// Shared by every attention library (flash_rel_attention{,_bwd,_wide,_wide_bwd}.cu):
// the tile sizes, the clip test of a tile pair, the conversions between the
// input type and fp32, and fp32's split into bf16 parts. The products, on
// Hopper's wgmma, and the staging are in flash_rel_hopper.cuh.
//
// bf16 inputs are one tensor-core operand. An fp32 input x is carried as
// three bf16 parts, x = x0 + x1 + x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 =
// bf16(x - x0 - x1): 24 bits in all, so nothing of x is lost. A product of
// two fp32 operands is then the six part products whose terms are above 2^-24
// of the result, (0,0) (0,1) (1,0) (0,2) (2,0) (1,1), summed smallest first:
// fp32 accuracy from the bf16 tensor cores, at six times the bf16 route's
// tensor work. (Three TF32 passes, big.big + big.small + small.big, were tried
// first: each product is then good to ~5e-7, not 6e-8, and a training step's
// gradients moved from 3e-4 to 2e-3 of the float64 result; see PERF.md.)
//
// The position term by skew. For a tile of queries from i0 and 64 keys from
// j0, query a meets key b at distance base + c with c = a - b + 63 and base =
// i0 + q_offset - j0 - 63. Row c of the staged window is E[clip(base + c,
// +-max_pos) + max_pos]; R = Q . E_window^T, and the position logit of (a, b)
// is R[a][a - b + 63]. A tile pair whose every distance is clipped needs no
// window: its position logit is one of two scalars a query, q_a .
// E[2*max_pos] or q_a . E[0].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

// One definition per library: each .cu includes this header once.
extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace flash_rel {

constexpr int BK = 64;       // keys per tile
constexpr int RCOLS = 80;    // columns of R a warp of the D <= 64 kernels reads (79 needed)
constexpr int RS = 20;       // floats per column of their R scratch
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may ask for

// f(std::integral_constant<int, HD>()) for a head dim the libraries are built
// for (16, 32, 64: ops/flash_attention.py KERNEL_HEAD_DIMS), `otherwise` for
// any other
template <typename F>
int with_head_dim(int head_dim, int otherwise, F f) {
  switch (head_dim) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    default: return otherwise;
  }
}

enum Clip { kMixed = 0, kHigh = 1, kLow = 2 };

// The uniform test: are all distances of the tile pair clipped to one row?
__device__ __forceinline__ int clip_kind(int base, int bq, int max_pos) {
  if (base >= max_pos) return kHigh;                        // least distance
  if (base + bq + BK - 2 <= -max_pos) return kLow;          // largest distance
  return kMixed;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// two neighbouring values, one store
__device__ __forceinline__ void narrow2(float x, float y, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void narrow2(float x, float y, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- fp32 as bf16 parts ----

using bf16 = __nv_bfloat16;

// bf16 parts an element of type T is carried in
template <typename T> struct Parts { static constexpr int N = 1; };
template <> struct Parts<float> { static constexpr int N = 3; };

// x = x0 + x1 + x2 and y likewise, each part a bf16; part i of both in p[i]
// (x in the low half)
__device__ __forceinline__ void split3(float x, float y, uint32_t* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16(x, y);
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// sum over the four lanes that share a row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

}  // namespace flash_rel
