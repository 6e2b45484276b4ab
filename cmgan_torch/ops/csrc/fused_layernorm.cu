// Single-pass LayerNorm over the last axis, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/fused_norm.py:_ln_kernel (launched by
// _ln_forward; API fused_layernorm). For each row of x [N, C]:
//
//   mean = E[x], var = E[x^2] - E[x]^2, y = (x - mean) * rsqrt(var + eps) * scale + bias
//
// with the statistics and the affine in fp32 and y written in x's type (fp32
// or bf16); scale and bias are fp32 [C].
//
// One warp owns one row. For an even C of at most MAX_C (pair-aligned rows)
// each lane loads pairs of neighbouring elements (one 8-byte or 4-byte load a
// lane for C = 64, the width the conformer uses), keeps them in registers,
// reduces sum x and sum x^2 across the warp by shuffle, and writes the
// normalised pairs back: x is read once and y written once, nothing else
// touches device memory. Any other C (odd, or wider than a warp keeps) takes
// the same warp a row with a strided loop of single elements, in two passes
// over the row: the statistics, then the output. The second pass reads the
// row again, mostly from the L1 and L2 caches.
//
// What bounds it on an H100 SXM (700 W part, 3.35 TB/s): bytes. A row costs
// about 5 FLOP an element against 2 * C * sizeof(T) bytes, far below the
// card's 20 fp32 FLOP a byte, so the least time is 2*N*C*sizeof(T) / 3.35e12 s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // rows per block
constexpr int MAX_PAIRS = 8;          // pairs a lane keeps: C <= 2 * 32 * MAX_PAIRS
constexpr int MAX_C = 2 * 32 * MAX_PAIRS;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 y) {
  *reinterpret_cast<float2*>(p) = y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y.x, y.y);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void warp_sums(float& sum, float& sumsq) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
}

// any C >= 1: a strided loop a lane, two passes over the row
template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
layernorm_fwd_any(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, long long n_rows,
                  int C, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float sum = 0.f, sumsq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = widen(xr[c]);
    sum += v;
    sumsq += v * v;
  }
  warp_sums(sum, sumsq);
  const float mean = sum / C;
  const float rstd = rsqrtf(sumsq / C - mean * mean + eps);
  for (int c = lane; c < C; c += 32) {
    narrow((widen(xr[c]) - mean) * rstd * scale[c] + bias[c], yr + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
layernorm_fwd(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ y, long long n_rows,
              int C, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int n_pairs = C / 2;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float2 vals[MAX_PAIRS];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = lane + 32 * i;
    if (p < n_pairs) {
      vals[i] = load2(xr + 2 * p);
      sum += vals[i].x + vals[i].y;
      sumsq += vals[i].x * vals[i].x + vals[i].y * vals[i].y;
    }
  }
  warp_sums(sum, sumsq);
  const float mean = sum / C;
  const float rstd = rsqrtf(sumsq / C - mean * mean + eps);
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) {
    const int p = lane + 32 * i;
    if (p < n_pairs) {
      const float2 s = load2(scale + 2 * p);
      const float2 b = load2(bias + 2 * p);
      float2 out;
      out.x = (vals[i].x - mean) * rstd * s.x + b.x;
      out.y = (vals[i].y - mean) * rstd * s.y + b.y;
      store2(yr + 2 * p, out);
    }
  }
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* y, long long n_rows, int C,
           float eps, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n_rows + WARPS - 1) / WARPS);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  // the pair loads need an even C and x, y, scale, bias at pair boundaries
  const uintptr_t pair = 2 * sizeof(T);
  const bool pairs = C % 2 == 0 && C <= MAX_C && reinterpret_cast<uintptr_t>(x) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(y) % pair == 0 &&
                     reinterpret_cast<uintptr_t>(scale) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(bias) % 8 == 0;
  if (pairs) {
    layernorm_fwd<T><<<grid, 32 * WARPS, 0, s>>>(xp, scale, bias, yp, n_rows, C, eps);
  } else {
    layernorm_fwd_any<T><<<grid, 32 * WARPS, 0, s>>>(xp, scale, bias, yp, n_rows, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise. Any C >= 1.
extern "C" int cmgan_fused_layernorm_fwd(const void* x, const void* scale, const void* bias,
                                         void* y, long long n_rows, int C, float eps,
                                         int is_bf16, void* stream) {
  if (n_rows <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  return is_bf16 ? launch<__nv_bfloat16>(x, sp, bp, y, n_rows, C, eps, s)
                 : launch<float>(x, sp, bp, y, n_rows, C, eps, s);
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
