// RMSNorm over the last axis, forward, float32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no RMSNorm. Added for SEMamba's
// Mamba blocks (cmgan_torch/models/semamba.py), which normalise each token of
// [rows, L, C] before the mixer. For each row of x [n, C]:
//
//   y = x * rsqrt(E[x^2] + eps) * weight
//
// with the mean of squares in fp32 and weight fp32 [C]. Launched by
// ops/fused_norm.py:fused_rmsnorm, which holds the plain version.
//
// What bounds it on an H100 SXM: bytes, 8 * C a row read and written against
// 3 flops an element. So it moves 16-byte words only: a row is C / 4 words,
// spread over a group of 16 lanes (two rows a warp), each lane holding up to
// WORDS of them in registers between the sum and the scaling, so x is read
// once and y written once. C must be a multiple of 4 and at most 16 * 4 *
// WORDS; x, y and weight start at 16-byte boundaries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 16;  // lanes a row
constexpr int WORDS = 8;   // 16-byte words a lane: rows of up to 512 floats

__global__ void __launch_bounds__(THREADS)
rmsnorm_fwd(const float4* __restrict__ x, const float4* __restrict__ w, float4* __restrict__ y,
            long long n_rows, int words, int C, float eps) {
  const long long row = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / LANES;
  const int j = threadIdx.x % LANES;
  const bool live = row < n_rows;  // every lane stays for the shuffles
  const float4* xr = x + row * words;
  float4 v[WORDS];
  float sumsq = 0.f;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int c = j + k * LANES;
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && c < words) v[k] = __ldcs(xr + c);
    sumsq += v[k].x * v[k].x + v[k].y * v[k].y + v[k].z * v[k].z + v[k].w * v[k].w;
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
  const float r = rsqrtf(sumsq / C + eps);
#pragma unroll
  for (int k = 0; k < WORDS; ++k) {
    const int c = j + k * LANES;
    if (live && c < words) {
      const float4 s = __ldg(w + c);
      __stcs(y + row * words + c,
             make_float4(v[k].x * r * s.x, v[k].y * r * s.y, v[k].z * r * s.z, v[k].w * r * s.w));
    }
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise. Refuses
// (cudaErrorInvalidValue) a C that is no multiple of 4 or wider than 512, and
// pointers off 16-byte boundaries.
extern "C" int cmgan_fused_rmsnorm_fwd(const void* x, const void* weight, void* y,
                                       long long n_rows, int C, float eps, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(weight) % 16 == 0;
  if (n_rows <= 0 || C <= 0 || C % 4 != 0 || C / 4 > LANES * WORDS || !aligned) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long grid = (n_rows * LANES + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_fwd<<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(weight), static_cast<float4*>(y),
      n_rows, C / 4, C, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
