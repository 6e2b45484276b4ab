// LayerNorm over the last axis, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/fused_norm.py:_ln_kernel (launched by
// _ln_forward; API fused_layernorm). For each row of x [N, C]:
//
//   mean = E[x], var = E[x^2] - E[x]^2, y = (x - mean) * rsqrt(var + eps) * scale + bias
//
// with the statistics and the affine in fp32 and y written in x's type (fp32
// or bf16); scale and bias are fp32 [C]; any C >= 1.
//
// What bounds it on an H100 SXM (700 W part, 3.35 TB/s): bytes. A row costs
// about 8 FLOP an element against 2 * C * sizeof(T) bytes, far below the
// card's 20 fp32 FLOP a byte, so the least time is 2*N*C*sizeof(T) / 3.35e12 s.
// Reaching it takes many bytes in flight: every lane keeps eight 16-byte loads
// of x outstanding before it first uses one, x is read once and y written
// once, both in 16-byte words wherever the layout allows. Three paths, picked
// on the host (ops/fused_norm.py:plan) by the width and the alignment:
//
//   rows in registers (`layernorm_regs<T, L, N, R>`): rows of a multiple of 16
//     bytes up to 4 KB, x, y, scale and bias at 16-byte boundaries. L lanes
//     share a row (a power of two), each holding N 16-byte chunks of it, for
//     R rows at once (N * R = 8: 128 bytes a lane in flight). A row of up to
//     512 bytes is one chunk a lane: C = 64 is 8 lanes a row in bf16 (4 rows a
//     warp), 16 in fp32 (2 rows); wider rows are a warp each, up to 8 chunks
//     a lane. Sums by shuffles within the L lanes; the values stay packed in
//     registers between the two reads of them.
//   span (`layernorm_span<T>`): any other row of up to 48 KB (odd or
//     unaligned C). A block owns a run of whole rows, one contiguous span of x:
//     it copies the span into shared memory in 16-byte words (at the offset
//     the span has within its 16-byte line), normalises it there, a warp a
//     row, and writes it back in 16-byte words (one element at a time only
//     at the span's two ends, or throughout where y's alignment differs).
//   long rows (`layernorm_long<T>`): a row wider than a block's span, a
//     block a row, two passes over it in device memory (the second mostly
//     from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// a span block's shared memory, its rows and the two ends' 16-byte lines
// (ops/fused_norm.py SPAN_MAX_BYTES): the default limit, no opt-in needed
constexpr int SPAN_MAX_BYTES = 48 * 1024;
constexpr int SPAN_SLACK = 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// the elements of a 16-byte word, widened: 4 fp32 or 8 bf16
__device__ __forceinline__ void unpack(uint4 u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void warp_sums(float& sum, float& sumsq) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
}

template <typename T, int L, int N, int R>
__global__ void __launch_bounds__(THREADS)
layernorm_regs(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, long long n_rows, int C,
               float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  constexpr int G = 32 / L;          // rows a warp holds in each of its R slots
  const int lane = threadIdx.x & 31, j = lane % L, sub = lane / L;
  const int chunks = C / E;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32) * (G * R);
  if (row0 >= n_rows) return;  // whole warps leave together

  // every load first, then their uses: N * R 16-byte words in flight a lane
  uint4 u[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + r * G + sub;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = j + n * L;
      u[r][n] = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows && c < chunks) {
        u[r][n] = __ldcs(reinterpret_cast<const uint4*>(x + row * C) + c);
      }
    }
  }
  float mean[R], rstd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float sum = 0.f, sumsq = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float f[E];
      unpack(u[r][n], f, T());
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sum += f[e];
        sumsq += f[e] * f[e];
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
    }
    mean[r] = sum / C;
    rstd[r] = rsqrtf(sumsq / C - mean[r] * mean[r] + eps);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = j + n * L;
    if (c >= chunks) continue;
    float s[E], b[E];
#pragma unroll
    for (int h = 0; h < E / 4; ++h) {
      const float4 sv = __ldg(reinterpret_cast<const float4*>(scale + c * E) + h);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c * E) + h);
      s[4 * h] = sv.x, s[4 * h + 1] = sv.y, s[4 * h + 2] = sv.z, s[4 * h + 3] = sv.w;
      b[4 * h] = bv.x, b[4 * h + 1] = bv.y, b[4 * h + 2] = bv.z, b[4 * h + 3] = bv.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + r * G + sub;
      if (row >= n_rows) continue;
      float f[E];
      unpack(u[r][n], f, T());
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (f[e] - mean[r]) * rstd[r] * s[e] + b[e];
      __stcs(reinterpret_cast<uint4*>(y + row * C) + c, pack(f, T()));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layernorm_span(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, long long n_rows, int C,
               float eps, int rows_per_block) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int rows = static_cast<int>(min(static_cast<long long>(rows_per_block), n_rows - r0));
  const long long first = r0 * C;  // the span's first element
  const int n = rows * C;          // and its length
  // buf[head + e] holds x[first + e]: the span keeps its offset within a
  // 16-byte line, so whole lines copy as 16-byte words. The words at the two
  // ends reach past the span, never past the 16-byte lines that hold its ends.
  const int head = static_cast<int>((reinterpret_cast<uintptr_t>(x + first) & 15) / sizeof(T));
  const int lines = (head + n + E - 1) / E;
  T* buf = reinterpret_cast<T*>(smem);
  const uint4* src = reinterpret_cast<const uint4*>(x + first - head);
  for (int i = threadIdx.x; i < lines; i += THREADS) {
    reinterpret_cast<uint4*>(buf)[i] = __ldcs(src + i);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += THREADS / 32) {
    T* row = buf + head + r * C;
    float sum = 0.f, sumsq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = widen(row[c]);
      sum += v;
      sumsq += v * v;
    }
    warp_sums(sum, sumsq);
    const float mean = sum / C;
    const float rstd = rsqrtf(sumsq / C - mean * mean + eps);
    for (int c = lane; c < C; c += 32) {
      narrow((widen(row[c]) - mean) * rstd * __ldg(scale + c) + __ldg(bias + c), row + c);
    }
  }
  __syncthreads();

  T* dst = y + first;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == (reinterpret_cast<uintptr_t>(x + first) & 15)) {
    uint4* out = reinterpret_cast<uint4*>(dst - head);
    for (int i = threadIdx.x; i < lines; i += THREADS) {
      const int e0 = i * E - head;  // the span's element at the line's start
      if (e0 >= 0 && e0 + E <= n) {
        __stcs(out + i, reinterpret_cast<const uint4*>(buf)[i]);
      } else {
        for (int e = max(e0, 0); e < min(e0 + E, n); ++e) dst[e] = buf[head + e];
      }
    }
  } else {
    for (int e = threadIdx.x; e < n; e += THREADS) dst[e] = buf[head + e];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layernorm_long(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, int C, float eps) {
  __shared__ float part[2][THREADS / 32];
  const T* xr = x + static_cast<long long>(blockIdx.x) * C;
  T* yr = y + static_cast<long long>(blockIdx.x) * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float sum = 0.f, sumsq = 0.f;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float v = widen(xr[c]);
    sum += v;
    sumsq += v * v;
  }
  warp_sums(sum, sumsq);
  if (lane == 0) {
    part[0][warp] = sum;
    part[1][warp] = sumsq;
  }
  __syncthreads();
  sum = lane < THREADS / 32 ? part[0][lane] : 0.f;
  sumsq = lane < THREADS / 32 ? part[1][lane] : 0.f;
  warp_sums(sum, sumsq);  // every warp sums the block's parts
  const float mean = sum / C;
  const float rstd = rsqrtf(sumsq / C - mean * mean + eps);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    narrow((widen(xr[c]) - mean) * rstd * scale[c] + bias[c], yr + c);
  }
}

template <typename T, int L, int N, int R>
int launch_regs(const T* x, const float* scale, const float* bias, T* y, long long n_rows, int C,
                float eps, cudaStream_t s) {
  constexpr int rows_a_block = THREADS / 32 * (32 / L) * R;
  const long long grid = (n_rows + rows_a_block - 1) / rows_a_block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  layernorm_regs<T, L, N, R><<<static_cast<unsigned>(grid), THREADS, 0, s>>>(x, scale, bias, y,
                                                                             n_rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// the instantiations ops/fused_norm.py:plan picks from
template <typename T>
int launch_regs_plan(int lanes, int chunks, int rows, const T* x, const float* scale,
                     const float* bias, T* y, long long n_rows, int C, float eps, cudaStream_t s) {
  const int key = lanes * 10000 + chunks * 100 + rows;
  switch (key) {
    case 10108: return launch_regs<T, 1, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 20108: return launch_regs<T, 2, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 40108: return launch_regs<T, 4, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 80108: return launch_regs<T, 8, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 160108: return launch_regs<T, 16, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 320108: return launch_regs<T, 32, 1, 8>(x, scale, bias, y, n_rows, C, eps, s);
    case 320204: return launch_regs<T, 32, 2, 4>(x, scale, bias, y, n_rows, C, eps, s);
    case 320402: return launch_regs<T, 32, 4, 2>(x, scale, bias, y, n_rows, C, eps, s);
    case 320801: return launch_regs<T, 32, 8, 1>(x, scale, bias, y, n_rows, C, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(int path, int lanes, int chunks, int rows, const void* xv, const float* scale,
           const float* bias, void* yv, long long n_rows, int C, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  const long long row_bytes = static_cast<long long>(C) * sizeof(T);
  if (path == 0) {
    // the plan's promise, checked: 16-byte rows and words, and room for a row
    const bool aligned = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(bias) % 16 == 0;
    if (!aligned || row_bytes > 16LL * lanes * chunks) return static_cast<int>(cudaErrorInvalidValue);
    return launch_regs_plan<T>(lanes, chunks, rows, x, scale, bias, y, n_rows, C, eps, s);
  }
  if (path == 1) {
    if (rows < 1 || row_bytes * rows + SPAN_SLACK > SPAN_MAX_BYTES) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long grid = (n_rows + rows - 1) / rows;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = static_cast<int>(row_bytes * rows) + SPAN_SLACK;
    layernorm_span<T><<<static_cast<unsigned>(grid), THREADS, bytes, s>>>(x, scale, bias, y, n_rows,
                                                                          C, eps, rows);
    return static_cast<int>(cudaGetLastError());
  }
  if (path == 2) {
    if (n_rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    layernorm_long<T><<<static_cast<unsigned>(n_rows), THREADS, 0, s>>>(x, scale, bias, y, C, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise. Any C >= 1. The
// path and its shape come from ops/fused_norm.py:plan: path 0 rows in
// registers (lanes a row, 16-byte chunks a lane, rows a thread), 1 span
// (rows a block), 2 long rows; a combination not built here, or whose
// alignment the pointers do not have, returns cudaErrorInvalidValue.
extern "C" int cmgan_fused_layernorm_fwd(const void* x, const void* scale, const void* bias,
                                         void* y, long long n_rows, int C, float eps,
                                         int is_bf16, int path, int lanes, int chunks, int rows,
                                         void* stream) {
  if (n_rows <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  return is_bf16
             ? launch<__nv_bfloat16>(path, lanes, chunks, rows, x, sp, bp, y, n_rows, C, eps, s)
             : launch<float>(path, lanes, chunks, rows, x, sp, bp, y, n_rows, C, eps, s);
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
