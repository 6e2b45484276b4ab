// Fused attention with Shaw relative positions, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/flash_attention.py:_flash_kernel
// (launched by _flash_forward; API flash_rel_attention_at). Computes, per
// group g and query i (global position i + q_offset):
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// over keys j < t_valid, with the softmax in fp32. q arrives pre-scaled
// and E unscaled (the caller's contract). q, k, v, out are [G, T, 16]
// contiguous, E is [2*max_pos+1, 16]; fp32 or bf16 (widened to fp32 on
// load, the output written in the input type). When `lse` is not null the
// row log-sum-exp m + log(l) is written there as fp32 [G, Tq]: the backward
// kernel (flash_rel_attention_bwd.cu) recomputes the weights from it.
//
// Memory is O(T): nothing of size [G, T, T] exists. One block of 64
// threads owns one (group, tile of 64 queries), one query per thread, q
// and the running (max, sum, accumulator) in registers. It walks the keys
// in tiles of 64 staged in shared memory, together with the 64+64-1 rows
// of E that the tile pair's distances need, and folds each chunk of 16
// scores into an online (running-max) softmax.
//
// What bounds it on an H100 SXM (700 W part; 989 TFLOP/s bf16 tensor,
// 67 TFLOP/s fp32 non-tensor, 3.35 TB/s). At the 16 s segment
// (G = 404, T = 2561, D = 16): content, position and P.V terms are
// 3 * 2*T*T*D * G = 2.54e11 FLOP, and q/k/v/out move 4*G*T*D*4 B =
// 265 MB in fp32 (132 MB in bf16). So the function is bound by
// operations: 3.8 ms at the fp32 rate, 0.26 ms at the bf16 tensor rate,
// against 0.08 ms (fp32) for the bytes. This first version uses the fp32
// CUDA cores only (no tensor cores, TMA or wgmma); its reads of K, V and
// the E rows from shared memory, not the FMAs, are expected to limit it.
// A card whose power limit is below 700 W runs slower under load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 16;
constexpr int BQ = 64;                // queries per block, one per thread
constexpr int BK = 64;                // keys per shared-memory tile
constexpr int NE = BQ + BK - 1;       // rows of E one tile pair needs
constexpr int ESTRIDE = D + 4;        // padded E row: conflict-free float4 reads
constexpr int CHUNK = 16;             // scores per online-softmax update

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float* q, float4 x) {
  return q[0] * x.x + q[1] * x.y + q[2] * x.z + q[3] * x.w;
}

template <typename T>
__global__ void __launch_bounds__(BQ)
flash_rel_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ table,
              T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk,
              int n_qtiles, int max_pos, int t_valid, int q_offset) {
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ __align__(16) float es[NE * ESTRIDE];

  const int g = blockIdx.x / n_qtiles;
  const int i0 = (blockIdx.x % n_qtiles) * BQ;
  const int a = threadIdx.x;
  const bool live = i0 + a < Tq;
  const size_t qrow = (static_cast<size_t>(g) * Tq + i0 + a) * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? widen(q[qrow + d]) : 0.f;

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;

  const T* kg = k + static_cast<size_t>(g) * Tk * D;
  const T* vg = v + static_cast<size_t>(g) * Tk * D;

  for (int j0 = 0; j0 < t_valid; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = a; e < BK * D; e += BQ) {
      const bool in = j0 + e / D < Tk;
      ks[e] = in ? widen(kg[static_cast<size_t>(j0) * D + e]) : 0.f;
      vs[e] = in ? widen(vg[static_cast<size_t>(j0) * D + e]) : 0.f;
    }
    // es row r holds E at distance base + r; thread a meets key b at row a - b + BK - 1
    const int base = i0 + q_offset - j0 - (BK - 1);
    for (int e = a; e < NE * D; e += BQ) {
      const int r = e / D;
      const int dist = min(max(base + r, -max_pos), max_pos) + max_pos;
      es[r * ESTRIDE + e % D] = widen(table[dist * D + e % D]);
    }
    __syncthreads();

    const int nk = min(BK, t_valid - j0);
    for (int b0 = 0; b0 < nk; b0 += CHUNK) {
      float s[CHUNK];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int b = b0 + c;
        const float4* kr = reinterpret_cast<const float4*>(ks + b * D);
        const float4* er = reinterpret_cast<const float4*>(es + (a - b + BK - 1) * ESTRIDE);
        float content = 0.f, pos = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          content += dot4(qr + 4 * d4, kr[d4]);
          pos += dot4(qr + 4 * d4, er[d4]);
        }
        s[c] = b < nk ? content + pos : -CUDART_INF_F;  // keys >= t_valid are masked
        cmax = fmaxf(cmax, s[c]);
      }
      // cmax is finite: key b0 < nk is valid
      const float m_new = fmaxf(m, cmax);
      const float corr = __expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float p = __expf(s[c] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (b0 + c) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 x = vr[d4];
          acc[4 * d4 + 0] += p * x.x;
          acc[4 * d4 + 1] += p * x.y;
          acc[4 * d4 + 2] += p * x.z;
          acc[4 * d4 + 3] += p * x.w;
        }
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) narrow(acc[d] * inv, out + qrow + d);
    if (lse != nullptr) lse[static_cast<size_t>(g) * Tq + i0 + a] = m + __logf(l);
  }
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int cmgan_flash_rel_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* out,
    void* lse, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid, int q_offset,
    int is_bf16, void* stream) {
  if (head_dim != D || G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_qtiles = (Tq + BQ - 1) / BQ;
  const dim3 grid(static_cast<unsigned>(G) * static_cast<unsigned>(n_qtiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_rel_fwd<__nv_bfloat16><<<grid, BQ, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Tq, Tk, n_qtiles, max_pos, t_valid, q_offset);
  } else {
    flash_rel_fwd<float><<<grid, BQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(table),
        static_cast<float*>(out), static_cast<float*>(lse), Tq, Tk, n_qtiles, max_pos, t_valid, q_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
