// Fused attention with Shaw relative positions, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/flash_attention.py:_flash_bwd_kernel
// (launched by _flash_backward; VJP _bwd_at of flash_rel_attention_at). With
//
//   s_ij   = q_i.k_j + q_i.E[r_ij],  r_ij = clip(i + q_offset - j, +-max_pos) + max_pos
//   p_ij   = exp(s_ij - lse_i)                      (keys j < t_valid, else 0)
//   ds_ij  = p_ij * (g_i.v_j - delta_i),  delta_i = g_i.out_i = sum_j p_ij g_i.v_j
//
// it computes, for the cotangent g of the forward's output,
//
//   dq_i = sum_j ds_ij (k_j + E[r_ij])      dk_j = sum_i ds_ij q_i
//   dv_j = sum_i p_ij g_i                   dE[r] = sum over groups and all
//                                                   (i, j) with r_ij = r of ds_ij q_i
//
// q, k, v, out, g, dq, dk, dv are [G, T, 16] contiguous, fp32 or bf16 (widened
// on load, every sum in fp32, written in the input type); lse is the forward
// kernel's fp32 [G, Tq] row log-sum-exp; dE is an fp32 [2*max_pos+1, 16]
// buffer the caller zeroes. Memory is O(T): the weights are recomputed tile
// by tile from lse, nothing of size [G, T, T] exists.
//
// The TPU kernel walks its query blocks in order and accumulates dk, dv and
// the band gradient across revisits; blocks here run in parallel, so the work
// is split into two kernels, each the sole owner of what it writes:
//
//   flash_rel_bwd_dq  one block per (group, 64 queries), one query a thread;
//       loops over key tiles; writes dq and delta, accumulates dE.
//   flash_rel_bwd_dkv one block per (group, 64 keys), one key a thread; loops
//       over query tiles; writes dk and dv (zeros for keys >= t_valid).
//
// dE is the hard part: 1025 x 16 sums over every group and pair. Pairs whose
// distance is clipped (|i + q_offset - j| >= max_pos) all land on row 0 or
// row 2*max_pos; each thread keeps their two ds sums in registers and the
// block adds sum_a c_a q_a to those rows once, at its end. Unclipped pairs of
// one tile pair touch 127 consecutive rows: they are summed in shared memory
// (shared atomics, row stride 17 so a warp's 32 rows fall in 32 banks) and
// added to the global buffer once per tile pair with coalesced fp32 atomics.
// The order of those atomics varies from run to run, so dE is reproducible
// only to fp32 rounding of its sum.
//
// What bounds it on an H100 SXM (700 W part; 67 TFLOP/s fp32 outside the
// tensor cores, 989 TFLOP/s bf16 tensor, 3.35 TB/s): the function is eight
// products of 2*G*Tq*t_valid*16 FLOP (two logit terms, dp, dv, dk, two dq
// terms, dE), so operations. At G = 1616, T = 641 that is 1.70e11 FLOP,
// 2.5 ms at the fp32 rate, against 0.16 ms for the bytes. This version uses
// the fp32 CUDA cores only and recomputes the logits in both kernels (11
// products in all); shared-memory reads and the shared atomics, not the
// FMAs, are expected to limit it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 16;
constexpr int BT = 64;                // queries or keys per tile, one per thread
constexpr int NE = 2 * BT - 1;        // rows of E one tile pair needs
constexpr int ESTRIDE = D + 4;        // padded E row: conflict-free float4 reads
constexpr int DSTRIDE = D + 1;        // padded dE row: 32 lanes, 32 banks

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(const float* q, float4 x) {
  return q[0] * x.x + q[1] * x.y + q[2] * x.z + q[3] * x.w;
}

__device__ __forceinline__ void axpy4(float* acc, float s, float4 x) {
  acc[0] += s * x.x;
  acc[1] += s * x.y;
  acc[2] += s * x.z;
  acc[3] += s * x.w;
}

// Stage the NE rows of E at distances base .. base + NE - 1 (clipped).
template <typename T>
__device__ __forceinline__ void stage_table(float* es, const T* __restrict__ table,
                                            int base, int max_pos, int tid) {
  for (int e = tid; e < NE * D; e += BT) {
    const int r = e / D;
    const int row = min(max(base + r, -max_pos), max_pos) + max_pos;
    es[r * ESTRIDE + e % D] = widen(table[row * D + e % D]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BT)
flash_rel_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ table,
                 const T* __restrict__ out, const T* __restrict__ gout,
                 const float* __restrict__ lse, T* __restrict__ dq,
                 float* __restrict__ delta, float* __restrict__ dtable,
                 int Tq, int Tk, int n_qtiles, int max_pos, int t_valid, int q_offset) {
  __shared__ __align__(16) float ks[BT * D];
  __shared__ __align__(16) float vs[BT * D];
  __shared__ __align__(16) float es[NE * ESTRIDE];
  __shared__ float des[NE * DSTRIDE];

  const int g = blockIdx.x / n_qtiles;
  const int i0 = (blockIdx.x % n_qtiles) * BT;
  const int a = threadIdx.x;
  const bool live = i0 + a < Tq;
  const size_t qrow = (static_cast<size_t>(g) * Tq + i0 + a) * D;

  // a thread past Tq carries zeros: its ds, and all it adds, are zero
  float qr[D], gr[D], dqr[D];
  float dl = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? widen(q[qrow + d]) : 0.f;
    gr[d] = live ? widen(gout[qrow + d]) : 0.f;
    dl += live ? gr[d] * widen(out[qrow + d]) : 0.f;
    dqr[d] = 0.f;
  }
  const float lse_a = live ? lse[static_cast<size_t>(g) * Tq + i0 + a] : 0.f;
  if (live) delta[static_cast<size_t>(g) * Tq + i0 + a] = dl;
  float c_lo = 0.f, c_hi = 0.f;  // ds summed over pairs clipped to row 0 / row 2*max_pos

  for (int e = a; e < NE * DSTRIDE; e += BT) des[e] = 0.f;

  const T* kg = k + static_cast<size_t>(g) * Tk * D;
  const T* vg = v + static_cast<size_t>(g) * Tk * D;
  const int pos = i0 + a + q_offset;  // this query's global position

  for (int j0 = 0; j0 < t_valid; j0 += BT) {
    __syncthreads();  // the previous tile is consumed, des is zeroed
    for (int e = a; e < BT * D; e += BT) {
      const bool in = j0 + e / D < Tk;
      ks[e] = in ? widen(kg[static_cast<size_t>(j0) * D + e]) : 0.f;
      vs[e] = in ? widen(vg[static_cast<size_t>(j0) * D + e]) : 0.f;
    }
    // es / des row r is distance base + r; thread a meets key b at row a - b + BT - 1
    const int base = i0 + q_offset - j0 - (BT - 1);
    stage_table(es, table, base, max_pos, a);
    __syncthreads();

    const int nk = min(BT, t_valid - j0);
    for (int b = 0; b < nk; ++b) {
      const int r = a - b + BT - 1;
      const float4* kr = reinterpret_cast<const float4*>(ks + b * D);
      const float4* vr = reinterpret_cast<const float4*>(vs + b * D);
      const float4* er = reinterpret_cast<const float4*>(es + r * ESTRIDE);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        s += dot4(qr + 4 * d4, kr[d4]) + dot4(qr + 4 * d4, er[d4]);
        dp += dot4(gr + 4 * d4, vr[d4]);
      }
      const float ds = __expf(s - lse_a) * (dp - dl);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        axpy4(dqr + 4 * d4, ds, kr[d4]);
        axpy4(dqr + 4 * d4, ds, er[d4]);
      }
      const int dist = pos - (j0 + b);
      if (dist >= max_pos) {
        c_hi += ds;
      } else if (dist <= -max_pos) {
        c_lo += ds;
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) atomicAdd(&des[r * DSTRIDE + d], ds * qr[d]);
      }
    }

    __syncthreads();  // every thread's shared sums for this tile pair are in
    for (int e = a; e < NE * D; e += BT) {
      const int r = e / D;
      const int dist = base + r;
      if (dist > -max_pos && dist < max_pos) {
        atomicAdd(&dtable[(dist + max_pos) * D + e % D], des[r * DSTRIDE + e % D]);
      }
      des[r * DSTRIDE + e % D] = 0.f;
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) narrow(dqr[d], dq + qrow + d);
  }

  // the clipped rows: sum_a c_a q_a over each warp, one atomic a warp and entry.
  // Uniform per block: skip the rows this block's distances never reach.
  const bool any_hi = i0 + BT - 1 + q_offset >= max_pos;
  const bool any_lo = i0 + q_offset - (t_valid - 1) <= -max_pos;
  if (any_hi || any_lo) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float hi = c_hi * qr[d], lo = c_lo * qr[d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        hi += __shfl_xor_sync(0xffffffffu, hi, off);
        lo += __shfl_xor_sync(0xffffffffu, lo, off);
      }
      if ((a & 31) == 0) {
        if (any_hi) atomicAdd(&dtable[2 * max_pos * D + d], hi);
        if (any_lo) atomicAdd(&dtable[d], lo);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BT)
flash_rel_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ table,
                  const T* __restrict__ gout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int Tq, int Tk, int n_ktiles, int max_pos,
                  int t_valid, int q_offset) {
  __shared__ __align__(16) float qs[BT * D];
  __shared__ __align__(16) float gs[BT * D];
  __shared__ __align__(16) float es[NE * ESTRIDE];
  __shared__ float lses[BT];
  __shared__ float deltas[BT];

  const int g = blockIdx.x / n_ktiles;
  const int j0 = (blockIdx.x % n_ktiles) * BT;
  const int b = threadIdx.x;
  const bool in_range = j0 + b < Tk;
  const bool valid = j0 + b < t_valid;  // keys past t_valid get zero gradients
  const size_t krow = (static_cast<size_t>(g) * Tk + j0 + b) * D;

  float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = valid ? widen(k[krow + d]) : 0.f;
    vr[d] = valid ? widen(v[krow + d]) : 0.f;
    dkr[d] = 0.f;
    dvr[d] = 0.f;
  }

  const T* qg = q + static_cast<size_t>(g) * Tq * D;
  const T* gg = gout + static_cast<size_t>(g) * Tq * D;
  const float* lg = lse + static_cast<size_t>(g) * Tq;
  const float* dg = delta + static_cast<size_t>(g) * Tq;

  // a tile of keys that lies wholly past t_valid only writes its zeros
  const int q_end = j0 < t_valid ? Tq : 0;
  for (int i0 = 0; i0 < q_end; i0 += BT) {
    __syncthreads();  // the previous tile is consumed
    for (int e = b; e < BT * D; e += BT) {
      const bool in = i0 + e / D < Tq;
      qs[e] = in ? widen(qg[static_cast<size_t>(i0) * D + e]) : 0.f;
      gs[e] = in ? widen(gg[static_cast<size_t>(i0) * D + e]) : 0.f;
    }
    lses[b] = i0 + b < Tq ? lg[i0 + b] : 0.f;
    deltas[b] = i0 + b < Tq ? dg[i0 + b] : 0.f;
    // es row r is distance base + r; key b meets query a at row a - b + BT - 1
    const int base = i0 + q_offset - j0 - (BT - 1);
    stage_table(es, table, base, max_pos, b);
    __syncthreads();

    const int nq = min(BT, Tq - i0);
    for (int a = 0; a < nq; ++a) {
      const float4* qr = reinterpret_cast<const float4*>(qs + a * D);
      const float4* gr = reinterpret_cast<const float4*>(gs + a * D);
      const float4* er = reinterpret_cast<const float4*>(es + (a - b + BT - 1) * ESTRIDE);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        const float4 ev = er[d4];
        s += dot4(kr + 4 * d4, qv) + qv.x * ev.x + qv.y * ev.y + qv.z * ev.z + qv.w * ev.w;
        dp += dot4(vr + 4 * d4, gr[d4]);
      }
      const float p = valid ? __expf(s - lses[a]) : 0.f;
      const float ds = p * (dp - deltas[a]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        axpy4(dvr + 4 * d4, p, gr[d4]);
        axpy4(dkr + 4 * d4, ds, qr[d4]);
      }
    }
  }

  if (in_range) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      narrow(dkr[d], dk + krow + d);
      narrow(dvr[d], dv + krow + d);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* out, const void* gout, const void* lse, void* dq, void* dk,
           void* dv, void* delta, void* dtable, int G, int Tq, int Tk, int max_pos,
           int t_valid, int q_offset, cudaStream_t s) {
  const int n_qtiles = (Tq + BT - 1) / BT;
  const int n_ktiles = (Tk + BT - 1) / BT;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* tp = static_cast<const T*>(table);
  const T* gp = static_cast<const T*>(gout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  flash_rel_bwd_dq<T><<<static_cast<unsigned>(G) * n_qtiles, BT, 0, s>>>(
      qp, kp, vp, tp, static_cast<const T*>(out), gp, lp, static_cast<T*>(dq), dp,
      static_cast<float*>(dtable), Tq, Tk, n_qtiles, max_pos, t_valid, q_offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // reads the delta the first kernel wrote: same stream, so in order
  flash_rel_bwd_dkv<T><<<static_cast<unsigned>(G) * n_ktiles, BT, 0, s>>>(
      qp, kp, vp, tp, gp, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk,
      n_ktiles, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise. `delta` is fp32
// [G, Tq] scratch, `dtable` fp32 [2*max_pos+1, 16] zeroed by the caller.
extern "C" int cmgan_flash_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* table, const void* out,
    const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* dtable, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid,
    int q_offset, int is_bf16, void* stream) {
  if (head_dim != D || G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable,
                                 G, Tq, Tk, max_pos, t_valid, q_offset, s);
  }
  return launch<float>(q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable,
                       G, Tq, Tk, max_pos, t_valid, q_offset, s);
}

extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
