// Fused attention with Shaw relative positions, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/flash_attention.py:_flash_kernel
// (launched by _flash_forward; API flash_rel_attention_at). Computes, per
// group g and query i (global position i + q_offset):
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// over keys j < t_valid, with the softmax in fp32. q arrives pre-scaled
// and E unscaled (the caller's contract). q, k, v, out are [G, T, HD]
// contiguous, E is [2*max_pos+1, HD], HD 16, 32 or 64 (the head dim, a
// template parameter: flash_rel_common.cuh); fp32 or bf16, the output written in
// the input type. When `lse` is not null the row log-sum-exp m + log(l) is
// written there as fp32 [G, Tq]: the backward kernel
// (flash_rel_attention_bwd.cu) recomputes the weights from it.
//
// Memory is O(T): nothing of size [G, T, T] exists. One block of four warps
// owns one (group, tile of 64 queries), 16 queries a warp, and walks the keys
// in tiles of 64 staged in shared memory. All three products run on the
// tensor cores through mma.sync.m16n8k16 with fp32 accumulators
// (flash_rel_common.cuh): bf16 inputs as they are, fp32 inputs as three bf16
// parts an element and six part products, which keeps fp32 accuracy. The
// running max, the sum and the output accumulator stay fp32 in registers, and
// the weights are narrowed only as the A operand of P.V (bf16: rounded once;
// fp32: split in three).
//   content   S = Q_w . K^T            8 tile products a warp, key tile and
//                                      16 of the head dim
//   position  R = Q_w . E_window^T    10, added to S through the skew
//             s[r][b] += R[r][r - b + 63] (scratch in shared memory)
//   values    O += P . V               8 (at HD 16; HD / 2 in general)
// A tile pair whose every distance is clipped (|i - j| >= max_pos throughout;
// 64% of the pairs at T = 2561, max_pos 512) stages no window and computes no
// R: its position logit is one of two scalars a query, computed once a block.
//
// What bounds it on an H100 SXM (700 W part; 989 TFLOP/s bf16 tensor,
// 3.35 TB/s, 16 exponentials a clock an SM). At the 16 s segment (G = 404,
// T = 2561): the function needs ~2.4 products of 2*T*T*16*G FLOP (the clipped
// pairs need no position product), 2.0e11 FLOP, and 2.65e9 exponentials.
// bf16: 0.20 ms of products, 0.63 ms of exponentials at a 1.98 GHz clock:
// bound by the exponentials. fp32: six part products each, 1.2 ms, bound by
// the operations. The bytes take 0.08 ms. What this version leaves: tile
// loads travel through registers (fetched a tile ahead) rather than a
// cp.async/TMA ring, two block syncs a tile, the skew's round trip through
// shared memory, and mma.sync where wgmma would take fewer instructions.
// A card whose power limit is below 700 W runs slower under load.

#include "flash_rel_common.cuh"

namespace {

using namespace flash_rel;

constexpr int NW = 4;                 // warps per block
constexpr int NT = 32 * NW;
constexpr int BQ = 16 * NW;           // queries per block
constexpr int WIN = BQ + BK;          // staged window rows (BQ + BK - 1 used)

template <typename T, int HD>
constexpr int fwd_smem_bytes() {
  return (2 * BK + WIN) * stage_stride(HD) * 2 * Parts<T>::N + NW * RCOLS * RS * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_rel_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ table,
              T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk,
              int n_qtiles, int max_pos, int t_valid, int q_offset) {
  constexpr int P = Parts<T>::N;                        // bf16 planes of a staged tile
  constexpr int TS = stage_stride(HD), KD = HD / 16, NB = HD / 8;
  constexpr int KPL = BK * TS, EPL = WIN * TS;          // elements a plane
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + P * KPL;
  bf16* es = vs + P * KPL;
  float* rt_all = reinterpret_cast<float*>(es + P * EPL);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* rt = rt_all + w * RCOLS * RS;

  const int grp = blockIdx.x / n_qtiles;
  const int i0 = (blockIdx.x % n_qtiles) * BQ;

  // the query tile goes through the window's room once, into registers
  stage_rows<T, NT, HD>(es, EPL, q + static_cast<size_t>(grp) * Tq * HD, i0, BQ, Tq, tid);
  __syncthreads();
  FragA<P> qa[KD];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) load_a<P>(qa[kd], es, EPL, TS, 16 * w, 16 * kd, lane);
  // q_a . E[2*max_pos] and q_a . E[0] for rows g and g + 8: the clipped tiles' logit
  float pos_hi[2], pos_lo[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float hi = 0.f, lo = 0.f;
#pragma unroll
    for (int h = 0; h < NB; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 2 * t + 8 * h + e;
        const float x = tile_value<P>(es, EPL, (16 * w + g + 8 * rr) * TS + d);
        hi += x * widen(table[2 * max_pos * HD + d]);
        lo += x * widen(table[d]);
      }
    }
    pos_hi[rr] = quad_sum(hi);
    pos_lo[rr] = quad_sum(lo);
  }

  float acc[NB][4];  // out rows g, g+8; d = 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  const T* kg = k + static_cast<size_t>(grp) * Tk * HD;
  const T* vg = v + static_cast<size_t>(grp) * Tk * HD;

  TileFetch<T, NT, BK, HD> k_next, v_next;
  TileFetch<T, NT, WIN, HD> e_next;
  auto fetch = [&](int j0) {
    const int base = i0 + q_offset - j0 - (BK - 1);
    k_next.fetch_rows(kg, j0, Tk, tid);
    v_next.fetch_rows(vg, j0, Tk, tid);
    if (clip_kind(base, BQ, max_pos) == kMixed) e_next.fetch_window(table, base, max_pos, tid);
  };
  fetch(0);

  for (int j0 = 0; j0 < t_valid; j0 += BK) {
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, BQ, max_pos);
    __syncthreads();  // the previous tile (or the query tile) is consumed
    k_next.store(ks, tid);
    v_next.store(vs, tid);
    if (kind == kMixed) e_next.store(es, tid);
    __syncthreads();
    if (j0 + BK < t_valid) fetch(j0 + BK);  // in flight while this tile is computed

    float s[BK / 8][4];
    warp_logits<P, HD>(s, qa, ks, es, EPL, rt, kind, pos_hi, pos_lo, w, lane);

    const int nk = t_valid - j0;  // keys at or past nk are masked
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * nb + 2 * t + e >= nk) s[nb][e] = s[nb][2 + e] = -CUDART_INF_F;
        mx[0] = fmaxf(mx[0], s[nb][e]);
        mx[1] = fmaxf(mx[1], s[nb][2 + e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // finite: key j0 is valid
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]));
      corr[rr] = __expf(m[rr] - m_new);
      m[rr] = m_new;
      l[rr] *= corr[rr];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nb][e] = __expf(s[nb][e] - m[0]);
        s[nb][2 + e] = __expf(s[nb][2 + e] - m[1]);
        l[0] += s[nb][e];
        l[1] += s[nb][2 + e];
      }
    }
    // the weights of keys 16kk .. 16kk + 15 are two neighbouring logit tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float pv[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2], s[2 * kk][3],
                           s[2 * kk + 1][0], s[2 * kk + 1][1], s[2 * kk + 1][2], s[2 * kk + 1][3]};
      FragA<P> pa;
      frag_from(pa, pv);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        FragB<P> vb;
        load_b_trans<P>(vb, vs, KPL, TS, 8 * n, 16 * kk, lane);
        mma(acc[n], pa, vb);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = i0 + 16 * w + g + 8 * rr;
    const float sum = quad_sum(l[rr]);
    if (row < Tq) {
      const float inv = 1.f / sum;
      T* o = out + (static_cast<size_t>(grp) * Tq + row) * HD;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        narrow2(acc[n][2 * rr] * inv, acc[n][2 * rr + 1] * inv, o + 8 * n + 2 * t);
      }
      if (lse != nullptr && t == 0) lse[static_cast<size_t>(grp) * Tq + row] = m[rr] + __logf(sum);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* table, void* out, void* lse,
           int G, int Tq, int Tk, int max_pos, int t_valid, int q_offset, cudaStream_t s) {
  constexpr int bytes = fwd_smem_bytes<T, HD>();
  static_assert(bytes <= MAX_SMEM, "the forward's tiles fit a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_rel_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (Tq + BQ - 1) / BQ;
  const dim3 grid(static_cast<unsigned>(G) * static_cast<unsigned>(n_qtiles));
  flash_rel_fwd<T, HD><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk,
      n_qtiles, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns the first CUDA
// error (0 on success); does not synchronise. Pointers are 16-byte aligned;
// head_dim is 16, 32 or 64.
extern "C" int cmgan_flash_rel_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* out,
    void* lse, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid, int q_offset,
    int is_bf16, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(head_dim, static_cast<int>(cudaErrorInvalidValue), [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? launch<__nv_bfloat16, HD>(q, k, v, table, out, lse, G, Tq, Tk, max_pos,
                                               t_valid, q_offset, s)
                   : launch<float, HD>(q, k, v, table, out, lse, G, Tq, Tk, max_pos, t_valid,
                                       q_offset, s);
  });
}

// Dynamic shared memory, in bytes, of one block, or -1 for a head dim the
// library does not take.
extern "C" int cmgan_flash_rel_attention_fwd_smem(int is_bf16, int head_dim) {
  return with_head_dim(head_dim, -1, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? fwd_smem_bytes<__nv_bfloat16, HD>() : fwd_smem_bytes<float, HD>();
  });
}
