// Fused attention with Shaw relative positions for heads wider than 64,
// forward, on Hopper (sm_90a).
//
// Replaces, for head dims over 64, the TPU kernel
// cmgan_tpu/ops/flash_attention.py:_flash_kernel (:91, launched by
// _flash_forward at :201), as flash_rel_attention.cu does for head dims 16,
// 32 and 64. The function, the arguments, the masks (t_valid, q_offset) and
// the fp32 row log-sum-exp are its:
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// for any head dim D (the wrapper, ops/flash_attention.py, sends it the heads
// wider than 64). Its backward is flash_rel_attention_wide_bwd.cu.
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (989 TFLOP/s of bf16
// tensor products, 3.35 TB/s): its products, three of 2*D FLOP a near
// query-key pair (two a clipped one); at G 404, T 641, D 128 0.127 ms in bf16
// and six times that in fp32 (six bf16 part products a product). The bytes
// (each input read once, the output written once) take five eighths of that
// in bf16, a fifth in fp32.
//
// The design (the pieces it shares with the wide backward are in
// flash_rel_hopper.cuh, namespace wide). Launches on the caller's stream: for
// fp32, a split of q, k, v and the table into three bf16 planes, x = x0 + x1
// + x2, once (TMA cannot split, and each row is read by many tile pairs), into
// the caller's scratch, each row padded to a multiple of 8 columns so that TMA
// takes every row; then the kernel, persistent blocks of a producer warpgroup
// and two consumer warpgroups, walking units of (group, 64-query tile, pass).
//
// - The producer fills a ring of stages, each 128 rows of one 64-column
//   chunk in the 128-byte swizzle: Q_c and K_c, the window of the table (a
//   mixed pair), or two tiles of V (one a consumer warpgroup, each at its own
//   columns); by TMA where a row is a whole number of 16-byte groups (fp32's
//   planes, bf16 D a multiple of 8) and the window has no clipped row, else
//   by its own cp.async copies (bf16 rows of 200 bytes at D 100). Columns
//   past D are zero and not computed.
// - The logits once a tile pair: warpgroup w computes S for keys 32w .. 32w
//   + 31 and R = Q . E_window^T for window rows 64w .. 64w + 63 over the depth
//   chunks. bf16 accumulates both over the chunks in the tensor cores and
//   writes R into the band in shared memory once a tile; fp32 computes each
//   chunk's products from zero, its part products smallest first, and adds
//   them in fp32, R in the band (its cells read before any is written: a
//   read-modify-write chain cost the first version most of its time). The
//   row maxima cross between the two warpgroups once a tile; each keeps its
//   own share of the row sums, crossed once a unit. P (bf16, or three bf16
//   planes for fp32) is written once into shared memory as wgmma's A operand.
// - The output's columns are split, not recomputed: each warpgroup owns half
//   of a pass's columns (at most HALF, in 64-column sub-chunks, the last of
//   an instantiation of 160 only 32 wide) and accumulates O += P . V there in
//   registers (bf16 straight onto O; fp32 each tile's product from zero and
//   added). One pass covers every D up to 2 * HALF = 320, so the logits are
//   computed once a tile pair there; past it the kernel takes passes of equal
//   widths and computes the logits once a pass.
// - A pair whose every distance is clipped stages no window: its position
//   logit is q_a . E[2 max_pos] or q_a . E[0], computed once a unit.
//
// Softmax in fp32 (exp2 on the special-function unit); the output is written
// in the input type, the lse by warpgroup 0 of the first pass. What this
// version leaves: the two consumer warpgroups meet two or three times a tile
// (band, maxima, P), so the tensor cores idle through the softmax; fp32
// spills about 1.2 KB a thread. Times: PERF.md.

#include "flash_rel_common.cuh"
#include "flash_rel_hopper.cuh"

namespace {

using namespace flash_rel;
using namespace flash_rel::hopper;
using namespace flash_rel::hopper::wide;

// Ablations, for tools/forward_ablation.py alone (each a wrong result, timed
// and nothing else): -DCMGAN_FWD_ABLATE=<bits>, 1 leaves out P . V (and its
// stages of V), 2 takes every tile pair as clipped (no window, no R, no
// band), 4 the softmax's exponentials
#ifndef CMGAN_FWD_ABLATE
#define CMGAN_FWD_ABLATE 0
#endif
constexpr int kAblate = CMGAN_FWD_ABLATE;
constexpr int kNoValues = 1, kNoPosition = 2, kNoExp = 4;

constexpr int HALF = 160;  // output columns a consumer warpgroup accumulates, at most, a pass

// The passes at head dim d: the fewest of at most 2 * HALF columns; each of
// equal width rounded up to 16, half of it a consumer warpgroup's
// (ops/flash_attention.py:_fwd_passes mirrors these)
__host__ __device__ constexpr int fwd_passes(int d) { return (d + 2 * HALF - 1) / (2 * HALF); }
__host__ __device__ constexpr int fwd_half(int d) {
  return ((d + fwd_passes(d) - 1) / fwd_passes(d) + 15) / 16 * 8;
}
// the instantiation's accumulator columns a warpgroup for that half
__host__ __device__ constexpr int acc_cols(int half) { return half <= 64 ? 64 : half <= 128 ? 128 : HALF; }

// the tile pair's kind (kNoPosition: every pair taken as clipped)
__device__ __forceinline__ int pair_kind(int base, int max_pos) {
  const int kind = clip_kind(base, WQ, max_pos);
  return (kAblate & kNoPosition) && kind == kMixed ? kHigh : kind;
}

template <typename T, int NO>
struct Cfg {
  static constexpr int P = Parts<T>::N;
  static constexpr int STAGE = P * PLANE;
  static constexpr int PT = P * TILE;          // P: 64 queries x 64 keys, P planes
  static constexpr int XCH = 2 * NCW * 64 * 4; // each warpgroup's row maxima, then its row sums
  static constexpr int FIT = (MAX_SMEM - 1024 - PT - BAND - XCH) / (STAGE + 16);
  static constexpr int STAGES = FIT < 12 ? FIT : 12;
  static_assert(STAGES >= 3, "a tile holds two stages at once, and the producer one more");
  static constexpr int PT_OFF = STAGES * STAGE;
  static constexpr int BAND_OFF = PT_OFF + PT;
  static constexpr int XCH_OFF = BAND_OFF + BAND;
  static constexpr int BAR_OFF = XCH_OFF + XCH;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // 1024: the base's alignment
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
  // the output's accumulators: FULL sub-chunks of 64 columns, then one of LAST
  static constexpr int FULL = (NO - 1) / CH;
  static constexpr int LAST = NO - CH * FULL;
  static constexpr int SUBS = FULL + 1;
};

// A warpgroup's output columns: rows 16wp + g (+ 8), columns 8n + 2t4 (+ 1)
// of sub-chunk s in full[s][4n + 2rr + e] (s < FULL) or last[...]
template <int FULL, int LAST>
struct Out {
  float full[FULL > 0 ? FULL : 1][32];
  float last[LAST / 2];
};

// acc (+)= P . V over the 64 keys, N columns of V: V MN-major from v, P
// K-major at p_s; bf16 straight onto acc, fp32 from zero (its part products
// smallest first) and added in fp32
template <int P, int N>
__device__ __forceinline__ void values(float (&acc)[N / 2], uint32_t p_s, uint32_t v) {
  if constexpr (P == 1) {
    wgmma_fence();
    chain<N, P, 4, 0, 1, true>(acc, KMaj{opaque(p_s), TILE}, MMaj{v, PLANE});
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    float x[N / 2];
    wgmma_fence();
    chain<N, P, 4, 0, 1>(x, KMaj{opaque(p_s), TILE}, MMaj{v, PLANE});
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    add_into(acc, x, false);
  }
}

// acc's columns c0 + 8n + 2t4 + e, below c_end, divided by the rows' sums
template <int N, typename T>
__device__ __forceinline__ void write_out(const float (&acc)[N / 2], T* orow0, T* orow1, const float (&inv)[2],
                                          int c0, int c_end, int t4) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * n + 2 * t4 + e;
      if (col >= c_end) continue;
      if (orow0 != nullptr) narrow(acc[4 * n + e] * inv[0], orow0 + col);
      if (orow1 != nullptr) narrow(acc[4 * n + 2 + e] * inv[1], orow1 + col);
    }
  }
}

template <typename T, int NO>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_e,
                   const Planes pl, const T* __restrict__ q, const T* __restrict__ table,
                   T* __restrict__ out, float* __restrict__ lse, int G, int Tq, int Tk, int D,
                   int max_pos, int t_valid, int q_offset, int vw, int tma) {
  using C = Cfg<T, NO>;
  constexpr int P = C::P;
  using RingT = Ring<C::STAGE, C::STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + C::BAR_OFF, empty = full + 8 * C::STAGES;

  // warpgroup and warp indices read from lane 0: uniform for the compiler
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int nch = chunks_of(D), passes = fwd_passes(D), half = fwd_half(D);
  const int subs = (half + CH - 1) / CH;               // stages of V a tile
  const int ks_last = (D - CH * (nch - 1) + 15) / 16;  // depth steps of the last chunk
  const int n_qtiles = (Tq + WQ - 1) / WQ, n_tiles = (t_valid + BK - 1) / BK;
  const long long n_units = static_cast<long long>(G) * n_qtiles * passes;

  if (tid == 0) init_bars(full, empty, C::STAGES);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: a unit's key tiles, each: the logits' chunks, then V's sub-chunks ----
    Producer<P, RingT> pr;
    init_producer(pr, base, full, empty, &map_e, pl, D, max_pos, vw, tma, tid);
    for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int pass = static_cast<int>(u % passes);
      const int i0 = static_cast<int>((u / passes) % n_qtiles) * WQ;
      pr.grp = static_cast<int>(u / (static_cast<long long>(passes) * n_qtiles));
      const size_t qo = static_cast<size_t>(pr.grp) * Tq * pl.ld, ko = static_cast<size_t>(pr.grp) * Tk * pl.ld;
      using Src = typename Producer<P, RingT>::Src;
      const Src sq{&map_q, pl.q + qo, pl.q_plane, Tq}, sk{&map_k, pl.k + ko, pl.k_plane, Tk},
          sv{&map_v, pl.v + ko, pl.k_plane, Tk};
      const int c0 = 2 * half * pass, c1 = c0 + half;  // the warpgroups' first columns
      for (int t = 0; t < n_tiles; ++t) {
        const int j0 = t * BK, base_t = i0 + q_offset - j0 - (BK - 1);
        const bool mixed = pair_kind(base_t, max_pos) == kMixed;
        for (int c = 0; c < nch; ++c) {
          pr.pair(sq, i0, CH * c, sk, j0, CH * c);
          if (mixed) pr.window(base_t + max_pos, CH * c);
        }
        if (kAblate & kNoValues) continue;
        for (int s = 0; s < subs; ++s) {
          // warpgroup 1's sub-chunk only where it holds columns
          const int x1 = c1 + CH * s;
          pr.pair(sv, j0, c0 + CH * s, sv, j0, x1 < D ? x1 : -1);
        }
      }
    }
    pr.settle();
    return;
  }

  // ---- consumers ----
  RingT ring;
  ring.stages = base;
  ring.full = full;
  ring.empty = empty;
  const Lane l0{wgi - 1, warp & 3, lane >> 2, lane & 3}, &l = l0;
  const uint32_t p_s = base + C::PT_OFF;
  float* band = reinterpret_cast<float*>(sbase + C::BAND_OFF);
  float* xmax = reinterpret_cast<float*>(sbase + C::XCH_OFF);  // [warpgroup][query]
  float* xsum = xmax + NCW * 64;

  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int pass = static_cast<int>(u % passes);
    const int i0 = static_cast<int>((u / passes) % n_qtiles) * WQ;
    const int grp = static_cast<int>(u / (static_cast<long long>(passes) * n_qtiles));
    const int col0 = 2 * half * pass + half * l.w;           // this warpgroup's first column
    const int col_end = min(D, col0 + half);
    const int live = col_end > col0 ? (col_end - col0 + CH - 1) / CH : 0;  // its sub-chunks with columns

    // q . E[2*max_pos] and q . E[0] of rows 16wp + g (+ 8), where a tile of the
    // unit is clipped (the first tile has the unit's largest distances, the
    // last its least), a quarter of the head dim a lane
    float sh_hi[2] = {0.f, 0.f}, sh_lo[2] = {0.f, 0.f};
    const int base0 = i0 + q_offset - (BK - 1);
    if (pair_kind(base0, max_pos) != kMixed || pair_kind(base0 - (n_tiles - 1) * BK, max_pos) != kMixed) {
      const Lane l = fresh(l0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = i0 + 16 * l.wp + l.g + 8 * rr;
        float hi = 0.f, lo = 0.f;
        if (row < Tq) {
          const T* qr = q + (static_cast<size_t>(grp) * Tq + row) * D;
          const T* er = table + static_cast<size_t>(2 * max_pos) * D;
          for (int d = l.t4; d < D; d += 4) {
            const float x = widen(qr[d]);
            hi = fmaf(x, widen(er[d]), hi);
            lo = fmaf(x, widen(table[d]), lo);
          }
        }
        sh_hi[rr] = quad_sum(hi);
        sh_lo[rr] = quad_sum(lo);
      }
    }

    Out<C::FULL, C::LAST> o;
#pragma unroll
    for (int s = 0; s < C::FULL; ++s) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o.full[s][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < C::LAST / 2; ++i) o.last[i] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, lsum[2] = {0.f, 0.f};

    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * BK, bw = i0 + q_offset - j0 - (BK - 1);
      const int kind = pair_kind(bw, max_pos);
      const bool mixed = kind == kMixed;

      // S (keys 32w ..) and R (window rows 64w ..) over the depth chunks: bf16
      // straight onto both in the tensor cores, R into the band once a tile;
      // fp32 each chunk from zero, added in fp32 (R in the band)
      float s_acc[16], r_acc[32];
      if constexpr (P == 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) s_acc[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) r_acc[i] = 0.f;
      }
      for (int c = 0; c < nch; ++c) {
        const uint32_t a = opaque(ring.acquire());  // Q_c | K_c
        const int ks = c == nch - 1 ? ks_last : 4;
        if constexpr (P == 1) {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());  // the window, chunk c
            logits_product<P, true>(ks, r_acc, KMaj{a, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE}, s_acc,
                                    KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            ring.release();
            ring.release();
          } else {
            chunk_product<32, P, true>(ks, s_acc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            ring.release();
          }
        } else {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());  // the window, chunk c
            chunk_product<64, P, false>(ks, r_acc, KMaj{a, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE});
            band_put(band, l, r_acc, c == 0);
          }
          float sc[16];
          chunk_product<32, P, false>(ks, sc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
          ring.release();
          if (mixed) ring.release();
          add_into(s_acc, sc, c == 0);
        }
      }
      if (mixed) {
        if constexpr (P == 1) band_put(band, l, r_acc, true);
        consumers_sync();  // the band is whole
      }

      // the position term, the mask, and the row maxima over this warpgroup's keys
      const int nk = t_valid - j0;  // keys at or past nk are masked
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      {
        const Lane l = fresh(l0);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = 32 * l.w + 8 * n + 2 * l.t4 + e;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = 4 * n + 2 * rr + e, a = 16 * l.wp + l.g + 8 * rr;
              const float pos = mixed ? band[a * SKS + BK - 1 - b] : kind == kHigh ? sh_hi[rr] : sh_lo[rr];
              s_acc[i] = b < nk ? s_acc[i] + pos : -CUDART_INF_F;
              mx[rr] = fmaxf(mx[rr], s_acc[i]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          mx[rr] = quad_max(mx[rr]);
          if (l.t4 == 0) xmax[64 * l.w + 16 * l.wp + l.g + 8 * rr] = mx[rr];
        }
      }
      consumers_sync();  // both warpgroups' maxima are in

      // the online softmax on the shared maxima (finite: key j0 is valid and
      // warpgroup 0's); P into shared memory, keys 32w .. of its rows
      float corr[2];
      {
        const Lane l = fresh(l0);
        float ml[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int a = 16 * l.wp + l.g + 8 * rr;
          const float m_new = fmaxf(m[rr], fmaxf(xmax[a], xmax[64 + a]));
          corr[rr] = ex2((m[rr] - m_new) * L2E);
          m[rr] = m_new;
          ml[rr] = m_new * L2E;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int rr = (i >> 1) & 1;
          const float x = fmaf(s_acc[i], L2E, -ml[rr]);
          s_acc[i] = (kAblate & kNoExp) ? x : ex2(x);
          ls[rr] += s_acc[i];
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) lsum[rr] = lsum[rr] * corr[rr] + ls[rr];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int a = 16 * l.wp + l.g + 8 * rr, b0 = 32 * l.w + 8 * n + 2 * l.t4;
            uint32_t u[P];
            parts_of<P>(s_acc[4 * n + 2 * rr], s_acc[4 * n + 2 * rr + 1], u);
            const uint32_t at = swz<128>(a * 128 + 2 * b0);
#pragma unroll
            for (int p = 0; p < P; ++p) st_shared_b32(p_s + p * TILE + at, u[p]);
          }
        }
      }
      fence_proxy_async();
      // the output rescaled to the new maxima
#pragma unroll
      for (int s = 0; s < C::FULL; ++s) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o.full[s][i] *= corr[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < C::LAST / 2; ++i) o.last[i] *= corr[(i >> 1) & 1];
      consumers_sync();  // P is whole

      // O += P . V over this warpgroup's sub-chunks (a stage each, both warpgroups')
      if (!(kAblate & kNoValues)) {
#pragma unroll
        for (int s = 0; s < C::SUBS; ++s) {
          if (s >= subs) break;  // uniform
          const uint32_t v = opaque(ring.acquire()) + TILE * l.w;
          if (s < live) {
            if (s < C::FULL) {
              values<P, CH>(o.full[s < C::FULL ? s : 0], p_s, v);  // (an index in range where dead)
            } else {
              values<P, C::LAST>(o.last, p_s, v);
            }
          }
          ring.release();
        }
      }
    }

    // the row sums: each warpgroup's share, crossed once a unit
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float sum = quad_sum(lsum[rr]);
      if (l.t4 == 0) xsum[64 * l.w + 16 * l.wp + l.g + 8 * rr] = sum;
    }
    consumers_sync();
    {
      const Lane l = fresh(l0);
      T* orow[2];
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int a = 16 * l.wp + l.g + 8 * rr, row = i0 + a;
        const float sum = xsum[a] + xsum[64 + a];
        inv[rr] = 1.f / sum;
        orow[rr] = row < Tq ? out + (static_cast<size_t>(grp) * Tq + row) * D : nullptr;
        if (lse != nullptr && row < Tq && pass == 0 && l.w == 0 && l.t4 == 0) {
          lse[static_cast<size_t>(grp) * Tq + row] = m[rr] + __logf(sum);
        }
      }
#pragma unroll
      for (int s = 0; s < C::FULL; ++s) {
        write_out<CH>(o.full[s], orow[0], orow[1], inv, col0 + CH * s, col_end, l.t4);
      }
      write_out<C::LAST>(o.last, orow[0], orow[1], inv, col0 + CH * C::FULL, col_end, l.t4);
    }
  }
}

// ================================ launches ================================

struct Args {
  const void *q, *k, *v, *table;
  void *out, *lse, *scratch;
  long long scratch_bytes;
  int G, Tq, Tk, D, max_pos, t_valid, q_offset;
  cudaStream_t stream;
};

// fp32's planes in the scratch, in bf16 elements: q, k, v and the table,
// each three planes of rows of ld = D rounded up to 8 columns (zero past D),
// so that every row is a whole number of 16-byte groups and TMA takes it
struct Layout {
  int ld;
  long long q_plane, k_plane, e_plane, elems;
};
Layout layout(int G, int Tq, int Tk, int D, int max_pos) {
  Layout l{};
  l.ld = (D + 7) / 8 * 8;
  l.q_plane = static_cast<long long>(G) * Tq * l.ld;
  l.k_plane = static_cast<long long>(G) * Tk * l.ld;
  l.e_plane = static_cast<long long>(2 * max_pos + 1) * l.ld;
  l.elems = 3 * (l.q_plane + 2 * l.k_plane + l.e_plane);
  return l;
}

template <typename T, int NO>
int launch_kernel(const CUtensorMap (&m)[5], const Planes& pl, const Args& a, int vw, bool tma) {
  using C = Cfg<T, NO>;
  int err = static_cast<int>(
      cudaFuncSetAttribute(flash_rel_wide_fwd<T, NO>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES));
  if (err != 0) return err;
  const long long per_group = static_cast<long long>((a.Tq + WQ - 1) / WQ) * fwd_passes(a.D);
  int grid = 0;
  if ((err = persistent_grid(per_group, a.G * per_group, &grid)) != 0) return err;
  flash_rel_wide_fwd<T, NO><<<static_cast<unsigned>(grid), NT, C::BYTES, a.stream>>>(
      m[0], m[2], m[3], m[4], pl, static_cast<const T*>(a.q), static_cast<const T*>(a.table),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.G, a.Tq, a.Tk, a.D, a.max_pos, a.t_valid,
      a.q_offset, vw, tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a) {
  constexpr int P = Parts<T>::N;
  using bf16_t = __nv_bfloat16;
  // the producer's sources: bf16 as they are; fp32 split into planes
  Planes pl{};
  if constexpr (P == 1) {
    pl = {static_cast<const bf16_t*>(a.q), static_cast<const bf16_t*>(a.k), static_cast<const bf16_t*>(a.v),
          nullptr, static_cast<const bf16_t*>(a.table), 0, 0, 0, a.D};
  } else {
    const Layout l = layout(a.G, a.Tq, a.Tk, a.D, a.max_pos);
    if (a.scratch == nullptr || a.scratch_bytes < 2 * l.elems) return static_cast<int>(cudaErrorInvalidValue);
    bf16_t* dst = static_cast<bf16_t*>(a.scratch);
    bf16_t* dk = dst + 3 * l.q_plane;
    bf16_t* dv = dk + 3 * l.k_plane;
    bf16_t* de = dv + 3 * l.k_plane;
    const Split sp = {{static_cast<const float*>(a.q), static_cast<const float*>(a.k),
                       static_cast<const float*>(a.v), static_cast<const float*>(a.table), nullptr},
                      {dst, dk, dv, de, nullptr},
                      {static_cast<long long>(a.G) * a.Tq, static_cast<long long>(a.G) * a.Tk,
                       static_cast<long long>(a.G) * a.Tk, 2LL * a.max_pos + 1, 0},
                      {l.q_plane, l.k_plane, l.k_plane, l.e_plane, 0},
                      a.D, l.ld};
    const int err = split_planes<4>(sp, a.stream);
    if (err != 0) return err;
    pl = {dst, dk, dv, nullptr, de, static_cast<size_t>(l.q_plane), static_cast<size_t>(l.k_plane),
          static_cast<size_t>(l.e_plane), l.ld};
  }
  // TMA takes rows of whole 16-byte groups: fp32's padded planes always,
  // bf16 where D is a multiple of 8; else the producer's own copies
  const bool tma = P == 3 || a.D % 8 == 0;
  CUtensorMap m[5] = {};
  if (tma) {
    const int err = make_maps(pl, P, a.G, a.Tq, a.Tk, a.D, a.max_pos, m);
    if (err != 0) return err;
  }
  const int vw = load_width(pl.ld);
  switch (acc_cols(fwd_half(a.D))) {
    case 64: return launch_kernel<T, 64>(m, pl, a, vw, tma);
    case 128: return launch_kernel<T, 128>(m, pl, a, vw, tma);
    default: return launch_kernel<T, HALF>(m, pl, a, vw, tma);
  }
}

int smem_of(int is_bf16, int head_dim) {
  switch (acc_cols(fwd_half(head_dim))) {
    case 64: return is_bf16 ? Cfg<__nv_bfloat16, 64>::BYTES : Cfg<float, 64>::BYTES;
    case 128: return is_bf16 ? Cfg<__nv_bfloat16, 128>::BYTES : Cfg<float, 128>::BYTES;
    default: return is_bf16 ? Cfg<__nv_bfloat16, HALF>::BYTES : Cfg<float, HALF>::BYTES;
  }
}

}  // namespace

// Plain C entries for ctypes. The forward at any head dim of 1 or more:
// arguments as flash_rel_attention.cu's cmgan_flash_rel_attention_fwd, and a
// scratch of scratch_bytes bytes (16-byte aligned, not zeroed) at least what
// cmgan_flash_rel_attention_wide_fwd_scratch gives (fp32's planes; bf16
// needs none: null and 0). Launches on `stream` and returns the first CUDA
// error (0 on success) without synchronising.
extern "C" int cmgan_flash_rel_attention_wide_fwd(
    const void* q, const void* k, const void* v, const void* table, void* out, void* lse,
    void* scratch, long long scratch_bytes, int G, int Tq, int Tk, int head_dim, int max_pos,
    int t_valid, int q_offset, int is_bf16, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || head_dim < 1 || q_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {q, k, v, table, out, lse, scratch, scratch_bytes, G, Tq, Tk, head_dim, max_pos,
                  t_valid, q_offset, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// Bytes of scratch the forward needs at these shapes (fp32: the three bf16
// planes of q, k, v and the table; bf16: 0), or -1.
extern "C" long long cmgan_flash_rel_attention_wide_fwd_scratch(int is_bf16, int head_dim, int G, int Tq,
                                                                int Tk, int max_pos) {
  if (G <= 0 || Tq <= 0 || Tk <= 0 || max_pos < 0 || head_dim < 1) return -1;
  return is_bf16 ? 0 : 2 * layout(G, Tq, Tk, head_dim, max_pos).elems;
}

// Dynamic shared memory, in bytes, of one block of the forward at this head
// dim, or -1.
extern "C" int cmgan_flash_rel_attention_fwd_smem(int is_bf16, int head_dim) {
  return head_dim < 1 ? -1 : smem_of(is_bf16, head_dim);
}

// The output columns each consumer warpgroup owns in a pass of the forward
// (which 0), or -1; ops/flash_attention.py:plan computes the same.
extern "C" int cmgan_flash_rel_attention_wide_slab(int head_dim, int which) {
  if (head_dim < 1 || which != 0) return -1;
  return fwd_half(head_dim);
}

// The forward's passes (which 0) at this head dim: how many times it computes
// a tile pair's logits; or -1.
extern "C" int cmgan_flash_rel_attention_wide_passes(int head_dim, int which) {
  if (head_dim < 1 || which != 0) return -1;
  return fwd_passes(head_dim);
}
