// Fused attention with Shaw relative positions, backward, for heads wider
// than 64, on Hopper (sm_90a).
//
// Replaces, for head dims over 64, the TPU kernel
// cmgan_tpu/ops/flash_attention.py:_flash_bwd_kernel (:250; launched by
// _flash_backward, VJP _bwd_at of flash_rel_attention_at), as
// flash_rel_attention_bwd.cu does for head dims 16, 32 and 64: the same
// function, arguments, masks (t_valid, q_offset) and C entries, for any head
// dim D over 64. With
//
//   s_ij  = q_i.k_j + q_i.E[r_ij],  r_ij = clip(i + q_offset - j, +-max_pos) + max_pos
//   p_ij  = exp(s_ij - lse_i)                       (keys j < t_valid, else 0)
//   ds_ij = p_ij * (g_i.v_j - delta_i),  delta_i = g_i.out_i
//
// it computes dq_i = sum_j ds_ij (k_j + E[r_ij]), dk_j = sum_i ds_ij q_i,
// dv_j = sum_i p_ij g_i and dE[r] = the sum of ds_ij q_i over every pair at
// distance row r, in fp32 sums written in the input type (dE in fp32).
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W (989 TFLOP/s of bf16
// tensor products, 3.35 TB/s): eight products of 2*D FLOP a near query-key
// pair (five a clipped one); at G 404, T 641, D 128 that is 0.339 ms in bf16
// and six times that in fp32 (six bf16 part products a product). The bytes
// take a tenth of it.
//
// The design (the pieces it shares with the wide forward are in
// flash_rel_hopper.cuh, namespace wide). Launches on the caller's stream: a
// prologue (each query row's statistics {lse, delta, q.E[2*max_pos],
// q.E[0]}); for fp32, a split of q,
// g, k, v and the table into three bf16 planes, x = x0 + x1 + x2, once (TMA
// cannot split, and each row is read by many tile pairs); the dq/dE kernel
// (queries own); the sum of its blocks' rows of dE; the dk/dv kernel (keys
// own). Both big kernels are persistent blocks of a producer warpgroup and
// two consumer warpgroups, walking units of (group, 64-row tile, pass).
//
// - The head dim in chunks of 64 columns: a chunk tile is 64 rows of 128
//   bytes of bf16 (fp32: three planes), in the 128-byte swizzle, so every
//   product is wgmma with the descriptors of a 64-wide head. Columns past D
//   are zero in shared memory and not computed: the last chunk's logits run
//   only the 16-column depth steps it needs and its output products only the
//   16, 32 or 48 columns it has. Nothing is padded in device memory.
// - The producer fills a ring of stages, each 128 rows of one chunk: two
//   64-row tiles (Q and K, g and V, two warpgroups' K, Q or g) or the 128-row
//   window of the table, by TMA where a row is a multiple of 16 bytes (D a
//   multiple of 8) and the window has no clipped row; else by its own
//   cp.async copies (rows of 200 bytes at D 100; a window's clipped rows
//   repeat the table's ends), one stage kept in flight while it issues the
//   next.
// - A pass: each consumer warpgroup owns one chunk of the output columns (a
//   pass covers 128 columns), and the two share the logits of a tile pair:
//   warpgroup w computes S and dP for keys (dk/dv kernel: queries) 32w ..
//   32w + 31, and R = Q . E_window^T for window rows 64w .. 64w + 63, over
//   every depth chunk, each chunk's product from zero (its part products
//   smallest first) and summed in fp32, so that no long chain adds in the
//   tensor cores' truncating accumulator. R goes into a band in shared
//   memory, R[a][a + x] at [a][x]; after a barrier of the consumers each
//   reads the position logits of its own pairs from it. dS (and dR, ds
//   written skewed: dR[a][a - b + 63] = ds[a][b]), or P^T and dS^T, are
//   written into shared memory as bf16 planes, and every output product
//   reads them as wgmma's A operand: dq += dS . K + dR . E_w, dE_w = dR^T . Q
//   in halves of 64 window rows, dv += P^T . g, dk += dS^T . Q, each fresh
//   a tile and added in fp32. So a tile pair's logits are computed once a
//   pass: once a kernel up to D 128, twice up to 256, three times up to 384.
//   Two barriers of the consumers a tile order the band and the A operands
//   (four in fp32's dq/dE kernel, whose band lies over dS and dR).
// - The registers decide the pass: one chunk of dq with its dE carry and
//   the rows it will add into, or of dk and dv, are 64 to 96 fp32 values a
//   thread, and the logits' share up to 48 more, within the 168 a thread of
//   384. Indices and shared addresses derived from a thread's place are
//   made a phase at a time (Lane, fresh()), not held over the walk.
//
// The table's gradient, in a fixed order with no atomics: a table row is met
// by at most two key tiles of a unit's walk, window half 0 of tile t and half
// 1 of tile t + 1, the same distances held by the same threads (every base is
// q_offset - 63 modulo 64). So half 0 is carried in registers until tile t +
// 1 adds its half 1, and the sum is added by a plain read-modify-write (its
// rows read ahead, behind the tile's products) into the block's own row of
// `partials`, each warpgroup its own columns. Pairs whose distance is
// clipped are summed per query; once a unit, each warpgroup adds them, times
// its queries, into rows 0 and 2*max_pos of its columns.
// flash_rel_sum_partials then adds the blocks' rows in block order. Two runs
// on the same inputs give the same bits.

#include "flash_rel_common.cuh"
#include "flash_rel_hopper.cuh"

namespace {

using namespace flash_rel;
using namespace flash_rel::hopper;
using namespace flash_rel::hopper::wide;

// Ablations, for tools/backward_ablation.py alone (each a wrong result, timed
// and nothing else): -DCMGAN_BWD_ABLATE=<bits>; in the dq/dE kernel 1 leaves
// out the dR writes, 2 dR's products (dq += dR . E_w, dE_w = dR^T . Q, and so
// the read-modify-writes of what they give), 4 those read-modify-writes; 8
// takes every tile pair of both kernels as clipped (no window, no R, no band,
// no dR)
#ifndef CMGAN_BWD_ABLATE
#define CMGAN_BWD_ABLATE 0
#endif
constexpr int kAblate = CMGAN_BWD_ABLATE;
constexpr int kNoDrWrites = 1, kNoDrProducts = 2, kNoFlush = 4, kNoPosition = 8;

constexpr int PASS = NCW * CH;           // output columns a pass: one chunk a consumer warpgroup
constexpr int CSUM = NCW * 64 * 2 * 4;   // dq/dE kernel: each warpgroup's clipped sums a query
constexpr int QSTATS = 64 * 16;          // dk/dv kernel: a query tile's statistics

__host__ __device__ constexpr int passes_of(int d) { return (chunks_of(d) + NCW - 1) / NCW; }

// the tile pair's kind (kNoPosition: every pair taken as clipped)
__device__ __forceinline__ int pair_kind(int base, int max_pos) {
  const int kind = clip_kind(base, WQ, max_pos);
  return (kAblate & kNoPosition) && kind == kMixed ? kHigh : kind;
}

// dR as A, K-major over its 128 window rows: step kk in half kk / 4
struct DrK {
  uint32_t a;
  __device__ __forceinline__ uint64_t operator()(int p, int kk) const {
    return kdesc(opaque(a) + p * 2 * TILE + (kk >> 2) * TILE, kk & 3);
  }
};

// ---- shared memory ----

template <typename T, bool OWNS_Q>
struct Cfg {
  static constexpr int P = Parts<T>::N;
  static constexpr int STAGE = P * PLANE;
  static constexpr int DS = P * TILE;      // dS (dq kernel); each of P^T and dS^T (dk/dv)
  static constexpr int DR = P * 2 * TILE;  // dR: two halves of 64 window rows
  // the band lies apart, except in fp32's dq kernel, whose shared memory
  // holds it only over dS and dR (two more barriers a tile order the two)
  static constexpr bool BAND_OVER = OWNS_Q && P == 3;
  static constexpr int SCR = (OWNS_Q ? DS + DR : 2 * DS) + (BAND_OVER ? 0 : BAND);
  static constexpr int BAND_OFF = BAND_OVER ? 0 : SCR - BAND;  // from the scratch's start
  static_assert(!BAND_OVER || BAND <= DS + DR, "the band fits over dS and dR");
  static constexpr int FIT = (MAX_SMEM - 1024 - SCR - CSUM - QSTATS - 16 * 16) / STAGE;
  static constexpr int STAGES = FIT < 12 ? FIT : 12;
  static_assert(STAGES >= 3, "a step of the walk holds up to three stages at once");
  static constexpr int SCR_OFF = STAGES * STAGE;
  static constexpr int CSUM_OFF = SCR_OFF + SCR;
  static constexpr int QSTATS_OFF = CSUM_OFF + CSUM;
  static constexpr int BAR_OFF = QSTATS_OFF + QSTATS;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // 1024: the base's alignment
  static_assert(BYTES <= MAX_SMEM, "a block's shared memory");
};

// ============================ the dq / dE kernel ============================

template <typename T>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_bwd_q(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_e, const Planes pl,
                     const T* __restrict__ q, const T* __restrict__ table,
                     const float4* __restrict__ stats, T* __restrict__ dq,
                     float* __restrict__ partials, int G, int Tq, int Tk, int D, int max_pos,
                     int t_valid, int q_offset, int vw, int tma, int de_writes) {
  using C = Cfg<T, true>;
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
  const int nch = chunks_of(D), passes = passes_of(D);
  const int ks_last = (D - CH * (nch - 1) + 15) / 16;  // depth steps of the last chunk
  const int n_qtiles = (Tq + WQ - 1) / WQ, n_tiles = (t_valid + BK - 1) / BK;
  const long long n_units = static_cast<long long>(G) * n_qtiles * passes;
  const long long row_floats = static_cast<long long>(2 * max_pos + 1) * D;

  if (tid == 0) init_bars(full, empty, C::STAGES);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: a unit's key tiles, each: the logits' chunks, then the outputs' ----
    Producer<P, RingT> pr;
    init_producer(pr, base, full, empty, &map_e, pl, D, max_pos, vw, tma, tid);
    for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int pass = static_cast<int>(u % passes);
      const int i0 = static_cast<int>((u / passes) % n_qtiles) * WQ;
      pr.grp = static_cast<int>(u / (static_cast<long long>(passes) * n_qtiles));
      const size_t qo = static_cast<size_t>(pr.grp) * Tq * D, ko = static_cast<size_t>(pr.grp) * Tk * D;
      using Src = typename Producer<P, RingT>::Src;
      const Src sq{&map_q, pl.q + qo, pl.q_plane, Tq}, sg{&map_g, pl.g + qo, pl.q_plane, Tq},
          sk{&map_k, pl.k + ko, pl.k_plane, Tk}, sv{&map_v, pl.v + ko, pl.k_plane, Tk};
      // the pass's columns: chunk NCW * pass, and the next where there is one
      const int c0 = CH * NCW * pass, c1 = NCW * pass + 1 < nch ? c0 + CH : -1;
      for (int t = 0; t < n_tiles; ++t) {
        const int j0 = t * BK, base_t = i0 + q_offset - j0 - (BK - 1);
        const bool mixed = pair_kind(base_t, max_pos) == kMixed;
        const int row0 = base_t + max_pos;
        for (int c = 0; c < nch; ++c) {
          pr.pair(sq, i0, CH * c, sk, j0, CH * c);
          if (mixed) pr.window(row0, CH * c);
        }
        for (int c = 0; c < nch; ++c) pr.pair(sg, i0, CH * c, sv, j0, CH * c);
        pr.pair(sk, j0, c0, sk, j0, c1);
        if (mixed) {
          pr.window(row0, c0);
          if (c1 >= 0) pr.window(row0, c1);
          pr.pair(sq, i0, c0, sq, i0, c1);
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
  const int ltid = tid - 128 * wgi;
  const uint32_t ds_s = base + C::SCR_OFF, dr_s = ds_s + C::DS;
  float* band = reinterpret_cast<float*>(sbase + C::SCR_OFF + C::BAND_OFF);
  float* csum = reinterpret_cast<float*>(sbase + C::CSUM_OFF);
  const bool flush_on = de_writes != 0 && !(kAblate & kNoFlush);

  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int pass = static_cast<int>(u % passes);
    const int i0 = static_cast<int>((u / passes) % n_qtiles) * WQ;
    const int grp = static_cast<int>(u / (static_cast<long long>(passes) * n_qtiles));
    const int cw = NCW * pass + l.w;       // this warpgroup's chunk
    const bool has = cw < nch;             // uniform in the warpgroup
    const bool c1_live = NCW * pass + 1 < nch;
    float* part = partials + static_cast<size_t>(blockIdx.x) * row_floats + CH * cw;

    // rows 16wp + g (+ 8): {lse, delta, q . E[2*max_pos], q . E[0]}
    float lse2[2], dlt[2], sh_hi[2], sh_lo[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = i0 + 16 * l.wp + l.g + 8 * rr;
      const float4 s = row < Tq ? stats[static_cast<size_t>(grp) * Tq + row] : make_float4(0.f, 0.f, 0.f, 0.f);
      lse2[rr] = s.x * L2E, dlt[rr] = s.y, sh_hi[rr] = s.z, sh_lo[rr] = s.w;
    }
    float dq_acc[32], carry[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = carry[i] = 0.f;
    bool carried = false;
    int carry_base = 0;
    float c_hi[2] = {0.f, 0.f}, c_lo[2] = {0.f, 0.f};

    // The rows of `part` that a half of dE_w leaves into, by a
    // read-modify-write: window rows dist0 + 16wp + g (+ 8), this warpgroup's
    // columns 8n + 2t4 (+ 1); clipped distances hold zeros and are skipped
    // (fetch reads them ahead, so that their latency hides behind products)
    auto fetch = [&](float (&x)[32], int dist0) {
      const Lane l = fresh(l0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int dist = dist0 + 16 * l.wp + l.g + 8 * rr;
        const bool live = dist > -max_pos && dist < max_pos;
        const float* cell = part + static_cast<size_t>(live ? dist + max_pos : 0) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * l.t4 + e;
            x[4 * n + 2 * rr + e] = live && CH * cw + col < D ? cell[col] : 0.f;
          }
        }
      }
    };
    auto flush = [&](const float (&val)[32], int dist0, const float (&x)[32]) {
      const Lane l = fresh(l0);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int dist = dist0 + 16 * l.wp + l.g + 8 * rr;
        if (dist <= -max_pos || dist >= max_pos) continue;
        float* cell = part + static_cast<size_t>(dist + max_pos) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * l.t4 + e, i = 4 * n + 2 * rr + e;
            if (CH * cw + col < D) cell[col] = x[i] + val[i];
          }
        }
      }
    };
    auto flush_now = [&](const float (&val)[32], int dist0) {
      float x[32];
      fetch(x, dist0);
      flush(val, dist0, x);
    };

    for (int t = 0; t < n_tiles; ++t) {
      const int j0 = t * BK, bw = i0 + q_offset - j0 - (BK - 1);
      const int kind = pair_kind(bw, max_pos);
      const bool mixed = kind == kMixed;
      // the last tile's products on dS and dR are done, where the band lies over them
      if constexpr (C::BAND_OVER) consumers_sync();

      // S (keys 32w ..) and R (window rows 64w ..) over the depth chunks: bf16
      // straight onto S, R with it in one span; fp32 each chunk from zero,
      // added in fp32
      float s_acc[16], dp_acc[16];
      if constexpr (P == 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
      }
      for (int c = 0; c < nch; ++c) {
        const uint32_t a = opaque(ring.acquire());  // Q_c | K_c
        const int ks = c == nch - 1 ? ks_last : 4;
        if constexpr (P == 1) {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());  // the window, chunk c
            float rc[32];
            logits_product<P>(ks, rc, KMaj{a, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE}, s_acc, KMaj{a, PLANE},
                          KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            band_put(band, l, rc, c == 0);
            ring.release();
            ring.release();
          } else {
            chunk_product<32, P, true>(ks, s_acc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            ring.release();
          }
        } else {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());  // the window, chunk c
            float rc[32];
            chunk_product<64, P, false>(ks, rc, KMaj{a, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE});
            band_put(band, l, rc, c == 0);
          }
          float sc[16];
          chunk_product<32, P, false>(ks, sc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
          ring.release();
          if (mixed) ring.release();
          add_into(s_acc, sc, c == 0);
        }
      }
      // dP = g . V^T (keys 32w ..)
      for (int c = 0; c < nch; ++c) {
        const uint32_t a = opaque(ring.acquire());  // g_c | V_c
        const int ks = c == nch - 1 ? ks_last : 4;
        if constexpr (P == 1) {
          chunk_product<32, P, true>(ks, dp_acc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
        } else {
          float pc[16];
          chunk_product<32, P, false>(ks, pc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
          add_into(dp_acc, pc, c == 0);
        }
        ring.release();
      }
      consumers_sync();  // the band is whole

      // the position term, the mask, p = exp(s - lse), ds = p (dp - delta) into dp_acc
      const int nk = t_valid - j0;
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
            const float p = b < nk ? ex2(fmaf(s_acc[i] + pos, L2E, -lse2[rr])) : 0.f;
            dp_acc[i] = p * (dp_acc[i] - dlt[rr]);
          }
        }
      }
      }
      if constexpr (C::BAND_OVER) consumers_sync();  // every read of the band is done

      // dS (keys 32w ..) and, a mixed pair, dR[a][a - b + 63] = ds[a][b] (zero
      // where the pair's own distance is clipped: its ds joins its query's
      // sum) with a zero at the same column of the other half, so that the
      // two warpgroups write every cell of both halves
      const bool clips = bw + 2 * BK - 2 >= max_pos || bw <= -max_pos;  // uniform
      {
      const Lane l = fresh(l0);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int a = 16 * l.wp + l.g + 8 * rr, b0 = 32 * l.w + 8 * n + 2 * l.t4;
          const float v0 = dp_acc[4 * n + 2 * rr], v1 = dp_acc[4 * n + 2 * rr + 1];
          if (!mixed) {
            if (kind == kHigh) {
              c_hi[rr] += v0 + v1;
            } else {
              c_lo[rr] += v0 + v1;
            }
          }
          uint32_t u[P];
          parts_of<P>(v0, v1, u);
          const uint32_t o = swz<128>(a * 128 + 2 * b0);
#pragma unroll
          for (int p = 0; p < P; ++p) st_shared_b32(ds_s + p * TILE + o, u[p]);
          if (!mixed) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = a - (b0 + e) + BK - 1, dist = bw + c;
            bool clipped = false;
            if (clips) {
              if (dist >= max_pos) {
                c_hi[rr] += e ? v1 : v0;
                clipped = true;
              } else if (dist <= -max_pos) {
                c_lo[rr] += e ? v1 : v0;
                clipped = true;
              }
            }
            if constexpr (!(kAblate & kNoDrWrites)) {
              const uint32_t cell = swz<128>(a * 128 + 2 * (c & 63));
              const uint32_t mine = dr_s + (c >> 6) * TILE + cell, other = dr_s + (1 - (c >> 6)) * TILE + cell;
#pragma unroll
              for (int p = 0; p < P; ++p) {
                st_shared_u16(mine + p * 2 * TILE, clipped ? 0u : e ? u[p] >> 16 : u[p] & 0xffffu);
                st_shared_u16(other + p * 2 * TILE, 0u);
              }
            }
          }
        }
      }
      }
      fence_proxy_async();
      consumers_sync();  // dS and dR are whole

      // dq (this warpgroup's chunk) += dS . K_c + dR . E_c; dE_w = dR^T . Q_c;
      // the rows half 1 leaves into read ahead, behind these products
      const bool leaves = mixed && has && flush_on && !(kAblate & kNoDrProducts);
      float ahead[32];
      if (leaves) fetch(ahead, bw + BK);
      const uint32_t sd = opaque(ring.acquire());  // K_c0 | K_c1
      float qs[32];
      const bool dr_products = mixed && !(kAblate & kNoDrProducts);
      if constexpr (P == 1) {
        // bf16: both products straight onto dq, one wait (bf16's own rounding
        // is far above the accumulator's over a unit's walk); the windows of
        // chunks c0 and c1 taken with K's stage (its ring has room for three)
        const uint32_t e0 = mixed ? opaque(ring.acquire()) : 0;
        const uint32_t e1 = mixed && c1_live ? opaque(ring.acquire()) : e0;
        if (has) {
          wgmma_fence();
          chain<64, P, 4, 0, 1, true>(dq_acc, KMaj{opaque(ds_s), TILE}, MMaj{sd + TILE * l.w, PLANE});
          if (dr_products) {
            chain<64, P, 8, 0, 1, true>(dq_acc, DrK{opaque(dr_s)}, MMaj{l.w == 0 ? e0 : e1, PLANE});
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq_acc);
        }
        ring.release();
        if (mixed) ring.release();
        if (mixed && c1_live) ring.release();
      } else {
        // fp32: each product from zero, added in fp32; K's stage released
        // before the windows are taken (a ring of three stages must never
        // be held whole: its last may wait on the producer's next)
        if (has) {
          wgmma_fence();
          chain<64, P, 4, 0, 1>(qs, KMaj{opaque(ds_s), TILE}, MMaj{sd + TILE * l.w, PLANE});
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(qs);
          add_into(dq_acc, qs, false);
        }
        ring.release();
        if (mixed) {
          const uint32_t e0 = opaque(ring.acquire());
          const uint32_t e1 = c1_live ? opaque(ring.acquire()) : e0;
          if (has && dr_products) {
            wgmma_fence();
            chain<64, P, 8, 0, 1>(qs, DrK{opaque(dr_s)}, MMaj{l.w == 0 ? e0 : e1, PLANE});
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(qs);
            add_into(dq_acc, qs, false);
          }
          ring.release();
          if (c1_live) ring.release();
        }
      }
      if (mixed) {
        const uint32_t f = opaque(ring.acquire());  // Q_c0 | Q_c1
        if (has && !(kAblate & kNoDrProducts)) {
          // half 1 (distances bw + 64 ..) and the carry: the same distances
          wgmma_fence();
          chain<64, P, 4, 1, 1>(qs, MMaj{opaque(dr_s) + TILE, 2 * TILE}, MMaj{f + TILE * l.w, PLANE});
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(qs);
          if (carried) add_into(qs, carry, false);
          // half 0, the next carry, runs while half 1 leaves
          wgmma_fence();
          chain<64, P, 4, 1, 1>(carry, MMaj{opaque(dr_s), 2 * TILE}, MMaj{f + TILE * l.w, PLANE});
          wgmma_commit();
          if (flush_on) flush(qs, bw + BK, ahead);
          wgmma_wait<0>();
          fence_regs(carry);
          carried = true;
          carry_base = bw;
        }
        ring.release();
      } else if (carried) {
        if (flush_on) flush_now(carry, carry_base);
        carried = false;
      }
    }
    if (carried && flush_on) flush_now(carry, carry_base);

    // the clipped pairs: each query's sums over both warpgroups' keys
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float h = quad_sum(c_hi[rr]), lo = quad_sum(c_lo[rr]);
      if (l.t4 == 0) {
        const int a = 16 * l.wp + l.g + 8 * rr;
        csum[(l.w * 64 + a) * 2] = h;
        csum[(l.w * 64 + a) * 2 + 1] = lo;
      }
    }
    consumers_sync();
    if (has) {
      // dq += c_hi E[2*max_pos] + c_lo E[0], written in the input type
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int a = 16 * l.wp + l.g + 8 * rr, row = i0 + a;
        if (row >= Tq) continue;
        const float ch = csum[2 * a] + csum[(64 + a) * 2], cl = csum[2 * a + 1] + csum[(64 + a) * 2 + 1];
        T* o = dq + (static_cast<size_t>(grp) * Tq + row) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = CH * cw + 8 * n + 2 * l.t4 + e;
            if (col >= D) continue;
            const float eh = widen(table[static_cast<size_t>(2 * max_pos) * D + col]), el = widen(table[col]);
            narrow(dq_acc[4 * n + 2 * rr + e] + ch * eh + cl * el, o + col);
          }
        }
      }
      // the clipped pairs' dE: rows 2*max_pos and 0 += sum_a c[a] q[a], a
      // column a thread (no window row reaches them: one row where max_pos is 0)
      if (flush_on && ltid < CH && CH * cw + ltid < D) {
        const int col = CH * cw + ltid;
        float hi = 0.f, lo = 0.f;
        for (int a = 0; a < WQ && i0 + a < Tq; ++a) {
          const float x = widen(q[(static_cast<size_t>(grp) * Tq + i0 + a) * D + col]);
          hi += (csum[2 * a] + csum[(64 + a) * 2]) * x;
          lo += (csum[2 * a + 1] + csum[(64 + a) * 2 + 1]) * x;
        }
        part[static_cast<size_t>(2 * max_pos) * D + ltid] += hi;
        part[ltid] += lo;
      }
    }
  }
}

// ============================ the dk / dv kernel ============================

template <typename T>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_bwd_kv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                      const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_e, const Planes pl,
                      const float4* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int G, int Tq, int Tk, int D, int max_pos, int t_valid,
                      int q_offset, int vw, int tma) {
  using C = Cfg<T, false>;
  constexpr int P = C::P;
  using RingT = Ring<C::STAGE, C::STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t full = base + C::BAR_OFF, empty = full + 8 * C::STAGES;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int nch = chunks_of(D), passes = passes_of(D);
  const int ks_last = (D - CH * (nch - 1) + 15) / 16;  // depth steps of the last chunk
  const int n_ktiles = (Tk + BK - 1) / BK, n_qtiles = (Tq + WQ - 1) / WQ;
  const long long n_units = static_cast<long long>(G) * n_ktiles * passes;

  if (tid == 0) init_bars(full, empty, C::STAGES);
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: a unit's query tiles, each: the logits' chunks, then g and Q ----
    Producer<P, RingT> pr;
    init_producer(pr, base, full, empty, &map_e, pl, D, max_pos, vw, tma, tid);
    for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int pass = static_cast<int>(u % passes);
      const int j0 = static_cast<int>((u / passes) % n_ktiles) * BK;
      if (j0 >= t_valid) continue;  // keys wholly masked: zeros, nothing staged
      pr.grp = static_cast<int>(u / (static_cast<long long>(passes) * n_ktiles));
      const size_t qo = static_cast<size_t>(pr.grp) * Tq * D, ko = static_cast<size_t>(pr.grp) * Tk * D;
      using Src = typename Producer<P, RingT>::Src;
      const Src sq{&map_q, pl.q + qo, pl.q_plane, Tq}, sg{&map_g, pl.g + qo, pl.q_plane, Tq},
          sk{&map_k, pl.k + ko, pl.k_plane, Tk}, sv{&map_v, pl.v + ko, pl.k_plane, Tk};
      // the pass's columns: chunk NCW * pass, and the next where there is one
      const int c0 = CH * NCW * pass, c1 = NCW * pass + 1 < nch ? c0 + CH : -1;
      for (int t = 0; t < n_qtiles; ++t) {
        const int i0 = t * WQ, base_t = i0 + q_offset - j0 - (BK - 1);
        const bool mixed = pair_kind(base_t, max_pos) == kMixed;
        for (int c = 0; c < nch; ++c) {
          pr.pair(sk, j0, CH * c, sq, i0, CH * c);
          if (mixed) pr.window(base_t + max_pos, CH * c);
        }
        for (int c = 0; c < nch; ++c) pr.pair(sv, j0, CH * c, sg, i0, CH * c);
        pr.pair(sg, i0, c0, sg, i0, c1);
        pr.pair(sq, i0, c0, sq, i0, c1);
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
  const int ltid = tid - 128 * wgi;
  const uint32_t pt_s = base + C::SCR_OFF, dst_s = pt_s + C::DS;
  float* band = reinterpret_cast<float*>(sbase + C::SCR_OFF + C::BAND_OFF);
  const float4* qstats = reinterpret_cast<const float4*>(sbase + C::QSTATS_OFF);

  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int pass = static_cast<int>(u % passes);
    const int j0 = static_cast<int>((u / passes) % n_ktiles) * BK;
    const int grp = static_cast<int>(u / (static_cast<long long>(passes) * n_ktiles));
    const int cw = NCW * pass + l.w;
    const bool has = cw < nch;
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const int walk = j0 < t_valid ? n_qtiles : 0;

    for (int t = 0; t < walk; ++t) {
      const int i0 = t * WQ, bw = i0 + q_offset - j0 - (BK - 1);
      const int kind = pair_kind(bw, max_pos);
      const bool mixed = kind == kMixed;
      // the query tile's statistics, staged by warpgroup 0 for both
      float4 sq = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l.w == 0 && ltid < WQ && i0 + ltid < Tq) sq = stats[static_cast<size_t>(grp) * Tq + i0 + ltid];

      // S^T = K . Q^T (queries 32w ..) and R = Q . E_w^T (window rows 64w ..),
      // as in the dq kernel
      float s_acc[16], dp_acc[16];
      if constexpr (P == 1) {
#pragma unroll
        for (int i = 0; i < 16; ++i) s_acc[i] = dp_acc[i] = 0.f;
      }
      for (int c = 0; c < nch; ++c) {
        const uint32_t a = opaque(ring.acquire());  // K_c | Q_c
        const int ks = c == nch - 1 ? ks_last : 4;
        if constexpr (P == 1) {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());
            float rc[32];
            logits_product<P>(ks, rc, KMaj{a + TILE, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE}, s_acc,
                          KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            band_put(band, l, rc, c == 0);
            ring.release();
            ring.release();
          } else {
            chunk_product<32, P, true>(ks, s_acc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
            ring.release();
          }
        } else {
          if (mixed) {
            const uint32_t e = opaque(ring.acquire());
            float rc[32];
            chunk_product<64, P, false>(ks, rc, KMaj{a + TILE, PLANE}, KMaj{e + 64 * 128 * l.w, PLANE});
            band_put(band, l, rc, c == 0);
          }
          float sc[16];
          chunk_product<32, P, false>(ks, sc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
          ring.release();
          if (mixed) ring.release();
          add_into(s_acc, sc, c == 0);
        }
      }
      // dP^T = V . g^T
      for (int c = 0; c < nch; ++c) {
        const uint32_t a = opaque(ring.acquire());  // V_c | g_c
        const int ks = c == nch - 1 ? ks_last : 4;
        if constexpr (P == 1) {
          chunk_product<32, P, true>(ks, dp_acc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
        } else {
          float pc[16];
          chunk_product<32, P, false>(ks, pc, KMaj{a, PLANE}, KMaj{a + TILE + 32 * 128 * l.w, PLANE});
          add_into(dp_acc, pc, c == 0);
        }
        ring.release();
      }
      if (l.w == 0 && ltid < WQ) {
        *reinterpret_cast<float4*>(sbase + C::QSTATS_OFF + 16 * ltid) = sq;
      }
      // the band and the statistics are whole; the last tile's products on
      // P^T and dS^T are done
      consumers_sync();

      // keys b (rows 16wp + g (+ 8)), queries a = 32w + 8n + 2t4 + e
      {
      const Lane l = fresh(l0);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = 32 * l.w + 8 * n + 2 * l.t4 + e;
          const float4 s = qstats[a];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = 4 * n + 2 * rr + e, b = 16 * l.wp + l.g + 8 * rr;
            const float pos = mixed ? band[a * SKS + BK - 1 - b] : kind == kHigh ? s.z : s.w;
            const bool ok = j0 + b < t_valid && i0 + a < Tq;
            const float p = ok ? ex2(fmaf(s_acc[i] + pos, L2E, -s.x * L2E)) : 0.f;
            s_acc[i] = p;
            dp_acc[i] = p * (dp_acc[i] - s.y);
          }
        }
      }
      // P^T and dS^T: rows b, columns a (queries 32w ..)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int b = 16 * l.wp + l.g + 8 * rr, a0 = 32 * l.w + 8 * n + 2 * l.t4;
          const uint32_t o = swz<128>(b * 128 + 2 * a0);
          uint32_t up[P], ud[P];
          parts_of<P>(s_acc[4 * n + 2 * rr], s_acc[4 * n + 2 * rr + 1], up);
          parts_of<P>(dp_acc[4 * n + 2 * rr], dp_acc[4 * n + 2 * rr + 1], ud);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            st_shared_b32(pt_s + p * TILE + o, up[p]);
            st_shared_b32(dst_s + p * TILE + o, ud[p]);
          }
        }
      }
      }
      fence_proxy_async();
      consumers_sync();  // P^T and dS^T are whole

      // dv += P^T . g_c, dk += dS^T . Q_c (this warpgroup's chunk): bf16
      // straight onto the sums, one wait; fp32 each from zero, added in fp32
      const uint32_t sg = opaque(ring.acquire());   // g_c0 | g_c1
      const uint32_t sq2 = opaque(ring.acquire());  // Q_c0 | Q_c1
      if constexpr (P == 1) {
        if (has) {
          wgmma_fence();
          chain<64, P, 4, 0, 1, true>(dv_acc, KMaj{opaque(pt_s), TILE}, MMaj{sg + TILE * l.w, PLANE});
          chain<64, P, 4, 0, 1, true>(dk_acc, KMaj{opaque(dst_s), TILE}, MMaj{sq2 + TILE * l.w, PLANE});
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
        }
      } else if (has) {
        float xs[32];
        wgmma_fence();
        chain<64, P, 4, 0, 1>(xs, KMaj{opaque(pt_s), TILE}, MMaj{sg + TILE * l.w, PLANE});
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xs);
        add_into(dv_acc, xs, false);
        wgmma_fence();
        chain<64, P, 4, 0, 1>(xs, KMaj{opaque(dst_s), TILE}, MMaj{sq2 + TILE * l.w, PLANE});
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(xs);
        add_into(dk_acc, xs, false);
      }
      ring.release();
      ring.release();
    }

    if (has) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = j0 + 16 * l.wp + l.g + 8 * rr;
        if (row >= Tk) continue;
        const size_t at = (static_cast<size_t>(grp) * Tk + row) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = CH * cw + 8 * n + 2 * l.t4 + e;
            if (col >= D) continue;
            narrow(dk_acc[4 * n + 2 * rr + e], dk + at + col);
            narrow(dv_acc[4 * n + 2 * rr + e], dv + at + col);
          }
        }
      }
    }
  }
}

// ============================ small kernels ============================

// Each query row's statistics {lse, delta = g . out, q . E[2*max_pos], q . E[0]}
// (delta also to `delta`), a warp a row
template <typename T>
__global__ void flash_rel_wide_bwd_prologue(const T* __restrict__ out, const T* __restrict__ gout,
                                            const T* __restrict__ q, const T* __restrict__ table,
                                            const float* __restrict__ lse, float* __restrict__ delta,
                                            float4* __restrict__ stats, long long rows, int D,
                                            int max_pos) {
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together
  const size_t at = static_cast<size_t>(r) * D, hi_row = static_cast<size_t>(2 * max_pos) * D;
  float d = 0.f, hi = 0.f, lo = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float x = widen(q[at + c]);
    d += widen(out[at + c]) * widen(gout[at + c]);
    hi += x * widen(table[hi_row + c]);
    lo += x * widen(table[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
    hi += __shfl_xor_sync(0xffffffffu, hi, off);
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
  }
  if (lane == 0) {
    delta[r] = d;
    stats[r] = make_float4(lse[r], d, hi, lo);
  }
}

// dE[e] = the sum over the blocks' rows of partial sums, in block order
__global__ void flash_rel_sum_partials(const float* __restrict__ partials, float* __restrict__ dtable,
                                       int n_rows, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < n_rows; ++b) acc += partials[static_cast<size_t>(b) * n + e];
  dtable[e] = acc;
}

// ================================ launches ================================

struct Args {
  const void *q, *k, *v, *table, *out, *gout, *lse;
  void *dq, *dk, *dv, *delta, *dtable, *partials;
  int G, Tq, Tk, D, max_pos, t_valid, q_offset, partial_rows;
  cudaStream_t stream;
};

// the dq kernel writes the table's gradient (off only to time it without those writes)
int g_de_writes = 1;

// Where a launch's scratch lies in `partials`, in floats from its start: the
// dq kernel's blocks' rows of partial sums (`grid` rows of n floats), the
// rows' statistics, and fp32's planes of q, g, k, v and the table (each plane
// a multiple of 8 elements, so that every plane starts at 16 bytes)
struct Layout {
  int grid;
  long long n, stats_at, planes_at, q_plane, k_plane, e_plane, floats;
};
int layout(bool bf16, int G, int Tq, int Tk, int D, int max_pos, Layout* l) {
  const long long per_group = static_cast<long long>((Tq + WQ - 1) / WQ) * passes_of(D);
  const int err = persistent_grid(per_group, G * per_group, &l->grid);
  if (err != 0) return err;
  l->n = static_cast<long long>(2 * max_pos + 1) * D;
  l->stats_at = round_up(l->grid * l->n, 4);
  l->planes_at = l->stats_at + 4LL * G * Tq;
  l->q_plane = round_up(static_cast<long long>(G) * Tq * D, 8);
  l->k_plane = round_up(static_cast<long long>(G) * Tk * D, 8);
  l->e_plane = round_up(l->n, 8);
  l->floats = l->planes_at + (bf16 ? 0 : 3 * (2 * l->q_plane + 2 * l->k_plane + l->e_plane) / 2);
  return 0;
}
int rows_of(long long floats, long long n) {
  const long long rows = (floats + n - 1) / n;
  return rows > 0x7fffffffLL ? -static_cast<int>(cudaErrorInvalidValue) : static_cast<int>(rows);
}

template <typename T>
int launch(const Args& a) {
  using QC = Cfg<T, true>;
  using KC = Cfg<T, false>;
  constexpr int P = Parts<T>::N;
  Layout l{};
  int err = layout(P == 1, a.G, a.Tq, a.Tk, a.D, a.max_pos, &l);
  if (err != 0) return err;
  const int rows = rows_of(l.floats, l.n);
  if (rows < 0) return -rows;
  if (rows > a.partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  float* partials = static_cast<float*>(a.partials);
  float4* stats = reinterpret_cast<float4*>(partials + l.stats_at);

  // zeros for the dq kernel's rows of partial sums; the rows' statistics
  err = static_cast<int>(cudaMemsetAsync(partials, 0, sizeof(float) * l.grid * l.n, a.stream));
  if (err != 0) return err;
  const long long qrows = static_cast<long long>(a.G) * a.Tq;
  flash_rel_wide_bwd_prologue<T><<<static_cast<unsigned>((qrows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.gout), static_cast<const T*>(a.q),
      static_cast<const T*>(a.table), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      stats, qrows, a.D, a.max_pos);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  // the producers' sources: bf16 as they are; fp32 split into planes
  using bf16_t = __nv_bfloat16;
  Planes pl{};
  if constexpr (P == 1) {
    pl = {static_cast<const bf16_t*>(a.q), static_cast<const bf16_t*>(a.k), static_cast<const bf16_t*>(a.v),
          static_cast<const bf16_t*>(a.gout), static_cast<const bf16_t*>(a.table), 0, 0, 0, a.D};
  } else {
    bf16_t* base = reinterpret_cast<bf16_t*>(partials + l.planes_at);
    bf16_t* dst[5] = {base, base + 3 * l.q_plane, base + 6 * l.q_plane, base + 6 * l.q_plane + 3 * l.k_plane,
                      base + 6 * l.q_plane + 6 * l.k_plane};
    const long long rq = static_cast<long long>(a.G) * a.Tq, rk = static_cast<long long>(a.G) * a.Tk;
    const Split sp = {{static_cast<const float*>(a.q), static_cast<const float*>(a.gout),
                       static_cast<const float*>(a.k), static_cast<const float*>(a.v),
                       static_cast<const float*>(a.table)},
                      {dst[0], dst[1], dst[2], dst[3], dst[4]},
                      {rq, rq, rk, rk, 2LL * a.max_pos + 1},
                      {l.q_plane, l.q_plane, l.k_plane, l.k_plane, l.e_plane},
                      a.D, a.D};
    if ((err = split_planes<5>(sp, a.stream)) != 0) return err;
    pl = {dst[0], dst[2], dst[3], dst[1], dst[4], static_cast<size_t>(l.q_plane),
          static_cast<size_t>(l.k_plane), static_cast<size_t>(l.e_plane), a.D};
  }
  const bool tma = a.D % 8 == 0;
  CUtensorMap m[5] = {};
  if (tma && (err = make_maps(pl, P, a.G, a.Tq, a.Tk, a.D, a.max_pos, m)) != 0) return err;
  const int vw = load_width(a.D);

  // dq and the table's gradient (the statistics above first: same stream)
  err = static_cast<int>(cudaFuncSetAttribute(flash_rel_wide_bwd_q<T>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, QC::BYTES));
  if (err != 0) return err;
  flash_rel_wide_bwd_q<T><<<static_cast<unsigned>(l.grid), NT, QC::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], m[4], pl, static_cast<const T*>(a.q), static_cast<const T*>(a.table),
      stats, static_cast<T*>(a.dq), partials, a.G, a.Tq, a.Tk, a.D, a.max_pos, a.t_valid, a.q_offset,
      vw, tma ? 1 : 0, g_de_writes);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_rel_sum_partials<<<static_cast<unsigned>((l.n + 255) / 256), 256, 0, a.stream>>>(
      partials, static_cast<float*>(a.dtable), l.grid, l.n);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  // dk and dv
  err = static_cast<int>(cudaFuncSetAttribute(flash_rel_wide_bwd_kv<T>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, KC::BYTES));
  if (err != 0) return err;
  const long long per_group = static_cast<long long>((a.Tk + BK - 1) / BK) * passes_of(a.D);
  int grid_k = 0;
  if ((err = persistent_grid(per_group, a.G * per_group, &grid_k)) != 0) return err;
  flash_rel_wide_bwd_kv<T><<<static_cast<unsigned>(grid_k), NT, KC::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], m[4], pl, stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.G,
      a.Tq, a.Tk, a.D, a.max_pos, a.t_valid, a.q_offset, vw, tma ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, with the names and arguments of
// flash_rel_attention_bwd.cu's, for any head dim over 64. Launches on `stream`
// and returns the first CUDA error (0 on success); does not synchronise.
// Scratch from the caller, none of it zeroed: `delta` fp32 [G, Tq] (receives
// delta); `partials` fp32 [partial_rows, (2*max_pos+1)*head_dim] with
// partial_rows at least what cmgan_flash_rel_attention_wide_bwd_rows gives
// for these shapes (the dq kernel's blocks' rows of partial sums, the rows'
// statistics, fp32's planes); `dtable` fp32 [2*max_pos+1, head_dim] receives
// the table's gradient. Pointers are 16-byte aligned.
extern "C" int cmgan_flash_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* table, const void* out,
    const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* dtable, void* partials, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid,
    int q_offset, int is_bf16, int partial_rows, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || head_dim <= 64 ||
      q_offset < 0 || q_offset + Tq > Tk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable, partials,
                  G, Tq, Tk, head_dim, max_pos, t_valid, q_offset, partial_rows,
                  static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// Rows the `partials` scratch needs on the current device for bf16: one a
// persistent block of the dq/dE kernel, then the rows' statistics (fp32 also
// needs its planes: cmgan_flash_rel_attention_wide_bwd_rows). Negative: minus a
// CUDA error.
extern "C" int cmgan_flash_rel_attention_bwd_partial_rows(int is_bf16, int head_dim, int G,
                                                          int Tq, int max_pos) {
  (void)is_bf16;
  if (G <= 0 || Tq <= 0 || max_pos < 0 || head_dim <= 64) return -static_cast<int>(cudaErrorInvalidValue);
  Layout l{};
  const int err = layout(true, G, Tq, Tq, head_dim, max_pos, &l);
  return err != 0 ? -err : rows_of(l.planes_at, l.n);
}

// Rows of `partials` a launch at these shapes needs: those above and, for
// fp32, the three bf16 planes of q, g, k, v and the table. Negative: minus a
// CUDA error.
extern "C" int cmgan_flash_rel_attention_wide_bwd_rows(int is_bf16, int head_dim, int G, int Tq,
                                                       int Tk, int max_pos) {
  if (G <= 0 || Tq <= 0 || Tk <= 0 || max_pos < 0 || head_dim <= 64) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  Layout l{};
  const int err = layout(is_bf16 != 0, G, Tq, Tk, head_dim, max_pos, &l);
  return err != 0 ? -err : rows_of(l.floats, l.n);
}

// Dynamic shared memory, in bytes, of one block of kernel `which` (0: the
// dq/dE kernel, 1: the dk/dv kernel), or -1: the same at every head dim and
// max_pos.
extern "C" int cmgan_flash_rel_attention_bwd_smem(int is_bf16, int head_dim, int which,
                                                  int max_pos) {
  (void)max_pos;
  if (head_dim <= 64 || which < 0 || which > 1) return -1;
  if (which == 0) return is_bf16 ? Cfg<__nv_bfloat16, true>::BYTES : Cfg<float, true>::BYTES;
  return is_bf16 ? Cfg<__nv_bfloat16, false>::BYTES : Cfg<float, false>::BYTES;
}

// The columns a pass of kernel `which` (1: dq/dE, 2: dk/dv) covers, one chunk
// a consumer warpgroup (the last pass may cover fewer), or -1;
// ops/flash_attention.py:plan computes the same.
extern "C" int cmgan_flash_rel_attention_wide_slab(int head_dim, int which) {
  if (head_dim <= 64 || which < 1 || which > 2) return -1;
  return PASS;
}

// The passes of kernel `which` (1, 2) at this head dim: how many times it
// computes a tile pair's logits; or -1.
extern "C" int cmgan_flash_rel_attention_wide_passes(int head_dim, int which) {
  if (head_dim <= 64 || which < 1 || which > 2) return -1;
  return passes_of(head_dim);
}

// Whether the dq kernel writes the table's gradient into its blocks' rows (1,
// the default) or skips those writes (0: dE is then wrong; for timing their
// share only). Returns the setting before.
extern "C" int cmgan_flash_rel_attention_wide_de_writes(int on) {
  const int before = g_de_writes;
  g_de_writes = on != 0;
  return before;
}
