// Fused attention with Shaw relative positions, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cmgan_tpu/ops/flash_attention.py:_flash_kernel
// (:91, launched by _flash_forward at :201; API flash_rel_attention_at).
// Computes, per group g and query i (global position i + q_offset):
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// over keys j < t_valid, with the softmax in fp32. q arrives pre-scaled
// and E unscaled (the caller's contract). q, k, v, out are [G, T, HD]
// contiguous, E is [2*max_pos+1, HD], HD 16, 32 or 64 (flash_rel_common.cuh);
// fp32 or bf16, the output written in the input type. When `lse` is not null
// the row log-sum-exp m + log(l) is written there as fp32 [G, Tq]: the
// backward kernel (flash_rel_attention_bwd.cu) recomputes the weights from it.
//
// Memory is O(T): nothing of size [G, T, T] exists. A block is a producer
// warpgroup and NCW consumer warpgroups of 64 queries each (NCW 3 for bf16 up
// to head dim 32, else 2), persistent: one an SM, each walking items (group,
// tile of 64 * NCW queries) in turn, every item's key tiles of 64 (the
// instructions are in flash_rel_hopper.cuh):
//   producer   fills a ring of stages in shared memory, each a key tile, its
//              value tile and, when a tile pair needs it, the window of E; a
//              full and an empty mbarrier a stage, and two query buffers so
//              that the next item's queries land while this one is worked
//              (setmaxnreg gives most of its registers to the consumers).
//              bf16: one thread issues TMA copies; the warpgroup gathers a
//              window whose rows are clipped. fp32: TMA cannot split an
//              element, so the warpgroup loads the tiles (a tile's K, V and
//              window loads in flight together) and stores each element as
//              three bf16 parts (flash_rel_common.cuh), three planes, before
//              it marks the stage full.
//   consumers  per tile pair of 64 queries and 64 keys (the tile walk of
//              ops/flash_attention.py, `_tile_pairs`):
//                content   S = Q . K^T            wgmma m64n64k16, A and B in shared memory
//                position  R = Q . E_window^T     wgmma m64n128k16 (mixed pairs only),
//                          s[a][b] += R[a][a - b + 63] through a per-warp scratch
//                values    O += P . V            wgmma, P from registers, V MN-major
//              with fp32 accumulators; fp32 inputs as six part products
//              (smallest first; P . V's big one in an accumulator of its
//              own, since the tensor cores' adds truncate), bf16 as one.
//              The online softmax runs on the
//              accumulators in registers, exp2 with log2(e) folded into one
//              FMA and a clipped pair's position logit folded into the
//              exponent; in bf16, P . V also sums the weights (8 more columns
//              of B, the first ones), so bf16's l is the sum of the weights
//              as rounded to bf16 for V, within 2^-9 of the fp32 sum.
// A pair whose every distance is clipped (|i - j| >= max_pos throughout; 64%
// of the pairs at T = 2561, max_pos 512) loads no window and computes no R:
// its position logit is one of two scalars a query, q . E[2*max_pos] or
// q . E[0], computed once an item. A mixed pair's window is the block's
// 64 * NCW + 64 rows of E[clip(base + c, +-max_pos) + max_pos]: one TMA box of
// the table where no row is clipped, else gathered by the producer with the
// clipped rows repeating the table's ends (no extended table: it would need a
// buffer the C entry's arguments do not carry).
//
// What bounds it, on an NVIDIA H100 80GB HBM3, 700.00 W (989 TFLOP/s bf16
// tensor, 3.35 TB/s, 16 exponentials a clock an SM; chip_smoke.py's
// attention_bound): the 16 s segment (G 404, T 2561) fp32 1.214 ms by the
// products (six bf16 part products each), bf16 0.634 ms by the exponentials;
// the 48 kHz 30 s segment (G 1204, T 4801) fp32 11.862 ms, bf16 6.636 ms,
// bound alike. The bytes take a tenth of that. What this design leaves: the consumers take a tile at a
// time (issuing the next tile's S before this one's softmax was measured
// slower: the second S accumulator costs the registers a third warpgroup
// needs), the skew's round trip through shared memory for mixed pairs, fp32
// tiles split by the producer's loads rather than copied by TMA (a staging
// ring does not fit beside the planes at head dims 32 and 64), and a ragged
// last item whose idle warpgroups only keep the ring going. Times: PERF.md.
// A card whose power limit is below 700 W runs slower under load.

#include <numeric>

#include "flash_rel_common.cuh"
#include "flash_rel_hopper.cuh"

namespace {

using namespace flash_rel;
using namespace flash_rel::hopper;

// Ablations, for tools/forward_ablation.py alone (each a wrong result, timed
// and nothing else): -DCMGAN_FWD_ABLATE=<bits>, 1 leaves out P . V, 2 takes
// every tile pair as clipped (no R, no skew), 4 the softmax's exponentials
#ifndef CMGAN_FWD_ABLATE
#define CMGAN_FWD_ABLATE 0
#endif
constexpr int kAblate = CMGAN_FWD_ABLATE;
constexpr int kNoValues = 1, kNoPosition = 2, kNoExp = 4;

template <typename T, int HD>
struct Cfg {
  static constexpr int P = Parts<T>::N;     // bf16 planes of a staged tile
  static constexpr int RB = 2 * HD;         // bytes a staged row
  // consumer warpgroups: three where their registers allow (bf16 up to head
  // dim 32: more warps to hide the softmax's latencies), else two
  static constexpr int NCW = P == 1 && HD <= 32 ? 3 : 2;
  static constexpr int BQ = NCW * WQ;       // queries a block
  static constexpr int WIN = BQ + BK;       // window rows a block stages (BQ + BK - 1 used)
  static constexpr int NT = 128 * (NCW + 1);  // the producer warpgroup and the consumers
  static constexpr int CONSUMERS = 128 * NCW;
  static constexpr int LAYOUT = swizzle_layout(RB);
  static constexpr int SBO = 8 * RB;
  static constexpr int QPL = BQ * RB, KPL = BK * RB, EPL = WIN * RB;  // bytes a plane
  // stages of the ring: as many as fit beside the queries and the R scratch
  static constexpr int STAGES = P == 1 || HD == 16 ? 3 : HD == 32 ? 2 : 1;
  static constexpr int STAGE = P * (2 * KPL + EPL);
  static constexpr int RT = 4 * NCW * RCOLS * RS * 4;   // R scratch of the consumer warps
  // bf16: P . V also sums the weights, through 8 more columns of B whose
  // first is ones (a block of 64 rows after the ring) - the row sums leave
  // the softmax's instructions for the tensor cores. fp32 sums them itself
  // (its tensor cores are the busier part, and its shared memory is full).
  static constexpr bool SUMS = P == 1;
  static constexpr int NV = HD + (SUMS ? 8 : 0);  // columns of P . V
  // query tiles: two buffers, so that a persistent block loads its next
  // item's queries while it works on this one's (one where they do not fit)
  static constexpr int NQ = P == 3 && HD == 64 ? 1 : 2;
  static constexpr int STAGE_OFF = NQ * P * QPL;
  static constexpr int ONES_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int RT_OFF = ONES_OFF + (SUMS ? KPL : 0);
  static constexpr int BAR_OFF = RT_OFF + RT;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * NQ) + 1024;  // 1024: the base's alignment
  // setmaxnreg: 168 registers a thread at launch (65,536 / 384, rounded down
  // to 8) or 128 (/ 512); the producer gives up what the consumers take
  static constexpr int PRODUCER_REGS = NCW == 3 ? 32 : P == 1 ? 40 : 88;
  static constexpr int CONSUMER_REGS = NCW == 3 ? 160 : P == 1 ? 232 : 208;
  static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 65536, "the register file");
};

// Does any warpgroup's tile pair (from query i0 + WQ * wg, keys from j0)
// need the window?
template <int NCW>
__device__ __forceinline__ bool block_needs_window(int i0, int q_offset, int j0, int max_pos) {
  const int base = i0 + q_offset - j0 - (BK - 1);
  bool mixed = false;
#pragma unroll
  for (int wg = 0; wg < NCW; ++wg) mixed |= clip_kind(base + WQ * wg, WQ, max_pos) == kMixed;
  return mixed;
}

// One consumer warpgroup: 64 queries against every key tile.
template <typename T, int HD>
struct Consumer {
  using C = Cfg<T, HD>;
  static constexpr int P = C::P, RB = C::RB;
  uint32_t base, bar_full, bar_empty, qa;  // qa: the warpgroup's queries, plane 0
  int wg, w, g, t4;                        // warpgroup, warp in it (rows 16w ..), lane's row and column
  int i0w, q_offset, max_pos, t_valid;     // i0w: the warpgroup's first query
  int tile0;                               // tiles of the ring the block consumed before this item
  float* rt;                               // the warp's R scratch
  float pos_hi[2], pos_lo[2];              // rows g, g + 8: q . E[2*max_pos], q . E[0]
  float o[C::NV / 2];                      // out rows g, g + 8; columns 8n + 2t, + 1 in o[4n .. 4n + 3]
                                           // (bf16: column HD the row sums)
  float m[2], l[2];                        // running max; this lane's share of the row sums

  __device__ __forceinline__ uint32_t stage(int t) const {
    return base + C::STAGE_OFF + ((tile0 + t) % C::STAGES) * C::STAGE;
  }
  // query a of the warpgroup meets key b of tile t at distance basew(t) + a - b + 63
  __device__ __forceinline__ int basew(int t) const { return i0w + q_offset - t * BK - (BK - 1); }
  __device__ __forceinline__ int kind_of(int t) const { return clip_kind(basew(t), WQ, max_pos); }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(bar_full + 8 * ((tile0 + t) % C::STAGES), ((tile0 + t) / C::STAGES) & 1);
  }

  // Issue tile t's S (and, MIXED, R) products. A wgmma's accumulator must
  // not be written by other instructions between the warpgroup's fence and
  // the wait that completes it (ptxas serializes every wgmma otherwise), so a
  // branch on the kind encloses whole fence-to-wait spans.
  template <bool MIXED>
  __device__ __forceinline__ void issue_logits(int t, float (&sa)[32], float (&ra)[64]) {
    const uint32_t st = stage(t);
    wgmma_fence();
    if constexpr (MIXED) {
      product<P, HD, 128, C::SBO, C::LAYOUT>(ra, qa, C::QPL, st + 2 * P * C::KPL + wg * WQ * RB,
                                             C::EPL);
    }
    product<P, HD, 64, C::SBO, C::LAYOUT>(sa, qa, C::QPL, st, C::KPL);
    wgmma_commit();
    fence_regs(sa);
    if constexpr (MIXED) fence_regs(ra);
  }

  // R's columns 16W .. 16W + 79, the window rows that warp W's queries meet,
  // parked column-major, RS floats a column (no bank conflict for these
  // writes nor for the skewed reads)
  template <int W>
  __device__ __forceinline__ void store_r_at(const float (&ra)[64]) {
#pragma unroll
    for (int n = 2 * W; n < 2 * W + RCOLS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * n - 16 * W + 2 * t4 + e;
        rt[cc * RS + g] = ra[4 * n + e];
        rt[cc * RS + g + 8] = ra[4 * n + 2 + e];
      }
    }
  }
  __device__ __forceinline__ void store_r(const float (&ra)[64]) {
    __syncwarp();  // the previous tile's reads are done
    switch (w) {
      case 0: store_r_at<0>(ra); break;
      case 1: store_r_at<1>(ra); break;
      case 2: store_r_at<2>(ra); break;
      default: store_r_at<3>(ra); break;
    }
    __syncwarp();
  }

  // Tile t's logits (S in sa; a mixed pair's R in the scratch) into weights:
  // the position term, the mask (MASK: the last tile), the online softmax.
  // The weights leave as the A operands of P . V (16 keys a step:
  // accumulator tiles 2kk and 2kk + 1 are the m16n8k16 A layout; bf16
  // rounded, fp32 in three parts); corr is the rescale of the rows' sums.
  template <bool MASK>
  __device__ __forceinline__ void softmax(int t, int kind, float (&sa)[32],
                                          uint32_t (&pa)[BK / 16][P][4], float (&corr)[2]) {
    float shift[2] = {0.f, 0.f};  // a clipped pair's position logit, one a row
    if (kind == kMixed) {
      // row a = 16w + g + 8rr meets key b = 8n + 2t + e at window row
      // c = a - b + 63: scratch column g + 8rr - b + 63 of the warp's
      const float* rg = rt + (g - 2 * t4 + BK - 1) * RS + g;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            sa[4 * n + 2 * rr + e] += rg[(8 * rr - 8 * n - e) * RS + 8 * rr];
          }
        }
      }
    } else {
      shift[0] = kind == kHigh ? pos_hi[0] : pos_lo[0];
      shift[1] = kind == kHigh ? pos_hi[1] : pos_lo[1];
    }
    if constexpr (MASK) {
      const int nk = t_valid - t * BK;  // keys at or past nk are masked
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * n + 2 * t4 + e >= nk) sa[4 * n + e] = sa[4 * n + 2 + e] = -CUDART_INF_F;
        }
      }
    }
    // row maxima and sums in four independent chains a row (short dependences)
    float mx[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float part[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[i] = fmaxf(fmaxf(sa[4 * i + 2 * rr], sa[4 * i + 2 * rr + 1]),
                        fmaxf(sa[4 * i + 16 + 2 * rr], sa[4 * i + 16 + 2 * rr + 1]));
      }
      mx[rr] = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    }
    float ml[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mx[rr]) + shift[rr]);  // finite: key t * BK is valid
      corr[rr] = ex2((m[rr] - m_new) * L2E);
      m[rr] = m_new;
      ml[rr] = (m_new - shift[rr]) * L2E;  // the clipped pair's logit folds into the exponent
    }
    float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float& x = sa[4 * n + 2 * rr + e];
          x = (kAblate & kNoExp) ? fmaf(x, L2E, -ml[rr]) : ex2(fmaf(x, L2E, -ml[rr]));
          if constexpr (!C::SUMS) ls[rr][n % 4] += x;
        }
      }
    }
    if constexpr (C::SUMS) {
      // P . V accumulates onto the rescaled output and row sums
#pragma unroll
      for (int n = 0; n < C::NV / 8; ++n) {
        o[4 * n] *= corr[0];
        o[4 * n + 1] *= corr[0];
        o[4 * n + 2] *= corr[1];
        o[4 * n + 3] *= corr[1];
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] = l[rr] * corr[rr] + ((ls[rr][0] + ls[rr][1]) + (ls[rr][2] + ls[rr][3]));
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (P == 1) {
          pa[kk][0][i] = pack_bf16(sa[8 * kk + 2 * i], sa[8 * kk + 2 * i + 1]);
        } else {
          uint32_t parts[3];
          split3(sa[8 * kk + 2 * i], sa[8 * kk + 2 * i + 1], parts);
          pa[kk][0][i] = parts[0];
          pa[kk][1][i] = parts[1];
          pa[kk][2][i] = parts[2];
        }
      }
    }
  }

  // Issue tile t's P . V: V MN-major (bf16: and the ones block, the
  // leading byte offset on), onto the output (bf16), or (fp32) the six part
  // products smallest first, the big one (0, 0) into a fresh accumulator ob
  // of its own and the five small ones into on: the tensor cores' adds
  // truncate, and a small part's low bits are lost where it meets the big
  __device__ __forceinline__ void issue_values(int t, const uint32_t (&pa)[BK / 16][P][4],
                                               float (&on)[C::NV / 2], float (&ob)[C::NV / 2]) {
    constexpr int first = P == 1 ? 5 : 0;
    const uint32_t va = stage(t) + P * C::KPL;
    const uint32_t lbo = C::SUMS ? base + C::ONES_OFF - va : 16;
    wgmma_fence();
#pragma unroll
    for (int x = first; x < ((kAblate & kNoValues) ? first : 6); ++x) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            smem_desc(va + part_b(x) * C::KPL + 16 * kk * RB, C::SBO, C::LAYOUT, lbo);
        if constexpr (C::SUMS) {
          wgmma_rs<C::NV, false>(o, pa[kk][part_a(x)], db);
        } else if (x == 5) {
          if (kk == 0) {
            wgmma_rs<C::NV, true>(ob, pa[kk][part_a(x)], db);
          } else {
            wgmma_rs<C::NV, false>(ob, pa[kk][part_a(x)], db);
          }
        } else if (x == first && kk == 0) {
          wgmma_rs<C::NV, true>(on, pa[kk][part_a(x)], db);
        } else {
          wgmma_rs<C::NV, false>(on, pa[kk][part_a(x)], db);
        }
      }
    }
    wgmma_commit();
    fence_values(on, ob);
  }
  // the compiler keeps P . V's accumulators as they are across this point
  __device__ __forceinline__ void fence_values(float (&on)[C::NV / 2], float (&ob)[C::NV / 2]) {
    if constexpr (C::SUMS) {
      fence_regs(o);
    } else {
      fence_regs(on);
      fence_regs(ob);
    }
  }

  // fp32: out = out * corr + P . V, in fp32 (the tensor cores' accumulator
  // adds by truncation; a chain over every key would drift). Then the stage
  // is free.
  __device__ __forceinline__ void finish_values(int t, const float (&on)[C::NV / 2],
                                                const float (&ob)[C::NV / 2],
                                                const float (&corr)[2]) {
    if constexpr (!C::SUMS) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] = o[4 * n] * corr[0] + (ob[4 * n] + on[4 * n]);
        o[4 * n + 1] = o[4 * n + 1] * corr[0] + (ob[4 * n + 1] + on[4 * n + 1]);
        o[4 * n + 2] = o[4 * n + 2] * corr[1] + (ob[4 * n + 2] + on[4 * n + 2]);
        o[4 * n + 3] = o[4 * n + 3] * corr[1] + (ob[4 * n + 3] + on[4 * n + 3]);
      }
    }
    mbar_arrive(bar_empty + 8 * ((tile0 + t) % C::STAGES));
  }

  // Tile t's logits, complete: S in sa, a mixed pair's R in the scratch.
  // The wait sits in each branch: ptxas serializes wgmma where the
  // registers of an accumulator in flight are defined by other instructions,
  // as a branch's join would. Returns the kind.
  __device__ __forceinline__ int logits(int t, float (&sa)[32], float (&ra)[64]) {
    wait_full(t);
    const int kind = (kAblate & kNoPosition) && kind_of(t) == kMixed ? kHigh : kind_of(t);
    if (kind == kMixed) {
      issue_logits<true>(t, sa, ra);
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(ra);
      store_r(ra);
    } else {
      issue_logits<false>(t, sa, ra);
      wgmma_wait<0>();
      fence_regs(sa);
    }
    return kind;
  }

  // The rest of tile t, S in sa: softmax, P . V, the output's update.
  template <bool MASK>
  __device__ __forceinline__ void values(int t, int kind, float (&sa)[32], float (&on)[C::NV / 2],
                                         float (&ob)[C::NV / 2], uint32_t (&pa)[BK / 16][P][4]) {
    float corr[2];
    softmax<MASK>(t, kind, sa, pa, corr);
    issue_values(t, pa, on, ob);
    wgmma_wait<0>();
    fence_values(on, ob);
    finish_values(t, on, ob, corr);
  }

  // every key tile in turn, one at a time: the tensor cores run one
  // warpgroup's products while the block's other warpgroups take their
  // softmax
  __device__ __forceinline__ void run(int n_tiles) {
    float sa[32], ra[64];  // S: row g (+ 8), keys 8n + 2t, + 1 in sa[4n .. 4n + 3]; R alike
    float on[C::NV / 2], ob[C::NV / 2];  // fp32: this tile's P . V, small and big parts
    uint32_t pa[BK / 16][P][4];
    const int last = n_tiles - 1;  // the one tile that may hold masked keys
    for (int t = 0; t < last; ++t) values<false>(t, logits(t, sa, ra), sa, on, ob, pa);
    values<true>(last, logits(last, sa, ra), sa, on, ob, pa);
  }
};

// The consumer warpgroups' part of the kernel (wg: which; w: the warp in it):
// the block's items (group, query tile) in turn.
template <typename T, int HD>
__device__ __forceinline__ void consume(const T* __restrict__ q, const T* __restrict__ table,
                                        T* __restrict__ out, float* __restrict__ lse, uint32_t base,
                                        float* rt, int wg, int w, int lane, int n_items,
                                        int n_qtiles, int Tq, int n_tiles, int max_pos,
                                        int t_valid, int q_offset) {
  using C = Cfg<T, HD>;
  const uint32_t bar_full = base + C::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * C::STAGES;
  const uint32_t bar_qempty = bar_qfull + 8 * C::NQ;
  regs_inc<C::CONSUMER_REGS>();
  Consumer<T, HD> c;
  c.base = base;
  c.bar_full = bar_full;
  c.bar_empty = bar_empty;
  c.wg = wg;
  c.w = w;
  c.g = lane >> 2;
  c.t4 = lane & 3;
  c.q_offset = q_offset;
  c.max_pos = max_pos;
  c.t_valid = t_valid;
  c.rt = rt;
  c.tile0 = 0;

  for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
    const int grp = item / n_qtiles;
    const int qb = k % C::NQ;  // the item's query buffer
    c.i0w = (item % n_qtiles) * C::BQ + WQ * wg;
    c.qa = base + qb * C::P * C::QPL + wg * WQ * C::RB;
    if (c.i0w >= Tq) {
      // a ragged last query tile leaves this warpgroup without queries: it
      // only keeps the ring going
      for (int t = 0; t < n_tiles; ++t) {
        c.wait_full(t);
        mbar_arrive(bar_empty + 8 * ((c.tile0 + t) % C::STAGES));
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = c.i0w + 16 * w + c.g + 8 * rr;
        float hi = 0.f, lo = 0.f;
        if (row < Tq) {
          const T* qr = q + (static_cast<size_t>(grp) * Tq + row) * HD;
#pragma unroll
          for (int d = c.t4 * (HD / 4); d < (c.t4 + 1) * (HD / 4); ++d) {
            const float x = widen(qr[d]);
            hi += x * widen(table[2 * max_pos * HD + d]);
            lo += x * widen(table[d]);
          }
        }
        c.pos_hi[rr] = quad_sum(hi);
        c.pos_lo[rr] = quad_sum(lo);
        c.m[rr] = -CUDART_INF_F;
        c.l[rr] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < C::NV / 2; ++i) c.o[i] = 0.f;

      mbar_wait(bar_qfull + 8 * qb, (k / C::NQ) & 1);
      c.run(n_tiles);

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = c.i0w + 16 * w + c.g + 8 * rr;
        // bf16: column HD of the product, held by the quad's first lane
        const float sum = C::SUMS ? __shfl_sync(0xffffffffu, c.o[HD / 2 + 2 * rr], lane & ~3)
                                  : quad_sum(c.l[rr]);
        if (row < Tq) {
          const float inv = 1.f / sum;
          T* orow = out + (static_cast<size_t>(grp) * Tq + row) * HD;
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            narrow2(c.o[4 * n + 2 * rr] * inv, c.o[4 * n + 2 * rr + 1] * inv,
                    orow + 8 * n + 2 * c.t4);
          }
          if (lse != nullptr && c.t4 == 0) {
            lse[static_cast<size_t>(grp) * Tq + row] = c.m[rr] + __logf(sum);
          }
        }
      }
    }
    mbar_arrive(bar_qempty + 8 * qb);  // every product that reads the queries is complete
    c.tile0 += n_tiles;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::NT, 1)
flash_rel_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_e,
              const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ table, T* __restrict__ out, float* __restrict__ lse, int G,
              int Tq, int Tk, int n_qtiles, int max_pos, int t_valid, int q_offset) {
  using C = Cfg<T, HD>;
  constexpr int P = C::P;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar_full = base + C::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * C::STAGES;
  const uint32_t bar_qempty = bar_qfull + 8 * C::NQ;

  // warpgroup and warp indices read from lane 0, so that the compiler knows
  // them uniform: wgmma and setmaxnreg under a branch it takes for divergent
  // are serialized or ignored
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_items = G * n_qtiles;  // (group, query tile), blockIdx.x + k * gridDim.x the block's
  const int n_tiles = (t_valid + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);  // the producer warpgroup (and the TMA bytes)
      mbar_init(bar_empty + 8 * s, C::CONSUMERS);
    }
#pragma unroll
    for (int b = 0; b < C::NQ; ++b) {
      mbar_init(bar_qfull + 8 * b, P == 1 ? 1 : 128);
      mbar_init(bar_qempty + 8 * b, C::CONSUMERS);
    }
    mbar_fence_init();
  }
  if constexpr (C::SUMS) {
    // the ones block: 64 rows, the first column ones, the rest zero, swizzled
    for (int c16 = tid; c16 < C::KPL / 16; c16 += C::NT) {
      const uint32_t at = swz<C::RB>(16 * c16);  // where logical chunk c16 is stored
      const bool first = c16 % (C::RB / 16) == 0;
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(base + C::ONES_OFF + at),
                   "r"(first ? 0x3F80u : 0u), "r"(0u), "r"(0u), "r"(0u)
                   : "memory");
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: every item's queries, then its key tiles, into the ring ----
    regs_dec<C::PRODUCER_REGS>();
    int it = 0;  // tiles of the ring filled so far
    for (int item = blockIdx.x, kq = 0; item < n_items; item += gridDim.x, ++kq) {
      const int grp = item / n_qtiles;
      const int i0 = (item % n_qtiles) * C::BQ;
      const int qb = kq % C::NQ;
      const uint32_t qbuf = base + qb * P * C::QPL;
      mbar_wait(bar_qempty + 8 * qb, ((kq / C::NQ) & 1) ^ 1);
      if constexpr (P == 1) {
        if (tid == 0) {
          mbar_arrive_expect_tx(bar_qfull + 8 * qb, C::QPL);
          tma_load_3d(qbuf, &map_q, bar_qfull + 8 * qb, 0, i0, grp);
        }
      } else {
        split_rows<HD, C::BQ>(qbuf, C::QPL, reinterpret_cast<const float*>(q) +
                              static_cast<size_t>(grp) * Tq * HD, i0, Tq, tid);
        fence_proxy_async();
        mbar_arrive(bar_qfull + 8 * qb);
      }
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % C::STAGES;
        const uint32_t full = bar_full + 8 * s, st = base + C::STAGE_OFF + s * C::STAGE;
        const int j0 = t * BK;
        const bool win = block_needs_window<C::NCW>(i0, q_offset, j0, max_pos);
        const int row0 = i0 + q_offset - j0 - (BK - 1) + max_pos;  // the window's first table row
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        if constexpr (P == 1) {
          // the window by one TMA box where none of its rows is clipped, else
          // gathered by the warpgroup, the clipped rows repeating the ends
          const bool box = win && row0 >= 0 && row0 + C::WIN - 1 <= 2 * max_pos;
          if (tid == 0) {
            mbar_expect_tx(full, 2 * C::KPL + (box ? C::EPL : 0));
            tma_load_3d(st, &map_k, full, 0, j0, grp);
            tma_load_3d(st + C::KPL, &map_v, full, 0, j0, grp);
            if (box) tma_load_2d(st + 2 * C::KPL, &map_e, full, 0, row0);
          }
          if (win && !box) gather_window<HD, C::WIN>(st + 2 * C::KPL, table, row0, max_pos, tid);
          fence_proxy_async();
          mbar_arrive(full);
        } else {
          const size_t kv = static_cast<size_t>(grp) * Tk * HD;
          split_tile<HD, C::WIN>(st, reinterpret_cast<const float*>(k) + kv,
                                 reinterpret_cast<const float*>(v) + kv,
                                 reinterpret_cast<const float*>(table), j0, Tk, win, row0,
                                 2 * max_pos + 1, tid);
          fence_proxy_async();
          mbar_arrive(full);
        }
      }
    }
  } else {
    float* rt = reinterpret_cast<float*>(smem_raw + (base - raw) + C::RT_OFF) +
                (warp - 4) * RCOLS * RS;
    consume<T, HD>(q, table, out, lse, base, rt, wgi - 1, warp & 3, lane, n_items, n_qtiles, Tq,
                   n_tiles, max_pos, t_valid, q_offset);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* table, void* out, void* lse,
           int G, int Tq, int Tk, int max_pos, int t_valid, int q_offset, cudaStream_t s) {
  using C = Cfg<T, HD>;
  static_assert(C::BYTES <= MAX_SMEM, "the forward's tiles fit a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_rel_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq{}, mk{}, mv{}, me{};
  if constexpr (C::P == 1) {
    const cuuint64_t row = C::RB;
    const cuuint64_t dq[3] = {HD, static_cast<cuuint64_t>(Tq), static_cast<cuuint64_t>(G)};
    const cuuint64_t dk[3] = {HD, static_cast<cuuint64_t>(Tk), static_cast<cuuint64_t>(G)};
    const cuuint64_t de[2] = {HD, static_cast<cuuint64_t>(2 * max_pos + 1)};
    const cuuint64_t sq[2] = {row, row * Tq}, sk[2] = {row, row * Tk};
    const cuuint32_t bq[3] = {HD, C::BQ, 1}, bk[3] = {HD, BK, 1}, be[2] = {HD, C::WIN};
    int rc = make_map(&mq, q, 3, dq, sq, bq, C::RB);
    if (rc == 0) rc = make_map(&mk, k, 3, dk, sk, bk, C::RB);
    if (rc == 0) rc = make_map(&mv, v, 3, dk, sk, bk, C::RB);
    if (rc == 0) rc = make_map(&me, table, 2, de, sk, be, C::RB);
    if (rc != 0) return rc;
  }
  // persistent blocks, one an SM, block b taking items b, b + grid, ...: a
  // grid with no factor in common with the query tiles a group, so that no
  // block takes only one tile position (the ragged last tile is the light
  // one; 132 blocks over 4 tiles a group gave a quarter of the blocks only
  // light items)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (Tq + C::BQ - 1) / C::BQ;
  const long long n_items = static_cast<long long>(G) * n_qtiles;
  int blocks = sms;
  while (blocks > 1 && std::gcd(blocks, n_qtiles) != 1) --blocks;
  const dim3 grid(static_cast<unsigned>(n_items < blocks ? n_items : blocks));
  flash_rel_fwd<T, HD><<<grid, C::NT, C::BYTES, s>>>(
      mq, mk, mv, me, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<T*>(out), static_cast<float*>(lse), G, Tq, Tk,
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
    return is_bf16 ? Cfg<__nv_bfloat16, HD>::BYTES : Cfg<float, HD>::BYTES;
  });
}
