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
// q, k, v, out, g, dq, dk, dv are [G, T, HD] contiguous, HD 16, 32 or 64 (a
// template parameter, as in the forward), fp32 or bf16 (every sum in fp32,
// written in the input type); lse is the forward kernel's fp32 [G, Tq] row
// log-sum-exp; dE is written as fp32 [2*max_pos+1, HD]. Memory is O(T): the
// weights are recomputed tile by tile from lse.
//
// Four launches on the caller's stream:
//   flash_rel_bwd_prologue   a row's statistics, one float4 a query (lse,
//       delta = g . out, and the clipped pairs' two position logits q . E[2*max_pos]
//       and q . E[0]); and zeros for the dq kernel's rows of partial sums.
//   flash_rel_bwd_q   owns the queries: dq and the table's gradient.
//   flash_rel_sum_partials   adds the rows of partial sums in row order.
//   flash_rel_bwd_kv  owns the keys: dk and dv.
// Both big kernels are laid out as the forward (flash_rel_attention.cu): a
// persistent block an SM of a producer warpgroup and NCW consumer warpgroups
// of 64 rows each (consumer_warpgroups: 3 in the dk/dv kernel for bf16 up to
// head dim 32, 1 for fp32 at head dim 64, whose tiles fill a block's shared
// memory, else 2), the producer filling a ring of stages (bf16 by TMA in the
// 32/64/128-byte swizzle, the window of E one TMA box where no row is clipped
// and else gathered; fp32 by its own loads, all of a stage's in flight
// together, split into three bf16 planes) and the consumers running every
// product on wgmma (flash_rel_hopper.cuh). fp32 products are the six part
// products of the three planes, smallest first, the big one in accumulator
// columns of its own at head dim 16 (the tensor cores' adds truncate).
//
//   flash_rel_bwd_kv   item: 64 * NCW keys of a group (K and V staged once);
//     stage: a tile of 64 queries, its rows of g, their statistics and the
//     window of E the block's key tiles meet. Keys are the wgmma M rows:
//       S^T  = K . Q^T  +  the position term        (SS, n 64)
//       dP^T = V . g^T                              (SS, n 64)
//     the position term of a mixed pair from R = Q . E_w^T (SS, n 128, waited
//     and parked first) through a skew that crosses the warps (R[a][a + x] in
//     the warpgroup's scratch, a named barrier, then read at x = 63 - b), of
//     a clipped pair one scalar a query (from the statistics). P^T and dS^T
//     stay in registers as the A operands of dv += P^T . g and dk += dS^T . Q
//     (RS, B MN-major), summed in registers over the query walk.
//   flash_rel_bwd_q    item: 64 * NCW queries of a group (Q, g and the rows'
//     statistics staged once); stage: a key tile, its value tile and the
//     window. Queries are the M rows: S and R as in the forward (R first,
//     parked, the skew through a per-warp scratch), dP = g . V^T, dq += dS . K
//     (RS, K MN-major). For a mixed pair ds is written skewed, dR[a][a - b +
//     63] = ds[a][b] (in bf16 while dS . K runs), as two 64 x 64 bf16 halves
//     (three planes in fp32, from dS's own parts): beside the R
//     scratch in bf16 and in fp32 at head dim 16 (its R scratch then holds each
//     query's 64 window rows alone), where the cells outside the
//     parallelogram are zeroed once, else over it, each cell of both halves
//     written every time (b -> c mod 64 is one to one). A tile whose window
//     reaches no clipped distance (most) writes the cells and nothing else.
//     Then dq += dR . E_w (SS) and dE_w = dR^T . Q (SS, A MN-major), each half
//     an accumulator of 64 window rows. fp32 at head dim 16 runs dq's products
//     three wgmma a depth step: each part of A against B's parts side by side
//     (the planes as consecutive swizzle atoms, the leading byte offset a
//     plane apart), n 48 / 32 / 16 in columns of their own.
//
// The table's gradient, in a fixed order and with no atomics. A table row is
// met by at most two key tiles of one warpgroup's walk: window half 0 of tile
// t and half 1 of tile t + 1 are the same distances, held by the same threads.
// So half 0 stays in registers (the carry) until tile t + 1 adds its half 1,
// and the sum then leaves the walk: it is added, by a plain read-modify-write,
// into the warpgroup's own row of the `partials` scratch in global memory
// (zeroed by the prologue). A distance's cell is always the same thread's
// (every base is q_offset - 63 modulo 64), so these adds need no barrier. Pairs
// whose distance is clipped are summed per query in registers; once an item a
// warp adds them, times its queries, into a slot of its own in shared memory,
// and at the end each warpgroup adds its warps' slots in order into rows 0 and
// 2*max_pos of its row. flash_rel_sum_partials adds the rows in order (block,
// then warpgroup). Two runs on the same inputs give the same bits.
//
// What bounds it, on an NVIDIA H100 80GB HBM3, 700.00 W (989 TFLOP/s bf16
// tensor, 3.35 TB/s, 16 exponentials a clock an SM; chip_smoke.py's
// attention_bound): the function is eight products of 2*G*Tq*t_valid*HD FLOP
// (five where a pair is clipped) and one exponential a pair; at the G step's
// shape (G 1616, T 641, HD 16) fp32 1.015 ms (six part products each), bf16
// 0.169 ms, both by the products; the bytes take 0.16 ms in fp32. What this
// design costs over that: two kernels recompute the logits (11 products and
// two exponentials a pair against 8 and 1); R, dR . E and dR^T . Q run over
// the whole 64 x 128 window where half its cells are zero; the skews and dR
// go through shared memory; the position products are narrow (n = HD) wgmma.
// Measured on that card (PERF.md, tools/backward_ablation.py): 7.26 ms fp32
// and 2.71 ms bf16 at that shape, the dq kernel two thirds of either, its
// time mostly the position term (dR's writes, its products and the rows'
// read-modify-writes). A card whose power limit is below 700 W runs slower.

#include <numeric>

#include "flash_rel_common.cuh"
#include "flash_rel_hopper.cuh"

namespace {

using namespace flash_rel;
using namespace flash_rel::hopper;

// Ablations, for tools/backward_ablation.py alone (each a wrong result, timed
// and nothing else): -DCMGAN_BWD_ABLATE=<bits>, in the dq kernel 1 leaves out
// the dR writes, 2 dR's products (dq += dR . E_w, dE_w = dR^T . Q), 4 the
// read-modify-writes of the partial sums, 8 takes every tile pair as clipped
// (no R, no skew, no dR)
#ifndef CMGAN_BWD_ABLATE
#define CMGAN_BWD_ABLATE 0
#endif
constexpr int kAblate = CMGAN_BWD_ABLATE;
constexpr int kNoDrWrites = 1, kNoDrProducts = 2, kNoFlush = 4, kNoPosition = 8;

constexpr int SKS = 68;                 // floats a row of the dk/dv kernel's skew scratch:
                                        // its skewed reads hit 32 banks
constexpr int DR_ROW = 128;             // bytes a row of a dR half (64 window rows, bf16)
constexpr int DR_HALF = 64 * DR_ROW;    // a 64 x 64 bf16 half of dR

// Consumer warpgroups a block: three in the dk/dv kernel for bf16 up to head
// dim 32 (more warps to hide the latencies between its products and its
// CUDA-core work; the dq kernel's registers would not hold three), two
// otherwise, one for fp32 at head dim 64 (its tiles fill a block's shared
// memory).
__host__ __device__ constexpr int consumer_warpgroups(int parts, int hd, bool owns_keys) {
  return parts == 1 ? (owns_keys && hd <= 32 ? 3 : 2) : hd == 64 ? 1 : 2;
}
// setmaxnreg (registers a thread; with one consumer warpgroup none is moved:
// each thread has 255 from the start): the fp32 producer keeps a stage's
// loads in flight, as the forward's does
__host__ __device__ constexpr int producer_regs(int parts, int ncw) {
  return ncw == 3 || parts == 1 ? 40 : 88;
}
__host__ __device__ constexpr int consumer_regs(int parts, int ncw) {
  return ncw == 3 ? 152 : parts == 1 ? 232 : 208;
}
// registers a thread at launch (setmaxnreg moves them between warpgroups)
__host__ __device__ constexpr int launch_regs(int threads) { return 65536 / threads / 8 * 8; }

// fp32 sums the big part product into an accumulator of its own at head dim
// 16; wider heads keep one chain (their registers would not hold two)
template <int P, int HD>
constexpr bool kSplit = P == 3 && HD == 16;

__device__ __forceinline__ void st_shared_v4f(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z),
               "f"(v.w)
               : "memory");
}

// a 16-bit store to shared memory (no memory clobber: these stores are
// ordered by the fence and the barrier that follow them)
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("{\n.reg .b16 h;\ncvt.u16.u32 h, %1;\nst.shared.b16 [%0], h;\n}\n" ::"r"(addr), "r"(v));
}

// the accumulator of 64 x 64 (rows g, g + 8 of the warp; columns 8n + 2t, + 1)
// as the A operands of a product over its columns: tiles 2kk and 2kk + 1 are
// the m16n8k16 A layout; bf16 rounded, fp32 in three parts
template <int P>
__device__ __forceinline__ void to_frags(const float (&s)[32], uint32_t (&f)[BK / 16][P][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (P == 1) {
        f[kk][0][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      } else {
        uint32_t parts[3];
        split3(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], parts);
        f[kk][0][i] = parts[0];
        f[kk][1][i] = parts[1];
        f[kk][2][i] = parts[2];
      }
    }
  }
}
template <int P>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[BK / 16][P][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < P; ++p) fence_regs(f[kk][p]);
  }
}

// d (64 x N) = (ZERO) or += the sum over the parts x in [X0, X1), smallest
// first, and the depth steps kk < K16 of A(part_a(x), kk) . B(part_b(x), kk):
// A and B in shared memory (descriptors from da, db; TA, TB: MN-major), or A
// from registers (chain_rs; B MN-major)
template <int N, int K16, int X0, int X1, bool ZERO, int TA, int TB, typename FA, typename FB>
__device__ __forceinline__ void chain_ss(float (&d)[N / 2], FA da, FB db) {
#pragma unroll
  for (int x = X0; x < X1; ++x) {
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      const uint64_t a = da(part_a(x), kk), b = db(part_b(x), kk);
      if (ZERO && x == X0 && kk == 0) {
        wgmma_ss<N, true, TA, TB>(d, a, b);
      } else {
        wgmma_ss<N, false, TA, TB>(d, a, b);
      }
    }
  }
}
template <int N, int P, int X0, int X1, bool ZERO, typename FB>
__device__ __forceinline__ void chain_rs(float (&d)[N / 2], const uint32_t (&a)[BK / 16][P][4], FB db) {
#pragma unroll
  for (int x = X0; x < X1; ++x) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t b = db(part_b(x), kk);
      if (ZERO && x == X0 && kk == 0) {
        wgmma_rs<N, true>(d, a[kk][part_a(x)], b);
      } else {
        wgmma_rs<N, false>(d, a[kk][part_a(x)], b);
      }
    }
  }
}

// 16 bytes of a row of T, widened
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}

// Each query row's statistics {lse, delta = g . out, q . E[2*max_pos],
// q . E[0]}, TPR threads a row (16 bytes each, the row's loads coalesced);
// delta also to `delta`. Every thread also zeroes its share of n_zero float4s.
template <typename T, int HD>
__global__ void flash_rel_bwd_prologue(const T* __restrict__ out, const T* __restrict__ gout,
                                       const T* __restrict__ q, const T* __restrict__ table,
                                       const float* __restrict__ lse, float* __restrict__ delta,
                                       float4* __restrict__ stats, float4* __restrict__ zero,
                                       long long n_zero, int rows, int max_pos) {
  constexpr int PER = 16 / sizeof(T), TPR = HD / PER;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = tid; e < n_zero; e += threads) zero[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long row = tid / TPR;
  const int part = static_cast<int>(tid % TPR);
  float d = 0.f, hi = 0.f, lo = 0.f;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * HD + part * PER;
    float o[PER], g[PER], x[PER], eh[PER], el[PER];
    load16(out + at, o);
    load16(gout + at, g);
    load16(q + at, x);
    load16(table + static_cast<size_t>(2 * max_pos) * HD + part * PER, eh);
    load16(table + part * PER, el);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      d += o[i] * g[i];
      hi += x[i] * eh[i];
      lo += x[i] * el[i];
    }
  }
#pragma unroll
  for (int s = 1; s < TPR; s <<= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, s);
    hi += __shfl_xor_sync(0xffffffffu, hi, s);
    lo += __shfl_xor_sync(0xffffffffu, lo, s);
  }
  if (row < rows && part == 0) {
    delta[row] = d;
    stats[row] = make_float4(lse[row], d, hi, lo);
  }
}

// dE[e] = the sum over the rows of partial sums, in row order
__global__ void flash_rel_sum_partials(const float* __restrict__ partials, float* __restrict__ dtable,
                                       int n_rows, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int b = 0; b < n_rows; ++b) acc += partials[static_cast<size_t>(b) * n + e];
  dtable[e] = acc;
}

// x, which the compiler may not take for loop-invariant: the descriptors
// made from it are made where they are used, not hoisted out of the walk and
// held in registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// Does any warpgroup's tile pair (64 rows, bases base0 - step * wg) need the window?
template <int NCW>
__device__ __forceinline__ bool needs_window(int base0, int step, int max_pos) {
  bool mixed = false;
#pragma unroll
  for (int wg = 0; wg < NCW; ++wg) mixed |= clip_kind(base0 - step * wg, WQ, max_pos) == kMixed;
  return mixed;
}

// ============================ the dq / dE kernel ============================

template <typename T, int HD>
struct QCfg {
  static constexpr int P = Parts<T>::N;
  static constexpr int RB = 2 * HD;                 // bytes a staged row
  static constexpr int NCW = consumer_warpgroups(P, HD, false);
  static constexpr int BQ = NCW * WQ;               // queries an item
  static constexpr int WIN = BQ + BK;               // window rows a block stages (BQ + BK - 1 used)
  static constexpr int NT = 128 * (NCW + 1);
  static constexpr int CONSUMERS = 128 * NCW;
  static constexpr int LAYOUT = swizzle_layout(RB);
  static constexpr int SBO = 8 * RB;
  static constexpr int QPL = BQ * RB, KPL = BK * RB, EPL = WIN * RB;  // bytes a plane
  static constexpr int STATS = 2 * P * QPL;         // an item's statistics, after its Q and g planes
  static constexpr int ITEM = STATS + 16 * BQ;
  static constexpr int STAGE = P * (2 * KPL + EPL);
  // fp32 at head dim 16: the smaller scratch lets dR lie beside it
  static constexpr bool BAND = P == 3 && HD == 16;
  // a warpgroup's R scratch: each warp's R columns 16w .. 16w + 79 (the
  // forward's layout), or (BAND) each query's 64 window rows, R[a][a + x]
  static constexpr int RT = ((BAND ? 4 * 16 * SKS * 4 : 4 * RCOLS * RS * 4) + 1023) / 1024 * 1024;
  static constexpr int DR = P * 2 * DR_HALF;        // its dR planes
  // dR beside the R scratch where both fit (bf16): the cells outside the
  // parallelogram are zeroed once and stay zero. fp32's planes lie over the
  // R scratch, and every cell is written each mixed tile.
  static constexpr bool APART = P == 1 || BAND;
  static constexpr int SCR = APART ? RT + DR : (RT > DR ? RT : DR);
  static constexpr int SLOTS = NCW * 4 * 2 * HD * 4;  // a warp's sums of its clipped pairs
  static constexpr int ROOM = MAX_SMEM - 1024 - NCW * SCR - SLOTS - 8 * 12;
  static constexpr int NQ = 2 * ITEM + 2 * STAGE <= ROOM ? 2 : 1;  // item buffers
  static constexpr int FIT = (ROOM - NQ * ITEM) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int STAGE_OFF = NQ * ITEM;
  static constexpr int SCR_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int SLOT_OFF = SCR_OFF + NCW * SCR;
  static constexpr int BAR_OFF = SLOT_OFF + SLOTS;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * NQ) + 1024;  // 1024: the base's alignment
  static constexpr int PRODUCER_REGS = producer_regs(P, NCW);
  static constexpr int CONSUMER_REGS = consumer_regs(P, NCW);
  static_assert(STAGES >= 1 && BYTES <= MAX_SMEM, "the dq kernel's tiles fit a block");
  static_assert(NCW == 1 || 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= NT * launch_regs(NT),
                "registers");
};

template <typename T, int HD>
struct QConsumer {
  using C = QCfg<T, HD>;
  static constexpr int P = C::P, RB = C::RB, NB = HD / 8;
  static constexpr bool SPLIT = kSplit<P, HD>;
  // fp32 at head dim 16: dq's products take each part of A against B's parts
  // side by side (B's planes as consecutive swizzle atoms, the leading byte
  // offset a plane apart): A0 . [B0 B1 B2] (n 48), A1 . [B0 B1] (n 32), A2 . B0
  // (n 16), the six part products in three wgmma, each in columns of its own
  static constexpr bool WIDE = SPLIT;
  uint32_t base, bar_full, bar_empty;
  uint32_t qa, ga;       // this item's queries and output gradients of the warpgroup, plane 0
  uint32_t dr;           // the warpgroup's dR planes (shared address)
  float* rt;             // this warp's R scratch
  float* part;           // the warpgroup's row of partial sums
  int wg, w, g, t4;
  int i0w, q_offset, max_pos, t_valid, tile0;
  const float4* srow;    // row g's statistics in the item buffer (row g + 8's: 8 on), read a tile
  float dq[HD / 2];      // rows g, g + 8; columns 8n + 2t, + 1 in dq[4n .. 4n + 3]
  float carry[HD / 2];   // window half 0 of the last mixed tile: distances carry_base + 16w + g (+ 8)
  int carry_base;
  bool carried;
  float c_hi[2], c_lo[2];  // this lane's share of the clipped pairs' ds sums

  __device__ __forceinline__ uint32_t stage(int t) const {
    return base + C::STAGE_OFF + ((tile0 + t) % C::STAGES) * C::STAGE;
  }
  __device__ __forceinline__ int basew(int t) const { return i0w + q_offset - t * BK - (BK - 1); }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(bar_full + 8 * ((tile0 + t) % C::STAGES), ((tile0 + t) / C::STAGES) & 1);
  }

  // R's columns 16W .. 16W + 79, the window rows warp W's queries meet, parked
  // column-major, RS floats a column (the forward's scratch)
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
  // BAND: R[a][c] at [a - 16w][c - a] for c - a in [0, 64), SKS floats a row
  template <int W>
  __device__ __forceinline__ void store_band_at(const float (&ra)[64]) {
#pragma unroll
    for (int n = 2 * W; n < 2 * W + RCOLS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = g + 8 * rr, x = 8 * n + 2 * t4 + e - 16 * W - r;
          if (x >= 0 && x < BK) rt[r * SKS + x] = ra[4 * n + 2 * rr + e];
        }
      }
    }
  }
  __device__ __forceinline__ void store_r(const float (&ra)[64]) {
    __syncwarp();  // the last tile's reads of the scratch are done
    if constexpr (C::BAND) {
      switch (w) {
        case 0: store_band_at<0>(ra); break;
        case 1: store_band_at<1>(ra); break;
        case 2: store_band_at<2>(ra); break;
        default: store_band_at<3>(ra); break;
      }
      __syncwarp();
      return;
    }
    switch (w) {
      case 0: store_r_at<0>(ra); break;
      case 1: store_r_at<1>(ra); break;
      case 2: store_r_at<2>(ra); break;
      default: store_r_at<3>(ra); break;
    }
    __syncwarp();
  }

  // tile t's logits: S (and a mixed pair's R, parked) in sa, dP in pa. The
  // wait sits in each branch (an accumulator in flight must not be defined at
  // a branch's join)
  __device__ __forceinline__ int logits(int t, float (&sa)[32], float (&pa)[32]) {
    const int kind = (kAblate & kNoPosition) && clip_kind(basew(t), WQ, max_pos) == kMixed
                         ? kHigh : clip_kind(basew(t), WQ, max_pos);
    if constexpr (P == 1 && !(kAblate & kNoFlush)) {
      if (kind == kMixed) fetch(pend, basew(t) + BK);
    }
    wait_full(t);
    const uint32_t st = stage(t), qa = opaque(this->qa), ga = opaque(this->ga);
    if (kind == kMixed) {
      // R first, parked, then S and dP: the three accumulators at once would
      // not leave the registers the rest of the tile needs
      float ra[64];
      wgmma_fence();
      product<P, HD, 128, C::SBO, C::LAYOUT>(ra, qa, C::QPL, st + 2 * P * C::KPL + wg * WQ * RB, C::EPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ra);
      store_r(ra);
      wgmma_fence();
      product<P, HD, 64, C::SBO, C::LAYOUT>(sa, qa, C::QPL, st, C::KPL);
      product<P, HD, 64, C::SBO, C::LAYOUT>(pa, ga, C::QPL, st + P * C::KPL, C::KPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(pa);
    } else {
      wgmma_fence();
      product<P, HD, 64, C::SBO, C::LAYOUT>(sa, qa, C::QPL, st, C::KPL);
      product<P, HD, 64, C::SBO, C::LAYOUT>(pa, ga, C::QPL, st + P * C::KPL, C::KPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(pa);
    }
    return kind;
  }

  // the position term, the mask (MASK: the last tile), p = exp(s - lse) in sa
  // and ds = p (dP - delta) in pa
  template <bool MASK>
  __device__ __forceinline__ void weights(int t, int kind, float (&sa)[32], float (&pa)[32]) {
    const float4 row[2] = {srow[0], srow[8]};  // {lse, delta, q . E[2*max_pos], q . E[0]}
    const float lse2[2] = {row[0].x * L2E, row[1].x * L2E}, dlt[2] = {row[0].y, row[1].y};
    float shift[2] = {0.f, 0.f};
    if (kind == kMixed && C::BAND) {
      // row a meets key b at R[a][a + 63 - b]
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            sa[4 * n + 2 * rr + e] += rt[(g + 8 * rr) * SKS + BK - 1 - (8 * n + 2 * t4 + e)];
          }
        }
      }
    } else if (kind == kMixed) {
      // row a = 16w + g + 8rr meets key b = 8n + 2t + e at window row a - b + 63
      const float* rg = rt + (g - 2 * t4 + BK - 1) * RS + g;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) sa[4 * n + 2 * rr + e] += rg[(8 * rr - 8 * n - e) * RS + 8 * rr];
        }
      }
    } else {
      shift[0] = kind == kHigh ? row[0].z : row[0].w;
      shift[1] = kind == kHigh ? row[1].z : row[1].w;
    }
    const int nk = t_valid - t * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !MASK || 8 * n + 2 * t4 + e < nk;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * n + 2 * rr + e;
          const float p = valid ? ex2(fmaf(sa[i] + shift[rr], L2E, -lse2[rr])) : 0.f;
          sa[i] = p;
          pa[i] = p * (pa[i] - dlt[rr]);
        }
      }
    }
  }

  // a clipped tile pair's ds into its queries' sums
  __device__ __forceinline__ void clipped_sums(int kind, const float (&ds)[32]) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[0] += ds[4 * n] + ds[4 * n + 1];
      s[1] += ds[4 * n + 2] + ds[4 * n + 3];
    }
    if (kind == kHigh) {
      c_hi[0] += s[0], c_hi[1] += s[1];
    } else {
      c_lo[0] += s[0], c_lo[1] += s[1];
    }
  }

  // dR[a][c] = ds[a][b], c = a - b + 63, into the warpgroup's two halves
  // (half c / 64, column c mod 64, bf16 parts); where dR lies over the R
  // scratch, a zero at the same column of the other half, so that every cell
  // of both is written once (b -> c mod 64 is one to one), else those cells
  // stay zero. A pair whose own distance is clipped adds into its query's
  // sum instead and leaves a zero.
  __device__ __forceinline__ void write_dr(int t, const float (&ds)[32],
                                           const uint32_t (&df)[BK / 16][P][4]) {
    const int bw = basew(t);
    // uniform in the warpgroup: most mixed pairs hold no clipped distance
    if (bw + 2 * BK - 2 >= max_pos || bw <= -max_pos) {
      write_dr_cells<true>(bw, ds, df);
    } else {
      write_dr_cells<false>(bw, ds, df);
    }
  }
  template <bool CLIPS>
  __device__ __forceinline__ void write_dr_cells(int bw, const float (&ds)[32],
                                                 const uint32_t (&df)[BK / 16][P][4]) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int a = 16 * w + g + 8 * rr;
        // the parts of ds[a][b], b = 8n + 2t (low half) and + 1 (high half):
        // dS's A fragment kk = n / 2, register (n % 2) * 2 + rr
        uint32_t keep = 0xffffffffu;
        if constexpr (CLIPS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = a - (8 * n + 2 * t4 + e) + BK - 1;
            if (bw + c >= max_pos || bw + c <= -max_pos) {
              // fp32: the value from its three parts (exact), so that ds need not stay live
              float v = 0.f;
              if constexpr (P == 1) {
                v = ds[4 * n + 2 * rr + e];
              } else {
#pragma unroll
                for (int q = 2; q >= 0; --q) {
                  const uint32_t h = df[n / 2][q][(n % 2) * 2 + rr];
                  v += __uint_as_float(e ? h & 0xffff0000u : h << 16);
                }
              }
              if (bw + c >= max_pos) {
                c_hi[rr] += v;
              } else {
                c_lo[rr] += v;
              }
              keep &= e ? 0xffffu : 0xffff0000u;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = a - (8 * n + 2 * t4 + e) + BK - 1;
          const uint32_t cell = swz<DR_ROW>(a * DR_ROW + 2 * (c & 63));
          const uint32_t mine = dr + (c >> 6) * DR_HALF + cell, other = dr + (1 - (c >> 6)) * DR_HALF + cell;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint32_t v = df[n / 2][p][(n % 2) * 2 + rr] & keep;
            st_shared_u16(mine + p * 2 * DR_HALF, e ? v >> 16 : v);
            if constexpr (!C::APART) st_shared_u16(other + p * 2 * DR_HALF, 0u);
          }
        }
      }
    }
  }

  // A read-modify-write of 64 window rows of the warpgroup's row of partial
  // sums (this thread's rows 16w + g (+ 8), columns 8n + 2t, + 1) at
  // distances dist0 + row; clipped distances hold zeros and are skipped.
  // fetch() reads every cell first (issued before the products it waits for,
  // so that the reads' latency hides behind them), add() writes the sums.
  struct Rows {
    float2 x[2][NB];
    float* cell;  // row g's; row g + 8's is 8 rows on
    bool live[2];
  };
  __device__ __forceinline__ void fetch(Rows& r, int dist0) const {
    const int dist = dist0 + 16 * w + g;
    r.cell = part + static_cast<ptrdiff_t>(dist + max_pos) * HD + 2 * t4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      r.live[rr] = dist + 8 * rr > -max_pos && dist + 8 * rr < max_pos;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (r.live[rr]) r.x[rr][n] = *reinterpret_cast<const float2*>(r.cell + 8 * rr * HD + 8 * n);
      }
    }
  }
  __device__ __forceinline__ static void add(Rows& r, const float (&v)[HD / 2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!r.live[rr]) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        r.x[rr][n].x += v[4 * n + 2 * rr];
        r.x[rr][n].y += v[4 * n + 2 * rr + 1];
        *reinterpret_cast<float2*>(r.cell + 8 * rr * HD + 8 * n) = r.x[rr][n];
      }
    }
  }
  __device__ __forceinline__ void flush(const float (&v)[HD / 2], int dist0) const {
    Rows r;
    fetch(r, dist0);
    add(r, v);
  }
  // the rows a mixed tile's window half 1 and the carry leave into, read
  // ahead: bf16 at the tile's start (its products are short), fp32 once
  // they are issued
  Rows pend;

  // the descriptors of the products (lambdas of values: no pointer to this)
  static __device__ __forceinline__ auto k_desc(uint32_t st) {  // B = K, MN-major
    return [=](int p, int kk) { return smem_desc(st + p * C::KPL + 16 * kk * RB, C::SBO, C::LAYOUT); };
  }
  __device__ __forceinline__ auto e_desc(uint32_t st) const {  // B = the window, MN-major
    const uint32_t e = st + 2 * P * C::KPL + wg * WQ * RB;
    return [=](int p, int kk) { return smem_desc(e + p * C::EPL + 16 * kk * RB, C::SBO, C::LAYOUT); };
  }
  __device__ __forceinline__ auto dr_desc() const {  // A = dR, K-major: depth kk of the window rows
    const uint32_t d = opaque(dr);
    return [=](int p, int kk) {
      return smem_desc(d + p * 2 * DR_HALF + (kk / 4) * DR_HALF + 32 * (kk % 4), 8 * DR_ROW,
                       swizzle_layout(DR_ROW));
    };
  }
  __device__ __forceinline__ auto drt_desc(int half) const {  // A = dR^T of a half, MN-major
    const uint32_t d = opaque(dr) + half * DR_HALF;
    return [=](int p, int kk) {
      return smem_desc(d + p * 2 * DR_HALF + 16 * kk * DR_ROW, 8 * DR_ROW, swizzle_layout(DR_ROW));
    };
  }
  __device__ __forceinline__ auto q_desc() const {  // B = Q, MN-major
    const uint32_t a = opaque(qa);
    return [=](int p, int kk) { return smem_desc(a + p * C::QPL + 16 * kk * RB, C::SBO, C::LAYOUT); };
  }

  // Tile t after its logits: the weights, dq's products, and for a mixed
  // pair dR, its products and the table's rows that leave the walk
  template <bool MASK>
  __device__ __forceinline__ void rest(int t, int kind, float (&sa)[32], float (&pa)[32]) {
    weights<MASK>(t, kind, sa, pa);
    const uint32_t st = stage(t);
    if (kind == kMixed) {
      mixed_products(t, st, pa);
    } else {
      clipped_sums(kind, pa);
      uint32_t df[BK / 16][P][4];
      to_frags<P>(pa, df);
      if constexpr (WIDE) {
        float d0[24], d1[16];
        wgmma_fence();
        issue_dsk_wide(st, df, d0, d1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_frags<P>(df);
        add_wide(d0, d1);
      } else {
        float qs[HD / 2];
        wgmma_fence();
        issue_dsk(st, df, qs);
        wgmma_commit();
        wgmma_wait<0>();
        fence_frags<P>(df);
        add_dq(qs);
      }
      if (carried) {
        flush(carry, carry_base);
        carried = false;
      }
    }
    mbar_arrive(bar_empty + 8 * ((tile0 + t) % C::STAGES));
  }

  // dq's part dS . K (not WIDE): bf16 onto dq; fp32 into qs, started afresh
  __device__ __forceinline__ void issue_dsk(uint32_t st, const uint32_t (&df)[BK / 16][P][4],
                                            float (&qs)[HD / 2]) {
    if constexpr (P == 1) {
      chain_rs<HD, P, 5, 6, false>(dq, df, k_desc(st));
    } else {
      chain_rs<HD, P, 0, 6, true>(qs, df, k_desc(st));
    }
  }
  // (A2 . B0 adds into the columns of A1 . B0: both small parts)
  __device__ __forceinline__ void issue_dsk_wide(uint32_t st, const uint32_t (&df)[BK / 16][P][4],
                                                 float (&d0)[24], float (&d1)[16]) {
    float(&d10)[8] = reinterpret_cast<float(&)[8]>(d1[0]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t b = smem_desc(st + 16 * kk * RB, C::SBO, C::LAYOUT, C::KPL);
      if (kk == 0) {
        wgmma_rs<48, true>(d0, df[kk][0], b);
        wgmma_rs<32, true>(d1, df[kk][1], b);
      } else {
        wgmma_rs<48, false>(d0, df[kk][0], b);
        wgmma_rs<32, false>(d1, df[kk][1], b);
      }
      wgmma_rs<16, false>(d10, df[kk][2], b);
    }
  }
  __device__ __forceinline__ void issue_dre_wide(uint32_t st, float (&d0)[24], float (&d1)[16]) const {
    float(&d10)[8] = reinterpret_cast<float(&)[8]>(d1[0]);
    const uint32_t e = opaque(st) + 2 * P * C::KPL + wg * WQ * RB, d = opaque(dr);
#pragma unroll
    for (int kk = 0; kk < 2 * BK / 16; ++kk) {
      const uint64_t b = smem_desc(e + 16 * kk * RB, C::SBO, C::LAYOUT, C::EPL);
      const uint32_t a = d + (kk / 4) * DR_HALF + 32 * (kk % 4);
      constexpr int L = swizzle_layout(DR_ROW);
      wgmma_ss<48, false, 0, 1>(d0, smem_desc(a, 8 * DR_ROW, L), b);
      wgmma_ss<32, false, 0, 1>(d1, smem_desc(a + 2 * DR_HALF, 8 * DR_ROW, L), b);
      wgmma_ss<16, false, 0, 1>(d10, smem_desc(a + 4 * DR_HALF, 8 * DR_ROW, L), b);
    }
  }
  // dq += the part products, smallest first, in fp32
  __device__ __forceinline__ void add_wide(float (&d0)[24], float (&d1)[16]) {
    fence_regs(d0);
    fence_regs(d1);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] += (((d1[8 + i] + d0[16 + i]) + d1[i]) + d0[8 + i]) + d0[i];
  }
  __device__ __forceinline__ void add_dq(float (&qs)[HD / 2]) {
    if constexpr (P == 1) {
      fence_regs(dq);
    } else {
      fence_regs(qs);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dq[i] += qs[i];
    }
  }

  // A mixed pair: dR written (from dS's parts, the A operands just made),
  // dS . K, then dq's and dE_w's products on dR. bf16 issues dS . K first, so
  // that the tensor cores run it while dR is written; fp32 issues it after,
  // and waits for it before the products on dR, so that its A operands are
  // dead before their accumulators live.
  __device__ __forceinline__ void mixed_products(int t, uint32_t st, const float (&ds)[32]) {
    uint32_t df[BK / 16][P][4];
    to_frags<P>(ds, df);
    float qs[HD / 2];
    float d0[24], d1[16];  // WIDE's
    // bf16: dS . K runs while dR is written; fp32 issues it after (its A
    // operands and dq's accumulators live together otherwise, past the
    // registers)
    constexpr bool EARLY = P == 1;
    if constexpr (EARLY) {
      wgmma_fence();
      if constexpr (WIDE) {
        issue_dsk_wide(st, df, d0, d1);
      } else {
        issue_dsk(st, df, qs);
      }
      wgmma_commit();
    }
    if constexpr (!C::APART) warpgroup_sync(wg);  // every warp has read its R scratch: dR lies over it
    if constexpr (!(kAblate & kNoDrWrites)) write_dr(t, ds, df);
    fence_proxy_async();
    warpgroup_sync(wg);  // the warpgroup's dR is whole
    if constexpr (!EARLY) {
      wgmma_fence();
      if constexpr (WIDE) {
        issue_dsk_wide(st, df, d0, d1);
      } else {
        issue_dsk(st, df, qs);
      }
      wgmma_commit();
    }
    if constexpr (P == 3) {
      wgmma_wait<0>();
      fence_frags<P>(df);
      if constexpr (!WIDE) add_dq(qs);
    }
    // dq += dR . E_w over the 128 window rows; dE_w = dR^T . Q a half at a time
    constexpr int X0 = P == 1 ? 5 : 0;
    float e1s[HD / 2], e1b[HD / 2], e0s[HD / 2], e0b[HD / 2];
    wgmma_fence();
    if constexpr (kAblate & kNoDrProducts) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) e1s[i] = e1b[i] = e0s[i] = e0b[i] = 0.f;
    } else if constexpr (P == 1) {
      chain_ss<HD, 8, 5, 6, false, 0, 1>(dq, dr_desc(), e_desc(st));
    } else if constexpr (WIDE) {
      issue_dre_wide(st, d0, d1);
    } else {
      chain_ss<HD, 8, 0, 6, true, 0, 1>(qs, dr_desc(), e_desc(st));
    }
    if constexpr (kAblate & kNoDrProducts) {
    } else if constexpr (SPLIT) {
      chain_ss<HD, 4, 0, 5, true, 1, 1>(e1s, drt_desc(1), q_desc());
      chain_ss<HD, 4, 5, 6, true, 1, 1>(e1b, drt_desc(1), q_desc());
      chain_ss<HD, 4, 0, 5, true, 1, 1>(e0s, drt_desc(0), q_desc());
      chain_ss<HD, 4, 5, 6, true, 1, 1>(e0b, drt_desc(0), q_desc());
    } else {
      chain_ss<HD, 4, X0, 6, true, 1, 1>(e1s, drt_desc(1), q_desc());
      chain_ss<HD, 4, X0, 6, true, 1, 1>(e0s, drt_desc(0), q_desc());
    }
    wgmma_commit();
    if constexpr (P != 1 && !(kAblate & kNoFlush)) fetch(pend, basew(t) + BK);
    wgmma_wait<0>();
    if constexpr (P == 1) fence_frags<P>(df);
    if constexpr (WIDE) {
      add_wide(d0, d1);
    } else {
      add_dq(qs);
    }
    fence_regs(e1s);
    fence_regs(e0s);
    if constexpr (SPLIT) {
      fence_regs(e1b);
      fence_regs(e0b);
    }
    // half 1 of this tile and half 0 of the last are the same distances
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      const float h1 = SPLIT ? e1b[i] + e1s[i] : e1s[i];
      e1s[i] = carried ? carry[i] + h1 : h1;
      carry[i] = SPLIT ? e0b[i] + e0s[i] : e0s[i];
    }
    if constexpr (!(kAblate & kNoFlush)) add(pend, e1s);
    carried = true;
    carry_base = basew(t);
  }

  // slot[:] += sum_a c[a] q[a][:] over the warp's 16 queries (rows g, g + 8),
  // each column by one lane
  __device__ __forceinline__ void add_slot(float* slot, const float (&c)[2], const T* qrow0,
                                           const T* qrow1) {
#pragma unroll
    for (int h = 0; h < NB; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * h + 2 * t4 + e;
        float x = (qrow0 ? c[0] * widen(qrow0[d]) : 0.f) + (qrow1 ? c[1] * widen(qrow1[d]) : 0.f);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (g == 0) slot[d] += x;
      }
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(QCfg<T, HD>::NT, 1)
flash_rel_bwd_q(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_e, const T* __restrict__ q,
                const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ table,
                const T* __restrict__ gout, const float4* __restrict__ stats, T* __restrict__ dq,
                float* __restrict__ partials, int G, int Tq, int Tk, int n_qtiles, int max_pos,
                int t_valid, int q_offset) {
  using C = QCfg<T, HD>;
  constexpr int P = C::P, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t bar_qfull = bar_empty + 8 * C::STAGES;
  const uint32_t bar_qempty = bar_qfull + 8 * C::NQ;

  // warpgroup and warp indices read from lane 0: uniform for the compiler
  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_items = G * n_qtiles;  // (group, query tile): items blockIdx.x + k * gridDim.x
  const int n_tiles = (t_valid + BK - 1) / BK;
  const int n_rows = (2 * max_pos + 1) * HD;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, C::CONSUMERS);
    }
#pragma unroll
    for (int b = 0; b < C::NQ; ++b) {
      mbar_init(bar_qfull + 8 * b, 128);
      mbar_init(bar_qempty + 8 * b, C::CONSUMERS);
    }
    mbar_fence_init();
  }
  // the slots start at zero
  float* slots = reinterpret_cast<float*>(sbase + C::SLOT_OFF);
  for (int e = tid; e < C::SLOTS / 4; e += C::NT) slots[e] = 0.f;
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: every item's Q, g and statistics, then its key tiles ----
    if constexpr (C::NCW > 1) regs_dec<C::PRODUCER_REGS>();
    int it = 0;
    for (int item = blockIdx.x, kq = 0; item < n_items; item += gridDim.x, ++kq) {
      const int grp = item / n_qtiles;
      const int i0 = (item % n_qtiles) * C::BQ;
      const int qb = kq % C::NQ;
      const uint32_t ib = base + qb * C::ITEM, qfull = bar_qfull + 8 * qb;
      mbar_wait(bar_qempty + 8 * qb, ((kq / C::NQ) & 1) ^ 1);
      if constexpr (P == 1) {
        if (tid == 0) {
          mbar_expect_tx(qfull, 2 * C::QPL);
          tma_load_3d(ib, &map_q, qfull, 0, i0, grp);
          tma_load_3d(ib + C::QPL, &map_g, qfull, 0, i0, grp);
        }
      } else {
        const size_t at = static_cast<size_t>(grp) * Tq * HD;
        split_rows<HD, C::BQ>(ib, C::QPL, reinterpret_cast<const float*>(q) + at, i0, Tq, tid);
        split_rows<HD, C::BQ>(ib + 3 * C::QPL, C::QPL, reinterpret_cast<const float*>(gout) + at, i0,
                              Tq, tid);
        fence_proxy_async();
      }
      for (int r = tid; r < C::BQ; r += 128) {
        const int row = i0 + r;
        st_shared_v4f(ib + C::STATS + 16 * r, row < Tq ? stats[static_cast<size_t>(grp) * Tq + row]
                                                        : make_float4(0.f, 0.f, 0.f, 0.f));
      }
      mbar_arrive(qfull);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int s = it % C::STAGES;
        const uint32_t full = bar_full + 8 * s, st = base + C::STAGE_OFF + s * C::STAGE;
        const int j0 = t * BK;
        const int base0 = i0 + q_offset - j0 - (BK - 1);
        const bool win = needs_window<C::NCW>(base0, -WQ, max_pos);
        const int row0 = base0 + max_pos;  // the window's first table row
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        if constexpr (P == 1) {
          const bool box = win && row0 >= 0 && row0 + C::WIN - 1 <= 2 * max_pos;
          if (tid == 0) {
            mbar_expect_tx(full, 2 * C::KPL + (box ? C::EPL : 0));
            tma_load_3d(st, &map_k, full, 0, j0, grp);
            tma_load_3d(st + C::KPL, &map_v, full, 0, j0, grp);
            if (box) tma_load_2d(st + 2 * C::KPL, &map_e, full, 0, row0);
          }
          if (win && !box) gather_window<HD, C::WIN>(st + 2 * C::KPL, table, row0, max_pos, tid);
        } else {
          const size_t kv = static_cast<size_t>(grp) * Tk * HD;
          split_tile<HD, C::WIN>(st, reinterpret_cast<const float*>(k) + kv,
                                 reinterpret_cast<const float*>(v) + kv,
                                 reinterpret_cast<const float*>(table), j0, Tk, win, row0,
                                 2 * max_pos + 1, tid);
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (C::NCW > 1) regs_inc<C::CONSUMER_REGS>();
  const int wg = wgi - 1, w = warp & 3;
  QConsumer<T, HD> c;
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
  c.tile0 = 0;
  c.dr = base + C::SCR_OFF + wg * C::SCR + (C::APART ? C::RT : 0);
  c.rt = reinterpret_cast<float*>(sbase + C::SCR_OFF + wg * C::SCR) + w * (C::BAND ? 16 * SKS : RCOLS * RS);
  if constexpr (C::APART) {
    // the cells of dR that no pair writes: zero for good
    for (int e = tid - 128 * wgi; e < C::DR / 16; e += 128) {
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(c.dr + 16 * e), "r"(0u) : "memory");
    }
    warpgroup_sync(wg);  // before any thread writes its cells
  }
  c.part = partials + static_cast<size_t>(blockIdx.x * C::NCW + wg) * n_rows;
  float* slot = slots + (wg * 4 + w) * 2 * HD;

  for (int item = blockIdx.x, kq = 0; item < n_items; item += gridDim.x, ++kq) {
    const int grp = item / n_qtiles;
    const int qb = kq % C::NQ;
    const uint32_t ib = base + qb * C::ITEM;
    c.i0w = (item % n_qtiles) * C::BQ + WQ * wg;
    c.qa = ib + wg * WQ * RB;
    c.ga = c.qa + P * C::QPL;
    mbar_wait(bar_qfull + 8 * qb, (kq / C::NQ) & 1);
    if (c.i0w >= Tq) {
      // a ragged last query tile leaves this warpgroup without queries: it
      // only keeps the ring going
      for (int t = 0; t < n_tiles; ++t) {
        c.wait_full(t);
        mbar_arrive(bar_empty + 8 * ((c.tile0 + t) % C::STAGES));
      }
    } else {
      const float4* st4 = reinterpret_cast<const float4*>(sbase + qb * C::ITEM + C::STATS) + wg * WQ;
      c.srow = st4 + 16 * w + c.g;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) c.c_hi[rr] = c.c_lo[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) c.dq[i] = 0.f;
      c.carried = false;
      float sa[32], pa[32];
      const int last = n_tiles - 1;  // the one tile that may hold masked keys
      for (int t = 0; t < last; ++t) c.template rest<false>(t, c.logits(t, sa, pa), sa, pa);
      c.template rest<true>(last, c.logits(last, sa, pa), sa, pa);
      if (c.carried) c.flush(c.carry, c.carry_base);

      const float ch[2] = {quad_sum(c.c_hi[0]), quad_sum(c.c_hi[1])};
      const float cl[2] = {quad_sum(c.c_lo[0]), quad_sum(c.c_lo[1])};
      const T* qrow[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = c.i0w + 16 * w + c.g + 8 * rr;
        qrow[rr] = row < Tq ? q + (static_cast<size_t>(grp) * Tq + row) * HD : nullptr;
      }
      // uniform in the warpgroup: skip the rows its distances never reach
      if (c.i0w + WQ - 1 + q_offset >= max_pos) c.add_slot(slot, ch, qrow[0], qrow[1]);
      if (c.i0w + q_offset - (t_valid - 1) <= -max_pos) c.add_slot(slot + HD, cl, qrow[0], qrow[1]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (qrow[rr] == nullptr) continue;
        T* o = dq + (qrow[rr] - q);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int d = 8 * n + 2 * c.t4;
          const float eh0 = widen(table[2 * max_pos * HD + d]), eh1 = widen(table[2 * max_pos * HD + d + 1]);
          const float el0 = widen(table[d]), el1 = widen(table[d + 1]);
          narrow2(c.dq[4 * n + 2 * rr] + ch[rr] * eh0 + cl[rr] * el0,
                  c.dq[4 * n + 2 * rr + 1] + ch[rr] * eh1 + cl[rr] * el1, o + d);
        }
      }
    }
    mbar_arrive(bar_qempty + 8 * qb);  // every product that reads the item's tiles is complete
    c.tile0 += n_tiles;
  }

  // the warpgroup's slots, in warp order, into rows 2*max_pos and 0 of its
  // row (no window row reaches them: one row where max_pos is 0)
  warpgroup_sync(wg);
  const int ltid = tid - 128 * wgi;
  if (ltid < HD) {
    float hi = 0.f, lo = 0.f;
    for (int wk = 0; wk < 4; ++wk) {
      hi += slots[(wg * 4 + wk) * 2 * HD + ltid];
      lo += slots[(wg * 4 + wk) * 2 * HD + HD + ltid];
    }
    c.part[2 * max_pos * HD + ltid] += hi;
    c.part[ltid] += lo;
  }
}

// ============================ the dk / dv kernel ============================

template <typename T, int HD>
struct KCfg {
  static constexpr int P = Parts<T>::N;
  static constexpr int RB = 2 * HD;
  static constexpr int NCW = consumer_warpgroups(P, HD, true);
  static constexpr int BKB = NCW * WQ;              // keys an item
  static constexpr int WIN = BKB + BK;              // window rows the block's key tiles meet
  static constexpr int NT = 128 * (NCW + 1);
  static constexpr int CONSUMERS = 128 * NCW;
  static constexpr int LAYOUT = swizzle_layout(RB);
  static constexpr int SBO = 8 * RB;
  static constexpr int QPL = WQ * RB, KPL = BKB * RB, EPL = WIN * RB;
  static constexpr int ITEM = 2 * P * KPL;          // K and V of the item
  static constexpr int STATS = P * (2 * QPL + EPL);  // a stage's statistics, after Q, g and E
  static constexpr int STAGE = STATS + 16 * WQ;
  static constexpr int SKEW = WQ * SKS * 4;         // a skew buffer
  static constexpr int SKEW_ROOM2 = MAX_SMEM - 1024 - NCW * 2 * SKEW - 8 * 12;
  static constexpr int NQ2 = 2 * ITEM + 2 * STAGE <= SKEW_ROOM2 ? 2 : 1;
  // two skew buffers a warpgroup (one named barrier a mixed tile) where they
  // leave room for two stages, else one (and a second barrier)
  static constexpr int NSK = (SKEW_ROOM2 - NQ2 * ITEM) / STAGE >= 2 ? 2 : 1;
  static constexpr int SCR = (NSK * SKEW + 1023) / 1024 * 1024;
  static constexpr int ROOM = MAX_SMEM - 1024 - NCW * SCR - 8 * 12;
  static constexpr int NQ = 2 * ITEM + 2 * STAGE <= ROOM ? 2 : 1;
  static constexpr int FIT = (ROOM - NQ * ITEM) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int STAGE_OFF = NQ * ITEM;
  static constexpr int SCR_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int BAR_OFF = SCR_OFF + NCW * SCR;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * NQ) + 1024;
  static constexpr int PRODUCER_REGS = producer_regs(P, NCW);
  static constexpr int CONSUMER_REGS = consumer_regs(P, NCW);
  static_assert(STAGES >= 1 && BYTES <= MAX_SMEM, "the dk/dv kernel's tiles fit a block");
  static_assert(NCW == 1 || 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= NT * launch_regs(NT),
                "registers");
};

template <typename T, int HD>
struct KvConsumer {
  using C = KCfg<T, HD>;
  static constexpr int P = C::P, RB = C::RB;
  static constexpr bool SPLIT = kSplit<P, HD>;
  static constexpr bool SERIAL = P == 3 && HD == 64;  // dv's product waited before dk's
  uint32_t base, bar_full, bar_empty;
  uint32_t ka, va;       // the warpgroup's keys and values in the item buffer, plane 0
  float* sk;             // the warpgroup's skew buffers
  const unsigned char* sb;  // the aligned shared memory, a pointer (shared address `base`)
  int wg, w, g, t4;
  int j0w, nk, q_offset, max_pos, tile0, n_mixed;
  float dk[HD / 2], dv[HD / 2];  // rows (keys) g, g + 8; columns 8n + 2t, + 1

  __device__ __forceinline__ uint32_t stage(int t) const {
    return base + C::STAGE_OFF + ((tile0 + t) % C::STAGES) * C::STAGE;
  }
  // query a of tile t meets key b of the warpgroup at distance basew(t) + a - b + 63
  __device__ __forceinline__ int basew(int t) const { return t * WQ + q_offset - j0w - (BK - 1); }
  __device__ __forceinline__ void wait_full(int t) const {
    mbar_wait(bar_full + 8 * ((tile0 + t) % C::STAGES), ((tile0 + t) / C::STAGES) & 1);
  }

  // R[a][c] (rows a: queries) at [a][c - a] for c - a in [0, 64): the 64
  // window rows query a meets, keys 63 .. 0
  template <int W>
  __device__ __forceinline__ void skew_at(float* buf, const float (&ra)[64]) {
#pragma unroll
    for (int n = 2 * W; n < 2 * W + RCOLS / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int a = 16 * W + g + 8 * rr, x = 8 * n + 2 * t4 + e - a;
          if (x >= 0 && x < BK) buf[a * SKS + x] = ra[4 * n + 2 * rr + e];
        }
      }
    }
  }

  // R parked by its owners into a skew buffer (returned), then S^T (keys b,
  // queries a) += R[a][a - b + 63], read by the threads of (b, a) across the
  // warpgroup
  __device__ __forceinline__ float* park(const float (&ra)[64]) {
    float* buf = sk + (C::NSK == 2 ? n_mixed & 1 : 0) * WQ * SKS;
    if constexpr (C::NSK == 1) warpgroup_sync(wg);  // the last mixed tile's reads are done
    switch (w) {
      case 0: skew_at<0>(buf, ra); break;
      case 1: skew_at<1>(buf, ra); break;
      case 2: skew_at<2>(buf, ra); break;
      default: skew_at<3>(buf, ra); break;
    }
    warpgroup_sync(wg);
    return buf;
  }
  __device__ __forceinline__ void skew(const float* buf, float (&sa)[32]) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int a = 8 * n + 2 * t4 + e, b = 16 * w + g + 8 * rr;
          sa[4 * n + 2 * rr + e] += buf[a * SKS + BK - 1 - b];
        }
      }
    }
    ++n_mixed;
  }

  __device__ __forceinline__ void tile(int t) {
    wait_full(t);
    const uint32_t st = stage(t), ga = st + P * C::QPL, ka = opaque(this->ka), va = opaque(this->va);
    const int kind = clip_kind(basew(t), WQ, max_pos);
    float sa[32], pa[32];  // S^T and dP^T
    if (kind == kMixed) {
      // R first, parked, then S^T and dP^T (the three accumulators at once
      // would not leave three warpgroups their registers)
      float ra[64];
      wgmma_fence();
      product<P, HD, 128, C::SBO, C::LAYOUT>(
          ra, st, C::QPL, st + 2 * P * C::QPL + (C::NCW - 1 - wg) * WQ * RB, C::EPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ra);
      float* buf = park(ra);
      wgmma_fence();
      product<P, HD, 64, C::SBO, C::LAYOUT>(sa, ka, C::KPL, st, C::QPL);
      product<P, HD, 64, C::SBO, C::LAYOUT>(pa, va, C::KPL, ga, C::QPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(pa);
      skew(buf, sa);
    } else {
      wgmma_fence();
      product<P, HD, 64, C::SBO, C::LAYOUT>(sa, ka, C::KPL, st, C::QPL);
      product<P, HD, 64, C::SBO, C::LAYOUT>(pa, va, C::KPL, ga, C::QPL);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(pa);
    }
    // p^T = exp(s - lse_a) for keys b < nk, ds^T = p^T (dp^T - delta_a); the
    // statistics of query a from the stage
    const bool row_ok[2] = {16 * w + g < nk, 16 * w + g + 8 < nk};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 s = *reinterpret_cast<const float4*>(sb + (st - base) + C::STATS +
                                                          16 * (8 * n + 2 * t4 + e));
        const float shift = kind == kMixed ? 0.f : kind == kHigh ? s.z : s.w;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * n + 2 * rr + e;
          const float p = row_ok[rr] ? ex2(fmaf(sa[i] + shift, L2E, -s.x * L2E)) : 0.f;
          sa[i] = p;
          pa[i] = p * (pa[i] - s.y);
        }
      }
    }
    uint32_t pf[BK / 16][P][4], df[BK / 16][P][4];
    to_frags<P>(sa, pf);
    to_frags<P>(pa, df);
    auto g_desc = [=](int p, int kk) { return smem_desc(ga + p * C::QPL + 16 * kk * RB, C::SBO, C::LAYOUT); };
    auto q_desc = [=](int p, int kk) { return smem_desc(st + p * C::QPL + 16 * kk * RB, C::SBO, C::LAYOUT); };
    if constexpr (P == 1) {
      wgmma_fence();
      chain_rs<HD, P, 5, 6, false>(dv, pf, g_desc);
      chain_rs<HD, P, 5, 6, false>(dk, df, q_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    } else if constexpr (SPLIT) {
      float vs[HD / 2], vb[HD / 2], ks[HD / 2], kb[HD / 2];
      wgmma_fence();
      chain_rs<HD, P, 0, 5, true>(vs, pf, g_desc);
      chain_rs<HD, P, 5, 6, true>(vb, pf, g_desc);
      chain_rs<HD, P, 0, 5, true>(ks, df, q_desc);
      chain_rs<HD, P, 5, 6, true>(kb, df, q_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(vs);
      fence_regs(vb);
      fence_regs(ks);
      fence_regs(kb);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        dv[i] += vb[i] + vs[i];
        dk[i] += kb[i] + ks[i];
      }
    } else if constexpr (!SERIAL) {
      float vs[HD / 2], ks[HD / 2];
      wgmma_fence();
      chain_rs<HD, P, 0, 6, true>(vs, pf, g_desc);
      chain_rs<HD, P, 0, 6, true>(ks, df, q_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(vs);
      fence_regs(ks);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        dv[i] += vs[i];
        dk[i] += ks[i];
      }
    } else {
      float xs[HD / 2];
      wgmma_fence();
      chain_rs<HD, P, 0, 6, true>(xs, pf, g_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xs);
      fence_frags<P>(pf);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dv[i] += xs[i];
      wgmma_fence();
      chain_rs<HD, P, 0, 6, true>(xs, df, q_desc);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(xs);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dk[i] += xs[i];
    }
    fence_frags<P>(pf);
    fence_frags<P>(df);
    mbar_arrive(bar_empty + 8 * ((tile0 + t) % C::STAGES));
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(KCfg<T, HD>::NT, 1)
flash_rel_bwd_kv(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
                 const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_e, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ table,
                 const T* __restrict__ gout, const float4* __restrict__ stats, T* __restrict__ dk,
                 T* __restrict__ dv, int G, int Tq, int Tk, int n_ktiles, int max_pos, int t_valid,
                 int q_offset) {
  using C = KCfg<T, HD>;
  constexpr int P = C::P, RB = C::RB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const uint32_t bar_full = base + C::BAR_OFF;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;
  const uint32_t bar_ifull = bar_empty + 8 * C::STAGES;
  const uint32_t bar_iempty = bar_ifull + 8 * C::NQ;

  const int tid = threadIdx.x, lane = tid & 31;
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_items = G * n_ktiles;  // (group, key tile of BKB)
  const int n_qtiles = (Tq + WQ - 1) / WQ;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, C::CONSUMERS);
    }
#pragma unroll
    for (int b = 0; b < C::NQ; ++b) {
      mbar_init(bar_ifull + 8 * b, 128);
      mbar_init(bar_iempty + 8 * b, C::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: every item's K and V, then its query tiles ----
    if constexpr (C::NCW > 1) regs_dec<C::PRODUCER_REGS>();
    int it = 0;
    for (int item = blockIdx.x, kq = 0; item < n_items; item += gridDim.x, ++kq) {
      const int grp = item / n_ktiles;
      const int j0 = (item % n_ktiles) * C::BKB;
      const int ib_i = kq % C::NQ;
      const uint32_t ib = base + ib_i * C::ITEM, ifull = bar_ifull + 8 * ib_i;
      mbar_wait(bar_iempty + 8 * ib_i, ((kq / C::NQ) & 1) ^ 1);
      const bool live = j0 < t_valid;  // else the item only writes zeros: nothing to load
      if (live) {
        if constexpr (P == 1) {
          if (tid == 0) {
            mbar_expect_tx(ifull, 2 * C::KPL);
            tma_load_3d(ib, &map_k, ifull, 0, j0, grp);
            tma_load_3d(ib + C::KPL, &map_v, ifull, 0, j0, grp);
          }
        } else {
          const size_t at = static_cast<size_t>(grp) * Tk * HD;
          split_rows<HD, C::BKB>(ib, C::KPL, reinterpret_cast<const float*>(k) + at, j0, Tk, tid);
          split_rows<HD, C::BKB>(ib + 3 * C::KPL, C::KPL, reinterpret_cast<const float*>(v) + at, j0,
                                 Tk, tid);
          fence_proxy_async();
        }
      }
      mbar_arrive(ifull);
      if (!live) continue;
      for (int t = 0; t < n_qtiles; ++t, ++it) {
        const int s = it % C::STAGES;
        const uint32_t full = bar_full + 8 * s, st = base + C::STAGE_OFF + s * C::STAGE;
        const int i0 = t * WQ;
        const int base0 = i0 + q_offset - j0 - (BK - 1);  // warpgroup wg's: base0 - 64 wg
        const bool win = needs_window<C::NCW>(base0, WQ, max_pos);
        const int row0 = base0 - WQ * (C::NCW - 1) + max_pos;  // the window's first table row
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        if constexpr (P == 1) {
          const bool box = win && row0 >= 0 && row0 + C::WIN - 1 <= 2 * max_pos;
          if (tid == 0) {
            mbar_expect_tx(full, 2 * C::QPL + (box ? C::EPL : 0));
            tma_load_3d(st, &map_q, full, 0, i0, grp);
            tma_load_3d(st + C::QPL, &map_g, full, 0, i0, grp);
            if (box) tma_load_2d(st + 2 * C::QPL, &map_e, full, 0, row0);
          }
          if (win && !box) gather_window<HD, C::WIN>(st + 2 * C::QPL, table, row0, max_pos, tid);
        } else {
          const size_t at = static_cast<size_t>(grp) * Tq * HD;
          split_tile<HD, C::WIN>(st, reinterpret_cast<const float*>(q) + at,
                                 reinterpret_cast<const float*>(gout) + at,
                                 reinterpret_cast<const float*>(table), i0, Tq, win, row0,
                                 2 * max_pos + 1, tid);
        }
        if (tid < WQ) {
          const int row = i0 + tid;
          st_shared_v4f(st + C::STATS + 16 * tid, row < Tq ? stats[static_cast<size_t>(grp) * Tq + row]
                                                             : make_float4(0.f, 0.f, 0.f, 0.f));
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (C::NCW > 1) regs_inc<C::CONSUMER_REGS>();
  const int wg = wgi - 1, w = warp & 3;
  KvConsumer<T, HD> c;
  c.base = base;
  c.bar_full = bar_full;
  c.bar_empty = bar_empty;
  c.wg = wg;
  c.w = w;
  c.g = lane >> 2;
  c.t4 = lane & 3;
  c.q_offset = q_offset;
  c.max_pos = max_pos;
  c.tile0 = 0;
  c.n_mixed = 0;
  c.sk = reinterpret_cast<float*>(sbase + C::SCR_OFF + wg * C::SCR);
  c.sb = sbase;

  for (int item = blockIdx.x, kq = 0; item < n_items; item += gridDim.x, ++kq) {
    const int grp = item / n_ktiles;
    const int j0 = (item % n_ktiles) * C::BKB;
    const int ib_i = kq % C::NQ;
    const uint32_t ib = base + ib_i * C::ITEM;
    const int n_tiles = j0 < t_valid ? n_qtiles : 0;
    c.j0w = j0 + WQ * wg;
    c.nk = t_valid - c.j0w;
    c.ka = ib + wg * WQ * RB;
    c.va = c.ka + P * C::KPL;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) c.dk[i] = c.dv[i] = 0.f;
    // every warpgroup waits for the item, even one with no keys to take: its
    // arrival below must not complete the item buffer's phase before the
    // producer has waited for it (an item wholly past t_valid loads nothing,
    // and its consumers would otherwise run ahead)
    mbar_wait(bar_ifull + 8 * ib_i, (kq / C::NQ) & 1);
    if (c.nk > 0) {
      for (int t = 0; t < n_tiles; ++t) c.tile(t);
    } else {
      // keys wholly past t_valid: zeros, and the ring kept going
      for (int t = 0; t < n_tiles; ++t) {
        c.wait_full(t);
        mbar_arrive(bar_empty + 8 * ((c.tile0 + t) % C::STAGES));
      }
    }
    mbar_arrive(bar_iempty + 8 * ib_i);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = c.j0w + 16 * w + c.g + 8 * rr;
      if (row >= Tk) continue;
      const size_t at = (static_cast<size_t>(grp) * Tk + row) * HD + 2 * c.t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        narrow2(c.dk[4 * n + 2 * rr], c.dk[4 * n + 2 * rr + 1], dk + at + 8 * n);
        narrow2(c.dv[4 * n + 2 * rr], c.dv[4 * n + 2 * rr + 1], dv + at + 8 * n);
      }
    }
    c.tile0 += n_tiles;
  }
}

// ================================ launches ================================

struct Args {
  const void *q, *k, *v, *table, *out, *gout, *lse;
  void *dq, *dk, *dv, *delta, *dtable, *partials;
  int G, Tq, Tk, max_pos, t_valid, q_offset, partial_rows;
  cudaStream_t stream;
};

// persistent blocks, at most one an SM, block b taking items b, b + grid, ...:
// a grid with no factor in common with the items a group, so that no block
// takes only one tile position (the ragged last tile is the light one)
int persistent_grid(int per_group, long long n_items, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = sms;
  while (blocks > 1 && std::gcd(blocks, per_group) != 1) --blocks;
  *grid = static_cast<int>(n_items < blocks ? n_items : blocks);
  return *grid >= 1 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// rows of `partials` a launch at these shapes needs: the dq kernel's rows of
// partial sums (one a consumer warpgroup), then the rows' statistics
template <typename T, int HD>
int partial_rows(int G, int Tq, int max_pos, int* de_rows) {
  using C = QCfg<T, HD>;
  const int n_qtiles = (Tq + C::BQ - 1) / C::BQ;
  int grid = 0;
  const int err = persistent_grid(n_qtiles, static_cast<long long>(G) * n_qtiles, &grid);
  if (err != 0) return -err;
  const long long n = static_cast<long long>(2 * max_pos + 1) * HD;
  const long long stats = (4LL * G * Tq + n - 1) / n;
  *de_rows = grid * C::NCW;
  const long long rows = *de_rows + stats;
  return rows > 0x7fffffffLL ? -static_cast<int>(cudaErrorInvalidValue) : static_cast<int>(rows);
}

// the bf16 kernels' tensor maps: q and g boxes of qrows, k and v boxes of
// krows, the table's of win rows
template <int HD>
int make_maps(const Args& a, int qrows, int krows, int win, CUtensorMap* m) {
  constexpr int RB = 2 * HD;
  const cuuint64_t row = RB;
  const cuuint64_t dq[3] = {HD, static_cast<cuuint64_t>(a.Tq), static_cast<cuuint64_t>(a.G)};
  const cuuint64_t dk[3] = {HD, static_cast<cuuint64_t>(a.Tk), static_cast<cuuint64_t>(a.G)};
  const cuuint64_t de[2] = {HD, static_cast<cuuint64_t>(2 * a.max_pos + 1)};
  const cuuint64_t sq[2] = {row, row * a.Tq}, sk[2] = {row, row * a.Tk};
  const cuuint32_t bq[3] = {HD, static_cast<cuuint32_t>(qrows), 1};
  const cuuint32_t bk[3] = {HD, static_cast<cuuint32_t>(krows), 1};
  const cuuint32_t be[2] = {HD, static_cast<cuuint32_t>(win)};
  int rc = make_map(&m[0], a.q, 3, dq, sq, bq, RB);
  if (rc == 0) rc = make_map(&m[1], a.gout, 3, dq, sq, bq, RB);
  if (rc == 0) rc = make_map(&m[2], a.k, 3, dk, sk, bk, RB);
  if (rc == 0) rc = make_map(&m[3], a.v, 3, dk, sk, bk, RB);
  if (rc == 0) rc = make_map(&m[4], a.table, 2, de, sk, be, RB);
  return rc;
}

template <typename T, int HD>
int launch(const Args& a) {
  using QC = QCfg<T, HD>;
  using KC = KCfg<T, HD>;
  int de_rows = 0;
  const int rows = partial_rows<T, HD>(a.G, a.Tq, a.max_pos, &de_rows);
  if (rows < 0) return -rows;
  if (rows > a.partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  const int n = (2 * a.max_pos + 1) * HD;
  float* partials = static_cast<float*>(a.partials);
  float4* stats = reinterpret_cast<float4*>(partials + static_cast<size_t>(de_rows) * n);

  // the rows' statistics, and zeros for the dq kernel's rows of partial sums
  constexpr int TPR = HD * static_cast<int>(sizeof(T)) / 16;
  const long long threads = static_cast<long long>(a.G) * a.Tq * TPR;
  flash_rel_bwd_prologue<T, HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.gout), static_cast<const T*>(a.q),
      static_cast<const T*>(a.table), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      stats, reinterpret_cast<float4*>(partials), static_cast<long long>(de_rows) * n / 4, a.G * a.Tq,
      a.max_pos);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  CUtensorMap mq[5] = {}, mk[5] = {};
  if constexpr (QC::P == 1) {
    if ((err = make_maps<HD>(a, QC::BQ, BK, QC::WIN, mq)) != 0) return err;
    if ((err = make_maps<HD>(a, WQ, KC::BKB, KC::WIN, mk)) != 0) return err;
  }

  // dq and the table's gradient (the statistics above first: same stream)
  err = static_cast<int>(cudaFuncSetAttribute(flash_rel_bwd_q<T, HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, QC::BYTES));
  if (err != 0) return err;
  const int n_qtiles = (a.Tq + QC::BQ - 1) / QC::BQ;
  flash_rel_bwd_q<T, HD><<<static_cast<unsigned>(de_rows / QC::NCW), QC::NT, QC::BYTES, a.stream>>>(
      mq[0], mq[1], mq[2], mq[3], mq[4], static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.table), static_cast<const T*>(a.gout), stats,
      static_cast<T*>(a.dq), partials, a.G, a.Tq, a.Tk, n_qtiles, a.max_pos, a.t_valid, a.q_offset);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_rel_sum_partials<<<(n + 255) / 256, 256, 0, a.stream>>>(partials, static_cast<float*>(a.dtable),
                                                                de_rows, n);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;

  // dk and dv
  err = static_cast<int>(cudaFuncSetAttribute(flash_rel_bwd_kv<T, HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, KC::BYTES));
  if (err != 0) return err;
  const int n_ktiles = (a.Tk + KC::BKB - 1) / KC::BKB;
  int grid = 0;
  if ((err = persistent_grid(n_ktiles, static_cast<long long>(a.G) * n_ktiles, &grid)) != 0) return err;
  flash_rel_bwd_kv<T, HD><<<static_cast<unsigned>(grid), KC::NT, KC::BYTES, a.stream>>>(
      mk[0], mk[1], mk[2], mk[3], mk[4], static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.table), static_cast<const T*>(a.gout), stats,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.G, a.Tq, a.Tk, n_ktiles, a.max_pos, a.t_valid,
      a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int smem_bytes(int which) {
  return which == 0 ? QCfg<T, HD>::BYTES : which == 1 ? KCfg<T, HD>::BYTES : -1;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns the first CUDA
// error (0 on success); does not synchronise. Scratch from the caller, none
// of it zeroed: `delta` fp32 [G, Tq] (receives delta); `partials` fp32
// [partial_rows, (2*max_pos+1)*head_dim] with partial_rows at least what
// cmgan_flash_rel_attention_bwd_partial_rows gives for these shapes (the dq
// kernel's rows of partial sums, then the rows' statistics); `dtable` fp32
// [2*max_pos+1, head_dim] receives the table's gradient. Pointers are 16-byte
// aligned; head_dim is 16, 32 or 64.
extern "C" int cmgan_flash_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* table, const void* out,
    const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* dtable, void* partials, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid,
    int q_offset, int is_bf16, int partial_rows, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = {q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable, partials,
                  G, Tq, Tk, max_pos, t_valid, q_offset, partial_rows,
                  static_cast<cudaStream_t>(stream)};
  return with_head_dim(head_dim, static_cast<int>(cudaErrorInvalidValue), [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? launch<__nv_bfloat16, HD>(a) : launch<float, HD>(a);
  });
}

// Rows the `partials` scratch needs on the current device: one a consumer
// warpgroup of the dq kernel's persistent blocks, and the rows' statistics.
// Negative: minus a CUDA error.
extern "C" int cmgan_flash_rel_attention_bwd_partial_rows(int is_bf16, int head_dim, int G,
                                                          int Tq, int max_pos) {
  if (G <= 0 || Tq <= 0 || max_pos < 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(head_dim, -static_cast<int>(cudaErrorInvalidValue), [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    int de_rows = 0;
    return is_bf16 ? partial_rows<__nv_bfloat16, HD>(G, Tq, max_pos, &de_rows)
                   : partial_rows<float, HD>(G, Tq, max_pos, &de_rows);
  });
}

// Dynamic shared memory, in bytes, of one block of kernel `which` (0: the
// kernel that sums dq and the table's gradient, 1: the dk/dv kernel), or -1.
// The same at every max_pos: no buffer grows with the table.
extern "C" int cmgan_flash_rel_attention_bwd_smem(int is_bf16, int head_dim, int which,
                                                  int max_pos) {
  (void)max_pos;
  return with_head_dim(head_dim, -1, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? smem_bytes<__nv_bfloat16, HD>(which) : smem_bytes<float, HD>(which);
  });
}
