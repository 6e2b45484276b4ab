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
// Every product runs on the tensor cores through mma.sync.m16n8k16
// (flash_rel_common.cuh: bf16 as it is, fp32 as three bf16 parts and six part
// products), warps own 16 queries each, and the position logits come from
// R = Q_w . E_window^T through the skew, or from two scalars a query where a
// whole tile pair is clipped. Three kernels and a sum:
//
//   flash_rel_delta   delta_i = g_i . out_i, one thread a row.
//   flash_rel_bwd<kOwnQ>   a block owns (group, BQ queries) and walks the key
//       tiles: dq in registers, and the table's gradient.
//   flash_rel_bwd<kOwnK>   a block owns (group, 64 keys) and walks the query
//       tiles: P and dS go through shared memory so that their transposes are
//       the A operands of dv = P^T . g and dk = dS^T . Q, kept in registers.
//   flash_rel_sum_partials   adds the blocks' sums of the table's gradient.
//
// The table's gradient in a fixed order, with no atomics. ds is written
// skewed, dR[r][r - b + 63] = ds[r][b], into a per-warp [16, 80] scratch (it
// lies over the warp's R scratch, which is consumed by then; the cells outside
// the parallelogram are zeroed anew). Then dE_window = dR^T . Q_tile is a tile
// product again (rows: window rows, depth: queries); each warp owns whole
// 16-row blocks of the window, skips the blocks of depth where dR is zero by
// construction, and adds its result into the block's own dE rows with plain
// read-modify-writes (each cell has one owner a tile pair and block). Clipped
// pairs, in a wholly clipped tile pair or in a mixed one, are summed per query
// in registers (rows 0 and 2*max_pos of the table collect them all); once a
// (group, query tile) each warp adds those sums, times its queries, into a
// slot of its own (two rows of HD floats in shared memory), and after its last
// item the block adds the slots in warp order into its rows. Blocks are
// persistent (as many as the card holds at once; block b takes items b,
// b + grid, ...), each owns one row of a [blocks, (2*max_pos+1)*HD] scratch,
// and flash_rel_sum_partials adds the rows in block order. Every sum thus has
// one order: two runs on the same inputs give the same bits.
//
// Where a block's dE rows live: a block-wide fp32 [2*max_pos+1, HD] buffer in
// shared memory (65,600 B at max_pos 512, HD 16; 131,200 B at HD 32), written to
// its scratch row once at the end; or, for a table too long for that buffer
// beside the tiles (at HD 16, max_pos above 750 in fp32, 1462 in bf16; at HD 32
// the fp32 buffer never fits, at HD 64 neither type's), the scratch row itself,
// in global memory, which the block zeroes first (de_global). The models'
// max_pos is 512.
//
// What bounds it on an H100 SXM (700 W part; 989 TFLOP/s bf16 tensor,
// 3.35 TB/s, 16 exponentials a clock an SM): the function is eight products of
// 2*G*Tq*t_valid*16 FLOP (five where a pair is clipped) and one exponential a
// pair. At G = 1616, T = 641: 1.7e11 FLOP, 0.17 ms in bf16, as long as its
// 6.6e8 exponentials; 1.0 ms in fp32 (six part products each); 0.16 ms (fp32)
// for the bytes. The two-kernel form recomputes the logits (11 products and
// two exponentials a pair, against the function's 8 and 1). What is left: the
// block that owns the queries needs its 65.6 KB buffer, so few warps share a
// multiprocessor (bf16 two blocks of four, fp32 one of eight); tile loads
// travel through registers, not a cp.async/TMA ring; mma.sync, not wgmma. One
// kernel that owns a key tile and adds dq with global atomics was measured and
// was slower, as was the other block size of each type (PERF.md).

#include "flash_rel_common.cuh"

namespace {

using namespace flash_rel;

enum Mode { kOwnQ = 0, kOwnK = 1 };

// warps a block of the kernel that owns the queries: with bf16, two blocks of
// four warps fit a multiprocessor and beat one of eight; fp32's three planes
// leave room for one block either way, and eight warps beat four, up to HD 32
// (at HD 64 the tiles of eight warps exceed a block's shared memory)
template <typename T, int HD>
constexpr int kWarpsQ = sizeof(T) == 2 || HD > 32 ? 4 : 8;

constexpr int DRS = 88;   // elements per row of a warp's dR scratch (80 used): 16-byte rows,
                          // conflict-free for ldmatrix
constexpr int PS = 72;    // elements per row of the P and dS tiles (64 used)

template <typename T, int HD>
__global__ void flash_rel_delta(const T* __restrict__ out, const T* __restrict__ gout,
                                float* __restrict__ delta, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc += widen(out[static_cast<size_t>(r) * HD + d]) * widen(gout[static_cast<size_t>(r) * HD + d]);
  delta[r] = acc;
}

// Where column d of table row r sits in a dE buffer: the two halves of each
// 16 columns swap on every other pair of rows, so that a half-warp's 8-byte
// read-modify-writes of four neighbouring rows fall on different banks.
__device__ __forceinline__ int de_col(int r, int d) { return d ^ (((r >> 1) & 1) << 3); }

// dE[e] = sum over the rows of partial sums (each laid out by de_col), in a
// fixed order; rows of the table hd wide
__global__ void flash_rel_sum_partials(const float* __restrict__ partials, float* __restrict__ dtable,
                                       int n_rows, int n, int hd) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int at = (e / hd) * hd + de_col(e / hd, e % hd);
  float acc = 0.f;
  for (int b = 0; b < n_rows; ++b) acc += partials[static_cast<size_t>(b) * n + at];
  dtable[e] = acc;
}

// Shared memory of one block, in bytes from its start: the staged tiles (bf16
// planes), one scratch chunk a warp, then fp32 arrays. A warp's chunk holds its
// R scratch; its dR rows lie over it (R is consumed before ds exists), and so
// do its rows of P and dS where no dR is kept.
template <typename T, int NW, int MODE, int HD>
struct Layout {
  static constexpr bool kOwnsQ = MODE == kOwnQ;
  static constexpr int P = Parts<T>::N;
  static constexpr int TS = stage_stride(HD);
  static constexpr int BQ = 16 * NW;
  static constexpr int WIN = BQ + BK;
  static constexpr int QPL = BQ * TS, KPL = BK * TS, EPL = WIN * TS;  // elements a plane
  static constexpr int qs = 0;
  static constexpr int gs = qs + 2 * P * QPL;
  static constexpr int ks = gs + 2 * P * QPL;
  static constexpr int vs = ks + 2 * P * KPL;
  static constexpr int es = vs + 2 * P * KPL;
  static constexpr int scratch = es + 2 * P * EPL;
  // within a warp's chunk
  static constexpr int R_BYTES = RCOLS * RS * 4;
  static constexpr int PB_BYTES = 16 * PS * static_cast<int>(sizeof(T));
  static constexpr int pb = 0;
  static constexpr int dsb = pb + PB_BYTES;
  static constexpr int CHUNK = kOwnsQ ? R_BYTES : (dsb + PB_BYTES > R_BYTES ? dsb + PB_BYTES : R_BYTES);
  static_assert(16 * DRS * sizeof(T) <= R_BYTES, "a warp's dR rows lie over its R scratch");
  static constexpr int lse = scratch + NW * CHUNK;
  static constexpr int delta = lse + 4 * BQ;
  static constexpr int eh = delta + 4 * BQ;
  static constexpr int el = eh + 4 * HD;
  // the kernel that owns the queries: each warp's sums of its clipped pairs,
  // rows 2*max_pos and 0 (2 * HD floats a warp)
  static constexpr int slots = el + 4 * HD;
  static constexpr int debuf = slots + (kOwnsQ ? 4 * 2 * HD * NW : 0);  // (2*max_pos+1) * HD floats
                                                                       // where the block keeps dE
  static int bytes(int max_pos, bool shared_de) {
    return debuf + (kOwnsQ && shared_de ? 4 * (2 * max_pos + 1) * HD : 0);
  }
};

// slot[:] += sum_a c[a] q[a][:] over the warp's 16 queries: the pairs clipped
// to one end row of the table, added into the warp's own slot (each column by
// one lane)
template <int P, int HD>
__device__ __forceinline__ void add_clipped_slot(float* slot, const float* c, const bf16* qs_w,
                                                 int q_plane, int lane) {
  constexpr int TS = stage_stride(HD);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < HD / 8; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 2 * t + 8 * h + e;
      float x = c[0] * tile_value<P>(qs_w, q_plane, g * TS + d) +
                c[1] * tile_value<P>(qs_w, q_plane, (g + 8) * TS + d);
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) slot[d] += x;
    }
  }
}

// dE_window = dR^T . Q for one tile pair, added into the block's dE rows (in
// shared memory, or with de_global its row of the scratch in global memory).
// Window rows 16m .. 16m+15 meet the queries of warp kk at that warp's dR
// columns 16(m - kk) ..; the other depth blocks are zero by construction. Warp
// w owns window blocks w and w + NW: five depth blocks in all, for every warp.
template <typename T, int NW, int CHUNK, int HD>
__device__ __forceinline__ void window_grad(const unsigned char* scratch, const bf16* qs,
                                            float* de, int base, int max_pos, int w, int lane) {
  constexpr int P = Parts<T>::N, WIN = 16 * NW + BK, TS = stage_stride(HD), NB = HD / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = w + mi * NW;
    if (m >= WIN / 16) break;
    float acc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    // the warp kk = m - back holds window block m at its dR columns 16 * back ..
#pragma unroll
    for (int back = 0; back < RCOLS / 16; ++back) {
      const int kk = m - back;
      if (kk < 0 || kk >= NW) continue;  // uniform in the warp
      FragA<P> da;
      load_a_scratch_trans(da, reinterpret_cast<const T*>(scratch + kk * CHUNK), DRS, 16 * back, 0, lane);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        FragB<P> qb;
        load_b_trans<P>(qb, qs, 16 * NW * TS, TS, 8 * n, 16 * kk, lane);
        mma(acc[n], da, qb);
      }
    }
    // the window's padding row, and a window row clipped to an end of the table,
    // carry zeros (its pairs went to the per-query sums). An unclipped row has
    // one owner a tile pair and block, so plain read-modify-writes do in the
    // block's own rows: every cell read first, so that no store waits on a read
    bool live[2];
    float2* cell[2][NB];
    float2 x[2][NB];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int c = 16 * m + g + 8 * rr;
      const int dist = base + c;
      live[rr] = c < WIN - 1 && dist > -max_pos && dist < max_pos;
      const int r = dist + max_pos;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        cell[rr][n] = reinterpret_cast<float2*>(de + r * HD + de_col(r, 8 * n + 2 * t));
        if (live[rr]) x[rr][n] = *cell[rr][n];
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!live[rr]) continue;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        x[rr][n].x += acc[n][2 * rr];
        x[rr][n].y += acc[n][2 * rr + 1];
        *cell[rr][n] = x[rr][n];
      }
    }
  }
}

template <typename T, int NW, int MODE, int HD>
__global__ void __launch_bounds__(32 * NW, 1)
flash_rel_bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ table, const T* __restrict__ gout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, T* __restrict__ dk,
              T* __restrict__ dv, float* __restrict__ partials, int G, int Tq, int Tk,
              int max_pos, int t_valid, int q_offset, int de_global) {
  using L = Layout<T, NW, MODE, HD>;
  constexpr int NT = 32 * NW, BQ = L::BQ, WIN = L::WIN, P = L::P, TS = L::TS;
  constexpr int QPL = L::QPL, KPL = L::KPL, EPL = L::EPL, CHUNK = L::CHUNK;
  constexpr int KD = HD / 16, NB = HD / 8;
  constexpr bool kOwnsQ = L::kOwnsQ;
  // 8-wide blocks of dk / dv a warp owns: the warps w and w + 4 own one key block
  constexpr int NPW = NB * 4 / NW;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::qs);
  bf16* gs = reinterpret_cast<bf16*>(smem + L::gs);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::ks);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::vs);
  bf16* es = reinterpret_cast<bf16*>(smem + L::es);
  unsigned char* scratch = smem + L::scratch;
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  float* eh = reinterpret_cast<float*>(smem + L::eh);
  float* el = reinterpret_cast<float*>(smem + L::el);
  float* slots = reinterpret_cast<float*>(smem + L::slots);
  // the block's dE rows: its buffer in shared memory, or with de_global its
  // row of the scratch (each block writes its own row either way)
  float* de = de_global ? partials + static_cast<size_t>(blockIdx.x) * (2 * max_pos + 1) * HD
                        : reinterpret_cast<float*>(smem + L::debuf);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* rt = reinterpret_cast<float*>(scratch + w * CHUNK);
  T* dr_w = reinterpret_cast<T*>(scratch + w * CHUNK);
  T* pb_w = reinterpret_cast<T*>(scratch + w * CHUNK + L::pb);
  T* dsb_w = reinterpret_cast<T*>(scratch + w * CHUNK + L::dsb);
  const int n_rows = (2 * max_pos + 1) * HD;

  // once a block: the table's two end rows; zero dE rows and slots
  if (tid < HD) {
    eh[tid] = widen(table[2 * max_pos * HD + tid]);
    el[tid] = widen(table[tid]);
  }
  if (kOwnsQ) {
    for (int e = tid; e < n_rows; e += NT) de[e] = 0.f;
    for (int e = tid; e < 2 * HD * NW; e += NT) slots[e] = 0.f;
  }

  const int n_qtiles = (Tq + BQ - 1) / BQ;
  const int n_ktiles = (Tk + BK - 1) / BK;
  const int per_group = kOwnsQ ? n_qtiles : n_ktiles;
  const int n_items = G * per_group;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int grp = item / per_group;
    const int own0 = (item % per_group) * (kOwnsQ ? BQ : BK);
    const T* qg = q + static_cast<size_t>(grp) * Tq * HD;
    const T* gg = gout + static_cast<size_t>(grp) * Tq * HD;
    const T* kg = k + static_cast<size_t>(grp) * Tk * HD;
    const T* vg = v + static_cast<size_t>(grp) * Tk * HD;
    const float* lg = lse + static_cast<size_t>(grp) * Tq;
    const float* dg = delta + static_cast<size_t>(grp) * Tq;

    __syncthreads();  // the previous item's tiles are consumed; the block's set-up is visible
    if (kOwnsQ) {
      stage_rows<T, NT, HD>(qs, QPL, qg, own0, BQ, Tq, tid);
      stage_rows<T, NT, HD>(gs, QPL, gg, own0, BQ, Tq, tid);
      for (int e = tid; e < BQ; e += NT) {
        lse_s[e] = own0 + e < Tq ? lg[own0 + e] : 0.f;
        delta_s[e] = own0 + e < Tq ? dg[own0 + e] : 0.f;
      }
    } else {
      stage_rows<T, NT, HD>(ks, KPL, kg, own0, BK, Tk, tid);
      stage_rows<T, NT, HD>(vs, KPL, vg, own0, BK, Tk, tid);
    }

    float dq_acc[NB][4];             // rows g, g+8; d = 8n + 2t, +1
    float c_hi[2], c_lo[2];          // this lane's share of the clipped pairs' ds sums
    float dk_acc[NPW][4], dv_acc[NPW][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
    c_hi[0] = c_hi[1] = c_lo[0] = c_lo[1] = 0.f;
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
      dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
    }

    // a tile of keys wholly past t_valid only writes its zeros
    const int n_inner = kOwnsQ ? (t_valid + BK - 1) / BK : (own0 < t_valid ? n_qtiles : 0);
    // the tiles that change with the walk travel through registers
    constexpr int VR = kOwnsQ ? BK : BQ;
    TileFetch<T, NT, VR, HD> a_next, b_next;  // K and V, or Q and g
    TileFetch<T, NT, WIN, HD> e_next;
    float lse_next = 0.f, delta_next = 0.f;
    auto fetch = [&](int it) {
      const int i0 = kOwnsQ ? own0 : it * BQ;
      const int j0 = kOwnsQ ? it * BK : own0;
      const int base = i0 + q_offset - j0 - (BK - 1);
      if (kOwnsQ) {
        a_next.fetch_rows(kg, j0, Tk, tid);
        b_next.fetch_rows(vg, j0, Tk, tid);
      } else {
        a_next.fetch_rows(qg, i0, Tq, tid);
        b_next.fetch_rows(gg, i0, Tq, tid);
        if (tid < BQ) {
          lse_next = i0 + tid < Tq ? lg[i0 + tid] : 0.f;
          delta_next = i0 + tid < Tq ? dg[i0 + tid] : 0.f;
        }
      }
      if (clip_kind(base, BQ, max_pos) == kMixed) e_next.fetch_window(table, base, max_pos, tid);
    };
    if (n_inner > 0) fetch(0);
    bool prev_mixed = false;
    int prev_base = 0;

    for (int it = 0; it < n_inner; ++it) {
      const int i0 = kOwnsQ ? own0 : it * BQ;
      const int j0 = kOwnsQ ? it * BK : own0;
      const int base = i0 + q_offset - j0 - (BK - 1);
      const int kind = clip_kind(base, BQ, max_pos);

      __syncthreads();  // the previous tile pair is consumed, its dR is whole
      if (kOwnsQ) {
        // the previous pair's share of the table's gradient: its dR stays until
        // the next block sync, Q for the whole item
        if (prev_mixed) window_grad<T, NW, CHUNK, HD>(scratch, qs, de, prev_base, max_pos, w, lane);
        prev_mixed = kind == kMixed;
        prev_base = base;
        a_next.store(ks, tid);
        b_next.store(vs, tid);
      } else {
        a_next.store(qs, tid);
        b_next.store(gs, tid);
        if (tid < BQ) {
          lse_s[tid] = lse_next;
          delta_s[tid] = delta_next;
        }
      }
      if (kind == kMixed) e_next.store(es, tid);
      __syncthreads();
      if (it + 1 < n_inner) fetch(it + 1);  // in flight while this pair is computed

      FragA<P> qa[KD], ga[KD];
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        load_a<P>(qa[kd], qs, QPL, TS, 16 * w, 16 * kd, lane);
        load_a<P>(ga[kd], gs, QPL, TS, 16 * w, 16 * kd, lane);
      }
      const bf16* qs_w = qs + 16 * w * TS;
      float pos_hi[2] = {0.f, 0.f}, pos_lo[2] = {0.f, 0.f};
      if (kind != kMixed) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float hi = 0.f, lo = 0.f;
#pragma unroll
          for (int h = 0; h < NB; ++h) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 2 * t + 8 * h + e;
              const float x = tile_value<P>(qs_w, QPL, (g + 8 * rr) * TS + d);
              hi += x * eh[d];
              lo += x * el[d];
            }
          }
          pos_hi[rr] = quad_sum(hi);
          pos_lo[rr] = quad_sum(lo);
        }
      }

      float s[BK / 8][4], dp[BK / 8][4];
      warp_logits<P, HD>(s, qa, ks, es, EPL, rt, kind, pos_hi, pos_lo, w, lane);
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          FragB<P> vb;
          load_b<P>(vb, vs, KPL, TS, 8 * nb, 16 * kd, lane);
          mma(dp[nb], ga[kd], vb);
        }
      }
      // s becomes p, dp becomes ds
      const int nk = t_valid - j0;
      const float lse_r[2] = {lse_s[16 * w + g], lse_s[16 * w + g + 8]};
      const float delta_r[2] = {delta_s[16 * w + g], delta_s[16 * w + g + 8]};
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = 8 * nb + 2 * t + e < nk;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float p = valid ? __expf(s[nb][2 * rr + e] - lse_r[rr]) : 0.f;
            s[nb][2 * rr + e] = p;
            dp[nb][2 * rr + e] = p * (dp[nb][2 * rr + e] - delta_r[rr]);
          }
        }
      }

      // every lane has read its R: the warp's chunk is free for dR, P and dS
      if (kind == kMixed) __syncwarp();

      if (kOwnsQ) {
        // dq += dS . K
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const float dsv[8] = {dp[2 * kk][0], dp[2 * kk][1], dp[2 * kk][2], dp[2 * kk][3],
                                dp[2 * kk + 1][0], dp[2 * kk + 1][1], dp[2 * kk + 1][2], dp[2 * kk + 1][3]};
          FragA<P> da;
          frag_from(da, dsv);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            FragB<P> kb;
            load_b_trans<P>(kb, ks, KPL, TS, 8 * n, 16 * kk, lane);
            mma(dq_acc[n], da, kb);
          }
        }
        if (kind == kMixed) {
          // dR[r][r - b + 63] = ds[r][b]; a pair that is itself clipped goes to its
          // query's sum instead, as in a clipped tile pair (uniform test first)
          const bool some_high = base + BQ + BK - 2 >= max_pos;
          const bool some_low = base <= -max_pos;
          // the rows lie over the R scratch: the cells no pair writes are zeroed anew,
          // 16 a row (columns below r and from r + 64)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = lane >> 1, cell = (lane & 1) * 8 + i;
            narrow(0.f, dr_w + row * DRS + (cell < row ? cell : cell + BK));
          }
#pragma unroll
          for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = g - (8 * nb + 2 * t + e) + BK - 1;
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                float x = dp[nb][2 * rr + e];
                const int dist = base + 16 * w + c + 8 * rr;
                if (some_high && dist >= max_pos) {
                  c_hi[rr] += x;
                  x = 0.f;
                }
                if (some_low && dist <= -max_pos) {
                  c_lo[rr] += x;
                  x = 0.f;
                }
                narrow(x, dr_w + (g + 8 * rr) * DRS + c + 8 * rr);
              }
            }
          }
        } else {
          float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
          for (int nb = 0; nb < BK / 8; ++nb) {
            sum0 += dp[nb][0] + dp[nb][1];
            sum1 += dp[nb][2] + dp[nb][3];
          }
          if (kind == kHigh) {
            c_hi[0] += sum0;
            c_hi[1] += sum1;
          } else {
            c_lo[0] += sum0;
            c_lo[1] += sum1;
          }
        }
      }
      if (!kOwnsQ) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int at = (g + 8 * rr) * PS + 8 * nb + 2 * t;
            narrow2(s[nb][2 * rr], s[nb][2 * rr + 1], pb_w + at);
            narrow2(dp[nb][2 * rr], dp[nb][2 * rr + 1], dsb_w + at);
          }
        }
      }
      if (!kOwnsQ) __syncthreads();  // P and dS of every warp are written

      if (kOwnsQ && kind == kMixed) {
        __syncwarp();  // this warp's dR is written
        // dq += dR_w . E_window (the warp's own 80 window rows)
#pragma unroll
        for (int kk = 0; kk < RCOLS / 16; ++kk) {
          FragA<P> da;
          load_a_scratch(da, dr_w, DRS, 0, 16 * kk, lane);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            FragB<P> eb;
            load_b_trans<P>(eb, es, EPL, TS, 8 * n, 16 * w + 16 * kk, lane);
            mma(dq_acc[n], da, eb);
          }
        }
      }
      if (!kOwnsQ) {
        // dv += P^T . g, dk += dS^T . Q: this warp's 16 keys, NPW column blocks
        const int m = w & 3, n_first = (w >> 2) * NPW;
#pragma unroll
        for (int kk = 0; kk < NW; ++kk) {
          // the queries of warp kk: that warp's rows of P and dS
          FragA<P> pa, da;
          load_a_scratch_trans(pa, reinterpret_cast<const T*>(scratch + kk * CHUNK + L::pb), PS, 16 * m, 0, lane);
          load_a_scratch_trans(da, reinterpret_cast<const T*>(scratch + kk * CHUNK + L::dsb), PS, 16 * m, 0, lane);
#pragma unroll
          for (int n = 0; n < NPW; ++n) {
            FragB<P> gb, qb;
            load_b_trans<P>(gb, gs, QPL, TS, 8 * (n_first + n), 16 * kk, lane);
            load_b_trans<P>(qb, qs, QPL, TS, 8 * (n_first + n), 16 * kk, lane);
            mma(dv_acc[n], pa, gb);
            mma(dk_acc[n], da, qb);
          }
        }
      }
    }

    if (kOwnsQ) {
      if (prev_mixed) {
        __syncthreads();  // the last pair's dR is whole
        window_grad<T, NW, CHUNK, HD>(scratch, qs, de, prev_base, max_pos, w, lane);
      }
      const float ch[2] = {quad_sum(c_hi[0]), quad_sum(c_hi[1])};
      const float cl[2] = {quad_sum(c_lo[0]), quad_sum(c_lo[1])};
      // uniform in the block: skip the rows its distances never reach
      if (own0 + BQ - 1 + q_offset >= max_pos) {
        add_clipped_slot<P, HD>(slots + 2 * HD * w, ch, qs + 16 * w * TS, QPL, lane);
      }
      if (own0 + q_offset - (t_valid - 1) <= -max_pos) {
        add_clipped_slot<P, HD>(slots + 2 * HD * w + HD, cl, qs + 16 * w * TS, QPL, lane);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = own0 + 16 * w + g + 8 * rr;
        if (row >= Tq) continue;
        T* o = dq + (static_cast<size_t>(grp) * Tq + row) * HD;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int d = 8 * n + 2 * t;
          narrow2(dq_acc[n][2 * rr] + ch[rr] * eh[d] + cl[rr] * el[d],
                  dq_acc[n][2 * rr + 1] + ch[rr] * eh[d + 1] + cl[rr] * el[d + 1], o + d);
        }
      }
    }
    if (!kOwnsQ) {
      const int m = w & 3, n_first = (w >> 2) * NPW;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = own0 + 16 * m + g + 8 * rr;
        if (row >= Tk) continue;
#pragma unroll
        for (int n = 0; n < NPW; ++n) {
          const size_t at = (static_cast<size_t>(grp) * Tk + row) * HD + 8 * (n_first + n) + 2 * t;
          narrow2(dk_acc[n][2 * rr], dk_acc[n][2 * rr + 1], dk + at);
          narrow2(dv_acc[n][2 * rr], dv_acc[n][2 * rr + 1], dv + at);
        }
      }
    }
  }

  if (kOwnsQ) {
    __syncthreads();  // every warp's sums are in its slots and the block's rows
    // the slots in warp order into rows 2*max_pos and 0 (one row where max_pos is 0)
    if (tid < HD) {
      float hi = 0.f, lo = 0.f;
      for (int wk = 0; wk < NW; ++wk) {
        hi += slots[2 * HD * wk + tid];
        lo += slots[2 * HD * wk + HD + tid];
      }
      de[2 * max_pos * HD + de_col(2 * max_pos, tid)] += hi;
      de[de_col(0, tid)] += lo;
    }
    if (!de_global) {
      __syncthreads();
      // this block's sums to its row of the partial sums
      float* mine = partials + static_cast<size_t>(blockIdx.x) * n_rows;
      for (int e = tid; e < n_rows; e += NT) mine[e] = de[e];
    }
  }
}

struct Args {
  const void *q, *k, *v, *table, *out, *gout, *lse;
  void *dq, *dk, *dv, *delta, *dtable, *partials;
  int G, Tq, Tk, max_pos, t_valid, q_offset, partial_rows;
  cudaStream_t stream;
};

// How one of the two kernels is launched at these shapes: its shared memory
// and its grid. The kernel that sums dE runs persistent blocks, as many as the
// card holds at once (one row of the partial sums each); the dk/dv kernel one
// block an item.
struct Plan {
  int bytes, blocks;
};

template <typename T, int NW, int MODE, int HD>
int plan(int G, int extent, int max_pos, bool shared_de, Plan* p) {
  using L = Layout<T, NW, MODE, HD>;
  auto kernel = flash_rel_bwd<T, NW, MODE, HD>;
  p->bytes = L::bytes(max_pos, shared_de);
  if (p->bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = MODE == kOwnQ ? L::BQ : BK;
  long long blocks = static_cast<long long>(G) * ((extent + tile - 1) / tile);
  if (L::kOwnsQ) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * NW, p->bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const long long room = static_cast<long long>(sms) * per_sm;
    if (blocks > room) blocks = room;
  }
  if (blocks < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p->blocks = static_cast<int>(blocks);
  return 0;
}

// the block's dE buffer fits beside the tiles
template <typename T, int HD>
bool shared_de_fits(int max_pos) {
  return Layout<T, kWarpsQ<T, HD>, kOwnQ, HD>::bytes(max_pos, true) <= MAX_SMEM;
}

template <typename T, int NW, int MODE, int HD>
int launch_one(const Args& a) {
  const bool shared_de = shared_de_fits<T, HD>(a.max_pos);
  Plan p;
  int err = plan<T, NW, MODE, HD>(a.G, MODE == kOwnQ ? a.Tq : a.Tk, a.max_pos, shared_de, &p);
  if (err != 0) return err;
  const int n = (2 * a.max_pos + 1) * HD;
  // the kernel that sums dE writes one row of `partials` a block
  if (MODE == kOwnQ && p.blocks > a.partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  flash_rel_bwd<T, NW, MODE, HD><<<static_cast<unsigned>(p.blocks), 32 * NW, p.bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.table), static_cast<const T*>(a.gout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.partials), a.G, a.Tq, a.Tk, a.max_pos, a.t_valid, a.q_offset,
      static_cast<int>(!shared_de));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || MODE != kOwnQ) return err;
  flash_rel_sum_partials<<<(n + 255) / 256, 256, 0, a.stream>>>(
      static_cast<const float*>(a.partials), static_cast<float*>(a.dtable), p.blocks, n, HD);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const Args& a) {
  const int rows = a.G * a.Tq;
  flash_rel_delta<T, HD><<<(rows + 255) / 256, 256, 0, a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.gout), static_cast<float*>(a.delta), rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // the kernels read the delta written above: same stream, so in order
  err = launch_one<T, kWarpsQ<T, HD>, kOwnQ, HD>(a);
  return err != 0 ? err : launch_one<T, 4, kOwnK, HD>(a);
}

// rows of `partials` a launch at these shapes writes, or minus the CUDA error
template <typename T, int HD>
int partial_rows(int G, int Tq, int max_pos) {
  Plan p;
  const int err = plan<T, kWarpsQ<T, HD>, kOwnQ, HD>(G, Tq, max_pos, shared_de_fits<T, HD>(max_pos), &p);
  return err != 0 ? -err : p.blocks;
}

template <typename T, int HD>
int smem_bytes(int which, int max_pos) {
  if (which == 0) {
    return Layout<T, kWarpsQ<T, HD>, kOwnQ, HD>::bytes(max_pos, shared_de_fits<T, HD>(max_pos));
  }
  return which == 1 ? Layout<T, 4, kOwnK, HD>::bytes(max_pos, false) : -1;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream` and returns the first CUDA
// error (0 on success); does not synchronise. Scratch from the caller, none
// of it zeroed: `delta` fp32 [G, Tq]; `partials` fp32 [partial_rows,
// (2*max_pos+1)*head_dim] with partial_rows at least what
// cmgan_flash_rel_attention_bwd_partial_rows gives for these shapes; `dtable`
// fp32 [2*max_pos+1, head_dim] receives the table's gradient. Pointers are
// 16-byte aligned; head_dim is 16, 32 or 64.
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

// Rows the `partials` scratch needs on the current device: one a block of the
// kernel that sums the table's gradient. Negative: minus a CUDA error.
extern "C" int cmgan_flash_rel_attention_bwd_partial_rows(int is_bf16, int head_dim, int G,
                                                          int Tq, int max_pos) {
  if (G <= 0 || Tq <= 0 || max_pos < 0) return -static_cast<int>(cudaErrorInvalidValue);
  return with_head_dim(head_dim, -static_cast<int>(cudaErrorInvalidValue), [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? partial_rows<__nv_bfloat16, HD>(G, Tq, max_pos)
                   : partial_rows<float, HD>(G, Tq, max_pos);
  });
}

// Dynamic shared memory, in bytes, of one block of kernel `which` (0: the
// kernel that sums dq and the table's gradient, 1: the dk/dv kernel), or -1.
extern "C" int cmgan_flash_rel_attention_bwd_smem(int is_bf16, int head_dim, int which,
                                                  int max_pos) {
  return with_head_dim(head_dim, -1, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return is_bf16 ? smem_bytes<__nv_bfloat16, HD>(which, max_pos)
                   : smem_bytes<float, HD>(which, max_pos);
  });
}
