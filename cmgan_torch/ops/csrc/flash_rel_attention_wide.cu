// Fused attention with Shaw relative positions for heads wider than 64,
// forward and backward, on Hopper's tensor cores (sm_90a).
//
// Replaces, for head dims over 64, the TPU kernels
// cmgan_tpu/ops/flash_attention.py:_flash_kernel (:91, forward) and
// :_flash_bwd_kernel (:250, backward), as flash_rel_attention.cu and
// flash_rel_attention_bwd.cu do for head dims 16, 32 and 64. The function,
// the arguments, the masks (t_valid, q_offset) and the fp32 row
// log-sum-exp are theirs:
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// and its gradients dq, dk, dv, dE. This library exports the same C entries
// as those two, under the same names, for any positive head dim; the wrapper
// (ops/flash_attention.py) sends it the heads wider than 64.
//
// What bounds it on an H100 SXM (700 W part): its products. At G 404, T 641,
// D 128 the forward needs 1.3e11 FLOP and the backward 3.4e11: 0.13 and 0.34
// ms at the 989 TFLOP/s of the bf16 tensor cores. The fp32 route below runs
// six bf16 products for each, so its bound is six times that. The bytes
// (inputs read once, outputs written once) take a tenth of it.
//
// The design. Every product runs on the tensor cores as mma.sync.m16n8k16
// tiles with fp32 accumulators (flash_rel_common.cuh): a bf16 input is one
// operand; an fp32 input is carried as three bf16 parts, and each product as
// the six part products whose terms reach 2^-24 of the result, summed
// smallest first outside the truncating accumulator (TF32 stood 2e-3 from
// float64 and misses the 1e-4 limit). What differs from the D <= 64 kernels
// is where the head dim lives:
//
// - Nothing on the card grows with the head dim. A block walks items: a
//   chunk of the head dim's columns (32 bf16 / 16 fp32; the logits) or a
//   chunk of its slab's output columns. An item's rows are copied into shared
//   memory by 16-byte cp.async while the block computes the item before:
//   bf16 rows are the operands as they land (two slots in turns); fp32 rows
//   land in one slot and each thread splits the granules it copied into three
//   bf16 planes, read by ldmatrix. Columns past the head dim are zero-filled
//   and a chunk runs only the 16-column depth steps it needs: at most 15
//   padded columns, nothing padded in device memory. A row that is not a
//   whole number of 16-byte groups is copied 8 bytes at a time (bf16 rows of
//   whole 8-byte groups, D 100) or element by element.
// - A block owns a tile of 64 queries (or, for dk/dv, 64 keys) and one slab
//   of output columns; the grid's fastest index walks the slabs. Each slab
//   block computes the logits over the whole head dim and accumulates the
//   output (or dq, or dk and dv) for its slab only, in registers: slabs of at
//   most 128 columns for the forward up to D 128, 256 past it, 128 for dq and
//   64 for dk and dv (two accumulators), equal widths rounded up to 8. Past
//   one slab the logits are recomputed once a slab, so no D is too wide.
// - The position term goes through the skew of kernels #1 and #2: a warp's
//   16 queries meet window rows 16w .. 16w + 78; R = Q_w . E_window^T is
//   added chunk by chunk through a per-warp scratch to the logits at
//   R[r][r - b + 63]. A tile pair whose every distance is clipped stages no
//   window: its position logit is q_a . E[2 max_pos] or q_a . E[0].
// - The backward keeps the two-kernel form: flash_rel_wide_bwd_q owns a query
//   tile (dq and the table's gradient), flash_rel_wide_bwd_k a key tile (dk
//   and dv, with P and dS through shared memory so that their transposes are
//   A operands). ds is written skewed, dR[a][a - c + 63] = ds[a][c], so dq's
//   position part (dR . E_window) and the window's gradient (dR^T . Q) are
//   tile products. The table's gradient is summed in a fixed order, with no
//   atomics: the dq kernel's blocks are persistent (as many as the card holds
//   at once, a whole number for each slab; block b takes the (query tile,
//   slab) items b, b + grid, ..., all of one slab), and each adds into rows of
//   its own in device memory, [2 max_pos + 1, slab] floats: the window's
//   gradient once a tile pair, window row and column (one owner a cell), and
//   the pairs clipped to an end row of the table, summed per query, once an
//   item. flash_rel_wide_sum_partials then adds the blocks' rows in block
//   order: two runs on the same inputs give the same bits.
//
// Softmax in fp32; outputs and gradients are written in the input type.
// What this version leaves: the logits recomputed per slab past D 128 (dk
// and dv past 64), one item in flight (two block syncs an item), mma.sync
// where wgmma would take fewer instructions, the skew's round trip through
// shared memory once a chunk.

#include "flash_rel_common.cuh"

namespace {

using namespace flash_rel;

constexpr int NW = 4;            // warps a block
constexpr int NT = 32 * NW;
constexpr int BQ = 16 * NW;      // queries a tile (keys: BK = 64)
constexpr int WIN = BQ + BK;     // window rows staged (WIN - 1 used)
constexpr int SLAB_FWD = 256;    // widest slab of output columns: forward (128 up to D 128),
constexpr int SLAB_Q = 128;      // dq,
constexpr int SLAB_K = 64;       // dk and dv
constexpr int VH = 64;           // columns of V a forward item stages (half the widest slab)
constexpr int DRS = 88;          // elements a row of a warp's dR scratch (80 used)
constexpr int PS = 72;           // elements a row of a warp's P and dS rows (64 used)

// Head-dim columns an item stages: 32 for bf16, 16 for fp32 (whose rows are
// staged twice: as fp32 where they land, then split into three bf16 planes),
// so that two blocks fit a multiprocessor
template <typename T> __host__ __device__ constexpr int dc() { return sizeof(T) == 2 ? 32 : 16; }
// elements a row of staged input holds beyond its columns: 16 bytes, so that
// rows stay 16-byte aligned for cp.async and ldmatrix spreads over the banks
template <typename T> __host__ __device__ constexpr int row_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

// The slab width for a head dim and a widest slab: the fewest slabs, equal
// widths rounded up to 8 columns (ops/flash_attention.py:slab_width mirrors it).
__host__ __device__ constexpr int slab_width(int hd, int widest) {
  return ((hd + (hd + widest - 1) / widest - 1) / ((hd + widest - 1) / widest) + 7) / 8 * 8;
}
__host__ __device__ constexpr int n_slabs(int hd, int slab) { return (hd + slab - 1) / slab; }

// x, hidden from the optimiser: indices and addresses derived from it are
// computed where they are used, not hoisted out of the loops over items
// (kept live across them, they would take the registers the accumulators
// need)
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int window_row(int base, int r, int max_pos) {
  return min(max(base + r, -max_pos), max_pos) + max_pos;
}

// ---- staging. A block walks items (a chunk of the head dim's columns for
// the logits, or a chunk of the slab's columns), each a set of rows copied
// into shared memory in the input type by 16-byte cp.async that land while
// the block computes the item before. bf16 rows are the products' operands
// as they land (two slots, in turns); fp32 rows land in one slot and each
// thread splits the granules it copied into three bf16 planes. ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // the clobber keeps the thread's reads of what it staged before (the fp32
  // split) ahead of the copy that overwrites it
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bytes a cp.async moves for rows hd wide: 16 where rows are whole 16-byte
// groups; 8 for bf16 rows of whole 8-byte groups (fp32 rows are split a
// 16-byte granule a thread); else 0: element by element.
template <typename T>
__device__ __forceinline__ int copy_bytes(int hd) {
  if (hd % row_pad<T>() == 0) return 16;
  return sizeof(T) == 2 && hd % 4 == 0 ? 8 : 0;
}

// Rows r < ROWS are row_of(r) of src (negative: a zero row), columns c0 ..
// c0 + COLS - 1 (zero at or past lim), into dst [ROWS][STRIDE], a 16-byte
// granule a thread and step: by cp.async of `copy` bytes (copy_bytes), in
// flight until the thread's next wait, or element by element (copy 0), done
// on return.
template <typename T, int ROWS, int COLS, int STRIDE, typename RowOf>
__device__ __forceinline__ void fetch(T* dst, const T* __restrict__ src, RowOf row_of, int hd,
                                      int c0, int lim, int tid, int copy) {
  constexpr int E = 16 / sizeof(T), G = COLS / E, PER = ROWS * G / NT;
  static_assert(COLS % E == 0 && ROWS * G % NT == 0, "whole 16-byte groups, whole rounds");
  tid = opaque(tid);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT;
    const int r = e / G, c = c0 + (e % G) * E;
    const int row = row_of(r);
    const bool ok = row >= 0 && c < lim;
    const T* s = ok ? src + static_cast<size_t>(row) * hd + c : src;
    T* d = dst + r * STRIDE + (e % G) * E;
    if (copy == 16) {
      cp_async16(d, s, ok);
    } else if (copy == 8) {
      const bool ok2 = row >= 0 && c + E / 2 < lim;  // implies ok
      cp_async8(d, s, ok);
      cp_async8(d + E / 2, ok2 ? s + E / 2 : src, ok2);
    } else {
#pragma unroll
      for (int u = 0; u < E; ++u) narrow(ok && c + u < lim ? widen(s[u]) : 0.f, d + u);
    }
  }
}

// The fp32 granules this thread fetched (the same rows and columns) from src
// [ROWS][SSTRIDE] into three bf16 planes [ROWS][DSTRIDE], `plane` apart. The
// one slot is refilled right after a thread's split, with no block sync: so
// every item fetches rows of RST elements, COLS = DC, from rows a multiple of
// 32 apart, and each address of the slot has one owner thread whatever the
// item.
template <int ROWS, int COLS, int SSTRIDE, int DSTRIDE>
__device__ __forceinline__ void split_rows(bf16* dst, int plane, const float* src, int tid) {
  constexpr int G = COLS / 4, PER = ROWS * G / NT;
  tid = opaque(tid);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, r = e / G, c = 4 * (e % G);
    const float4 x = *reinterpret_cast<const float4*>(src + r * SSTRIDE + c);
    uint32_t lo[3], hi[3];
    split3(x.x, x.y, lo);
    split3(x.z, x.w, hi);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      *reinterpret_cast<uint2*>(dst + p * plane + r * DSTRIDE + c) = make_uint2(lo[p], hi[p]);
    }
  }
}

// c += a . b. With fp32 operands and TWO set, the five small part products
// run as two chains (three and two long) in place of one of five: the same
// terms, summed smallest first into each chain, with less latency between
// dependent tensor-core products, for the forward, which has the registers
template <bool TWO>
__device__ __forceinline__ void mma_w(float* c, const FragA<1>& a, const FragB<1>& b) {
  mma(c, a, b);
}
template <bool TWO>
__device__ __forceinline__ void mma_w(float* c, const FragA<3>& a, const FragB<3>& b) {
  if (!TWO) {
    mma(c, a, b);
    return;
  }
  float big[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(s1, a.r[1], b.r[1]);
  mma_bf16(s2, a.r[2], b.r[0]);
  mma_bf16(s1, a.r[0], b.r[2]);
  mma_bf16(s2, a.r[1], b.r[0]);
  mma_bf16(s1, a.r[0], b.r[1]);
  mma_bf16(big, a.r[0], b.r[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += big[i] + (s1[i] + s2[i]);
}

// ---- the logits of one warp over one staged chunk ----

// s[nb] (16 queries x 64 keys) += Q_c . K_c^T and, for a mixed tile pair,
// the chunk's position logits R_c = Q_c . E_c^T through the skew. qs, ks, es:
// the chunk's rows of Q, K and the window as P bf16 planes `plane` apart, CS
// elements a row; `ksteps` of its 16-column depth steps hold the head dim.
template <int P, int DC, bool TWO = false>
__device__ __forceinline__ void chunk_logits(float (*s)[4], const bf16* qs, const bf16* ks,
                                             const bf16* es, int plane, float* rt, int kind,
                                             int ksteps, int w, int lane) {
  constexpr int CS = DC + 8;
  lane = opaque(lane);
  const int g = lane >> 2, t = lane & 3;
  FragA<P> qa[DC / 16];
#pragma unroll
  for (int kd = 0; kd < DC / 16; ++kd) {
    if (kd < ksteps) load_a<P>(qa[kd], qs, plane, CS, 16 * w, 16 * kd, lane);
  }
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int kd = 0; kd < DC / 16; ++kd) {
      if (kd < ksteps) {
        FragB<P> kb;
        load_b<P>(kb, ks, plane, CS, 8 * nb, 16 * kd, lane);
        mma_w<TWO>(s[nb], qa[kd], kb);
      }
    }
  }
  if (kind != kMixed) return;
  __syncwarp();  // the scratch's earlier readers are done
#pragma unroll
  for (int nb = 0; nb < RCOLS / 8; ++nb) {
    float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kd = 0; kd < DC / 16; ++kd) {
      if (kd < ksteps) {
        FragB<P> eb;
        load_b<P>(eb, es, plane, CS, 16 * w + 8 * nb, 16 * kd, lane);
        mma_w<TWO>(r, qa[kd], eb);
      }
    }
    const int c = 8 * nb + 2 * t;
    rt[c * RS + g] = r[0];
    rt[(c + 1) * RS + g] = r[1];
    rt[c * RS + g + 8] = r[2];
    rt[(c + 1) * RS + g + 8] = r[3];
  }
  __syncwarp();
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = g - (8 * nb + 2 * t + e) + BK - 1;  // row g meets this key at column c
      s[nb][e] += rt[c * RS + g];
      s[nb][2 + e] += rt[(c + 8) * RS + g + 8];
    }
  }
}

// q_a . E[2 max_pos] and q_a . E[0] for the warp's rows g and g + 8 (rows at or
// past Tq: 0), from device memory, over the whole head dim
template <typename T>
__device__ __forceinline__ void clipped_scalars(float* pos_hi, float* pos_lo, const T* qg,
                                                const T* __restrict__ table, int row0, int Tq,
                                                int hd, int max_pos, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    float hi = 0.f, lo = 0.f;
    if (row < Tq) {
#pragma unroll 1
      for (int d = t; d < hd; d += 4) {
        const float x = widen(qg[static_cast<size_t>(row) * hd + d]);
        hi = fmaf(x, widen(table[static_cast<size_t>(2 * max_pos) * hd + d]), hi);
        lo = fmaf(x, widen(table[d]), lo);
      }
    }
    pos_hi[rr] = quad_sum(hi);
    pos_lo[rr] = quad_sum(lo);
  }
}

// s += the clipped pair's position logit, one scalar a row
__device__ __forceinline__ void add_rows(float (*s)[4], float p0, float p1) {
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    s[nb][0] += p0;
    s[nb][1] += p0;
    s[nb][2] += p1;
    s[nb][3] += p1;
  }
}

// Where a block's items land and are read: ROWS rows of COLS columns a slot
// (RS_T elements of T a row), bf16 operands of CS elements a row and P planes
// `plane` apart (bf16: the slot itself)
template <typename T, int ROWS, int COLS>
struct Staging {
  static constexpr int P = Parts<T>::N, CS = COLS + 8, RST = COLS + row_pad<T>();
  static constexpr int SLOTS = P == 1 ? 2 : 1;
  static constexpr int SLOT = ROWS * RST;             // elements of T
  static constexpr int PLANE = ROWS * CS;             // bf16 elements
  static constexpr int slots_bytes = SLOTS * SLOT * static_cast<int>(sizeof(T));
  static constexpr int planes_bytes = P == 1 ? 0 : 3 * PLANE * 2;
  static constexpr int bytes = slots_bytes + planes_bytes;
  static_assert(P == 1 ? RST == CS : true, "bf16 rows are read where they land");
};

// ---- forward ----

// Items: for each key tile, the head dim's chunks (rows of Q, K and, for a
// mixed pair, the window: the logits), then the slab's columns of V in one
// or two halves (P . V).
template <typename T>
struct FwdLayout {
  static constexpr int DC = dc<T>();
  using S = Staging<T, BQ + BK + WIN, DC>;
  static constexpr int VST = VH + row_pad<T>(), VCS = VH + 8;  // a half slab of V
  // bf16 lands as [BK][VST]; fp32 as VH / DC blocks [BK][RST] of DC columns
  static_assert(BK * VST <= S::SLOT && BK * VH / DC * S::RST <= S::SLOT && BK * VCS <= S::PLANE,
                "a half slab of V fits");
  static constexpr int rt = S::bytes;  // NW x [RCOLS][RS] fp32
  static constexpr int bytes = rt + NW * RCOLS * RS * 4;
};

// SLAB: the widest slab the instantiation holds in registers, 128 (with the
// fp32 products in two chains) or 256
template <typename T, int SLAB>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ table, T* __restrict__ out, float* __restrict__ lse,
                   int Tq, int Tk, int hd, int n_qtiles, int slab, int max_pos, int t_valid,
                   int q_offset) {
  using L = FwdLayout<T>;
  using S = typename L::S;
  constexpr int P = S::P, DC = L::DC, RST = S::RST, CS = S::CS, VST = L::VST, VCS = L::VCS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  bf16* planes = reinterpret_cast<bf16*>(smem + S::slots_bytes);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* rt = reinterpret_cast<float*>(smem + L::rt) + w * RCOLS * RS;
  const int slabs = n_slabs(hd, slab);
  const int item = blockIdx.x / slabs;
  // the slab's first column, its end, its 8-column tiles: computed where used
  auto s0 = [=] { return opaque(static_cast<int>(blockIdx.x) % slabs) * slab; };
  auto s_end = [=] { return min(hd, s0() + slab); };
  auto nn = [=] { return (s_end() - s0() + 7) / 8; };
  const int grp = item / n_qtiles;
  const int i0 = (item % n_qtiles) * BQ;
  // the group's rows, addressed where they are used
  auto qg = [=] { return q + static_cast<size_t>(opaque(grp)) * Tq * hd; };
  auto kg = [=] { return k + static_cast<size_t>(opaque(grp)) * Tk * hd; };
  auto vg = [=] { return v + static_cast<size_t>(opaque(grp)) * Tk * hd; };
  const int copy = copy_bytes<T>(hd);

  float acc[SLAB / 8][4];  // out rows g, g+8; columns s0 + 8n + 2t, +1
#pragma unroll
  for (int n = 0; n < SLAB / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float s[BK / 8][4];

  const int nc = (hd + DC - 1) / DC;
  const int per_tile = nc + (s_end() - s0() + VH - 1) / VH;
  const int total = (t_valid + BK - 1) / BK * per_tile;
  auto q_row = [=](int r) { return i0 + r < Tq ? i0 + r : -1; };
  auto slot_of = [=](int it) { return slots + (S::SLOTS == 2 ? (it & 1) * S::SLOT : 0); };
  auto issue = [=](int it) {
    const int j0 = it / per_tile * BK, sub = it % per_tile;
    const int base = i0 + q_offset - j0 - (BK - 1);
    T* slot = slot_of(it);
    auto k_row = [=](int r) { return j0 + r < Tk ? j0 + r : -1; };
    if (sub < nc) {
      const int d0 = sub * DC;
      fetch<T, BQ, DC, RST>(slot, qg(), q_row, hd, d0, hd, tid, copy);
      fetch<T, BK, DC, RST>(slot + BQ * RST, kg(), k_row, hd, d0, hd, tid, copy);
      if (clip_kind(base, BQ, max_pos) == kMixed) {
        auto e_row = [=](int r) { return window_row(base, r, max_pos); };
        fetch<T, WIN, DC, RST>(slot + (BQ + BK) * RST, table, e_row, hd, d0, hd, tid, copy);
      }
    } else if constexpr (P == 3) {
      // fp32: as blocks of DC columns, so that every address of the slot is
      // copied (and split) by the same thread whatever the item
#pragma unroll
      for (int b = 0; b < VH / DC; ++b) {
        fetch<T, BK, DC, RST>(slot + b * BK * RST, vg(), k_row, hd, s0() + (sub - nc) * VH + b * DC,
                              s_end(), tid, copy);
      }
    } else {
      fetch<T, BK, VH, VST>(slot, vg(), k_row, hd, s0() + (sub - nc) * VH, s_end(), tid, copy);
    }
    cp_async_commit();
  };
  // fp32: the granules this thread copied for item it, into the planes
  auto split = [=](int it) {
    if constexpr (P == 3) {
      const int j0 = it / per_tile * BK, sub = it % per_tile;
      const float* slot = reinterpret_cast<const float*>(slot_of(it));
      if (sub < nc) {
        split_rows<BQ + BK, DC, RST, CS>(planes, S::PLANE, slot, tid);
        if (clip_kind(i0 + q_offset - j0 - (BK - 1), BQ, max_pos) == kMixed) {
          split_rows<WIN, DC, RST, CS>(planes + (BQ + BK) * CS, S::PLANE, slot + (BQ + BK) * RST,
                                       tid);
        }
      } else {
#pragma unroll
        for (int b = 0; b < VH / DC; ++b) {
          split_rows<BK, DC, RST, VCS>(planes + b * DC, S::PLANE, slot + b * BK * RST, tid);
        }
      }
    }
  };

  issue(0);
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    const int j0 = it / per_tile * BK, sub = it % per_tile;
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, BQ, max_pos);
    __syncthreads();  // the item before is consumed
    if constexpr (P == 3) {
      cp_async_wait<0>();
      split(it);  // then the slot takes the next item
      if (it + 1 < total) issue(it + 1);
    } else {
      if (it + 1 < total) {
        issue(it + 1);  // into the other slot
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
    }
    __syncthreads();  // this item's operands are in
    const bf16* ops = P == 1 ? reinterpret_cast<const bf16*>(slot_of(it)) : planes;
    const int ln = opaque(lane);

    if (sub < nc) {
      if (sub == 0) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      }
      const int ksteps = min(DC / 16, (hd - sub * DC + 15) / 16);
      chunk_logits<P, DC, SLAB == 128>(s, ops, ops + BQ * CS, ops + (BQ + BK) * CS, S::PLANE, rt, kind,
                                ksteps, w, ln);
      if (sub < nc - 1) continue;
      // the tile pair's logits are whole: the clipped scalars, the mask, the online softmax
      if (kind != kMixed) {
        float pos_hi[2], pos_lo[2];
        clipped_scalars(pos_hi, pos_lo, qg(), table, i0 + 16 * w, Tq, hd, max_pos, lane);
        add_rows(s, kind == kHigh ? pos_hi[0] : pos_lo[0], kind == kHigh ? pos_hi[1] : pos_lo[1]);
      }
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
        const float m_new = fmaxf(m[rr], quad_max(mx[rr]));  // finite: key j0 is valid
        corr[rr] = __expf(m[rr] - m_new);
        m[rr] = m_new;
        l[rr] *= corr[rr];
      }
#pragma unroll
      for (int n = 0; n < SLAB / 8; ++n) {
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
      continue;
    }
    // O += P . V over a half slab: columns s0 + VH h ..
    const int h = sub - nc, n_tiles = nn();
#pragma unroll
    for (int hh = 0; hh < SLAB / VH; ++hh) {
      if (hh != h) continue;  // uniform: the accumulators' indices stay static
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float pv[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2], s[2 * kk][3],
                             s[2 * kk + 1][0], s[2 * kk + 1][1], s[2 * kk + 1][2], s[2 * kk + 1][3]};
        FragA<P> pa;
        frag_from(pa, pv);
#pragma unroll
        for (int n = 0; n < VH / 8; ++n) {
          if (hh * (VH / 8) + n < n_tiles) {
            FragB<P> vb;
            load_b_trans<P>(vb, ops, S::PLANE, VCS, 8 * n, 16 * kk, ln);
            mma_w<SLAB == 128>(acc[hh * (VH / 8) + n], pa, vb);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = i0 + 16 * w + g + 8 * rr;
    const float sum = quad_sum(l[rr]);
    if (row < Tq) {
      const float inv = 1.f / sum;
      const int c0 = s0(), c_end = s_end(), n_tiles = nn();
      T* o = out + (static_cast<size_t>(grp) * Tq + row) * hd;
#pragma unroll
      for (int n = 0; n < SLAB / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c0 + 8 * n + 2 * t + e;
          if (n < n_tiles && d < c_end) narrow(acc[n][2 * rr + e] * inv, o + d);
        }
      }
      if (lse != nullptr && c0 == 0 && t == 0) {
        lse[static_cast<size_t>(grp) * Tq + row] = m[rr] + __logf(sum);
      }
    }
  }
}

// ---- backward ----

// delta_i = g_i . out_i, a warp a row
template <typename T>
__global__ void flash_rel_wide_delta(const T* __restrict__ out, const T* __restrict__ gout,
                                     float* __restrict__ delta, long long rows, int hd) {
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // whole warps leave together
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc += widen(out[r * hd + d]) * widen(gout[r * hd + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

enum Mode { kOwnQ = 0, kOwnK = 1 };

// Shared memory of a backward block, in bytes from its start: the staging
// (a chunk of the head dim: rows of Q, g, K, V and the window; or a chunk of
// the slab's columns), one R scratch a warp (its dR rows lie over it), the
// warps' rows of dS (dq kernel) or of P and dS (dk/dv kernel), then fp32
// arrays. With fp32 the P/dS rows lie in the planes' rows that the slab's
// chunks leave free; with bf16 over (dk/dv) or beside (dq) the R scratch.
template <typename T, int MODE>
struct BwdLayout {
  static constexpr int DC = dc<T>();
  using S = Staging<T, 2 * BQ + 2 * BK + WIN, DC>;
  // rows of a logits chunk, and of each kernel's slab chunks
  static constexpr int Q = 0, G = BQ, K = 2 * BQ, V = 2 * BQ + BK, E = 2 * BQ + 2 * BK;
  static constexpr int SK = 0, SE = BK, SQ = BK + WIN, SQ_END = SQ + BQ;  // dq kernel
  static constexpr int SG = 0, SQK = BQ, SQK_END = 2 * BQ;              // dk/dv kernel
  static constexpr int R_BYTES = RCOLS * RS * 4;
  static_assert(16 * DRS * sizeof(T) <= R_BYTES, "a warp's dR rows lie over its R scratch");
  static constexpr int PDS = 16 * PS * static_cast<int>(sizeof(T));  // a warp's rows of P (or dS)
  static constexpr int NPDS = MODE == kOwnQ ? 1 : 2;                  // dS; or P and dS
  static constexpr bool IN_PLANES = S::P == 3;
  static constexpr int rt = S::bytes;
  // bf16: the dk/dv kernel's P and dS over the R scratch, the dq kernel's dS beside it
  static constexpr int CHUNK = IN_PLANES || MODE == kOwnK ? R_BYTES : R_BYTES + PDS;
  static_assert(MODE == kOwnQ || IN_PLANES || 2 * PDS <= R_BYTES, "P and dS fit the R scratch");
  // a slab chunk's operands are split into planes of its own rows only, so
  // that the planes' tail is free while the warps read P/dS from it (fp32)
  static constexpr int SLAB_ROWS = MODE == kOwnQ ? SQ_END : SQK_END;
  static constexpr int PLS = SLAB_ROWS * S::CS;
  static constexpr int pds = IN_PLANES ? S::slots_bytes + 3 * PLS * 2 : rt + (MODE == kOwnQ ? R_BYTES : 0);
  static constexpr int pds_stride = IN_PLANES ? NPDS * PDS : CHUNK;  // bytes from a warp's to the next
  static_assert(!IN_PLANES || 3 * PLS * 2 + NW * NPDS * PDS <= S::planes_bytes,
                "P/dS fit the planes' tail");
  static constexpr int lse = rt + NW * CHUNK;
  static constexpr int delta = lse + 4 * BQ;
  static constexpr int c_hi = delta + 4 * BQ;  // dq kernel: the clipped pairs' ds sums, a query
  static constexpr int c_lo = c_hi + 4 * BQ;
  static constexpr int bytes = c_lo + 4 * BQ;
};

// Rows of Q, g, K, V and (a mixed pair) the window, head-dim columns d0 ..
template <typename T, int MODE>
__device__ __forceinline__ void fetch_logit_chunk(T* slot, const T* qg, const T* gg, const T* kg,
                                                  const T* vg, const T* __restrict__ table, int i0,
                                                  int j0, int Tq, int Tk, int hd, int d0, int base,
                                                  int max_pos, int tid, int copy) {
  using L = BwdLayout<T, MODE>;
  constexpr int DC = L::DC, RST = L::S::RST;
  auto q_row = [=](int r) { return i0 + r < Tq ? i0 + r : -1; };
  auto k_row = [=](int r) { return j0 + r < Tk ? j0 + r : -1; };
  fetch<T, BQ, DC, RST>(slot + L::Q * RST, qg, q_row, hd, d0, hd, tid, copy);
  fetch<T, BQ, DC, RST>(slot + L::G * RST, gg, q_row, hd, d0, hd, tid, copy);
  fetch<T, BK, DC, RST>(slot + L::K * RST, kg, k_row, hd, d0, hd, tid, copy);
  fetch<T, BK, DC, RST>(slot + L::V * RST, vg, k_row, hd, d0, hd, tid, copy);
  if (clip_kind(base, BQ, max_pos) == kMixed) {
    auto e_row = [=](int r) { return window_row(base, r, max_pos); };
    fetch<T, WIN, DC, RST>(slot + L::E * RST, table, e_row, hd, d0, hd, tid, copy);
  }
}

// One chunk of the logits s and dp = g . v^T of the warp's 16 queries against
// the 64 keys of a tile pair, from the staged operands
template <typename T, int MODE>
__device__ __forceinline__ void chunk_logits_bwd(float (*s)[4], float (*dp)[4], const bf16* ops,
                                                 float* rt, int kind, int ksteps, int w, int lane) {
  using L = BwdLayout<T, MODE>;
  constexpr int P = L::S::P, DC = L::DC, CS = L::S::CS, PL = L::S::PLANE;
  chunk_logits<P, DC>(s, ops + L::Q * CS, ops + L::K * CS, ops + L::E * CS, PL, rt, kind, ksteps, w,
                      lane);
  lane = opaque(lane);
  FragA<P> ga[DC / 16];
#pragma unroll
  for (int kd = 0; kd < DC / 16; ++kd) {
    if (kd < ksteps) load_a<P>(ga[kd], ops + L::G * CS, PL, CS, 16 * w, 16 * kd, lane);
  }
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int kd = 0; kd < DC / 16; ++kd) {
      if (kd < ksteps) {
        FragB<P> vb;
        load_b<P>(vb, ops + L::V * CS, PL, CS, 8 * nb, 16 * kd, lane);
        mma(dp[nb], ga[kd], vb);
      }
    }
  }
}

// s becomes p, dp becomes ds; queries at or past Tq and keys at or past
// t_valid weigh 0
__device__ __forceinline__ void weights_and_ds(float (*s)[4], float (*dp)[4], const float* lse_s,
                                               const float* delta_s, int i0, int j0, int Tq,
                                               int t_valid, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float lse_r[2] = {lse_s[16 * w + g], lse_s[16 * w + g + 8]};
  const float delta_r[2] = {delta_s[16 * w + g], delta_s[16 * w + g + 8]};
  const bool row_ok[2] = {i0 + 16 * w + g < Tq, i0 + 16 * w + g + 8 < Tq};
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = j0 + 8 * nb + 2 * t + e < t_valid;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float p = valid && row_ok[rr] ? __expf(s[nb][2 * rr + e] - lse_r[rr]) : 0.f;
        s[nb][2 * rr + e] = p;
        dp[nb][2 * rr + e] = p * (dp[nb][2 * rr + e] - delta_r[rr]);
      }
    }
  }
}

// a warp's 16 x 64 tile of values (accumulator layout) to its rows, PS apart
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, float (*x)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      narrow2(x[nb][2 * rr], x[nb][2 * rr + 1], dst + (g + 8 * rr) * PS + 8 * nb + 2 * t);
    }
  }
}

// *row += the sum of x over the four lanes that share the row (its lane t == 0 adds)
__device__ __forceinline__ void add_row_sum(float* row, float x, int t) {
  x = quad_sum(x);
  if (t == 0) *row += x;
}

// dE[r][d] = the sum, in block order, of the partial rows of the dq kernel's
// blocks that took d's slab (b = slab, slab + slabs, ...: the grid is a whole
// number of slabs)
__global__ void flash_rel_wide_sum_partials(const float* __restrict__ partials,
                                            float* __restrict__ dtable, int blocks, int rows,
                                            int hd, int slab) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(rows) * hd) return;
  const int r = static_cast<int>(e / hd), d = static_cast<int>(e % hd);
  const int slabs = n_slabs(hd, slab), sl = d / slab;
  const size_t per_block = static_cast<size_t>(rows) * slab;
  const float* p = partials + static_cast<size_t>(r) * slab + (d - sl * slab);
  float acc = 0.f;
  for (int b = sl; b < blocks; b += slabs) acc += p[b * per_block];
  dtable[e] = acc;
}

// The block's item loop, shared by the two backward kernels: before item
// `it` is computed, its operands are in (and item it + 1 is on its way).
template <typename T, typename Issue, typename Split>
__device__ __forceinline__ void next_item(int it, int total, Issue issue, Split split) {
  __syncthreads();  // the item before is consumed
  if constexpr (Parts<T>::N == 3) {
    cp_async_wait<0>();
    split(it);  // then the slot takes the next item
    if (it + 1 < total) issue(it + 1);
  } else {
    if (it + 1 < total) {
      issue(it + 1);  // into the other slot
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
  }
  __syncthreads();  // this item's operands are in
}

// The kernel that owns a query tile and a slab of dq's columns: dq, and the
// table's gradient in those columns. Persistent: block b takes the jobs (query
// tile, slab) b, b + grid, ..., all of its slab (the grid is a whole number of
// slabs), and adds the table's gradient into its own rows of `partials`. A
// job's items: for each key tile, the head dim's chunks (the logits), then the
// slab's chunks (dq += dS . K + dR . E_window, and dE_window = dR^T . Q to the
// block's rows).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_bwd_q(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ table, const T* __restrict__ gout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, float* __restrict__ partials, int G, int Tq, int Tk,
                     int hd, int n_qtiles, int slab, int max_pos, int t_valid, int q_offset,
                     int de_writes) {
  using L = BwdLayout<T, kOwnQ>;
  using S = typename L::S;
  constexpr int P = S::P, DC = L::DC, RST = S::RST, CS = S::CS, PL = S::PLANE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  bf16* planes = reinterpret_cast<bf16*>(smem + S::slots_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);
  float* ch_s = reinterpret_cast<float*>(smem + L::c_hi);
  float* cl_s = reinterpret_cast<float*>(smem + L::c_lo);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the warp's scratch: its R (then dR) rows and its dS rows, addressed where used
  auto rt = [=] { return reinterpret_cast<float*>(smem + L::rt + opaque(w) * L::CHUNK); };
  auto dr_w = [=] { return reinterpret_cast<T*>(smem + L::rt + opaque(w) * L::CHUNK); };
  auto ds_w = [=] { return reinterpret_cast<T*>(smem + L::pds + opaque(w) * L::pds_stride); };
  const int slabs = n_slabs(hd, slab);
  // the block's dE rows: its slab's columns of every table row, addressed where used
  const int de_rows = 2 * max_pos + 1;
  auto de = [=] {
    return partials + static_cast<size_t>(opaque(static_cast<int>(blockIdx.x))) * de_rows * slab;
  };
  for (int e = tid; e < de_rows * slab; e += NT) de()[e] = 0.f;
  // the slab's bounds, computed where used (kept live through the item loop
  // they would crowd the accumulators): the block's, the same for every job
  auto s0 = [=] { return opaque(static_cast<int>(blockIdx.x) % slabs) * slab; };
  auto s_end = [=] { return min(hd, s0() + slab); };
  auto nn = [=] { return (s_end() - s0() + 7) / 8; };
  const int copy = copy_bytes<T>(hd);

#pragma unroll 1
  for (int job = blockIdx.x; job < G * n_qtiles * slabs; job += gridDim.x) {
    __syncthreads();  // the job before is done with the shared arrays; the zeroed rows are in
    const int item = job / slabs;
    const int grp = item / n_qtiles;
    const int i0 = (item % n_qtiles) * BQ;
    // the group's rows, computed where used
    auto qg = [=] { return q + static_cast<size_t>(opaque(grp)) * Tq * hd; };
    auto gg = [=] { return gout + static_cast<size_t>(opaque(grp)) * Tq * hd; };
    auto kg = [=] { return k + static_cast<size_t>(opaque(grp)) * Tk * hd; };
    auto vg = [=] { return v + static_cast<size_t>(opaque(grp)) * Tk * hd; };

    if (tid < BQ) {
      const bool ok = i0 + tid < Tq;
      lse_s[tid] = ok ? lse[static_cast<size_t>(grp) * Tq + i0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[static_cast<size_t>(grp) * Tq + i0 + tid] : 0.f;
      ch_s[tid] = cl_s[tid] = 0.f;  // the clipped pairs' ds summed a query, a row a lane with t == 0
    }

    float dq_acc[SLAB_Q / 8][4];  // rows g, g+8; columns s0 + 8n + 2t, +1
#pragma unroll
    for (int n = 0; n < SLAB_Q / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
    float s[BK / 8][4], dp[BK / 8][4];

    const int nc = (hd + DC - 1) / DC;
    const int per_pair = nc + (s_end() - s0() + DC - 1) / DC;
    const int total = (t_valid + BK - 1) / BK * per_pair;
    auto slot_of = [=](int it) { return slots + (S::SLOTS == 2 ? (it & 1) * S::SLOT : 0); };
    auto issue = [=](int it) {
      const int j0 = it / per_pair * BK, sub = it % per_pair;
      const int base = i0 + q_offset - j0 - (BK - 1);
      T* slot = slot_of(it);
      if (sub < nc) {
        fetch_logit_chunk<T, kOwnQ>(slot, qg(), gg(), kg(), vg(), table, i0, j0, Tq, Tk, hd, sub * DC, base,
                                    max_pos, tid, copy);
      } else {
        const int c0 = s0() + (sub - nc) * DC;
        auto q_row = [=](int r) { return i0 + r < Tq ? i0 + r : -1; };
        auto k_row = [=](int r) { return j0 + r < Tk ? j0 + r : -1; };
        fetch<T, BK, DC, RST>(slot + L::SK * RST, kg(), k_row, hd, c0, s_end(), tid, copy);
        if (clip_kind(base, BQ, max_pos) == kMixed) {
          auto e_row = [=](int r) { return window_row(base, r, max_pos); };
          fetch<T, WIN, DC, RST>(slot + L::SE * RST, table, e_row, hd, c0, s_end(), tid, copy);
          fetch<T, BQ, DC, RST>(slot + L::SQ * RST, qg(), q_row, hd, c0, s_end(), tid, copy);
        }
      }
      cp_async_commit();
    };
    auto split = [=](int it) {
      if constexpr (P == 3) {
        const int j0 = it / per_pair * BK, sub = it % per_pair;
        const bool mixed = clip_kind(i0 + q_offset - j0 - (BK - 1), BQ, max_pos) == kMixed;
        const float* slot = reinterpret_cast<const float*>(slot_of(it));
        if (sub < nc) {
          split_rows<L::E, DC, RST, CS>(planes, PL, slot, tid);
          if (mixed) split_rows<WIN, DC, RST, CS>(planes + L::E * CS, PL, slot + L::E * RST, tid);
        } else {
          split_rows<BK, DC, RST, CS>(planes, L::PLS, slot, tid);
          if (mixed) {
            split_rows<WIN + BQ, DC, RST, CS>(planes + L::SE * CS, L::PLS, slot + L::SE * RST, tid);
          }
        }
      }
    };

    issue(0);
#pragma unroll 1
    for (int it = 0; it < total; ++it) {
      const int j0 = it / per_pair * BK, sub = it % per_pair;
      const int base = i0 + q_offset - j0 - (BK - 1);
      const int kind = clip_kind(base, BQ, max_pos);
      next_item<T>(it, total, issue, split);
      const bf16* ops = P == 1 ? reinterpret_cast<const bf16*>(slot_of(it)) : planes;
      const int ln = opaque(lane);

      if (sub < nc) {
        if (sub == 0) {
#pragma unroll
          for (int nb = 0; nb < BK / 8; ++nb) {
            s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
            dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
          }
        }
        const int ksteps = min(DC / 16, (hd - sub * DC + 15) / 16);
        chunk_logits_bwd<T, kOwnQ>(s, dp, ops, rt(), kind, ksteps, w, ln);
        if (sub < nc - 1) continue;
        if (kind != kMixed) {
          float pos_hi[2], pos_lo[2];
          clipped_scalars(pos_hi, pos_lo, qg(), table, i0 + 16 * w, Tq, hd, max_pos, lane);
          add_rows(s, kind == kHigh ? pos_hi[0] : pos_lo[0], kind == kHigh ? pos_hi[1] : pos_lo[1]);
        }
        weights_and_ds(s, dp, lse_s, delta_s, i0, j0, Tq, t_valid, w, lane);
        if (kind == kMixed) {
          __syncwarp();  // every lane has read its R: the chunk is free for dR
          // dR[r][r - b + 63] = ds[r][b]; a pair that is itself clipped goes to its
          // query's sum instead, as in a clipped tile pair (uniform test first)
          const bool some_high = base + BQ + BK - 2 >= max_pos;
          const bool some_low = base <= -max_pos;
          float c_hi[2] = {0.f, 0.f}, c_lo[2] = {0.f, 0.f};  // this lane's share
          // the cells no pair writes are zeroed anew, 16 a row (columns below r and from r + 64)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = lane >> 1, cell = (lane & 1) * 8 + i;
            narrow(0.f, dr_w() + row * DRS + (cell < row ? cell : cell + BK));
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
                narrow(x, dr_w() + (g + 8 * rr) * DRS + c + 8 * rr);
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (some_high) add_row_sum(ch_s + 16 * w + g + 8 * rr, c_hi[rr], t);
            if (some_low) add_row_sum(cl_s + 16 * w + g + 8 * rr, c_lo[rr], t);
          }
        } else {
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int nb = 0; nb < BK / 8; ++nb) {
            sum[0] += dp[nb][0] + dp[nb][1];
            sum[1] += dp[nb][2] + dp[nb][3];
          }
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            add_row_sum((kind == kHigh ? ch_s : cl_s) + 16 * w + g + 8 * rr, sum[rr], t);
          }
        }
        if (!L::IN_PLANES) store_rows(ds_w(), dp, lane);
        continue;
      }

      // a chunk of the slab's columns, c0 ..
      const int c = sub - nc, c0 = s0() + c * DC, c_end = s_end(), n_tiles = nn();
      if (L::IN_PLANES && c == 0) {
        // ds to the warp's rows in the planes' free rows (the logits' chunk lay there)
        store_rows(ds_w(), dp, lane);
        __syncwarp();
      }
      const bf16* ks = ops + L::SK * CS;
      const bf16* es = ops + L::SE * CS;
      const bf16* qs = ops + L::SQ * CS;
#pragma unroll
      for (int cc = 0; cc < SLAB_Q / DC; ++cc) {
        if (cc != c) continue;  // uniform: the accumulators' indices stay static
        // dq += dS . K
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          FragA<P> da;
          load_a_scratch(da, ds_w(), PS, 0, 16 * kk, ln);
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            if (cc * (DC / 8) + n < n_tiles) {
              FragB<P> kb;
              load_b_trans<P>(kb, ks, L::PLS, CS, 8 * n, 16 * kk, ln);
              mma(dq_acc[cc * (DC / 8) + n], da, kb);
            }
          }
        }
        if (kind != kMixed) continue;
        // dq += dR_w . E_window (the warp's own 80 window rows)
#pragma unroll
        for (int kk = 0; kk < RCOLS / 16; ++kk) {
          FragA<P> da;
          load_a_scratch(da, dr_w(), DRS, 0, 16 * kk, ln);
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            if (cc * (DC / 8) + n < n_tiles) {
              FragB<P> eb;
              load_b_trans<P>(eb, es, L::PLS, CS, 8 * n, 16 * w + 16 * kk, ln);
              mma(dq_acc[cc * (DC / 8) + n], da, eb);
            }
          }
        }
      }
      if (kind != kMixed) continue;
      // dE_window = dR^T . Q: window rows 16m .. 16m + 15 meet the queries of
      // warp kk at that warp's dR columns 16(m - kk) ..; warp w owns window
      // blocks w and w + NW
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = w + mi * NW;
        float ea[DC / 8][4];
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) ea[n][0] = ea[n][1] = ea[n][2] = ea[n][3] = 0.f;
#pragma unroll
        for (int back = 0; back < RCOLS / 16; ++back) {
          const int kk = m - back;
          if (kk < 0 || kk >= NW) continue;  // uniform in the warp
          FragA<P> da;
          load_a_scratch_trans(da, reinterpret_cast<const T*>(smem + L::rt + kk * L::CHUNK), DRS,
                               16 * back, 0, ln);
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            FragB<P> qb;
            load_b_trans<P>(qb, qs, L::PLS, CS, 8 * n, 16 * kk, ln);
            mma(ea[n], da, qb);
          }
        }
        if (!de_writes) continue;
        // into the block's rows (width slab, a multiple of 8; columns from s0):
        // plain read-modify-writes, each cell with one owner a tile pair, every
        // cell read first so that no store waits on a read. The window's padding
        // row, and rows clipped to an end of the table (their pairs went to the
        // per-query sums), carry nothing; of a column pair that crosses the
        // head dim's end, the second column is one no sum reads.
        bool live[2];
        float2* cell[2][DC / 8];
        float2 x[2][DC / 8];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int wr = 16 * m + g + 8 * rr;  // window row
          const int dist = base + wr;
          live[rr] = wr < WIN - 1 && dist > -max_pos && dist < max_pos;
          float* row = de() + static_cast<size_t>(dist + max_pos) * slab + (c0 - s0()) + 2 * t;
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            cell[rr][n] = reinterpret_cast<float2*>(row + 8 * n);
            if (live[rr] && c0 + 8 * n + 2 * t < c_end) x[rr][n] = *cell[rr][n];
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int n = 0; n < DC / 8; ++n) {
            if (live[rr] && c0 + 8 * n + 2 * t < c_end) {
              x[rr][n].x += ea[n][2 * rr];
              x[rr][n].y += ea[n][2 * rr + 1];
              *cell[rr][n] = x[rr][n];
            }
          }
        }
      }
    }

    // the clipped pairs' share: dq_a += c_hi[a] E[2 max_pos] + c_lo[a] E[0], and
    // dE[2 max_pos] += sum_a c_hi[a] q_a, dE[0] likewise, in the slab's columns
    __syncwarp();  // the warp's rows' sums are in
    const float ch[2] = {ch_s[16 * w + g], ch_s[16 * w + g + 8]};
    const float cl[2] = {cl_s[16 * w + g], cl_s[16 * w + g + 8]};
    const T* e_hi = table + static_cast<size_t>(2 * max_pos) * hd;
    const int c0 = s0(), c_end = s_end(), n_tiles = nn();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = i0 + 16 * w + g + 8 * rr;
      if (row >= Tq) continue;
      T* o = dq + (static_cast<size_t>(grp) * Tq + row) * hd;
#pragma unroll
      for (int n = 0; n < SLAB_Q / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = c0 + 8 * n + 2 * t + e;
          if (n < n_tiles && d < c_end) {
            narrow(dq_acc[n][2 * rr + e] + ch[rr] * widen(e_hi[d]) + cl[rr] * widen(table[d]), o + d);
          }
        }
      }
    }
    __syncthreads();  // every row's sums are in
    // uniform in the block: skip the rows its distances never reach
    const bool any_hi = i0 + BQ - 1 + q_offset >= max_pos;
    const bool any_lo = i0 + q_offset - (t_valid - 1) <= -max_pos;
    if (de_writes && (any_hi || any_lo)) {
      // each column by one thread, the same one for every job: rows 2 max_pos
      // and 0 of the block's (one row where max_pos is 0)
      const T* qrows = qg();
      float* rows = de();
      for (int d = c0 + tid; d < c_end; d += NT) {
        float hi = 0.f, lo = 0.f;
        for (int a = 0; a < BQ && i0 + a < Tq; ++a) {
          const float x = widen(qrows[static_cast<size_t>(i0 + a) * hd + d]);
          hi = fmaf(ch_s[a], x, hi);
          lo = fmaf(cl_s[a], x, lo);
        }
        if (any_hi) rows[static_cast<size_t>(2 * max_pos) * slab + d - c0] += hi;
        if (any_lo) rows[d - c0] += lo;
      }
    }
  }
}

// The kernel that owns a key tile and a slab of dk's and dv's columns. Items:
// for each query tile, the head dim's chunks (the logits), then the slab's
// chunks (dv += P^T . g, dk += dS^T . Q).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
flash_rel_wide_bwd_k(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ table, const T* __restrict__ gout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int hd, int n_ktiles,
                     int slab, int max_pos, int t_valid, int q_offset) {
  using L = BwdLayout<T, kOwnK>;
  using S = typename L::S;
  constexpr int P = S::P, DC = L::DC, RST = S::RST, CS = S::CS, PL = S::PLANE;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slots = reinterpret_cast<T*>(smem);
  bf16* planes = reinterpret_cast<bf16*>(smem + S::slots_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* rt = reinterpret_cast<float*>(smem + L::rt + w * L::CHUNK);
  auto p_rows = [=](int warp) { return reinterpret_cast<T*>(smem + L::pds + warp * L::pds_stride); };
  auto ds_rows = [=](int warp) { return p_rows(warp) + 16 * PS; };
  const int slabs = n_slabs(hd, slab);
  const int item = blockIdx.x / slabs;
  const int s0 = (blockIdx.x % slabs) * slab;
  const int s_end = min(hd, s0 + slab);
  const int nn = (s_end - s0 + 7) / 8;
  const int grp = item / n_ktiles;
  const int j0 = (item % n_ktiles) * BK;
  const T* qg = q + static_cast<size_t>(grp) * Tq * hd;
  const T* gg = gout + static_cast<size_t>(grp) * Tq * hd;
  const T* kg = k + static_cast<size_t>(grp) * Tk * hd;
  const T* vg = v + static_cast<size_t>(grp) * Tk * hd;
  const float* lg = lse + static_cast<size_t>(grp) * Tq;
  const float* dg = delta + static_cast<size_t>(grp) * Tq;
  const int copy = copy_bytes<T>(hd);

  // keys 16w + g and + 8; columns s0 + 8n + 2t, +1
  float dk_acc[SLAB_K / 8][4], dv_acc[SLAB_K / 8][4];
#pragma unroll
  for (int n = 0; n < SLAB_K / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }
  float s[BK / 8][4], dp[BK / 8][4];

  // a key tile wholly past t_valid only writes its zeros
  const int nc = (hd + DC - 1) / DC;
  const int per_pair = nc + (s_end - s0 + DC - 1) / DC;
  const int total = j0 < t_valid ? (Tq + BQ - 1) / BQ * per_pair : 0;
  auto slot_of = [=](int it) { return slots + (S::SLOTS == 2 ? (it & 1) * S::SLOT : 0); };
  auto issue = [=](int it) {
    const int i0 = it / per_pair * BQ, sub = it % per_pair;
    const int base = i0 + q_offset - j0 - (BK - 1);
    T* slot = slot_of(it);
    if (sub < nc) {
      fetch_logit_chunk<T, kOwnK>(slot, qg, gg, kg, vg, table, i0, j0, Tq, Tk, hd, sub * DC, base,
                                  max_pos, tid, copy);
    } else {
      const int c0 = s0 + (sub - nc) * DC;
      auto q_row = [=](int r) { return i0 + r < Tq ? i0 + r : -1; };
      fetch<T, BQ, DC, RST>(slot + L::SG * RST, gg, q_row, hd, c0, s_end, tid, copy);
      fetch<T, BQ, DC, RST>(slot + L::SQK * RST, qg, q_row, hd, c0, s_end, tid, copy);
    }
    cp_async_commit();
  };
  auto split = [=](int it) {
    if constexpr (P == 3) {
      const int i0 = it / per_pair * BQ, sub = it % per_pair;
      const float* slot = reinterpret_cast<const float*>(slot_of(it));
      if (sub < nc) {
        split_rows<L::E, DC, RST, CS>(planes, PL, slot, tid);
        if (clip_kind(i0 + q_offset - j0 - (BK - 1), BQ, max_pos) == kMixed) {
          split_rows<WIN, DC, RST, CS>(planes + L::E * CS, PL, slot + L::E * RST, tid);
        }
      } else {
        split_rows<2 * BQ, DC, RST, CS>(planes, L::PLS, slot, tid);
      }
    }
  };

  if (total > 0) issue(0);
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    const int i0 = it / per_pair * BQ, sub = it % per_pair;
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, BQ, max_pos);
    next_item<T>(it, total, issue, split);
    const bf16* ops = P == 1 ? reinterpret_cast<const bf16*>(slot_of(it)) : planes;
    const int ln = opaque(lane);

    if (sub < nc) {
      if (sub == 0) {
#pragma unroll
        for (int nb = 0; nb < BK / 8; ++nb) {
          s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
          dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
        }
        // read after this pair's last chunk, behind at least one block sync
        if (tid < BQ) {
          const bool ok = i0 + tid < Tq;
          lse_s[tid] = ok ? lg[i0 + tid] : 0.f;
          delta_s[tid] = ok ? dg[i0 + tid] : 0.f;
        }
      }
      const int ksteps = min(DC / 16, (hd - sub * DC + 15) / 16);
      chunk_logits_bwd<T, kOwnK>(s, dp, ops, rt, kind, ksteps, w, ln);
      if (sub < nc - 1) continue;
      if (kind != kMixed) {
        float pos_hi[2], pos_lo[2];
        clipped_scalars(pos_hi, pos_lo, qg, table, i0 + 16 * w, Tq, hd, max_pos, lane);
        add_rows(s, kind == kHigh ? pos_hi[0] : pos_lo[0], kind == kHigh ? pos_hi[1] : pos_lo[1]);
      }
      weights_and_ds(s, dp, lse_s, delta_s, i0, j0, Tq, t_valid, w, lane);
      continue;
    }

    // dv += P^T . g, dk += dS^T . Q: this warp's 16 keys, a chunk of the slab's columns
    const int c = sub - nc;
    if (c == 0) {
      // P and dS to the warp's rows (with fp32 in the planes' free rows, where the
      // logits' chunk lay), for every warp to read
      __syncwarp();  // every lane has read its R
      store_rows(p_rows(w), s, lane);
      store_rows(ds_rows(w), dp, lane);
      __syncthreads();
    }
    const bf16* gs = ops + L::SG * CS;
    const bf16* qs = ops + L::SQK * CS;
#pragma unroll
    for (int cc = 0; cc < SLAB_K / DC; ++cc) {
      if (cc != c) continue;  // uniform: the accumulators' indices stay static
#pragma unroll
      for (int kk = 0; kk < NW; ++kk) {
        // the queries of warp kk: that warp's rows of P and dS
        FragA<P> pa, da;
        load_a_scratch_trans(pa, p_rows(kk), PS, 16 * w, 0, ln);
        load_a_scratch_trans(da, ds_rows(kk), PS, 16 * w, 0, ln);
#pragma unroll
        for (int n = 0; n < DC / 8; ++n) {
          if (cc * (DC / 8) + n < nn) {
            FragB<P> gb, qb;
            load_b_trans<P>(gb, gs, L::PLS, CS, 8 * n, 16 * kk, ln);
            load_b_trans<P>(qb, qs, L::PLS, CS, 8 * n, 16 * kk, ln);
            mma(dv_acc[cc * (DC / 8) + n], pa, gb);
            mma(dk_acc[cc * (DC / 8) + n], da, qb);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = j0 + 16 * w + g + 8 * rr;
    if (row >= Tk) continue;
    const size_t at = (static_cast<size_t>(grp) * Tk + row) * hd;
#pragma unroll
    for (int n = 0; n < SLAB_K / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = s0 + 8 * n + 2 * t + e;
        if (n < nn && d < s_end) {
          narrow(dk_acc[n][2 * rr + e], dk + at + d);
          narrow(dv_acc[n][2 * rr + e], dv + at + d);
        }
      }
    }
  }
}

// ---- launches ----

// the slab width of kernel `which` (0: the forward, 1: dq, 2: dk and dv); the
// forward's widest slab is 128 up to D 128 (its instantiation then keeps 128
// accumulators a thread, not 256) and SLAB_FWD past it
int slab_of(int hd, int which) {
  return slab_width(hd, which == 0 ? (hd <= 128 ? 128 : SLAB_FWD) : which == 1 ? SLAB_Q : SLAB_K);
}

// the dq kernel writes the table's gradient (off only to time it without those writes)
int g_de_writes = 1;

template <typename K>
int allow(K kernel, int bytes) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// blocks of a grid over `tiles` tiles of each of G groups and the slabs, or -1
long long grid_blocks(int G, int tiles, int hd, int slab) {
  const long long blocks = static_cast<long long>(G) * tiles * n_slabs(hd, slab);
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* table, void* out, void* lse,
               int G, int Tq, int Tk, int hd, int max_pos, int t_valid, int q_offset,
               cudaStream_t s) {
  constexpr int bytes = FwdLayout<T>::bytes;
  auto kernel = hd <= 128 ? flash_rel_wide_fwd<T, 128> : flash_rel_wide_fwd<T, SLAB_FWD>;
  int err = allow(kernel, bytes);
  if (err != 0) return err;
  const int n_qtiles = (Tq + BQ - 1) / BQ, slab = slab_of(hd, 0);
  const long long blocks = grid_blocks(G, n_qtiles, hd, slab);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk, hd,
      n_qtiles, slab, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// The dq kernel's persistent grid at these shapes: as many blocks as the card
// holds at once, rounded down to a whole number of slabs (at least one of
// each), at most one a job. Returns 0 or the CUDA error.
template <typename T>
int q_grid(int G, int Tq, int hd, int* blocks) {
  constexpr int qb = BwdLayout<T, kOwnQ>::bytes;
  auto kernel = flash_rel_wide_bwd_q<T>;
  int err = allow(kernel, qb);
  if (err != 0) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = static_cast<int>(cudaGetDevice(&device))) != 0) return err;
  err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err != 0) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, qb));
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int slab = slab_of(hd, 1), slabs = n_slabs(hd, slab);
  const long long jobs = grid_blocks(G, (Tq + BQ - 1) / BQ, hd, slab);
  if (jobs < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long fit = static_cast<long long>(sms) * per_sm / slabs;
  const long long room = (fit > 0 ? fit : 1) * slabs;
  *blocks = static_cast<int>(jobs < room ? jobs : room);
  return 0;
}

// rows of `partials` ((2*max_pos+1)*hd floats each) that hold the dq
// kernel's `blocks` rows of (2*max_pos+1)*slab floats
long long partial_rows_for(int blocks, int hd) {
  return (static_cast<long long>(blocks) * slab_of(hd, 1) + hd - 1) / hd;
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* table, const void* out,
               const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
               void* dtable, void* partials, int G, int Tq, int Tk, int hd, int max_pos,
               int t_valid, int q_offset, int partial_rows, cudaStream_t s) {
  constexpr int qb = BwdLayout<T, kOwnQ>::bytes, kb = BwdLayout<T, kOwnK>::bytes;
  int q_blocks = 0;
  int err = q_grid<T>(G, Tq, hd, &q_blocks);
  if (err == 0) err = allow(flash_rel_wide_bwd_k<T>, kb);
  if (err != 0) return err;
  if (partial_rows_for(q_blocks, hd) > partial_rows) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(G) * Tq;
  const int n_qtiles = (Tq + BQ - 1) / BQ, n_ktiles = (Tk + BK - 1) / BK;
  const int slab_q = slab_of(hd, 1), slab_k = slab_of(hd, 2);
  const long long k_blocks = grid_blocks(G, n_ktiles, hd, slab_k);
  if (k_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);

  flash_rel_wide_delta<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(gout), static_cast<float*>(delta), rows, hd);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_rel_wide_bwd_q<T><<<static_cast<unsigned>(q_blocks), NT, qb, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<const T*>(gout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<float*>(partials), G, Tq,
      Tk, hd, n_qtiles, slab_q, max_pos, t_valid, q_offset, g_de_writes);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  const long long cells = static_cast<long long>(2 * max_pos + 1) * hd;
  flash_rel_wide_sum_partials<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(dtable), q_blocks, 2 * max_pos + 1,
      hd, slab_q);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_rel_wide_bwd_k<T><<<static_cast<unsigned>(k_blocks), NT, kb, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<const T*>(gout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, hd,
      n_ktiles, slab_k, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, with the names and arguments of
// flash_rel_attention.cu's and flash_rel_attention_bwd.cu's. Each launches on
// `stream` and returns the first CUDA error (0 on success) without
// synchronising; cudaErrorInvalidValue (1) for a head dim below 1.

extern "C" int cmgan_flash_rel_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* out,
    void* lse, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid, int q_offset,
    int is_bf16, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || head_dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, table, out, lse, G, Tq, Tk, head_dim,
                                             max_pos, t_valid, q_offset, s)
                 : launch_fwd<float>(q, k, v, table, out, lse, G, Tq, Tk, head_dim, max_pos,
                                     t_valid, q_offset, s);
}

// `delta` fp32 [G, Tq] and `partials` fp32 [partial_rows, (2*max_pos+1)*head_dim]
// are scratch, none of it zeroed, with partial_rows at least what
// cmgan_flash_rel_attention_bwd_partial_rows gives for these shapes; `dtable`
// fp32 [2*max_pos+1, head_dim] receives the table's gradient.
extern "C" int cmgan_flash_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* table, const void* out,
    const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* dtable, void* partials, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid,
    int q_offset, int is_bf16, int partial_rows, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || head_dim < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, table, out, gout, lse, dq, dk, dv, delta,
                                             dtable, partials, G, Tq, Tk, head_dim, max_pos,
                                             t_valid, q_offset, partial_rows, s)
                 : launch_bwd<float>(q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable,
                                     partials, G, Tq, Tk, head_dim, max_pos, t_valid, q_offset,
                                     partial_rows, s);
}

// Rows of `partials` a backward launch on the current device needs: the dq
// kernel's blocks each write (2*max_pos+1) x (a slab's width) floats. Negative:
// minus a CUDA error.
extern "C" int cmgan_flash_rel_attention_bwd_partial_rows(int is_bf16, int head_dim, int G,
                                                          int Tq, int max_pos) {
  if (G <= 0 || Tq <= 0 || max_pos < 0 || head_dim < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int err = is_bf16 ? q_grid<__nv_bfloat16>(G, Tq, head_dim, &blocks)
                          : q_grid<float>(G, Tq, head_dim, &blocks);
  return err != 0 ? -err : static_cast<int>(partial_rows_for(blocks, head_dim));
}

// Dynamic shared memory, in bytes, of one block of the forward, or -1: the
// same at every head dim.
extern "C" int cmgan_flash_rel_attention_fwd_smem(int is_bf16, int head_dim) {
  if (head_dim < 1) return -1;
  return is_bf16 ? FwdLayout<__nv_bfloat16>::bytes : FwdLayout<float>::bytes;
}

// ... of the backward's kernel `which` (0: dq and the table's gradient, 1: dk
// and dv), or -1.
extern "C" int cmgan_flash_rel_attention_bwd_smem(int is_bf16, int head_dim, int which,
                                                  int max_pos) {
  (void)max_pos;
  if (head_dim < 1 || which < 0 || which > 1) return -1;
  if (which == 0) {
    return is_bf16 ? BwdLayout<__nv_bfloat16, kOwnQ>::bytes : BwdLayout<float, kOwnQ>::bytes;
  }
  return is_bf16 ? BwdLayout<__nv_bfloat16, kOwnK>::bytes : BwdLayout<float, kOwnK>::bytes;
}

// The slab width of kernel `which` (0: the forward, 1: dq, 2: dk and dv) at
// this head dim, or -1; ops/flash_attention.py:plan computes the same.
extern "C" int cmgan_flash_rel_attention_wide_slab(int head_dim, int which) {
  if (head_dim < 1 || which < 0 || which > 2) return -1;
  return slab_of(head_dim, which);
}

// Whether the dq kernel writes the table's gradient into its blocks' rows (1,
// the default) or skips those writes (0: dE is then wrong; for timing their
// share only). Returns the setting before.
extern "C" int cmgan_flash_rel_attention_wide_de_writes(int on) {
  const int before = g_de_writes;
  g_de_writes = on != 0;
  return before;
}
