// Fused attention with Shaw relative positions for heads wider than 64,
// forward, on Hopper's tensor cores (sm_90a).
//
// Replaces, for head dims over 64, the TPU kernel
// cmgan_tpu/ops/flash_attention.py:_flash_kernel (:91), as
// flash_rel_attention.cu does for head dims 16, 32 and 64. The function, the
// arguments, the masks (t_valid, q_offset) and the fp32 row log-sum-exp are
// its:
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// This library exports the same C entries as that one, under the same names,
// for any positive head dim; the wrapper (ops/flash_attention.py) sends it the
// heads wider than 64. Their backward is flash_rel_attention_wide_bwd.cu.
//
// What bounds it on an H100 SXM (700 W part): its products. At G 404, T 641,
// D 128 the forward needs 1.3e11 FLOP: 0.13 ms at the 989 TFLOP/s of the bf16
// tensor cores. The fp32 route below runs six bf16 products for each, so its
// bound is six times that. The bytes (inputs read once, outputs written once)
// take a tenth of it.
//
// The design. Every product runs on the tensor cores as mma.sync.m16n8k16
// tiles with fp32 accumulators (flash_rel_common.cuh): a bf16 input is one
// operand; an fp32 input is carried as three bf16 parts, and each product as
// the six part products whose terms reach 2^-24 of the result, summed
// smallest first outside the truncating accumulator (TF32 stood 2e-3 from
// float64 and misses the 1e-4 limit). What differs from the D <= 64 kernel
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
// - A block owns a tile of 64 queries and one slab of output columns; the
//   grid's fastest index walks the slabs. Each slab block computes the logits
//   over the whole head dim and accumulates the output for its slab only, in
//   registers: slabs of at most 128 columns up to D 128, 256 past it, equal
//   widths rounded up to 8. Past one slab the logits are recomputed once a
//   slab, so no D is too wide.
// - The position term goes through the skew of kernel #1: a warp's 16
//   queries meet window rows 16w .. 16w + 78; R = Q_w . E_window^T is added
//   chunk by chunk through a per-warp scratch to the logits at R[r][r - b +
//   63]. A tile pair whose every distance is clipped stages no window: its
//   position logit is q_a . E[2 max_pos] or q_a . E[0].
//
// Softmax in fp32; the output is written in the input type. What this
// version leaves: the logits recomputed per slab past D 128, one item in
// flight (two block syncs an item), mma.sync where wgmma would take fewer
// instructions, the skew's round trip through shared memory once a chunk.

#include "flash_rel_common.cuh"

namespace {

using namespace flash_rel;

constexpr int NW = 4;            // warps a block
constexpr int NT = 32 * NW;
constexpr int BQ = 16 * NW;      // queries a tile (keys: BK = 64)
constexpr int WIN = BQ + BK;     // window rows staged (WIN - 1 used)
constexpr int SLAB_FWD = 256;    // widest slab of output columns (128 up to D 128)
constexpr int VH = 64;           // columns of V a forward item stages (half the widest slab)

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

// ---- launches ----

// the forward's slab width: its widest slab is 128 up to D 128 (its
// instantiation then keeps 128 accumulators a thread, not 256) and SLAB_FWD
// past it
int slab_of(int hd) { return slab_width(hd, hd <= 128 ? 128 : SLAB_FWD); }

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
  const int n_qtiles = (Tq + BQ - 1) / BQ, slab = slab_of(hd);
  const long long blocks = grid_blocks(G, n_qtiles, hd, slab);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk, hd,
      n_qtiles, slab, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, with the names and arguments of
// flash_rel_attention.cu's. Each launches on `stream` and returns the first
// CUDA error (0 on success) without synchronising; cudaErrorInvalidValue (1)
// for a head dim below 1.

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

// Dynamic shared memory, in bytes, of one block of the forward, or -1: the
// same at every head dim.
extern "C" int cmgan_flash_rel_attention_fwd_smem(int is_bf16, int head_dim) {
  if (head_dim < 1) return -1;
  return is_bf16 ? FwdLayout<__nv_bfloat16>::bytes : FwdLayout<float>::bytes;
}

// The forward's slab width at this head dim (which 0), or -1;
// ops/flash_attention.py:plan computes the same.
extern "C" int cmgan_flash_rel_attention_wide_slab(int head_dim, int which) {
  if (head_dim < 1 || which != 0) return -1;
  return slab_of(head_dim);
}
