// Fused attention with Shaw relative positions for heads wider than 64,
// forward and backward, for Hopper (sm_90a).
//
// Replaces, for head dims 65 to 256, the TPU kernels
// cmgan_tpu/ops/flash_attention.py:_flash_kernel (forward) and
// :_flash_bwd_kernel (backward), as flash_rel_attention.cu and
// flash_rel_attention_bwd.cu do for head dims 16, 32 and 64. The function,
// the arguments, the masks (t_valid, q_offset) and the fp32 row
// log-sum-exp are theirs:
//
//   out[g,i] = sum_j softmax_j( q.k_j + q.E[clip(i + q_offset - j, +-max_pos) + max_pos] ) v_j
//
// and its gradients dq, dk, dv, dE. This library exports the same C entries
// as those two, under the same names, for any head dim from 1 to 256; the
// wrapper (ops/flash_attention.py) sends it the heads wider than 64.
//
// Why a kernel of its own. Those kernels keep a warp's share of every head
// dim in registers and stage fp32 tiles as three bf16 planes. At a head dim
// of 128 the forward's fp32 tiles need 234,496 B of shared memory and the
// backward's more than 300 KB, over the 232,448 B a block may have, and fp32
// already spills registers at 64. Here nothing scales with the head dim but
// one accumulator:
//
// - The head dim is walked in chunks of DC = 32 columns, staged in turn into
//   shared memory as fp32 (bf16 inputs are widened there). A column at or
//   past the head dim is staged as zero, which adds nothing to a product, so
//   any width is exact without padding in device memory.
// - The logits of a tile pair (64 queries, 64 keys) are summed over the
//   chunks in registers: 256 threads, a 4 x 4 block of logits each. The
//   position term is read through the skew of flash_rel_common.cuh, straight
//   from the staged window: query a meets key b at window row a - b + 63, so
//   a thread's 16 pairs need 7 window rows a column. A tile pair whose every
//   distance is clipped stages no window: its position logit is q_a . E[0]
//   or q_a . E[2 max_pos], one scalar a query.
// - The [64, D] fp32 accumulators (the output; dq; dk and dv) live in
//   shared memory, each cell owned by one thread: 64 KB at D 256.
// - The backward keeps the two-kernel form of flash_rel_attention_bwd.cu:
//   one kernel owns a query tile (dq and the table's gradient), the other a
//   key tile (dk and dv). ds is written skewed, dR[c][a] = ds[a][a - c + 63],
//   so that dq's position part (dR . E_window) and the window's gradient
//   (dR^T . Q) are plain products; the window's gradient goes to dE in
//   device memory by global atomics, added in an order that varies from run
//   to run.
//
// Every product is a scalar fp32 FMA, so fp32 inputs keep fp32 accuracy;
// softmax in fp32; outputs and gradients are written in the input type.
//
// What bounds it on an H100 SXM (700 W part): the function is bound by its
// products (at G 404, T 641, D 128: 1.3e11 FLOP forward), which the tensor
// cores would run at 989 TFLOP/s in bf16. These kernels run them on the
// fp32 units (67 TFLOP/s at most) from shared memory, a 16-byte load for
// every four FMAs: far from the bound. Tensor-core tiles and cp.async/TMA
// staging are later work.

#include "flash_rel_common.cuh"

namespace {

using namespace flash_rel;

constexpr int WQ = 64;          // queries a tile (keys: BK = 64)
constexpr int DC = 32;          // head-dim columns a chunk
constexpr int NTH = 256;        // threads a block: 16 x 16, a 4 x 4 block of logits each
constexpr int WROWS = WQ + BK;  // window rows staged for (WQ + BK - 1 used)
constexpr int TLD = WQ + 4;     // floats a row of a transposed chunk [DC][TLD]
constexpr int ELD = WROWS + 4;  // floats a row of a transposed window chunk [DC][ELD]
constexpr int RLD = DC + 4;     // floats a row of a row-major chunk [rows][RLD]
constexpr int MAX_HD = 256;

__host__ __device__ constexpr int n_chunks(int hd) { return (hd + DC - 1) / DC; }
// floats a row of a [64, head dim] accumulator in shared memory
__host__ __device__ constexpr int acc_ld(int hd) { return n_chunks(hd) * DC + 4; }

__device__ __forceinline__ int window_row(int base, int r, int max_pos) {
  return min(max(base + r, -max_pos), max_pos) + max_pos;
}

// ---- staging: one chunk of DC columns, from column d0 of rows hd wide ----

// Rows row0 .. row0 + nrows - 1, columns d0 .. d0 + DC - 1 of src ([limit, hd]),
// transposed (dst[c * TLD + r]) or row-major (dst[r * RLD + c]); zero for rows
// at or past `limit` and for columns at or past hd
template <typename T, bool TRANSPOSED>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int row0, int nrows,
                                      int limit, int hd, int d0) {
  for (int e = threadIdx.x; e < nrows * DC; e += NTH) {
    const int r = e / DC, c = e % DC;
    float x = 0.f;
    if (row0 + r < limit && d0 + c < hd) x = widen(src[static_cast<size_t>(row0 + r) * hd + d0 + c]);
    dst[TRANSPOSED ? c * TLD + r : r * RLD + c] = x;
  }
}

// window row r (r < WROWS - 1) is E[clip(base + r, +-max_pos) + max_pos];
// transposed (dst[c * ELD + r]) or row-major (dst[r * RLD + c])
template <typename T, bool TRANSPOSED>
__device__ __forceinline__ void stage_window(float* dst, const T* __restrict__ table, int base,
                                             int max_pos, int hd, int d0) {
  for (int e = threadIdx.x; e < (WROWS - 1) * DC; e += NTH) {
    const int r = e / DC, c = e % DC;
    const float x = d0 + c < hd ? widen(table[window_row(base, r, max_pos) * hd + d0 + c]) : 0.f;
    dst[TRANSPOSED ? c * ELD + r : r * RLD + c] = x;
  }
}

// ---- products over one staged chunk ----

__device__ __forceinline__ void unpack4(float4 v, float* f) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// s[i][j] += sum over the chunk of a[d][4ty + i] * b[d][4tx + j]
__device__ __forceinline__ void chunk_product(float (&s)[4][4], const float* a, const float* b,
                                              int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float x[4], y[4];
    unpack4(*reinterpret_cast<const float4*>(a + d * TLD + 4 * ty), x);
    unpack4(*reinterpret_cast<const float4*>(b + d * TLD + 4 * tx), y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
  }
}

// the position logits of a mixed tile pair: query 4ty + i meets key 4tx + j
// at window row 4(ty - tx) + 63 + i - j, so s[i][j] += sum over the chunk of
// a[d][4ty + i] * e[d][4(ty - tx) + 60 + (i - j + 3)]
__device__ __forceinline__ void chunk_skew_product(float (&s)[4][4], const float* a, const float* e,
                                                   int ty, int tx) {
  const int c0 = 4 * (ty - tx) + 60;  // 0 .. 120, a multiple of 4
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float x[4], w[8];
    unpack4(*reinterpret_cast<const float4*>(a + d * TLD + 4 * ty), x);
    unpack4(*reinterpret_cast<const float4*>(e + d * ELD + c0), w);
    unpack4(*reinterpret_cast<const float4*>(e + d * ELD + c0 + 4), w + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], w[i - j + 3], s[i][j]);
    }
  }
}

// a clipped tile pair's position logit: p[i] += sum over the chunk of
// a[d][4ty + i] * erow[d], erow the chunk of the table's end row
__device__ __forceinline__ void chunk_row_product(float (&p)[4], const float* a, const float* erow,
                                                  int ty) {
#pragma unroll 4
  for (int d = 0; d < DC; ++d) {
    float x[4];
    unpack4(*reinterpret_cast<const float4*>(a + d * TLD + 4 * ty), x);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = fmaf(x[i], erow[d], p[i]);
  }
}

// acc[i][j] += sum over k < depth of a[k][4ty + i] * b[k][2tx + j]: a transposed
// [depth][LDA] (P, dS or dR), b row-major [depth][RLD] (a chunk of V, K, g, Q or
// the window)
template <int LDA = TLD>
__device__ __forceinline__ void chunk_accumulate(float (&acc)[4][2], const float* a, const float* b,
                                                 int depth, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    float x[4];
    unpack4(*reinterpret_cast<const float4*>(a + k * LDA + 4 * ty), x);
    const float2 y = *reinterpret_cast<const float2*>(b + k * RLD + 2 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(x[i], y.x, acc[i][0]);
      acc[i][1] = fmaf(x[i], y.y, acc[i][1]);
    }
  }
}

// max and sum over the 16 lanes that hold one row of a tile's logits
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The logits s (and, with G, dp = g . v) of the tile pair (queries i0.., keys
// j0..), summed over the head dim's chunks. Staging: qt, kt (and gt, vt)
// [DC][TLD], et [DC][ELD], erow [DC]. `first` runs once between the first
// chunk's two syncs (the tiles of the pair before are consumed by then).
template <typename T, bool G, typename F>
__device__ __forceinline__ void pair_logits(float (&s)[4][4], float (&dp)[4][4], float* qt, float* kt,
                                            float* gt, float* vt, float* et, float* erow,
                                            const T* qg, const T* kg, const T* gg, const T* vg,
                                            const T* __restrict__ table, int i0, int j0, int Tq,
                                            int Tk, int hd, int base, int kind, int max_pos,
                                            F first) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float pc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  }
  const int end_row = kind == kHigh ? 2 * max_pos : 0;
  for (int c = 0; c < n_chunks(hd); ++c) {
    const int d0 = c * DC;
    __syncthreads();  // the chunk before is consumed
    stage<T, true>(qt, qg, i0, WQ, Tq, hd, d0);
    stage<T, true>(kt, kg, j0, BK, Tk, hd, d0);
    if (G) {
      stage<T, true>(gt, gg, i0, WQ, Tq, hd, d0);
      stage<T, true>(vt, vg, j0, BK, Tk, hd, d0);
    }
    if (kind == kMixed) {
      stage_window<T, true>(et, table, base, max_pos, hd, d0);
    } else if (tid < DC) {
      erow[tid] = d0 + tid < hd ? widen(table[end_row * hd + d0 + tid]) : 0.f;
    }
    if (c == 0) first();
    __syncthreads();
    chunk_product(s, qt, kt, ty, tx);
    if (G) chunk_product(dp, gt, vt, ty, tx);
    if (kind == kMixed) {
      chunk_skew_product(s, qt, et, ty, tx);
    } else {
      chunk_row_product(pc, qt, erow, ty);
    }
  }
  if (kind != kMixed) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += pc[i];
    }
  }
}

// ---- forward ----

template <typename T>
__global__ void __launch_bounds__(NTH)
flash_rel_wide_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ table, T* __restrict__ out, float* __restrict__ lse,
                   int Tq, int Tk, int hd, int n_qtiles, int max_pos, int t_valid, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);  // [DC][TLD]
  float* kt = qt + DC * TLD;                   // [DC][TLD]
  float* et = kt + DC * TLD;                   // [DC][ELD]
  float* vs = qt;                              // [BK][RLD], over qt and kt once the logits are done
  float* pt = et;                              // [BK][WQ]: the weights, pt[b][a], over et
  float* erow = et + DC * ELD;                 // [DC]
  float* o = erow + DC;                        // [WQ][acc_ld(hd)]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.x / n_qtiles;
  const int i0 = (blockIdx.x % n_qtiles) * WQ;
  const int ald = acc_ld(hd);
  const T* qg = q + static_cast<size_t>(grp) * Tq * hd;
  const T* kg = k + static_cast<size_t>(grp) * Tk * hd;
  const T* vg = v + static_cast<size_t>(grp) * Tk * hd;

  for (int e = tid; e < WQ * ald; e += NTH) o[e] = 0.f;
  float m[4], l[4];  // rows 4ty + i, whole-row values in every lane of the row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  for (int j0 = 0; j0 < t_valid; j0 += BK) {
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, WQ, max_pos);
    float s[4][4], unused[4][4];
    pair_logits<T, false>(s, unused, qt, kt, nullptr, nullptr, et, erow, qg, kg,
                          static_cast<const T*>(nullptr), static_cast<const T*>(nullptr), table,
                          i0, j0, Tq, Tk, hd, base, kind, max_pos, [] {});

    const int nk = t_valid - j0;  // keys at or past nk are masked
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * tx + j >= nk) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));  // finite: key j0 is valid
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr[i] + row_sum16(sum);
      m[i] = m_new;
    }
    __syncthreads();  // qt, kt and et are consumed: V's chunks and the weights lie over them
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * WQ + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    // O = O * corr + P . V, a chunk of V at a time
    for (int c = 0; c < n_chunks(hd); ++c) {
      const int d0 = c * DC;
      if (c > 0) __syncthreads();  // the chunk of V before is consumed
      stage<T, false>(vs, vg, j0, BK, Tk, hd, d0);
      __syncthreads();  // and the weights are written
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      chunk_accumulate<WQ>(acc, pt, vs, BK, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2* cell = reinterpret_cast<float2*>(o + (4 * ty + i) * ald + d0 + 2 * tx);
        float2 y = *cell;
        y.x = y.x * corr[i] + acc[i][0];
        y.y = y.y * corr[i] + acc[i][1];
        *cell = y;
      }
    }
  }

  // each thread writes the cells it owns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + 4 * ty + i;
    if (row >= Tq) continue;
    const float inv = 1.f / l[i];
    T* orow = out + (static_cast<size_t>(grp) * Tq + row) * hd;
    for (int c = 0; c < n_chunks(hd); ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = c * DC + 2 * tx + j;
        if (d < hd) narrow(o[(4 * ty + i) * ald + d] * inv, orow + d);
      }
    }
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(grp) * Tq + row] = m[i] + logf(l[i]);
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

// p and ds of a tile pair from its logits s and dp = g . v (in place: s becomes
// p, dp becomes ds); queries at or past Tq and keys at or past t_valid weigh 0
__device__ __forceinline__ void weights_and_ds(float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
                                               const float* delta_s, int i0, int j0, int Tq,
                                               int t_valid, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = i0 + 4 * ty + i < Tq;
    const float lse_r = lse_s[4 * ty + i], delta_r = delta_s[4 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = row_ok && j0 + 4 * tx + j < t_valid ? expf(s[i][j] - lse_r) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_r);
    }
  }
}

// Shared memory of the two backward kernels, in floats: the head-dim chunks of
// the logits phase, the chunks of the accumulation phase over them, then the
// kernel's own arrays.
constexpr int LOGIT_TILES = 4 * DC * TLD + DC * ELD;  // qt kt gt vt, et

// The kernel that owns a query tile: dq, and the table's gradient.
template <typename T>
__global__ void __launch_bounds__(NTH)
flash_rel_wide_bwd_q(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ table, const T* __restrict__ gout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, float* __restrict__ dtable, int Tq, int Tk, int hd,
                     int n_qtiles, int max_pos, int t_valid, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);
  float* kt = qt + DC * TLD;
  float* gt = kt + DC * TLD;
  float* vt = gt + DC * TLD;
  float* et = vt + DC * TLD;
  float* ks = qt;                     // [BK][RLD]    over the logits' chunks
  float* ew = ks + BK * RLD;          // [WROWS][RLD]
  float* qs = ew + WROWS * RLD;       // [WQ][RLD]
  float* erow = qt + LOGIT_TILES;     // [DC]
  float* dst = erow + DC;             // [BK][TLD]: ds transposed, dst[b][a]
  float* drt = dst + BK * TLD;        // [WROWS][TLD]: dR transposed, drt[c][a] = ds[a][a - c + 63]
  float* dqa = drt + WROWS * TLD;     // [WQ][acc_ld(hd)]
  float* lse_s = dqa + WQ * acc_ld(hd);
  float* delta_s = lse_s + WQ;
  float* c_hi = delta_s + WQ;         // ds summed over the pairs clipped to row 2 max_pos, a query
  float* c_lo = c_hi + WQ;            // ... to row 0

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.x / n_qtiles;
  const int i0 = (blockIdx.x % n_qtiles) * WQ;
  const int ald = acc_ld(hd);
  const T* qg = q + static_cast<size_t>(grp) * Tq * hd;
  const T* gg = gout + static_cast<size_t>(grp) * Tq * hd;
  const T* kg = k + static_cast<size_t>(grp) * Tk * hd;
  const T* vg = v + static_cast<size_t>(grp) * Tk * hd;

  for (int e = tid; e < WQ * ald; e += NTH) dqa[e] = 0.f;
  if (tid < WQ) {
    const bool ok = i0 + tid < Tq;
    lse_s[tid] = ok ? lse[static_cast<size_t>(grp) * Tq + i0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[static_cast<size_t>(grp) * Tq + i0 + tid] : 0.f;
    c_hi[tid] = c_lo[tid] = 0.f;
  }
  bool any_hi = false, any_lo = false;  // uniform in the block

  for (int j0 = 0; j0 < t_valid; j0 += BK) {
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, WQ, max_pos);
    float s[4][4], ds[4][4];
    pair_logits<T, true>(s, ds, qt, kt, gt, vt, et, erow, qg, kg, gg, vg, table, i0, j0, Tq, Tk, hd,
                         base, kind, max_pos, [&] {
                           if (kind == kMixed) {  // dR's cells that no pair writes stay zero
                             for (int e = tid; e < WROWS * TLD; e += NTH) drt[e] = 0.f;
                           }
                         });
    weights_and_ds(s, ds, lse_s, delta_s, i0, j0, Tq, t_valid, ty, tx);
    if (kind != kMixed) {
      // every pair of the tile is clipped to one end row of the table
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sum = row_sum16(ds[i][0] + ds[i][1] + ds[i][2] + ds[i][3]);
        if (tx == 0) (kind == kHigh ? c_hi : c_lo)[4 * ty + i] += sum;
      }
      any_hi |= kind == kHigh;
      any_lo |= kind == kLow;
    }
    __syncthreads();  // the logits' chunks are consumed: the accumulation's lie over them
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(dst + (4 * tx + j) * TLD + 4 * ty) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    }
    if (kind == kMixed) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) drt[(4 * (ty - tx) + 63 + i - j) * TLD + 4 * ty + i] = ds[i][j];
      }
    }
    for (int c = 0; c < n_chunks(hd); ++c) {
      const int d0 = c * DC;
      if (c > 0) __syncthreads();  // the chunks before are consumed
      stage<T, false>(ks, kg, j0, BK, Tk, hd, d0);
      if (kind == kMixed) {
        stage_window<T, false>(ew, table, base, max_pos, hd, d0);
        stage<T, false>(qs, qg, i0, WQ, Tq, hd, d0);
      }
      __syncthreads();  // and ds, dR are written
      // dq += dS . K (+ dR . E_window)
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      chunk_accumulate(acc, dst, ks, BK, ty, tx);
      if (kind == kMixed) chunk_accumulate(acc, drt, ew, WROWS - 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2* cell = reinterpret_cast<float2*>(dqa + (4 * ty + i) * ald + d0 + 2 * tx);
        float2 y = *cell;
        y.x += acc[i][0];
        y.y += acc[i][1];
        *cell = y;
      }
      if (kind == kMixed) {
        // dE_window = dR^T . Q: window rows ty + 16u, columns 2tx, 2tx + 1
        float e[8][2];
#pragma unroll
        for (int u = 0; u < 8; ++u) e[u][0] = e[u][1] = 0.f;
        for (int a = 0; a < WQ; a += 4) {
          float2 qv[4];
#pragma unroll
          for (int w = 0; w < 4; ++w) qv[w] = *reinterpret_cast<const float2*>(qs + (a + w) * RLD + 2 * tx);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int r = ty + 16 * u;
            if (r >= WROWS - 1) continue;
            float x[4];
            unpack4(*reinterpret_cast<const float4*>(drt + r * TLD + a), x);
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              e[u][0] = fmaf(x[w], qv[w].x, e[u][0]);
              e[u][1] = fmaf(x[w], qv[w].y, e[u][1]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = ty + 16 * u;
          if (r >= WROWS - 1) continue;
          float* row = dtable + window_row(base, r, max_pos) * hd;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int d = d0 + 2 * tx + j;
            if (d < hd) atomicAdd(row + d, e[u][j]);
          }
        }
      }
    }
  }

  __syncthreads();  // the clipped pairs' sums of every row are in
  // the clipped pairs' share: dq_a += c_hi[a] E[2 max_pos] + c_lo[a] E[0], and
  // dE[2 max_pos] += sum_a c_hi[a] q_a, dE[0] likewise
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = 4 * ty + i, row = i0 + a;
    if (row >= Tq) continue;
    T* drow = dq + (static_cast<size_t>(grp) * Tq + row) * hd;
    for (int c = 0; c < n_chunks(hd); ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = c * DC + 2 * tx + j;
        if (d >= hd) continue;
        const float x = dqa[a * ald + d] + c_hi[a] * widen(table[2 * max_pos * hd + d]) +
                        c_lo[a] * widen(table[d]);
        narrow(x, drow + d);
      }
    }
  }
  if (any_hi || any_lo) {
    for (int d = tid; d < hd; d += NTH) {
      float hi = 0.f, lo = 0.f;
      for (int a = 0; a < WQ && i0 + a < Tq; ++a) {
        const float x = widen(qg[static_cast<size_t>(i0 + a) * hd + d]);
        hi = fmaf(c_hi[a], x, hi);
        lo = fmaf(c_lo[a], x, lo);
      }
      if (any_hi) atomicAdd(dtable + 2 * max_pos * hd + d, hi);
      if (any_lo) atomicAdd(dtable + d, lo);
    }
  }
}

// The kernel that owns a key tile: dk and dv.
template <typename T>
__global__ void __launch_bounds__(NTH)
flash_rel_wide_bwd_k(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ table, const T* __restrict__ gout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int hd, int n_ktiles,
                     int max_pos, int t_valid, int q_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qt = reinterpret_cast<float*>(smem);
  float* kt = qt + DC * TLD;
  float* gt = kt + DC * TLD;
  float* vt = gt + DC * TLD;
  float* et = vt + DC * TLD;
  float* gs = qt;                    // [WQ][RLD]  over the logits' chunks
  float* qs = gs + WQ * RLD;         // [WQ][RLD]
  float* erow = qt + LOGIT_TILES;    // [DC]
  float* pa = erow + DC;             // [WQ][TLD]: the weights, pa[a][b]
  float* dsa = pa + WQ * TLD;        // [WQ][TLD]: ds, dsa[a][b]
  float* dka = dsa + WQ * TLD;       // [BK][acc_ld(hd)]
  float* dva = dka + BK * acc_ld(hd);
  float* lse_s = dva + BK * acc_ld(hd);
  float* delta_s = lse_s + WQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = blockIdx.x / n_ktiles;
  const int j0 = (blockIdx.x % n_ktiles) * BK;
  const int ald = acc_ld(hd);
  const T* qg = q + static_cast<size_t>(grp) * Tq * hd;
  const T* gg = gout + static_cast<size_t>(grp) * Tq * hd;
  const T* kg = k + static_cast<size_t>(grp) * Tk * hd;
  const T* vg = v + static_cast<size_t>(grp) * Tk * hd;
  const float* lg = lse + static_cast<size_t>(grp) * Tq;
  const float* dg = delta + static_cast<size_t>(grp) * Tq;

  for (int e = tid; e < BK * ald; e += NTH) dka[e] = dva[e] = 0.f;

  // a key tile wholly past t_valid only writes its zeros
  const int n_inner = j0 < t_valid ? (Tq + WQ - 1) / WQ : 0;
  for (int it = 0; it < n_inner; ++it) {
    const int i0 = it * WQ;
    const int base = i0 + q_offset - j0 - (BK - 1);
    const int kind = clip_kind(base, WQ, max_pos);
    float s[4][4], ds[4][4];
    pair_logits<T, true>(s, ds, qt, kt, gt, vt, et, erow, qg, kg, gg, vg, table, i0, j0, Tq, Tk, hd,
                         base, kind, max_pos, [&] {
                           if (tid < WQ) {
                             const bool ok = i0 + tid < Tq;
                             lse_s[tid] = ok ? lg[i0 + tid] : 0.f;
                             delta_s[tid] = ok ? dg[i0 + tid] : 0.f;
                           }
                         });
    weights_and_ds(s, ds, lse_s, delta_s, i0, j0, Tq, t_valid, ty, tx);
    __syncthreads();  // the logits' chunks are consumed: the accumulation's lie over them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(pa + (4 * ty + i) * TLD + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      *reinterpret_cast<float4*>(dsa + (4 * ty + i) * TLD + 4 * tx) =
          make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    // dv += P^T . g, dk += dS^T . Q: keys 4ty + i, columns 2tx, 2tx + 1 of a chunk
    for (int c = 0; c < n_chunks(hd); ++c) {
      const int d0 = c * DC;
      if (c > 0) __syncthreads();  // the chunks before are consumed
      stage<T, false>(gs, gg, i0, WQ, Tq, hd, d0);
      stage<T, false>(qs, qg, i0, WQ, Tq, hd, d0);
      __syncthreads();  // and P, dS are written
      float av[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      float ak[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      chunk_accumulate(av, pa, gs, WQ, ty, tx);
      chunk_accumulate(ak, dsa, qs, WQ, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2* cv = reinterpret_cast<float2*>(dva + (4 * ty + i) * ald + d0 + 2 * tx);
        float2* ck = reinterpret_cast<float2*>(dka + (4 * ty + i) * ald + d0 + 2 * tx);
        float2 y = *cv, z = *ck;
        y.x += av[i][0];
        y.y += av[i][1];
        z.x += ak[i][0];
        z.y += ak[i][1];
        *cv = y;
        *ck = z;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = 4 * ty + i, row = j0 + b;
    if (row >= Tk) continue;
    const size_t at = (static_cast<size_t>(grp) * Tk + row) * hd;
    for (int c = 0; c < n_chunks(hd); ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = c * DC + 2 * tx + j;
        if (d >= hd) continue;
        narrow(dka[b * ald + d], dk + at + d);
        narrow(dva[b * ald + d], dv + at + d);
      }
    }
  }
}

// ---- launches ----

int fwd_bytes(int hd) { return 4 * (2 * DC * TLD + DC * ELD + DC + WQ * acc_ld(hd)); }
int bwd_q_bytes(int hd) {
  return 4 * (LOGIT_TILES + DC + BK * TLD + WROWS * TLD + WQ * acc_ld(hd) + 4 * WQ);
}
int bwd_k_bytes(int hd) {
  return 4 * (LOGIT_TILES + DC + 2 * WQ * TLD + 2 * BK * acc_ld(hd) + 2 * WQ);
}
static_assert(BK * RLD + WROWS * RLD + WQ * RLD <= LOGIT_TILES, "the dq kernel's chunks fit");
static_assert(BK * RLD <= 2 * DC * TLD, "the forward's chunk of V fits over qt and kt");
static_assert(BK * WQ <= DC * ELD, "the forward's weights fit over the window chunk");
static_assert(2 * WQ * RLD <= LOGIT_TILES, "the dk/dv kernel's chunks fit");

bool head_dim_ok(int hd) { return hd >= 1 && hd <= MAX_HD; }

template <typename K>
int allow(K kernel, int bytes) {
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* table, void* out, void* lse,
               int G, int Tq, int Tk, int hd, int max_pos, int t_valid, int q_offset,
               cudaStream_t s) {
  const int bytes = fwd_bytes(hd);
  int err = allow(flash_rel_wide_fwd<T>, bytes);
  if (err != 0) return err;
  const int n_qtiles = (Tq + WQ - 1) / WQ;
  const long long blocks = static_cast<long long>(G) * n_qtiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_rel_wide_fwd<T><<<static_cast<unsigned>(blocks), NTH, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk, hd,
      n_qtiles, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* table, const void* out,
               const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
               void* dtable, int G, int Tq, int Tk, int hd, int max_pos, int t_valid,
               int q_offset, cudaStream_t s) {
  const int qb = bwd_q_bytes(hd), kb = bwd_k_bytes(hd);
  int err = allow(flash_rel_wide_bwd_q<T>, qb);
  if (err == 0) err = allow(flash_rel_wide_bwd_k<T>, kb);
  if (err != 0) return err;
  const long long rows = static_cast<long long>(G) * Tq;
  const int n_qtiles = (Tq + WQ - 1) / WQ, n_ktiles = (Tk + BK - 1) / BK;
  const long long q_blocks = static_cast<long long>(G) * n_qtiles;
  const long long k_blocks = static_cast<long long>(G) * n_ktiles;
  if (q_blocks > 0x7fffffffLL || k_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  flash_rel_wide_delta<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(gout), static_cast<float*>(delta), rows, hd);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  // the table's gradient arrives by atomics: zeroed first, on the same stream
  err = static_cast<int>(cudaMemsetAsync(dtable, 0, sizeof(float) * (2 * max_pos + 1) * hd, s));
  if (err != 0) return err;
  flash_rel_wide_bwd_q<T><<<static_cast<unsigned>(q_blocks), NTH, qb, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<const T*>(gout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<float*>(dtable), Tq, Tk,
      hd, n_qtiles, max_pos, t_valid, q_offset);
  if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  flash_rel_wide_bwd_k<T><<<static_cast<unsigned>(k_blocks), NTH, kb, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(table), static_cast<const T*>(gout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, hd,
      n_ktiles, max_pos, t_valid, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries for ctypes, with the names and arguments of
// flash_rel_attention.cu's and flash_rel_attention_bwd.cu's. Each launches on
// `stream` and returns the first CUDA error (0 on success) without
// synchronising; cudaErrorInvalidValue (1) for a head dim outside 1 .. 256.

extern "C" int cmgan_flash_rel_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* out,
    void* lse, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid, int q_offset,
    int is_bf16, void* stream) {
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || !head_dim_ok(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, table, out, lse, G, Tq, Tk, head_dim,
                                             max_pos, t_valid, q_offset, s)
                 : launch_fwd<float>(q, k, v, table, out, lse, G, Tq, Tk, head_dim, max_pos,
                                     t_valid, q_offset, s);
}

// `delta` fp32 [G, Tq] is scratch; `dtable` fp32 [2*max_pos+1, head_dim]
// receives the table's gradient. `partials` is not read: this library asks for
// no rows of it (cmgan_flash_rel_attention_bwd_partial_rows).
extern "C" int cmgan_flash_rel_attention_bwd(
    const void* q, const void* k, const void* v, const void* table, const void* out,
    const void* gout, const void* lse, void* dq, void* dk, void* dv, void* delta,
    void* dtable, void* partials, int G, int Tq, int Tk, int head_dim, int max_pos, int t_valid,
    int q_offset, int is_bf16, int partial_rows, void* stream) {
  (void)partials;
  (void)partial_rows;
  if (G <= 0 || Tq <= 0 || t_valid <= 0 || t_valid > Tk || max_pos < 0 || !head_dim_ok(head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, table, out, gout, lse, dq, dk, dv, delta,
                                             dtable, G, Tq, Tk, head_dim, max_pos, t_valid,
                                             q_offset, s)
                 : launch_bwd<float>(q, k, v, table, out, gout, lse, dq, dk, dv, delta, dtable, G,
                                     Tq, Tk, head_dim, max_pos, t_valid, q_offset, s);
}

// Rows of `partials` a backward launch writes: none (the table's gradient
// goes to dtable by global atomics). Negative: minus a CUDA error.
extern "C" int cmgan_flash_rel_attention_bwd_partial_rows(int is_bf16, int head_dim, int G,
                                                          int Tq, int max_pos) {
  (void)is_bf16;
  if (G <= 0 || Tq <= 0 || max_pos < 0 || !head_dim_ok(head_dim)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Dynamic shared memory, in bytes, of one block of the forward, or -1. The
// same at both input types: tiles are staged as fp32.
extern "C" int cmgan_flash_rel_attention_fwd_smem(int is_bf16, int head_dim) {
  (void)is_bf16;
  return head_dim_ok(head_dim) ? fwd_bytes(head_dim) : -1;
}

// ... of the backward's kernel `which` (0: dq and the table's gradient, 1: dk
// and dv), or -1.
extern "C" int cmgan_flash_rel_attention_bwd_smem(int is_bf16, int head_dim, int which,
                                                  int max_pos) {
  (void)is_bf16;
  (void)max_pos;
  if (!head_dim_ok(head_dim)) return -1;
  return which == 0 ? bwd_q_bytes(head_dim) : which == 1 ? bwd_k_bytes(head_dim) : -1;
}
