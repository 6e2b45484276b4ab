// Shared by flash_rel_attention.cu (forward) and flash_rel_attention_bwd.cu
// (backward): the tile products on the tensor cores, the staging of tiles and
// of the window of E into shared memory, and the skewed position term.
//
// Products. Every product of the two kernels is a sum of 16 x 8 x 16 tile
// products C += A . B, one mma.sync.m16n8k16 on bf16 operands with an fp32
// accumulator. One warp executes it; lane (g, t) = (lane / 4, lane % 4) owns
//
//   A (16 x 16)  rows g and g + 8, depth {2t, 2t+1, 2t+8, 2t+9}
//   B (16 x 8)   depth {2t, 2t+1, 2t+8, 2t+9}, column g
//   C (16 x 8)   rows g and g + 8, columns 2t and 2t + 1
//
// Because C's ownership is A's, two neighbouring C tiles (softmax weights) are
// the A operand of the next product without leaving registers.
//
// bf16 inputs are one such operand. An fp32 input x is carried as three bf16
// parts, x = x0 + x1 + x2 with x0 = bf16(x), x1 = bf16(x - x0), x2 =
// bf16(x - x0 - x1): 24 bits in all, so nothing of x is lost. A product of
// two fp32 operands is then the six part products whose terms are above 2^-24
// of the result, (0,0) (0,1) (1,0) (0,2) (2,0) (1,1), summed smallest first
// into the same fp32 accumulator: fp32 accuracy from the bf16 tensor cores,
// at six times the bf16 route's tensor work. (Three TF32 passes, big.big +
// big.small + small.big, were tried first: each product is then good to
// ~5e-7, not 6e-8, and a training step's gradients moved from 3e-4 to 2e-3 of
// the float64 result; see PERF.md.) Tiles are split once, where they are
// staged into shared memory, as three bf16 planes, so that all warps share
// the split and every fragment load is an ldmatrix whatever the input type.
//
// The position term by skew. For a tile of BQ queries from i0 and 64 keys
// from j0, query a meets key b at distance base + c with c = a - b + 63 and
// base = i0 + q_offset - j0 - 63. Row c of the staged window is
// E[clip(base + c, +-max_pos) + max_pos]. A warp (16 queries from 16w) needs
// window rows 16w .. 16w + 78: it computes R = Q_w . E_w^T (16 x 80) as ten
// tile products, parks R in its own shared scratch column-major with 20
// floats a column (conflict-free for the write and for the skewed read), and
// adds R[r][r - b + 63] to the content logit of (r, b). A tile pair whose
// every distance is clipped needs no window: its position logit is one of two
// scalars a query, q_a . E[2*max_pos] or q_a . E[0].
//
// The head dim. Rows of q, k, v and E are HD wide, HD a multiple of 16 (the
// libraries instantiate 16, 32 and 64; the wrapper zero-pads other widths up
// to the next, which changes no product). A product over the head dim takes
// HD / 16 depth steps, one whose result is HD wide HD / 8 tiles of 8 columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

// One definition per library: each .cu includes this header once.
extern "C" const char* cmgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace flash_rel {

constexpr int BK = 64;       // keys per tile
// bf16 elements per staged row of HD: 2 * HD + 16 bytes, 16-byte aligned, and
// the eight rows an ldmatrix reads fall on eight different groups of 4 banks
__host__ __device__ constexpr int stage_stride(int hd) { return hd + 8; }
constexpr int RCOLS = 80;    // columns of R a warp computes (79 needed)
constexpr int RS = 20;       // floats per column of the R scratch
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may ask for

// f(std::integral_constant<int, HD>()) for a head dim the libraries are built
// for (16, 32, 64: ops/flash_attention.py KERNEL_HEAD_DIMS), `otherwise` for
// any other
template <typename F>
int with_head_dim(int head_dim, int otherwise, F f) {
  switch (head_dim) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    default: return otherwise;
  }
}

enum Clip { kMixed = 0, kHigh = 1, kLow = 2 };

// The uniform test: are all distances of the tile pair clipped to one row?
__device__ __forceinline__ int clip_kind(int base, int bq, int max_pos) {
  if (base >= max_pos) return kHigh;                        // least distance
  if (base + bq + BK - 2 <= -max_pos) return kLow;          // largest distance
  return kMixed;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float x, float* p) { *p = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// two neighbouring values, one store
__device__ __forceinline__ void narrow2(float x, float y, float* p) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void narrow2(float x, float y, __nv_bfloat16* p) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- fragments ----

using bf16 = __nv_bfloat16;

// bf16 parts an element of type T is carried in
template <typename T> struct Parts { static constexpr int N = 1; };
template <> struct Parts<float> { static constexpr int N = 3; };

template <int P> struct FragA { uint32_t r[P][4]; };
template <int P> struct FragB { uint32_t r[P][2]; };

// x = x0 + x1 + x2 and y likewise, each part a bf16; part i of both in p[i]
// (x in the low half)
__device__ __forceinline__ void split3(float x, float y, uint32_t* p) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16(x, y);
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// A from eight accumulator-layout values: v[0..1] row g depth 2t, 2t+1; v[2..3]
// row g+8 the same; v[4..7] depth 2t+8, 2t+9
__device__ __forceinline__ void frag_from(FragA<1>& a, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.r[0][i] = pack_bf16(v[2 * i], v[2 * i + 1]);
}
__device__ __forceinline__ void frag_from(FragA<3>& a, const float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p[3];
    split3(v[2 * i], v[2 * i + 1], p);
    a.r[0][i] = p[0];
    a.r[1][i] = p[1];
    a.r[2][i] = p[2];
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8, fp32) += a (16 x 16) . b (16 x 8)
__device__ __forceinline__ void mma(float* c, const FragA<1>& a, const FragB<1>& b) {
  mma_bf16(c, a.r[0], b.r[0]);
}
// The tensor core adds into its accumulator by truncation, not to nearest: a
// long chain of products summed there drifts by ~2^-24 a step (4e-6 measured
// on a row of 641 keys, against 5e-7 for plain fp32). So the six part products
// start from zero, the five small ones in one chain, and join c by fp32 adds.
__device__ __forceinline__ void mma(float* c, const FragA<3>& a, const FragB<3>& b) {
  float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(small, a.r[1], b.r[1]);
  mma_bf16(small, a.r[2], b.r[0]);
  mma_bf16(small, a.r[0], b.r[2]);
  mma_bf16(small, a.r[1], b.r[0]);
  mma_bf16(small, a.r[0], b.r[1]);
  mma_bf16(big, a.r[0], b.r[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += big[i] + small[i];
}

// ---- fragment loads from a staged tile: P bf16 planes, `plane` elements
// apart, rows of `stride` elements. Four views of the row-major tile M:
//   load_a        A[r][k] = M[r0 + r][k0 + k]
//   load_a_trans  A[r][k] = M[k0 + k][r0 + r]
//   load_b        B[k][n] = M[n0 + n][k0 + k]
//   load_b_trans  B[k][n] = M[k0 + k][n0 + n]
// ldmatrix: lane l gives the address of row l % 8 of 8 x 8 matrix l / 8.

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

template <int P>
__device__ __forceinline__ void load_a(FragA<P>& a, const bf16* m, int plane, int stride, int r0,
                                       int k0, int lane) {
  const int mi = lane >> 3, row = lane & 7;
  const bf16* at = m + (r0 + (mi & 1) * 8 + row) * stride + k0 + (mi >> 1) * 8;
#pragma unroll
  for (int p = 0; p < P; ++p) ldmatrix_x4(a.r[p], at + p * plane);
}
template <int P>
__device__ __forceinline__ void load_a_trans(FragA<P>& a, const bf16* m, int plane, int stride,
                                             int r0, int k0, int lane) {
  const int mi = lane >> 3, row = lane & 7;
  const bf16* at = m + (k0 + (mi >> 1) * 8 + row) * stride + r0 + (mi & 1) * 8;
#pragma unroll
  for (int p = 0; p < P; ++p) ldmatrix_x4_trans(a.r[p], at + p * plane);
}
template <int P>
__device__ __forceinline__ void load_b(FragB<P>& b, const bf16* m, int plane, int stride, int n0,
                                       int k0, int lane) {
  const int mi = (lane >> 3) & 1, row = lane & 7;
  const bf16* at = m + (n0 + row) * stride + k0 + mi * 8;
#pragma unroll
  for (int p = 0; p < P; ++p) ldmatrix_x2(b.r[p], at + p * plane);
}
template <int P>
__device__ __forceinline__ void load_b_trans(FragB<P>& b, const bf16* m, int plane, int stride,
                                             int n0, int k0, int lane) {
  const int mi = (lane >> 3) & 1, row = lane & 7;
  const bf16* at = m + (k0 + mi * 8 + row) * stride + n0;
#pragma unroll
  for (int p = 0; p < P; ++p) ldmatrix_x2_trans(b.r[p], at + p * plane);
}

// The fp32 value of element `at` of a staged tile
template <int P>
__device__ __forceinline__ float tile_value(const bf16* m, int plane, int at) {
  float x = 0.f;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) x += __bfloat162float(m[p * plane + at]);
  return x;
}

// ---- A operands from a scratch array written by the kernel itself (dR, P,
// dS), kept in the input type: bf16 through ldmatrix, fp32 read as owned
// elements and split in registers ----

__device__ __forceinline__ void load_a_scratch(FragA<1>& a, const bf16* m, int stride, int r0,
                                               int k0, int lane) {
  load_a<1>(a, m, 0, stride, r0, k0, lane);
}
__device__ __forceinline__ void load_a_scratch_trans(FragA<1>& a, const bf16* m, int stride,
                                                     int r0, int k0, int lane) {
  load_a_trans<1>(a, m, 0, stride, r0, k0, lane);
}
__device__ __forceinline__ void load_a_scratch(FragA<3>& a, const float* m, int stride, int r0,
                                               int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float v[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float2 x = *reinterpret_cast<const float2*>(m + (r0 + g + 8 * rr) * stride + k0 + 2 * t + 8 * h);
      v[4 * h + 2 * rr] = x.x;
      v[4 * h + 2 * rr + 1] = x.y;
    }
  }
  frag_from(a, v);
}
__device__ __forceinline__ void load_a_scratch_trans(FragA<3>& a, const float* m, int stride,
                                                     int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float v[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[4 * h + 2 * rr + e] = m[(k0 + 2 * t + 8 * h + e) * stride + r0 + g + 8 * rr];
      }
    }
  }
  frag_from(a, v);
}

// ---- staging ----

// One 16-byte chunk of a row of T (chunk c of row r) into the staged tile,
// rows ts elements apart
__device__ __forceinline__ void store_chunk(bf16* dst, int plane, int ts, int r, int c, uint4 x,
                                            bf16) {
  *reinterpret_cast<uint4*>(dst + r * ts + 8 * c) = x;
}
__device__ __forceinline__ void store_chunk(bf16* dst, int plane, int ts, int r, int c, uint4 x,
                                            float) {
  uint32_t lo[3], hi[3];
  split3(__uint_as_float(x.x), __uint_as_float(x.y), lo);
  split3(__uint_as_float(x.z), __uint_as_float(x.w), hi);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    *reinterpret_cast<uint2*>(dst + p * plane + r * ts + 4 * c) = make_uint2(lo[p], hi[p]);
  }
}

// Rows row0 .. row0 + nrows - 1 of src ([limit, HD] contiguous) into the
// staged tile dst; rows at or past `limit` are zero.
template <typename T, int NT, int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, int plane, const T* __restrict__ src,
                                           int row0, int nrows, int limit, int tid) {
  constexpr int C = HD * sizeof(T) / 16;  // 16-byte chunks in a row
  for (int e = tid; e < nrows * C; e += NT) {
    const int r = e / C, c = e % C;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      x = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * HD + c * (16 / sizeof(T)));
    }
    store_chunk(dst, plane, stage_stride(HD), r, c, x, T());
  }
}

// A tile on its way from global to shared memory, held in registers: fetched
// while the previous tile pair is computed, stored (and split) once that one
// is consumed, so the loads' latency hides behind the products.
template <typename T, int NT, int ROWS, int HD>
struct TileFetch {
  static constexpr int C = HD * sizeof(T) / 16;       // 16-byte chunks in a row
  static constexpr int N = (ROWS * C + NT - 1) / NT;  // chunks a thread carries
  uint4 x[N];

  // rows row0 .. of src ([limit, HD] contiguous); rows at or past `limit` are zero
  __device__ __forceinline__ void fetch_rows(const T* __restrict__ src, int row0, int limit, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NT, r = e / C, c = e % C;
      x[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < ROWS * C && row0 + r < limit) {
        x[i] = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * HD + c * (16 / sizeof(T)));
      }
    }
  }
  // window row c is E[clip(base + c, +-max_pos) + max_pos]
  __device__ __forceinline__ void fetch_window(const T* __restrict__ table, int base, int max_pos, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NT, r = e / C, c = e % C;
      if (e < ROWS * C) {
        const int row = min(max(base + r, -max_pos), max_pos) + max_pos;
        x[i] = *reinterpret_cast<const uint4*>(table + row * HD + c * (16 / sizeof(T)));
      }
    }
  }
  __device__ __forceinline__ void store(bf16* dst, int tid) const {
    constexpr int TS = stage_stride(HD);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NT;
      if (e < ROWS * C) store_chunk(dst, ROWS * TS, TS, e / C, e % C, x[i], T());
    }
  }
};

// ---- the logits of one warp: 16 queries against 64 keys ----

// s[nb][0..1]: row g, keys 8nb + 2t, + 1;  s[nb][2..3]: row g + 8, the same keys.
// qa: the warp's queries, HD / 16 depth steps; ks: the staged key tile; es: the
// staged window (kMixed only), its planes e_plane apart; rt: this warp's R scratch;
// pos_hi / pos_lo: the two clipped scalars of rows g and g + 8.
template <int P, int HD>
__device__ __forceinline__ void warp_logits(float (*s)[4], const FragA<P> (&qa)[HD / 16],
                                            const bf16* ks, const bf16* es, int e_plane,
                                            float* rt, int kind, const float* pos_hi,
                                            const float* pos_lo, int w, int lane) {
  constexpr int TS = stage_stride(HD);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < BK / 8; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      FragB<P> kb;
      load_b<P>(kb, ks, BK * TS, TS, 8 * nb, 16 * kd, lane);
      mma(s[nb], qa[kd], kb);
    }
  }
  if (kind == kMixed) {
    __syncwarp();  // the scratch's earlier readers are done
#pragma unroll
    for (int nb = 0; nb < RCOLS / 8; ++nb) {
      float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        FragB<P> eb;
        load_b<P>(eb, es, e_plane, TS, 16 * w + 8 * nb, 16 * kd, lane);
        mma(r, qa[kd], eb);
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
  } else {
    const float p0 = kind == kHigh ? pos_hi[0] : pos_lo[0];
    const float p1 = kind == kHigh ? pos_hi[1] : pos_lo[1];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
      s[nb][0] += p0;
      s[nb][1] += p0;
      s[nb][2] += p1;
      s[nb][3] += p1;
    }
  }
}

// sum over the four lanes that share a row
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

}  // namespace flash_rel
