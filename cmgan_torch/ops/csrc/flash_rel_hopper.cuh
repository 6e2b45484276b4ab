// Hopper building blocks of the attention kernels (flash_rel_attention.cu,
// the forward, and flash_rel_attention_bwd.cu, the backward, for head dims up
// to 64; flash_rel_attention_wide{,_bwd}.cu past it, whose shared pieces are
// the namespace `wide` at the end), written as inline PTX so that nvcc builds
// each library in seconds: no CUTLASS or CuTe header.
//
//   mbarrier    a barrier in shared memory that counts arrivals and the bytes
//               a TMA copy delivers; a waiter spins on one phase's parity
//   TMA         cp.async.bulk.tensor: one thread copies a box of a tensor
//               (described by a CUtensorMap made on the host) into shared
//               memory, swizzled, zero-filling rows outside the tensor, and
//               reports the bytes to an mbarrier
//   wgmma       wgmma.mma_async: a warpgroup (four warps) multiplies a 64-row
//               tile, A from shared memory (a matrix descriptor) or from
//               registers, B from shared memory, the fp32 sum in registers
//   setmaxnreg  moves registers from the producer warpgroup to the consumers
//
// Staged tiles. Every operand tile is bf16 rows of RB = 2 * HD bytes (32, 64 or
// 128), stored row after row and swizzled as the TMA's SWIZZLE_{32,64,128}B
// modes store them: the 16-byte chunk c of row r sits at chunk c ^ ((r * RB /
// 128) mod (RB / 16)) of its row, the pattern repeating every 8 rows. Buffers
// start at 1024-byte boundaries, so the pattern is the same whether the
// address or the offset in the buffer is swizzled. As a wgmma operand such a
// tile is
//   K-major (A = Q, B = K or a window of E: rows along M or N, the head dim
//   along the depth): 8-row groups SBO = 8 * RB bytes apart; a depth step of
//   16 moves the start 32 bytes along the row;
//   MN-major (B = V: keys along the depth, the head dim along N): 8-key
//   groups SBO apart; the next 16 keys start 16 * RB bytes on. N = HD fits one
//   swizzle row, so the leading byte offset is not used in either form.
// The backward also takes A MN-major (its dR^T: 64 window rows along M, one
// 128-byte row of bf16 a query along the depth), the same rules with M for
// N; only 16-bit operands may be MN-major.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <numeric>

#include "flash_rel_common.cuh"

namespace flash_rel {
namespace hopper {

// ---- mbarrier ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more from TMA copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// expect `bytes` more from TMA copies, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the phase of this parity has completed. A phase that never
// completes (a fault in the protocol) traps after ~2^34 clocks, some
// seconds, so that the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy (wgmma reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- TMA: a box of the tensor map into shared memory, completion on `bar` ----

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- registers between warpgroups ----

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---- wgmma ----

// the swizzle of rows of rb bytes: the descriptor's layout code (128 B: 1,
// 64 B: 2, 32 B: 3)
__host__ __device__ constexpr int swizzle_layout(int rb) { return rb == 128 ? 1 : rb == 64 ? 2 : 3; }

// byte offset o of a tile with rows of RB bytes, swizzled
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & (RB / 16 - 1)) << 4);
}

// the matrix descriptor of a staged tile at shared address addr; lbo: (an
// MN-major B wider than one swizzle row) where its next columns start
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo, int layout,
                                              uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// the compiler may not move reads or writes of these registers across this
// point: an accumulator is read only after the wait that completes it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32) = A . B (_zero) or d + A . B, bf16 operands. _ss: A and B
// in shared memory, each K-major or (TA, TB = 1) MN-major; _rs: A from
// registers (the m16n8k16 A layout a warp, rows 16w .. 16w + 15), B MN-major
// in shared memory, N the head dim and 8 more columns, a second swizzle atom
// the leading byte offset on. The _zero forms only write the accumulator, so
// that a chain's first product needs no defined registers.

#define CMGAN_W(x) "=f"(x)
#define CMGAN_RW(x) "+f"(x)
#define CMGAN_D8(M, o) M(d[(o) + 0]), M(d[(o) + 1]), M(d[(o) + 2]), M(d[(o) + 3]), \
                       M(d[(o) + 4]), M(d[(o) + 5]), M(d[(o) + 6]), M(d[(o) + 7])
#define CMGAN_D16(M, o) CMGAN_D8(M, o), CMGAN_D8(M, (o) + 8)
#define CMGAN_D24(M, o) CMGAN_D16(M, o), CMGAN_D8(M, (o) + 16)
#define CMGAN_D32(M, o) CMGAN_D16(M, o), CMGAN_D16(M, (o) + 16)
#define CMGAN_D64(M) CMGAN_D32(M, 0), CMGAN_D32(M, 32)
#define CMGAN_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define CMGAN_R16 CMGAN_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define CMGAN_R24 CMGAN_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define CMGAN_R32 CMGAN_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CMGAN_R64 CMGAN_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
                  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// operands after the accumulator's: A's and B's descriptors, the scale-d
// flag, A's and B's transposes (immediates)
#define CMGAN_SS(SHAPE, REGS, IA, IB, IP, ITA, ITB)                                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                         \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32.bf16.bf16 {" REGS "}, %" IA ", %" IB           \
  ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"

template <int N, bool ZERO, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 128,
                "the head dims, S (n 64), R (n 128), and up to three planes of B at head dim 16");
  if constexpr (N == 16 && ZERO) {
    asm volatile(CMGAN_SS("m64n16k16", CMGAN_R8, "8", "9", "10", "11", "12")
                 : CMGAN_D8(CMGAN_W, 0) : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(CMGAN_SS("m64n16k16", CMGAN_R8, "8", "9", "10", "11", "12")
                 : CMGAN_D8(CMGAN_RW, 0) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 32 && ZERO) {
    asm volatile(CMGAN_SS("m64n32k16", CMGAN_R16, "16", "17", "18", "19", "20")
                 : CMGAN_D16(CMGAN_W, 0) : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(CMGAN_SS("m64n32k16", CMGAN_R16, "16", "17", "18", "19", "20")
                 : CMGAN_D16(CMGAN_RW, 0) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 48 && ZERO) {
    asm volatile(CMGAN_SS("m64n48k16", CMGAN_R24, "24", "25", "26", "27", "28")
                 : CMGAN_D24(CMGAN_W, 0) : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
  } else if constexpr (N == 48) {
    asm volatile(CMGAN_SS("m64n48k16", CMGAN_R24, "24", "25", "26", "27", "28")
                 : CMGAN_D24(CMGAN_RW, 0) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (N == 64 && ZERO) {
    asm volatile(CMGAN_SS("m64n64k16", CMGAN_R32, "32", "33", "34", "35", "36")
                 : CMGAN_D32(CMGAN_W, 0) : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(CMGAN_SS("m64n64k16", CMGAN_R32, "32", "33", "34", "35", "36")
                 : CMGAN_D32(CMGAN_RW, 0) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else if constexpr (ZERO) {
    asm volatile(CMGAN_SS("m64n128k16", CMGAN_R64, "64", "65", "66", "67", "68")
                 : CMGAN_D64(CMGAN_W) : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
  } else {
    asm volatile(CMGAN_SS("m64n128k16", CMGAN_R64, "64", "65", "66", "67", "68")
                 : CMGAN_D64(CMGAN_RW) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}

__device__ __forceinline__ void wgmma_rs_n16_zero(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, " "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, " "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32_zero(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, " "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, " "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64_zero(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, " "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, " "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n24_zero(float (&d)[12], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, " "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, " "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n40_zero(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, " "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, " "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n72_zero(float (&d)[36], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35"
      "}, " "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n72(float (&d)[36], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35"
      "}, " "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ZERO: d = A . B (the accumulator's registers are only written); else d += A . B
#define CMGAN_RS48                                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                                              \
  "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {" CMGAN_R24 "}, {%24, %25, %26, %27}, " \
  "%28, p, 1, 1, 1;\n}\n"
__device__ __forceinline__ void wgmma_rs_n48_zero(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(CMGAN_RS48 : CMGAN_D24(CMGAN_W, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(CMGAN_RS48 : CMGAN_D24(CMGAN_RW, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N, bool ZERO>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 24 || N == 40 || N == 72,
                "the head dims 16, 32 and 64, alone or with 8 columns of row sums, or three planes of "
                "B at head dim 16");
  if constexpr (N == 48 && ZERO) wgmma_rs_n48_zero(d, a, db);
  if constexpr (N == 48 && !ZERO) wgmma_rs_n48(d, a, db);
  if constexpr (N == 16 && ZERO) wgmma_rs_n16_zero(d, a, db);
  if constexpr (N == 16 && !ZERO) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32 && ZERO) wgmma_rs_n32_zero(d, a, db);
  if constexpr (N == 32 && !ZERO) wgmma_rs_n32(d, a, db);
  if constexpr (N == 64 && ZERO) wgmma_rs_n64_zero(d, a, db);
  if constexpr (N == 64 && !ZERO) wgmma_rs_n64(d, a, db);
  if constexpr (N == 24 && ZERO) wgmma_rs_n24_zero(d, a, db);
  if constexpr (N == 24 && !ZERO) wgmma_rs_n24(d, a, db);
  if constexpr (N == 40 && ZERO) wgmma_rs_n40_zero(d, a, db);
  if constexpr (N == 40 && !ZERO) wgmma_rs_n40(d, a, db);
  if constexpr (N == 72 && ZERO) wgmma_rs_n72_zero(d, a, db);
  if constexpr (N == 72 && !ZERO) wgmma_rs_n72(d, a, db);
}

// ---- registers ----

// the compiler keeps an RS product's A fragments as they are until this
// point (the wait that completes the product): they are read asynchronously
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the 128 threads of warpgroup wg of the consumers meet (named barrier 1 + wg;
// 0 is __syncthreads'), their shared-memory writes visible to each other
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// ---- staging and products shared by the kernels ----

constexpr int WQ = 64;           // rows of a consumer warpgroup's tile
constexpr float L2E = 1.4426950408889634f;

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(addr), "r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// fp32 producer: rows row0 .. row0 + ROWS - 1 of src ([limit, HD]) split into
// three bf16 planes at dst, `plane` bytes apart, swizzled; rows outside
// [0, limit) are zero. The 128 threads of the producer warpgroup share it.
template <int HD, int ROWS>
__device__ __forceinline__ void split_rows(uint32_t dst, int plane, const float* __restrict__ src,
                                           int row0, int limit, int ptid) {
  constexpr int C4 = HD / 4, RB = 2 * HD;            // 16-byte chunks of fp32 a row
  constexpr int N = ROWS * C4 / 128;                  // chunks a thread
  // loads in flight a thread: the most, up to 4, that divide the chunks
  constexpr int B = N % 4 == 0 ? 4 : N % 3 == 0 ? 3 : N % 2 == 0 ? 2 : 1;
  static_assert(ROWS * C4 % 128 == 0 && N % B == 0, "whole batches of chunks");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += B) {
    float4 x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int e = ptid + 128 * (n0 + i), row = row0 + e / C4;
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row >= 0 && row < limit) {
        x[i] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row) * HD) + e % C4);
      }
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int e = ptid + 128 * (n0 + i);
      uint32_t lo[3], hi[3];
      split3(x[i].x, x[i].y, lo);
      split3(x[i].z, x[i].w, hi);
      const uint32_t o = swz<RB>((e / C4) * RB + 8 * (e % C4));
#pragma unroll
      for (int p = 0; p < 3; ++p) st_shared_v2(dst + p * plane + o, lo[p], hi[p]);
    }
  }
}

// The part products of an fp32 product, smallest first: (part of A, part of
// B) for x = 0 .. 5; bf16 takes x = 5 alone.
__host__ __device__ constexpr int part_a(int x) { return x == 0 || x == 3 ? 1 : x == 1 ? 2 : 0; }
__host__ __device__ constexpr int part_b(int x) { return x == 0 || x == 4 ? 1 : x == 2 ? 2 : 0; }

// bf16 producer: the window's rows row0 .. row0 + WIN - 1 of the table,
// clipped to [0, 2*max_pos] (the rows of E[clip(base + c, +-max_pos) +
// max_pos]), gathered by the 128 threads of the warpgroup into the swizzled
// tile at dst
template <int HD, int WIN>
__device__ __forceinline__ void gather_window(uint32_t dst, const __nv_bfloat16* __restrict__ table,
                                              int row0, int max_pos, int ptid) {
  constexpr int RB = 2 * HD, CR = RB / 16;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < WIN * CR / 128; ++i) {
    const int e = ptid + 128 * i, r = e / CR;
    const int row = min(max(row0 + r, 0), 2 * max_pos);
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(table + static_cast<size_t>(row) * HD) + e % CR);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dst + swz<RB>(16 * e)), "r"(x.x),
                 "r"(x.y), "r"(x.z), "r"(x.w)
                 : "memory");
  }
}

// fp32 producer: a tile of 64 rows of kg from j0 (keys; in the backward's
// dk/dv kernel, queries), the same rows of vg (values; there the output's
// gradient) and (win) the window's rows row0 .. of the table into their
// planes at st, the loads of all three in flight together (ten 16-byte loads
// a thread at head dim 16). Rows at or past Tk are zero; window rows are
// clipped to the table's.
template <int HD, int WIN>
__device__ __forceinline__ void split_tile(uint32_t st, const float* __restrict__ kg,
                                           const float* __restrict__ vg,
                                           const float* __restrict__ table, int j0, int Tk,
                                           bool win, int row0, int rows, int ptid) {
  constexpr int C4 = HD / 4, RB = 2 * HD;
  constexpr int KPL = BK * RB, CK = BK * C4 / 128, CE = WIN * C4 / 128;  // chunks a thread
  constexpr int N = 2 * CK + CE, B = N <= 12 ? N : N % 10 == 0 ? 10 : 8;
  static_assert(N % B == 0, "whole batches of chunks");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += B) {
    float4 x[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int n = n0 + i;  // K chunks, then V's, then E's
      const int e = ptid + 128 * (n < CK ? n : n < 2 * CK ? n - CK : n - 2 * CK);
      const float* src = n < CK ? kg : n < 2 * CK ? vg : table;
      const int row = n < 2 * CK ? j0 + e / C4 : min(max(row0 + e / C4, 0), rows - 1);
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < 2 * CK ? row < Tk : win) {
        x[i] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row) * HD) + e % C4);
      }
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int n = n0 + i;
      if (n >= 2 * CK && !win) continue;
      const int e = ptid + 128 * (n < CK ? n : n < 2 * CK ? n - CK : n - 2 * CK);
      const uint32_t dst = st + (n < CK ? 0 : n < 2 * CK ? 3 * KPL : 6 * KPL);
      const int plane = n < 2 * CK ? KPL : WIN * RB;
      uint32_t lo[3], hi[3];
      split3(x[i].x, x[i].y, lo);
      split3(x[i].z, x[i].w, hi);
      const uint32_t o = swz<RB>((e / C4) * RB + 8 * (e % C4));
#pragma unroll
      for (int p = 0; p < 3; ++p) st_shared_v2(dst + p * plane + o, lo[p], hi[p]);
    }
  }
}

// A product of the consumer warpgroup: d (64 x N) = A . B^T over the head dim,
// A and B K-major staged tiles of P planes. fp32 (P = 3): the six part
// products whose terms are above 2^-24 of the result, smallest first into the
// one accumulator; bf16: the one product.
template <int P, int HD, int N, int SBO, int LAYOUT>
__device__ __forceinline__ void product(float (&d)[N / 2], uint32_t a, int a_plane, uint32_t b,
                                        int b_plane) {
  constexpr int first = P == 1 ? 5 : 0;
#pragma unroll
  for (int x = first; x < 6; ++x) {
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      const uint64_t da = smem_desc(a + part_a(x) * a_plane + 32 * kd, SBO, LAYOUT);
      const uint64_t db = smem_desc(b + part_b(x) * b_plane + 32 * kd, SBO, LAYOUT);
      if (x == first && kd == 0) {
        wgmma_ss<N, true>(d, da, db);
      } else {
        wgmma_ss<N, false>(d, da, db);
      }
    }
  }
}

// ---- host: tensor maps ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

// A map of a bf16 tensor of `rank` dims (innermost first; rows of rb bytes,
// `strides` in bytes for dims 1 ..), boxes of `box`, swizzled as rows of rb
// bytes; elements outside the tensor read as zero. 0, or a CUDA error code.
inline int make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box, int rb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


// ============ the wide kernels' pieces (flash_rel_attention_wide{,_bwd}.cu) ============
//
// Heads wider than 64, of any width, in chunks of 64 columns: a chunk tile is
// 64 rows of 128 bytes of bf16 (fp32: three planes, x = x0 + x1 + x2, split
// once by flash_rel_wide_split), in the 128-byte swizzle, so every product is
// wgmma with the descriptors of a 64-wide head. Columns past D are zero in
// shared memory and not computed. A block is a producer warpgroup and two
// consumer warpgroups; the producer fills a ring of stages, each 128 rows of
// one chunk: two 64-row tiles, each from its own rows and columns, or the
// 128-row window of the table; by TMA where a row is a multiple of 16 bytes (D
// a multiple of 8) and the window has no clipped row; else by its own cp.async
// copies (rows of 200 bytes at D 100; a window's clipped rows repeat the
// table's ends), one stage kept in flight while it issues the next. The two
// consumer warpgroups share a tile pair's logits: warpgroup w computes S for
// keys 32w .. 32w + 31 and R = Q . E_window^T for window rows 64w .. 64w + 63,
// R through a band in shared memory, R[a][a + x] at [a][x].

namespace wide {

constexpr int CH = 64;                   // head-dim columns a chunk: a 128-byte bf16 row
constexpr int NCW = 2;                   // consumer warpgroups
constexpr int NT = 128 * (NCW + 1);      // the producer warpgroup, then the consumers
constexpr int CONSUMERS = 128 * NCW;
constexpr int TILE = 64 * 128;           // bytes a 64-row chunk tile (a bf16 plane)
constexpr int PLANE = 2 * TILE;          // bytes a plane of a stage: 128 rows
constexpr int SBO = 1024;                // 8 rows of 128 bytes
constexpr int LAYOUT = 1;                // the 128-byte swizzle
constexpr int SKS = 68;                  // floats a row of the band
constexpr int BAND = 64 * SKS * 4;       // R[a][a + x], x in [0, 64): a query a row
constexpr int CONSUMER_BAR = 5;          // the consumers' named barrier (1 .. 2: warpgroups')

__host__ __device__ constexpr int chunks_of(int d) { return (d + CH - 1) / CH; }

// the 256 consumer threads meet, their shared-memory writes visible to each other
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(CONSUMER_BAR), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
// no memory clobber: ordered by the fence and the barrier that follow
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("{\n.reg .b16 h;\ncvt.u16.u32 h, %1;\nst.shared.b16 [%0], h;\n}\n" ::"r"(addr), "r"(v));
}

// x, which the compiler may not take for loop-invariant: descriptors made
// from it are made where they are used, not held in registers over the walk
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ int opaque_i(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// ---- descriptors of 128-byte-row tiles ----

// K-major: rows along M or N, the 64 columns along the depth (16 a step)
__device__ __forceinline__ uint64_t kdesc(uint32_t a, int kk) { return smem_desc(a + 32 * kk, SBO, LAYOUT); }
// MN-major: rows along the depth (16 a step), the 64 columns along M or N
__device__ __forceinline__ uint64_t mdesc(uint32_t a, int kk) { return smem_desc(a + 2048 * kk, SBO, LAYOUT); }

// (the base passes through opaque() at each use, so that a chain's
// descriptors are made as it issues them, not all held in registers first)
struct KMaj {  // a tile of planes `pl` bytes apart, K-major
  uint32_t a;
  int pl;
  __device__ __forceinline__ uint64_t operator()(int p, int kk) const { return kdesc(opaque(a) + p * pl, kk); }
};
struct MMaj {  // ... MN-major
  uint32_t a;
  int pl;
  __device__ __forceinline__ uint64_t operator()(int p, int kk) const { return mdesc(opaque(a) + p * pl, kk); }
};

// d (64 x N) = A . B over K16 depth steps (ACC: d += A . B): the part
// products of P planes, smallest first (all steps of a part before the
// next), from zero
template <int N, int P, int K16, int TA, int TB, bool ACC = false, typename FA, typename FB>
__device__ __forceinline__ void chain(float (&d)[N / 2], FA da, FB db) {
  constexpr int X0 = P == 1 ? 5 : 0;
#pragma unroll
  for (int x = X0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      const uint64_t a = da(part_a(x), kk), b = db(part_b(x), kk);
      if (!ACC && x == X0 && kk == 0) {
        wgmma_ss<N, true, TA, TB>(d, a, b);
      } else {
        wgmma_ss<N, false, TA, TB>(d, a, b);
      }
    }
  }
}

// d = A . B (ACC: d += A . B), both K-major, over the first ks depth steps
// of a chunk (4, or fewer in the last chunk of a head dim that is no
// multiple of 64: the zero columns past D are not computed), in a
// fence-to-wait span of its own in each case
template <int N, int P, bool ACC, typename FA, typename FB>
__device__ __forceinline__ void chunk_product(int ks, float (&d)[N / 2], FA da, FB db) {
  switch (ks) {
    case 1:
      wgmma_fence();
      chain<N, P, 1, 0, 0, ACC>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    case 2:
      wgmma_fence();
      chain<N, P, 2, 0, 0, ACC>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    case 3:
      wgmma_fence();
      chain<N, P, 3, 0, 0, ACC>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    default:
      wgmma_fence();
      chain<N, P, 4, 0, 0, ACC>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
  }
  fence_regs(d);
}
// A mixed pair's chunk in one span (bf16): r = Q . E_w^T (N 64; RACC: r +=)
// and d += Q . K^T (N 32)
template <int P, bool RACC = false, typename FA, typename FB, typename FC, typename FD>
__device__ __forceinline__ void logits_product(int ks, float (&r)[32], FA ra, FB rb, float (&d)[16], FC da,
                                               FD db) {
  switch (ks) {
    case 1:
      wgmma_fence();
      chain<64, P, 1, 0, 0, RACC>(r, ra, rb);
      chain<32, P, 1, 0, 0, true>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    case 2:
      wgmma_fence();
      chain<64, P, 2, 0, 0, RACC>(r, ra, rb);
      chain<32, P, 2, 0, 0, true>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    case 3:
      wgmma_fence();
      chain<64, P, 3, 0, 0, RACC>(r, ra, rb);
      chain<32, P, 3, 0, 0, true>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
    default:
      wgmma_fence();
      chain<64, P, 4, 0, 0, RACC>(r, ra, rb);
      chain<32, P, 4, 0, 0, true>(d, da, db);
      wgmma_commit();
      wgmma_wait<0>();
      break;
  }
  fence_regs(r);
  fence_regs(d);
}

// ---- the producer's own loads ----

// Rows of a bf16 source of P planes (`plane` elements apart; rows of D
// elements) that a stage takes: rows row0 .. of each plane, read where 0 <=
// row < limit, else zero; with clip, rows clamped into [0, limit) instead, so
// that the table's end rows repeat
struct Seg {
  const __nv_bfloat16* src;
  size_t plane;
  int row0, limit;
  bool clip;
};

// NSEG segments of ROWS rows (ld elements apart; segment s at dst + s * ROWS
// * 128, plane p PLANE bytes on), columns col0 .. col0 + 63 (zero past D),
// swizzled, where ld is odd (a row is no whole number of 4 bytes, so no
// cp.async takes it):
// loaded and stored here, 2 bytes at a time, by the 128 threads of the
// producer warpgroup, a plane of one segment a batch, its loads in flight
// before the first store
template <int ROWS, int NSEG, int P>
__device__ __forceinline__ void load_u16(uint32_t dst, const Seg (&seg)[NSEG], int D, int ld, int col0,
                                         int ptid) {
  constexpr int PER = ROWS * CH / 128;
  ptid = opaque_i(ptid);
  const int r0 = ptid / CH, k = ptid % CH;  // this thread's first row and its column
  const bool col_ok = col0 + k < D;
#pragma unroll
  for (int sp = 0; sp < NSEG * P; ++sp) {
    const int sn = sp % NSEG, pn = sp / NSEG;
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(seg[sn].src + pn * seg[sn].plane + col0 + k);
    unsigned short x[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int row = seg[sn].row0 + r0 + 2 * i;
      if (seg[sn].clip) row = min(max(row, 0), seg[sn].limit - 1);
      x[i] = col_ok && row >= 0 && row < seg[sn].limit ? __ldg(src + static_cast<size_t>(row) * ld) : 0;
    }
    const uint32_t d = dst + sn * ROWS * 128 + pn * PLANE;
#pragma unroll
    for (int i = 0; i < PER; ++i) st_shared_u16(d + swz<128>((r0 + 2 * i) * 128 + 2 * k), x[i]);
  }
}

// The same rows by cp.async of VW * 2 bytes (VW 2, 4 or 8), zero-filled
// where a load is invalid: the copies land while the producer goes on (one
// commit group a stage, committed by the caller), and the stage is published
// once they are done (publish_stage)
template <int VW, int ROWS, int NSEG, int P>
__device__ __forceinline__ void async_load(uint32_t dst, const Seg (&seg)[NSEG], int D, int ld, int col0,
                                           int ptid) {
  constexpr int GR = CH / VW, PER = ROWS * GR / 128;
  constexpr int RSTEP = 128 / GR;  // rows between a thread's loads
  ptid = opaque_i(ptid);
  // this thread's first row and its column, the same for every row it loads
  const int r0 = ptid / GR, k = (ptid % GR) * VW;
  const bool col_ok = col0 + k < D;
#pragma unroll
  for (int sp = 0; sp < NSEG * P; ++sp) {
    const int sn = sp % NSEG, pn = sp / NSEG;
    const __nv_bfloat16* src = seg[sn].src + pn * seg[sn].plane + col0 + k;
    const uint32_t d = dst + sn * ROWS * 128 + pn * PLANE;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = r0 + RSTEP * i;
      int row = seg[sn].row0 + r;
      if (seg[sn].clip) row = min(max(row, 0), seg[sn].limit - 1);
      const bool ok = col_ok && row >= 0 && row < seg[sn].limit;
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d + swz<128>(r * 128 + 2 * k)),
                   "l"(ok ? src + static_cast<size_t>(row) * ld : src), "n"(2 * VW), "r"(ok ? 2 * VW : 0)
                   : "memory");
    }
  }
}

// own loads of a stage: asynchronous where a load is 4 bytes or more (true
// returned: the stage waits for publish_stage), else loaded and stored here
template <int ROWS, int NSEG, int P>
__device__ __forceinline__ bool own_load(int vw, uint32_t dst, const Seg (&seg)[NSEG], int D,
                                         int ld, int col0, int ptid) {
  if (vw == 8) {
    async_load<8, ROWS, NSEG, P>(dst, seg, D, ld, col0, ptid);
  } else if (vw == 4) {
    async_load<4, ROWS, NSEG, P>(dst, seg, D, ld, col0, ptid);
  } else if (vw == 2) {
    async_load<2, ROWS, NSEG, P>(dst, seg, D, ld, col0, ptid);
  } else {
    load_u16<ROWS, NSEG, P>(dst, seg, D, ld, col0, ptid);
    return false;
  }
  return true;
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- the ring ----

// The ring of stages: the producer fills them in order, both consumer
// warpgroups read every one (a warpgroup may only wait and release one it
// has no product on), and each is released in the order it was taken.
template <int STAGE, int N>
struct Ring {
  static constexpr int SLOTS = N;
  uint32_t stages, full, empty;
  int head = 0, tail = 0;
  __device__ __forceinline__ uint32_t acquire() {
    const int s = head % N;
    mbar_wait(full + 8 * s, (head / N) & 1);
    ++head;
    return stages + s * STAGE;
  }
  __device__ __forceinline__ void release() {
    mbar_arrive(empty + 8 * (tail % N));
    ++tail;
  }
  // producer: wait until the next stage is free; its address and full barrier
  __device__ __forceinline__ uint32_t begin() {
    mbar_wait(empty + 8 * (head % N), ((head / N) & 1) ^ 1);
    return stages + (head % N) * STAGE;
  }
  __device__ __forceinline__ uint32_t full_bar() const { return full + 8 * (head % N); }
  __device__ __forceinline__ void end() {
    fence_proxy_async();
    mbar_arrive(full + 8 * (head % N));
    ++head;
  }
};

// publish stage i of the ring (full barrier `full`) whose copies this
// thread's cp.async groups carry: wait until at most KEEP groups are in
// flight (the stages after it), make the landed rows visible to wgmma, arrive
template <int KEEP, int N>
__device__ __forceinline__ void publish_stage(uint32_t full, int i) {
  asm volatile("cp.async.wait_group %0;" ::"n"(KEEP) : "memory");
  fence_proxy_async();
  mbar_arrive(full + 8 * (i % N));
}

// a stage's full barrier counts the producer warpgroup, its empty barrier the consumers
__device__ __forceinline__ void init_bars(uint32_t full, uint32_t empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 128);
    mbar_init(empty + 8 * s, CONSUMERS);
  }
  mbar_fence_init();
}

// The producer's sources: plane 0 of q, k, v, g (the backward's output
// gradient) and the table, bf16 (fp32: the planes flash_rel_wide_split
// wrote), the elements a plane of each, and the elements a row (D, or the
// split's rows padded to a multiple of 8 columns, so that TMA takes them)
struct Planes {
  const __nv_bfloat16 *q, *k, *v, *g, *e;
  size_t q_plane, k_plane, e_plane;
  int ld;
};

// The producer warpgroup's stages, from bf16 sources of P planes: 64-row
// tiles of q, k, v and g by TMA (rows of D a multiple of 8) or by its own
// loads; windows of the table by TMA where no row is clipped, else gathered.
template <int P, typename R>
struct Producer {
  R ring;
  const CUtensorMap* map_e;
  const __nv_bfloat16* table;  // plane 0
  size_t table_plane;
  int D, ld, max_pos, vw, ptid, grp;
  bool tma;
  struct Src {
    const CUtensorMap* map;
    const __nv_bfloat16* rows;  // the group's rows, plane 0
    size_t plane;
    int limit;
  };

  // A stage of own loads in flight is published when the next stage of own
  // loads has been issued (so that two are in flight), or before a TMA stage,
  // or at the end: never more than one behind, so the ring never waits on it.
  int pending = -1;  // that stage's index in the ring, or -1
  __device__ __forceinline__ void settle() {
    if (pending >= 0) publish_stage<0, R::SLOTS>(ring.full, pending);
    pending = -1;
  }
  // after a stage's own loads: publish the last pending stage, this one pends
  // (async) or is published now
  __device__ __forceinline__ void after_own(bool async) {
    if (async) {
      asm volatile("cp.async.commit_group;" ::: "memory");  // the stage's copies, one group
      if (pending >= 0) publish_stage<1, R::SLOTS>(ring.full, pending);
      pending = ring.head++;
    } else {
      settle();
      ring.end();
    }
  }

  // x0's rows r0, columns col0 .. col0 + 63, as the stage's tile 0; x1's rows
  // r1, columns col1 .. (none where col1 < 0) as its tile 1
  __device__ __forceinline__ void pair(const Src& x0, int r0, int col0, const Src& x1, int r1, int col1) {
    if (tma) {
      settle();
      const uint32_t st = ring.begin(), bar = ring.full_bar();
      if (ptid == 0) {
        mbar_expect_tx(bar, (col1 >= 0 ? 2 : 1) * P * TILE);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load_4d(st + p * PLANE, x0.map, bar, col0, r0, grp, p);
          if (col1 >= 0) tma_load_4d(st + TILE + p * PLANE, x1.map, bar, col1, r1, grp, p);
        }
      }
      ring.end();
      return;
    }
    const uint32_t st = ring.begin();
    bool async;
    if (col0 == col1) {
      const Seg seg[2] = {{x0.rows, x0.plane, r0, x0.limit, false},
                          {x1.rows, x1.plane, r1, x1.limit, false}};
      async = own_load<64, 2, P>(vw, st, seg, D, ld, col0, ptid);
    } else {
      const Seg s0[1] = {{x0.rows, x0.plane, r0, x0.limit, false}};
      async = own_load<64, 1, P>(vw, st, s0, D, ld, col0, ptid);
      if (col1 >= 0) {
        const Seg s1[1] = {{x1.rows, x1.plane, r1, x1.limit, false}};
        own_load<64, 1, P>(vw, st + TILE, s1, D, ld, col1, ptid);
      }
    }
    after_own(async);
  }
  // the 128 window rows from table row row0 (clipped rows repeat the ends), columns col ..
  __device__ __forceinline__ void window(int row0, int col) {
    if (tma && row0 >= 0 && row0 + 127 <= 2 * max_pos) {
      settle();
      const uint32_t st = ring.begin(), bar = ring.full_bar();
      if (ptid == 0) {
        mbar_expect_tx(bar, P * PLANE);
#pragma unroll
        for (int p = 0; p < P; ++p) tma_load_3d(st + p * PLANE, map_e, bar, col, row0, p);
      }
      ring.end();
      return;
    }
    const uint32_t st = ring.begin();
    const Seg seg[1] = {{table, table_plane, row0, 2 * max_pos + 1, true}};
    after_own(own_load<128, 1, P>(vw, st, seg, D, ld, col, ptid));
  }
};

template <int P, typename R>
__device__ __forceinline__ void init_producer(Producer<P, R>& pr, uint32_t base, uint32_t full,
                                              uint32_t empty, const CUtensorMap* map_e,
                                              const Planes& pl, int D, int max_pos, int vw,
                                              int tma, int ptid) {
  pr.ring.stages = base;
  pr.ring.full = full;
  pr.ring.empty = empty;
  pr.map_e = map_e;
  pr.table = pl.e;
  pr.table_plane = pl.e_plane;
  pr.D = D, pr.ld = pl.ld, pr.max_pos = max_pos, pr.vw = vw, pr.ptid = ptid;
  pr.tma = tma != 0;
}

// ---- the consumers' shared steps ----

// A consumer thread's place: warpgroup w, warp wp of it, lane (g, t4)
struct Lane {
  int w, wp, g, t4;
};

// the same place, which the compiler may not take for loop-invariant: the
// many indices and shared addresses made from it are made where they are
// used, a phase at a time, not held in registers (or spilled) over the walk
__device__ __forceinline__ Lane fresh(const Lane& l) {
  return {opaque_i(l.w), opaque_i(l.wp), opaque_i(l.g), opaque_i(l.t4)};
}

// R (64 x 64: rows a, columns 64w + 8n + 2t4 + e of the window) into the
// band at [a][c - a] where c - a is in [0, 64): stored (first chunk) or added.
// The cells a thread adds to are all read before any is written: a load
// ordered behind a store to a cell the compiler cannot tell apart would wait
// for it, a chain of 16 round trips a chunk.
__device__ __forceinline__ void band_put(float* band, const Lane& l0, const float (&r)[32], bool first) {
  const Lane l = fresh(l0);
  float old[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) old[i] = 0.f;
  if (!first) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int a = 16 * l.wp + l.g + 8 * rr;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 64 * l.w + 8 * n + 2 * l.t4 + e - a;
          if (x >= 0 && x < 64) old[4 * n + 2 * rr + e] = band[a * SKS + x];
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int a = 16 * l.wp + l.g + 8 * rr;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 64 * l.w + 8 * n + 2 * l.t4 + e - a;
        const int i = 4 * n + 2 * rr + e;
        if (x >= 0 && x < 64) band[a * SKS + x] = first ? r[i] : old[i] + r[i];
      }
    }
  }
}

// s (+)= t
template <int R>
__device__ __forceinline__ void add_into(float (&s)[R], const float (&t)[R], bool first) {
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = first ? t[i] : s[i] + t[i];
}

// the bf16 parts of two neighbouring values
template <int P>
__device__ __forceinline__ void parts_of(float x, float y, uint32_t (&u)[P]) {
  if constexpr (P == 1) {
    u[0] = pack_bf16(x, y);
  } else {
    split3(x, y, u);
  }
}

// ---- fp32 split once into three bf16 planes ----

// fp32 rows split into three bf16 planes, x = x0 + x1 + x2, for the
// producers' loads (TMA cannot split); tensor blockIdx.y of the N given:
// rows[t] rows of `cols` elements into rows of `ld` (cols or more, the
// columns past cols zero), its planes `plane[t]` elements apart
struct Split {
  const float* src[5];
  __nv_bfloat16* dst[5];
  long long rows[5], plane[5];
  int cols, ld;
};
template <int N>
__global__ void flash_rel_wide_split(const Split s) {
  const int t = blockIdx.y;
  const float* src = s.src[t];
  __nv_bfloat16* dst = s.dst[t];
  const long long n = s.rows[t] * s.ld, plane = s.plane[t];
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long e = 4LL * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x); e < n;
       e += step) {
    float x[4];
    if (s.ld == s.cols && e + 4 <= n) {
      const float4 y = __ldg(reinterpret_cast<const float4*>(src + e));
      x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
    } else {
      const long long r = e / s.ld;
      const int c = static_cast<int>(e % s.ld);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // unpadded rows: element e + i of the whole; padded: whole groups of 4 a row
        x[i] = s.ld == s.cols ? (e + i < n ? src[e + i] : 0.f)
                              : (c + i < s.cols ? src[r * s.cols + c + i] : 0.f);
      }
    }
    uint32_t lo[3], hi[3];
    split3(x[0], x[1], lo);
    split3(x[2], x[3], hi);
    if (e + 4 <= n) {
#pragma unroll
      for (int p = 0; p < 3; ++p) *reinterpret_cast<uint2*>(dst + p * plane + e) = make_uint2(lo[p], hi[p]);
    } else {
      for (long long i = e; i < n; ++i) {  // the last elements of unpadded rows
        const int j = static_cast<int>(i - e);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint32_t pair = j < 2 ? lo[p] : hi[p];
          *reinterpret_cast<unsigned short*>(dst + p * plane + i) =
              static_cast<unsigned short>(pair >> (16 * (j & 1)));
        }
      }
    }
  }
}

__host__ __device__ constexpr long long round_up(long long x, long long m) { return (x + m - 1) / m * m; }

// Launch the split of the first N tensors of s.
template <int N>
int split_planes(const Split& s, cudaStream_t stream) {
  long long most = 0;
  for (int t = 0; t < N; ++t) most = s.rows[t] > most ? s.rows[t] : most;
  const long long blocks = most * s.ld / 4 / 256 + 1;
  flash_rel_wide_split<N><<<dim3(static_cast<unsigned>(blocks < 2048 ? blocks : 2048), N), 256, 0, stream>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// ---- host ----

// persistent blocks, at most one an SM, block b taking units b, b + grid, ...:
// a grid with no factor in common with the units a group, so that no block
// takes only one tile position
inline int persistent_grid(long long per_group, long long n_units, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = sms;
  while (blocks > 1 && std::gcd(static_cast<long long>(blocks), per_group) != 1) --blocks;
  *grid = static_cast<int>(n_units < blocks ? n_units : blocks);
  return *grid >= 1 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A map of a bf16 tensor of `rank` dims (innermost first; rows of 128 bytes
// a box, `strides` in bytes for dims 1 ..), boxes of `box`, in the 128-byte
// swizzle; elements outside the tensor read as zero. 0, or a CUDA error code.
inline int make_map_n(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of the producers' sources (P planes): m[0 .. 4] for q, g,
// k, v [P][G][T][D] (rows pl.ld apart) in boxes of 64 rows of one chunk and
// one plane, and the table [P][rows][D] in boxes of 128 rows; g's only where
// pl.g is set. The bf16 planes' sizes are the tensors' own.
inline int make_maps(const Planes& pl, int P, int G, int Tq, int Tk, int D, int max_pos, CUtensorMap* m) {
  const cuuint64_t row = 2ull * pl.ld, d = static_cast<cuuint64_t>(D);
  const cuuint64_t rows = static_cast<cuuint64_t>(2 * max_pos + 1);
  const cuuint64_t g = static_cast<cuuint64_t>(G), planes = static_cast<cuuint64_t>(P);
  const cuuint64_t dq[4] = {d, static_cast<cuuint64_t>(Tq), g, planes};
  const cuuint64_t dk[4] = {d, static_cast<cuuint64_t>(Tk), g, planes};
  const cuuint64_t de[3] = {d, rows, planes};
  const cuuint64_t sq[3] = {row, row * Tq, 2ull * (P > 1 ? pl.q_plane : static_cast<size_t>(G) * Tq * D)};
  const cuuint64_t sk[3] = {row, row * Tk, 2ull * (P > 1 ? pl.k_plane : static_cast<size_t>(G) * Tk * D)};
  const cuuint64_t se[2] = {row, 2ull * (P > 1 ? pl.e_plane : rows * D)};
  const cuuint32_t box[4] = {CH, 64, 1, 1}, be[3] = {CH, 128, 1};
  int rc = make_map_n(&m[0], pl.q, 4, dq, sq, box);
  if (rc == 0 && pl.g != nullptr) rc = make_map_n(&m[1], pl.g, 4, dq, sq, box);
  if (rc == 0) rc = make_map_n(&m[2], pl.k, 4, dk, sk, box);
  if (rc == 0) rc = make_map_n(&m[3], pl.v, 4, dk, sk, box);
  if (rc == 0) rc = make_map_n(&m[4], pl.e, 3, de, se, be);
  return rc;
}

// bf16 elements a load of the producer's own: the widest that divides a row
inline int load_width(int D) { return D % 8 == 0 ? 8 : D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1; }

}  // namespace wide

}  // namespace hopper
}  // namespace flash_rel
