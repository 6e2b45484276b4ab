// Hopper building blocks of the attention kernels (flash_rel_attention.cu,
// the forward, and flash_rel_attention_bwd.cu, the backward), written as
// inline PTX so that nvcc builds each library in seconds: no CUTLASS or CuTe
// header.
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

}  // namespace hopper
}  // namespace flash_rel
