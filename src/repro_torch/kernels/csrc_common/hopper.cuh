// Hopper (sm_90a) building blocks shared by the bfloat16 paths of K5b
// (flash_attention/csrc/flash_attention_bwd.cu) and K6b
// (ssd_chunk/csrc/ssd_chunk_bwd.cu), in inline PTX: mbarriers, TMA tile loads
// and bulk copies into shared memory, descriptors of 128-byte-swizzled
// operand tiles, and the warpgroup products (wgmma) they issue. Every source
// of the port has this directory on its include path (kernels/_build.py).
//
// Operand tiles. A TMA box of 64 bf16 columns (128 bytes) by R rows with
// CU_TENSOR_MAP_SWIZZLE_128B lands as R rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8): the "swizzle atom" is 8 rows,
// 1,024 bytes, and a tile's base must be 1,024-byte aligned. A D = 128 row
// is two such tiles (columns 0-63 and 64-127), each its own region. wgmma
// reads such a region two ways:
//   * K-major (the operand's 16-wide k-step runs along the row): the
//     k-step's 32 bytes start at base + 32 kk inside the atom; stride byte
//     offset 1,024 (the next 8 rows); the leading offset is unused.
//   * MN-major (the operand's k-step runs down 16 rows, its N columns along
//     the row): start base + 16 kk * 128; stride byte offset 1,024 (the next
//     8 rows along K); leading byte offset the distance to the region that
//     holds the next 64 columns along N.

#pragma once

#include <cuda.h>  // CUtensorMap (the driver API is reached through the runtime)
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// mbarriers (shared::cta addresses)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Make the initialised barriers visible to the async proxy (TMA) as well.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that polls
// 2^26 times (seconds; the kernels' waits last microseconds) traps: a fault in
// the barrier protocol fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA and bulk copies, completing on an mbarrier
// ---------------------------------------------------------------------------
// The box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at `dst` (out-of-bounds elements land as zeros).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes from 16-byte aligned `src`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The byte offset of the 16-byte chunk `chunk` (0 .. 7) of row `row` in a
// 128-byte-swizzled region (rows of 128 bytes from a 1,024-byte aligned
// base), for reads and writes of such a tile by ordinary loads, stores and
// ldmatrix.
__device__ __forceinline__ uint32_t sw128_at(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// A wgmma descriptor of a 128-byte-swizzled operand in two words: the low
// word holds the start address (16-byte units) and the leading byte offset
// `lead`, the high word the stride byte offset `stride` and the swizzle mode.
__device__ __forceinline__ uint32_t sw128_lo(uint32_t addr, uint32_t lead) {
  return ((addr & 0x3FFFF) >> 4) | (lead >> 4) << 16;
}
__device__ __forceinline__ uint32_t sw128_hi(uint32_t stride) {
  return (stride >> 4) | 1u << 30;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that a product in flight reads or writes: their reads and
// writes around the fence stay on their side of it (accumulators after a
// wait; register A operands, kept alive until the product has read them).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, float32) = (scale_d ? d : 0) + A B^T: A (64 x 16) and B (64 x 16)
// from shared memory, both K-major, by descriptors whose low words are
// a_lo + a_off and b_lo + b_off (offsets in 16-byte units) and whose high
// word is `hi`; the sums are formed inside the instruction's block, so no
// descriptor is held in registers across the walk.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint32_t a_lo, uint32_t a_off,
                                             uint32_t b_lo, uint32_t b_off, uint32_t hi,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 alo, blo;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 alo, %32, %33;\nadd.u32 blo, %34, %35;\n"
      "mov.b64 da, {alo, %36};\nmov.b64 db, {blo, %36};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(a_off), "r"(b_lo), "r"(b_off), "r"(hi), "r"(scale_d));
}

// d (64 x 64, float32) += A B: A (64 x 16, bf16) from registers in the
// m16n8k16 A fragment layout (warp w: rows 16 w ..), B (16 x 64) from shared
// memory, MN-major (its rows along K: imm-trans-b 1), by the descriptor
// (b_lo + b_off, hi) as above.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint32_t b_lo, uint32_t b_off, uint32_t hi) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 blo;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %39, 0;\n"
      "add.u32 blo, %36, %37;\nmov.b64 db, {blo, %38};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(b_off), "r"(hi),
        "r"(1));
}

// d (64 x 128, float32) += A B: A (64 x 16, bf16) from registers in the
// m16n8k16 A fragment layout (warp w: rows 16 w ..), B (16 x 128) from shared
// memory, MN-major (its rows along K: imm-trans-b 1), by the descriptor
// (b_lo + b_off, hi) as above.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint32_t b_lo, uint32_t b_off, uint32_t hi) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 blo;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %71, 0;\n"
      "add.u32 blo, %68, %69;\nmov.b64 db, {blo, %70};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(b_off), "r"(hi),
        "r"(1));
}

}  // namespace
