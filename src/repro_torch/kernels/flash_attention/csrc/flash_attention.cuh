// Helpers shared by the flash attention forward (K5, flash_attention.cu) and
// its backward (K5b, flash_attention_bwd.cu): the mask's tile walk, the
// CUDA-core tile loads and the tensor-core building blocks (cp.async,
// ldmatrix, mma.sync m16n8k16 bf16 -> float32, P in two bf16 terms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The kv tiles [t_beg, t_end) of `block_k` keys that rows q0 .. q0 +
// block_q - 1 can see (none is wholly masked for every row of the tile).
// P: any struct with Sq, Skv, causal and window.
template <class P>
__device__ __forceinline__ void kv_tile_range(const P& p, int q0, int block_q,
                                              int block_k, int& t_beg, int& t_end) {
  const int off = p.Skv - p.Sq;
  const int first = q0 + off;                             // first row's position
  const int last = min(q0 + block_q, p.Sq) - 1 + off;    // last row's position
  const int kend = p.causal ? min(p.Skv, last + 1) : p.Skv;
  const int kbeg = p.window > 0 ? max(0, first - p.window + 1) : 0;
  t_beg = kbeg / block_k;
  t_end = (kend + block_k - 1) / block_k;
}

// The transpose (K5b's walk over q): the q tiles [t_beg, t_end) of `block_q`
// rows that can see some key of k0 .. k0 + block_k - 1. Key t is visible
// from row i when i >= t - off (causal) and i < t - off + window (window).
template <class P>
__device__ __forceinline__ void q_tile_range(const P& p, int k0, int block_k,
                                             int block_q, int& t_beg, int& t_end) {
  const int off = p.Skv - p.Sq;
  const int k_last = min(k0 + block_k, p.Skv) - 1;
  const int ibeg = p.causal ? max(0, k0 - off) : 0;
  const int iend = p.window > 0 ? min(p.Sq, k_last - off + p.window) : p.Sq;
  t_beg = ibeg / block_q;
  t_end = iend > ibeg ? (iend + block_q - 1) / block_q : t_beg;
}

// Whether some (row, key) pair of the q tile at q0 and the kv tile at k0 is
// masked (rows past Sq count as rows: the forward never stores them).
template <class P>
__device__ __forceinline__ bool tile_needs_mask(const P& p, int q0, int k0,
                                                int block_q, int block_k) {
  const int off = p.Skv - p.Sq;
  return k0 + block_k > p.Skv || (p.causal && k0 + block_k - 1 > q0 + off) ||
         (p.window > 0 && k0 <= q0 + block_q - 1 + off - p.window);
}

// Key kpos visible from the query at position qpos (row + Skv - Sq).
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// ===========================================================================
// float32 on the CUDA cores: 64-row tiles, 256 threads
// ===========================================================================
constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLP = kTile + 4;  // padded row of a probability tile

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// Rows row0 .. row0 + 63 of a (seq, D) slice with row stride `ss` into
// dst[r * ld + c] times `mul`; rows at or past `rows` are zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long ss, int row0, int rows,
                                          int D, int ld, float mul) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < rows) load4(base + static_cast<long long>(row0 + r) * ss + c, v);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ===========================================================================
// bfloat16 on the tensor cores
// ===========================================================================
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes from global to shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x by the SFU (relative error ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
// What rounding x to bf16 leaves out (exact in float32).
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

// The A fragments (16 rows x 16 columns, k-step kk) of a matrix held in
// m16n8 accumulator fragments s[j] (columns 8 j .. 8 j + 7), in two bf16
// terms: a its rounding, r the rest (the accumulator's layout is the A
// fragment's, so no data moves between lanes).
__device__ __forceinline__ void to_a_frags(float (*s)[4], int kk, uint32_t* a,
                                           uint32_t* r) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  r[0] = pack_bf16(bf16_rest(s[2 * kk][0]), bf16_rest(s[2 * kk][1]));
  r[1] = pack_bf16(bf16_rest(s[2 * kk][2]), bf16_rest(s[2 * kk][3]));
  r[2] = pack_bf16(bf16_rest(s[2 * kk + 1][0]), bf16_rest(s[2 * kk + 1][1]));
  r[3] = pack_bf16(bf16_rest(s[2 * kk + 1][2]), bf16_rest(s[2 * kk + 1][3]));
}

// Rows row0 .. row0 + nrows - 1, columns 0 .. D16 - 1 of a (seq, D) bf16
// slice with row stride `ss`, into dst[r * LDS + c] by cp.async; rows at or
// past `rows` and columns at or past D are zero-filled.
template <int LDS, int kThreadsPerBlock>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* base,
                                                long long ss, int row0, int rows,
                                                int nrows, int D, int D16) {
  const int chunks = D16 / 8;  // 16-byte pieces of a row
  for (int i = threadIdx.x; i < nrows * chunks; i += kThreadsPerBlock) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    const bool valid = row0 + r < rows && c < D;
    const bf16* src = valid ? base + static_cast<long long>(row0 + r) * ss + c : base;
    cp_async16(smem_addr(dst + r * LDS + c), src, valid);
  }
}

}  // namespace
