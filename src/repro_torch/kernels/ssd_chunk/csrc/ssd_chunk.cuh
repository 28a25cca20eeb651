// Device pieces shared by the SSD chunk scan (ssd_chunk.cu, K6) and its
// backward (ssd_chunk_bwd.cu, K6b): the launch parameters, the bfloat16
// tile helpers (cp.async, ldmatrix, mma.sync m16n8k16, the two-term
// split), the chunk's inclusive sum of dt a, and K6's pass 1 (each chunk's
// own end state), which the backward launches on dy and C for the state
// cotangents (writing its chunk table). ssd_chunk.cu's head comment
// describes the passes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  int B, S, H, G, P, N;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
  long long dt_sb, dt_ss, dt_sh;
};

constexpr int kMaxP = 64;

// ===========================================================================
// bfloat16: the chunk-parallel tensor-core kernels
// ===========================================================================
using bf16 = __nv_bfloat16;
constexpr int kQc = 128;        // chunk length
constexpr int kHT = 8;          // heads per pass-3 block (the last tile of a group may have fewer)
constexpr int kStateThreads = 256;
constexpr int kOutThreads = 256;
constexpr int kPassThreads = 128;
constexpr int kPassE = 2;        // state entries per pass-2 thread
constexpr int kPassUnroll = 16;  // chunks a pass-2 thread prefetches
static_assert(kPassE == 2, "pass 2 moves its entries as float2 and bf16 pairs");
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kOutMinBlocks = 2;  // pass-3 blocks per SM (registers <= 128)
// The backward's chunk table, per (batch, chunk, head): cum (log2 units) and
// dt of the chunk's kQc steps, then the reverse pass's kDotParts partial
// sums of <g, s_in> (ssd_chunk_bwd.cu).
constexpr int kDotParts = 32;
constexpr int kTab = 2 * kQc + kDotParts;

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
// The pair (v0, v1) as two bf16 pairs: its rounding and the rest.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  lo = pack_bf16(bf16_rest(v0), bf16_rest(v1));
}

// Rows 0 .. nrows - 1, columns 0 .. cols16 - 1 of a bf16 slice with row
// stride `ss` into dst[r * ld + c]; rows at or past `rows` and columns at or
// past `cols` are zeros. vec: 16-byte cp.async (cols a multiple of 8, the
// slice and its stride 16-byte aligned); else element loads.
template <int kT>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* base,
                                          long long ss, int rows, int nrows,
                                          int cols, int cols16, bool vec) {
  if (vec) {
    const int per = cols16 / 8;
    for (int i = threadIdx.x; i < nrows * per; i += kT) {
      const int r = i / per, c = (i - r * per) * 8;
      const bool valid = r < rows && c < cols;
      cp_async16(smem_addr(dst + r * ld + c), valid ? base + r * ss + c : base, valid);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < nrows * cols16; i += kT) {
      const int r = i / cols16, c = i - r * cols16;
      dst[r * ld + c] = r < rows && c < cols ? base[r * ss + c] : zero;
    }
  }
}

// One warp: the inclusive sum of dt a over a chunk's kQc rows (lane l owns
// rows 4l .. 4l + 3; rows at or past `rows` have dt = 0), stored times
// log2(e) in cum2, dt in dts and, when vt is given, vt[j] = exp2(c_r - c_j)
// dt_j with r the last row of j's 16-row tile (c_r <= c_j: at most 1).
// Returns the chunk's total times log2(e).
__device__ __forceinline__ float chunk_cumsum(const float* dtb, long long dt_ss,
                                              int rows, float ah, float* cum2,
                                              float* dts, float* vt, int lane) {
  float d[4], c[4], run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    d[e] = r < rows ? dtb[r * dt_ss] : 0.f;
    run += d[e] * ah;
    c[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float excl = incl - run;
  // the last row of this lane's 16-row tile is lane 4 (l / 4) + 3's last
  const float tile_end = __shfl_sync(0xffffffffu, incl, lane | 3) * kLog2e;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float c2 = (excl + c[e]) * kLog2e;
    cum2[4 * lane + e] = c2;
    dts[4 * lane + e] = d[e];
    if (vt != nullptr) vt[4 * lane + e] = fast_exp2(tile_end - c2) * d[e];
  }
  return __shfl_sync(0xffffffffu, incl, 31) * kLog2e;
}

// Pass 1: one block per (chunk, head, batch), 8 warps (below).
// local[p, n] = sum_j (wk_j x_j[p]) B_j[n]. With kCot (the backward's
// state cotangents, ssd_chunk_bwd.cu) the same product of dy and C with
// wk_i = exp(cum_i): D[p, n] = sum_i exp(cum_i) dy_i[p] C_i[n] (x and B
// are then dy and C, with their strides in p), and `dec` is the chunk
// table (B, nc, H, kTab) float32 instead: the chunk's cum (log2 units)
// into its entries 0 .. kQc - 1 and dt into kQc .. 2 kQc - 1.
template <int NB, bool kCot = false>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const bf16* __restrict__ Bm,
                       float* __restrict__ st, float* __restrict__ dec, Params p,
                       int nc, int vec) {
  constexpr int LDX = kMaxP + 8, LDB = NB + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // kQc x LDX
  bf16* bs = xs + kQc * LDX;                     // kQc x LDB
  float* cum2 = reinterpret_cast<float*>(bs + kQc * LDB);  // kQc
  float* wk = cum2 + kQc;                                  // kQc: dt, then wk

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kQc, rows = min(kQc, p.S - t0);
  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;

  load_rows<kStateThreads>(xs, LDX, x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh,
                           p.x_ss, rows, kQc, p.P, P16, vec);
  load_rows<kStateThreads>(bs, LDB, Bm + b * p.b_sb + t0 * p.b_ss + g * p.b_sg,
                           p.b_ss, rows, kQc, p.N, N16, vec);
  cp_async_commit();
  if (warp == 0) {
    const float end = chunk_cumsum(dt + b * p.dt_sb + t0 * p.dt_ss + h * p.dt_sh,
                                   p.dt_ss, rows, a[h], cum2, wk, nullptr, lane);
    if (kCot) {
      float* tab = dec + ((static_cast<long long>(b) * nc + c) * p.H + h) * kTab;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tab[4 * lane + e] = cum2[4 * lane + e];
        tab[kQc + 4 * lane + e] = wk[4 * lane + e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // wk_j = exp(cum_end - cum_j) dt_j
      const int r = 4 * lane + e;
      wk[r] = kCot ? fast_exp2(cum2[r]) : wk[r] * fast_exp2(end - cum2[r]);
    }
    if (!kCot && lane == 0)
      dec[(static_cast<long long>(b) * nc + c) * p.H + h] = fast_exp2(end);
  }
  cp_async_wait<0>();
  __syncthreads();
  // Warp w: state rows 16 pw .. 16 pw + 15, n16 steps [nh NPH, (nh + 1) NPH)
  // (N split in halves from N16 = 32 on).
  constexpr int kHalves = NB >= 32 ? 2 : 1;
  constexpr int NPH = NB / 16 / kHalves;
  const int pw = warp & 3, nh = warp >> 2;
  if (16 * pw >= P16 || nh >= kHalves) return;

  const int g8 = lane >> 2, t4 = lane & 3;
  float acc[2 * NPH][4];
#pragma unroll
  for (int n = 0; n < 2 * NPH; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kQc / 16; ++kk) {
    // A = x^T (rows p, columns j), by ldmatrix.trans of x's (j, p) rows,
    // each entry times wk_j and split into two bf16 terms.
    uint32_t xf[4], ah[4], al[4];
    ldmatrix_x4_trans(xf, smem_addr(xs + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * LDX +
                                    16 * pw + 8 * ((lane >> 3) & 1)));
    const int j0 = 16 * kk + 2 * t4;
    const float w0 = wk[j0], w1 = wk[j0 + 1], w8 = wk[j0 + 8], w9 = wk[j0 + 9];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xf[r]));
      const float wa = r < 2 ? w0 : w8, wb = r < 2 ? w1 : w9;
      split2(v.x * wa, v.y * wb, ah[r], al[r]);
    }
#pragma unroll
    for (int np = 0; np < NPH; ++np) {
      const int n16 = nh * NPH + np;
      if (16 * n16 >= N16) continue;
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, smem_addr(bs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                                       16 * n16 + 8 * (lane >> 4)));
      mma_bf16(acc[2 * np], ah, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], ah, bfr[2], bfr[3]);
      mma_bf16(acc[2 * np], al, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], al, bfr[2], bfr[3]);
    }
  }
  float* so = st + ((static_cast<long long>(b) * nc + c) * p.H + h) * P16 * N16;
  const int p0 = 16 * pw + g8;
#pragma unroll
  for (int n = 0; n < 2 * NPH; ++n) {
    const int col = 16 * nh * NPH + 8 * n + 2 * t4;
    if (col >= N16) continue;
    *reinterpret_cast<float2*>(so + p0 * N16 + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(so + (p0 + 8) * N16 + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

template <int NB>
size_t state_smem() {
  return sizeof(bf16) * kQc * (kMaxP + 8 + NB + 8) + 2 * sizeof(float) * kQc;
}

}  // namespace
