// Backward of the Mamba2 SSD chunk scan (K6b), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its model's plain
// chunked scan (repro/models/lm/layers.py:580 `ssd_mix`) with JAX's
// autodiff, and its Pallas kernel (repro/kernels/ssd_chunk) is forward
// only. This is the gradient of K6 (ssd_chunk.cu) for training the ssm and
// hybrid families on the card, as K3b and K5b are for K3 and K5. Its plain
// version, kernels/ssd_chunk/ref.py `ssd_chunk_bwd_ref`, writes out the
// same formulas.
//
// Per (batch b, head h of group g), chunks of Q steps (the last padded with
// dt = 0), cum the inclusive sum of dt a within a chunk, L_ij = exp(cum_i -
// cum_j) for i >= j, e_j = exp(cum_end - cum_j), s_in,c the state entering
// chunk c and g_c+1 the cotangent of chunk c's end state:
//   g_nc = dstate (or 0); g_c = exp(cum_end,c) g_c+1 + D_c,
//   D_c = sum_i exp(cum_i) dy_i (x) C_i;
//   dx_j = sum_i>=j (C_i . B_j) L_ij dt_j dy_i + e_j dt_j g B_j;
//   dB_j = sum over the group's heads of sum_i>=j (dy_i . x_j) L_ij dt_j C_i
//          + e_j dt_j g^T x_j;
//   dC_i = sum over the group's heads of sum_j<=i (dy_i . x_j) L_ij dt_j B_j
//          + exp(cum_i) s_in^T dy_i;
//   with K_ij = (C_i . B_j) L_ij (dy_i . x_j), ddt_j = sum_i K_ij + e_j x_j .
//   (g B_j) + a d(dt a)_j, where dcum_i = sum_j<i K_ij dt_j - dt_i sum_i'>i
//   K_i'i + exp(cum_i) dy_i . (s_in C_i) - e_i dt_i x_i . (g B_i) (K's
//   diagonal cancels, and is left out of both sums: under steep decay it
//   dominates them, and the difference would keep only its rounding), the
//   chunk's last step also taking sum_j e_j dt_j x_j . (g B_j) + exp(cum_end)
//   <g, s_in>, and d(dt a) is dcum's reverse inclusive sum within the chunk;
//   da_h = sum over batch and steps of dt d(dt a).
//
//   In: x, dy (B, S, H, P), Bm, Cm (B, S, G, N), all float32 or all
//   bfloat16, read through their strides (unit stride along P and N); dt
//   (B, S, H) float32 through its strides, a (H,) float32, the final
//   state's cotangent (B, H, P, N) float32 contiguous or null; bfloat16
//   only, K6's own chunk states (its scratch after pass 2, split into [8 x
//   hi | 8 x lo] groups) and chunk decays, kept by the autograd Function
//   from the forward that the backward follows. Out, all
//   contiguous: dx (B, S, H, P), dB, dC (B, S, G, N) in the inputs' dtype,
//   ddt (B, S, H) and da (H,) float32.
//
// What bounds it: the bytes of x, dy, B, C, dt read once and of dx, dB,
// dC, ddt written once: 325 MB at mamba2's training shape (B = 4, S =
// 4,096, H = 48, P = 64, N = 128, G = 1, bf16) and 323 MB at hymba's (H =
// 50, N = 16), about 0.097 ms over 3.35 TB/s; the recurrence's backward,
// 8 P N operations per step and head (two outer products and two
// state-vector products), takes 0.052 ms at mamba2 at the bf16 tensor rate.
// Any chunked form adds its Q x Q products (~22 MFLOP per (batch, chunk,
// head) at mamba2, ~0.15 ms at the tensor rate) and the state scratch
// between its passes.
//
// bfloat16 inputs, chunks of Q = 128 (K6's), on one stream:
//   1.   K6's pass 1 (ssd_chunk.cuh) again, with dy and C for x and B and
//        exp(cum_i) for its weights: D_c into the scratch `cotan` (B, nc,
//        H, P16, N16) float32, and each (batch, chunk, head)'s cum and dt
//        into the chunk table (B, nc, H, kTab) float32.
//   2.   `ssd_state_rpass_kernel`: the reverse state pass, sequential over
//        chunks only, two state entries a thread: g_c+1 in float32 in
//        registers, written rounded to bf16 into the image `g`, s_in,c's
//        hi terms into the image `s` (both (B, nc, H, P16, N16) bf16, read
//        by TMA below), and the block's share of <g_c+1, s_in,c> (s_in as
//        hi + lo, g in float32) into the chunk table.
//   3.   `ssd_bwd_chunk_kernel`: one block of two warpgroups per (chunk,
//        tile of heads of one group, batch); the plan (kernel.py
//        `bwd_plan`) gives a block as many heads as fill the card's SMs
//        once (all of a group's heads at both training shapes). C and B of
//        the chunk load once per block; thread 0 keeps each head's x and dy
//        rows, its s and g images and its chunk table in flight by TMA and
//        bulk copies into a ring of kStages = 2 stages (an mbarrier per
//        stage for the bytes, one for its release), so head h + 1 arrives
//        while head h computes. Every chunk product is a wgmma (bf16 ->
//        float32) on 128-byte-swizzled tiles. The 128-step chunk is two
//        64-row blocks, and the causal triangle three 64 x 64 blocks;
//        warpgroup w owns the column block J = w (the blocks (I, J) with I
//        >= J: two for w = 0, one for w = 1) and the row block I = w (one
//        block for w = 0, two for w = 1), so neither does more than 1.3x
//        the other's products.
//        Column phase, per block (I, J): C B^T's and dy x^T's transposes,
//        B_J C_I^T and x_J dy_I^T, with both operands from shared memory;
//        in registers K^T, its row sums (over i > j), K's diagonal and its
//        column sums times dt_j (over j < i, per warp into shared memory);
//        W^T = (C B^T o L o dt)^T rounded to bf16 as a register A operand
//        (the accumulator's layout is the A fragment's), so dx_J += W^T dy_I
//        takes B from shared memory (MN-major); R^T = (dy x^T o L o dt)^T,
//        rounded, into shared memory. Once per head: V2 = B_J g^T (both
//        from shared memory) starts dx_J as e dt V2, and x . V2 gives ddt's
//        and dcum's x . (g B) terms. Row phase, after a block barrier:
//        dB_J += R^T_(J,I) C_I (R^T by ldmatrix) and (e dt o x_J) g, dC_I
//        += R_(I,J) B_J (R by ldmatrix.trans) and (exp(cum) o dy_I) s_in
//        (x and dy scaled as they load into register A), O_i = exp(cum_i)
//        dy_i . (C s_in^T)_i from C_I s_in^T; then one warp forms dcum, its
//        reverse inclusive sum, ddt and the head's share of da. dB and dC
//        sum over the block's heads in registers and go out once per block
//        as float32 partial sums (tiles, B, S, G, N); at N16 = 16, where
//        the 64-column products carry 48 padded columns, the accumulators
//        take one head at a time and only their 16 columns sum over the
//        heads (208 registers; summing all 64 in place, 255 and a spill).
//        Each 64 x 64 block of dy x^T is formed once (as x_J dy_I^T) where
//        both phases run in one kernel: at N16 = 16. At N16 = 128 dB and dC (64
//        registers a thread each) beside dx, C B^T and dy x^T (32 each)
//        pass ptxas's 255 (merged, that instance took 255 registers and
//        spilled 140 bytes), so it runs as two kernels over the same ring:
//        `<128, true, false>` (dx, ddt, da) and `<128, false, true>` (dB,
//        dC), each forming x_J dy_I^T.
//   4.   `ssd_bwd_sum_kernel`: dB and dC summed over the head tiles and da
//        over batch and chunks, each in a fixed order, in one launch.
//   Rounding: C, B, x and dy are exact bf16 operands; the float32 operands
//   (C B^T o L o dt, dy x^T o L o dt, the states s_in and g, and dy and x
//   scaled by their decays) are rounded once to bf16. Sums, the row and
//   column sums of K, dcum, its reverse sum and da stay float32. Decays
//   are exp2 of differences of the chunk's running sums of dt a log2(e),
//   each <= 0 (never exp(cum_i) exp(-cum_j)), so steep decay (cum past
//   -88 inside a chunk) stays finite. Scratch (kernel.py::bwd_plan): cotan
//   (float32), the images s and g (bf16), the chunk table, the partial
//   sums of dB and dC (tiles x dB's size each, float32) and da's (B, nc,
//   H); K6's states (float32) and decays are read where K6 left them.
//   Instances by N16: 16 (hymba; any N <= 16) and 128
//   (mamba2; any N from 17 up, zero-padded by TMA's out-of-bounds fill).
//   P <= 64 is zero-padded to 64 the same way.
//
// float32 inputs keep a CUDA-core kernel, `ssd_bwd_f32_kernel`: one block
// of 256 threads per (tile of kHT heads of one group, batch), each head in
// turn walking its chunks of 32 forward (the entering states into
// `states`, (B, nc, H, P, N)) and then backward with g in shared memory,
// every product a loop of float32 FMAs; its dB and dC shares go to the
// tile's partial sums as in the bf16 path.
//
// No atomics: each sum across blocks (dB and dC over a group's heads, da
// over batch and chunks, <g, s_in> over the reverse pass's blocks) is
// written as per-block partials and summed in a fixed order by a later
// launch or block, so a second launch gives the same bits (a repeated
// train step, and a killed and resumed run, stay bit-exact).
// P <= 64, N <= 128, H % G == 0, S >= 1.

#include "ssd_chunk.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBwdThreads = 256;  // two warpgroups (bf16); the float32 kernel's block
constexpr int kWgThreads = 128;
constexpr int kQf = 32;     // the float32 kernel's chunk
constexpr int kBlk = 64;    // a warpgroup's rows: a 64 x 64 block of the chunk
constexpr int kRowB = 128;  // bytes of a 128-byte-swizzled row: 64 bf16
constexpr int kStages = 2;  // the ring over a block's heads

__device__ __forceinline__ float2 bf2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The block's sum of v, the same bits on every thread and every launch
// (shuffle tree per warp, then the warps in order); red holds 8 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kBwdThreads / 32; ++w) t += red[w];
  __syncthreads();
  return t;
}

struct Strides {  // dy's element strides
  long long sb, ss, sh;
};

// ===========================================================================
// bfloat16: the reverse state pass
// ===========================================================================
// Pass 4 (see the head comment). A thread owns kPassE entries of (b, h)'s
// P16 x N16 state; grid (entries / (kPassE kPassThreads), H, B). Each batch
// of kPassUnroll chunks is loaded before it is used; the block's sums of
// <g, s_in> go to the chunk table at entry 2 kQc + blockIdx.x.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_rpass_kernel(const float* __restrict__ cot, const float* __restrict__ st,
                       const float* __restrict__ dec, const float* __restrict__ dstate,
                       uint32_t* __restrict__ s_img, uint32_t* __restrict__ g_img,
                       float* __restrict__ tab, int nc, int H, int P, int N, int P16, int N16) {
  __shared__ float red[kPassThreads / 32][kPassUnroll];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = kPassE * (blockIdx.x * kPassThreads + tid);  // first entry
  const int PN = P16 * N16;
  const bool valid = e < PN;
  const int pp = valid ? e / N16 : 0, n0 = e - pp * N16;
  const long long cstride = static_cast<long long>(H) * PN;  // one chunk
  const long long e0 = (static_cast<long long>(b) * nc * H + h) * PN + e;  // chunk 0's entry
  const float* db = dec + static_cast<long long>(b) * nc * H + h;
  float s0 = 0.f, s1 = 0.f;
  if (valid && dstate != nullptr && pp < P) {
    const float* ds = dstate + ((static_cast<long long>(b) * H + h) * P + pp) * N;
    if (n0 < N) s0 = ds[n0];
    if (n0 + 1 < N) s1 = ds[n0 + 1];
  }
  for (int c1 = nc; c1 > 0; c1 -= kPassUnroll) {  // chunks c1 - 1 down to c1 - kPassUnroll
    float2 dv[kPassUnroll];
    uint32_t hi[kPassUnroll], lo[kPassUnroll];
    float d[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      dv[u] = make_float2(0.f, 0.f);
      hi[u] = lo[u] = 0u;
      d[u] = 1.f;
      if (valid && c >= 0) {
        const long long o = e0 + c * cstride;
        dv[u] = *reinterpret_cast<const float2*>(cot + o);
        // hi and lo of entries e, e + 1 within their group's 32 bytes
        const char* grp = reinterpret_cast<const char*>(st + o - (e & 7));
        hi[u] = *reinterpret_cast<const uint32_t*>(grp + 2 * (e & 7));
        lo[u] = *reinterpret_cast<const uint32_t*>(grp + 16 + 2 * (e & 7));
        d[u] = db[c * H];
      }
    }
    float dots[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      dots[u] = 0.f;
      if (valid && c >= 0) {
        const long long o = e0 + c * cstride;
        g_img[o >> 1] = pack_bf16(s0, s1);  // g_c+1
        s_img[o >> 1] = hi[u];
        const float2 h2 = bf2f(hi[u]), l2 = bf2f(lo[u]);
        dots[u] = fmaf(s0, h2.x + l2.x, s1 * (h2.y + l2.y));
        s0 = fmaf(d[u], s0, dv[u].x);
        s1 = fmaf(d[u], s1, dv[u].y);
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      float v = dots[u];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][u] = v;
    }
    __syncthreads();
    if (tid < kPassUnroll && c1 - 1 - tid >= 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kPassThreads / 32; ++w) t += red[w][tid];
      tab[((static_cast<long long>(b) * nc + c1 - 1 - tid) * H + h) * kTab + 2 * kQc +
          blockIdx.x] = t;
    }
    __syncthreads();
  }
}

// ===========================================================================
// bfloat16: the chunk pass on wgmma, fed by a TMA ring
// ===========================================================================
struct ChunkArgs {
  int B, S, H, G, P, N, nc, hpb, dots;  // hpb: heads per block; dots: table partials
};

// Byte offsets of a chunk block's shared memory from a 1,024-byte aligned
// base. NB: 16 or 128 (NA = 1 or 2 swizzle atoms of 64 columns along N). C
// and B of the chunk (NA regions of kQc rows each); the ring, each stage a
// head's x and dy (kQc rows of P <= 64) and its s and g images (NA regions
// of 64 rows p); R^T (kDbc): rows j of the blocks (I, J) with I >= J, a
// region of 64 rows for I = 0 and one of 128 for I = 1; each stage's chunk
// table; (kDx) the per-head sums: warp w's column sums of K o dt (8 x kQc),
// then K's row sums, ddt's direct terms, T, K's diagonal and O (kQc each);
// the barriers.
template <int NB, bool kDx, bool kDbc>
struct ChunkSmem {
  static constexpr int NA = NB > 64 ? 2 : 1;
  static constexpr int kCB = NA * kQc * kRowB;
  static constexpr int kX = kQc * kRowB;
  static constexpr int kSt = NA * kBlk * kRowB;
  static constexpr int kStage = 2 * kX + 2 * kSt;
  static constexpr int kC = 0, kB = kCB, kRing = 2 * kCB;
  static constexpr int kRt = kRing + kStages * kStage;
  static constexpr int kRtB = kDbc ? 3 * kBlk * kRowB : 0;
  static constexpr int kTabs = kRt + kRtB;
  static constexpr int kF = kTabs + kStages * kTab * 4;
  static constexpr int kFB = kDx ? 4 * 13 * kQc : 0;
  static constexpr int kBar = kF + kFB;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

// d (64 x 64, float32) = A B^T over kK columns (kK / 16 k-steps): A's 64 rows
// at a_base, B's 64 rows at b_base, both K-major 128-byte-swizzled, their
// next 64 columns a_rgn and b_rgn bytes on.
template <int kK>
__device__ __forceinline__ void ss_prod(float (&d)[32], uint32_t a_base, uint32_t a_rgn,
                                        uint32_t b_base, uint32_t b_rgn) {
  const uint32_t a_lo = sw128_lo(a_base, 16), b_lo = sw128_lo(b_base, 16), hi = sw128_hi(1024);
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    const uint32_t in = 32 * (kk % 4), at = kk / 4;  // byte offsets, / 16 below
    wgmma_ss_n64(d, a_lo, (at * a_rgn + in) / 16, b_lo, (at * b_rgn + in) / 16, hi, kk > 0);
  }
}

// acc (64 x kNW, float32) += A B: A (64 x 64) as four k-steps of register
// fragments, B the 64 rows (along K) of a tile at `tile`, MN-major, its next
// 64 columns `rgn` bytes on.
template <int kNW>
__device__ __forceinline__ void rs_prod(float (&acc)[kNW / 2], const uint32_t (&a)[4][4],
                                        uint32_t tile, uint32_t rgn) {
  const uint32_t lo = sw128_lo(tile, rgn), hi = sw128_hi(1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = kk * 16 * kRowB / 16;  // 16 rows down, in 16-byte units
    if constexpr (kNW == 128)
      wgmma_rs_n128(acc, a[kk], lo, off, hi);
    else
      wgmma_rs_n64(acc, a[kk], lo, off, hi);
  }
}

// The A fragments (warp w4's rows 16 w4 .. of the 64-row tile at `tile`,
// four k-steps of its 64 columns) of a 128-byte-swizzled bf16 tile, the
// lane's rows g and g + 8 scaled by sc0 and sc1 and rounded to bf16.
__device__ __forceinline__ void scaled_a(uint32_t (&a)[4][4], uint32_t tile, int w4, int lane,
                                         float sc0, float sc1) {
  const int row = 16 * w4 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t f[4];
    ldmatrix_x4(f, tile + sw128_at(row, 2 * kk + (lane >> 4)));
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // A rows: r even the lane's row g, odd g + 8
      const float2 u = bf2f(f[r]);
      const float sc = (r & 1) ? sc1 : sc0;
      a[kk][r] = pack_bf16(u.x * sc, u.y * sc);
    }
  }
}

// The first kV / 4 n8 blocks of a 64-row accumulator (the lane's rows r0
// and r0 + 8) into rows t0 + r of a (.., S, G, N) float32 array, from row
// offset o0 = ((tile, b) S + t0) G + g, the rows below `rows` and the columns
// below N.
template <int kV>
__device__ __forceinline__ void write_rows(float* __restrict__ part, const float (&v)[kV],
                                           long long o0, const ChunkArgs& q, int rows, int r0,
                                           int t4) {
#pragma unroll
  for (int n = 0; n < kV / 4; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + 8 * rr;
      if (row >= rows) continue;
      const long long o = (o0 + static_cast<long long>(row) * q.G) * q.N;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (col + k < q.N) part[o + col + k] = v[4 * n + 2 * rr + k];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Pass 5 (see the head comment): one block per (chunk, tile of q.hpb heads
// of group g, batch); kDx: dx, ddt and the heads' shares of da; kDbc: the
// tile's shares of dB and dC.
template <int NB, bool kDx, bool kDbc>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap ty,
                     const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
                     const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tg,
                     const float* __restrict__ tab, const float* __restrict__ a,
                     bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part_a,
                     float* __restrict__ part_b, float* __restrict__ part_c, ChunkArgs q) {
  using L = ChunkSmem<NB, kDx, kDbc>;
  constexpr int kNW = L::NA * 64;  // columns of the dB and dC accumulators
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);  // the same bytes, by generic pointers
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages, res = empty + 8 * kStages;

  const int c = blockIdx.x, ht = blockIdx.y;
  const int b = blockIdx.z / q.G, g = blockIdx.z - (blockIdx.z / q.G) * q.G;
  const int Hg = q.H / q.G;
  const int h0 = g * Hg + ht * q.hpb, nh = min(q.hpb, Hg - ht * q.hpb);
  if (nh <= 0) return;  // the whole block (the plan makes none)
  const int t0 = c * kQc, rows = min(kQc, q.S - t0);
  const long long bc = static_cast<long long>(b) * q.nc + c;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);             // the issuing thread
      mbar_init(empty + 8 * s, kBwdThreads);  // every thread
    }
    mbar_init(res, 1);  // C and B of the chunk
    mbar_fence_init();
  }
  __syncthreads();

  // Head `it` of the block into its stage: x and dy rows, the s and g
  // images, the chunk table (cum, dt and the <g, s_in> partials).
  const auto load_head = [&](int it) {
    const int s = it % kStages, h = h0 + it;
    const uint32_t st = base + L::kRing + s * L::kStage, bar = full + 8 * s;
    mbar_expect_tx(bar, L::kStage + kTab * 4);
    tma_load_4d(st, &tx, bar, 0, t0, h, b);
    tma_load_4d(st + L::kX, &ty, bar, 0, t0, h, b);
#pragma unroll
    for (int at = 0; at < L::NA; ++at) {
      tma_load_4d(st + 2 * L::kX + at * kBlk * kRowB, &ts, bar, 64 * at, 0, h,
                  static_cast<int>(bc));
      tma_load_4d(st + 2 * L::kX + L::kSt + at * kBlk * kRowB, &tg, bar, 64 * at, 0, h,
                  static_cast<int>(bc));
    }
    bulk_load(base + L::kTabs + s * kTab * 4, tab + (bc * q.H + h) * kTab, kTab * 4, bar);
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(res, 2 * L::kCB);
#pragma unroll
    for (int at = 0; at < L::NA; ++at) {
      tma_load_4d(base + L::kC + at * kQc * kRowB, &tc, res, 64 * at, t0, g, b);
      tma_load_4d(base + L::kB + at * kQc * kRowB, &tb, res, 64 * at, t0, g, b);
    }
    for (int it = 0; it < kStages && it < nh; ++it) load_head(it);
  }

  const int tid = threadIdx.x, wg = tid / kWgThreads, warp = tid >> 5, w4 = warp & 3;
  const int lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  // This warpgroup's column block J and row block I are both wg; its rows
  // in them (the lane's accumulator rows):
  const int blk = wg;
  const int r0 = kBlk * blk + 16 * w4 + g8, r1 = r0 + 8;
  const uint32_t cs = base + L::kC, bs = base + L::kB, rt = base + L::kRt;
  const auto rt_rgn = [&](int i_blk) { return rt + (i_blk ? kBlk * kRowB : 0); };
  float* colA = reinterpret_cast<float*>(gen + L::kF);  // 8 x kQc
  float* csum = colA + 8 * kQc;
  float* dd = csum + kQc;
  float* tv = dd + kQc;
  float* kdg = tv + kQc;
  float* ov = kdg + kQc;

  // dB and dC: the products' accumulators (64 x kNW a warpgroup). Where the
  // instance's columns run past N16 (N16 = 16 in a 64-column product) the
  // accumulators take one head at a time and their kUse values of the
  // columns < N16 sum over the block's heads apart, so that the column
  // phase carries 2 x 8 registers of sums instead of 2 x 32.
  constexpr int kUse = NB < 64 ? NB / 2 : kNW / 2;
  constexpr bool kSplit = kUse < kNW / 2;
  float accB[kDbc ? kNW / 2 : 1], accC[kDbc ? kNW / 2 : 1];
  float keepB[kDbc && kSplit ? kUse : 1], keepC[kDbc && kSplit ? kUse : 1];
  zero(accB);
  zero(accC);
  zero(keepB);
  zero(keepC);
  mbar_wait(res, 0);

  for (int it = 0; it < nh; ++it) {
    const int s = it % kStages, h = h0 + it;
    const uint32_t xs = base + L::kRing + s * L::kStage, ys = xs + L::kX;
    const uint32_t ss = ys + L::kX, gs = ss + L::kSt;
    const float* cum = reinterpret_cast<const float*>(gen + L::kTabs + s * kTab * 4);
    const float* dts = cum + kQc;
    if (issuer && it > 0 && it - 1 + kStages < nh) {
      // refill the stage of head it - 1 once every thread has released it
      mbar_wait(empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_head(it - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, (it / kStages) & 1);

    const float cend = cum[kQc - 1];
    const float c0 = cum[r0], c1 = cum[r1], d0 = dts[r0], d1 = dts[r1];
    const float e0 = fast_exp2(cend - c0), e1 = fast_exp2(cend - c1);
    const float ed0 = e0 * d0, ed1 = e1 * d1;

    // ---- column phase: rows j of block J = blk, the blocks (I, J), I >= J
    float dxa[kDx ? 32 : 1];
    float xg0 = 0.f, xg1 = 0.f;
    if constexpr (kDx) {  // V2 = B_J g^T, then x . V2 and dx = e dt V2
      wgmma_fence();
      ss_prod<NB>(dxa, bs + blk * kBlk * kRowB, kQc * kRowB, gs, kBlk * kRowB);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dxa);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 xa = bf2f(*reinterpret_cast<const uint32_t*>(
            gen + (xs - base) + sw128_at(r0, jn) + 4 * t4));
        const float2 xb = bf2f(*reinterpret_cast<const uint32_t*>(
            gen + (xs - base) + sw128_at(r1, jn) + 4 * t4));
        xg0 = fmaf(xa.x, dxa[4 * jn], fmaf(xa.y, dxa[4 * jn + 1], xg0));
        xg1 = fmaf(xb.x, dxa[4 * jn + 2], fmaf(xb.y, dxa[4 * jn + 3], xg1));
        dxa[4 * jn] *= ed0;
        dxa[4 * jn + 1] *= ed0;
        dxa[4 * jn + 2] *= ed1;
        dxa[4 * jn + 3] *= ed1;
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        xg0 += __shfl_xor_sync(0xffffffffu, xg0, o);
        xg1 += __shfl_xor_sync(0xffffffffu, xg1, o);
      }
    }
    float rs0 = 0.f, rs1 = 0.f;  // K's column sums over i > j (rows j of K^T)
    for (int ib = blk; ib < 2; ++ib) {
      float cbt[kDx ? 32 : 1], dxt[32];
      wgmma_fence();
      if constexpr (kDx)  // (C B^T)^T = B_J C_I^T
        ss_prod<NB>(cbt, bs + blk * kBlk * kRowB, kQc * kRowB, cs + ib * kBlk * kRowB,
                    kQc * kRowB);
      ss_prod<64>(dxt, xs + blk * kBlk * kRowB, L::kX, ys + ib * kBlk * kRowB, L::kX);
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDx) reg_fence(cbt);
      reg_fence(dxt);

      uint32_t aw[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int i = kBlk * ib + 8 * jn + 2 * t4;
        const float2 ci = *reinterpret_cast<const float2*>(cum + i);
        float wv[4], rv[4], cp[2];  // cp: column sums of K o dt_j over the lane's rows
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (e >> 1) ? r1 : r0, ii = i + (e & 1);
          const float cj = (e >> 1) ? c1 : c0, dj = (e >> 1) ? d1 : d0;
          const float l = ii >= j ? fast_exp2(((e & 1) ? ci.y : ci.x) - cj) : 0.f;
          if constexpr (kDbc) rv[e] = dxt[4 * jn + e] * l * dj;
          if constexpr (kDx) {
            const float kv = cbt[4 * jn + e] * dxt[4 * jn + e] * l;
            wv[e] = cbt[4 * jn + e] * l * dj;
            if (ii > j) {
              if (e >> 1)
                rs1 += kv;
              else
                rs0 += kv;
            }
            if (ii == j) kdg[j] = kv;
            const float cv = ii > j ? kv * dj : 0.f;
            if (e >> 1)
              cp[e & 1] += cv;
            else
              cp[e & 1] = cv;
          }
        }
        if constexpr (kDx) {
          aw[jn >> 1][2 * (jn & 1)] = pack_bf16(wv[0], wv[1]);
          aw[jn >> 1][2 * (jn & 1) + 1] = pack_bf16(wv[2], wv[3]);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {  // over the warp's 16 rows
            cp[0] += __shfl_xor_sync(0xffffffffu, cp[0], o);
            cp[1] += __shfl_xor_sync(0xffffffffu, cp[1], o);
          }
          if (g8 == 0) *reinterpret_cast<float2*>(colA + warp * kQc + i) = make_float2(cp[0], cp[1]);
        }
        if constexpr (kDbc) {  // R^T (rows j, columns i of block ib), for dB and dC
          const uint32_t at = (rt_rgn(ib) - base) + 4 * t4;
          *reinterpret_cast<uint32_t*>(gen + at + sw128_at(r0, jn)) = pack_bf16(rv[0], rv[1]);
          *reinterpret_cast<uint32_t*>(gen + at + sw128_at(r1, jn)) = pack_bf16(rv[2], rv[3]);
        }
      }
      if constexpr (kDx) {
        wgmma_fence();
        rs_prod<64>(dxa, aw, ys + ib * kBlk * kRowB, L::kX);  // dx_J += W^T dy_I
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dxa);
        reg_fence(aw);
      }
    }
    if constexpr (kDx) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      }
      if (t4 == 0) {
        csum[r0] = rs0;
        csum[r1] = rs1;
        dd[r0] = fmaf(e0, xg0, rs0);
        dd[r1] = fmaf(e1, xg1, rs1);
        tv[r0] = ed0 * xg0;
        tv[r1] = ed1 * xg1;
      }
      // dx rows j of this block
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int col = 8 * jn + 2 * t4;
        if (col >= q.P) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = rr ? r1 : r0;
          if (row >= rows) continue;
          bf16* dr = dx + ((static_cast<long long>(b) * q.S + t0 + row) * q.H + h) * q.P;
          const float va = dxa[4 * jn + 2 * rr], vb = dxa[4 * jn + 2 * rr + 1];
          if ((q.P & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dr + col) = __floats2bfloat162_rn(va, vb);
          } else {
            dr[col] = __float2bfloat16(va);
            if (col + 1 < q.P) dr[col + 1] = __float2bfloat16(vb);
          }
        }
      }
    }
    __syncthreads();  // R^T and the column phase's sums are in shared memory

    // ---- row phase: rows i of block I = blk
    const float ec0 = fast_exp2(c0), ec1 = fast_exp2(c1);
    if constexpr (kDx) {  // O_i = exp(cum_i) dy_i . (C s_in^T)_i
      float oa[32];
      wgmma_fence();
      ss_prod<NB>(oa, cs + blk * kBlk * kRowB, kQc * kRowB, ss, kBlk * kRowB);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(oa);
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 ya = bf2f(*reinterpret_cast<const uint32_t*>(
            gen + (ys - base) + sw128_at(r0, jn) + 4 * t4));
        const float2 yb = bf2f(*reinterpret_cast<const uint32_t*>(
            gen + (ys - base) + sw128_at(r1, jn) + 4 * t4));
        o0 = fmaf(ya.x, oa[4 * jn], fmaf(ya.y, oa[4 * jn + 1], o0));
        o1 = fmaf(yb.x, oa[4 * jn + 2], fmaf(yb.y, oa[4 * jn + 3], o1));
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        o0 += __shfl_xor_sync(0xffffffffu, o0, o);
        o1 += __shfl_xor_sync(0xffffffffu, o1, o);
      }
      if (t4 == 0) {
        ov[r0] = o0 * ec0;
        ov[r1] = o1 * ec1;
      }
    }
    if constexpr (kDbc) {
      if constexpr (kSplit) zero(accB);
      for (int ib = blk; ib < 2; ++ib) {  // dB_J += R^T_(J,I) C_I, J = blk
        uint32_t ar[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4(ar[kk], rt_rgn(ib) + sw128_at(kBlk * blk + 16 * w4 + (lane & 15),
                                                    2 * kk + (lane >> 4)));
        wgmma_fence();
        rs_prod<kNW>(accB, ar, cs + ib * kBlk * kRowB, kQc * kRowB);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(accB);
        reg_fence(ar);
      }
      uint32_t ax[4][4];  // dB_J += (e dt o x_J) g
      scaled_a(ax, xs + blk * kBlk * kRowB, w4, lane, ed0, ed1);
      wgmma_fence();
      rs_prod<kNW>(accB, ax, gs, kBlk * kRowB);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(accB);
      reg_fence(ax);
      if constexpr (kSplit) {
#pragma unroll
        for (int k = 0; k < kUse; ++k) keepB[k] += accB[k];
        zero(accC);
      }
      for (int jb = 0; jb <= blk; ++jb) {  // dC_I += R_(I,J) B_J
        uint32_t ar[4][4];
        const int m = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldmatrix_x4_trans(ar[kk], rt_rgn(blk) + sw128_at(kBlk * jb + 16 * kk + (lane & 7) +
                                                                8 * (m >> 1),
                                                            2 * w4 + (m & 1)));
        wgmma_fence();
        rs_prod<kNW>(accC, ar, bs + jb * kBlk * kRowB, kQc * kRowB);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(accC);
        reg_fence(ar);
      }
      uint32_t ay[4][4];  // dC_I += (exp(cum) o dy_I) s_in
      scaled_a(ay, ys + blk * kBlk * kRowB, w4, lane, ec0, ec1);
      wgmma_fence();
      rs_prod<kNW>(accC, ay, ss, kBlk * kRowB);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(accC);
      reg_fence(ay);
      if constexpr (kSplit) {
#pragma unroll
        for (int k = 0; k < kUse; ++k) keepC[k] += accC[k];
      }
    }

    if constexpr (kDx) {
      __syncthreads();  // O
      // Through cum: the end terms, dcum's reverse inclusive sum, ddt and da.
      if (warp == 0) {
        float dc[4], ddd[4], tsum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * lane + e;
          float rsv = 0.f;  // sum_j<r K_rj dt_j: the warps whose rows j can be below r
#pragma unroll
          for (int w = 0; w < 4; ++w) rsv += colA[w * kQc + r];
          if (r >= kBlk) {
#pragma unroll
            for (int w = 4; w < 8; ++w) rsv += colA[w * kQc + r];
          }
          dc[e] = rsv - dts[r] * csum[r] + ov[r] - tv[r];
          ddd[e] = dd[r] + kdg[r];
          tsum += tv[r];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
        float gsd = 0.f;  // <g, s_in>, the reverse pass's block sums in order
        for (int k = 0; k < q.dots; ++k) gsd += cum[2 * kQc + k];
        if (lane == 31) dc[3] += tsum + fast_exp2(cend) * gsd;
        const float run = dc[0] + dc[1] + dc[2] + dc[3];
        float incl = run;  // the sum of lanes lane .. 31
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += u;
        }
        const float nxt = __shfl_down_sync(0xffffffffu, incl, 1);
        float acc = lane < 31 ? nxt : 0.f, da_part = 0.f;
        const float ah = a[h];
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int r = 4 * lane + e;
          acc += dc[e];
          if (r < rows)
            ddt[(static_cast<long long>(b) * q.S + t0 + r) * q.H + h] = fmaf(ah, acc, ddd[e]);
          da_part = fmaf(dts[r], acc, da_part);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) da_part += __shfl_xor_sync(0xffffffffu, da_part, o);
        if (lane == 0) part_a[bc * q.H + h] = da_part;
      }
    }
    mbar_arrive(empty + 8 * s);
    __syncthreads();  // the next head rewrites R^T and the per-head sums
  }

  if constexpr (kDbc) {  // the tile's shares, rows of the chunk, (tiles, B, S, G, N) float32
    const long long o0 = ((static_cast<long long>(ht) * q.B + b) * q.S + t0) * q.G + g;
    if constexpr (kSplit) {
      write_rows(part_b, keepB, o0, q, rows, r0, t4);
      write_rows(part_c, keepC, o0, q, rows, r0, t4);
    } else {
      write_rows(part_b, accB, o0, q, rows, r0, t4);
      write_rows(part_c, accC, o0, q, rows, r0, t4);
    }
  }
}

__device__ __forceinline__ void store_out(bf16* ptr, float v) { *ptr = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* ptr, float v) { *ptr = v; }

// The fixed-order sums, one launch: threads below `count` add dB's and dC's
// partial sums over the tiles in tile order; the next H threads add da's
// (arows, H) partials in row order.
template <typename OutT>
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ part_b,
                                   const float* __restrict__ part_c, OutT* __restrict__ dB,
                                   OutT* __restrict__ dC, long long count, int tiles,
                                   const float* __restrict__ part_a, float* __restrict__ da,
                                   int arows, int H) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) {
    float sb = 0.f, sc = 0.f;
    for (int t = 0; t < tiles; ++t) {
      sb += part_b[t * count + i];
      sc += part_c[t * count + i];
    }
    store_out(dB + i, sb);
    store_out(dC + i, sc);
  } else if (i < count + H) {
    const int h = static_cast<int>(i - count);
    float s = 0.f;
    for (int r = 0; r < arows; ++r) s += part_a[static_cast<long long>(r) * H + h];
    da[h] = s;
  }
}

// ===========================================================================
// float32: the CUDA-core kernel
// ===========================================================================
size_t f32_smem_floats(int P, int N) {
  const int N1 = N + 1, Q1 = kQf + 1;
  return 2 * kQf * P + 2 * kQf * N1 + 2 * P * N1 + 3 * kQf * Q1 + kQf * P + kQf * N1 +
         10 * kQf + 8 + 4;
}

// One block per (tile of kHT heads of one group, batch); each head walks
// its chunks of kQf forward (the entering states into st, (B, nc, H, P,
// N)) and then backward with its cotangent g in shared memory.
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   const float* __restrict__ dstate, float* __restrict__ dx,
                   float* __restrict__ ddt, float* __restrict__ st, float* __restrict__ part_b,
                   float* __restrict__ part_c, float* __restrict__ part_a, Params p, Strides ys,
                   int nc) {
  extern __shared__ float fsm[];
  const int P = p.P, N = p.N, N1 = N + 1, Q1 = kQf + 1;
  float* xs = fsm;                 // kQf x P
  float* dys = xs + kQf * P;       // kQf x P
  float* bs = dys + kQf * P;       // kQf x N1
  float* cs = bs + kQf * N1;       // kQf x N1
  float* ss = cs + kQf * N1;       // P x N1: the state (forward), s_in (backward)
  float* gs = ss + P * N1;         // P x N1: g
  float* km = gs + P * N1;         // kQf x Q1: K
  float* wx = km + kQf * Q1;       // kQf x Q1: C B^T o L o dt
  float* wb = wx + kQf * Q1;       // kQf x Q1: dy x^T o L o dt
  float* gb = wb + kQf * Q1;       // kQf x P: g B_j
  float* dco = gb + kQf * P;       // kQf x N1: exp(cum_i) s^T dy_i
  float* dts = dco + kQf * N1;     // kQf each below
  float* cum = dts + kQf;
  float* ee = cum + kQf;           // e_j
  float* ec = ee + kQf;            // exp(cum_i)
  float* rsum = ec + kQf;
  float* csum = rsum + kQf;
  float* ov = csum + kQf;
  float* tv = ov + kQf;
  float* ddtd = tv + kQf;
  float* xgb = ddtd + kQf;
  float* red = xgb + kQf;          // 8
  float* scal = red + 8;           // exp(cum_end)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ht = blockIdx.x, b = blockIdx.y / p.G, g = blockIdx.y - (blockIdx.y / p.G) * p.G;
  const int Hg = p.H / p.G;
  const int h0 = g * Hg + ht * kHT, nh = min(kHT, Hg - ht * kHT);
  const float* bb = Bm + b * p.b_sb + g * p.b_sg;
  const float* cb = Cm + b * p.c_sb + g * p.c_sg;

  // Rows t0 .. t0 + kQf of x (and dy, C when `all`), B and dt, zero past S;
  // warp 0 then forms the chunk's decays.
  auto load_chunk = [&](int h, int t0, bool all) {
    const float* xb = x + b * p.x_sb + h * p.x_sh;
    const float* yb = dy + b * ys.sb + h * ys.sh;
    for (int i = tid; i < kQf * P; i += kBwdThreads) {
      const int r = i / P, col = i - r * P;
      const bool in = t0 + r < p.S;
      xs[i] = in ? xb[(t0 + r) * p.x_ss + col] : 0.f;
      if (all) dys[i] = in ? yb[(t0 + r) * ys.ss + col] : 0.f;
    }
    for (int i = tid; i < kQf * N; i += kBwdThreads) {
      const int r = i / N, col = i - r * N;
      const bool in = t0 + r < p.S;
      bs[r * N1 + col] = in ? bb[(t0 + r) * p.b_ss + col] : 0.f;
      if (all) cs[r * N1 + col] = in ? cb[(t0 + r) * p.c_ss + col] : 0.f;
    }
    if (warp == 0) {
      const float d = t0 + lane < p.S ? dt[b * p.dt_sb + (t0 + lane) * p.dt_ss + h * p.dt_sh] : 0.f;
      float cv = d * a[h];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, cv, o);
        if (lane >= o) cv += u;
      }
      const float end = __shfl_sync(0xffffffffu, cv, 31);
      dts[lane] = d;
      cum[lane] = cv;
      ee[lane] = expf(end - cv);
      ec[lane] = expf(cv);
      if (lane == 0) *scal = expf(end);
    }
    __syncthreads();
  };

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    // forward walk: the state entering each chunk
    for (int i = tid; i < P * N1; i += kBwdThreads) ss[i] = 0.f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();
      load_chunk(h, c * kQf, false);
      float* so = st + ((static_cast<long long>(b) * nc + c) * p.H + h) * P * N;
      const float dec = *scal;
      for (int i = tid; i < P * N; i += kBwdThreads) {
        const int pp = i / N, n = i - pp * N;
        float v = ss[pp * N1 + n];
        so[i] = v;
        v *= dec;
        for (int j = 0; j < kQf; ++j) v = fmaf(ee[j] * dts[j] * xs[j * P + pp], bs[j * N1 + n], v);
        ss[pp * N1 + n] = v;
      }
    }
    // backward walk
    for (int i = tid; i < P * N1; i += kBwdThreads) {
      const int pp = i / N1, n = i - pp * N1;
      gs[i] = dstate != nullptr && n < N
                  ? dstate[((static_cast<long long>(b) * p.H + h) * P + pp) * N + n] : 0.f;
    }
    float da_acc = 0.f;
    for (int c = nc - 1; c >= 0; --c) {
      const int t0 = c * kQf;
      __syncthreads();
      load_chunk(h, t0, true);
      const float* si = st + ((static_cast<long long>(b) * nc + c) * p.H + h) * P * N;
      for (int i = tid; i < P * N; i += kBwdThreads) {
        const int pp = i / N, n = i - pp * N;
        ss[pp * N1 + n] = si[i];
      }
      for (int i = tid; i < kQf * kQf; i += kBwdThreads) {
        const int r = i / kQf, j = i - r * kQf;
        float k = 0.f, w1 = 0.f, w2 = 0.f;
        if (j <= r) {
          float cbv = 0.f, dxv = 0.f;
          for (int n = 0; n < N; ++n) cbv = fmaf(cs[r * N1 + n], bs[j * N1 + n], cbv);
          for (int pp = 0; pp < P; ++pp) dxv = fmaf(dys[r * P + pp], xs[j * P + pp], dxv);
          const float l = expf(cum[r] - cum[j]);
          k = cbv * l * dxv;
          w1 = cbv * l * dts[j];
          w2 = dxv * l * dts[j];
        }
        km[r * Q1 + j] = k;
        wx[r * Q1 + j] = w1;
        wb[r * Q1 + j] = w2;
      }
      __syncthreads();  // s_in loaded too
      for (int i = tid; i < kQf * P; i += kBwdThreads) {
        const int j = i / P, pp = i - j * P;
        float v = 0.f;
        for (int n = 0; n < N; ++n) v = fmaf(bs[j * N1 + n], gs[pp * N1 + n], v);
        gb[j * P + pp] = v;
      }
      for (int i = tid; i < kQf * N; i += kBwdThreads) {
        const int r = i / N, n = i - r * N;
        float v = 0.f;
        for (int pp = 0; pp < P; ++pp) v = fmaf(dys[r * P + pp], ss[pp * N1 + n], v);
        dco[r * N1 + n] = ec[r] * v;
      }
      if (tid < kQf) {  // K's sums below its diagonal (see the head comment)
        float v = 0.f;
        for (int j = 0; j < tid; ++j) v = fmaf(km[tid * Q1 + j], dts[j], v);
        rsum[tid] = v;
      } else if (tid < 2 * kQf) {
        const int j = tid - kQf;
        float v = 0.f;
        for (int r = j + 1; r < kQf; ++r) v += km[r * Q1 + j];
        csum[j] = v;
      }
      __syncthreads();
      for (int i = tid; i < kQf * P; i += kBwdThreads) {
        const int j = i / P, pp = i - j * P;
        float v = ee[j] * dts[j] * gb[j * P + pp];
        for (int r = j; r < kQf; ++r) v = fmaf(wx[r * Q1 + j], dys[r * P + pp], v);
        if (t0 + j < p.S) dx[((static_cast<long long>(b) * p.S + t0 + j) * p.H + h) * P + pp] = v;
      }
      if (tid < kQf) {
        float v = 0.f;
        for (int pp = 0; pp < P; ++pp) v = fmaf(xs[tid * P + pp], gb[tid * P + pp], v);
        xgb[tid] = v;
      } else if (tid < 2 * kQf) {
        const int r = tid - kQf;
        float v = 0.f;
        for (int n = 0; n < N; ++n) v = fmaf(cs[r * N1 + n], dco[r * N1 + n], v);
        ov[r] = v;
      }
      for (int i = tid; i < kQf * N; i += kBwdThreads) {
        const int r = i / N, n = i - r * N;
        if (t0 + r >= p.S) continue;
        float vb = 0.f, vc = dco[r * N1 + n];
        for (int pp = 0; pp < P; ++pp) vb = fmaf(xs[r * P + pp], gs[pp * N1 + n], vb);
        vb *= ee[r] * dts[r];
        for (int k = r; k < kQf; ++k) vb = fmaf(wb[k * Q1 + r], cs[k * N1 + n], vb);
        for (int k = 0; k <= r; ++k) vc = fmaf(wb[r * Q1 + k], bs[k * N1 + n], vc);
        const long long o =
            (((static_cast<long long>(ht) * p.B + b) * p.S + t0 + r) * p.G + g) * N + n;
        part_b[o] = hh ? part_b[o] + vb : vb;
        part_c[o] = hh ? part_c[o] + vc : vc;
      }
      float dot = 0.f;
      for (int i = tid; i < P * N; i += kBwdThreads) {
        const int pp = i / N, n = i - pp * N;
        dot = fmaf(gs[pp * N1 + n], ss[pp * N1 + n], dot);
      }
      const float gs_dot = block_sum(dot, red);  // also orders xgb, ov above
      if (warp == 0) {
        const int r = lane;
        ddtd[r] = fmaf(ee[r], xgb[r], csum[r] + km[r * Q1 + r]);
        tv[r] = ee[r] * dts[r] * xgb[r];
        float dc = rsum[r] - dts[r] * csum[r] + ov[r] - tv[r];
        float tsum = tv[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
        if (r == kQf - 1) dc += tsum + *scal * gs_dot;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {  // reverse inclusive sum
          const float u = __shfl_down_sync(0xffffffffu, dc, o);
          if (lane + o < 32) dc += u;
        }
        if (t0 + r < p.S)
          ddt[(static_cast<long long>(b) * p.S + t0 + r) * p.H + h] = fmaf(a[h], dc, ddtd[r]);
        float dpart = dts[r] * dc;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dpart += __shfl_xor_sync(0xffffffffu, dpart, o);
        da_acc += dpart;
      }
      // g = exp(cum_end) g + sum_i exp(cum_i) dy_i (x) C_i
      const float dec = *scal;
      for (int i = tid; i < P * N; i += kBwdThreads) {
        const int pp = i / N, n = i - pp * N;
        float v = gs[pp * N1 + n] * dec;
        for (int r = 0; r < kQf; ++r) v = fmaf(ec[r] * dys[r * P + pp], cs[r * N1 + n], v);
        gs[pp * N1 + n] = v;
      }
    }
    if (tid == 0) part_a[static_cast<long long>(b) * p.H + h] = da_acc;
  }
}

// The opt-in above 48 KB of dynamic shared memory, once per kernel instance.
template <class Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

int launch_bwd_f32(const float* x, const float* dt, const float* a, const float* Bm,
                   const float* Cm, const float* dy, const float* dstate, float* dx, float* ddt,
                   float* da, float* dB, float* dC, float* st, float* part_b, float* part_c,
                   float* part_a, const Params& p, const Strides& ys, int nc, int tiles,
                   cudaStream_t stream) {
  static bool attr_set = false;
  int err = allow_smem(ssd_bwd_f32_kernel,
                       sizeof(float) * f32_smem_floats(kMaxP, 128), attr_set);
  if (err) return err;
  ssd_bwd_f32_kernel<<<dim3(tiles, p.B * p.G), kBwdThreads, sizeof(float) * f32_smem_floats(p.P, p.N),
                       stream>>>(x, dt, a, Bm, Cm, dy, dstate, dx, ddt, st, part_b, part_c,
                                 part_a, p, ys, nc);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long count = static_cast<long long>(p.B) * p.S * p.G * p.N;
  ssd_bwd_sum_kernel<float><<<static_cast<unsigned>((count + p.H + 255) / 256), 256, 0, stream>>>(
      part_b, part_c, dB, dC, count, tiles, part_a, da, p.B, p.H);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 host side: the tensor maps and the launches
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no -lcuda); null if the driver has none.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map arguments of one operand, as kernel.py's `bwd_maps` computes them:
// dims (4), byte strides of dims 1-3, box (4). In order: x, dy, B, C (box
// 64 columns x kQc rows), the s and g images (box 64 x 64).
constexpr int kMapArgs = 11;
constexpr int kMaps = 6;

bool box_is(const long long* args, int rows) {
  return args[7] == 64 && args[8] == rows && args[9] == 1 && args[10] == 1;
}

int encode_map(CUtensorMap* map, const void* ptr, const long long* args) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(args[i]);
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(args[4 + i]);
  for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(args[7 + i]);
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int NB, bool kDx, bool kDbc>
int launch_chunk(const CUtensorMap (&m)[kMaps], const float* tab, const float* a, bf16* dx,
                 float* ddt, float* part_a, float* part_b, float* part_c, const ChunkArgs& q,
                 int tiles, cudaStream_t stream) {
  using L = ChunkSmem<NB, kDx, kDbc>;
  static bool done = false;
  const int err = allow_smem(ssd_bwd_chunk_kernel<NB, kDx, kDbc>, L::kBytes, done);
  if (err) return err;
  ssd_bwd_chunk_kernel<NB, kDx, kDbc><<<dim3(q.nc, tiles, q.B * q.G), kBwdThreads, L::kBytes,
                                         stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], tab, a, dx,
                                                   ddt, part_a, part_b, part_c, q);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_bwd_bf16(const bf16* x, const float* dt, const float* a, const bf16* Bm,
                    const bf16* Cm, const bf16* dy, const float* dstate, bf16* dx, float* ddt,
                    float* da, bf16* dB, bf16* dC, const float* st, const float* dec, float* cot,
                    float* tab, bf16* images, float* part_b, float* part_c, float* part_a,
                    const void* const (&tma)[4], const long long* maps, const Params& p,
                    const Strides& ys, int nc, int tiles, int hpb, int vec,
                    cudaStream_t stream) {
  static bool set_d = false;  // the opt-in above 48 KB, once per instance
  int err = allow_smem(ssd_chunk_state_kernel<NB, true>, state_smem<NB>(), set_d);
  if (err) return err;
  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;
  const long long PN = static_cast<long long>(P16) * N16;
  const int groups = static_cast<int>((PN / kPassE + kPassThreads - 1) / kPassThreads);
  if (groups > kDotParts) return static_cast<int>(cudaErrorInvalidValue);
  // 1. D_c and the chunk table
  Params pc = p;
  pc.x_sb = ys.sb;
  pc.x_ss = ys.ss;
  pc.x_sh = ys.sh;
  pc.b_sb = p.c_sb;
  pc.b_ss = p.c_ss;
  pc.b_sg = p.c_sg;
  ssd_chunk_state_kernel<NB, true><<<dim3(nc, p.H, p.B), kStateThreads, state_smem<NB>(), stream>>>(
      dy, dt, a, Cm, cot, tab, pc, nc, vec);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // 2. the reverse state pass: the images and <g, s_in>
  const long long img = static_cast<long long>(p.B) * nc * p.H * PN;
  uint32_t* s_img = reinterpret_cast<uint32_t*>(images);
  uint32_t* g_img = reinterpret_cast<uint32_t*>(images + img);
  ssd_state_rpass_kernel<<<dim3(groups, p.H, p.B), kPassThreads, 0, stream>>>(
      cot, st, dec, dstate, s_img, g_img, tab, nc, p.H, p.P, p.N, P16, N16);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  // 3. the chunks
  CUtensorMap m[kMaps];
  const void* ptrs[kMaps] = {tma[0], tma[1], tma[2], tma[3], images, images + img};
  for (int i = 0; i < kMaps && !err; ++i) err = encode_map(&m[i], ptrs[i], maps + i * kMapArgs);
  if (err) return err;
  const ChunkArgs q{p.B, p.S, p.H, p.G, p.P, p.N, nc, hpb, groups};
  if constexpr (NB == 16) {
    err = launch_chunk<NB, true, true>(m, tab, a, dx, ddt, part_a, part_b, part_c, q, tiles, stream);
  } else {
    err = launch_chunk<NB, true, false>(m, tab, a, dx, ddt, part_a, part_b, part_c, q, tiles,
                                        stream);
    if (!err)
      err = launch_chunk<NB, false, true>(m, tab, a, dx, ddt, part_a, part_b, part_c, q, tiles,
                                          stream);
  }
  if (err) return err;
  // 4. the fixed-order sums
  const long long count = static_cast<long long>(p.B) * p.S * p.G * p.N;
  ssd_bwd_sum_kernel<bf16><<<static_cast<unsigned>((count + p.H + 255) / 256), 256, 0, stream>>>(
      part_b, part_c, dB, dC, count, tiles, part_a, da, p.B * nc, p.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy (B, S, H, P) with element strides (x_sb, x_ss, x_sh) and (y_sb,
// y_ss, y_sh), Bm and Cm (B, S, G, N) with strides (b_*) and (c_*), dt (B,
// S, H) float32 with strides (dt_*), a (H,) float32 contiguous, dstate (B,
// H, P, N) float32 contiguous or null; unit stride along P and N. dtype 0
// float32 (chunks of 32), 1 bfloat16 (chunks of 128); nc = ceil(S / chunk).
// Outputs contiguous: dx (B, S, H, P) and dB, dC (B, S, G, N) in the
// inputs' dtype, ddt (B, S, H) and da (H,) float32. Scratch
// (kernel.py::bwd_plan), float32: states (B, nc, H, P16, N16) (float32
// inputs: (B, nc, H, P, N)), part_b and part_c (tiles, B, S, G, N), part_a
// (B, nc, H) (float32 inputs: (B, H)). float32 inputs: tiles = ceil((H / G)
// / 8); the rest is null. bfloat16 inputs: states and decay (B, nc, H)
// hold K6's own pass-2 states and decays of these inputs (kept by
// `ssd_chunk_kernel(..., keep=True)`), read only; cotan like states; table
// (B, nc, H, kTab); images (2, B, nc, H, P16, N16) bf16; hpb heads per block and tiles = ceil((H / G) / hpb); tma_x,
// tma_dy, tma_b, tma_c the addresses the tensor maps read x, dy, Bm and Cm
// at (the tensors themselves, or copies with 16-byte aligned rows: the
// maps' strides say which), and `maps` the six maps' arguments (kMapArgs
// each: x, dy, Bm, Cm, the s and g images; kernel.py `bwd_maps`).
// Launches on `stream` and returns the first error that is not 0 (a CUDA
// error, or cudaErrorInvalidValue for arguments or a map the driver
// refuses), else 0.
extern "C" int ssd_chunk_bwd(
    const void* x, const float* dt, const float* a, const void* Bm, const void* Cm,
    const void* dy, const float* dstate, void* dx, float* ddt, float* da, void* dB, void* dC,
    float* states, float* decay, float* cotan, float* table,
    void* images, float* part_b, float* part_c, float* part_a, const void* tma_x,
    const void* tma_dy, const void* tma_b, const void* tma_c, const long long* maps, int B, int S,
    int H, int G, int P, int N, int nc, int tiles, int hpb, long long x_sb, long long x_ss,
    long long x_sh, long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long dt_sb, long long dt_ss, long long dt_sh, long long y_sb,
    long long y_ss, long long y_sh, int dtype, void* stream) {
  const int chunk = dtype == 1 ? kQc : kQf;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP || N <= 0 ||
      N > 128 || H > 65535 || B * G > 65535 || nc != (S + chunk - 1) / chunk ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, P, N, x_sb, x_ss, x_sh, b_sb, b_ss, b_sg,
                 c_sb, c_ss, c_sg, dt_sb, dt_ss, dt_sh};
  const Strides ys{y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tiles != (H / G + kHT - 1) / kHT) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bwd_f32(static_cast<const float*>(x), dt, a, static_cast<const float*>(Bm),
                          static_cast<const float*>(Cm), static_cast<const float*>(dy), dstate,
                          static_cast<float*>(dx), ddt, da, static_cast<float*>(dB),
                          static_cast<float*>(dC), states, part_b, part_c, part_a, p, ys, nc,
                          tiles, s);
  }
  if (hpb <= 0 || tiles != (H / G + hpb - 1) / hpb || tiles > 65535 ||
      static_cast<long long>(B) * nc > 0x7fffffffLL || states == nullptr || decay == nullptr ||
      cotan == nullptr || table == nullptr || images == nullptr || maps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < kMaps; ++i)
    if (!box_is(maps + i * kMapArgs, i < 4 ? kQc : 64)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte cp.async tile loads (K6's passes 1 and the state cotangents)
  // need every row start 16-byte aligned.
  const auto al = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vec = al(x) && al(Bm) && al(Cm) && al(dy) && P % 8 == 0 && N % 8 == 0 &&
                  (x_sb | x_ss | x_sh | b_sb | b_ss | b_sg | c_sb | c_ss | c_sg | y_sb | y_ss |
                   y_sh) % 8 == 0;
  const void* const tma[4] = {tma_x, tma_dy, tma_b, tma_c};
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(Bm),
             *cb = static_cast<const bf16*>(Cm), *yb = static_cast<const bf16*>(dy);
  bf16 *dxb = static_cast<bf16*>(dx), *dbb = static_cast<bf16*>(dB), *dcb = static_cast<bf16*>(dC);
  bf16* img = static_cast<bf16*>(images);
#define SSD_BWD_LAUNCH(NBV)                                                                     \
  return launch_bwd_bf16<NBV>(xb, dt, a, bb, cb, yb, dstate, dxb, ddt, da, dbb, dcb, states,    \
                              decay, cotan, table, img, part_b, part_c, part_a, tma, maps, p, ys, \
                              nc, tiles, hpb, vec, s)
  if (N <= 16) SSD_BWD_LAUNCH(16);
  SSD_BWD_LAUNCH(128);
#undef SSD_BWD_LAUNCH
}

extern "C" const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
