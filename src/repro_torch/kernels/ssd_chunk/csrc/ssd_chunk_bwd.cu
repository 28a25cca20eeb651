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
//   state's cotangent (B, H, P, N) float32 contiguous or null. Out, all
//   contiguous: dx (B, S, H, P), dB, dC (B, S, G, N) in the inputs' dtype,
//   ddt (B, S, H) and da (H,) float32.
//
// What bounds it: the bytes of x, dy, B, C, dt read once and of dx, dB,
// dC, ddt written once: 325 MB at mamba2's training shape (B = 4, S =
// 4,096, H = 48, P = 64, N = 128, G = 1, bf16) and 323 MB at hymba's (H =
// 50, N = 16), about 0.097 ms over 3.35 TB/s; the recurrence's backward,
// 8 P N operations per step and head (two outer products and two
// state-vector products), takes 0.052 ms at mamba2 at the bf16 tensor rate.
//
// bfloat16 inputs, chunks of Q = 128 (K6's), eight launches on one stream:
//   1-2. K6's passes 1 and 2 (ssd_chunk.cuh) recompute the state entering
//        each chunk into the scratch `states` (B, nc, H, P16, N16), split
//        as K6's pass 3 reads it, and the chunk decays (B, nc, H). Nothing
//        is kept from the forward: under remat the layer is recomputed
//        anyway.
//   3.   Pass 1 again with dy and C for x and B and exp(cum_i) for its
//        weights: D_c into the scratch `cotan` (same shape, float32).
//   4.   `ssd_state_rpass_kernel`: the reverse state pass, sequential over
//        chunks only, two state entries a thread, in place: cotan[c] =
//        g_c+1 (float32).
//   5.   `ssd_bwd_dx_kernel`, one block of 8 warps per (chunk, tile of up
//        to kHT = 8 heads of one group, batch), warp w owning rows 16 w ..
//        16 w + 15 of the chunk: C B^T once per block in registers (as K6's
//        pass 3), then per head dy x^T by 16-column tiles, K and the row
//        and column sums for dcum, (C B^T o L o dt) to shared memory, the
//        off-diagonal terms dy s_in^T and B g^T, dx = (C B^T o L o dt)^T dy
//        + e dt B g^T, ddt and the head's share of da (B, nc, H).
//   6.   `ssd_bwd_dbc_kernel`, the same grid and rows: per head (dy x^T o
//        L o dt) to shared memory, then dC += it B + (exp(cum) dy) s_in and
//        dB += it^T C + (e dt x) g, summed over the tile's heads in
//        registers and written once per tile: partial sums (tiles, B, S, G,
//        N) float32. Passes 5 and 6 are apart because C B^T, dB and dC
//        take 64 registers a thread each at N = 128: one pass would spill;
//        each recomputes dy x^T instead.
//   7-8. `ssd_bwd_sum_kernel` sums dB and dC over the tiles and
//        `ssd_bwd_da_kernel` da over batch and chunks, each in a fixed
//        order.
//   Every chunk product runs on the tensor cores (mma.sync m16n8k16 bf16 ->
//   float32, operands by ldmatrix from shared memory rows padded by 16
//   bytes). Rounding: C, B, x and dy are exact bf16 operands; the float32
//   operands (C B^T o L o dt, dy x^T o L o dt, the states s_in and g, and
//   dy and x scaled by their decays) are rounded once to bf16. Sums, the
//   row and column sums of K, dcum, its reverse sum and da stay float32.
//   Decays are exp2 of differences of the chunk's running sums of dt a
//   log2(e), each <= 0 (never exp(cum_i) exp(-cum_j)), so steep decay (cum
//   past -88 inside a chunk) stays finite. Scratch: states and cotan (B,
//   nc, H, P16, N16) float32 each (201 MB each at mamba2, 26 MB at hymba),
//   the partial sums of dB and dC (tiles x dB's size each, float32), da's
//   (B, nc, H), the decays and K6's final state; kernel.py::bwd_plan sizes
//   them and the grids. Two instances, N16 = 16 (hymba) and 128 (mamba2;
//   any N from 17 up, zero-padded to 16 columns at a time as in K6).
//
// float32 inputs keep a CUDA-core kernel, `ssd_bwd_f32_kernel`: one block
// of 256 threads per (tile of kHT heads of one group, batch), each head in
// turn walking its chunks of 32 forward (the entering states into
// `states`, (B, nc, H, P, N)) and then backward with g in shared memory,
// every product a loop of float32 FMAs; its dB and dC shares go to the
// tile's partial sums as in the bf16 path.
//
// No atomics: each sum across blocks (dB and dC over a group's heads, da
// over batch and chunks) is written as per-block partials and summed in a
// fixed order by a later launch, so a second launch gives the same bits (a
// repeated train step, and a killed and resumed run, stay bit-exact).
// P <= 64, N <= 128, H % G == 0, S >= 1.

#include "ssd_chunk.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kQf = 32;  // the float32 kernel's chunk

__device__ __forceinline__ float2 bf2f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 bf2f_at(const bf16* ptr) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ptr));
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

// One head's state tiles into shared memory (P16 rows of N16): s_in's
// rounding (the hi terms of pass 2's [8 x hi | 8 x lo] groups) into ss, g
// (float32) rounded to bf16 into gs. With kDot, returns this thread's share
// of <g, s_in> (s_in as hi + lo, g in float32).
template <int LD, bool kDot>
__device__ __forceinline__ float load_states(bf16* ss, bf16* gs, const float* st,
                                             const float* gt, int P16, int N16) {
  float dot = 0.f;
  const int groups = N16 / 8;
  for (int u = threadIdx.x; u < P16 * groups; u += kBwdThreads) {
    const int pp = u / groups, n0 = (u - pp * groups) * 8;
    const float* sg = st + pp * N16 + n0;
    const uint4 hi = *reinterpret_cast<const uint4*>(sg);
    *reinterpret_cast<uint4*>(ss + pp * LD + n0) = hi;
    const float4 g0 = *reinterpret_cast<const float4*>(gt + pp * N16 + n0);
    const float4 g1 = *reinterpret_cast<const float4*>(gt + pp * N16 + n0 + 4);
    uint4 gp;
    gp.x = pack_bf16(g0.x, g0.y);
    gp.y = pack_bf16(g0.z, g0.w);
    gp.z = pack_bf16(g1.x, g1.y);
    gp.w = pack_bf16(g1.z, g1.w);
    *reinterpret_cast<uint4*>(gs + pp * LD + n0) = gp;
    if (kDot) {
      const uint4 lo = *reinterpret_cast<const uint4*>(sg + 4);
      const uint32_t hw[4] = {hi.x, hi.y, hi.z, hi.w}, lw[4] = {lo.x, lo.y, lo.z, lo.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 h2 = bf2f(hw[k]), l2 = bf2f(lw[k]);
        dot = fmaf(gv[2 * k], h2.x + l2.x, dot);
        dot = fmaf(gv[2 * k + 1], h2.y + l2.y, dot);
      }
    }
  }
  return dot;
}

// Shared memory of passes 5 and 6: C, B (kQc x LDC), x, dy (kQc x LDX), the
// head's s_in and g (kMaxP x LDC) and one kQc x kQc product (LDW), bf16;
// then float32: the tile's cum (log2 units) and dt (kHT x kQc each), pass
// 5's per-warp column sums of K below its diagonal (8 x kQc), dcum, the
// direct ddt, T and K's diagonal (kQc each) and 8 floats for block sums.
template <int NB> struct BwdTile {
  static constexpr int LDC = NB + 8, LDX = kMaxP + 8, LDW = kQc + 8;
  static constexpr int kBf = 2 * kQc * LDC + 2 * kQc * LDX + 2 * kMaxP * LDC + kQc * LDW;
  static constexpr int kF = 2 * kHT * kQc + 8 * kQc + 4 * kQc + 8;
  static constexpr size_t kSmem = sizeof(bf16) * kBf + sizeof(float) * kF;
};

struct Strides {  // dy's element strides
  long long sb, ss, sh;
};

// Passes 5 and 6 share their set-up: C and B of the chunk, every head's
// cum and dt; per head x, dy and the state tiles.
struct TileView {
  bf16 *cs, *bs, *xs, *dys, *ss, *gs, *ws;
  float *cum2, *dts;
};

template <int NB>
__device__ __forceinline__ TileView tile_view(unsigned char* raw) {
  using T = BwdTile<NB>;
  TileView v;
  v.cs = reinterpret_cast<bf16*>(raw);
  v.bs = v.cs + kQc * T::LDC;
  v.xs = v.bs + kQc * T::LDC;
  v.dys = v.xs + kQc * T::LDX;
  v.ss = v.dys + kQc * T::LDX;
  v.gs = v.ss + kMaxP * T::LDC;
  v.ws = v.gs + kMaxP * T::LDC;
  v.cum2 = reinterpret_cast<float*>(v.ws + kQc * T::LDW);
  v.dts = v.cum2 + kHT * kQc;
  return v;
}

// C, B and every head's cum / dt of the block's (chunk, tile, batch).
template <int NB>
__device__ __forceinline__ void load_tile(const TileView& v, const float* dt, const float* a,
                                          const bf16* Bm, const bf16* Cm, const Params& p,
                                          int b, int g, int t0, int rows, int h0, int nh,
                                          int vec) {
  constexpr int LDC = BwdTile<NB>::LDC;
  const int N16 = (p.N + 15) & ~15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows<kBwdThreads>(v.cs, LDC, Cm + b * p.c_sb + t0 * p.c_ss + g * p.c_sg, p.c_ss,
                         rows, kQc, p.N, N16, vec);
  load_rows<kBwdThreads>(v.bs, LDC, Bm + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss,
                         rows, kQc, p.N, N16, vec);
  cp_async_commit();
  for (int hh = warp; hh < nh; hh += kBwdThreads / 32)
    chunk_cumsum(dt + b * p.dt_sb + t0 * p.dt_ss + (h0 + hh) * p.dt_sh, p.dt_ss, rows,
                 a[h0 + hh], v.cum2 + hh * kQc, v.dts + hh * kQc, nullptr, lane);
}

// One head's x and dy rows (cp.async, committed).
template <int NB>
__device__ __forceinline__ void load_head(const TileView& v, const bf16* x, const bf16* dy,
                                          const Params& p, const Strides& ys, int b, int h,
                                          int t0, int rows, int vec) {
  constexpr int LDX = BwdTile<NB>::LDX;
  const int P16 = (p.P + 15) & ~15;
  load_rows<kBwdThreads>(v.xs, LDX, x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh, p.x_ss, rows,
                         kQc, p.P, P16, vec);
  load_rows<kBwdThreads>(v.dys, LDX, dy + b * ys.sb + t0 * ys.ss + h * ys.sh, ys.ss, rows,
                         kQc, p.P, P16, vec);
  cp_async_commit();
}

// The warp's dy rows (16 warp ..) as A fragments, one per 16 columns of P.
template <int NB>
__device__ __forceinline__ void dy_fragments(uint32_t (&dyf)[kMaxP / 16][4], const bf16* dys,
                                             int P16) {
  constexpr int LDX = BwdTile<NB>::LDX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int kp = 0; kp < kMaxP / 16; ++kp)
    if (16 * kp < P16)
      ldmatrix_x4(dyf[kp], smem_addr(dys + (16 * warp + (lane & 15)) * LDX + 16 * kp +
                                     8 * (lane >> 4)));
}

// dy x^T of the warp's 16 rows against columns 16 kk .. 16 kk + 15 (two n8
// tiles in d).
template <int NB>
__device__ __forceinline__ void dyx_tile(float (&d)[2][4], const uint32_t (&dyf)[kMaxP / 16][4],
                                         const bf16* xs, int kk, int P16) {
  constexpr int LDX = BwdTile<NB>::LDX;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) d[r][0] = d[r][1] = d[r][2] = d[r][3] = 0.f;
#pragma unroll
  for (int kp = 0; kp < kMaxP / 16; ++kp) {
    if (16 * kp >= P16) continue;
    uint32_t bfr[4];
    ldmatrix_x4(bfr, smem_addr(xs + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * LDX + 16 * kp +
                               8 * ((lane >> 3) & 1)));
    mma_bf16(d[0], dyf[kp], bfr[0], bfr[1]);
    mma_bf16(d[1], dyf[kp], bfr[2], bfr[3]);
  }
}

// Pass 5: dx, ddt and the heads' shares of da (see the head comment).
template <int NB>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                  const float* __restrict__ st, const float* __restrict__ cot,
                  bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ part_a,
                  Params p, Strides ys, int nc, int vec) {
  using T = BwdTile<NB>;
  constexpr int LDC = T::LDC, LDX = T::LDX, LDW = T::LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileView v = tile_view<NB>(smem_raw);
  float* colp = v.dts + kHT * kQc;  // 8 x kQc: warp w's column sums of K (i > j)
  float* dcum = colp + 8 * kQc;
  float* ddtd = dcum + kQc;          // ddt's direct terms
  float* tv = ddtd + kQc;            // T_j
  float* kd = tv + kQc;              // K_jj
  float* red = kd + kQc;

  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;
  const int c = blockIdx.x, ht = blockIdx.y;
  const int b = blockIdx.z / p.G, g = blockIdx.z - (blockIdx.z / p.G) * p.G;
  const int Hg = p.H / p.G;
  const int h0 = g * Hg + ht * kHT, nh = min(kHT, Hg - ht * kHT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int t0 = c * kQc, rows = min(kQc, p.S - t0);
  const long long PN = static_cast<long long>(P16) * N16;
  const float* st_c = st + (static_cast<long long>(b) * nc + c) * p.H * PN;
  const float* cot_c = cot + (static_cast<long long>(b) * nc + c) * p.H * PN;

  load_tile<NB>(v, dt, a, Bm, Cm, p, b, g, t0, rows, h0, nh, vec);
  cp_async_wait<0>();
  __syncthreads();

  // C B^T of the warp's rows against the columns j <= its last row, shared
  // by the tile's heads (K6's pass 3).
  const uint32_t c_addr = smem_addr(v.cs + (16 * warp + (lane & 15)) * LDC + 8 * (lane >> 4));
  float sc[kQc / 8][4];
#pragma unroll
  for (int j = 0; j < kQc / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
  for (int kn = 0; kn < NB / 16; ++kn) {
    if (16 * kn >= N16) continue;
    uint32_t af[4];
    ldmatrix_x4(af, c_addr + 32 * kn);
#pragma unroll
    for (int np = 0; np < kQc / 16; ++np) {
      if (np > warp) continue;
      uint32_t bfr[4];
      ldmatrix_x4(bfr, smem_addr(v.bs + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LDC +
                                 16 * kn + 8 * ((lane >> 3) & 1)));
      mma_bf16(sc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(sc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }

  const int i0 = 16 * warp + g8, i1 = i0 + 8;  // this lane's rows
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    load_head<NB>(v, x, dy, p, ys, b, h, t0, rows, vec);
    const float gs_dot = block_sum(
        load_states<LDC, true>(v.ss, v.gs, st_c + h * PN, cot_c + h * PN, P16, N16), red);
    cp_async_wait<0>();
    __syncthreads();
    const float* cm = v.cum2 + hh * kQc;
    const float* dm = v.dts + hh * kQc;
    const float cend = cm[kQc - 1], ci0 = cm[i0], ci1 = cm[i1];
    uint32_t dyf[kMaxP / 16][4];
    dy_fragments<NB>(dyf, v.dys, P16);

    // K = C B^T o L o dy x^T: row sums (times dt_j) and column sums per
    // warp below the diagonal, the diagonal itself, and W = C B^T o L o dt
    // into shared memory.
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk > warp) continue;
      float d[2][4];
      dyx_tile<NB>(d, dyf, v.xs, kk, P16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kk + 8 * half + 2 * t4;
        const float* s4 = sc[2 * kk + half];
        const float cj0 = cm[j], cj1 = cm[j + 1], d0 = dm[j], d1 = dm[j + 1];
        const float l00 = j <= i0 ? fast_exp2(ci0 - cj0) : 0.f;
        const float l01 = j + 1 <= i0 ? fast_exp2(ci0 - cj1) : 0.f;
        const float l10 = j <= i1 ? fast_exp2(ci1 - cj0) : 0.f;
        const float l11 = j + 1 <= i1 ? fast_exp2(ci1 - cj1) : 0.f;
        const float k00 = s4[0] * d[half][0] * l00, k01 = s4[1] * d[half][1] * l01;
        const float k10 = s4[2] * d[half][2] * l10, k11 = s4[3] * d[half][3] * l11;
        const float s00 = j < i0 ? k00 : 0.f, s01 = j + 1 < i0 ? k01 : 0.f;
        const float s10 = j < i1 ? k10 : 0.f, s11 = j + 1 < i1 ? k11 : 0.f;
        if (j == i0) kd[j] = k00;
        if (j + 1 == i0) kd[j + 1] = k01;
        if (j == i1) kd[j] = k10;
        if (j + 1 == i1) kd[j + 1] = k11;
        rs0 = fmaf(s00, d0, fmaf(s01, d1, rs0));
        rs1 = fmaf(s10, d0, fmaf(s11, d1, rs1));
        float cp0 = s00 + s10, cp1 = s01 + s11;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cp0 += __shfl_xor_sync(0xffffffffu, cp0, o);
          cp1 += __shfl_xor_sync(0xffffffffu, cp1, o);
        }
        if (g8 == 0) {
          colp[warp * kQc + j] = cp0;
          colp[warp * kQc + j + 1] = cp1;
        }
        *reinterpret_cast<uint32_t*>(v.ws + i0 * LDW + j) =
            pack_bf16(s4[0] * l00 * d0, s4[1] * l01 * d1);
        *reinterpret_cast<uint32_t*>(v.ws + i1 * LDW + j) =
            pack_bf16(s4[2] * l10 * d0, s4[3] * l11 * d1);
      }
    }

    // O_i = exp(cum_i) dy_i . (s_in C_i), as (dy s_in)_i . C_i
    float o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int kn = 0; kn < NB / 16; ++kn) {
      if (16 * kn >= N16) continue;
      float oc[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) oc[r][0] = oc[r][1] = oc[r][2] = oc[r][3] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kMaxP / 16; ++kp) {
        if (16 * kp >= P16) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(v.ss + (16 * kp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDC +
                                         16 * kn + 8 * (lane >> 4)));
        mma_bf16(oc[0], dyf[kp], bfr[0], bfr[1]);
        mma_bf16(oc[1], dyf[kp], bfr[2], bfr[3]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 16 * kn + 8 * half + 2 * t4;
        const float2 c0 = bf2f_at(v.cs + i0 * LDC + n), c1 = bf2f_at(v.cs + i1 * LDC + n);
        o0 = fmaf(oc[half][0], c0.x, fmaf(oc[half][1], c0.y, o0));
        o1 = fmaf(oc[half][2], c1.x, fmaf(oc[half][3], c1.y, o1));
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, o);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, o);
      o0 += __shfl_xor_sync(0xffffffffu, o0, o);
      o1 += __shfl_xor_sync(0xffffffffu, o1, o);
    }
    o0 *= fast_exp2(ci0);
    o1 *= fast_exp2(ci1);
    __syncthreads();  // W and the column sums are complete

    // V2 = B g^T (rows j of the warp); x . V2 for ddt and dcum; then dx =
    // e dt V2 + W^T dy (k = i >= j) in the same registers.
    float v1[kMaxP / 8][4];
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) v1[n][0] = v1[n][1] = v1[n][2] = v1[n][3] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NB / 16; ++kn) {
      if (16 * kn >= N16) continue;
      uint32_t af[4];
      ldmatrix_x4(af, smem_addr(v.bs + (16 * warp + (lane & 15)) * LDC + 16 * kn + 8 * (lane >> 4)));
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        if (16 * dp >= P16) continue;
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_addr(v.gs + (16 * dp + (lane & 7) + 8 * (lane >> 4)) * LDC +
                                   16 * kn + 8 * ((lane >> 3) & 1)));
        mma_bf16(v1[2 * dp], af, bfr[0], bfr[1]);
        mma_bf16(v1[2 * dp + 1], af, bfr[2], bfr[3]);
      }
    }
    const float e0 = fast_exp2(cend - ci0), e1 = fast_exp2(cend - ci1);
    const float dt0 = dm[i0], dt1 = dm[i1];
    const float ed0 = e0 * dt0, ed1 = e1 * dt1;
    float xv0 = 0.f, xv1 = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < P16) {
        const float2 xa = bf2f_at(v.xs + i0 * LDX + col), xb = bf2f_at(v.xs + i1 * LDX + col);
        xv0 = fmaf(xa.x, v1[n][0], fmaf(xa.y, v1[n][1], xv0));
        xv1 = fmaf(xb.x, v1[n][2], fmaf(xb.y, v1[n][3], xv1));
      }
      v1[n][0] *= ed0;
      v1[n][1] *= ed0;
      v1[n][2] *= ed1;
      v1[n][3] *= ed1;
    }
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk < warp) continue;
      uint32_t af[4];
      ldmatrix_x4_trans(af, smem_addr(v.ws + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * LDW +
                                      16 * warp + 8 * ((lane >> 3) & 1)));
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        if (16 * dp >= P16) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(v.dys + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDX +
                                         16 * dp + 8 * (lane >> 4)));
        mma_bf16(v1[2 * dp], af, bfr[0], bfr[1]);
        mma_bf16(v1[2 * dp + 1], af, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col >= p.P) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? i1 : i0;
        if (row >= rows) continue;
        bf16* dr = dx + ((static_cast<long long>(b) * p.S + t0 + row) * p.H + h) * p.P;
        const float va = v1[n][2 * r], vb = v1[n][2 * r + 1];
        if ((p.P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dr + col) = __floats2bfloat162_rn(va, vb);
        } else {
          dr[col] = __float2bfloat16(va);
          if (col + 1 < p.P) dr[col + 1] = __float2bfloat16(vb);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      xv0 += __shfl_xor_sync(0xffffffffu, xv0, o);
      xv1 += __shfl_xor_sync(0xffffffffu, xv1, o);
    }
    if (t4 == 0) {
      float cs0 = 0.f, cs1 = 0.f;  // column sums of K over the warps that wrote them
      for (int w = warp; w < kBwdThreads / 32; ++w) {
        cs0 += colp[w * kQc + i0];
        cs1 += colp[w * kQc + i1];
      }
      ddtd[i0] = fmaf(e0, xv0, cs0 + kd[i0]);
      ddtd[i1] = fmaf(e1, xv1, cs1 + kd[i1]);
      tv[i0] = ed0 * xv0;
      tv[i1] = ed1 * xv1;
      dcum[i0] = rs0 - dt0 * cs0 + o0 - ed0 * xv0;
      dcum[i1] = rs1 - dt1 * cs1 + o1 - ed1 * xv1;
    }
    __syncthreads();

    // Through cum: the end terms, dcum's reverse inclusive sum, ddt and da.
    if (warp == 0) {
      float dc[4], tsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dc[e] = dcum[4 * lane + e];
        tsum += tv[4 * lane + e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
      if (lane == 31) dc[3] += tsum + fast_exp2(cend) * gs_dot;
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
        if (r < rows) ddt[(static_cast<long long>(b) * p.S + t0 + r) * p.H + h] = fmaf(ah, acc, ddtd[r]);
        da_part = fmaf(dm[r], acc, da_part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da_part += __shfl_xor_sync(0xffffffffu, da_part, o);
      if (lane == 0) part_a[(static_cast<long long>(b) * nc + c) * p.H + h] = da_part;
    }
    __syncthreads();  // the next head reuses every tile
  }
}

// Pass 6: the tile's shares of dB and dC (see the head comment).
template <int NB>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_bwd_dbc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                   const float* __restrict__ st, const float* __restrict__ cot,
                   float* __restrict__ part_b, float* __restrict__ part_c, Params p,
                   Strides ys, int nc, int vec) {
  using T = BwdTile<NB>;
  constexpr int LDC = T::LDC, LDX = T::LDX, LDW = T::LDW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileView v = tile_view<NB>(smem_raw);

  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;
  const int c = blockIdx.x, ht = blockIdx.y;
  const int b = blockIdx.z / p.G, g = blockIdx.z - (blockIdx.z / p.G) * p.G;
  const int Hg = p.H / p.G;
  const int h0 = g * Hg + ht * kHT, nh = min(kHT, Hg - ht * kHT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int t0 = c * kQc, rows = min(kQc, p.S - t0);
  const long long PN = static_cast<long long>(P16) * N16;
  const float* st_c = st + (static_cast<long long>(b) * nc + c) * p.H * PN;
  const float* cot_c = cot + (static_cast<long long>(b) * nc + c) * p.H * PN;

  load_tile<NB>(v, dt, a, Bm, Cm, p, b, g, t0, rows, h0, nh, vec);
  cp_async_wait<0>();
  __syncthreads();

  const int i0 = 16 * warp + g8, i1 = i0 + 8;
  float accb[NB / 8][4], accc[NB / 8][4];
#pragma unroll
  for (int n = 0; n < NB / 8; ++n)
    accb[n][0] = accb[n][1] = accb[n][2] = accb[n][3] = accc[n][0] = accc[n][1] = accc[n][2] =
        accc[n][3] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    load_head<NB>(v, x, dy, p, ys, b, h, t0, rows, vec);
    load_states<LDC, false>(v.ss, v.gs, st_c + h * PN, cot_c + h * PN, P16, N16);
    cp_async_wait<0>();
    __syncthreads();
    const float* cm = v.cum2 + hh * kQc;
    const float* dm = v.dts + hh * kQc;
    const float cend = cm[kQc - 1], ci0 = cm[i0], ci1 = cm[i1];
    uint32_t dyf[kMaxP / 16][4];
    dy_fragments<NB>(dyf, v.dys, P16);

    // R = dy x^T o L o dt into shared memory (zero above the diagonal).
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk > warp) continue;
      float d[2][4];
      dyx_tile<NB>(d, dyf, v.xs, kk, P16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kk + 8 * half + 2 * t4;
        const float cj0 = cm[j], cj1 = cm[j + 1], d0 = dm[j], d1 = dm[j + 1];
        const float l00 = j <= i0 ? fast_exp2(ci0 - cj0) * d0 : 0.f;
        const float l01 = j + 1 <= i0 ? fast_exp2(ci0 - cj1) * d1 : 0.f;
        const float l10 = j <= i1 ? fast_exp2(ci1 - cj0) * d0 : 0.f;
        const float l11 = j + 1 <= i1 ? fast_exp2(ci1 - cj1) * d1 : 0.f;
        *reinterpret_cast<uint32_t*>(v.ws + i0 * LDW + j) =
            pack_bf16(d[half][0] * l00, d[half][1] * l01);
        *reinterpret_cast<uint32_t*>(v.ws + i1 * LDW + j) =
            pack_bf16(d[half][2] * l10, d[half][3] * l11);
      }
    }
    __syncthreads();

    // dC rows i: R B (k = j <= i), then (exp(cum) dy) s_in
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk > warp) continue;
      uint32_t af[4];
      ldmatrix_x4(af, smem_addr(v.ws + (16 * warp + (lane & 15)) * LDW + 16 * kk + 8 * (lane >> 4)));
#pragma unroll
      for (int np = 0; np < NB / 16; ++np) {
        if (16 * np >= N16) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(v.bs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDC +
                                         16 * np + 8 * (lane >> 4)));
        mma_bf16(accc[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(accc[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    if (c > 0) {  // the first chunk enters with a zero state
      const float ec0 = fast_exp2(ci0), ec1 = fast_exp2(ci1);
#pragma unroll
      for (int kp = 0; kp < kMaxP / 16; ++kp) {
        if (16 * kp >= P16) continue;
        uint32_t af[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // A rows: r even the lane's row i0, odd i1
          const float2 u = bf2f(dyf[kp][r]);
          const float sc = (r & 1) ? ec1 : ec0;
          af[r] = pack_bf16(u.x * sc, u.y * sc);
        }
#pragma unroll
        for (int np = 0; np < NB / 16; ++np) {
          if (16 * np >= N16) continue;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, smem_addr(v.ss + (16 * kp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDC +
                                           16 * np + 8 * (lane >> 4)));
          mma_bf16(accc[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(accc[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    // dB rows j: R^T C (k = i >= j), then (e dt x) g
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk < warp) continue;
      uint32_t af[4];
      ldmatrix_x4_trans(af, smem_addr(v.ws + (16 * kk + (lane & 7) + 8 * (lane >> 4)) * LDW +
                                      16 * warp + 8 * ((lane >> 3) & 1)));
#pragma unroll
      for (int np = 0; np < NB / 16; ++np) {
        if (16 * np >= N16) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(v.cs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDC +
                                         16 * np + 8 * (lane >> 4)));
        mma_bf16(accb[2 * np], af, bfr[0], bfr[1]);
        mma_bf16(accb[2 * np + 1], af, bfr[2], bfr[3]);
      }
    }
    {
      const float ed0 = fast_exp2(cend - ci0) * dm[i0], ed1 = fast_exp2(cend - ci1) * dm[i1];
#pragma unroll
      for (int kp = 0; kp < kMaxP / 16; ++kp) {
        if (16 * kp >= P16) continue;
        uint32_t xf[4], af[4];
        ldmatrix_x4(xf, smem_addr(v.xs + (16 * warp + (lane & 15)) * LDX + 16 * kp + 8 * (lane >> 4)));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 u = bf2f(xf[r]);
          const float sc = (r & 1) ? ed1 : ed0;
          af[r] = pack_bf16(u.x * sc, u.y * sc);
        }
#pragma unroll
        for (int np = 0; np < NB / 16; ++np) {
          if (16 * np >= N16) continue;
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, smem_addr(v.gs + (16 * kp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDC +
                                           16 * np + 8 * (lane >> 4)));
          mma_bf16(accb[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(accb[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the next head reuses every tile
  }

  // The tile's shares, rows of the chunk, (tiles, B, S, G, N) float32.
#pragma unroll
  for (int n = 0; n < NB / 8; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? i1 : i0;
      if (row >= rows) continue;
      const long long base =
          (((static_cast<long long>(ht) * p.B + b) * p.S + t0 + row) * p.G + g) * p.N;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (col + k >= p.N) continue;
        part_b[base + col + k] = accb[n][2 * r + k];
        part_c[base + col + k] = accc[n][2 * r + k];
      }
    }
  }
}

// Pass 4: the reverse state pass, in place. A thread owns kPassE entries of
// (b, h)'s P16 x N16 state; cot[c] holds D_c and becomes g_c+1.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_rpass_kernel(float* __restrict__ cot, const float* __restrict__ dec,
                       const float* __restrict__ dstate, int nc, int H, int P, int N,
                       int P16, int N16) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = kPassE * (blockIdx.x * kPassThreads + threadIdx.x);
  const int PN = P16 * N16;
  if (e >= PN) return;
  const int pp = e / N16, n0 = e - pp * N16;
  const long long cstride = static_cast<long long>(H) * PN;
  float* base = cot + (static_cast<long long>(b) * nc * H + h) * PN + e;
  const float* db = dec + static_cast<long long>(b) * nc * H + h;
  float s[kPassE];
#pragma unroll
  for (int k = 0; k < kPassE; ++k)
    s[k] = dstate != nullptr && pp < P && n0 + k < N
               ? dstate[((static_cast<long long>(b) * H + h) * P + pp) * N + n0 + k]
               : 0.f;
  for (int c1 = nc; c1 > 0; c1 -= kPassUnroll) {  // chunks c1 - 1 down to c1 - kPassUnroll
    float2 dv[kPassUnroll];
    float d[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      dv[u] = make_float2(0.f, 0.f);
      d[u] = 1.f;
      if (c >= 0) {
        dv[u] = *reinterpret_cast<const float2*>(base + c * cstride);
        d[u] = db[c * H];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int c = c1 - 1 - u;
      if (c < 0) continue;
      *reinterpret_cast<float2*>(base + c * cstride) = make_float2(s[0], s[1]);
      s[0] = fmaf(d[u], s[0], dv[u].x);
      s[1] = fmaf(d[u], s[1], dv[u].y);
    }
  }
}

__device__ __forceinline__ void store_out(bf16* ptr, float v) { *ptr = __float2bfloat16(v); }
__device__ __forceinline__ void store_out(float* ptr, float v) { *ptr = v; }

// dB and dC: the tiles' partial sums added in tile order.
template <typename OutT>
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ part_b,
                                   const float* __restrict__ part_c, OutT* __restrict__ dB,
                                   OutT* __restrict__ dC, long long count, int tiles) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sb = 0.f, sc = 0.f;
  for (int t = 0; t < tiles; ++t) {
    sb += part_b[t * count + i];
    sc += part_c[t * count + i];
  }
  store_out(dB + i, sb);
  store_out(dC + i, sc);
}

// da: the (rows, H) partials added in row order.
__global__ void ssd_bwd_da_kernel(const float* __restrict__ part_a, float* __restrict__ da,
                                  int rows, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part_a[static_cast<long long>(r) * H + h];
  da[h] = s;
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

int launch_bwd_f32(const float* x, const float* dt, const float* a, const float* Bm,
                   const float* Cm, const float* dy, const float* dstate, float* dx, float* ddt,
                   float* da, float* dB, float* dC, float* st, float* part_b, float* part_c,
                   float* part_a, const Params& p, const Strides& ys, int nc, int tiles,
                   cudaStream_t stream) {
  static bool attr_set = false;  // the opt-in above 48 KB, once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * f32_smem_floats(kMaxP, 128)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  ssd_bwd_f32_kernel<<<dim3(tiles, p.B * p.G), kBwdThreads, sizeof(float) * f32_smem_floats(p.P, p.N),
                       stream>>>(x, dt, a, Bm, Cm, dy, dstate, dx, ddt, st, part_b, part_c,
                                 part_a, p, ys, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long count = static_cast<long long>(p.B) * p.S * p.G * p.N;
  ssd_bwd_sum_kernel<float><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      part_b, part_c, dB, dC, count, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_da_kernel<<<(p.H + 127) / 128, 128, 0, stream>>>(part_a, da, p.B, p.H);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_bwd_bf16(const bf16* x, const float* dt, const float* a, const bf16* Bm,
                    const bf16* Cm, const bf16* dy, const float* dstate, bf16* dx, float* ddt,
                    float* da, bf16* dB, bf16* dC, float* st, float* cot, float* dec,
                    float* fin, float* part_b, float* part_c, float* part_a, const Params& p,
                    const Strides& ys, int nc, int tiles, int vec, cudaStream_t stream) {
  static bool attr_set = false;  // the opt-ins above 48 KB, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_state_kernel<NB, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(state_smem<NB>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_state_kernel<NB, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(state_smem<NB>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_dx_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(BwdTile<NB>::kSmem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_dbc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(BwdTile<NB>::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;
  const int groups = (P16 * N16 / kPassE + kPassThreads - 1) / kPassThreads;
  // 1-2. the entering states
  ssd_chunk_state_kernel<NB, false><<<dim3(nc, p.H, p.B), kStateThreads, state_smem<NB>(), stream>>>(
      x, dt, a, Bm, st, dec, p, nc, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_pass_kernel<<<dim3(groups, p.H, p.B), kPassThreads, 0, stream>>>(
      st, dec, fin, nc, p.H, p.P, p.N, P16, N16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // 3-4. D_c, then the cotangents of the chunks' end states
  Params pc = p;
  pc.x_sb = ys.sb;
  pc.x_ss = ys.ss;
  pc.x_sh = ys.sh;
  pc.b_sb = p.c_sb;
  pc.b_ss = p.c_ss;
  pc.b_sg = p.c_sg;
  ssd_chunk_state_kernel<NB, true><<<dim3(nc, p.H, p.B), kStateThreads, state_smem<NB>(), stream>>>(
      dy, dt, a, Cm, cot, dec, pc, nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_state_rpass_kernel<<<dim3(groups, p.H, p.B), kPassThreads, 0, stream>>>(
      cot, dec, dstate, nc, p.H, p.P, p.N, P16, N16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // 5-6. the chunks
  const dim3 grid(nc, tiles, p.B * p.G);
  ssd_bwd_dx_kernel<NB><<<grid, kBwdThreads, BwdTile<NB>::kSmem, stream>>>(
      x, dt, a, Bm, Cm, dy, st, cot, dx, ddt, part_a, p, ys, nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dbc_kernel<NB><<<grid, kBwdThreads, BwdTile<NB>::kSmem, stream>>>(
      x, dt, a, Bm, Cm, dy, st, cot, part_b, part_c, p, ys, nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // 7-8. the fixed-order sums
  const long long count = static_cast<long long>(p.B) * p.S * p.G * p.N;
  ssd_bwd_sum_kernel<bf16><<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(
      part_b, part_c, dB, dC, count, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_da_kernel<<<(p.H + 127) / 128, 128, 0, stream>>>(part_a, da, p.B * nc, p.H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy (B, S, H, P) with element strides (x_sb, x_ss, x_sh) and (y_sb,
// y_ss, y_sh), Bm and Cm (B, S, G, N) with strides (b_*) and (c_*), dt (B,
// S, H) float32 with strides (dt_*), a (H,) float32 contiguous, dstate (B,
// H, P, N) float32 contiguous or null; unit stride along P and N. dtype 0
// float32 (chunks of 32), 1 bfloat16 (chunks of 128); nc = ceil(S /
// chunk), tiles = ceil((H / G) / 8). Outputs contiguous: dx (B, S, H, P)
// and dB, dC (B, S, G, N) in the inputs' dtype, ddt (B, S, H) and da (H,)
// float32. Scratch (float32, kernel.py::bwd_plan): states (B, nc, H, P16,
// N16) (float32: (B, nc, H, P, N)); bfloat16 only: cotan like states, decay
// (B, nc, H), final (B, H, P, N); part_b and part_c (tiles, B, S, G, N);
// part_a (B, nc, H) (float32: (B, H)). Launches on `stream` and returns
// cudaGetLastError() (0 when every launch was taken).
extern "C" int ssd_chunk_bwd(
    const void* x, const float* dt, const float* a, const void* Bm, const void* Cm,
    const void* dy, const float* dstate, void* dx, float* ddt, float* da, void* dB, void* dC,
    float* states, float* cotan, float* decay, float* final_state, float* part_b,
    float* part_c, float* part_a, int B, int S, int H, int G, int P, int N, int nc, int tiles,
    long long x_sb, long long x_ss, long long x_sh, long long b_sb, long long b_ss,
    long long b_sg, long long c_sb, long long c_ss, long long c_sg, long long dt_sb,
    long long dt_ss, long long dt_sh, long long y_sb, long long y_ss, long long y_sh,
    int dtype, void* stream) {
  const int chunk = dtype == 1 ? kQc : kQf;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > 128 || H > 65535 || B * G > 65535 || nc != (S + chunk - 1) / chunk ||
      tiles != (H / G + kHT - 1) / kHT || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, P, N, x_sb, x_ss, x_sh, b_sb, b_ss, b_sg,
                 c_sb, c_ss, c_sg, dt_sb, dt_ss, dt_sh};
  const Strides ys{y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_f32(static_cast<const float*>(x), dt, a, static_cast<const float*>(Bm),
                          static_cast<const float*>(Cm), static_cast<const float*>(dy), dstate,
                          static_cast<float*>(dx), ddt, da, static_cast<float*>(dB),
                          static_cast<float*>(dC), states, part_b, part_c, part_a, p, ys, nc,
                          tiles, s);
  if (cotan == nullptr || decay == nullptr || final_state == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte tile loads need every row start 16-byte aligned.
  const auto al = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vec = al(x) && al(Bm) && al(Cm) && al(dy) && P % 8 == 0 && N % 8 == 0 &&
                  (x_sb | x_ss | x_sh | b_sb | b_ss | b_sg | c_sb | c_ss | c_sg | y_sb | y_ss |
                   y_sh) % 8 == 0;
  const bf16 *xb = static_cast<const bf16*>(x), *bb = static_cast<const bf16*>(Bm),
             *cb = static_cast<const bf16*>(Cm), *yb = static_cast<const bf16*>(dy);
  bf16 *dxb = static_cast<bf16*>(dx), *dbb = static_cast<bf16*>(dB), *dcb = static_cast<bf16*>(dC);
#define SSD_BWD_LAUNCH(NBV)                                                                  \
  return launch_bwd_bf16<NBV>(xb, dt, a, bb, cb, yb, dstate, dxb, ddt, da, dbb, dcb, states, \
                              cotan, decay, final_state, part_b, part_c, part_a, p, ys, nc,  \
                              tiles, vec, s)
  if (N <= 16) SSD_BWD_LAUNCH(16);
  SSD_BWD_LAUNCH(128);
#undef SSD_BWD_LAUNCH
}

extern "C" const char* ssd_chunk_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
