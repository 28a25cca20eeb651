// Mamba2 SSD chunk scan from a zero state, for Hopper (sm_90a); its backward
// is ssd_chunk_bwd.cu (K6b).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk/kernel.py `ssd_chunk_kernel`
// (Pallas body `_ssd_chunk_kernel`), which computes, per head, the
// recurrence
//
//   s_t = exp(dt_t a) s_{t-1} + dt_t x_t (x) B_t,     y_t = s_t C_t
//
// chunk by chunk, walking the chunks of a head in its sequential grid axis
// with the (P, N) state in VMEM: within a chunk y = (C B^T o L o dt) x +
// exp(cum) C s_prev with L[i, j] = exp(cum_i - cum_j) for i >= j (cum the
// inclusive sum of dt a over the chunk), then s = exp(cum_end) s_prev +
// sum_j exp(cum_end - cum_j) dt_j x_j (x) B_j. The TPU kernel takes one
// sequence with B and C per head and returns y only; the model's mixer
// (`ssd_mix(return_state=True)`) needs more, so this kernel's contract is
// wider: a batch axis, G groups of B and C broadcast to H heads (head h
// reads group h / (H / G), nothing repeated in memory), and the final
// state as a second output.
//
//   x (B, S, H, P) and Bm, Cm (B, S, G, N): float32 or bfloat16, read
//   through their strides (unit stride along P and N), so the model's views
//   of the conv output go in without copies; dt (B, S, H) and a (H,)
//   float32. Out: y (B, S, H, P) contiguous in x's dtype, final_state (B, H,
//   P, N) float32 contiguous. Steps past S (the last chunk's padding) have
//   dt = 0: decay 1 and no input, so the final state is the state after
//   step S - 1. No initial state (the prefill starts from zeros).
//
// What bounds it: the bytes of x, B, C, dt and y (each read or written
// once) and the final state: 215 MB at hymba's prefill (B = 4, S = 4,096,
// H = 50, P = 64, N = 16) and 219 MB at mamba2's (H = 48, N = 128), about
// 0.065 ms over 3.35 TB/s; the recurrence's 4 P N operations per step and
// head take less at the bf16 tensor rate. The TPU kernel's shape, one
// sequential walk per head, gives the card B H blocks (200 at hymba, 50 at
// the 32k prefill) each walking S / Q chunks one after another, with every
// product on the CUDA cores: 1-3% of the bound.
//
// bfloat16 inputs (the LM path): SSD's chunk-parallel decomposition (Dao &
// Gu 2024), chunk Q = 128 (the TPU kernel's default), three launches on one
// stream, every product on the tensor cores (mma.sync m16n8k16 bf16 ->
// float32, operands by ldmatrix from shared memory padded by 16 bytes a
// row, so the 8 rows of an ldmatrix hit 8 distinct bank groups). The grid
// has B H S / Q blocks or more (6,400 at hymba's prefill, 12,800 at 32k):
//   1. `ssd_chunk_state_kernel`, one block of 8 warps per (chunk, head,
//      batch): the chunk's inclusive sum of dt a (one warp, lane l owns
//      rows 4l..4l+3), then the chunk's own end state from zero, local =
//      (wk o x)^T B with wk_j = exp(cum_end - cum_j) dt_j, a (P x Q)(Q x N)
//      product (x^T and B by ldmatrix.trans; warp w owns state rows
//      16 (w % 4).. and, from N16 = 32 on, half w / 4 of the columns).
//      Writes local (float32) to a scratch (B, nc, H, P16, N16) and
//      exp(cum_end) to (B, nc, H).
//   2. `ssd_state_pass_kernel`, sequential over chunks only, parallel over
//      (b, h) and the P16 x N16 state entries (two per thread, 16 chunks
//      loaded ahead): s_c = exp(cum_end,c) s_{c-1} + local_c in float32.
//      It overwrites each chunk's local with the state entering that chunk,
//      in place and already split for pass 3 (below), and writes the final
//      state in float32. Elementwise and memory-bound.
//   3. `ssd_chunk_out_kernel`, one block of 8 warps per (chunk, tile of up
//      to 8 heads of one group, batch), two blocks per SM; warp w owns rows
//      16w..16w+15. C B^T once per block, kept in registers and shared by
//      the tile's heads (both LM configurations have one group), then per
//      head y = (C B^T o L o dt) x + exp(cum) C s_in^T, written once in bf16.
//      A head's x and s_in tiles come by cp.async, double-buffered under the
//      previous head's products where two blocks still fit an SM's shared
//      memory (N16 <= 64), single-buffered at N16 = 128. The tile is a
//      constant, kHT = 8 heads (`kernel.py::chunk_plan` mirrors the grid).
// What bounds this design: bytes. The scratch is written, read, written
// and read again (201 MB at mamba2, 26 MB at hymba), and x is read twice
// (passes 1 and 3), so it moves ~4x the bound's bytes at mamba2 and ~2x at
// hymba. Pass 3's loads are not fully hidden under its products: its warps
// are unequal (warp w does w + 1 of the 8 diagonal k-steps), and at 128
// registers the score tile leaves room for two blocks per SM only.
// Numerics: C, B and x are exact bf16 operands. The other operands are
// float32 products (W = C B^T o L o dt, wk o x, the carried state), and one
// rounding to bf16 is the fault that model inputs showed in K5's P: each
// enters as two bf16 terms, its rounding and the rest (~16 bits). For the
// state, pass 2 stores each group of 8 entries of a row as [8 x hi | 8 x
// lo] bf16 in the 32 bytes the 8 float32 held, so that C s_in^T over 8
// state columns is one k16 step whose A fragment repeats C's (two k8
// halves, the same C values against hi and lo). Decays are exp2 of sums of
// dt a log2(e) that are <= 0: cum_i - cum_j on the diagonal 16 x 16 tile,
// and below it the product of exp2(cum_i - cum_r) and a per-head table
// exp2(cum_r - cum_j) dt_j (r the k tile's last row), both at most 1
// (never exp(cum_i) exp(-cum_j), which overflows once a 128-step chunk's
// cum passes -88). No atomics: a second launch gives the same bits. P <=
// 64, N <= 128 (zero-padded to multiples of 16 in shared memory and the
// scratch); instances for N16 <= 16, 32, 64, 128. Tiles load by 16-byte
// cp.async when every stride and pointer allows, else element by element.
//
// float32 inputs keep the CUDA-core kernel `ssd_chunk_f32_kernel` (float32
// arithmetic throughout): one block of 256 threads per (b, h) walks chunks
// of 32 in order with the (P, N) state in shared memory (rows padded by one
// float), a warp computes the chunk's cumulative decay with shuffles, the
// block forms W[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j (j <= i),
// writes y_i = sum_j W[i, j] x_j + exp(cum_i) C_i . s_prev and updates the
// state, each thread accumulating its 4 x NJ entries in registers.
//
// The launch parameters, the tile helpers and pass 1 live in ssd_chunk.cuh,
// shared with the backward (ssd_chunk_bwd.cu, K6b), which launches pass 1
// on dy and C for the state cotangents and reads the chunk states that
// passes 1-2 left when the caller kept them.

#include "ssd_chunk.cuh"

namespace {

// Pass 2: the state entering each chunk. A thread owns kPassE consecutive
// entries of a state row of (b, h), 8 / kPassE lanes one group of 8 (the
// [8 x hi | 8 x lo] layout's unit); grid (entries / (kPassE kPassThreads),
// H, B). Each batch of kPassUnroll chunks is loaded before the warp writes
// into the same 32-byte groups (__syncwarp between).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ st, const float* __restrict__ dec,
                      float* __restrict__ state_out, int nc, int H, int P, int N,
                      int P16, int N16) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = kPassE * (blockIdx.x * kPassThreads + threadIdx.x);  // first entry
  const int PN = P16 * N16;
  const bool valid = e < PN;
  const int part = (e & 7) / kPassE;  // this thread's share of its group of 8
  const long long cstride = static_cast<long long>(H) * PN;  // one chunk
  float* base = st + (static_cast<long long>(b) * nc * H + h) * PN + e;
  // hi and lo of this thread's entries within the group's 32 bytes
  char* grp = reinterpret_cast<char*>(base - (e & 7));
  const float* db = dec + static_cast<long long>(b) * nc * H + h;
  float s[kPassE];
#pragma unroll
  for (int k = 0; k < kPassE; ++k) s[k] = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassUnroll) {
    float loc[kPassUnroll][kPassE], d[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      d[u] = 1.f;
#pragma unroll
      for (int k = 0; k < kPassE; ++k) loc[u][k] = 0.f;
      if (valid && c0 + u < nc) {
        const float2 v = *reinterpret_cast<const float2*>(base + (c0 + u) * cstride);
        loc[u][0] = v.x;
        loc[u][1] = v.y;
        d[u] = db[(c0 + u) * H];
      }
    }
    __syncwarp();  // every lane of a group has read it before any writes
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      if (valid && c0 + u < nc) {
        uint32_t hi, lo;
        split2(s[0], s[1], hi, lo);
        char* g = grp + (c0 + u) * cstride * 4;
        *reinterpret_cast<uint32_t*>(g + 2 * kPassE * part) = hi;
        *reinterpret_cast<uint32_t*>(g + 16 + 2 * kPassE * part) = lo;
      }
#pragma unroll
      for (int k = 0; k < kPassE; ++k) s[k] = fmaf(d[u], s[k], loc[u][k]);
    }
    __syncwarp();  // this batch's writes before the next batch's reads
  }
  if (!valid) return;
  const int pp = e / N16, n0 = e - pp * N16;
  if (pp >= P) return;
  float* so = state_out + ((static_cast<long long>(b) * H + h) * P + pp) * N;
#pragma unroll
  for (int k = 0; k < kPassE; ++k)
    if (n0 + k < N) so[n0 + k] = s[k];
}

// ===========================================================================
// float32: the CUDA-core kernel
// ===========================================================================
constexpr int kQ = 32;  // chunk length: one warp's lanes
constexpr int kThreads = 256;

size_t smem_floats(int P, int N) {
  return kQ * P + 2 * kQ * (N + 1) + kQ * (kQ + 1) + P * (N + 1) + 4 * kQ + 1;
}

// NJ: state columns per thread (N <= 16 * NJ).
template <int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ state_out, Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, ldn = N + 1;
  float* xs = smem;                 // kQ x P
  float* bs = xs + kQ * P;          // kQ x ldn
  float* cs = bs + kQ * ldn;        // kQ x ldn
  float* w = cs + kQ * ldn;         // kQ x (kQ + 1)
  float* st = w + kQ * (kQ + 1);    // P x ldn, the carried state
  float* dts = st + P * ldn;        // kQ
  float* cum = dts + kQ;            // kQ, inclusive sum of dt a
  float* wk = cum + kQ;             // kQ, exp(cum_end - cum_j) dt_j
  float* ec = wk + kQ;              // kQ, exp(cum_i)
  float* dec_end = ec + kQ;         // 1, exp(cum_end)

  const int b = blockIdx.x / p.H, h = blockIdx.x - (blockIdx.x / p.H) * p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const float ah = a[h];
  const float* xb = x + b * p.x_sb + h * p.x_sh;
  const float* bb = Bm + b * p.b_sb + g * p.b_sg;
  const float* cb = Cm + b * p.c_sb + g * p.c_sg;
  const float* db = dt + b * p.dt_sb + h * p.dt_sh;
  float* yb = y + (static_cast<long long>(b) * p.S * p.H + h) * P;

  for (int i = tid; i < P * ldn; i += kThreads) st[i] = 0.f;
  // State-update ownership: rows pr + 16 i (i < 4), columns nc + 16 j.
  const int pr = tid >> 4, nc = tid & 15;
  // Output ownership: column yp, rows yq + 4 r (r < 8).
  const int yp = tid % kMaxP, yq = tid / kMaxP;

  for (int t0 = 0; t0 < p.S; t0 += kQ) {
    __syncthreads();  // the last chunk's state update has read xs, bs
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, c = i - r * P;
      xs[i] = t0 + r < p.S ? xb[(t0 + r) * p.x_ss + c] : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, c = i - r * N;
      const bool in = t0 + r < p.S;
      bs[r * ldn + c] = in ? bb[(t0 + r) * p.b_ss + c] : 0.f;
      cs[r * ldn + c] = in ? cb[(t0 + r) * p.c_ss + c] : 0.f;
    }
    if (tid < kQ) {  // warp 0: the chunk's decays
      const float d = t0 + tid < p.S ? db[(t0 + tid) * p.dt_ss] : 0.f;
      float c = d * ah;
#pragma unroll
      for (int o = 1; o < kQ; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, c, o);
        if (tid >= o) c += u;
      }
      const float end = __shfl_sync(0xffffffffu, c, kQ - 1);
      dts[tid] = d;
      cum[tid] = c;
      wk[tid] = expf(end - c) * d;
      ec[tid] = expf(c);
      if (tid == 0) *dec_end = expf(end);
    }
    __syncthreads();

    // W[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0.
    {
      const int j = tid & (kQ - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (tid >> 5) + 8 * r;
        float s = 0.f;
        if (j <= i) {
          for (int n = 0; n < N; ++n) s = fmaf(cs[i * ldn + n], bs[j * ldn + n], s);
          s *= expf(cum[i] - cum[j]) * dts[j];
        }
        w[i * (kQ + 1) + j] = s;
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} W[i, j] x_j + exp(cum_i) C_i . s_prev
    if (yp < P) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = yq + 4 * r;
        if (t0 + i >= p.S) continue;
        float yd = 0.f;
        for (int j = 0; j <= i; ++j) yd = fmaf(w[i * (kQ + 1) + j], xs[j * P + yp], yd);
        float yo = 0.f;
        for (int n = 0; n < N; ++n) yo = fmaf(cs[i * ldn + n], st[yp * ldn + n], yo);
        yb[static_cast<long long>(t0 + i) * p.H * P + yp] = yd + ec[i] * yo;
      }
    }
    __syncthreads();  // y has read the previous state

    // s = exp(cum_end) s_prev + sum_j (wk_j x_j) (x) B_j
    {
      float acc[4][NJ];
      const float de = *dec_end;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int pp = pr + 16 * i, n = nc + 16 * jn;
          acc[i][jn] = pp < P && n < N ? st[pp * ldn + n] * de : 0.f;
        }
      for (int j = 0; j < kQ; ++j) {
        const float wj = wk[j];
        float u[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pp = pr + 16 * i;
          u[i] = pp < P ? wj * xs[j * P + pp] : 0.f;
        }
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int n = nc + 16 * jn;
          bv[jn] = n < N ? bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jn = 0; jn < NJ; ++jn) acc[i][jn] = fmaf(u[i], bv[jn], acc[i][jn]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int pp = pr + 16 * i, n = nc + 16 * jn;
          if (pp < P && n < N) st[pp * ldn + n] = acc[i][jn];
        }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<long long>(blockIdx.x) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i - pp * N;
    so[i] = st[pp * ldn + n];
  }
}

template <int NJ>
int launch_f32(const void* x, const float* dt, const float* a, const void* Bm,
               const void* Cm, void* y, float* state, const Params& p,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N);
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(kMaxP, 16 * NJ)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  ssd_chunk_f32_kernel<NJ><<<p.B * p.H, kThreads, smem, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), state, p);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3's shared memory per state width: a head's x and s_in are
// double-buffered where two blocks still fit an SM (N16 <= 64), else
// single-buffered.
template <int NB> struct OutTile {
  static constexpr int kStages = NB <= 64 ? 2 : 1;
  static constexpr int LDC = NB + 8, LDS = 2 * NB + 8, LDX = kMaxP + 8;
  static constexpr int kStage = kMaxP * LDS + kQc * LDX;  // s_in and x of a head
  static constexpr int kRegion = kQc * LDC > kStage ? kQc * LDC : kStage;  // B, then a stage
  static constexpr size_t kSmem = sizeof(bf16) * (kQc * LDC + kRegion + (kStages - 1) * kStage) +
                                  3 * sizeof(float) * kHT * kQc;
};

// Pass 3: one block per (chunk, tile of kHT heads of one group, batch), 8
// warps; warp w owns output rows 16 w .. 16 w + 15 of the chunk.
template <int NB>
__global__ void __launch_bounds__(kOutThreads, kOutMinBlocks)
ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, bf16* __restrict__ y,
                     const float* __restrict__ st, Params p, int nc, int vec) {
  using T = OutTile<NB>;
  constexpr int LDC = T::LDC, LDS = T::LDS, LDX = T::LDX;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // kQc x LDC
  bf16* bs = cs + kQc * LDC;                     // kQc x LDC, then the last stage
  // Stage k: s_in as [hi | lo] (kMaxP x LDS), then x (kQc x LDX); the last
  // stage takes B's space once the scores are formed.
  bf16* stage_at[kStages];
  stage_at[kStages - 1] = bs;
  for (int k = 0; k + 1 < kStages; ++k) stage_at[k] = bs + T::kRegion + k * T::kStage;
  float* cum2 = reinterpret_cast<float*>(bs + T::kRegion + (kStages - 1) * T::kStage);
  float* dts = cum2 + kHT * kQc;  // kHT x kQc each
  float* vts = dts + kHT * kQc;

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

  auto load_head = [&](int hh, int stage) {
    const int h = h0 + hh;
    bf16* sdst = stage_at[stage];
    load_rows<kOutThreads>(sdst, LDS, reinterpret_cast<const bf16*>(st_c + h * PN),
                           2 * N16, P16, P16, 2 * N16, 2 * N16, 1);
    load_rows<kOutThreads>(sdst + kMaxP * LDS, LDX, x + b * p.x_sb + t0 * p.x_ss + h * p.x_sh,
                           p.x_ss, rows, kQc, p.P, P16, vec);
  };

  load_rows<kOutThreads>(cs, LDC, Cm + b * p.c_sb + t0 * p.c_ss + g * p.c_sg, p.c_ss,
                         rows, kQc, p.N, N16, vec);
  load_rows<kOutThreads>(bs, LDC, Bm + b * p.b_sb + t0 * p.b_ss + g * p.b_sg, p.b_ss,
                         rows, kQc, p.N, N16, vec);
  cp_async_commit();
  for (int k = 0; k + 1 < kStages; ++k) {  // heads 0 .. stages - 2 in flight
    if (k < nh) load_head(k, k);
    cp_async_commit();
  }
  for (int hh = warp; hh < nh; hh += kOutThreads / 32)
    chunk_cumsum(dt + b * p.dt_sb + t0 * p.dt_ss + (h0 + hh) * p.dt_sh, p.dt_ss, rows,
                 a[h0 + hh], cum2 + hh * kQc, dts + hh * kQc, vts + hh * kQc, lane);
  cp_async_wait<kStages - 1>();  // C and B landed
  __syncthreads();

  // Scores C B^T of the warp's 16 rows against the columns j <= its last
  // row (n8 tiles 0 .. 2 warp + 1), shared by the tile's heads.
  const uint32_t c_addr = smem_addr(cs + (16 * warp + (lane & 15)) * LDC + 8 * (lane >> 4));
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
      ldmatrix_x4(bfr, smem_addr(bs + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LDC +
                                 16 * kn + 8 * ((lane >> 3) & 1)));
      mma_bf16(sc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(sc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
  __syncthreads();  // B is read: its space holds the last stage from here

  const int i0 = 16 * warp + g8;  // this lane's rows: i0 and i0 + 8
  for (int hh = 0; hh < nh; ++hh) {
    const int stage = hh % kStages;
    if (hh + kStages - 1 < nh) load_head(hh + kStages - 1, (hh + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // head hh's x and s_in landed
    __syncthreads();
    const bf16* sst = stage_at[stage];
    const bf16* xt = sst + kMaxP * LDS;
    const float* cm = cum2 + hh * kQc;
    const float* dm = dts + hh * kQc;
    const float* vm = vts + hh * kQc;

    // Off-diagonal: C s_in^T. Per 16 state columns one ldmatrix of C gives
    // two k16 steps over [hi | lo] groups of 8 columns.
    float acc[kMaxP / 8][4];
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (c > 0) {  // the first chunk enters with a zero state
#pragma unroll
      for (int kn = 0; kn < NB / 16; ++kn) {
        if (16 * kn >= N16) continue;
        uint32_t cf[4];
        ldmatrix_x4(cf, c_addr + 32 * kn);
        const uint32_t a0[4] = {cf[0], cf[1], cf[0], cf[1]};
        const uint32_t a1[4] = {cf[2], cf[3], cf[2], cf[3]};
#pragma unroll
        for (int np = 0; np < kMaxP / 16; ++np) {
          if (16 * np >= P16) continue;
          const bf16* row = sst + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LDS +
                            8 * ((lane >> 3) & 1);
          uint32_t bfr[4];
          ldmatrix_x4(bfr, smem_addr(row + 32 * kn));
          mma_bf16(acc[2 * np], a0, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], a0, bfr[2], bfr[3]);
          ldmatrix_x4(bfr, smem_addr(row + 32 * kn + 16));
          mma_bf16(acc[2 * np], a1, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], a1, bfr[2], bfr[3]);
        }
      }
    }
    const float ci0 = cm[i0], ci1 = cm[i0 + 8];
    const float e0 = fast_exp2(ci0), e1 = fast_exp2(ci1);
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      acc[n][0] *= e0; acc[n][1] *= e0;
      acc[n][2] *= e1; acc[n][3] *= e1;
    }

    // Diagonal: (C B^T o L o dt) x over the k16 steps j <= the warp's rows,
    // W in two bf16 terms as A fragments (the score layout is theirs).
    // Below the diagonal tile L o dt = exp2(c_i - c_r) vt_j with r the k
    // tile's last row (both factors at most 1); on it exp2(c_i - c_j) dt_j.
#pragma unroll
    for (int kk = 0; kk < kQc / 16; ++kk) {
      if (kk > warp) continue;
      uint32_t wh[4], wl[4];
      if (kk < warp) {
        const float cr = cm[16 * kk + 15];
        const float u0 = fast_exp2(ci0 - cr), u1 = fast_exp2(ci1 - cr);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* s4 = sc[2 * kk + half];
          const int j = 16 * kk + 8 * half + 2 * t4;
          const float v0 = vm[j], v1 = vm[j + 1];
          split2(s4[0] * u0 * v0, s4[1] * u0 * v1, wh[2 * half], wl[2 * half]);
          split2(s4[2] * u1 * v0, s4[3] * u1 * v1, wh[2 * half + 1], wl[2 * half + 1]);
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* s4 = sc[2 * kk + half];
          const int j = 16 * kk + 8 * half + 2 * t4;
          const float cj0 = cm[j], cj1 = cm[j + 1], d0 = dm[j], d1 = dm[j + 1];
          const float v00 = j <= i0 ? s4[0] * fast_exp2(ci0 - cj0) * d0 : 0.f;
          const float v01 = j + 1 <= i0 ? s4[1] * fast_exp2(ci0 - cj1) * d1 : 0.f;
          const float v10 = j <= i0 + 8 ? s4[2] * fast_exp2(ci1 - cj0) * d0 : 0.f;
          const float v11 = j + 1 <= i0 + 8 ? s4[3] * fast_exp2(ci1 - cj1) * d1 : 0.f;
          split2(v00, v01, wh[2 * half], wl[2 * half]);
          split2(v10, v11, wh[2 * half + 1], wl[2 * half + 1]);
        }
      }
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        if (16 * dp >= P16) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(xt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDX +
                                         16 * dp + 8 * (lane >> 4)));
        mma_bf16(acc[2 * dp], wh, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], wh, bfr[2], bfr[3]);
        mma_bf16(acc[2 * dp], wl, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], wl, bfr[2], bfr[3]);
      }
    }

    const int h = h0 + hh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + 8 * r;
      if (row >= rows) continue;
      bf16* yr = y + ((static_cast<long long>(b) * p.S + t0 + row) * p.H + h) * p.P;
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col >= p.P) continue;
        if ((p.P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
        } else {
          yr[col] = __float2bfloat16(acc[n][2 * r]);
          if (col + 1 < p.P) yr[col + 1] = __float2bfloat16(acc[n][2 * r + 1]);
        }
      }
    }
    __syncthreads();  // stage `stage` is read: a later head may load into it
  }
}

template <int NB>
int launch_bf16(const void* x, const float* dt, const float* a, const void* Bm,
                const void* Cm, void* y, float* state, float* scratch,
                float* decay, int vec, const Params& p, cudaStream_t stream) {
  static bool attr_set = false;  // the opt-ins above 48 KB, once per instance
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_state_kernel<NB, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(state_smem<NB>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_out_kernel<NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(OutTile<NB>::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int nc = (p.S + kQc - 1) / kQc;
  const int P16 = (p.P + 15) & ~15, N16 = (p.N + 15) & ~15;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bm);
  ssd_chunk_state_kernel<NB, false><<<dim3(nc, p.H, p.B), kStateThreads, state_smem<NB>(), stream>>>(
      xb, dt, a, bb, scratch, decay, p, nc, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (P16 * N16 / kPassE + kPassThreads - 1) / kPassThreads;
  ssd_state_pass_kernel<<<dim3(groups, p.H, p.B), kPassThreads, 0, stream>>>(
      scratch, decay, state, nc, p.H, p.P, p.N, P16, N16);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (p.H / p.G + kHT - 1) / kHT;
  ssd_chunk_out_kernel<NB><<<dim3(nc, tiles, p.B * p.G), kOutThreads, OutTile<NB>::kSmem,
                             stream>>>(
      xb, dt, a, bb, static_cast<const bf16*>(Cm), static_cast<bf16*>(y), scratch, p, nc,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, S, H, P) with element strides (x_sb, x_ss, x_sh), Bm and Cm (B, S,
// G, N) with strides (b_sb, b_ss, b_sg) and (c_sb, c_ss, c_sg), dt (B, S, H)
// float32 with strides (dt_sb, dt_ss, dt_sh), a (H,) float32 contiguous;
// unit stride along P and N. dtype 0 float32, 1 bfloat16 (x, Bm, Cm and y).
// y (B, S, H, P) and state (B, H, P, N) float32 contiguous. P <= 64, N <=
// 128, H % G == 0, S >= 1. bfloat16 only: scratch (B, nc, H, P16, N16) and
// decay (B, nc, H) float32 (nc = ceil(S / 128), P16 and N16 = P and N
// rounded up to 16).
// Launches on `stream` and returns cudaGetLastError() (0 when every launch
// was taken).
extern "C" int ssd_chunk_fwd(
    const void* x, const float* dt, const float* a, const void* Bm,
    const void* Cm, void* y, float* state, float* scratch, float* decay,
    int B, int S, int H, int G, int P, int N, long long x_sb, long long x_ss,
    long long x_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, long long dt_sb,
    long long dt_ss, long long dt_sh, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > 128 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, P, N, x_sb, x_ss, x_sh, b_sb, b_ss, b_sg,
                 c_sb, c_ss, c_sg, dt_sb, dt_ss, dt_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (N <= 16) return launch_f32<1>(x, dt, a, Bm, Cm, y, state, p, s);
    if (N <= 32) return launch_f32<2>(x, dt, a, Bm, Cm, y, state, p, s);
    if (N <= 64) return launch_f32<4>(x, dt, a, Bm, Cm, y, state, p, s);
    return launch_f32<8>(x, dt, a, Bm, Cm, y, state, p, s);
  }
  if (dtype != 1 || scratch == nullptr || decay == nullptr || B * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte tile loads need every row start 16-byte aligned.
  const auto al = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vec = al(x) && al(Bm) && al(Cm) && P % 8 == 0 && N % 8 == 0 &&
                  (x_sb | x_ss | x_sh | b_sb | b_ss | b_sg | c_sb | c_ss | c_sg) % 8 == 0;
  if (N <= 16) return launch_bf16<16>(x, dt, a, Bm, Cm, y, state, scratch, decay, vec, p, s);
  if (N <= 32) return launch_bf16<32>(x, dt, a, Bm, Cm, y, state, scratch, decay, vec, p, s);
  if (N <= 64) return launch_bf16<64>(x, dt, a, Bm, Cm, y, state, scratch, decay, vec, p, s);
  return launch_bf16<128>(x, dt, a, Bm, Cm, y, state, scratch, decay, vec, p, s);
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
