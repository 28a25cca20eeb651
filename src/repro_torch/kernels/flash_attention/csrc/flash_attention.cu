// Online-softmax GQA attention (causal with offset, sliding window), forward,
// for Hopper (sm_90a). Its gradient is K5b (flash_attention_bwd.cu); the
// helpers both share are in flash_attention.cuh.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// `flash_attention_kernel` (Pallas body `_flash_kernel`):
//
//   s[i, t] = (q[i, :] * scale) . k[t, :]                    (float32)
//   visible: t < Skv, and t <= i + (Skv - Sq) when causal, and
//            t > i + (Skv - Sq) - window when window > 0
//   o[i, :] = sum_t softmax_t(s[i, :])[t] * v[t, :]          (cast to q's type)
//
// for q (B, H, Sq, D) and k, v (B, Hk, Skv, D) with H % Hk == 0 (query head h
// reads kv head h / (H / Hk), the reference's `kv_map`), read through their
// strides, so the model's (B, S, H, D) tensors go in without a transposed
// copy. It is every prefill attention of the LM path (hymba: window 1024,
// D = 64, 25 query over 5 kv heads; qwen3: causal, D = 128, 16 over 8) and
// every attention forward of LM training. Asked for it (`lse` not null), it
// also writes each row's float32 log-sum-exp of its scaled visible scores,
// (B, H, Sq): the one statistic K5b needs to recompute the probabilities.
//
// The TPU kernel walks every kv block of a q block in a sequential grid axis
// and masks; here a block walks only the kv tiles that the causal bound and
// the window do not wholly exclude (`kv_tile_range`, mirrored in Python by
// kernel.py's `kv_tile_range` for the CPU tests): under hymba's window of
// 1024 a 128-row q tile at S = 4,096 reads 18 or 19 kv tiles of 64, not up
// to 64 of them, and at S = 32,768 not up to 512.
//
// What bounds it: about 4 * D operations per visible (query, key) pair (the
// score and its share of the weighted sum); 9.4e10 at hymba's prefill (B =
// 4, S = 4,096, 25 heads, 3.67 M visible pairs per head) and 2.7e11 at
// qwen3's, against 126 and 201 MB of q, k, v and o: operations, 0.095 and
// 0.278 ms at the bf16 tensor-core rate of an H100 SXM (989 TFLOP/s).
//
// bf16 inputs (the LM path): the FlashAttention-2 shape on the tensor cores,
// `flash_attention_tc_kernel`. One block per (b, h, 128-row q tile); each
// warp owns one or two 16-row m tiles (`TcConfig`: D <= 64 runs 4 warps x 2
// m tiles, three blocks per SM; D = 128 runs 8 warps x 1, two blocks per
// SM, as many as the registers allow).
//   * Q, K and V tiles come in by 16-byte cp.async copies into shared memory
//     (rows padded by 16 bytes, so that the 8 rows of each ldmatrix hit 8
//     distinct 16-byte bank groups). K and V have two stages each: tile t+1's
//     K is in flight while tile t's softmax and P V run, and its V while the
//     next Q K^T runs. Rows past Sq or Skv and the columns D .. D16 - 1 (D
//     rounded up to 16) are zero-filled by the copy itself.
//   * S = Q K^T by mma.sync m16n8k16 bf16 -> float32; Q's A fragments and
//     K's B fragments by ldmatrix from shared memory (K's rows are the B
//     operand's columns, as .col wants). Q is re-read each tile rather than
//     held in registers: at D = 128 that is what lets two blocks share an SM.
//     With two m tiles a warp feeds each K and V fragment to both.
//   * The online softmax runs on the accumulator fragments: a row's max and
//     sum are reduced over the 4 lanes of a quad only. The scale and log2(e)
//     are applied to the float32 scores inside the exponent (ex2.approx), so
//     q is never rounded after scaling. The mask is evaluated only in tiles
//     that cut the causal diagonal, the window's edge or Skv
//     (`tile_needs_mask`); a masked entry contributes exactly 0, so a tile
//     whose rows are all masked leaves the running max and sum unchanged.
//   * P is split in registers into two bf16 terms, its bf16 rounding and
//     the rest, and both are A operands of P V as they stand (the S
//     accumulator's layout is the A fragment's); V's fragments by
//     ldmatrix.trans, each feeding both terms. The pair carries P to ~16
//     bits: P rounded once to bf16 (8 bits, as FlashAttention-2 does)
//     missed the plain version's bf16 tolerance by up to 2.8x on the LM
//     models' own inputs (outputs that cancel to near zero), at a third
//     more tensor work than one term. O stays in float32 registers and is
//     normalised once at the end.
//   * No split over kv and no atomics: a second launch gives the same bits.
//   * D a multiple of 16 up to 128 runs natively (the k-steps and O's column
//     tiles past D16 are skipped); any other multiple of 8 is padded with
//     zeros to D16 in shared memory. Two instantiations, D <= 64 and <= 128.
// This design stops at mma.sync and reaches 13-15% of the bf16 rate at the
// LM shapes (PERF.md): Hopper's full tensor rate needs wgmma (warpgroup
// products from shared memory) fed by TMA from a producer warp, which is
// later work.
//
// float32 inputs keep the CUDA-core kernel, `flash_attention_f32_kernel`
// (float32 arithmetic throughout, which the float32 model's checks need):
// one block of 256 threads per (b, h, 64-row q tile); the q tile (pre-scaled),
// one 64-key tile of K and then of V, and the 64 x 64 probabilities in
// shared memory (rows padded by 4 floats); thread (rg, cg) = (tid / 16, tid
// % 16) owns query rows 4 rg .. 4 rg + 3, keys cg + 16 j (j < 4) of the
// scores and columns 4 cg + 64 jj + e of the output; the running max is a
// 4-step xor shuffle over a half-warp, the sum is reduced once at the end.

#include "flash_attention.cuh"

namespace {

struct Params {
  int B, H, Hk, Sq, Skv, D, causal, window;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
};

// ===========================================================================
// float32: the CUDA-core kernel
// ===========================================================================
// NJ4: float4 column groups a thread owns in the output (D <= 64 * NJ4).
template <int NJ4>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.D + 4;
  float* qs = smem;                 // kTile x ld, pre-scaled q
  float* kv = qs + kTile * ld;      // kTile x ld, the K tile, then the V tile
  float* ps = kv + kTile * ld;      // kTile x kLP, probabilities

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest tiles first
  const int off = p.Skv - p.Sq;
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + hk * p.k_sh;
  const float* vb = v + b * p.v_sb + hk * p.v_sh;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;

  int t_beg, t_end;
  kv_tile_range(p, q0, kTile, kTile, t_beg, t_end);

  load_tile(qs, qb, p.q_ss, q0, p.Sq, p.D, ld, p.scale);

  float m[4], l[4], acc[4][4 * NJ4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ4; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's V and probabilities are read
    load_tile(kv, kb, p.k_ss, k0, p.Skv, p.D, ld, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.D; d += 4) {
      float4 qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kv + (cg + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kk[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + off;
      bool allow[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        allow[j] = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                   (p.window <= 0 || kpos > qpos - p.window);
        if (allow[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < 4 * NJ4; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = allow[j] ? expf(s[i][j] - m_new) : 0.f;
        l[i] += pr;
        ps[(rg * 4 + i) * kLP + cg + 16 * j] = pr;
      }
    }
    __syncthreads();  // the K tile is read
    load_tile(kv, vb, p.v_ss, k0, p.Skv, p.D, ld, 1.f);
    __syncthreads();

    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg * 4 + i) * kLP + kk);
#pragma unroll
      for (int jj = 0; jj < NJ4; ++jj) {
        const int col = cg * 4 + 64 * jj;
        if (col < p.D) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 vv = *reinterpret_cast<const float4*>(kv + (kk + e) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              acc[i][jj * 4 + 0] = fmaf(pe, vv.x, acc[i][jj * 4 + 0]);
              acc[i][jj * 4 + 1] = fmaf(pe, vv.y, acc[i][jj * 4 + 1]);
              acc[i][jj * 4 + 2] = fmaf(pe, vv.z, acc[i][jj * 4 + 2]);
              acc[i][jj * 4 + 3] = fmaf(pe, vv.w, acc[i][jj * 4 + 3]);
            }
          }
        }
      }
    }
  }

  float* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = row_sum16(l[i]);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = q0 + rg * 4 + i;
    if (row >= p.Sq) continue;
    if (lse != nullptr && cg == 0)  // m is a max of the pre-scaled scores
      lse[static_cast<long long>(bh) * p.Sq + row] = m[i] + logf(sum);
    float* orow = ob + static_cast<long long>(row) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 64 * jj + e;
        if (col < p.D) orow[col] = acc[i][jj * 4 + e] * inv;
      }
  }
}

template <int NJ4>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kTile * (p.D + 4) + kTile * kLP);
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_f32_kernel<NJ4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * (2 * kTile * (64 * NJ4 + 4) + kTile * kLP)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + kTile - 1) / kTile);
  flash_attention_f32_kernel<NJ4><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// bfloat16: the tensor-core kernel
// ===========================================================================
constexpr int kBM = 128;  // q rows per block
constexpr int kBN = 64;   // keys per kv tile

// Per head-dim instance: kMT 16-row m tiles per warp, kWarps warps (kBM =
// 16 kMT kWarps) and kMinBlocks blocks per SM for the register budget. Each
// warp's K and V fragments feed kMT m tiles, so kMT = 2 halves the shared
// memory read per product; it suits the D <= 64 instance (168 registers,
// 20 bytes spilled, three blocks of 4 warps per SM) but spills heavily at
// D = 128, which runs one m
// tile per warp (128 registers, two blocks of 8 warps per SM). Chosen on an
// H100 against the other combinations (PERF.md).
template <int kD> struct TcConfig;
template <> struct TcConfig<64> { static constexpr int kMT = 2, kWarps = 4, kMinBlocks = 3; };
template <> struct TcConfig<128> { static constexpr int kMT = 1, kWarps = 8, kMinBlocks = 2; };

// One kv tile's online-softmax step on one m tile's S fragments (s[j]: keys
// 8 j .. 8 j + 7 of the tile; entries 0, 1 in row g, 2, 3 in row g + 8),
// then P as the A fragments of P V, in two bf16 terms: pa its rounding, pl
// the rest. kMask: evaluate the mask.
template <bool kMask, int NT>
__device__ __forceinline__ void softmax_step(const Params& p, float (*s)[4],
                                             float* m, float* l, float (*acc)[4],
                                             uint32_t (*pa)[4], uint32_t (*pl)[4],
                                             int row_pos,
                                             int k0, int t4, float sc) {
  if (kMask) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qpos = row_pos + 8 * (e >> 1);
        const bool allow = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                           (p.window <= 0 || kpos > qpos - p.window);
        if (!allow) s[j][e] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float corr[2], msc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = fast_exp2((m[r] - m_new) * sc);
    m[r] = m_new;
    msc[r] = m_new * sc;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
    acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = fast_exp2(fmaf(s[j][e], sc, -msc[e >> 1]));
      if (kMask && s[j][e] == kNegInf) pr = 0.f;  // exactly 0, never exp(0)
      s[j][e] = pr;
      l[e >> 1] += pr;
    }
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) to_a_frags(s, kk, pa[kk], pl[kk]);
}

// kD: 64 or 128, the largest D16 the instance takes (its register arrays).
template <int kD>
__global__ void __launch_bounds__(32 * TcConfig<kD>::kWarps, TcConfig<kD>::kMinBlocks)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, Params p) {
  constexpr int kMT = TcConfig<kD>::kMT;
  constexpr int kThreadsPerBlock = 32 * TcConfig<kD>::kWarps;
  static_assert(16 * kMT * TcConfig<kD>::kWarps == kBM, "a block covers kBM rows");
  constexpr int LDS = kD + 8;  // padded row: 16 bytes past the data
  constexpr int KT = kD / 16;  // k-steps of Q K^T
  constexpr int NT = kD / 8;   // n8 column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBM x LDS
  bf16* ks = qs + kBM * LDS;                     // 2 stages of kBN x LDS
  bf16* vs = ks + 2 * kBN * LDS;                 // 2 stages of kBN x LDS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int off = p.Skv - p.Sq;
  const bf16* qb = q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = v + b * p.v_sb + hk * p.v_sh;
  const int D16 = (p.D + 15) & ~15;
  const int nk = D16 / 16;  // live k-steps, and live 16-column pairs of O
  const float sc = p.scale * kLog2e;

  int t_beg, t_end;
  kv_tile_range(p, q0, kBM, kBN, t_beg, t_end);

  // Groups in flight, oldest first: {Q, K(t_beg)}, {V(t_beg)}; then each
  // iteration commits {K(t + 1)} after Q K^T and {V(t + 1)} after P V (empty
  // past the last tile), so "all but one complete" always means the operand
  // about to be read has landed.
  load_tile_async<LDS, kThreadsPerBlock>(qs, qb, p.q_ss, q0, p.Sq, kBM, p.D, D16);
  load_tile_async<LDS, kThreadsPerBlock>(ks, kb, p.k_ss, t_beg * kBN, p.Skv, kBN, p.D, D16);
  cp_async_commit();
  load_tile_async<LDS, kThreadsPerBlock>(vs, vb, p.v_ss, t_beg * kBN, p.Skv, kBN, p.D, D16);
  cp_async_commit();

  float acc[kMT][NT][4];
  float m[kMT][2], l[kMT][2];
  uint32_t q_addr[kMT];  // Q's A fragments are re-read from shared memory
  int row_pos[kMT];      // position of this lane's first row in each m tile
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
    const int r0 = 16 * (kMT * warp + mt);
    q_addr[mt] = smem_addr(qs + (r0 + (lane & 15)) * LDS + 8 * (lane >> 4));
    row_pos[mt] = q0 + r0 + g + off;
  }

  for (int t = t_beg; t < t_end; ++t) {
    const int stage = (t - t_beg) & 1;
    const bf16* kt = ks + stage * kBN * LDS;
    const bf16* vt = vs + stage * kBN * LDS;
    cp_async_wait<1>();  // K(t) (and Q) landed
    __syncthreads();

    float s[kMT][kBN / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (kk >= nk) continue;
      uint32_t qa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(qa[mt], q_addr[mt] + 32 * kk);
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, smem_addr(kt + (16 * np + (lane & 7) + 8 * (lane >> 4)) * LDS +
                                   16 * kk + 8 * ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], bfr[0], bfr[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], bfr[2], bfr[3]);
        }
      }
    }

    if (t + 1 < t_end)
      load_tile_async<LDS, kThreadsPerBlock>(ks + (stage ^ 1) * kBN * LDS, kb, p.k_ss, (t + 1) * kBN,
                           p.Skv, kBN, p.D, D16);
    cp_async_commit();

    const int k0 = t * kBN;
    uint32_t pa[kMT][kBN / 16][4], pl[kMT][kBN / 16][4];  // P's bf16 head and rest
    const bool masked = tile_needs_mask(p, q0, k0, kBM, kBN);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (masked)
        softmax_step<true, NT>(p, s[mt], m[mt], l[mt], acc[mt], pa[mt], pl[mt], row_pos[mt], k0, t4, sc);
      else
        softmax_step<false, NT>(p, s[mt], m[mt], l[mt], acc[mt], pa[mt], pl[mt], row_pos[mt], k0, t4, sc);
    }

    cp_async_wait<1>();  // V(t) landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < KT; ++dp) {
        if (dp >= nk) continue;
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, smem_addr(vt + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS +
                                         16 * dp + 8 * (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt][kk], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt][kk], bfr[2], bfr[3]);
          mma_bf16(acc[mt][2 * dp], pl[mt][kk], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * dp + 1], pl[mt][kk], bfr[2], bfr[3]);
        }
      }
    }

    if (t + 1 < t_end)
      load_tile_async<LDS, kThreadsPerBlock>(vs + (stage ^ 1) * kBN * LDS, vb, p.v_ss, (t + 1) * kBN,
                           p.Skv, kBN, p.D, D16);
    cp_async_commit();
  }

  bf16* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = q0 + 16 * (kMT * warp + mt) + g + 8 * r;
      if (row >= p.Sq) continue;
      if (lse != nullptr && t4 == 0)  // m is a max of the unscaled scores
        lse[static_cast<long long>(bh) * p.Sq + row] = m[mt][r] * p.scale + logf(sum);
      bf16* orow = ob + static_cast<long long>(row) * p.o_ss;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
      }
    }
}

template <int kD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
              const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kBM + 4 * kBN) * (kD + 8);
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + kBM - 1) / kBM);
  flash_attention_tc_kernel<kD><<<grid, 32 * TcConfig<kD>::kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o with element strides (batch, head, sequence) and unit stride
// along D; dtype 0 float32, 1 bfloat16 (all four the same). D a multiple of
// 8 up to 128, every stride a multiple of 8 and every pointer 16-byte
// aligned (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Hk,
    int Sq, int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D > 128 || D % 8 != 0 || (Sq + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, H, Hk, Sq, Skv, D, causal, window,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  if (dtype == 0) {
    return D <= 64 ? launch_f32<1>(q, k, v, o, L, p, s) : launch_f32<2>(q, k, v, o, L, p, s);
  }
  if (dtype == 1) {
    return D <= 64 ? launch_tc<64>(q, k, v, o, L, p, s) : launch_tc<128>(q, k, v, o, L, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
