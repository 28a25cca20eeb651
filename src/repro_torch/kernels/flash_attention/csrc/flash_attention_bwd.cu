// Flash attention backward (K5b) for Hopper (sm_90a): dq, dk and dv of K5
// (flash_attention.cu) from q, k, v, K5's output o and float32 row
// log-sum-exp lse, and the output's cotangent dO.
//
// Replaces no TPU kernel. The JAX package's Pallas kernel
// (repro/kernels/flash_attention/kernel.py `flash_attention_kernel`) is
// forward only, and its LM trains through autodiff of the jnp blocked
// attention (repro/models/lm/layers.py `flash_attention`, each kv block
// recomputed under jax.checkpoint). This is that gradient as one kernel, so
// that no (Sq, Skv) probability tensor is ever stored:
//
//   P[i, t]  = exp(s[i, t] scale - lse[i]) on visible pairs, exactly 0 on
//              masked ones (K5's mask: causal with offset Skv - Sq, window)
//   Delta[i] = sum_d dO[i, d] O[i, d]
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),
//   dQ = scale dS K,  dK = scale dS^T Q,
//
// with dk and dv summed over the G query heads of each kv head (GQA).
//
// Three launches and no float atomics, so a second call gives the same bits
// (a train step repeated from the same state must, for checkpoint resume):
//   1. fa_bwd_delta_kernel: Delta (float32, (B, H, Sq)), one warp a row.
//   2. dq: one block per (b, h, 64-row q tile), walking the kv tiles that
//      K5's `kv_tile_range` leaves; it recomputes S and dP, forms dS and
//      accumulates dQ in registers.
//   3. dk, dv: one block per (b, kv head, 64-key tile), walking the G query
//      heads of its group and, for each, the q tiles that can see its keys
//      (`q_tile_range`, the transpose of `kv_tile_range`): it recomputes
//      S^T and dP^T and accumulates dK and dV in registers, over the group
//      and the q tiles in a fixed order.
//
// What bounds it: five products of 2 D operations per visible (query, key)
// pair and head (S, dP, dV, dQ, dK); at qwen3's train shape (B = 4, S =
// 4,096, 16 heads over 8, D = 128, causal: 5.4e8 visible pairs) 6.9e11
// operations against ~0.4 GB of q, k, v, o, dO in and dq, dk, dv out:
// operations, ~0.70 ms at the bf16 tensor-core rate of an H100 SXM. The
// two walks recompute S and dP each (seven products, not five): the price
// of owning every output row in one block, which is what removes atomics.
//
// bf16 inputs: the tensor cores, mma.sync m16n8k16 bf16 -> float32 with
// K5's fragment helpers (flash_attention.cuh). Each of a block's 4 warps
// owns 16 rows (q rows for dq, keys for dk/dv); the walked tile is 32 rows
// (keys for dq, q rows for dk/dv), which keeps dk's and dv's two D-wide
// accumulators in registers at D = 128. P and dS, as the A operands of dV,
// dQ and dK, go in two bf16 terms (their rounding and the rest), as K5's P V
// does: one rounding of P cost K5 its tolerance on the LM's own inputs.
// Operands come in by 16-byte cp.async, one stage: a simple kernel first;
// K5's double buffering, and wgmma, are later work.
// float32 inputs: the CUDA cores in float32, K5's float32 layout (256
// threads over a 64 x 64 tile, thread (rg, cg) owning rows 4 rg .. 4 rg + 3
// and columns cg + 16 j).

#include "flash_attention.cuh"

namespace {

// Element strides (batch, head, sequence) of each tensor, at these offsets.
enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21, kStrides = 24 };

struct BwdParams {
  int B, H, Hk, Sq, Skv, D, causal, window;
  long long st[kStrides];
  float scale;
};

template <class T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

// ===========================================================================
// 1. Delta = rowsum(dO * O), one warp a row, a fixed order of sums
// ===========================================================================
constexpr int kDeltaRows = 8;  // warps (rows) per block

template <class T>
__global__ void __launch_bounds__(32 * kDeltaRows)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                    float* __restrict__ delta, BwdParams p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = blockIdx.y * kDeltaRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.Sq) return;  // the whole warp
  const T* orow = o + b * p.st[kO] + h * p.st[kO + 1] + row * p.st[kO + 2];
  const T* grow = dO + b * p.st[kDO] + h * p.st[kDO + 1] + row * p.st[kDO + 2];
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(to_f(grow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[static_cast<long long>(bh) * p.Sq + row] = acc;
}

// ===========================================================================
// 2-3. bfloat16: the tensor cores
// ===========================================================================
constexpr int kBR = 64;   // a block's own rows: q rows (dq) or keys (dk/dv)
constexpr int kBC = 32;   // the walked tile: keys (dq) or q rows (dk/dv)
constexpr int kTcThreads = 128;  // 4 warps x 16 rows

// kD: 64 or 128, the largest D16 the instance takes (its register arrays).
template <int kD>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, BwdParams p) {
  constexpr int LDS = kD + 8;  // padded row: 16 bytes past the data
  constexpr int NT = kD / 8;   // n8 column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBR x LDS
  bf16* gs = qs + kBR * LDS;                     // kBR x LDS, dO
  bf16* ks = gs + kBR * LDS;                     // kBC x LDS
  bf16* vs = ks + kBC * LDS;                     // kBC x LDS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBR;  // longest tiles first
  const int off = p.Skv - p.Sq;
  const bf16* qb = q + b * p.st[kQ] + h * p.st[kQ + 1];
  const bf16* gb = dO + b * p.st[kDO] + h * p.st[kDO + 1];
  const bf16* kb = k + b * p.st[kK] + hk * p.st[kK + 1];
  const bf16* vb = v + b * p.st[kV] + hk * p.st[kV + 1];
  const int D16 = (p.D + 15) & ~15;
  const int nk = D16 / 16;  // live k-steps, and live 16-column pairs of dQ
  const float sc = p.scale * kLog2e;

  load_tile_async<LDS, kTcThreads>(qs, qb, p.st[kQ + 2], q0, p.Sq, kBR, p.D, D16);
  load_tile_async<LDS, kTcThreads>(gs, gb, p.st[kDO + 2], q0, p.Sq, kBR, p.D, D16);
  cp_async_commit();

  const int r0 = 16 * warp;
  float lse2[2], dl[2];  // this lane's rows g and g + 8: lse in log2 units, Delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const long long at = static_cast<long long>(bh) * p.Sq + row;
    lse2[r] = row < p.Sq ? lse[at] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? delta[at] : 0.f;
  }
  const uint32_t q_addr = smem_addr(qs + (r0 + (lane & 15)) * LDS + 8 * (lane >> 4));
  const uint32_t g_addr = smem_addr(gs + (r0 + (lane & 15)) * LDS + 8 * (lane >> 4));
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int t_beg, t_end;
  kv_tile_range(p, q0, kBR, kBC, t_beg, t_end);
  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kBC;
    __syncthreads();  // the last tile's K and V are read
    load_tile_async<LDS, kTcThreads>(ks, kb, p.st[kK + 2], k0, p.Skv, kBC, p.D, D16);
    load_tile_async<LDS, kTcThreads>(vs, vb, p.st[kV + 2], k0, p.Skv, kBC, p.D, D16);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kBC / 8][4], dp[kBC / 8][4];
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<kD, LDS, kBC>(s, q_addr, ks, nk, lane);   // S = Q K^T
    mma_abt<kD, LDS, kBC>(dp, g_addr, vs, nk, lane);  // dP = dO V^T

    const bool masked = tile_needs_mask(p, q0, k0, kBR, kBC);
#pragma unroll
    for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = fast_exp2(fmaf(s[j][e], sc, -lse2[r]));
        if (masked && !visible(p, q0 + r0 + g + 8 * r + off, k0 + 8 * j + 2 * t4 + (e & 1)))
          pr = 0.f;  // exactly 0
        s[j][e] = pr * (dp[j][e] - dl[r]);  // dS
      }
#pragma unroll
    for (int kk = 0; kk < kBC / 16; ++kk) {  // dQ += dS K, dS in two terms
      uint32_t a[4], rest[4];
      to_a_frags(s, kk, a, rest);
      mma_a_by_rows<kD, LDS>(acc, a, ks, kk, nk, lane);
      mma_a_by_rows<kD, LDS>(acc, rest, ks, kk, nk, lane);
    }
  }
  cp_async_wait<0>();  // an empty walk leaves the first group in flight

  bf16* db = dq + b * p.st[kDQ] + h * p.st[kDQ + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= p.Sq) continue;
    bf16* drow = db + static_cast<long long>(row) * p.st[kDQ + 2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
fa_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, BwdParams p) {
  constexpr int LDS = kD + 8;
  constexpr int NT = kD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kBR x LDS
  bf16* vs = ks + kBR * LDS;                     // kBR x LDS
  bf16* qs = vs + kBR * LDS;                     // kBC x LDS
  bf16* gs = qs + kBC * LDS;                     // kBC x LDS, dO
  float* ls = reinterpret_cast<float*>(gs + kBC * LDS);  // kBC: lse in log2 units
  float* dls = ls + kBC;                                 // kBC: Delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bhk = blockIdx.x;
  const int b = bhk / p.Hk, hk = bhk - b * p.Hk;
  const int G = p.H / p.Hk;
  const int k0 = blockIdx.y * kBR;  // the earliest keys first: the causal bound lets them see most
  const int off = p.Skv - p.Sq;
  const bf16* kb = k + b * p.st[kK] + hk * p.st[kK + 1];
  const bf16* vb = v + b * p.st[kV] + hk * p.st[kV + 1];
  const int D16 = (p.D + 15) & ~15;
  const int nk = D16 / 16;
  const float sc = p.scale * kLog2e;

  load_tile_async<LDS, kTcThreads>(ks, kb, p.st[kK + 2], k0, p.Skv, kBR, p.D, D16);
  load_tile_async<LDS, kTcThreads>(vs, vb, p.st[kV + 2], k0, p.Skv, kBR, p.D, D16);
  cp_async_commit();

  const int r0 = 16 * warp;
  const uint32_t k_addr = smem_addr(ks + (r0 + (lane & 15)) * LDS + 8 * (lane >> 4));
  const uint32_t v_addr = smem_addr(vs + (r0 + (lane & 15)) * LDS + 8 * (lane >> 4));
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  int t_beg, t_end;
  q_tile_range(p, k0, kBR, kBC, t_beg, t_end);
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const bf16* qb = q + b * p.st[kQ] + h * p.st[kQ + 1];
    const bf16* gb = dO + b * p.st[kDO] + h * p.st[kDO + 1];
    const float* lse_h = lse + static_cast<long long>(b * p.H + h) * p.Sq;
    const float* delta_h = delta + static_cast<long long>(b * p.H + h) * p.Sq;
    for (int t = t_beg; t < t_end; ++t) {
      const int q0 = t * kBC;
      __syncthreads();  // the last tile's Q, dO, lse and Delta are read
      load_tile_async<LDS, kTcThreads>(qs, qb, p.st[kQ + 2], q0, p.Sq, kBC, p.D, D16);
      load_tile_async<LDS, kTcThreads>(gs, gb, p.st[kDO + 2], q0, p.Sq, kBC, p.D, D16);
      cp_async_commit();
      for (int i = tid; i < kBC; i += kTcThreads) {
        const bool in = q0 + i < p.Sq;
        ls[i] = in ? lse_h[q0 + i] * kLog2e : 0.f;
        dls[i] = in ? delta_h[q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      float st[kBC / 8][4], dpt[kBC / 8][4];
#pragma unroll
      for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      mma_abt<kD, LDS, kBC>(st, k_addr, qs, nk, lane);   // S^T = K Q^T
      mma_abt<kD, LDS, kBC>(dpt, v_addr, gs, nk, lane);  // dP^T = V dO^T

      const bool masked = q0 + kBC > p.Sq || tile_needs_mask(p, q0, k0, kBC, kBR);
#pragma unroll
      for (int j = 0; j < kBC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);  // q row in the tile
          float pr = fast_exp2(fmaf(st[j][e], sc, -ls[col]));
          if (masked && (q0 + col >= p.Sq ||
                         !visible(p, q0 + col + off, k0 + r0 + g + 8 * (e >> 1))))
            pr = 0.f;  // exactly 0
          st[j][e] = pr;                            // P^T
          dpt[j][e] = pr * (dpt[j][e] - dls[col]);  // dS^T
        }
#pragma unroll
      for (int kk = 0; kk < kBC / 16; ++kk) {
        uint32_t a[4], rest[4];
        to_a_frags(st, kk, a, rest);  // dV += P^T dO
        mma_a_by_rows<kD, LDS>(dva, a, gs, kk, nk, lane);
        mma_a_by_rows<kD, LDS>(dva, rest, gs, kk, nk, lane);
        to_a_frags(dpt, kk, a, rest);  // dK += dS^T Q
        mma_a_by_rows<kD, LDS>(dka, a, qs, kk, nk, lane);
        mma_a_by_rows<kD, LDS>(dka, rest, qs, kk, nk, lane);
      }
    }
  }
  cp_async_wait<0>();  // an empty walk leaves the first group in flight

  bf16* dkb = dk + b * p.st[kDK] + hk * p.st[kDK + 1];
  bf16* dvb = dv + b * p.st[kDV] + hk * p.st[kDV + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + g + 8 * r;
    if (key >= p.Skv) continue;
    bf16* krow = dkb + static_cast<long long>(key) * p.st[kDK + 2];
    bf16* vrow = dvb + static_cast<long long>(key) * p.st[kDV + 2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(dka[n][2 * r] * p.scale, dka[n][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
  }
}

// ===========================================================================
// 2-3. float32: the CUDA cores (64 x 64 tiles, 256 threads)
// ===========================================================================
// NJ4: float4 column groups a thread owns in the outputs (D <= 64 * NJ4).
template <int NJ4>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.D + 4;
  float* qs = smem;             // kTile x ld, pre-scaled q
  float* gs = qs + kTile * ld;  // kTile x ld, dO
  float* ks = gs + kTile * ld;  // kTile x ld
  float* vs = ks + kTile * ld;  // kTile x ld
  float* ps = vs + kTile * ld;  // kTile x kLP, dS

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest tiles first
  const int off = p.Skv - p.Sq;
  const float* kb = k + b * p.st[kK] + hk * p.st[kK + 1];
  const float* vb = v + b * p.st[kV] + hk * p.st[kV + 1];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;

  load_tile(qs, q + b * p.st[kQ] + h * p.st[kQ + 1], p.st[kQ + 2], q0, p.Sq, p.D, ld, p.scale);
  load_tile(gs, dO + b * p.st[kDO] + h * p.st[kDO + 1], p.st[kDO + 2], q0, p.Sq, p.D, ld, 1.f);
  float lr[4], dl[4], acc[4][4 * NJ4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const long long at = static_cast<long long>(bh) * p.Sq + row;
    lr[i] = row < p.Sq ? lse[at] : 0.f;
    dl[i] = row < p.Sq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ4; ++c) acc[i][c] = 0.f;
  }

  int t_beg, t_end;
  kv_tile_range(p, q0, kTile, kTile, t_beg, t_end);
  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's K and dS are read
    load_tile(ks, kb, p.st[kK + 2], k0, p.Skv, p.D, ld, 1.f);
    load_tile(vs, vb, p.st[kV + 2], k0, p.Skv, p.D, ld, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.D; d += 4) {
      float4 qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * ld + d);
        gv[i] = *reinterpret_cast<const float4*>(gs + (rg * 4 + i) * ld + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * ld + d);
        const float4 vv = *reinterpret_cast<const float4*>(vs + (cg + 16 * j) * ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kk.x, fmaf(qv[i].y, kk.y, fmaf(qv[i].z, kk.z, fmaf(qv[i].w, kk.w, s[i][j]))));
          dp[i][j] = fmaf(gv[i].x, vv.x, fmaf(gv[i].y, vv.y, fmaf(gv[i].z, vv.z, fmaf(gv[i].w, vv.w, dp[i][j]))));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool allow = visible(p, q0 + rg * 4 + i + off, k0 + cg + 16 * j);
        const float pr = allow ? expf(s[i][j] - lr[i]) : 0.f;
        ps[(rg * 4 + i) * kLP + cg + 16 * j] = pr * (dp[i][j] - dl[i]);
      }
    __syncthreads();

    for (int kk = 0; kk < kTile; kk += 4) {  // dQ += dS K
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg * 4 + i) * kLP + kk);
#pragma unroll
      for (int jj = 0; jj < NJ4; ++jj) {
        const int col = cg * 4 + 64 * jj;
        if (col >= p.D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (kk + e) * ld + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] = fmaf(pe, kv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pe, kv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pe, kv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pe, kv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

  float* db = dq + b * p.st[kDQ] + h * p.st[kDQ + 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= p.Sq) continue;
    float* drow = db + static_cast<long long>(row) * p.st[kDQ + 2];
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 64 * jj + e;
        if (col < p.D) drow[col] = acc[i][jj * 4 + e] * p.scale;
      }
  }
}

template <int NJ4>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.D + 4;
  float* ks = smem;              // kTile x ld
  float* vs = ks + kTile * ld;   // kTile x ld
  float* qs = vs + kTile * ld;   // kTile x ld, pre-scaled q
  float* gs = qs + kTile * ld;   // kTile x ld, dO
  float* pts = gs + kTile * ld;  // kTile x kLP, P^T
  float* dss = pts + kTile * kLP;  // kTile x kLP, dS^T
  float* ls = dss + kTile * kLP;   // kTile: lse
  float* dls = ls + kTile;         // kTile: Delta

  const int bhk = blockIdx.x;
  const int b = bhk / p.Hk, hk = bhk - b * p.Hk;
  const int G = p.H / p.Hk;
  const int k0 = blockIdx.y * kTile;
  const int off = p.Skv - p.Sq;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;

  load_tile(ks, k + b * p.st[kK] + hk * p.st[kK + 1], p.st[kK + 2], k0, p.Skv, p.D, ld, 1.f);
  load_tile(vs, v + b * p.st[kV] + hk * p.st[kV + 1], p.st[kV + 2], k0, p.Skv, p.D, ld, 1.f);
  float dka[4][4 * NJ4], dva[4][4 * NJ4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NJ4; ++c) dka[i][c] = dva[i][c] = 0.f;

  int t_beg, t_end;
  q_tile_range(p, k0, kTile, kTile, t_beg, t_end);
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qb = q + b * p.st[kQ] + h * p.st[kQ + 1];
    const float* gb = dO + b * p.st[kDO] + h * p.st[kDO + 1];
    const float* lse_h = lse + static_cast<long long>(b * p.H + h) * p.Sq;
    const float* delta_h = delta + static_cast<long long>(b * p.H + h) * p.Sq;
    for (int t = t_beg; t < t_end; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the last tile's Q, dO, P^T and dS^T are read
      load_tile(qs, qb, p.st[kQ + 2], q0, p.Sq, p.D, ld, p.scale);
      load_tile(gs, gb, p.st[kDO + 2], q0, p.Sq, p.D, ld, 1.f);
      for (int i = tid; i < kTile; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        ls[i] = in ? lse_h[q0 + i] : 0.f;
        dls[i] = in ? delta_h[q0 + i] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];  // keys 4 rg + i, q rows cg + 16 j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < p.D; d += 4) {
        float4 kr[4], vr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kr[i] = *reinterpret_cast<const float4*>(ks + (rg * 4 + i) * ld + d);
          vr[i] = *reinterpret_cast<const float4*>(vs + (rg * 4 + i) * ld + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 qc = *reinterpret_cast<const float4*>(qs + (cg + 16 * j) * ld + d);
          const float4 gc = *reinterpret_cast<const float4*>(gs + (cg + 16 * j) * ld + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st[i][j] = fmaf(kr[i].x, qc.x, fmaf(kr[i].y, qc.y, fmaf(kr[i].z, qc.z, fmaf(kr[i].w, qc.w, st[i][j]))));
            dpt[i][j] = fmaf(vr[i].x, gc.x, fmaf(vr[i].y, gc.y, fmaf(vr[i].z, gc.z, fmaf(vr[i].w, gc.w, dpt[i][j]))));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cg + 16 * j;
          const bool allow = q0 + col < p.Sq && visible(p, q0 + col + off, k0 + rg * 4 + i);
          const float pr = allow ? expf(st[i][j] - ls[col]) : 0.f;
          pts[(rg * 4 + i) * kLP + col] = pr;
          dss[(rg * 4 + i) * kLP + col] = pr * (dpt[i][j] - dls[col]);
        }
      __syncthreads();

      for (int qq = 0; qq < kTile; qq += 4) {  // dV += P^T dO, dK += dS^T (scale Q)
        float4 pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = *reinterpret_cast<const float4*>(pts + (rg * 4 + i) * kLP + qq);
          sv[i] = *reinterpret_cast<const float4*>(dss + (rg * 4 + i) * kLP + qq);
        }
#pragma unroll
        for (int jj = 0; jj < NJ4; ++jj) {
          const int col = cg * 4 + 64 * jj;
          if (col >= p.D) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 gv = *reinterpret_cast<const float4*>(gs + (qq + e) * ld + col);
            const float4 qv = *reinterpret_cast<const float4*>(qs + (qq + e) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              const float se = e == 0 ? sv[i].x : e == 1 ? sv[i].y : e == 2 ? sv[i].z : sv[i].w;
              dva[i][jj * 4 + 0] = fmaf(pe, gv.x, dva[i][jj * 4 + 0]);
              dva[i][jj * 4 + 1] = fmaf(pe, gv.y, dva[i][jj * 4 + 1]);
              dva[i][jj * 4 + 2] = fmaf(pe, gv.z, dva[i][jj * 4 + 2]);
              dva[i][jj * 4 + 3] = fmaf(pe, gv.w, dva[i][jj * 4 + 3]);
              dka[i][jj * 4 + 0] = fmaf(se, qv.x, dka[i][jj * 4 + 0]);
              dka[i][jj * 4 + 1] = fmaf(se, qv.y, dka[i][jj * 4 + 1]);
              dka[i][jj * 4 + 2] = fmaf(se, qv.z, dka[i][jj * 4 + 2]);
              dka[i][jj * 4 + 3] = fmaf(se, qv.w, dka[i][jj * 4 + 3]);
            }
          }
        }
      }
    }
  }

  float* dkb = dk + b * p.st[kDK] + hk * p.st[kDK + 1];
  float* dvb = dv + b * p.st[kDV] + hk * p.st[kDV + 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    if (key >= p.Skv) continue;
    float* krow = dkb + static_cast<long long>(key) * p.st[kDK + 2];
    float* vrow = dvb + static_cast<long long>(key) * p.st[kDV + 2];
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 64 * jj + e;
        if (col < p.D) {
          krow[col] = dka[i][jj * 4 + e];  // Q was pre-scaled: already scale dS^T Q
          vrow[col] = dva[i][jj * 4 + e];
        }
      }
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

template <int kD>
int launch_tc(const void* q, const void* k, const void* v, const void* dO,
              const float* lse, const float* delta, void* dq, void* dk, void* dv,
              const BwdParams& p, cudaStream_t stream) {
  const size_t smem_dq = sizeof(bf16) * (2 * kBR + 2 * kBC) * (kD + 8);
  const size_t smem_dkdv = smem_dq + sizeof(float) * 2 * kBC;
  static bool dq_set = false, dkdv_set = false;
  int err = allow_smem(fa_bwd_dq_tc_kernel<kD>, smem_dq, dq_set);
  if (!err) err = allow_smem(fa_bwd_dkdv_tc_kernel<kD>, smem_dkdv, dkdv_set);
  if (err) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(dO);
  fa_bwd_dq_tc_kernel<kD><<<dim3(p.B * p.H, (p.Sq + kBR - 1) / kBR), kTcThreads, smem_dq,
                            stream>>>(qb, kb, vb, gb, lse, delta, static_cast<bf16*>(dq), p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dkdv_tc_kernel<kD><<<dim3(p.B * p.Hk, (p.Skv + kBR - 1) / kBR), kTcThreads,
                              smem_dkdv, stream>>>(qb, kb, vb, gb, lse, delta,
                                                   static_cast<bf16*>(dk),
                                                   static_cast<bf16*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ4>
int launch_f32(const void* q, const void* k, const void* v, const void* dO,
               const float* lse, const float* delta, void* dq, void* dk, void* dv,
               const BwdParams& p, cudaStream_t stream) {
  const auto smem_of = [](int D, int tiles, int ptiles, int vecs) {
    return sizeof(float) * (tiles * kTile * (D + 4) + ptiles * kTile * kLP + vecs * kTile);
  };
  static bool dq_set = false, dkdv_set = false;
  int err = allow_smem(fa_bwd_dq_f32_kernel<NJ4>, smem_of(64 * NJ4, 4, 1, 0), dq_set);
  if (!err) err = allow_smem(fa_bwd_dkdv_f32_kernel<NJ4>, smem_of(64 * NJ4, 4, 2, 2), dkdv_set);
  if (err) return err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dO);
  fa_bwd_dq_f32_kernel<NJ4><<<dim3(p.B * p.H, (p.Sq + kTile - 1) / kTile), kThreads,
                              smem_of(p.D, 4, 1, 0), stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dq), p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dkdv_f32_kernel<NJ4><<<dim3(p.B * p.Hk, (p.Skv + kTile - 1) / kTile), kThreads,
                                smem_of(p.D, 4, 2, 2), stream>>>(
      qf, kf, vf, gf, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv with element strides (batch, head, sequence),
// eight triples in that order in `strides`, and unit stride along D; lse
// and delta (scratch) float32 (B, H, Sq) contiguous. dtype 0 float32, 1
// bfloat16 (all eight tensors the same). D a multiple of 8 up to 128, every
// stride a multiple of 8 and every pointer 16-byte aligned (the wrapper
// checks). Three launches on `stream` (Delta, dq, dk/dv); returns the first
// cudaGetLastError() that is not 0, else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* dq, void* dk, void* dv, void* delta, int B, int H,
    int Hk, int Sq, int Skv, int D, const long long* strides, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D > 128 || D % 8 != 0 || (Sq + kDeltaRows - 1) / kDeltaRows > 65535 ||
      (Skv + kTile - 1) / kTile > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  for (int i = 0; i < kStrides; ++i) p.st[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const dim3 dgrid(B * H, (Sq + kDeltaRows - 1) / kDeltaRows);
  if (dtype == 0)
    fa_bwd_delta_kernel<float><<<dgrid, 32 * kDeltaRows, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), dl, p);
  else
    fa_bwd_delta_kernel<bf16><<<dgrid, 32 * kDeltaRows, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dO), dl, p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (dtype == 0)
    return D <= 64 ? launch_f32<1>(q, k, v, dO, L, dl, dq, dk, dv, p, s)
                   : launch_f32<2>(q, k, v, dO, L, dl, dq, dk, dv, p, s);
  return D <= 64 ? launch_tc<64>(q, k, v, dO, L, dl, dq, dk, dv, p, s)
                 : launch_tc<128>(q, k, v, dO, L, dl, dq, dk, dv, p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
