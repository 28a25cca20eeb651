// Flash attention backward (K5b) for Hopper (sm_90a): dq, dk and dv of K5
// (flash_attention.cu) from q, k, v, K5's output o and float32 row
// log-sum-exp lse, and the output's cotangent dO.
//
// Replaces no TPU kernel. The JAX package's Pallas kernel
// (repro/kernels/flash_attention/kernel.py `flash_attention_kernel`) is
// forward only, and its LM trains through autodiff of the jnp blocked
// attention (src/repro/models/lm/layers.py:95 `flash_attention`, each kv
// block recomputed under jax.checkpoint). This is that gradient as one
// kernel, so that no (Sq, Skv) probability tensor is ever stored:
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
//   1. the row statistics: Delta, one warp a row (bf16: with lse log2(e)
//      beside it, padded to a multiple of 128 rows with (+inf, 0), so that
//      rows past Sq get probabilities of exactly 0);
//   2. dq: one block per (b, h, q tile), walking the kv tiles that K5's
//      `kv_tile_range` leaves; it recomputes S and dP, forms dS and
//      accumulates dQ in registers;
//   3. dk, dv: one block per (b, kv head, key tile), walking the G query
//      heads of its group and, for each, the q tiles that can see its keys
//      (`q_tile_range`, the transpose of `kv_tile_range`): it recomputes
//      S^T and dP^T and accumulates dK and dV in registers, over the group
//      and the q tiles in one fixed order.
// Owning every output row in one block is what removes the atomics; its
// price is that both walks recompute S and dP: seven products a visible
// pair, not five.
//
// What bounds it: five products of 2 D operations per visible (query, key)
// pair and head (S, dP, dV, dQ, dK); at qwen3's train shape (B = 4, S =
// 4,096, 16 heads over 8, D = 128, causal: 5.4e8 visible pairs) 6.9e11
// operations against ~0.4 GB of q, k, v, o, dO in and dq, dk, dv out:
// operations, 0.695 ms at the bf16 tensor-core rate of an H100 SXM (989
// TFLOP/s), which only wgmma reaches.
//
// bf16 inputs: blocks of two warpgroups (hopper.cuh has the PTX building
// blocks).
//   * Tiles (kernel.py `BWD_TILES`): a block owns 128 rows (dq: q rows; dk/dv:
//     keys), 64 per warpgroup, and walks tiles of 64 rows (dq: keys; dk/dv:
//     q rows). Each warpgroup skips the walked tiles that its own 64 rows
//     cannot see (the block's ranges at 64 rows) but still takes part in
//     the ring.
//   * The ring: thread 0 first loads the block's resident operands by TMA
//     (dk/dv: K and V; dq: Q, dO and the rows' statistics) and the first
//     kStages = 3 walked tiles (dk/dv: Q, dO and the 64 rows' statistics;
//     dq: K and V), each stage with a `full` mbarrier (TMA transaction
//     bytes) and an `empty` one (every thread arrives when its products have
//     read the stage); at the top of each step it refills the stage the
//     previous step used, once both warpgroups have released it, so two
//     tiles are in flight while one is computed. The tensor maps are 4-d,
//     (D, S, heads, B) with the strides of either layout, boxes of 64
//     columns by 64 rows with 128-byte swizzle; kernel.py (`bwd_plan`)
//     computes their arguments and this file only encodes them. TMA's
//     out-of-bounds zeros
//     pad D up to the instance's 64 or 128 and the ragged Sq and Skv edges.
//     No producer warpgroup: ptxas (CUDA 12.8) budgets a block's registers
//     by warpgroups and did not raise a consumer's budget past 168 for
//     setmaxnreg, where the dk/dv pass at D = 128 needs 234; with a third
//     warpgroup (or warp) for the producer it spilled ~600 bytes a thread
//     and serialized its wgmma (PERF.md).
//   * The products (wgmma, bf16 -> float32): S^T = K Q^T and dP^T = V dO^T
//     (dq: S = Q K^T, dP = dO V^T) as m64n64k16 with both operands in shared
//     memory (K-major descriptors); P^T and dS^T in registers (the mask only
//     in tiles that need it); then dV += P^T dO and dK += dS^T Q (dq: dQ +=
//     dS K) as m64nDk16 with A from registers (the m64n64 accumulator's
//     layout is the A fragment's, so nothing moves between threads) and B
//     the staged tile through a transposed (MN-major) descriptor. dK and dV
//     (2 x 64 x 128 float32 a warpgroup at D = 128) stay in registers: 234 a
//     thread at D = 128, one block of 256 threads an SM.
//   * Rounding: P and dS enter the second products rounded once to bf16.
//     That is seven products of wgmma work a visible pair against the
//     bound's five; adding their rest as a second bf16 term (as K5's P V
//     does) would make it ten. Measured on the card, both held every K5b
//     check of chip_smoke.py at its tolerance and one term was 1.24x faster
//     (PERF.md), so only one term is built.
//   * D a multiple of 8 up to 128; two instantiations, D <= 64 and <= 128
//     (the columns past D are TMA's zeros).
// float32 inputs: the CUDA cores in float32, K5's float32 layout (256
// threads over a 64 x 64 tile, thread (rg, cg) owning rows 4 rg .. 4 rg + 3
// and columns cg + 16 j).

#include "flash_attention.cuh"
#include "hopper.cuh"

namespace {

// Element strides (batch, head, sequence) of each tensor, at these offsets.
enum { kQ = 0, kK = 3, kV = 6, kO = 9, kDO = 12, kDQ = 15, kDK = 18, kDV = 21, kStrides = 24 };

struct BwdParams {
  int B, H, Hk, Sq, Skv, D, causal, window;
  long long st[kStrides];
  float scale;
};

// ===========================================================================
// 1. Delta = rowsum(dO * O), one warp a row, a fixed order of sums (float32;
//    the bf16 statistics kernel is below)
// ===========================================================================
constexpr int kDeltaRows = 8;  // warps (rows) per block

__global__ void __launch_bounds__(32 * kDeltaRows)
fa_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
                    float* __restrict__ delta, BwdParams p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = blockIdx.y * kDeltaRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= p.Sq) return;  // the whole warp
  const float* orow = o + b * p.st[kO] + h * p.st[kO + 1] + row * p.st[kO + 2];
  const float* grow = dO + b * p.st[kDO] + h * p.st[kDO + 1] + row * p.st[kDO + 2];
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(grow[c], orow[c], acc);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) delta[static_cast<long long>(bh) * p.Sq + row] = acc;
}

// ===========================================================================
// bfloat16: wgmma fed by a TMA ring (two warpgroups, one thread issuing)
// ===========================================================================
constexpr int kRows = 64;    // a warpgroup's own rows; the walked tile's rows
constexpr int kOwn = 128;    // a block's own rows: two warpgroups
constexpr int kAtom = 64;    // bf16 columns of a 128-byte swizzle atom row
constexpr int kRowBytes = 128;
constexpr int kStages = 3;   // the ring
constexpr int kWgThreads = 128;
constexpr int kBlockThreads = 2 * kWgThreads;  // two warpgroups
constexpr int kStatsRows = kOwn;  // the row statistics are padded to a multiple

// Byte offsets of a block's shared memory from a 1,024-byte aligned base. kD:
// 64 or 128 (NA = kD / 64 swizzle atoms a row). `own`: the block's resident
// operands (dk/dv: K then V; dq: Q then dO), each NA regions of kOwn rows;
// then the row statistics of the own rows (dq only); then the ring, each
// stage NA regions of kRows rows of two operands (dk/dv: Q then dO; dq: K
// then V), and (dk/dv) the walked rows' statistics; then the barriers.
template <int kD, bool kDq>
struct SmemLayout {
  static constexpr int NA = kD / kAtom;
  static constexpr int kOwnOp = NA * kOwn * kRowBytes;
  static constexpr int kWalkOp = NA * kRows * kRowBytes;
  static constexpr int kOwnStats = kDq ? kOwn * 8 : 0;
  static constexpr int kStageStats = kDq ? 0 : kRows * 8;
  static constexpr int kStage = 2 * kWalkOp + (kDq ? 0 : 1024);
  static constexpr int kRing = 2 * kOwnOp + (kDq ? 1024 : 0);
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

// (lse log2(e), Delta) of each row, padded: rows Sq .. sq_pad - 1 get
// (+inf, 0), so that their probabilities are exactly 0. One warp a row.
__global__ void __launch_bounds__(32 * kDeltaRows)
fa_bwd_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, float2* __restrict__ stats, int sq_pad,
                    BwdParams p) {
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int row = blockIdx.y * kDeltaRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= sq_pad) return;  // the whole warp
  float acc = 0.f;
  if (row < p.Sq) {
    const bf16* orow = o + b * p.st[kO] + h * p.st[kO + 1] + row * p.st[kO + 2];
    const bf16* grow = dO + b * p.st[kDO] + h * p.st[kDO + 1] + row * p.st[kDO + 2];
    for (int c = lane; c < p.D; c += 32)
      acc = fmaf(__bfloat162float(grow[c]), __bfloat162float(orow[c]), acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0)
    stats[static_cast<long long>(bh) * sq_pad + row] =
        row < p.Sq ? make_float2(lse[static_cast<long long>(bh) * p.Sq + row] * kLog2e, acc)
                   : make_float2(__int_as_float(0x7f800000), 0.f);
}

// The bf16 A fragments of a 64 x 64 m64n64 accumulator (k-steps of 16
// columns; warp w's rows 16 w ..): the accumulator's layout is the A
// operand's, so no data moves.
__device__ __forceinline__ void acc_to_a(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// acc (64 x kD) += A (64 x 64, four k-steps of register fragments) * B, B a
// walked tile of kRows rows along K (base `tile`: NA regions of kRows x 64,
// MN-major).
template <int kD>
__device__ __forceinline__ void rs_products(float (&acc)[kD / 2], const uint32_t (&a)[4][4],
                                            uint32_t tile) {
  const uint32_t lo = sw128_lo(tile, kRows * kRowBytes), hi = sw128_hi(1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = kk * 16 * kRowBytes / 16;  // 16 rows down, in 16-byte units
    if constexpr (kD == 128)
      wgmma_rs_n128(acc, a[kk], lo, off, hi);
    else
      wgmma_rs_n64(acc, a[kk], lo, off, hi);
  }
}

// s (64 x 64) = A B^T: A this warpgroup's 64 rows of a resident operand
// (regions of kOwn rows, `a_base` at its first row), B a walked tile
// (regions of kRows rows); both K-major. Columns past D are TMA's zeros.
template <int kD>
__device__ __forceinline__ void ss_products(float (&s)[32], uint32_t a_base, uint32_t b_base) {
  const uint32_t a_lo = sw128_lo(a_base, 16), b_lo = sw128_lo(b_base, 16), hi = sw128_hi(1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int atom = kk / 4, in = 32 * (kk % 4);  // byte offsets, / 16 below
    wgmma_ss_n64(s, a_lo, (atom * kOwn * kRowBytes + in) / 16, b_lo,
                 (atom * kRows * kRowBytes + in) / 16, hi, kk > 0);
  }
}

// The TMA loads of rows r0 .. r0 + nrows - 1 (nrows a multiple of kRows) of
// one (batch, head) of a tensor map, every atom, into regions of `region_rows`
// rows at `dst`.
template <int kD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int nrows, int region_rows, int h, int b) {
#pragma unroll
  for (int atom = 0; atom < kD / kAtom; ++atom)
    for (int r = 0; r < nrows; r += kRows)
      tma_load_4d(dst + (atom * region_rows + r) * kRowBytes, map, bar, atom * kAtom, r0 + r, h, b);
}

__device__ __forceinline__ void init_barriers(uint32_t bar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * s, 1);                                // full: the issuing thread
      mbar_init(bar + 8 * (kStages + s), kBlockThreads);        // empty: every thread
    }
    mbar_init(bar + 16 * kStages, 1);                           // the resident operands
    mbar_fence_init();
  }
  __syncthreads();
}

// dK and dV: one block per (b, kv head, kOwn keys), the earliest keys first
// (the causal bound lets them see the most rows). Warpgroup wg owns keys
// k0 + 64 wg ..; K and V stay resident; thread 0 streams (Q, dO,
// statistics) tiles of kRows rows through the ring, over the G query heads
// of the group and, for each, the q tiles that see the block's keys.
template <int kD>
__global__ void __launch_bounds__(kBlockThreads, 1)
fa_bwd_dkdv_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                      const float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, BwdParams p) {
  using L = SmemLayout<kD, false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages, res = empty + 8 * kStages;
  const int bhk = blockIdx.x;
  const int b = bhk / p.Hk, hk = bhk - b * p.Hk;
  const int G = p.H / p.Hk;
  const int k0 = blockIdx.y * kOwn;
  int t_beg, t_end;
  q_tile_range(p, k0, kOwn, kRows, t_beg, t_end);
  const int n_tiles = t_end - t_beg, n_walk = G * n_tiles;
  init_barriers(full);

  const auto load_walk = [&](int it) {  // walked tile `it` into its stage
    const int s = it % kStages;
    const int h = hk * G + it / n_tiles, q0 = (t_beg + it % n_tiles) * kRows;
    const uint32_t st = base + L::kRing + s * L::kStage;
    mbar_expect_tx(full + 8 * s, 2 * L::kWalkOp + L::kStageStats);
    load_rows<kD>(st, &tq, full + 8 * s, q0, kRows, kRows, h, b);
    load_rows<kD>(st + L::kWalkOp, &tg, full + 8 * s, q0, kRows, kRows, h, b);
    bulk_load(st + 2 * L::kWalkOp, stats + (static_cast<long long>(b) * p.H + h) * sq_pad + q0,
              L::kStageStats, full + 8 * s);
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(res, 2 * L::kOwnOp);
    load_rows<kD>(base, &tk, res, k0, kOwn, kOwn, hk, b);
    load_rows<kD>(base + L::kOwnOp, &tv, res, k0, kOwn, kOwn, hk, b);
    for (int it = 0; it < kStages && it < n_walk; ++it) load_walk(it);
  }

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x & (kWgThreads - 1), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + kRows * wg;  // this warpgroup's keys
  const int off = p.Skv - p.Sq;
  int w_beg = 0, w_end = 0;
  if (kw0 < p.Skv) q_tile_range(p, kw0, kRows, kRows, w_beg, w_end);
  const float sc = p.scale * kLog2e;
  const uint32_t k_rows = base + kw0 % kOwn * kRowBytes;  // this warpgroup's K rows
  const uint32_t v_rows = k_rows + L::kOwnOp;

  float dka[kD / 2], dva[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(res, 0);

  for (int it = 0; it < n_walk; ++it) {
    const int s = it % kStages, use = it / kStages;
    const int t = t_beg + it % n_tiles, q0 = t * kRows;
    const uint32_t st = base + L::kRing + s * L::kStage;
    if (issuer && it > 0 && it - 1 + kStages < n_walk) {
      // refill the stage of tile it - 1 once both warpgroups have released it
      mbar_wait(empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_walk(it - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, use & 1);
    if (t >= w_beg && t < w_end) {
      float sT[32], dpT[32];
      wgmma_fence();
      ss_products<kD>(sT, k_rows, st);             // S^T = K Q^T
      wgmma_commit();
      ss_products<kD>(dpT, v_rows, st + L::kWalkOp);  // dP^T = V dO^T
      wgmma_commit();
      const float2* rs = reinterpret_cast<const float2*>(
          smem_raw + (st + 2 * L::kWalkOp - raw));  // the walked rows' (lse2, Delta)
      const bool masked = q0 + kRows > p.Sq || tile_needs_mask(p, q0, kw0, kRows, kRows);
      wgmma_wait<1>();
      reg_fence(sT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);  // q row in the tile
          float pr = fast_exp2(fmaf(sT[4 * j + e], sc, -rs[col].x));
          if (masked && (q0 + col >= p.Sq ||
                         !visible(p, q0 + col + off, kw0 + 16 * warp + g + 8 * (e >> 1))))
            pr = 0.f;  // exactly 0
          sT[4 * j + e] = pr;  // P^T
        }
      wgmma_wait<0>();
      reg_fence(dpT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpT[4 * j + e] = sT[4 * j + e] * (dpT[4 * j + e] - rs[8 * j + 2 * t4 + (e & 1)].y);
      uint32_t aP[4][4], aS[4][4];
      acc_to_a(sT, aP);
      acc_to_a(dpT, aS);
      wgmma_fence();
      rs_products<kD>(dva, aP, st + L::kWalkOp);  // dV += P^T dO
      rs_products<kD>(dka, aS, st);               // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dva);
      reg_fence(dka);
      reg_fence(aP);
      reg_fence(aS);
    }
    mbar_arrive(empty + 8 * s);
  }

  bf16* dkb = dk + b * p.st[kDK] + hk * p.st[kDK + 1];
  bf16* dvb = dv + b * p.st[kDV] + hk * p.st[kDV + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + 16 * warp + g + 8 * r;
    if (key >= p.Skv) continue;
    bf16* krow = dkb + static_cast<long long>(key) * p.st[kDK + 2];
    bf16* vrow = dvb + static_cast<long long>(key) * p.st[kDV + 2];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(dka[4 * n + 2 * r] * p.scale, dka[4 * n + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      }
    }
  }
}

// dQ: one block per (b, head, kOwn q rows), the longest walks first.
// Warpgroup wg owns rows q0 + 64 wg ..; Q, dO and the rows' statistics stay
// resident; thread 0 streams (K, V) tiles of kRows keys through the ring
// over the kv tiles the block's rows see.
template <int kD>
__global__ void __launch_bounds__(kBlockThreads, 1)
fa_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                    const float2* __restrict__ stats, int sq_pad, bf16* __restrict__ dq,
                    BwdParams p) {
  using L = SmemLayout<kD, true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full = base + L::kBar, empty = full + 8 * kStages, res = empty + 8 * kStages;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  int t_beg, t_end;
  kv_tile_range(p, q0, kOwn, kRows, t_beg, t_end);
  const int n_walk = t_end - t_beg;
  init_barriers(full);

  const auto load_walk = [&](int it) {  // walked tile `it` into its stage
    const int s = it % kStages, k0 = (t_beg + it) * kRows;
    const uint32_t st = base + L::kRing + s * L::kStage;
    mbar_expect_tx(full + 8 * s, 2 * L::kWalkOp);
    load_rows<kD>(st, &tk, full + 8 * s, k0, kRows, kRows, hk, b);
    load_rows<kD>(st + L::kWalkOp, &tv, full + 8 * s, k0, kRows, kRows, hk, b);
  };
  const bool issuer = threadIdx.x == 0;
  if (issuer) {
    mbar_expect_tx(res, 2 * L::kOwnOp + L::kOwnStats);
    load_rows<kD>(base, &tq, res, q0, kOwn, kOwn, h, b);
    load_rows<kD>(base + L::kOwnOp, &tg, res, q0, kOwn, kOwn, h, b);
    bulk_load(base + 2 * L::kOwnOp, stats + static_cast<long long>(bh) * sq_pad + q0,
              L::kOwnStats, res);
    for (int it = 0; it < kStages && it < n_walk; ++it) load_walk(it);
  }

  const int wg = threadIdx.x / kWgThreads;
  const int tid = threadIdx.x & (kWgThreads - 1), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + kRows * wg;  // this warpgroup's rows
  const int off = p.Skv - p.Sq;
  int w_beg = 0, w_end = 0;
  if (qw0 < p.Sq) kv_tile_range(p, qw0, kRows, kRows, w_beg, w_end);
  const float sc = p.scale * kLog2e;
  const uint32_t q_rows = base + kRows * wg * kRowBytes;
  const uint32_t g_rows = q_rows + L::kOwnOp;

  mbar_wait(res, 0);
  const float2* rs = reinterpret_cast<const float2*>(smem_raw + (base + 2 * L::kOwnOp - raw));
  float lse2[2], dl[2];  // rows g and g + 8 of this warp's 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 v = rs[kRows * wg + 16 * warp + g + 8 * r];
    lse2[r] = v.x;
    dl[r] = v.y;
  }
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_walk; ++it) {
    const int s = it % kStages, use = it / kStages;
    const int t = t_beg + it, k0 = t * kRows;
    const uint32_t st = base + L::kRing + s * L::kStage;
    if (issuer && it > 0 && it - 1 + kStages < n_walk) {
      // refill the stage of tile it - 1 once both warpgroups have released it
      mbar_wait(empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_walk(it - 1 + kStages);
    }
    __syncwarp();
    mbar_wait(full + 8 * s, use & 1);
    if (t >= w_beg && t < w_end) {
      float sv[32], dp[32];
      wgmma_fence();
      ss_products<kD>(sv, q_rows, st);               // S = Q K^T
      wgmma_commit();
      ss_products<kD>(dp, g_rows, st + L::kWalkOp);  // dP = dO V^T
      wgmma_commit();
      const bool masked = tile_needs_mask(p, qw0, k0, kRows, kRows);
      wgmma_wait<1>();
      reg_fence(sv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pr = fast_exp2(fmaf(sv[4 * j + e], sc, -lse2[r]));
          if (masked && !visible(p, qw0 + 16 * warp + g + 8 * r + off, k0 + 8 * j + 2 * t4 + (e & 1)))
            pr = 0.f;  // exactly 0
          sv[4 * j + e] = pr;
        }
      wgmma_wait<0>();
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[4 * j + e] *= dp[4 * j + e] - dl[e >> 1];  // dS
      uint32_t aS[4][4];
      acc_to_a(sv, aS);
      wgmma_fence();
      rs_products<kD>(acc, aS, st);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(aS);
    }
    mbar_arrive(empty + 8 * s);
  }

  bf16* db = dq + b * p.st[kDQ] + h * p.st[kDQ + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + 16 * warp + g + 8 * r;
    if (row >= p.Sq) continue;
    bf16* drow = db + static_cast<long long>(row) * p.st[kDQ + 2];
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = 8 * n + 2 * t4;
      if (col < p.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(acc[4 * n + 2 * r] * p.scale, acc[4 * n + 2 * r + 1] * p.scale);
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

// ---------------------------------------------------------------------------
// bf16 host side: the tensor maps and the two warp-specialised launches
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

// The map arguments of one bf16 operand, as kernel.py's `bwd_plan` computes
// them: dims (D, rows, heads, B), byte strides (sequence, head, batch), box.
constexpr int kMapArgs = 11;

// Whether a map's box is the tile these kernels load and count bytes for:
// (kAtom columns, kRows rows, 1, 1).
bool box_fits(const long long* args) {
  return args[7] == kAtom && args[8] == kRows && args[9] == 1 && args[10] == 1;
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

template <int kD>
int launch_wg(const void* q, const void* k, const void* v, const void* dO, const float2* stats,
              int sq_pad, const long long* args, void* dq, void* dk, void* dv, const BwdParams& p,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  int err = encode_map(&tq, q, args);
  if (!err) err = encode_map(&tk, k, args + kMapArgs);
  if (!err) err = encode_map(&tv, v, args + 2 * kMapArgs);
  if (!err) err = encode_map(&tg, dO, args + 3 * kMapArgs);
  using Ldq = SmemLayout<kD, true>;
  using Lkv = SmemLayout<kD, false>;
  static bool dq_set = false, dkdv_set = false;
  if (!err) err = allow_smem(fa_bwd_dq_wg_kernel<kD>, Ldq::kBytes, dq_set);
  if (!err) err = allow_smem(fa_bwd_dkdv_wg_kernel<kD>, Lkv::kBytes, dkdv_set);
  if (err) return err;
  fa_bwd_dq_wg_kernel<kD><<<dim3(p.B * p.H, sq_pad / kOwn), kBlockThreads, Ldq::kBytes, stream>>>(
      tq, tk, tv, tg, stats, sq_pad, static_cast<bf16*>(dq), p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fa_bwd_dkdv_wg_kernel<kD><<<dim3(p.B * p.Hk, (p.Skv + kOwn - 1) / kOwn), kBlockThreads,
                              Lkv::kBytes, stream>>>(tq, tk, tv, tg, stats, sq_pad,
                                                     static_cast<bf16*>(dk),
                                                     static_cast<bf16*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}


bool bad_shape(int B, int H, int Hk, int Sq, int Skv, int D) {
  return B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Sq <= 0 || Skv <= 0 || D <= 0 ||
         D > 128 || D % 8 != 0 || (Sq + kDeltaRows - 1) / kDeltaRows > 65535 ||
         (Skv + kTile - 1) / kTile > 65535;
}

BwdParams make_params(int B, int H, int Hk, int Sq, int Skv, int D, const long long* strides,
                      int causal, int window, float scale) {
  BwdParams p;
  p.B = B; p.H = H; p.Hk = Hk; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.causal = causal; p.window = window; p.scale = scale;
  for (int i = 0; i < kStrides; ++i) p.st[i] = strides[i];
  return p;
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv with element strides (batch, head, sequence),
// eight triples in that order in `strides`, and unit stride along D; lse
// float32 (B, H, Sq) contiguous; delta float32 scratch: (B, H, Sq) for
// float32, (B H, sq_pad, 2) for bfloat16 (kernel.py `bwd_scratch_shape`).
// For bfloat16, `maps` holds the tensor map arguments of q, k, v and dO in
// turn (kMapArgs each) and sq_pad Sq rounded up to a multiple of 128
// (kernel.py `bwd_plan`); float32 reads neither. dtype 0 float32,
// 1 bfloat16 (all eight tensors the same). D a multiple of 8 up to 128,
// every stride a multiple of 8 and every pointer 16-byte aligned (the
// wrapper checks). Three launches on `stream` (the row statistics, dq,
// dk/dv); returns the first error that is not 0 (a CUDA error, or
// cudaErrorInvalidValue for a tensor map the driver refuses), else 0.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dO, void* dq, void* dk, void* dv, void* delta, int B, int H,
    int Hk, int Sq, int Skv, int D, const long long* strides, const long long* maps,
    int sq_pad, int causal, int window, float scale, int dtype, void* stream) {
  if (bad_shape(B, H, Hk, Sq, Skv, D) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && (maps == nullptr || sq_pad != (Sq + kStatsRows - 1) / kStatsRows * kStatsRows ||
                     sq_pad / kDeltaRows > 65535 || !box_fits(maps) ||
                     !box_fits(maps + kMapArgs) || !box_fits(maps + 2 * kMapArgs) ||
                     !box_fits(maps + 3 * kMapArgs)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p = make_params(B, H, Hk, Sq, Skv, D, strides, causal, window, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* L = static_cast<const float*>(lse);
  if (dtype == 0) {
    float* dl = static_cast<float*>(delta);
    fa_bwd_delta_kernel<<<dim3(B * H, (Sq + kDeltaRows - 1) / kDeltaRows),
                           32 * kDeltaRows, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), dl, p);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    return D <= 64 ? launch_f32<1>(q, k, v, dO, L, dl, dq, dk, dv, p, s)
                   : launch_f32<2>(q, k, v, dO, L, dl, dq, dk, dv, p, s);
  }
  float2* stats = static_cast<float2*>(delta);
  fa_bwd_stats_kernel<<<dim3(B * H, sq_pad / kDeltaRows), 32 * kDeltaRows, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dO), L, stats, sq_pad, p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return D <= 64 ? launch_wg<64>(q, k, v, dO, stats, sq_pad, maps, dq, dk, dv, p, s)
                 : launch_wg<128>(q, k, v, dO, stats, sq_pad, maps, dq, dk, dv, p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
