// Backward of the fused neighbor gather + bias fold + masked attention over
// the packed recency buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/temporal_attention/kernel.py
// `fused_temporal_layer_bwd_kernel` (Pallas body `_fused_layer_bwd_kernel`):
// every gradient of the layer for the output cotangent g (S, H, D).
//
// The factored form (the forward's head comment, fused_temporal_layer.cu).
// Per seed s and head h, with x_j = [phi_j ; e_j] (X = d_time + d_edge
// wide), W_k,h / W_v,h the (X, D) blocks of [wt_k ; we_k] / [wt_v ; we_v]
// for head h and qs = q * scale:
//
//   U_k[h] = W_k,h qs_h        U_v[h] = W_v,h g_h                 (per seed)
//   s_jh  = qs_h . k_tab[id_j]_h + U_k[h] . x_j    p = masked softmax over j
//   dp_jh = g_h . v_tab[id_j]_h + U_v[h] . x_j     ds = p (dp - sum_j p dp)
//   A_k[h] = sum_j ds_jh x_j    A_v[h] = sum_j p_jh x_j
//   dq_h = scale (sum_j ds_jh k_tab[id_j]_h + W_k,h^T A_k[h])
//   dphi_j[i] = sum_h ds_jh U_k[h, i] + p_jh U_v[h, i]   (time rows only)
//   dtheta = -sin(theta) dphi: dtime_w = sum dtheta dt, dtime_b = sum dtheta
//   dk_table[id_j] += ds_jh qs_h      dv_table[id_j] += p_jh g_h
//   dW_k[:, h] = sum_s A_k[s, h] (x) qs_s,h     dW_v[:, h] = sum_s A_v[s, h] (x) g_s,h
//
// So no weight matrix is crossed per slot, and no per-slot row is written:
// the weight gradients reduce over S rows of A, not S * K slot rows. Five
// launches on the caller's stream, one count of the wrapper's LAUNCHES:
//
//   1. project: U_k and U_v, a block per head holding that head's weight
//      block in shared memory and running tiles of 8 seeds through it
//      (the weight stream shared by every seed the block takes), beside
//      blocks that zero the table gradients;
//   2. slots: one block of 128 threads per seed takes its slots 16 at a
//      time, each chunk staged in shared memory at once as in the forward.
//      Pass 1 forms the scores and dp (a warp per head and slot) and keeps
//      the online softmax statistics (max, sum, sum of e dp); pass 2 forms
//      p and ds, adds the table rows with float atomics (neighbor ids
//      repeat within and across rows), and accumulates A_k, A_v, dq's table
//      part and the seed's dtime partial in a fixed order. At K <= 16 the
//      one chunk stays staged between the passes; above, pass 2 stages each
//      chunk again with the same code (the same bits);
//   3. back-project: dq += scale W_k^T A_k, blocks as in 1;
//   4. weight-gradient partials: A^T [qs | g] for 32 weight rows at a time
//      over ranges of seeds that are a function of S alone, and the dtime
//      partials of the same ranges;
//   5. their sums, each entry adding its ranges' partials in range order,
//      so every gradient but the two tables is deterministic. The table
//      gradients add in the order blocks arrive.
//
// The workspace (U_k, U_v, A_k, A_v, the partials) is 7.9 MB at S = 600 and
// the quickstart widths and stays in the 50 MB L2.
//
// What bounds it: 10 X HD flops a seed of projections and weight
// gradients plus O(H (D + X)) a slot, ~0.2 GFLOP at S = 600, against
// ~15 MB of operands (the two 3.6 MB table gradients written, the weights
// read and their gradients written): bytes, at ~0.0045 ms. Float32 on the
// CUDA cores throughout. Measured on an H100 (PERF.md), each launch takes
// several microseconds whatever its work at this size, and the slot pass's
// precise sincosf (most arguments take its slow range reduction at
// wikipedia's time scale) is a large part of that pass.
//
// Numerics follow the forward: the time delta is taken in int32 and then
// cast; theta = dt * w + b is rounded per operation; sincosf is the precise
// one (both passes compute a slot's features with the same code, so pass 2
// sees pass 1's scores bit for bit); a masked slot is skipped (its score of
// -1e30 gives it an exact zero weight) and adds nothing to any gradient; the
// softmax denominator has a floor of 1e-30; seeds below 0 give exact zero
// rows. All accumulation is float32.

#include "fused_temporal_layer.cuh"

namespace {

using ftl::Rows;

constexpr int kMaxSplits = 32;     // seed ranges of launch 4, at most
constexpr int kMinSplitRows = 64;  // seeds per range, at least
constexpr int kWRows = 32;         // launch 4: weight rows per block
constexpr int kWSeeds = 32;        // launch 4: seeds staged at once
constexpr int kMinZeroBlocks = 64; // launch 1: blocks that zero, at least
constexpr int kTimeCols = 32;      // launch 4: dtime columns per pass
constexpr int kTimeLanes = 8;      // launch 4: seed lanes per column

struct Split {
  int n;     // number of seed ranges
  int rows;  // seeds per range
};

// Seed ranges of launch 4 for S seeds: a function of S alone, so the
// partials always add up in the same order.
Split weight_split(int S) {
  if (S <= 0) return {0, kMinSplitRows};
  int rows = ftl::ceil_div(S, kMaxSplits);
  rows = rows < kMinSplitRows ? kMinSplitRows : rows;
  return {ftl::ceil_div(S, rows), rows};
}

struct Workspace {
  float* uk;       // S x H x X
  float* uv;       // S x H x X
  float* ak;       // S x H x X
  float* av;       // S x H x X
  float* time;     // S x 2 d_time per-seed dtime_w / dtime_b partials
  float* part;     // splits x 2 x X x HD partials of the weight gradients
  float* tpart;    // splits x 2 d_time partials of dtime
  size_t bytes;
};

Workspace carve(float* base, int S, int H, int D, int d_time, int d_edge) {
  const int X = d_time + d_edge;
  const size_t sx = static_cast<size_t>(S) * H * X;
  const Split sp = weight_split(S);
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  w.uk = take(sx);
  w.uv = take(sx);
  w.ak = take(sx);
  w.av = take(sx);
  w.time = take(static_cast<size_t>(S) * 2 * d_time);
  w.part = take(static_cast<size_t>(sp.n) * 2 * X * H * D);
  w.tpart = take(static_cast<size_t>(sp.n) * 2 * d_time);
  w.bytes = sizeof(float) * off;
  return w;
}

// Launch 1: blockIdx.y < nz = 2 H (0 without a bias group): U_p[s, h, i] =
// mul_p sum_d src_p[s, h, d] W_p[i, h D + d] for p = y / H (0: q and W_k,
// times scale; 1: g and W_v); blockIdx.y == nz: zero the table gradients.
struct ProjArgs {
  const float* q;
  const float* g;
  Rows wk;
  Rows wv;
  float* uk;
  float* uv;
  float scale;
  int S, H, D, X, nz;
  float* dk_tab;
  float* dv_tab;
  size_t table_floats;
};

__global__ void ftl_bwd_project_kernel(ProjArgs a) {
  extern __shared__ float4 smem4[];
  if (static_cast<int>(blockIdx.y) == a.nz) {
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (size_t i = first; i < a.table_floats; i += stride) {
      a.dk_tab[i] = 0.f;
      a.dv_tab[i] = 0.f;
    }
    return;
  }
  if (static_cast<int>(blockIdx.x) >= ftl::ceil_div(a.S, ftl::kTileSeeds)) return;
  const int p = blockIdx.y / a.H;
  ftl::project_tiles(p ? a.g : a.q, p ? a.wv : a.wk, p ? a.uv : a.uk, p ? 1.f : a.scale, a.S,
                     a.H, a.D, a.X, blockIdx.y % a.H, reinterpret_cast<float*>(smem4));
}

// The scores and dp of one staged chunk: a warp per (head, slot); a masked
// slot's score is -inf.
__device__ __forceinline__ void chunk_scores(const int* row, int j0, int n, int kc,
                                             const float* uk, const float* uv,
                                             const float* qs, const float* gs,
                                             const float* ks, const float* vs,
                                             const float* xs, float* sc, float* dp, int H,
                                             int D, int X) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int HS = ftl::round4(H * D);
  for (int pr = warp; pr < H * n; pr += blockDim.x >> 5) {
    const int h = pr / n;
    const int j = pr - h * n;
    if (row[3 * (j0 + j)] < 0) {
      if (lane == 0) sc[h * kc + j] = -INFINITY;
      continue;
    }
    const float s = ftl::slot_dot(uk, xs + j * X, qs, ks + j * HS, h, D, X, lane);
    const float d = ftl::slot_dot(uv, xs + j * X, gs, vs + j * HS, h, D, X, lane);
    if (lane == 0) {
      sc[h * kc + j] = s;
      dp[h * kc + j] = d;
    }
  }
}

// Launch 2: one block per seed, two passes over its slots.
__global__ void __launch_bounds__(ftl::kSlotThreads, ftl::kSlotBlocksPerSM)
ftl_bwd_slot_kernel(const float* __restrict__ g, const float* __restrict__ q,
                    const float* __restrict__ k_tab, const float* __restrict__ v_tab,
                    const int* __restrict__ seeds, const int* __restrict__ seed_times,
                    const int* __restrict__ buf, const float* __restrict__ time_w,
                    const float* __restrict__ time_b, const float* __restrict__ edge_feats,
                    float* __restrict__ dq, float* __restrict__ dk_tab,
                    float* __restrict__ dv_tab, Workspace ws, int H, int D, int K,
                    int d_time, int d_edge, float scale) {
  const int s = blockIdx.x;
  const int HD = H * D;
  const int X = d_time + d_edge;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nw = nt >> 5;
  const size_t sx = static_cast<size_t>(s) * H * X;
  float* dq_row = dq + static_cast<size_t>(s) * HD;
  float* t_row = ws.time + static_cast<size_t>(s) * 2 * d_time;
  const int kc = ftl::slot_chunk(K);
  const int HS = ftl::round4(HD);
  const int HX = ftl::round4(H * X);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kc x HS: the chunk's k_tab rows
  float* vs = ks + kc * HS;                     // kc x HS: its v_tab rows
  float* xs = vs + kc * HS;                     // kc x X: its features
  float* uk = xs + ftl::round4(kc * X);         // H X
  float* uv = uk + HX;                          // H X
  float* qs = uv + HX;           // HD: q * scale
  float* gs = qs + HD;           // HD: the cotangent
  float* tw = gs + HD;           // d_time
  float* tb = tw + d_time;       // d_time
  float* sn = tb + d_time;       // kc d_time: sin(theta)
  float* sc = sn + kc * d_time;  // H kc: scores
  float* dp = sc + H * kc;       // H kc: dp
  float* pv = dp + H * kc;       // H kc: p
  float* dsv = pv + H * kc;      // H kc: ds
  float* mh = dsv + H * kc;      // H: running max, then the max
  float* lh = mh + H;            // H: running sum of e, then 1 / max(sum, 1e-30)
  float* th = lh + H;            // H: running sum of e dp, then sum_j p dp
  float* ak = th + H;            // H X: sum_j ds x_j
  float* av = ak + H * X;        // H X: sum_j p x_j
  float* dqa = av + H * X;       // HD: sum_j ds k_tab[id_j]
  float* twa = dqa + HD;         // d_time: sum dtheta dt
  float* tba = twa + d_time;     // d_time: sum dtheta
  int* row = reinterpret_cast<int*>(tba + d_time);  // 3 K

  // The copies that need no seed id go out first.
  ftl::copy_block(uk, ws.uk + sx, H * X);
  ftl::copy_block(uv, ws.uv + sx, H * X);
  ftl::copy_block(qs, q + static_cast<size_t>(s) * HD, HD);
  ftl::copy_block(gs, g + static_cast<size_t>(s) * HD, HD);
  ftl::copy_block(tw, time_w, d_time);
  ftl::copy_block(tb, time_b, d_time);
  const int seed = seeds[s];
  if (seed < 0) {  // hop-2 frontier padding: zero rows, zero contributions
    ftl::cp_async_wait_all();
    for (int c = tid; c < HD; c += nt) dq_row[c] = 0.f;
    for (int i = tid; i < H * X; i += nt) ws.ak[sx + i] = ws.av[sx + i] = 0.f;
    for (int i = tid; i < 2 * d_time; i += nt) t_row[i] = 0.f;
    return;
  }
  ftl::copy_block(reinterpret_cast<float*>(row),
                  reinterpret_cast<const float*>(buf + static_cast<size_t>(seed) * K * 3), 3 * K);
  for (int c = tid; c < HD; c += nt) dqa[c] = 0.f;
  for (int i = tid; i < H * X; i += nt) ak[i] = av[i] = 0.f;
  for (int i = tid; i < d_time; i += nt) twa[i] = tba[i] = 0.f;
  for (int h = tid; h < H; h += nt) {
    mh[h] = -INFINITY;
    lh[h] = th[h] = 0.f;
  }
  ftl::cp_async_wait_all();
  __syncthreads();
  for (int c = tid; c < HD; c += nt) qs[c] *= scale;

  const unsigned t_s = d_time ? static_cast<unsigned>(seed_times[s]) : 0u;
  const int chunks = ftl::ceil_div(K, kc);
  auto stage_and_score = [&](int j0, int n) {
    ftl::stage_slots(row, j0, n, k_tab, v_tab, edge_feats, tw, tb, t_s, HD, d_time, d_edge,
                     ks, vs, xs, sn);
    ftl::cp_async_wait_all();
    __syncthreads();
    chunk_scores(row, j0, n, kc, uk, uv, qs, gs, ks, vs, xs, sc, dp, H, D, X);
    __syncthreads();
  };

  // Pass 1: online softmax statistics.
  for (int j0 = 0; j0 < K; j0 += kc) {
    const int n = min(kc, K - j0);
    stage_and_score(j0, n);
    // A warp per head, lanes over the chunk's slots.
    for (int h = warp; h < H; h += nw) {
      const float sj = lane < n ? sc[h * kc + lane] : -INFINITY;
      const float m_old = mh[h];
      const float m = fmaxf(m_old, ftl::warp_max(sj));
      if (m == -INFINITY) continue;
      const float e = sj == -INFINITY ? 0.f : expf(sj - m);
      const float se = ftl::warp_sum_ordered(e);
      const float sd = ftl::warp_sum_ordered(e == 0.f ? 0.f : e * dp[h * kc + lane]);
      if (lane == 0) {
        const float alpha = expf(m_old - m);
        mh[h] = m;
        lh[h] = fmaf(lh[h], alpha, se);
        th[h] = fmaf(th[h], alpha, sd);
      }
    }
    __syncthreads();
  }
  for (int h = tid; h < H; h += nt) {
    const float iv = mh[h] == -INFINITY ? 0.f : 1.f / fmaxf(lh[h], 1e-30f);
    lh[h] = iv;
    th[h] *= iv;
  }
  __syncthreads();

  // Pass 2: p, ds and every contribution, in a fixed order.
  for (int j0 = 0; j0 < K; j0 += kc) {
    const int n = min(kc, K - j0);
    if (chunks > 1) stage_and_score(j0, n);
    for (int idx = tid; idx < H * n; idx += nt) {
      const int h = idx / n;
      const int j = idx - h * n;
      const float sj = sc[h * kc + j];
      float p = 0.f, ds = 0.f;
      if (sj != -INFINITY) {
        p = expf(sj - mh[h]) * lh[h];
        ds = p * (dp[h * kc + j] - th[h]);
      }
      pv[h * kc + j] = p;
      dsv[h * kc + j] = ds;
    }
    __syncthreads();
    for (int idx = tid; idx < H * X; idx += nt) {
      const int h = idx / X;
      const int i = idx - h * X;
      float a = ak[idx], b = av[idx];
      for (int j = 0; j < n; ++j) {
        const float x = xs[j * X + i];
        a = fmaf(dsv[h * kc + j], x, a);
        b = fmaf(pv[h * kc + j], x, b);
      }
      ak[idx] = a;
      av[idx] = b;
    }
    for (int c = tid; c < HD; c += nt) {
      const float* dh = dsv + (c / D) * kc;
      float a = dqa[c];
      for (int j = 0; j < n; ++j) a = fmaf(dh[j], ks[j * HS + c], a);
      dqa[c] = a;
    }
    for (int i = tid; i < d_time; i += nt) {
      float a = twa[i], b = tba[i];
      for (int j = 0; j < n; ++j) {
        const int* r = row + 3 * (j0 + j);
        if (r[0] < 0) continue;
        float dphi = 0.f;
        for (int h = 0; h < H; ++h) {
          dphi = fmaf(dsv[h * kc + j], uk[h * X + i], dphi);
          dphi = fmaf(pv[h * kc + j], uv[h * X + i], dphi);
        }
        const float dth = -sn[j * d_time + i] * dphi;
        a = fmaf(dth, ftl::slot_dt(t_s, r[1]), a);
        b += dth;
      }
      twa[i] = a;
      tba[i] = b;
    }
    for (int idx = tid; idx < n * HD; idx += nt) {
      const int j = idx / HD;
      const int c = idx - j * HD;
      const int nid = row[3 * (j0 + j)];
      if (nid < 0) continue;
      const int hj = (c / D) * kc + j;
      atomicAdd(dk_tab + static_cast<size_t>(nid) * HD + c, dsv[hj] * qs[c]);
      atomicAdd(dv_tab + static_cast<size_t>(nid) * HD + c, pv[hj] * gs[c]);
    }
    __syncthreads();
  }

  for (int i = tid; i < H * X; i += nt) {
    ws.ak[sx + i] = ak[i];
    ws.av[sx + i] = av[i];
  }
  for (int c = tid; c < HD; c += nt) dq_row[c] = dqa[c] * scale;
  for (int i = tid; i < d_time; i += nt) {
    t_row[i] = twa[i];
    t_row[d_time + i] = tba[i];
  }
}

// Launch 3: dq[s, h, d] += scale sum_i A_k[s, h, i] W_k[i, h D + d]; head
// blockIdx.y.
__global__ void ftl_bwd_back_project_kernel(const float* __restrict__ A, Rows wk,
                                            float* __restrict__ dq, int S, int H, int D,
                                            int X, float scale) {
  extern __shared__ float4 smem4[];
  ftl::back_project_tiles(A, wk, dq, scale, S, H, D, X, blockIdx.y,
                          reinterpret_cast<float*>(smem4));
}

// Launch 4: blockIdx.y = p < 2: weight rows x * 32 .. of the gradient
// (0: A_k with qs, 1: A_v with g), every head, over the seeds of range z;
// blockIdx.y == 2: the dtime sums of range z.
struct WgradArgs {
  const float* ak;
  const float* av;
  const float* q;
  const float* g;
  float scale;
  float* dwt;    // (2, d_time, HD)
  float* dwe;    // (2, d_edge, HD)
  float* dtime;  // (2, d_time)
  Workspace ws;
  int S, H, D, X, d_time, d_edge, splits, split_rows;
};

// dtime partials of seeds k0 .. k1 - 1: lanes of kTimeLanes seeds per
// column, added in order.
__device__ void time_sums(const WgradArgs& a, int k0, int k1, int split) {
  __shared__ float red[kTimeLanes][kTimeCols + 1];
  const int C = 2 * a.d_time;
  const int chunks = ftl::ceil_div(C, kTimeCols);
  const int col_l = threadIdx.x % kTimeCols;
  const int r = threadIdx.x / kTimeCols;
  for (int cc = blockIdx.x; cc < chunks; cc += gridDim.x) {
    const int col = cc * kTimeCols + col_l;
    float acc = 0.f;
    if (col < C && r < kTimeLanes && k0 + r < k1) {
      acc = ftl::ordered_sum(a.ws.time + static_cast<size_t>(k0 + r) * C + col,
                             static_cast<size_t>(kTimeLanes) * C,
                             ftl::ceil_div(k1 - k0 - r, kTimeLanes));
    }
    if (r < kTimeLanes) red[r][col_l] = acc;
    __syncthreads();
    if (r == 0 && col < C) {
      float t = 0.f;
      for (int rr = 0; rr < kTimeLanes; ++rr) t += red[rr][col_l];
      a.ws.tpart[static_cast<size_t>(split) * C + col] = t;
    }
    __syncthreads();
  }
}

// Thread (r, h, c) holds the 4 x 4 sums of weight rows i0 + 4 r .. and
// columns h D + 4 c .. (within head h); the seeds stream through shared
// memory kWSeeds at a time.
__global__ void ftl_bwd_wgrad_kernel(WgradArgs a) {
  extern __shared__ float4 smem4[];
  const int split = blockIdx.z;
  const int k0 = split * a.split_rows;
  const int k1 = min(a.S, k0 + a.split_rows);
  if (blockIdx.y == 2) {
    time_sums(a, k0, k1, split);
    return;
  }
  const int p = blockIdx.y;
  const int H = a.H, D = a.D, X = a.X, HD = H * D;
  const int DP = ftl::round4(D);
  const int CG = DP / 4;
  const int i0 = blockIdx.x * kWRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* A = p ? a.av : a.ak;
  const float* B = p ? a.g : a.q;
  float* as = reinterpret_cast<float*>(smem4);  // kWSeeds x H x kWRows
  float* bs = as + kWSeeds * H * kWRows;        // kWSeeds x H x DP
  float* part = a.ws.part + (static_cast<size_t>(split) * 2 + p) * X * HD;
  const int tasks = (kWRows / 4) * H * CG;
  for (int base = 0; base < tasks; base += blockDim.x) {
    const int task = base + threadIdx.x;
    const int r = task % (kWRows / 4);
    const int h = (task / (kWRows / 4)) % H;
    const int c = task / ((kWRows / 4) * H);
    float acc[4][4] = {};
    for (int c0 = k0; c0 < k1; c0 += kWSeeds) {
      const int n = min(kWSeeds, k1 - c0);
      for (int rs = warp; rs < kWSeeds * H; rs += nw) {  // (seed, head) rows
        const int sl = rs / H;
        const int hh = rs - sl * H;
        const bool ok = sl < n;
        const size_t s = static_cast<size_t>(ok ? c0 + sl : k0);
        const bool in = ok && i0 + lane < X;
        ftl::cp_async4(as + rs * kWRows + lane, A + (s * H + hh) * X + (in ? i0 + lane : 0), in);
        for (int d = lane; d < DP; d += 32) {
          ftl::cp_async4(bs + rs * DP + d, B + s * HD + hh * D + (d < D ? d : 0), ok && d < D);
        }
      }
      ftl::cp_async_wait_all();
      __syncthreads();
      if (task < tasks) {
        for (int sl = 0; sl < n; ++sl) {
          const float4 x = *reinterpret_cast<const float4*>(as + (sl * H + h) * kWRows + 4 * r);
          const float4 y = *reinterpret_cast<const float4*>(bs + (sl * H + h) * DP + 4 * c);
          const float xr[4] = {x.x, x.y, x.z, x.w};
          const float yr[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xr[u], yr[v], acc[u][v]);
        }
      }
      __syncthreads();
    }
    if (task < tasks) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * r + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int d = 4 * c + v;
          if (i < X && d < D) part[static_cast<size_t>(i) * HD + h * D + d] = acc[u][v];
        }
      }
    }
  }
}

// Launch 5: every weight gradient and dtime entry, the sum of its seed
// ranges' partials in range order.
__global__ void ftl_bwd_wsum_kernel(WgradArgs a) {
  const int HD = a.H * a.D;
  const size_t XH = static_cast<size_t>(a.X) * HD;
  const size_t W = 2 * XH;
  const size_t C = 2 * static_cast<size_t>(a.d_time);
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < W + C;
       e += step) {
    if (e < W) {
      const int p = static_cast<int>(e / XH);
      const int i = static_cast<int>((e - p * XH) / HD);
      const int col = static_cast<int>(e - p * XH - static_cast<size_t>(i) * HD);
      const float t = ftl::ordered_sum(a.ws.part + e, W, a.splits);
      float* out = i < a.d_time ? a.dwt + (static_cast<size_t>(p) * a.d_time + i) * HD
                                : a.dwe + (static_cast<size_t>(p) * a.d_edge + i - a.d_time) * HD;
      out[col] = t * (p ? 1.f : a.scale);
    } else {
      a.dtime[e - W] = ftl::ordered_sum(a.ws.tpart + (e - W), C, a.splits);
    }
  }
}

size_t slot_smem(int H, int D, int K, int d_time, int d_edge) {
  const int HD = H * D, X = d_time + d_edge, kc = ftl::slot_chunk(K);
  return sizeof(float) * (2 * kc * ftl::round4(HD) + ftl::round4(kc * X) +
                          2 * ftl::round4(H * X) + 2 * HD + 2 * d_time + kc * d_time +
                          4 * H * kc + 3 * H + 2 * H * X + HD + 2 * d_time) +
         sizeof(int) * 3 * static_cast<size_t>(K);
}

template <class F>
cudaError_t fit(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t launch(const ProjArgs& pa, const float* g, const float* q, const float* k_tab,
                   const float* v_tab, const int* seeds, const int* seed_times,
                   const int* buf, const float* time_w, const float* time_b,
                   const float* edge_feats, float* dq, float* dk_tab, float* dv_tab,
                   const Workspace& ws, const WgradArgs& wa, int S, int H, int D, int K,
                   int d_time, int d_edge, float scale, cudaStream_t st) {
  const int X = d_time + d_edge;
  const int blocks = ftl::proj_blocks(S);
  cudaError_t err;
  // 1. U_k, U_v; zero the tables.
  {
    const size_t smem = ftl::proj_smem(X, D);
    err = fit(ftl_bwd_project_kernel, smem);
    if (err != cudaSuccess) return err;
    const int gx = blocks > kMinZeroBlocks ? blocks : kMinZeroBlocks;
    ftl_bwd_project_kernel<<<dim3(gx, pa.nz + 1), ftl::proj_threads(X), smem, st>>>(pa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 2. Slots.
  {
    const size_t smem = slot_smem(H, D, K, d_time, d_edge);
    err = fit(ftl_bwd_slot_kernel, smem);
    if (err != cudaSuccess) return err;
    ftl_bwd_slot_kernel<<<S, ftl::kSlotThreads, smem, st>>>(
        g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, edge_feats, dq, dk_tab,
        dv_tab, ws, H, D, K, d_time, d_edge, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || X == 0) return err;
  }
  // 3. dq += scale W_k^T A_k.
  {
    const size_t smem = ftl::back_smem(X, D);
    err = fit(ftl_bwd_back_project_kernel, smem);
    if (err != cudaSuccess) return err;
    ftl_bwd_back_project_kernel<<<dim3(blocks, H), ftl::back_threads(D), smem, st>>>(
        ws.ak, pa.wk, dq, S, H, D, X, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 4. Weight gradients and dtime.
  {
    const size_t smem = sizeof(float) * kWSeeds * H * (kWRows + ftl::round4(D));
    err = fit(ftl_bwd_wgrad_kernel, smem);
    if (err != cudaSuccess) return err;
    const int tasks = (kWRows / 4) * H * (ftl::round4(D) / 4);
    int threads = ftl::round32(tasks);  // at least the dtime blocks' 32 x 8
    threads = threads < kTimeCols * kTimeLanes ? kTimeCols * kTimeLanes : threads;
    threads = threads > 512 ? 512 : threads;
    const dim3 grid(ftl::ceil_div(X, kWRows), 2 + (d_time ? 1 : 0), wa.splits);
    ftl_bwd_wgrad_kernel<<<grid, threads, smem, st>>>(wa);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // 5. Their fixed-order sums.
  {
    const size_t total = 2 * static_cast<size_t>(X) * H * D + 2 * static_cast<size_t>(d_time);
    const int blocks = static_cast<int>((total + 255) / 256);
    ftl_bwd_wsum_kernel<<<blocks < 1024 ? blocks : 1024, 256, 0, st>>>(wa);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// Bytes of transient workspace `fused_temporal_layer_bwd` needs.
size_t fused_temporal_layer_bwd_workspace(int S, int H, int D, int K,
                                          int d_time, int d_edge) {
  (void)K;
  return carve(nullptr, S > 0 ? S : 0, H, D, d_time, d_edge).bytes;
}

// Returns a cudaError_t code (0 on success); every launch is asynchronous
// on `stream`. Outputs: dq (S, H, D); dk_tab/dv_tab (N, H, D), zeroed here;
// dtime (2, d_time) = [dtime_w; dtime_b]; dwt (2, d_time, H*D) =
// [dwt_k; dwt_v]; dwe (2, d_edge, H*D) = [dwe_k; dwe_v]. d_time = 0 turns
// the time group off (its pointers may be null), d_edge = 0 the edge group.
// `workspace` holds fused_temporal_layer_bwd_workspace(...) bytes.
int fused_temporal_layer_bwd(const float* g, const float* q, const float* k_tab,
                             const float* v_tab, const int* seeds,
                             const int* seed_times, const int* buf,
                             const float* time_w, const float* time_b,
                             const float* wt_k, const float* wt_v,
                             const float* edge_feats, const float* we_k,
                             const float* we_v, float* dq, float* dk_tab,
                             float* dv_tab, float* dtime, float* dwt, float* dwe,
                             float* workspace, int S, int N, int H, int D, int K,
                             int d_time, int d_edge, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HD = H * D;
  const int X = d_time + d_edge;
  const size_t table = static_cast<size_t>(N) * HD;
  cudaError_t err = cudaSuccess;
  if (S <= 0) {
    err = cudaMemsetAsync(dk_tab, 0, sizeof(float) * table, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv_tab, 0, sizeof(float) * table, st);
    if (err == cudaSuccess && d_time) err = cudaMemsetAsync(dtime, 0, sizeof(float) * 2 * d_time, st);
    if (err == cudaSuccess && d_time)
      err = cudaMemsetAsync(dwt, 0, sizeof(float) * 2 * static_cast<size_t>(d_time) * HD, st);
    if (err == cudaSuccess && d_edge)
      err = cudaMemsetAsync(dwe, 0, sizeof(float) * 2 * static_cast<size_t>(d_edge) * HD, st);
    return static_cast<int>(err);
  }
  const Workspace ws = carve(workspace, S, H, D, d_time, d_edge);
  const Rows wk{wt_k, we_k, d_time, HD};
  const Rows wv{wt_v, we_v, d_time, HD};
  const ProjArgs pa{q, g, wk, wv, ws.uk, ws.uv, scale, S, H, D, X, X > 0 ? 2 * H : 0,
                    dk_tab, dv_tab, table};
  const Split sp = weight_split(S);
  const WgradArgs wa{ws.ak, ws.av, q, g, scale, dwt, dwe, dtime, ws, S, H, D, X,
                     d_time, d_edge, sp.n, sp.rows};
  return static_cast<int>(launch(pa, g, q, k_tab, v_tab, seeds, seed_times, buf, time_w,
                                time_b, edge_feats, dq, dk_tab, dv_tab, ws, wa, S, H, D, K,
                                d_time, d_edge, scale, st));
}

const char* fused_temporal_layer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
