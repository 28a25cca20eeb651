// Backward of the fused neighbor gather + bias fold + masked attention over
// the packed recency buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/temporal_attention/kernel.py
// `fused_temporal_layer_bwd_kernel` (Pallas body `_fused_layer_bwd_kernel`).
// For every seed s with packed buffer row buf[seeds[s]] = K slots of
// (neighbor id, time, edge id) and output cotangent g = dL/dout[s] (H, D):
//
//   recompute k[j], v[j] (bias folds included) and p = masked softmax
//   dv = p (x) g        dp = g . v        ds = p * (dp - sum_j p dp)
//   dq[s] = (ds . k) * scale               dk = ds (x) (q * scale)
//
// and, from the slot rows dkf, dvf (K, H*D), masked slots exactly zero:
//
//   dk_table[id_j] += dkf[j]   dv_table[id_j] += dvf[j]
//   dwt_k += phi^T dkf   dwt_v += phi^T dvf   dwe_k += e^T dkf   dwe_v += e^T dvf
//   dphi = dkf wt_k^T + dvf wt_v^T   dtheta = -sin(theta) * dphi
//   dtime_w += sum dtheta * dt       dtime_b += sum dtheta
//
// Seeds below 0 give exact zero rows and add nothing to any gradient.
//
// What bounds it: at the quickstart shapes (H*D = 100, d_time = 100,
// d_edge = 172, K = 10) every valid slot costs the forward's bias products
// again (4 * (d_time + d_edge) * H*D flops), dphi (4 * d_time * H*D) and the
// weight-gradient products (4 * (d_time + d_edge) * H*D): ~2.6 MFLOP a seed
// of float32 work on the CUDA cores against ~2 KB of gathered rows, so
// operations bound it, not bytes. The design is the simple one, in three
// passes on the caller's stream:
//
//   1. one block per seed (the forward's staging: buffer row, K Bochner
//      encodings and K edge rows in shared memory) recomputes k, v and p,
//      writes dq, adds the dk/dv rows into the zeroed tables with float
//      atomics (neighbor ids repeat within and across rows), reduces dtheta
//      over the row into a per-seed partial of dtime_w/dtime_b, and writes
//      the slot rows dkf, dvf, phi and e to a transient workspace;
//   2. the weight-gradient products phi^T [dkf|dvf] and e^T [dkf|dvf] as a
//      tiled reduction over the S*K slot rows, split into at most 32 row
//      ranges whose 32x32 output tiles each go to their own partial;
//   3. a fixed-order sum of the partials (and of the per-seed dtime
//      partials) into the outputs.
//
// Passes 2 and 3 replace the TPU's grid-resident accumulators: blocks run in
// parallel here, and one atomic per weight float per seed would put ~33 M
// atomics on the same 54,600 addresses. They are deterministic; the table
// gradients are not, since float atomics add in the order blocks arrive.
// The TPU's scalar prefetch, 2-slot DMA ring, semaphores and sequential DMA
// read-modify-write have no counterpart. Faster designs (tensor cores, one
// pass with the products kept on chip) are later work.
//
// Numerics follow the forward (fused_temporal_layer.cu): the time delta is
// taken in int32 and then cast; theta = dt * w + b is rounded per operation;
// cosf/sinf are the precise ones; masked scores are -1e30 and the softmax
// denominator has a floor of 1e-30. All accumulation is float32.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;           // weight-gradient output tile, rows and columns
constexpr int kTileRows = 32;       // slot rows staged per step of pass 2
constexpr int kMaxSplits = 32;      // row ranges of pass 2 (partials per output)
constexpr int kMinRowsPerSplit = 256;
constexpr int kSumCols = 32;        // pass 3: columns per block
constexpr int kSumRows = 8;         // pass 3: row lanes per column

struct Split {
  int n;      // number of row ranges
  int rows;   // rows per range (a multiple of kTileRows)
};

// Row ranges of pass 2 for R slot rows: a function of R alone, so the
// partials always add up in the same order.
Split weight_split(int R) {
  if (R <= 0) return {1, kTileRows};
  int n = (R + kMinRowsPerSplit - 1) / kMinRowsPerSplit;
  n = n > kMaxSplits ? kMaxSplits : n;
  const int rows = ((R + n - 1) / n + kTileRows - 1) / kTileRows * kTileRows;
  return {(R + rows - 1) / rows, rows};
}

struct Workspace {
  float* dk;      // S*K x HD slot rows dkf
  float* dv;      // S*K x HD slot rows dvf
  float* phi;     // S*K x d_time Bochner encodings
  float* ef;      // S*K x d_edge edge rows (zero where eid = -1)
  float* time;    // S x 2 x d_time per-seed dtime_w / dtime_b partials
  float* part_t;  // splits x 2 x d_time x HD partials of dwt_k / dwt_v
  float* part_e;  // splits x 2 x d_edge x HD partials of dwe_k / dwe_v
  size_t floats;
};

Workspace carve(float* base, int S, int HD, int K, int d_time, int d_edge) {
  const size_t rows = static_cast<size_t>(S) * K;
  const Split sp = weight_split(S * K);
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  w.dk = take(rows * HD);
  w.dv = take(rows * HD);
  w.phi = take(rows * d_time);
  w.ef = take(rows * d_edge);
  w.time = take(static_cast<size_t>(S) * 2 * d_time);
  w.part_t = take(static_cast<size_t>(sp.n) * 2 * d_time * HD);
  w.part_e = take(static_cast<size_t>(sp.n) * 2 * d_edge * HD);
  w.floats = off;
  return w;
}

// Pass 1: one block per seed.
template <int KC>
__global__ void __launch_bounds__(kThreads)
bwd_seed_kernel(
    const float* __restrict__ g, const float* __restrict__ q,
    const float* __restrict__ k_tab, const float* __restrict__ v_tab,
    const int* __restrict__ seeds, const int* __restrict__ seed_times,
    const int* __restrict__ buf, const float* __restrict__ time_w,
    const float* __restrict__ time_b, const float* __restrict__ wt_k,
    const float* __restrict__ wt_v, const float* __restrict__ edge_feats,
    const float* __restrict__ we_k, const float* __restrict__ we_v,
    float* __restrict__ dq, float* __restrict__ dk_tab,
    float* __restrict__ dv_tab, Workspace ws, int H, int D, int K, int Kp,
    int d_time, int d_edge, float scale) {
  const int s = blockIdx.x;
  const int HD = H * D;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* dq_row = dq + static_cast<size_t>(s) * HD;
  float* w_dk = ws.dk + static_cast<size_t>(s) * K * HD;
  float* w_dv = ws.dv + static_cast<size_t>(s) * K * HD;
  float* w_phi = d_time ? ws.phi + static_cast<size_t>(s) * K * d_time : nullptr;
  float* w_ef = d_edge ? ws.ef + static_cast<size_t>(s) * K * d_edge : nullptr;
  float* w_time = d_time ? ws.time + static_cast<size_t>(s) * 2 * d_time : nullptr;

  const int seed = seeds[s];
  if (seed < 0) {  // hop-2 frontier padding: zero row, zero contributions
    for (int c = tid; c < HD; c += nt) dq_row[c] = 0.f;
    for (int i = tid; i < K * HD; i += nt) w_dk[i] = w_dv[i] = 0.f;
    for (int i = tid; i < K * d_time; i += nt) w_phi[i] = 0.f;
    for (int i = tid; i < K * d_edge; i += nt) w_ef[i] = 0.f;
    for (int i = tid; i < 2 * d_time; i += nt) w_time[i] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  int* row = reinterpret_cast<int*>(smem);   // K * 3
  float* qs = smem + K * 3;                  // HD, q * scale
  float* gs = qs + HD;                       // HD, cotangent
  float* phi = gs + HD;                      // Kp * d_time
  float* ef = phi + Kp * d_time;             // Kp * d_edge
  float* ks = ef + Kp * d_edge;              // K * HD: k, later dkf
  float* vs = ks + K * HD;                   // K * HD: v, later dvf
  float* p = vs + K * HD;                    // H * K softmax weights
  float* ds = p + H * K;                     // H * K: dp, later ds

  const int* brow = buf + static_cast<size_t>(seed) * K * 3;
  for (int i = tid; i < K * 3; i += nt) row[i] = brow[i];
  const float* qrow = q + static_cast<size_t>(s) * HD;
  const float* grow = g + static_cast<size_t>(s) * HD;
  for (int c = tid; c < HD; c += nt) {
    qs[c] = qrow[c] * scale;
    gs[c] = grow[c];
  }
  __syncthreads();

  const unsigned t_s = d_time ? static_cast<unsigned>(seed_times[s]) : 0u;
  if (d_time > 0) {
    for (int idx = tid; idx < Kp * d_time; idx += nt) {
      const int j = idx / d_time;
      const int i = idx - j * d_time;
      float val = 0.f;
      if (j < K) {
        // int32 difference (wrapping, as in the plain versions), then cast.
        const int dti = static_cast<int>(t_s - static_cast<unsigned>(row[j * 3 + 1]));
        const float theta = __fadd_rn(__fmul_rn(static_cast<float>(dti), time_w[i]), time_b[i]);
        val = cosf(theta);
        w_phi[idx] = val;
      }
      phi[idx] = val;
    }
  }
  if (d_edge > 0) {
    for (int idx = tid; idx < Kp * d_edge; idx += nt) {
      const int j = idx / d_edge;
      const int e = idx - j * d_edge;
      float val = 0.f;
      if (j < K) {
        const int eid = row[j * 3 + 2];
        if (eid >= 0) val = edge_feats[static_cast<size_t>(eid) * d_edge + e];
        w_ef[idx] = val;
      }
      ef[idx] = val;
    }
  }
  __syncthreads();

  // k and v columns, as the forward builds them: thread c owns column c.
  for (int c = tid; c < HD; c += nt) {
    for (int j0 = 0; j0 < K; j0 += KC) {
      float ak[KC], av[KC], bk[KC], bv[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        ak[jj] = av[jj] = bk[jj] = bv[jj] = 0.f;
      }
      for (int i = 0; i < d_time; ++i) {
        const float wk = wt_k[static_cast<size_t>(i) * HD + c];
        const float wv = wt_v[static_cast<size_t>(i) * HD + c];
        const float* f = phi + j0 * d_time + i;
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          const float x = f[jj * d_time];
          ak[jj] = fmaf(x, wk, ak[jj]);
          av[jj] = fmaf(x, wv, av[jj]);
        }
      }
      for (int e = 0; e < d_edge; ++e) {
        const float wk = we_k[static_cast<size_t>(e) * HD + c];
        const float wv = we_v[static_cast<size_t>(e) * HD + c];
        const float* f = ef + j0 * d_edge + e;
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          const float x = f[jj * d_edge];
          bk[jj] = fmaf(x, wk, bk[jj]);
          bv[jj] = fmaf(x, wv, bv[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = j0 + jj;
        if (j < K) {
          const size_t nid = static_cast<size_t>(max(row[j * 3], 0));
          ks[j * HD + c] = (k_tab[nid * HD + c] + ak[jj]) + bk[jj];
          vs[j * HD + c] = (v_tab[nid * HD + c] + av[jj]) + bv[jj];
        }
      }
    }
  }
  __syncthreads();

  // Scores and dp = g . v: one (head, slot) pair per thread, reduced over D.
  for (int idx = tid; idx < H * K; idx += nt) {
    const int h = idx / K;
    const int j = idx - h * K;
    const float* kr = ks + j * HD + h * D;
    const float* vr = vs + j * HD + h * D;
    const float* qr = qs + h * D;
    const float* gr = gs + h * D;
    float sc = 0.f, dp = 0.f;
    for (int d = 0; d < D; ++d) {
      sc = fmaf(qr[d], kr[d], sc);
      dp = fmaf(gr[d], vr[d], dp);
    }
    p[idx] = row[j * 3] >= 0 ? sc : -1e30f;
    ds[idx] = dp;
  }
  __syncthreads();

  // Masked softmax and ds = p * (dp - sum_j p dp), one thread per head.
  for (int h = tid; h < H; h += nt) {
    float* ph = p + h * K;
    float* dh = ds + h * K;
    float m = ph[0];
    bool any = false;
    for (int j = 0; j < K; ++j) {
      m = fmaxf(m, ph[j]);
      any = any || row[j * 3] >= 0;
    }
    float sum = 0.f;
    for (int j = 0; j < K; ++j) {
      const float e = expf(ph[j] - m);
      ph[j] = e;
      sum += e;
    }
    const float denom = fmaxf(sum, 1e-30f);
    float pdp = 0.f;
    for (int j = 0; j < K; ++j) {
      ph[j] = any ? ph[j] / denom : 0.f;
      pdp = fmaf(ph[j], dh[j], pdp);
    }
    for (int j = 0; j < K; ++j) dh[j] = ph[j] * (dh[j] - pdp);
  }
  __syncthreads();

  // dq = (ds . k) * scale.
  for (int c = tid; c < HD; c += nt) {
    const float* dh = ds + (c / D) * K;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(dh[j], ks[j * HD + c], acc);
    dq_row[c] = acc * scale;
  }
  __syncthreads();

  // Slot rows dkf = ds (x) q*scale, dvf = p (x) g (masked slots exactly 0):
  // into shared memory (over k, v), the workspace and the table gradients.
  for (int idx = tid; idx < K * HD; idx += nt) {
    const int j = idx / HD;
    const int c = idx - j * HD;
    const int nid = row[j * 3];
    const int hk = (c / D) * K + j;
    float dkf = 0.f, dvf = 0.f;
    if (nid >= 0) {
      dkf = ds[hk] * qs[c];
      dvf = p[hk] * gs[c];
      atomicAdd(dk_tab + static_cast<size_t>(nid) * HD + c, dkf);
      atomicAdd(dv_tab + static_cast<size_t>(nid) * HD + c, dvf);
    }
    ks[idx] = dkf;
    vs[idx] = dvf;
    w_dk[idx] = dkf;
    w_dv[idx] = dvf;
  }
  if (d_time == 0) return;
  __syncthreads();

  // dphi, dtheta and this seed's dtime partials: thread i owns time
  // feature i and walks the slots KC at a time.
  for (int i = tid; i < d_time; i += nt) {
    const float wi = time_w[i];
    const float bi = time_b[i];
    const float* wk_row = wt_k + static_cast<size_t>(i) * HD;
    const float* wv_row = wt_v + static_cast<size_t>(i) * HD;
    float tw = 0.f, tb = 0.f;
    for (int j0 = 0; j0 < K; j0 += KC) {
      float acc[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) acc[jj] = 0.f;
      for (int c = 0; c < HD; ++c) {
        const float wk = wk_row[c];
        const float wv = wv_row[c];
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          if (j0 + jj < K) {
            acc[jj] = fmaf(ks[(j0 + jj) * HD + c], wk, acc[jj]);
            acc[jj] = fmaf(vs[(j0 + jj) * HD + c], wv, acc[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = j0 + jj;
        if (j < K && row[j * 3] >= 0) {
          const int dti = static_cast<int>(t_s - static_cast<unsigned>(row[j * 3 + 1]));
          const float dt = static_cast<float>(dti);
          const float theta = __fadd_rn(__fmul_rn(dt, wi), bi);
          const float dtheta = -sinf(theta) * acc[jj];
          tw = fmaf(dtheta, dt, tw);
          tb += dtheta;
        }
      }
    }
    w_time[i] = tw;
    w_time[d_time + i] = tb;
  }
}

// Pass 2: P[z][0] = A^T B1 and P[z][1] = A^T B2 over the z-th range of the
// R rows. A: (R, M), B1/B2: (R, N), all row-major; each block one 32x32
// output tile of both products, 256 threads with 2x2 outputs each.
__global__ void __launch_bounds__(256)
weight_grad_partial_kernel(const float* __restrict__ A,
                           const float* __restrict__ B1,
                           const float* __restrict__ B2,
                           float* __restrict__ P, int R, int M, int N,
                           int rows_per_split) {
  __shared__ float as[kTileRows][kTile];
  __shared__ float b1s[kTileRows][kTile];
  __shared__ float b2s[kTileRows][kTile];
  const int m0 = blockIdx.x * kTile;
  const int n0 = blockIdx.y * kTile;
  const int z = blockIdx.z;
  const int r_lo = z * rows_per_split;
  const int r_hi = min(R, r_lo + rows_per_split);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float c1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float c2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int r0 = r_lo; r0 < r_hi; r0 += kTileRows) {
    for (int idx = threadIdx.x; idx < kTileRows * kTile; idx += blockDim.x) {
      const int rr = idx / kTile;
      const int cc = idx - rr * kTile;
      const int r = r0 + rr;
      const bool in = r < r_hi;
      const int m = m0 + cc;
      const int n = n0 + cc;
      as[rr][cc] = in && m < M ? A[static_cast<size_t>(r) * M + m] : 0.f;
      b1s[rr][cc] = in && n < N ? B1[static_cast<size_t>(r) * N + n] : 0.f;
      b2s[rr][cc] = in && n < N ? B2[static_cast<size_t>(r) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTileRows; ++rr) {
      const float a0 = as[rr][2 * ty];
      const float a1 = as[rr][2 * ty + 1];
      const float x0 = b1s[rr][2 * tx];
      const float x1 = b1s[rr][2 * tx + 1];
      const float y0 = b2s[rr][2 * tx];
      const float y1 = b2s[rr][2 * tx + 1];
      c1[0][0] = fmaf(a0, x0, c1[0][0]);
      c1[0][1] = fmaf(a0, x1, c1[0][1]);
      c1[1][0] = fmaf(a1, x0, c1[1][0]);
      c1[1][1] = fmaf(a1, x1, c1[1][1]);
      c2[0][0] = fmaf(a0, y0, c2[0][0]);
      c2[0][1] = fmaf(a0, y1, c2[0][1]);
      c2[1][0] = fmaf(a1, y0, c2[1][0]);
      c2[1][1] = fmaf(a1, y1, c2[1][1]);
    }
    __syncthreads();
  }
  float* p1 = P + static_cast<size_t>(2 * z) * M * N;
  float* p2 = p1 + static_cast<size_t>(M) * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int m = m0 + 2 * ty + i;
      const int n = n0 + 2 * tx + k;
      if (m < M && n < N) {
        p1[static_cast<size_t>(m) * N + n] = c1[i][k];
        p2[static_cast<size_t>(m) * N + n] = c2[i][k];
      }
    }
  }
}

// Pass 3: out[x] = sum over l of P[l][x], in a fixed order (deterministic).
__global__ void __launch_bounds__(kSumCols * kSumRows)
sum_partials_kernel(const float* __restrict__ P, int L, int X,
                    float* __restrict__ out) {
  __shared__ float part[kSumRows][kSumCols];
  const int x = blockIdx.x * kSumCols + threadIdx.x;
  float acc = 0.f;
  if (x < X) {
    for (int l = threadIdx.y; l < L; l += kSumRows) {
      acc += P[static_cast<size_t>(l) * X + x];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && x < X) {
    float t = 0.f;
    for (int y = 0; y < kSumRows; ++y) t += part[y][threadIdx.x];
    out[x] = t;
  }
}

cudaError_t sum_partials(const float* P, int L, int X, float* out,
                         cudaStream_t st) {
  if (X <= 0) return cudaSuccess;
  const dim3 block(kSumCols, kSumRows);
  sum_partials_kernel<<<(X + kSumCols - 1) / kSumCols, block, 0, st>>>(P, L, X, out);
  return cudaGetLastError();
}

cudaError_t weight_grads(const float* A, const float* B1, const float* B2,
                         float* part, float* out, int R, int M, int N,
                         cudaStream_t st) {
  const Split sp = weight_split(R);
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, sp.n);
  weight_grad_partial_kernel<<<grid, 256, 0, st>>>(A, B1, B2, part, R, M, N, sp.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(part, sp.n, 2 * M * N, out, st);
}

template <int KC>
cudaError_t launch_seeds(const float* g, const float* q, const float* k_tab,
                         const float* v_tab, const int* seeds,
                         const int* seed_times, const int* buf,
                         const float* time_w, const float* time_b,
                         const float* wt_k, const float* wt_v,
                         const float* edge_feats, const float* we_k,
                         const float* we_v, float* dq, float* dk_tab,
                         float* dv_tab, const Workspace& ws, int S, int H,
                         int D, int K, int d_time, int d_edge, float scale,
                         cudaStream_t stream) {
  const int HD = H * D;
  const int Kp = (K + KC - 1) / KC * KC;
  const size_t smem = sizeof(int) * K * 3 +
                      sizeof(float) * (2 * static_cast<size_t>(HD) +
                                       static_cast<size_t>(Kp) * (d_time + d_edge) +
                                       2 * static_cast<size_t>(K) * HD + 2 * H * K);
  auto kernel = bwd_seed_kernel<KC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<S, kThreads, smem, stream>>>(g, q, k_tab, v_tab, seeds, seed_times, buf,
                                        time_w, time_b, wt_k, wt_v, edge_feats,
                                        we_k, we_v, dq, dk_tab, dv_tab, ws, H, D,
                                        K, Kp, d_time, d_edge, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of transient workspace `fused_temporal_layer_bwd` needs.
size_t fused_temporal_layer_bwd_workspace(int S, int H, int D, int K,
                                          int d_time, int d_edge) {
  return sizeof(float) * carve(nullptr, S, H * D, K, d_time, d_edge).floats;
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
  const size_t table = sizeof(float) * static_cast<size_t>(N) * HD;
  cudaError_t err = cudaMemsetAsync(dk_tab, 0, table, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(dv_tab, 0, table, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S <= 0) {
    if (d_time) err = cudaMemsetAsync(dtime, 0, sizeof(float) * 2 * d_time, st);
    if (err == cudaSuccess && d_time)
      err = cudaMemsetAsync(dwt, 0, sizeof(float) * 2 * static_cast<size_t>(d_time) * HD, st);
    if (err == cudaSuccess && d_edge)
      err = cudaMemsetAsync(dwe, 0, sizeof(float) * 2 * static_cast<size_t>(d_edge) * HD, st);
    return static_cast<int>(err);
  }
  const Workspace ws = carve(workspace, S, HD, K, d_time, d_edge);
  // Slots held in registers at once, as the forward chooses them.
  if (K <= 2) {
    err = launch_seeds<2>(g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k,
                          wt_v, edge_feats, we_k, we_v, dq, dk_tab, dv_tab, ws, S, H, D, K,
                          d_time, d_edge, scale, st);
  } else if (K <= 4) {
    err = launch_seeds<4>(g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k,
                          wt_v, edge_feats, we_k, we_v, dq, dk_tab, dv_tab, ws, S, H, D, K,
                          d_time, d_edge, scale, st);
  } else if (K <= 8) {
    err = launch_seeds<8>(g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k,
                          wt_v, edge_feats, we_k, we_v, dq, dk_tab, dv_tab, ws, S, H, D, K,
                          d_time, d_edge, scale, st);
  } else if (K <= 10) {
    err = launch_seeds<10>(g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k,
                           wt_v, edge_feats, we_k, we_v, dq, dk_tab, dv_tab, ws, S, H, D, K,
                           d_time, d_edge, scale, st);
  } else {
    err = launch_seeds<16>(g, q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k,
                           wt_v, edge_feats, we_k, we_v, dq, dk_tab, dv_tab, ws, S, H, D, K,
                           d_time, d_edge, scale, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = S * K;
  if (d_time) {
    err = weight_grads(ws.phi, ws.dk, ws.dv, ws.part_t, dwt, R, d_time, HD, st);
    if (err == cudaSuccess) err = sum_partials(ws.time, S, 2 * d_time, dtime, st);
  }
  if (err == cudaSuccess && d_edge) {
    err = weight_grads(ws.ef, ws.dk, ws.dv, ws.part_e, dwe, R, d_edge, HD, st);
  }
  return static_cast<int>(err);
}

const char* fused_temporal_layer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
