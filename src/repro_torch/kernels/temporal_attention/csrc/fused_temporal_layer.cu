// Fused neighbor gather + bias fold + masked attention over the packed
// recency buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/temporal_attention/kernel.py
// `fused_temporal_layer_kernel` (Pallas body `_fused_layer_kernel`). For
// every seed s with packed buffer row buf[seeds[s]] = K slots of
// (neighbor id, time, edge id):
//
//   k[j] = k_tab[id_j] + cos((t_s - t_j) * time_w + time_b) @ wt_k
//                      + edge_feats[eid_j] @ we_k           (v alike)
//   out[s] = softmax_j(q[s] * scale . k[j]) @ v            over valid slots
//
// The factored form. With x_j = [phi_j ; e_j] (X = d_time + d_edge wide)
// and W_k,h the (X, D) block of [wt_k ; we_k] for head h, the bias groups
// factor per seed: q_h . (x_j W_k,h) = (W_k,h q_h) . x_j, and
// sum_j p_j x_j W_v,h = (sum_j p_j x_j) W_v,h. So each weight matrix is
// crossed once per seed, not once per slot (8x fewer operations at the
// quickstart widths), in three launches on the caller's stream:
//
//   1. project: U[s, h] = W_k,h (q[s, h] * scale): a block holds head h's
//      weight block in shared memory and runs tiles of 8 seeds through it,
//      tile after tile, at most one block per SM and head (the weight
//      stream shared by every seed the block takes);
//   2. slots: one block of 128 threads per seed takes its slots 16 at a
//      time; a chunk's table rows, edge rows and Bochner encodings are
//      staged in shared memory at once (cp.async for the rows, 16 bytes a
//      lane where aligned), then a warp per (head, slot)
//      forms score_jh = (q_h * scale) . k_tab[id_j]_h + U[h] . x_j, and an
//      online softmax across chunks accumulates the partial output
//      sum_j p_jh v_tab[id_j]_h and Z[s, h] = sum_j p_jh x_j (one chunk, a
//      plain softmax, at K <= 16);
//   3. back-project: out[s, h] += Z[s, h] W_v,h, blocks as in 1, the sum
//      over X split four ways inside the block and added in order.
//
// U and Z, (S, H, X) each, live in the caller's workspace (9.6 MB at S =
// 4,400 and the quickstart widths: they stay in the 50 MB L2). With both
// bias groups off (the ids-only surface) only launch 2 runs. One call is
// one count of the wrapper's LAUNCHES, whatever the number of launches.
//
// What bounds it: after the factoring a seed costs 4 X HD flops of
// projections plus O(H (D + X)) a slot, ~0.6 GFLOP at S = 4,400, against
// ~30 MB of operands (0.0091 ms at 3.35 TB/s, ~0.009 ms at 67 TFLOP/s):
// level, and the bytes bound is the larger. Float32 on the CUDA cores
// throughout (TF32 in one pass would miss the 1e-4 tolerance at |k| ~ 1).
// Measured on an H100 (PERF.md), each launch takes several microseconds at
// these sizes whatever its work, and the slot pass's precise cosf (most
// arguments take its slow range reduction at wikipedia's time scale) is a
// large part of that pass.
//
// Numerics follow repro/kernels/temporal_attention/ref.py: the time delta is
// taken in int32 and then cast; theta = dt * w + b is rounded per operation
// (no fused multiply-add, as the plain versions compute it); cosf is the
// precise one; a masked slot is skipped, which is what its score of -1e30
// gives (its exp underflows to exactly 0); the softmax denominator has a
// floor of 1e-30; a row with every slot masked and a seed below 0 give exact
// zeros; a slot with eid -1 has a zero edge row. All accumulation is
// float32.

#include "fused_temporal_layer.cuh"

namespace {

using ftl::Rows;

// Launch 1: U[s, h, i] = scale * sum_d q[s, h, d] W_k[i, h D + d]; head
// blockIdx.y.
__global__ void ftl_fwd_project_kernel(const float* __restrict__ q, Rows wk,
                                       float* __restrict__ U, int S, int H, int D, int X,
                                       float scale) {
  extern __shared__ float4 smem4[];
  ftl::project_tiles(q, wk, U, scale, S, H, D, X, blockIdx.y,
                     reinterpret_cast<float*>(smem4));
}

// Launch 2: one block per seed.
__global__ void __launch_bounds__(ftl::kSlotThreads, ftl::kSlotBlocksPerSM)
ftl_fwd_slot_kernel(const float* __restrict__ q, const float* __restrict__ k_tab,
                    const float* __restrict__ v_tab, const int* __restrict__ seeds,
                    const int* __restrict__ seed_times, const int* __restrict__ buf,
                    const float* __restrict__ time_w, const float* __restrict__ time_b,
                    const float* __restrict__ edge_feats, const float* __restrict__ U,
                    float* __restrict__ Z, float* __restrict__ out, int H, int D, int K,
                    int d_time, int d_edge, float scale) {
  const int s = blockIdx.x;
  const int HD = H * D;
  const int X = d_time + d_edge;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nw = nt >> 5;
  float* o_row = out + static_cast<size_t>(s) * HD;
  float* z_row = Z + static_cast<size_t>(s) * H * X;
  const int kc = ftl::slot_chunk(K);
  const int HS = ftl::round4(HD);
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kc x HS: the chunk's k_tab rows
  float* vs = ks + kc * HS;                     // kc x HS: its v_tab rows
  float* xs = vs + kc * HS;                     // kc x X: its features
  float* u = xs + ftl::round4(kc * X);          // H X
  float* qs = u + ftl::round4(H * X);           // HD: q * scale
  float* tw = qs + HD;                          // d_time
  float* tb = tw + d_time;                      // d_time
  float* ev = tb + d_time;                      // H kc: scores, then exp(score - m)
  float* mh = ev + H * kc;                      // H: running max
  float* lh = mh + H;                           // H: running sum of exp
  float* ah = lh + H;                           // H: this chunk's rescale of the sums
  float* za = ah + H;                           // H X: sum_j e_jh x_j
  float* oa = za + H * X;                       // HD: sum_j e_jh v_tab[id_j]
  int* row = reinterpret_cast<int*>(oa + HD);   // 3 K

  // The copies that need no seed id go out first.
  ftl::copy_block(u, U + static_cast<size_t>(s) * H * X, H * X);
  ftl::copy_block(qs, q + static_cast<size_t>(s) * HD, HD);
  ftl::copy_block(tw, time_w, d_time);
  ftl::copy_block(tb, time_b, d_time);
  const int seed = seeds[s];
  if (seed < 0) {  // hop-2 frontier padding: exact zero row
    ftl::cp_async_wait_all();
    for (int c = tid; c < HD; c += nt) o_row[c] = 0.f;
    for (int i = tid; i < H * X; i += nt) z_row[i] = 0.f;
    return;
  }
  ftl::copy_block(reinterpret_cast<float*>(row),
                  reinterpret_cast<const float*>(buf + static_cast<size_t>(seed) * K * 3), 3 * K);
  for (int i = tid; i < H * X; i += nt) za[i] = 0.f;
  for (int c = tid; c < HD; c += nt) oa[c] = 0.f;
  for (int h = tid; h < H; h += nt) {
    mh[h] = -INFINITY;
    lh[h] = 0.f;
  }
  ftl::cp_async_wait_all();
  __syncthreads();
  for (int c = tid; c < HD; c += nt) qs[c] *= scale;

  const unsigned t_s = d_time ? static_cast<unsigned>(seed_times[s]) : 0u;
  for (int j0 = 0; j0 < K; j0 += kc) {
    const int n = min(kc, K - j0);
    ftl::stage_slots(row, j0, n, k_tab, v_tab, edge_feats, tw, tb, t_s, HD, d_time,
                     d_edge, ks, vs, xs, nullptr);
    ftl::cp_async_wait_all();
    __syncthreads();
    for (int pr = warp; pr < H * n; pr += nw) {
      const int h = pr / n;
      const int j = pr - h * n;
      if (row[3 * (j0 + j)] < 0) {  // masked slot: exp weight exactly 0
        if (lane == 0) ev[h * kc + j] = -INFINITY;
        continue;
      }
      const float sc = ftl::slot_dot(u, xs + j * X, qs, ks + j * HS, h, D, X, lane);
      if (lane == 0) ev[h * kc + j] = sc;
    }
    __syncthreads();
    // Online softmax update, a warp per head, lanes over the chunk's slots.
    for (int h = warp; h < H; h += nw) {
      float* e = ev + h * kc;
      const float sj = lane < n ? e[lane] : -INFINITY;
      const float m_old = mh[h];
      const float m = fmaxf(m_old, ftl::warp_max(sj));
      if (m == -INFINITY) {  // no valid slot yet: nothing to add
        if (lane < n) e[lane] = 0.f;
        if (lane == 0) ah[h] = 1.f;
        continue;
      }
      const float ej = lane < n ? expf(sj - m) : 0.f;
      if (lane < n) e[lane] = ej;
      const float sum = ftl::warp_sum_ordered(ej);
      if (lane == 0) {
        const float alpha = expf(m_old - m);
        mh[h] = m;
        lh[h] = fmaf(lh[h], alpha, sum);
        ah[h] = alpha;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < H * X; idx += nt) {
      const int h = idx / X;
      const int i = idx - h * X;
      const float* e = ev + h * kc;
      float acc = za[idx] * ah[h];
      for (int j = 0; j < n; ++j) acc = fmaf(e[j], xs[j * X + i], acc);
      za[idx] = acc;
    }
    for (int c = tid; c < HD; c += nt) {
      const int h = c / D;
      const float* e = ev + h * kc;
      float acc = oa[c] * ah[h];
      for (int j = 0; j < n; ++j) acc = fmaf(e[j], vs[j * HS + c], acc);
      oa[c] = acc;
    }
    __syncthreads();
  }

  // p = exp / max(sum, 1e-30); exact zeros for a row with no valid slot.
  for (int idx = tid; idx < H * X; idx += nt) {
    const int h = idx / X;
    z_row[idx] = mh[h] == -INFINITY ? 0.f : za[idx] / fmaxf(lh[h], 1e-30f);
  }
  for (int c = tid; c < HD; c += nt) {
    const int h = c / D;
    o_row[c] = mh[h] == -INFINITY ? 0.f : oa[c] / fmaxf(lh[h], 1e-30f);
  }
}

// Launch 3: out[s, h, d] += sum_i Z[s, h, i] W_v[i, h D + d]; head
// blockIdx.y.
__global__ void ftl_fwd_back_project_kernel(const float* __restrict__ Z, Rows wv,
                                            float* __restrict__ out, int S, int H, int D,
                                            int X) {
  extern __shared__ float4 smem4[];
  ftl::back_project_tiles(Z, wv, out, 1.f, S, H, D, X, blockIdx.y,
                          reinterpret_cast<float*>(smem4));
}

size_t slot_smem(int H, int D, int K, int d_time, int d_edge) {
  const int HD = H * D, X = d_time + d_edge, kc = ftl::slot_chunk(K);
  return sizeof(float) * (2 * kc * ftl::round4(HD) + ftl::round4(kc * X) +
                          ftl::round4(H * X) + HD + 2 * d_time + H * kc + 3 * H + H * X +
                          HD) +
         sizeof(int) * 3 * static_cast<size_t>(K);
}

// The kernel's dynamic shared memory, raised above the 48 KB default when
// it needs more.
template <class F>
cudaError_t fit(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

cudaError_t launch(const float* q, const float* k_tab, const float* v_tab, const int* seeds,
                   const int* seed_times, const int* buf, const float* time_w,
                   const float* time_b, const Rows& wk, const Rows& wv,
                   const float* edge_feats, float* out, float* U, float* Z, int S, int H,
                   int D, int K, int d_time, int d_edge, float scale, cudaStream_t st) {
  const int X = d_time + d_edge;
  const dim3 grid(ftl::proj_blocks(S), H);
  cudaError_t err;
  if (X > 0) {
    const size_t smem = ftl::proj_smem(X, D);
    err = fit(ftl_fwd_project_kernel, smem);
    if (err != cudaSuccess) return err;
    ftl_fwd_project_kernel<<<grid, ftl::proj_threads(X), smem, st>>>(q, wk, U, S, H, D, X,
                                                                      scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = slot_smem(H, D, K, d_time, d_edge);
  err = fit(ftl_fwd_slot_kernel, smem);
  if (err != cudaSuccess) return err;
  ftl_fwd_slot_kernel<<<S, ftl::kSlotThreads, smem, st>>>(
      q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, edge_feats, U, Z, out, H, D,
      K, d_time, d_edge, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || X == 0) return err;
  const size_t bsmem = ftl::back_smem(X, D);
  err = fit(ftl_fwd_back_project_kernel, bsmem);
  if (err != cudaSuccess) return err;
  ftl_fwd_back_project_kernel<<<grid, ftl::back_threads(D), bsmem, st>>>(Z, wv, out, S, H,
                                                                          D, X);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of workspace `fused_temporal_layer_fwd` needs: U and Z, (S, H, X)
// float32 each (none without a bias group).
size_t fused_temporal_layer_fwd_workspace(int S, int H, int D, int K, int d_time,
                                          int d_edge) {
  (void)D;
  (void)K;
  return sizeof(float) * 2 * static_cast<size_t>(S > 0 ? S : 0) * H * (d_time + d_edge);
}

// Returns a cudaError_t code (0 on success); the launches are asynchronous
// on `stream`. d_time = 0 turns the time group off (its pointers may be
// null), d_edge = 0 the edge group. `workspace` holds
// fused_temporal_layer_fwd_workspace(...) bytes (may be null when that is 0).
int fused_temporal_layer_fwd(const float* q, const float* k_tab,
                             const float* v_tab, const int* seeds,
                             const int* seed_times, const int* buf,
                             const float* time_w, const float* time_b,
                             const float* wt_k, const float* wt_v,
                             const float* edge_feats, const float* we_k,
                             const float* we_v, float* out, float* workspace,
                             int S, int H, int D, int K, int d_time, int d_edge,
                             float scale, void* stream) {
  if (S <= 0) return 0;
  const int HD = H * D;
  const int X = d_time + d_edge;
  const Rows wk{wt_k, we_k, d_time, HD};
  const Rows wv{wt_v, we_v, d_time, HD};
  float* U = workspace;
  float* Z = X ? workspace + static_cast<size_t>(S) * H * X : nullptr;
  return static_cast<int>(launch(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wk,
                                wv, edge_feats, out, U, Z, S, H, D, K, d_time, d_edge, scale,
                                static_cast<cudaStream_t>(stream)));
}

const char* fused_temporal_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
