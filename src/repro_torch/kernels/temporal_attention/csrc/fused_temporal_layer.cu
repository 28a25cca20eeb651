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
// What bounds it: at the quickstart shapes (H*D = 100, d_time = 100,
// d_edge = 172, K = 10) every slot costs 2 * (d_time + d_edge) * H*D * 2
// flops of bias products against ~2 KB of gathered rows, so the work is
// arithmetic in float32 on the CUDA cores, not memory. This first design is
// the simple one: one block per seed, one thread per output column. The
// block stages its buffer row, the K Bochner encodings and the K edge rows
// in shared memory (~19 KB), then each thread accumulates its column of k
// and v for up to KC slots at once in registers while it streams the weight
// columns (218 KB in total, kept in L2 across blocks). Scores reduce over D
// from shared memory and the softmax over K runs one thread per head. The
// TPU's scalar prefetch, 2-slot DMA staging and semaphores have no
// counterpart: a block loads its own indices. Faster designs (per-edge bias
// precomputed once, tensor cores, TMA staging, several seeds per block to
// share the weight stream) are later work.
//
// Numerics follow repro/kernels/temporal_attention/ref.py: the time delta is
// taken in int32 and then cast; theta = dt * w + b is rounded per operation
// (no fused multiply-add, as the plain versions compute it); masked scores
// are -1e30, the softmax denominator has a floor of 1e-30, a row with every
// slot masked and a seed below 0 give exact zeros; a slot with eid -1 has
// a zero edge row. All accumulation is float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int KC>
__global__ void __launch_bounds__(kThreads)
fused_temporal_layer_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k_tab,
    const float* __restrict__ v_tab, const int* __restrict__ seeds,
    const int* __restrict__ seed_times, const int* __restrict__ buf,
    const float* __restrict__ time_w, const float* __restrict__ time_b,
    const float* __restrict__ wt_k, const float* __restrict__ wt_v,
    const float* __restrict__ edge_feats, const float* __restrict__ we_k,
    const float* __restrict__ we_v, float* __restrict__ out,
    int H, int D, int K, int Kp, int d_time, int d_edge, float scale) {
  const int s = blockIdx.x;
  const int HD = H * D;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* o = out + static_cast<size_t>(s) * HD;
  const int seed = seeds[s];
  if (seed < 0) {  // hop-2 frontier padding: exact zero row, nothing read
    for (int c = tid; c < HD; c += nt) o[c] = 0.f;
    return;
  }

  extern __shared__ float smem[];
  int* row = reinterpret_cast<int*>(smem);   // K * 3
  float* qs = smem + K * 3;                  // HD
  float* phi = qs + HD;                      // Kp * d_time
  float* ef = phi + Kp * d_time;             // Kp * d_edge
  float* ks = ef + Kp * d_edge;              // K * HD
  float* vs = ks + K * HD;                   // K * HD
  float* p = vs + K * HD;                    // H * K

  const int* brow = buf + static_cast<size_t>(seed) * K * 3;
  for (int i = tid; i < K * 3; i += nt) row[i] = brow[i];
  const float* qrow = q + static_cast<size_t>(s) * HD;
  for (int c = tid; c < HD; c += nt) qs[c] = qrow[c] * scale;
  __syncthreads();

  if (d_time > 0) {
    const unsigned t_s = static_cast<unsigned>(seed_times[s]);
    for (int idx = tid; idx < Kp * d_time; idx += nt) {
      const int j = idx / d_time;
      const int i = idx - j * d_time;
      float val = 0.f;
      if (j < K) {
        // int32 difference (wrapping, as in the plain versions), then cast.
        const int dti = static_cast<int>(t_s - static_cast<unsigned>(row[j * 3 + 1]));
        const float theta = __fadd_rn(__fmul_rn(static_cast<float>(dti), time_w[i]), time_b[i]);
        val = cosf(theta);
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
      }
      ef[idx] = val;
    }
  }
  __syncthreads();

  // k and v columns: thread c owns column c of every slot.
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

  // Scores: one (head, slot) pair per thread, reduced over D.
  for (int idx = tid; idx < H * K; idx += nt) {
    const int h = idx / K;
    const int j = idx - h * K;
    const float* kr = ks + j * HD + h * D;
    const float* qr = qs + h * D;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    p[idx] = row[j * 3] >= 0 ? acc : -1e30f;
  }
  __syncthreads();

  // Masked softmax over K, one thread per head.
  for (int h = tid; h < H; h += nt) {
    float* ph = p + h * K;
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
    for (int j = 0; j < K; ++j) ph[j] = any ? ph[j] / denom : 0.f;
  }
  __syncthreads();

  for (int c = tid; c < HD; c += nt) {
    const float* ph = p + (c / D) * K;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc = fmaf(ph[j], vs[j * HD + c], acc);
    o[c] = acc;
  }
}

template <int KC>
cudaError_t launch(const float* q, const float* k_tab, const float* v_tab,
                   const int* seeds, const int* seed_times, const int* buf,
                   const float* time_w, const float* time_b,
                   const float* wt_k, const float* wt_v,
                   const float* edge_feats, const float* we_k,
                   const float* we_v, float* out, int S, int H, int D, int K,
                   int d_time, int d_edge, float scale, cudaStream_t stream) {
  const int HD = H * D;
  const int Kp = (K + KC - 1) / KC * KC;
  const size_t smem = sizeof(int) * K * 3 +
                      sizeof(float) * (HD + static_cast<size_t>(Kp) * (d_time + d_edge) +
                                       2 * static_cast<size_t>(K) * HD + H * K);
  auto kernel = fused_temporal_layer_fwd_kernel<KC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<S, kThreads, smem, stream>>>(q, k_tab, v_tab, seeds, seed_times, buf,
                                        time_w, time_b, wt_k, wt_v, edge_feats,
                                        we_k, we_v, out, H, D, K, Kp, d_time,
                                        d_edge, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t code (0 on success); the launch is asynchronous on
// `stream`. d_time = 0 turns the time group off (its pointers may be null),
// d_edge = 0 the edge group.
int fused_temporal_layer_fwd(const float* q, const float* k_tab,
                             const float* v_tab, const int* seeds,
                             const int* seed_times, const int* buf,
                             const float* time_w, const float* time_b,
                             const float* wt_k, const float* wt_v,
                             const float* edge_feats, const float* we_k,
                             const float* we_v, float* out, int S, int H,
                             int D, int K, int d_time, int d_edge, float scale,
                             void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Slots accumulated in registers at once: the smallest chunk that holds K
  // (K = 10 at the quickstart shape) or 16-slot chunks above that.
  cudaError_t err;
  if (K <= 2) {
    err = launch<2>(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k, wt_v,
                    edge_feats, we_k, we_v, out, S, H, D, K, d_time, d_edge, scale, st);
  } else if (K <= 4) {
    err = launch<4>(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k, wt_v,
                    edge_feats, we_k, we_v, out, S, H, D, K, d_time, d_edge, scale, st);
  } else if (K <= 8) {
    err = launch<8>(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k, wt_v,
                    edge_feats, we_k, we_v, out, S, H, D, K, d_time, d_edge, scale, st);
  } else if (K <= 10) {
    err = launch<10>(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k, wt_v,
                     edge_feats, we_k, we_v, out, S, H, D, K, d_time, d_edge, scale, st);
  } else {
    err = launch<16>(q, k_tab, v_tab, seeds, seed_times, buf, time_w, time_b, wt_k, wt_v,
                     edge_feats, we_k, we_v, out, S, H, D, K, d_time, d_edge, scale, st);
  }
  return static_cast<int>(err);
}

const char* fused_temporal_layer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
