// Gradient of the seed -> K-neighbor masked attention (K3b), for Hopper
// (sm_90a).
//
// The JAX package has no TPU kernel for it: its temporal_attention_kernel
// is forward only, and jax.grad differentiates the jnp oracle
// (`temporal_attention_ref`). This kernel computes that gradient for the
// cotangent g (S, H, D) of K3's output, per seed s, head h and valid slot j:
//
//   s_jh  = (q_h . k_jh) * scale,   p_jh = softmax_j(s_jh)
//   dp_jh = g_h . v_jh
//   delta_h = sum_j p_jh dp_jh
//   ds_jh = p_jh (dp_jh - delta_h)
//   dq_h  = scale * sum_j ds_jh k_jh
//   dk_jh = scale * ds_jh q_h
//   dv_jh = p_jh g_h
//
// with exact zeros in dk and dv for masked slots and in dq, dk and dv for a
// seed with no valid slot, as the oracle's `where`s give. Gradients come
// back in q's type (float32 or bfloat16), arithmetic in float32.
//
// What bounds it: each valid slot's k and v rows read once, q and g read
// once, dq and the whole dk and dv (masked slots included) written once:
// bytes, ~10 MB and ~3 us on an H100 at the classic path's train shape
// (S = 600, K = 10, H = 2, D = 50).
//
// Design: K3's (temporal_attention.cu, helpers in temporal_attention.cuh):
// one warp per seed over all heads, its valid slots found by a ballot per
// chunk of up to 16 slots and their k and v rows staged, compacted, in the
// warp's shared memory by 16-byte cp.async (element loads on the scalar
// path). Pass 1 computes the scores and dp, one lane per (staged row,
// head), and keeps per head an online maximum m, sum l and t = sum_j
// exp(s_jh - m) dp_jh, started by the first chunk with a valid slot; then
// delta = t / l. Pass 2 forms p and ds per pair, then each lane takes a
// group of adjacent columns (16 bytes on the vector path): dq's float32
// accumulators in shared memory, and each valid slot's dk and dv row written
// once, 16 bytes at a time; masked slots' rows are written as zeros. With
// one chunk (K <= 16: the path's K = 10) pass 2 reuses pass 1's staged rows
// and exponentials; with more, it stages each chunk again and recomputes its
// scores with the same code (the same bits). No atomics: every (seed, slot)
// row belongs to one warp, so a second launch gives the same bits in all
// three gradients.

#include "temporal_attention.cuh"

namespace {

using namespace ta;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
ta_bwd_kernel(const T* __restrict__ g, const T* __restrict__ q,
              const T* __restrict__ k, const T* __restrict__ v,
              const unsigned char* __restrict__ mask, T* __restrict__ dq,
              T* __restrict__ dk, T* __restrict__ dv, int S, int K, int H, int D,
              int chunk, int warp_bytes, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long s = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (s >= S) return;  // whole warps leave; nothing below syncs the block
  const int HD = H * D;
  constexpr int kPer = group_size<T, kVec>();
  const bool wide = D >= kPer;
  const BwdLayout L(chunk, H, HD, sizeof(T));
  unsigned char* base = smem + static_cast<size_t>(warp) * warp_bytes;
  T* ks = reinterpret_cast<T*>(base + L.ks);
  T* vs = reinterpret_cast<T*>(base + L.vs);
  T* qs = reinterpret_cast<T*>(base + L.qs);
  T* gs = reinterpret_cast<T*>(base + L.gs);
  float* sc = reinterpret_cast<float*>(base + L.sc);  // s, then e = exp(s - m), then p
  float* dp = reinterpret_cast<float*>(base + L.dp);  // dp, then ds
  float* mx = reinterpret_cast<float*>(base + L.st);  // running max per head
  float* sum = mx + H;                                // running sum per head
  float* tt = sum + H;                                // running sum of e * dp, then delta
  float* alpha = tt + H;                              // this chunk's rescale
  float* dqa = reinterpret_cast<float*>(base + L.dq);

  const size_t row0 = static_cast<size_t>(s) * K;
  const unsigned char* mrow = mask + row0;
  const size_t seed0 = row0 * HD;
  const bool one_chunk = K <= chunk;

  // Stage a chunk's valid rows (with q and g the first time): q, g and the
  // key rows as one cp.async group, the value rows as a second; then the
  // scores (once the first group is in) and dp (once the second is), one
  // lane per (staged row, head).
  auto stage_and_score = [&](unsigned bits, int c0, int n, bool first) {
    if (first) {
      stage_row<T, kVec>(qs, q + static_cast<size_t>(s) * HD, HD, lane);
      stage_row<T, kVec>(gs, g + static_cast<size_t>(s) * HD, HD, lane);
    }
    stage_rows<T, kVec>(ks, k + seed0, bits, c0, HD, lane);
    commit<kVec>();
    stage_rows<T, kVec>(vs, v + seed0, bits, c0, HD, lane);
    commit<kVec>();
    wait_until_one_left<kVec>();
    __syncwarp();
    for (int p = lane; p < n * H; p += kWarp) {
      const int jj = p / H, h = p - jj * H;
      sc[p] = dot(qs + h * D, ks + static_cast<size_t>(jj) * HD + h * D, D) * scale;
    }
    wait_all<kVec>();
    __syncwarp();
    for (int p = lane; p < n * H; p += kWarp) {
      const int jj = p / H, h = p - jj * H;
      dp[p] = dot(gs + h * D, vs + static_cast<size_t>(jj) * HD + h * D, D);
    }
  };

  // Pass 1: the softmax statistics and delta per head.
  bool seen = false;
  for (int c0 = 0; c0 < K; c0 += chunk) {
    const unsigned bits = chunk_bits(mrow, c0, min(chunk, K - c0), lane);
    if (bits == 0) continue;
    const int n = __popc(bits);
    stage_and_score(bits, c0, n, !seen);
    __syncwarp();
    for (int h = lane; h < H; h += kWarp) {
      float m = sc[h];
#pragma unroll 4
      for (int jj = 1; jj < n; ++jj) m = fmaxf(m, sc[jj * H + h]);
      if (seen) {
        const float mn = fmaxf(mx[h], m);
        alpha[h] = expf(mx[h] - mn);
        mx[h] = mn;
      } else {
        alpha[h] = 0.f;
        mx[h] = m;
      }
    }
    __syncwarp();
    for (int p = lane; p < n * H; p += kWarp) sc[p] = expf(sc[p] - mx[p % H]);
    __syncwarp();
    for (int h = lane; h < H; h += kWarp) {
      float l = 0.f, t = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        l += sc[jj * H + h];
        t = fmaf(sc[jj * H + h], dp[jj * H + h], t);
      }
      sum[h] = seen ? alpha[h] * sum[h] + l : l;
      tt[h] = seen ? alpha[h] * tt[h] + t : t;
    }
    seen = true;
    __syncwarp();
  }

  const T zero = from_f32<T>(0.f);
  if (!seen) {  // no valid slot: exact zeros everywhere
    for (int c = lane; c < HD; c += kWarp) dq[static_cast<size_t>(s) * HD + c] = zero;
    for (size_t c = lane; c < static_cast<size_t>(K) * HD; c += kWarp) {
      dk[seed0 + c] = zero;
      dv[seed0 + c] = zero;
    }
    return;
  }
  for (int h = lane; h < H; h += kWarp) tt[h] = tt[h] / sum[h];  // delta
  __syncwarp();

  // Pass 2: p and ds per pair, then by column groups dq's sums and each
  // valid slot's dk and dv row; masked slots' rows are zeros.
  bool first = true;
  for (int c0 = 0; c0 < K; c0 += chunk) {
    const int cn = min(chunk, K - c0);
    const unsigned bits = chunk_bits(mrow, c0, cn, lane);
    const int n = __popc(bits);
    if (n) {
      if (!one_chunk) {  // stage again; the same code gives the same scores
        stage_and_score(bits, c0, n, false);
        __syncwarp();
        for (int p = lane; p < n * H; p += kWarp) sc[p] = expf(sc[p] - mx[p % H]);
      }
      for (int p = lane; p < n * H; p += kWarp) {
        const int h = p % H;
        const float pr = sc[p] / sum[h];
        sc[p] = pr;
        dp[p] = pr * (dp[p] - tt[h]);
      }
      __syncwarp();
      for (int gi = lane; gi < HD / kPer; gi += kWarp) {
        const int col0 = gi * kPer;
        const GroupHeads<kPer> heads(col0, D);
        float qd[kPer], gd[kPer], a[kPer] = {};
        load_group<kPer>(qs + col0, qd);
        load_group<kPer>(gs + col0, gd);
        int jj = 0;
        for (unsigned b = bits; b; b &= b - 1, ++jj) {
          const size_t out = seed0 + static_cast<size_t>(c0 + __ffs(b) - 1) * HD + col0;
          float x[kPer], ds[kPer], pr[kPer], dkr[kPer], dvr[kPer];
          load_group<kPer>(ks + static_cast<size_t>(jj) * HD + col0, x);
          heads.gather(dp + jj * H, ds, wide);
          heads.gather(sc + jj * H, pr, wide);
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            a[e] = fmaf(ds[e], x[e], a[e]);
            dkr[e] = ds[e] * (qd[e] * scale);
            dvr[e] = pr[e] * gd[e];
          }
          store_group<kPer>(dk + out, dkr);
          store_group<kPer>(dv + out, dvr);
        }
        if (!first) {
          float old[kPer];
          load_group<kPer>(dqa + col0, old);
#pragma unroll
          for (int e = 0; e < kPer; ++e) a[e] += old[e];
        }
        store_group<kPer>(dqa + col0, a);
      }
      first = false;
    }
    // Masked slots of this chunk: zero rows.
    const float zeros[kPer] = {};
    for (unsigned b = ~bits & ((1u << cn) - 1u); b; b &= b - 1) {
      const size_t r = seed0 + static_cast<size_t>(c0 + __ffs(b) - 1) * HD;
      for (int gi = lane; gi < HD / kPer; gi += kWarp) {
        store_group<kPer>(dk + r + gi * kPer, zeros);
        store_group<kPer>(dv + r + gi * kPer, zeros);
      }
    }
    __syncwarp();
  }
  for (int gi = lane; gi < HD / kPer; gi += kWarp) {
    float a[kPer];
    load_group<kPer>(dqa + gi * kPer, a);
#pragma unroll
    for (int e = 0; e < kPer; ++e) a[e] *= scale;
    store_group<kPer>(dq + static_cast<size_t>(s) * HD + gi * kPer, a);
  }
}

template <typename T, bool kVec>
int launch(const void* g, const void* q, const void* k, const void* v, const void* mask,
           void* dq, void* dk, void* dv, int S, int K, int H, int D, float scale,
           void* stream) {
  const Plan P = plan(K, H, D, sizeof(T), /*backward=*/true);
  if (P.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ta_bwd_kernel<T, kVec>;
  if (P.block_bytes > kDefaultShared) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(P.block_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (static_cast<long long>(S) + P.warps - 1) / P.warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), P.warps * kWarp, P.block_bytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(mask), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), S, K, H, D, P.chunk, P.warp_bytes, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g, q, dq (S, H, D), k, v, dk, dv (S, K, H, D), all of one type (dtype 0
// float32, 1 bfloat16), mask (S, K) bool as one byte each, all contiguous on
// one device; `vec` as in temporal_attention_fwd (g, q, k and v aligned).
// Writes every element of dq, dk and dv. Launches on `stream` and returns
// cudaGetLastError(). S = 0 launches nothing.
extern "C" int temporal_attention_bwd(const void* g, const void* q, const void* k,
                                      const void* v, const void* mask, void* dq, void* dk,
                                      void* dv, int S, int H, int D, int K, int dtype,
                                      int vec, float scale, void* stream) {
  if (S < 0 || H <= 0 || D <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if (dtype == 0)
    return vec ? launch<float, true>(g, q, k, v, mask, dq, dk, dv, S, K, H, D, scale, stream)
               : launch<float, false>(g, q, k, v, mask, dq, dk, dv, S, K, H, D, scale, stream);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(g, q, k, v, mask, dq, dk, dv, S, K, H, D, scale,
                                             stream)
               : launch<__nv_bfloat16, false>(g, q, k, v, mask, dq, dk, dv, S, K, H, D, scale,
                                              stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* temporal_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
