// Pieces shared by the fused temporal layer's forward
// (fused_temporal_layer.cu) and backward (fused_temporal_layer_bwd.cu):
// the weight rows of the two bias groups seen as one (X, H*D) matrix, the
// per-seed projections through it and back, the staging of a chunk of
// slots, and a warp sum.
//
// X = d_time + d_edge: a slot's features x_j = [phi_j ; e_j], with
// phi_j[i] = cos(theta_ji), theta_ji = dt_j * time_w[i] + time_b[i], and
// e_j the edge-feature row of the slot (zero where eid = -1).
//
// Every kernel here loads what its block needs into shared memory at once
// and then computes from there: one wait for memory per block (per chunk
// of slots), not one per slot or per 16-deep step.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace ftl {

// Row i of the stacked weight [w_time ; w_edge] (X rows of `ld` floats):
// rows below `split` (= d_time) come from `a`, the rest from `b`.
struct Rows {
  const float* a;
  const float* b;
  int split;
  int ld;
  __device__ __forceinline__ const float* row(int i) const {
    return i < split ? a + static_cast<size_t>(i) * ld
                     : b + static_cast<size_t>(i - split) * ld;
  }
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round4(int a) { return (a + 3) & ~3; }
__host__ __device__ inline int round32(int a) { return (a + 31) & ~31; }

// 4-byte copies into shared memory that do not wait (zero fill where
// `valid` is false; `src` must still be a readable address), then one wait
// for all of them.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One warp copies n floats of a row (zeros where !valid), 16 bytes a lane
// when both ends are 16-byte aligned and n is a multiple of 4.
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n, bool valid,
                                         int lane) {
  if ((n & 3) == 0 &&
      ((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0) {
    for (int c = 4 * lane; c < n; c += 128) cp_async16(dst + c, src + c, valid);
  } else {
    for (int c = lane; c < n; c += 32) cp_async4(dst + c, src + c, valid);
  }
}

// ---- per-seed projections -------------------------------------------------
// A block holds one head's (X, D) weight block in shared memory and runs
// tiles of kTileSeeds seeds through it, tile after tile (the weight stream
// shared by every seed the block takes). The grid has at most one block per
// SM and head, so large S shares each loaded weight block among many tiles.
constexpr int kTileSeeds = 8;
constexpr int kBackSplit = 4;  // back-projection: the X sum in 4 parts

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
    return 132;
  return n;
}

// Blocks per head of the projections for S seeds.
inline int proj_blocks(int S) {
  const int tiles = ceil_div(S, kTileSeeds);
  const int n = sm_count();
  return tiles < n ? tiles : n;
}

inline int proj_threads(int X) {
  const int t = round32(X);
  return t < 32 ? 32 : (t > 512 ? 512 : t);
}

inline size_t proj_smem(int X, int D) {
  return sizeof(float) * (static_cast<size_t>(round4(X * (D | 1))) + D * kTileSeeds);
}

// dst[s, h, i] = mul * sum_d src[s, h, d] W[i, h D + d] for every seed and
// i < X, tiles blockIdx.x, blockIdx.x + gridDim.x, ... Thread i holds a
// tile's kTileSeeds sums; the weight rows sit at an odd stride (no bank
// conflicts across i), the tile's seeds d-major so that four seeds are one
// float4 read.
__device__ __forceinline__ void project_tiles(const float* __restrict__ src, Rows w,
                                              float* __restrict__ dst, float mul, int S,
                                              int H, int D, int X, int h, float* smem) {
  constexpr int T = kTileSeeds;
  const int HD = H * D;
  const int DP = D | 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* ws = smem;                    // X x DP
  float* qs = smem + round4(X * DP);   // D x T
  for (int i = warp; i < X; i += nw) {
    const float* r = w.row(i) + h * D;
    for (int d = lane; d < D; d += 32) cp_async4(ws + i * DP + d, r + d, true);
  }
  const int tiles = ceil_div(S, T);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * T;
    for (int t = warp; t < T; t += nw) {
      const int s = s0 + t;
      const float* r = src + static_cast<size_t>(s < S ? s : s0) * HD + h * D;
      for (int d = lane; d < D; d += 32) cp_async4(qs + d * T + t, r + d, s < S);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < X; i += blockDim.x) {
      float acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = 0.f;
      const float* wr = ws + i * DP;
      for (int d = 0; d < D; ++d) {
        const float wv = wr[d];
        const float4 a = *reinterpret_cast<const float4*>(qs + d * T);
        const float4 b = *reinterpret_cast<const float4*>(qs + d * T + 4);
        acc[0] = fmaf(a.x, wv, acc[0]);
        acc[1] = fmaf(a.y, wv, acc[1]);
        acc[2] = fmaf(a.z, wv, acc[2]);
        acc[3] = fmaf(a.w, wv, acc[3]);
        acc[4] = fmaf(b.x, wv, acc[4]);
        acc[5] = fmaf(b.y, wv, acc[5]);
        acc[6] = fmaf(b.z, wv, acc[6]);
        acc[7] = fmaf(b.w, wv, acc[7]);
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (s0 + t < S) dst[(static_cast<size_t>(s0 + t) * H + h) * X + i] = acc[t] * mul;
      }
    }
    __syncthreads();
  }
}

inline int back_threads(int D) {
  const int t = round32(D * (kTileSeeds / 4) * kBackSplit);
  return t > 1024 ? 1024 : t;
}

inline size_t back_smem(int X, int D) {
  return sizeof(float) * (static_cast<size_t>(round4(X * D)) + static_cast<size_t>(X) * kTileSeeds +
                          static_cast<size_t>(kBackSplit) * kTileSeeds * D);
}

// out[s, h, d] = fma(mul, sum_i Z[s, h, i] W[i, h D + d], out[s, h, d]) for
// every seed, tiles as in project_tiles. Thread (d, g, k) sums seeds 4 g ..
// 4 g + 3 over the k-th quarter of i; the quarters add in order.
__device__ __forceinline__ void back_project_tiles(const float* __restrict__ Z, Rows w,
                                                   float* __restrict__ out, float mul, int S,
                                                   int H, int D, int X, int h, float* smem) {
  constexpr int T = kTileSeeds;
  constexpr int G = T / 4;
  const int HD = H * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* ws = smem;                   // X x D
  float* zs = ws + round4(X * D);     // X x T
  float* red = zs + X * T;            // kBackSplit x T x D
  for (int i = warp; i < X; i += nw) {
    const float* r = w.row(i) + h * D;
    for (int d = lane; d < D; d += 32) cp_async4(ws + i * D + d, r + d, true);
  }
  const int span = ceil_div(X, kBackSplit);
  const int tiles = ceil_div(S, T);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * T;
    for (int t = warp; t < T; t += nw) {
      const int s = s0 + t;
      const float* r = Z + (static_cast<size_t>(s < S ? s : s0) * H + h) * X;
      for (int i = lane; i < X; i += 32) cp_async4(zs + i * T + t, r + i, s < S);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int task = threadIdx.x; task < D * G * kBackSplit; task += blockDim.x) {
      const int k = task / (D * G);
      const int g = (task / D) % G;
      const int d = task % D;
      const int i1 = min(X, (k + 1) * span);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int i = k * span; i < i1; ++i) {
        const float wv = ws[i * D + d];
        const float4 z = *reinterpret_cast<const float4*>(zs + i * T + 4 * g);
        a0 = fmaf(z.x, wv, a0);
        a1 = fmaf(z.y, wv, a1);
        a2 = fmaf(z.z, wv, a2);
        a3 = fmaf(z.w, wv, a3);
      }
      float* r = red + (k * T + 4 * g) * D + d;
      r[0] = a0;
      r[D] = a1;
      r[2 * D] = a2;
      r[3 * D] = a3;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
      const int t = e / D;
      const int d = e - t * D;
      const int s = s0 + t;
      if (s >= S) continue;
      float acc = 0.f;
      for (int k = 0; k < kBackSplit; ++k) acc += red[k * T * D + e];
      float* o = out + static_cast<size_t>(s) * HD + h * D + d;
      *o = fmaf(mul, acc, *o);
    }
    __syncthreads();
  }
}

// ---- slots ----------------------------------------------------------------
// The slot passes run one block of kSlotThreads per seed and take the
// seed's slots kSlotChunk at a time: every row of a chunk is staged in
// shared memory at once (cp.async, zero fill for masked slots and eid -1),
// the Bochner encodings computed beside the copies, then the block works
// from shared memory.
constexpr int kSlotThreads = 128;
constexpr int kSlotBlocksPerSM = 6;  // register cap: every S = 600 seed block resident at once
constexpr int kSlotChunk = 16;

__host__ __device__ inline int slot_chunk(int K) { return K < kSlotChunk ? (K < 1 ? 1 : K) : kSlotChunk; }

// The whole block copies n floats (zeros where !valid), 16 bytes a thread
// when both ends are 16-byte aligned and n is a multiple of 4.
__device__ __forceinline__ void copy_block(float* dst, const float* src, int n, bool valid = true) {
  if ((n & 3) == 0 &&
      ((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0) {
    for (int c = 4 * threadIdx.x; c < n; c += 4 * blockDim.x) cp_async16(dst + c, src + c, valid);
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) cp_async4(dst + c, src + c, valid);
  }
}

// theta = dt * w + b rounded per operation (no fused multiply-add), with
// dt the int32 difference of the seed's and the slot's times (wrapping, as
// in the plain versions), then cast.
__device__ __forceinline__ float slot_dt(unsigned t_seed, int t_slot) {
  return static_cast<float>(static_cast<int>(t_seed - static_cast<unsigned>(t_slot)));
}

__device__ __forceinline__ float theta(float dt, float w, float b) {
  return __fadd_rn(__fmul_rn(dt, w), b);
}

// Stage slots j0 .. j0 + n - 1 of the row: ks / vs (n rows of HD, at a
// stride of round4(HD)) the table rows, xs (n x X) the features; with `sn`
// (n x d_time) also sin(theta). A warp copies a slot's rows; masked slots
// get zero rows. The caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void stage_slots(const int* row, int j0, int n,
                                            const float* __restrict__ k_tab,
                                            const float* __restrict__ v_tab,
                                            const float* __restrict__ edge_feats,
                                            const float* tw, const float* tb,
                                            unsigned t_s, int HD, int d_time, int d_edge,
                                            float* ks, float* vs, float* xs, float* sn) {
  const int X = d_time + d_edge;
  const int HS = round4(HD);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n; j += blockDim.x >> 5) {
    const int* r = row + 3 * (j0 + j);
    const bool ok = r[0] >= 0;
    const size_t off = static_cast<size_t>(ok ? r[0] : 0) * HD;
    copy_row(ks + j * HS, k_tab + off, HD, ok, lane);
    copy_row(vs + j * HS, v_tab + off, HD, ok, lane);
    if (d_edge) {
      const bool ok_e = ok && r[2] >= 0;
      copy_row(xs + j * X + d_time, edge_feats + static_cast<size_t>(ok_e ? r[2] : 0) * d_edge,
               d_edge, ok_e, lane);
    }
  }
  for (int idx = threadIdx.x; idx < n * d_time; idx += blockDim.x) {
    const int j = idx / d_time;
    const int i = idx - j * d_time;
    const int* r = row + 3 * (j0 + j);
    float cv = 0.f, sv = 0.f;
    if (r[0] >= 0) {
      const float th = theta(slot_dt(t_s, r[1]), tw[i], tb[i]);
      if (sn != nullptr) {
        sincosf(th, &sv, &cv);
      } else {
        cv = cosf(th);
      }
    }
    xs[j * X + i] = cv;
    if (sn != nullptr) sn[idx] = sv;
  }
}

// sum_k p[k * stride] for k < n, added in order k = 0, 1, ...; the loads
// go out eight at a time (an L2 round trip per eight terms, not per term).
__device__ __forceinline__ float ordered_sum(const float* p, size_t stride, int n) {
  float t = 0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = k0 + u < n ? __ldcg(p + (k0 + u) * stride) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (k0 + u < n) t += v[u];
    }
  }
  return t;
}

// Sum over the warp; every lane gets the same bits (xor butterfly).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Max over the warp (every lane gets it).
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the warp in lane order (lane 0 + lane 1 + ... + lane 31, as a
// loop over the slots would add them), returned to every lane.
__device__ __forceinline__ float warp_sum_ordered(float v) {
  float t = 0.f;
  for (int l = 0; l < 32; ++l) t += __shfl_sync(0xffffffffu, v, l);
  return t;
}

// Head h's dot of a staged slot: u[h] . x + a[h] . r[h] (the first over X
// features, the second over the head's D columns of HD), on one warp.
__device__ __forceinline__ float slot_dot(const float* u, const float* x, const float* a,
                                          const float* r, int h, int D, int X, int lane) {
  float part = 0.f;
  for (int i = lane; i < X; i += 32) part = fmaf(u[h * X + i], x[i], part);
  for (int c = h * D + lane; c < (h + 1) * D; c += 32) part = fmaf(a[c], r[c], part);
  return warp_sum(part);
}

}  // namespace ftl
