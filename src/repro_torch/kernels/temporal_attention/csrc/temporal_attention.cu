// Seed -> K-neighbor masked attention over pre-gathered keys and values, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/temporal_attention/kernel.py
// `temporal_attention_kernel` (Pallas body `_temporal_attention_kernel`):
//
//   s[s, h, j] = (q[s, h, :] . k[s, j, h, :]) * scale     (float32)
//   s          = -1e30 where mask[s, j] is false
//   p[s, h, :] = softmax_j(s[s, h, :]),  0 for a seed with no valid slot
//   o[s, h, :] = sum_j p[s, h, j] * v[s, j, h, :],  cast to q's type
//
// for q (S, H, D), k and v (S, K, H, D), mask (S, K), o (S, H, D). It is the
// attention core of the classic (pre-gathered) path: the TGAT and TGN
// layers over a host-sampled neighborhood. The models' `mha` masks with
// -1e9, this kernel with -1e30: for a row with at least one valid slot both
// give the same weights (exp underflows to exactly 0 either way), and a row
// with none is exact zeros in both. Its gradient is
// temporal_attention_bwd.cu (K3b), which shares this file's helpers
// (temporal_attention.cuh).
//
// The TPU kernel tiles 128 seeds into VMEM with K padded to a lane multiple
// and computes the (block, H, K) score tile with the MXU. Here nothing is
// padded: any S (0 too), any K >= 1, any H and D.
//
// What bounds it: each valid slot's key and value row is read once (2 * S *
// K * H * D * 4 bytes when every slot is valid: 35.2 MB at the eval shape
// S = 4,400, K = 10, H = 2, D = 50), against ~4 * D operations per slot and
// head: bytes, about 10.5 us on an H100 with the path's mask.
//
// Design: one warp per seed, covering all H heads, one warp a block (see
// `ta::plan`). A seed's k (and v) rows are H * D contiguous elements per
// slot, so a slot is one contiguous row. The slots go in chunks of up to 16:
// one ballot over the chunk's mask bytes finds its valid slots, and only
// those rows are staged, compacted, into the warp's shared memory: q and the
// key rows as one cp.async group, the value rows as a second, 16 bytes a
// copy, all issued before the first wait (one memory round trip for a
// chunk, and for the whole seed at the path's K = 10). The scores come from
// the staged rows, one lane per (slot, head) pair; the softmax is online
// over chunks per head, with an explicit "no valid slot yet" state (the
// first chunk with a valid slot sets the running maximum, nothing is
// rescaled against the -1e30 sentinel); then each lane takes a group of 4
// (float32) or 8 (bfloat16) adjacent output columns, adds p * v from the
// staged value rows into float32 accumulators in shared memory, and writes
// its group once, 16 bytes at a time. A seed with no valid slot reads
// nothing but its mask row. Where a row (H * D * element size) is not a
// multiple of 16 bytes, or q, k or v is not 16-byte aligned, the same
// kernel stages with plain element loads and takes one column at a time
// (its scalar path, chosen by the wrapper). Arithmetic is float32 whatever
// the storage type (float32 or bfloat16). There are no atomics: a launch's
// bits depend only on its inputs.
//
// Measured on an H100 at 700 W (chip_smoke.py, PERF.md): 14.5 us at S =
// 4,400 and 6.2 us at S = 600; the staging takes most of it.

#include "temporal_attention.cuh"

namespace {

using namespace ta;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
ta_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const unsigned char* __restrict__ mask,
              T* __restrict__ out, int S, int K, int H, int D, int chunk,
              int warp_bytes, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long s = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (s >= S) return;  // whole warps leave; nothing below syncs the block
  const int HD = H * D;
  constexpr int kPer = group_size<T, kVec>();
  const bool wide = D >= kPer;
  const FwdLayout L(chunk, H, HD, sizeof(T));
  unsigned char* base = smem + static_cast<size_t>(warp) * warp_bytes;
  T* ks = reinterpret_cast<T*>(base + L.ks);
  T* vs = reinterpret_cast<T*>(base + L.vs);
  T* qs = reinterpret_cast<T*>(base + L.qs);
  float* sc = reinterpret_cast<float*>(base + L.sc);
  float* mx = reinterpret_cast<float*>(base + L.st);  // running max per head
  float* sum = mx + H;                                // running sum per head
  float* alpha = sum + H;                             // this chunk's rescale
  float* inv = alpha + H;                             // 1 / sum, at the end
  float* acc = reinterpret_cast<float*>(base + L.acc);

  const size_t row0 = static_cast<size_t>(s) * K;
  const unsigned char* mrow = mask + row0;
  const T* kseed = k + row0 * HD;
  const T* vseed = v + row0 * HD;
  T* orow = out + static_cast<size_t>(s) * HD;

  bool seen = false;  // warp-uniform: a valid slot was met in an earlier chunk
  for (int c0 = 0; c0 < K; c0 += chunk) {
    const unsigned bits = chunk_bits(mrow, c0, min(chunk, K - c0), lane);
    if (bits == 0) continue;  // no valid slot here: nothing to read
    const int n = __popc(bits);
    if (!seen) stage_row<T, kVec>(qs, q + static_cast<size_t>(s) * HD, HD, lane);
    stage_rows<T, kVec>(ks, kseed, bits, c0, HD, lane);
    commit<kVec>();
    stage_rows<T, kVec>(vs, vseed, bits, c0, HD, lane);
    commit<kVec>();
    wait_until_one_left<kVec>();  // q and the key rows are here
    __syncwarp();

    // Scores, one lane per (staged row, head).
    for (int p = lane; p < n * H; p += kWarp) {
      const int jj = p / H, h = p - jj * H;
      sc[p] = dot(qs + h * D, ks + static_cast<size_t>(jj) * HD + h * D, D) * scale;
    }
    __syncwarp();
    // The running maximum per head; the first chunk with a valid slot
    // starts it (alpha 0 drops the empty accumulators).
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
    wait_all<kVec>();  // the value rows are here
    __syncwarp();
    for (int h = lane; h < H; h += kWarp) {
      float l = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) l += sc[jj * H + h];
      sum[h] = seen ? alpha[h] * sum[h] + l : l;
    }
    // p * v by column groups: kPer independent sums a lane, one 16-byte
    // (vector path) or element (scalar path) load per staged row.
    for (int gi = lane; gi < HD / kPer; gi += kWarp) {
      const int col0 = gi * kPer;
      const GroupHeads<kPer> heads(col0, D);
      float a[kPer] = {};
      for (int jj = 0; jj < n; ++jj) {
        float x[kPer], p[kPer];
        load_group<kPer>(vs + static_cast<size_t>(jj) * HD + col0, x);
        heads.gather(sc + jj * H, p, wide);
#pragma unroll
        for (int e = 0; e < kPer; ++e) a[e] = fmaf(p[e], x[e], a[e]);
      }
      if (seen) {
        float old[kPer], al[kPer];
        load_group<kPer>(acc + col0, old);
        heads.gather(alpha, al, wide);
#pragma unroll
        for (int e = 0; e < kPer; ++e) a[e] = fmaf(al[e], old[e], a[e]);
      }
      store_group<kPer>(acc + col0, a);
    }
    seen = true;
    __syncwarp();  // the stage and the scores are free for the next chunk
  }

  for (int h = lane; h < H; h += kWarp) inv[h] = 1.f / sum[h];
  __syncwarp();
  for (int gi = lane; gi < HD / kPer; gi += kWarp) {
    const int col0 = gi * kPer;
    float o[kPer] = {};  // no valid slot: zeros
    if (seen) {
      float r[kPer];
      load_group<kPer>(acc + col0, o);
      GroupHeads<kPer>(col0, D).gather(inv, r, wide);
#pragma unroll
      for (int e = 0; e < kPer; ++e) o[e] *= r[e];
    }
    store_group<kPer>(orow + col0, o);
  }
}

template <typename T, bool kVec>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int S, int K, int H, int D, float scale, void* stream) {
  const Plan P = plan(K, H, D, sizeof(T), /*backward=*/false);
  if (P.warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ta_fwd_kernel<T, kVec>;
  if (P.block_bytes > kDefaultShared) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(P.block_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (static_cast<long long>(S) + P.warps - 1) / P.warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), P.warps * kWarp, P.block_bytes,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), S, K, H, D,
      P.chunk, P.warp_bytes, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (S, H, D), k and v (S, K, H, D), out (S, H, D), all of one type (dtype 0
// float32, 1 bfloat16), mask (S, K) bool as one byte each, all contiguous on
// one device; `vec` 1 takes the 16-byte path (the caller checks that H * D *
// element size is a multiple of 16 and that q, k and v are 16-byte aligned),
// 0 the scalar path. Launches on `stream` and returns cudaGetLastError() (0
// when the launch was taken). S = 0 launches nothing.
extern "C" int temporal_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int S, int H,
                                      int D, int K, int dtype, int vec, float scale,
                                      void* stream) {
  if (S < 0 || H <= 0 || D <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if (dtype == 0)
    return vec ? launch<float, true>(q, k, v, mask, out, S, K, H, D, scale, stream)
               : launch<float, false>(q, k, v, mask, out, S, K, H, D, scale, stream);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(q, k, v, mask, out, S, K, H, D, scale, stream)
               : launch<__nv_bfloat16, false>(q, k, v, mask, out, S, K, H, D, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of a call, as `kernel.py::ta_plan` mirrors it: out[0]
// warps (seeds) per block, out[1] slots per chunk, out[2] bytes per copy
// (16 on the vector path, the element size on the scalar path), out[3]
// shared bytes per warp, out[4] shared bytes per block. All 0 when no plan
// fits (a row too wide for one warp's shared memory).
extern "C" void temporal_attention_plan(int K, int H, int D, int dtype, int vec,
                                        int backward, long long* out) {
  const int esize = dtype == 1 ? 2 : 4;
  const ta::Plan P = ta::plan(K, H, D, esize, backward != 0);
  out[0] = P.warps;
  out[1] = P.chunk;
  out[2] = P.warps ? (vec ? 16 : esize) : 0;
  out[3] = P.warp_bytes;
  out[4] = static_cast<long long>(P.block_bytes);
}

extern "C" const char* temporal_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
