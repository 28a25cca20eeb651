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
// with none is exact zeros in both.
//
// The TPU kernel tiles 128 seeds into VMEM with K padded to a lane multiple
// and computes the (block, H, K) score tile with the MXU. Here nothing is
// padded: any S (0 too), any K >= 1, any D.
//
// What bounds it: each valid slot's key and value row is read once (2 * S *
// K * H * D * 4 bytes when every slot is valid: 35.2 MB at the eval shape
// S = 4,400, K = 10, H = 2, D = 50), against ~4 * D operations per slot and
// head: bytes, about 11 us on an H100.
//
// Design, the simple one: one warp per (seed, head). The lanes split D
// (lane d, d + 32, ...), so a key or value row is read by consecutive lanes
// from consecutive addresses. For each valid slot the lanes' partial dot
// products are summed by xor shuffles; the warp keeps the K scores in its
// slice of shared memory (the running maximum is the same on every lane,
// since an xor-shuffle sum gives every lane the same bits), turns them into
// the softmax weights (the sum reduced by shuffles, exp in float32), and then each lane sums its columns
// of p_j * v_j over the valid slots and writes its output elements once.
// Masked slots read neither k nor v. Arithmetic is float32 whatever the
// storage type (float32 or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void temporal_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ mask, T* __restrict__ out, int S, int H,
    int D, int K, float scale) {
  extern __shared__ float scores[];  // K floats per warp
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long pair = static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (pair >= static_cast<long long>(S) * H) return;  // whole warps leave
  const int s = static_cast<int>(pair / H);
  const int h = static_cast<int>(pair - static_cast<long long>(s) * H);
  float* sc = scores + static_cast<size_t>(warp) * K;

  const size_t HD = static_cast<size_t>(H) * D;
  const T* qrow = q + static_cast<size_t>(s) * HD + static_cast<size_t>(h) * D;
  const unsigned char* mrow = mask + static_cast<size_t>(s) * K;
  const size_t slot0 = static_cast<size_t>(s) * K * HD + static_cast<size_t>(h) * D;

  // Scores of the valid slots; the running maximum on every lane.
  float m = kNegInf;
  bool any = false;
  for (int j = 0; j < K; ++j) {
    float sj = kNegInf;
    if (mrow[j]) {
      const T* krow = k + slot0 + static_cast<size_t>(j) * HD;
      float part = 0.f;
      for (int d = lane; d < D; d += kWarp) part += to_f32(qrow[d]) * to_f32(krow[d]);
      sj = warp_sum(part) * scale;
      m = fmaxf(m, sj);
      any = true;
    }
    if (lane == 0) sc[j] = sj;
  }
  T* orow = out + static_cast<size_t>(s) * HD + static_cast<size_t>(h) * D;
  if (!any) {  // no valid neighbor: exact zeros
    for (int d = lane; d < D; d += kWarp) orow[d] = from_f32<T>(0.f);
    return;
  }
  __syncwarp();

  // Softmax weights: e_j = exp(s_j - m) (exactly 0 on masked slots), then
  // p_j = e_j / sum_j e_j, written back over the scores.
  float l = 0.f;
  for (int j = lane; j < K; j += kWarp) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    l += e;
  }
  l = warp_sum(l);
  __syncwarp();
  for (int j = lane; j < K; j += kWarp) sc[j] = sc[j] / l;
  __syncwarp();

  for (int d = lane; d < D; d += kWarp) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      if (mrow[j]) acc += sc[j] * to_f32(v[slot0 + static_cast<size_t>(j) * HD + d]);
    }
    orow[d] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int S, int H, int D, int K, float scale, void* stream) {
  // As many warps per block as fit the scores in 48 KB of shared memory
  // (8 at the path's K = 10); above that, one warp and the opt-in limit.
  int warps = kMaxWarps;
  while (warps > 1 && static_cast<size_t>(warps) * K * sizeof(float) > 48 * 1024) warps >>= 1;
  const size_t smem = static_cast<size_t>(warps) * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        temporal_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long pairs = static_cast<long long>(S) * H;
  const long long blocks = (pairs + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  temporal_attention_kernel<T>
      <<<static_cast<unsigned>(blocks), warps * kWarp, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const unsigned char*>(mask),
          static_cast<T*>(out), S, H, D, K, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (S, H, D), k and v (S, K, H, D), out (S, H, D), all of one type (dtype 0
// float32, 1 bfloat16), mask (S, K) bool as one byte each, all contiguous on
// one device; launches on `stream` and returns cudaGetLastError() (0 when
// the launch was taken). S = 0 launches nothing. K is limited only by the
// shared memory of one warp's scores (58,112 slots).
extern "C" int temporal_attention_fwd(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int S, int H,
                                      int D, int K, int dtype, float scale,
                                      void* stream) {
  if (S < 0 || H <= 0 || D <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  if (dtype == 0) return launch<float>(q, k, v, mask, out, S, H, D, K, scale, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, mask, out, S, H, D, K, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* temporal_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
