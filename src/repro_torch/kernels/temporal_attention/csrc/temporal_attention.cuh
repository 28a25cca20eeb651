// Shared pieces of K3 (temporal_attention.cu) and its gradient K3b
// (temporal_attention_bwd.cu): the launch plan, each warp's shared-memory
// layout, the staging of a seed's valid slot rows and the type helpers.
//
// Both kernels run one warp per seed over all heads. A seed's slots go in
// chunks of up to kMaxChunk; a chunk's valid key and value rows are staged,
// compacted, in the warp's part of shared memory. `plan` sizes the chunk
// and the warps per block from that layout; kernel.py::ta_plan mirrors it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ta {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kMaxChunk = 16;                   // slots staged at once (<= 32: one ballot)
constexpr size_t kDefaultShared = 48 * 1024;    // a block's shared bytes without opt-in
constexpr size_t kMaxShared = 232448;           // the opt-in limit (227 KB)

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// One warp's shared memory in the forward: the staged key and value rows of
// a chunk (storage type), q, the chunk's scores (float32, per staged row and
// head), four floats per head of softmax state, the output accumulators.
struct FwdLayout {
  size_t ks, vs, qs, sc, st, acc, bytes;
  __host__ __device__ FwdLayout(int chunk, int H, int HD, int esize) {
    const size_t rows = align16(static_cast<size_t>(chunk) * HD * esize);
    ks = 0;
    vs = rows;
    qs = 2 * rows;
    sc = qs + align16(static_cast<size_t>(HD) * esize);
    st = sc + align16(static_cast<size_t>(chunk) * H * 4);
    acc = st + align16(static_cast<size_t>(4) * H * 4);
    bytes = acc + align16(static_cast<size_t>(HD) * 4);
  }
};

// The backward's: the forward's rows, q and the cotangent g, the chunk's
// scores and dp (then p and ds), the softmax state, dq's accumulators.
struct BwdLayout {
  size_t ks, vs, qs, gs, sc, dp, st, dq, bytes;
  __host__ __device__ BwdLayout(int chunk, int H, int HD, int esize) {
    const size_t rows = align16(static_cast<size_t>(chunk) * HD * esize);
    const size_t row = align16(static_cast<size_t>(HD) * esize);
    const size_t pairs = align16(static_cast<size_t>(chunk) * H * 4);
    ks = 0;
    vs = rows;
    qs = 2 * rows;
    gs = qs + row;
    sc = gs + row;
    dp = sc + pairs;
    st = dp + pairs;
    dq = st + align16(static_cast<size_t>(4) * H * 4);
    bytes = dq + align16(static_cast<size_t>(HD) * 4);
  }
};

struct Plan {
  int warps;           // seeds per block (0: no plan fits)
  int chunk;           // slots per stage
  int warp_bytes;      // shared bytes per warp
  size_t block_bytes;  // shared bytes per block
};

// The chunk is min(K, kMaxChunk), halved while one warp's layout exceeds
// the opt-in limit. The forward runs one warp (seed) per block: on an H100
// one-warp blocks ran K3 faster at the eval shape (S = 4,400) than 2-5
// warps a block, since a block holds its shared memory until its slowest
// seed is done, and no slower at S = 600. The backward, which showed no
// such gain, takes the most warps (up to kMaxWarps) that keep the block
// within the default 48 KB, else one warp with the opt-in.
inline Plan plan(int K, int H, int D, int esize, bool backward) {
  const int HD = H * D;
  auto bytes = [&](int c) {
    return backward ? BwdLayout(c, H, HD, esize).bytes : FwdLayout(c, H, HD, esize).bytes;
  };
  int chunk = K < kMaxChunk ? K : kMaxChunk;
  while (chunk > 1 && bytes(chunk) > kMaxShared) chunk /= 2;
  const size_t per = bytes(chunk);
  if (per > kMaxShared) return Plan{0, 0, 0, 0};
  int warps = backward ? kMaxWarps : 1;
  while (warps > 1 && warps * per > kDefaultShared) --warps;
  return Plan{warps, chunk, static_cast<int>(per), warps * per};
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// The valid slots among mask[c0 .. c0 + cn) as bits (bit i: slot c0 + i).
__device__ __forceinline__ unsigned chunk_bits(const unsigned char* mrow, int c0, int cn,
                                               int lane) {
  return __ballot_sync(0xffffffffu, lane < cn && mrow[c0 + lane] != 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
// cp.async groups (the scalar path copies synchronously: no-ops there).
template <bool kVec>
__device__ __forceinline__ void commit() {
  if (kVec) asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <bool kVec>
__device__ __forceinline__ void wait_until_one_left() {
  if (kVec) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
template <bool kVec>
__device__ __forceinline__ void wait_all() {
  if (kVec) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One row of HD elements into shared memory: 16-byte cp.async copies on the
// vector path (the row and both pointers 16-byte aligned), element loads on
// the scalar path.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int HD, int lane) {
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    for (int x = lane * kPer; x < HD; x += kWarp * kPer) cp_async16(dst + x, src + x);
  } else {
#pragma unroll 4
    for (int x = lane; x < HD; x += kWarp) dst[x] = src[x];
  }
}

// The rows of the valid slots in `bits` (relative to slot c0) of one seed's
// (K, HD) block, compacted into dst in slot order.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(T* dst, const T* seed, unsigned bits, int c0,
                                           int HD, int lane) {
  for (int jj = 0; bits; bits &= bits - 1, ++jj) {
    const int j = c0 + __ffs(bits) - 1;
    stage_row<T, kVec>(dst + static_cast<size_t>(jj) * HD, seed + static_cast<size_t>(j) * HD,
                       HD, lane);
  }
}

// 8 bytes of a row as floats: two float32 or four bfloat16.
__device__ __forceinline__ void unpack8(uint2 u, const float*, float* x) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
}
__device__ __forceinline__ void unpack8(uint2 u, const __nv_bfloat16*, float* x) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// a . b over D elements of shared memory in float32 (four partial sums);
// 8-byte loads where D * sizeof(T) is a multiple of 8 (both pointers are
// then 8-byte aligned: rows start 16-byte aligned, heads D elements apart).
template <typename T>
__device__ __forceinline__ float dot(const T* a, const T* b, int D) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int d = 0;
  if ((D * sizeof(T)) % 8 == 0) {
    constexpr int kP = 8 / sizeof(T);
    for (; d + 2 * kP <= D; d += 2 * kP) {
      float x[2 * kP], y[2 * kP];
      unpack8(*reinterpret_cast<const uint2*>(a + d), a, x);
      unpack8(*reinterpret_cast<const uint2*>(a + d + kP), a, x + kP);
      unpack8(*reinterpret_cast<const uint2*>(b + d), b, y);
      unpack8(*reinterpret_cast<const uint2*>(b + d + kP), b, y + kP);
#pragma unroll
      for (int e = 0; e < 2 * kP; e += 4) {
        s0 = fmaf(x[e], y[e], s0);
        s1 = fmaf(x[e + 1], y[e + 1], s1);
        s2 = fmaf(x[e + 2], y[e + 2], s2);
        s3 = fmaf(x[e + 3], y[e + 3], s3);
      }
    }
  } else {
    for (; d + 4 <= D; d += 4) {
      s0 = fmaf(to_f32(a[d]), to_f32(b[d]), s0);
      s1 = fmaf(to_f32(a[d + 1]), to_f32(b[d + 1]), s1);
      s2 = fmaf(to_f32(a[d + 2]), to_f32(b[d + 2]), s2);
      s3 = fmaf(to_f32(a[d + 3]), to_f32(b[d + 3]), s3);
    }
  }
  for (; d < D; ++d) s0 = fmaf(to_f32(a[d]), to_f32(b[d]), s0);
  return (s0 + s1) + (s2 + s3);
}

// The output columns go in groups of kPer contiguous elements, one group
// per lane at a time: 16 bytes on the vector path (4 float32 or 8
// bfloat16), one element on the scalar path.
template <typename T, bool kVec>
__host__ __device__ constexpr int group_size() {
  return kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// kPer elements of a row (storage type) as floats, and back.
template <int kPer>
__device__ __forceinline__ void load_group(const float* src, float (&x)[kPer]) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kPer; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + e);
      x[e] = v.x;
      x[e + 1] = v.y;
      x[e + 2] = v.z;
      x[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e] = src[e];
  }
}
template <int kPer>
__device__ __forceinline__ void load_group(const __nv_bfloat16* src, float (&x)[kPer]) {
  if constexpr (kPer == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) x[e] = __bfloat162float(src[e]);
  }
}
template <int kPer>
__device__ __forceinline__ void store_group(float* dst, const float (&x)[kPer]) {
  if constexpr (kPer % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kPer; e += 4)
      *reinterpret_cast<float4*>(dst + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[e] = x[e];
  }
}
template <int kPer>
__device__ __forceinline__ void store_group(__nv_bfloat16* dst, const float (&x)[kPer]) {
  if constexpr (kPer == 8) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);  // RNE, as torch
      w[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[e] = __float2bfloat16(x[e]);
  }
}

// The head of each element of the group of columns col0 .. col0 + kPer
// (one division), and a gather of one float per head (a row of scores, say)
// onto them. A group spans at most two heads when D >= kPer (`wide`): the
// first and last heads' values are loaded once and selected; a narrower D
// loads per element.
template <int kPer>
struct GroupHeads {
  int he[kPer];
  __device__ __forceinline__ GroupHeads(int col0, int D) {
    int h = col0 / D, r = col0 - h * D;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      he[e] = h;
      if (++r == D) {
        r = 0;
        ++h;
      }
    }
  }
  __device__ __forceinline__ void gather(const float* per_head, float (&x)[kPer],
                                         bool wide) const {
    if (wide) {
      const float first = per_head[he[0]], last = per_head[he[kPer - 1]];
#pragma unroll
      for (int e = 0; e < kPer; ++e) x[e] = he[e] == he[0] ? first : last;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) x[e] = per_head[he[e]];
    }
  }
};

}  // namespace ta
