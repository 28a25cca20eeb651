// Online-softmax GQA attention (causal with offset, sliding window), forward
// only, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py
// `flash_attention_kernel` (Pallas body `_flash_kernel`):
//
//   s[i, t] = (q[i, :] * scale) . k[t, :]                    (float32)
//   visible: t < Skv, and t <= i + (Skv - Sq) when causal, and
//            t > i + (Skv - Sq) - window when window > 0
//   o[i, :] = sum_t softmax_t(s[i, :])[t] * v[t, :]          (cast to q's type)
//
// for q (B, H, Sq, D) and k, v (B, Hk, Skv, D) with H % Hk == 0 (query head h
// reads kv head h / (H / Hk), the reference's `kv_map`), read through their
// strides, so the model's (B, S, H, D) tensors go in without a transposed
// copy. It is every prefill attention of the LM path (hymba: window 1024,
// D = 64, 25 query over 5 kv heads; qwen3: causal, D = 128, 16 over 8).
//
// The TPU kernel walks every kv block of a q block in a sequential grid axis
// and masks; here a block walks only the kv tiles that the causal bound and
// the window do not wholly exclude: under hymba's window of 1024 a q tile
// at S = 4,096 reads 17 tiles, not up to 64, and at S = 32,768 not up to 512.
//
// What bounds it: about 4 * D operations per visible (query, key) pair (the
// score and its share of the weighted sum); 9.4e10 at hymba's prefill (B =
// 4, S = 4,096, 25 heads, 3.67 M visible pairs per head), against 126 MB of
// q, k, v and o: operations. On the tensor cores (bf16) that is ~0.1 ms; this
// first kernel runs them on the CUDA cores in float32 (67 TFLOP/s at most).
//
// Design, the simple one: one block of 256 threads per (b, h, 64-row q tile).
// The q tile (pre-scaled, float32), one 64-key tile of K and then of V, and
// the 64 x 64 probabilities sit in shared memory (rows padded by 4 floats so
// that the 16-byte reads of one quarter-warp hit distinct banks). Thread
// (rg, cg) = (tid / 16, tid % 16) owns query rows 4 rg .. 4 rg + 3; in the
// scores it owns keys cg + 16 j (j < 4) and reads 4 q rows and 4 k rows as
// float4 per 4 columns (8 shared loads per 64 FMAs); in the output it owns
// columns 4 cg + 64 jj + e. A row's 16 threads are one half-warp, so the
// running maximum is a 4-step xor shuffle (every lane gets the same bits),
// and the sum is reduced once at the end. The running max, sum and the
// output accumulator stay in float32 registers. A masked entry contributes
// exactly 0 (never exp(-1e30 - (-1e30)) = 1), so a tile whose rows are all
// masked after the window cut leaves them unchanged. Inputs are float32 or
// bfloat16 (converted to float32 on load); D is a multiple of 8 up to 128.
// Shared memory is (3 * 64 * (D + 4) + 64 * 4) floats: 52 KB at D = 64, 85 KB
// at D = 128, above the 48 KB static limit, so it is dynamic (opt-in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows and keys per tile
constexpr int kThreads = 256;
constexpr int kLP = kTile + 4;  // padded row of the probability tile
constexpr float kNegInf = -1e30f;

struct Params {
  int B, H, Hk, Sq, Skv, D, causal, window;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
};

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Rows row0 .. row0 + 63 of a (seq, D) slice with row stride `ss` into
// dst[r * ld + c] as float32 times `mul`; rows at or past `rows` are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long ss, int row0, int rows,
                                          int D, int ld, float mul) {
  const int per_row = D / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < rows) load4(base + static_cast<long long>(row0 + r) * ss + c, v);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NJ4: float4 column groups a thread owns in the output (D <= 64 * NJ4).
template <typename T, int NJ4>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ld = p.D + 4;
  float* qs = smem;                 // kTile x ld, pre-scaled q
  float* kv = qs + kTile * ld;      // kTile x ld, the K tile, then the V tile
  float* ps = kv + kTile * ld;      // kTile x kLP, probabilities

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int hk = h / (p.H / p.Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest tiles first
  const int off = p.Skv - p.Sq;
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + hk * p.k_sh;
  const T* vb = v + b * p.v_sb + hk * p.v_sh;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;

  // The kv tiles this q tile can see: [t_beg, t_end).
  const int first = q0 + off;                              // first row's position
  const int last = min(q0 + kTile, p.Sq) - 1 + off;       // last row's position
  const int kend = p.causal ? min(p.Skv, last + 1) : p.Skv;
  const int kbeg = p.window > 0 ? max(0, first - p.window + 1) : 0;
  const int t_beg = kbeg / kTile;
  const int t_end = (kend + kTile - 1) / kTile;

  load_tile(qs, qb, p.q_ss, q0, p.Sq, p.D, ld, p.scale);

  float m[4], l[4], acc[4][4 * NJ4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ4; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's V and probabilities are read
    load_tile(kv, kb, p.k_ss, k0, p.Skv, p.D, ld, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.D; d += 4) {
      float4 qv[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kv + (cg + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kk[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i + off;
      bool allow[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        allow[j] = kpos < p.Skv && (!p.causal || kpos <= qpos) &&
                   (p.window <= 0 || kpos > qpos - p.window);
        if (allow[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < 4 * NJ4; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = allow[j] ? expf(s[i][j] - m_new) : 0.f;
        l[i] += pr;
        ps[(rg * 4 + i) * kLP + cg + 16 * j] = pr;
      }
    }
    __syncthreads();  // the K tile is read
    load_tile(kv, vb, p.v_ss, k0, p.Skv, p.D, ld, 1.f);
    __syncthreads();

    for (int kk = 0; kk < kTile; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rg * 4 + i) * kLP + kk);
#pragma unroll
      for (int jj = 0; jj < NJ4; ++jj) {
        const int col = cg * 4 + 64 * jj;
        if (col < p.D) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 vv = *reinterpret_cast<const float4*>(kv + (kk + e) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
              acc[i][jj * 4 + 0] = fmaf(pe, vv.x, acc[i][jj * 4 + 0]);
              acc[i][jj * 4 + 1] = fmaf(pe, vv.y, acc[i][jj * 4 + 1]);
              acc[i][jj * 4 + 2] = fmaf(pe, vv.z, acc[i][jj * 4 + 2]);
              acc[i][jj * 4 + 3] = fmaf(pe, vv.w, acc[i][jj * 4 + 3]);
            }
          }
        }
      }
    }
  }

  T* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / fmaxf(row_sum16(l[i]), 1e-30f);
    const int row = q0 + rg * 4 + i;
    if (row >= p.Sq) continue;
    T* orow = ob + static_cast<long long>(row) * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < NJ4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 64 * jj + e;
        if (col < p.D) store1(orow + col, acc[i][jj * 4 + e] * inv);
      }
  }
}

template <typename T, int NJ4>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kTile * (p.D + 4) + kTile * kLP);
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_fwd_kernel<T, NJ4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * (2 * kTile * (64 * NJ4 + 4) + kTile * kLP)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + kTile - 1) / kTile);
  flash_attention_fwd_kernel<T, NJ4><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o with element strides (batch, head, sequence) and unit stride
// along D; dtype 0 float32, 1 bfloat16 (all four the same). D a multiple of
// 8 up to 128, every stride a multiple of 8 and every pointer 16-byte
// aligned (the wrapper checks). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Hk,
    int Sq, int Skv, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D > 128 || D % 8 != 0 || (Sq + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, H, Hk, Sq, Skv, D, causal, window,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return D <= 64 ? launch<float, 1>(q, k, v, o, p, s) : launch<float, 2>(q, k, v, o, p, s);
  }
  if (dtype == 1) {
    return D <= 64 ? launch<__nv_bfloat16, 1>(q, k, v, o, p, s)
                   : launch<__nv_bfloat16, 2>(q, k, v, o, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
