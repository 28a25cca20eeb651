// Mamba2 SSD chunk scan with the state carried across chunks, forward only,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk/kernel.py `ssd_chunk_kernel`
// (Pallas body `_ssd_chunk_kernel`), which computes, per head, the
// recurrence
//
//   s_t = exp(dt_t a) s_{t-1} + dt_t x_t (x) B_t,     y_t = s_t C_t,
//
// chunk by chunk: within a chunk y = (C B^T o L) (dt x) + exp(cum) C s_prev
// with L[i, j] = exp(cum_i - cum_j) for i >= j (cum the inclusive sum of
// dt a over the chunk), then s = exp(cum_end) s_prev + sum_j exp(cum_end -
// cum_j) dt_j x_j (x) B_j. The TPU kernel takes one sequence with B and C
// per head and returns y only; the model's mixer (`ssd_mix(return_state=
// True)`) needs more, so this kernel's contract is wider: a batch axis, G
// groups of B and C broadcast to H heads (head h reads group h / (H / G),
// nothing repeated in memory), and the final state as a second output.
//
//   x (B, S, H, P) and Bm, Cm (B, S, G, N): float32 or bfloat16, read
//   through their strides (unit stride along P and N), so the model's views
//   of the conv output go in without copies; dt (B, S, H) and a (H,)
//   float32. Out: y (B, S, H, P) contiguous in x's dtype, final_state (B, H,
//   P, N) float32 contiguous. Steps past S (the last chunk's padding) have
//   dt = 0: decay 1 and no input, so the final state is the state after
//   step S - 1. No initial state (the prefill starts from zeros).
//
// What bounds it: the bytes of x, B, C, dt and y (each read or written
// once) and the state: 214 MB at hymba's prefill (B = 4, S = 4,096, H = 50,
// P = 64, N = 16), about 0.064 ms on an H100, against ~4e9 FMAs of the
// chunked form: close to the line between the two on the CUDA cores.
//
// Design, the simple one: one block of 256 threads per (b, h) walks the
// chunks in order (the TPU grid's sequential axis becomes this loop), with
// the (P, N) float32 state in shared memory. Chunk Q = 32: a warp computes
// the chunk's cumulative decay with shuffles; per chunk the block stages x,
// dt, B and C in shared memory as float32 (rows of B, C and the state padded
// by one float against bank conflicts), forms W[i, j] = (C_i . B_j)
// exp(cum_i - cum_j) dt_j (j <= i), writes y_i = sum_j W[i, j] x_j + exp(cum_i)
// C_i . s_prev, and updates the state, each thread accumulating its 4 x NJ
// entries of it in registers over the chunk's steps. Arithmetic is float32.
// The scores C B^T are recomputed per head, though heads of a group share
// them: a later kernel can compute them once per group. P <= 64 and N <=
// 128; shared memory is ~79 KB at N = 128 (dynamic, opt-in), 21 KB at 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 32;  // chunk length: one warp's lanes
constexpr int kThreads = 256;
constexpr int kMaxP = 64;

struct Params {
  int B, S, H, G, P, N;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
  long long dt_sb, dt_ss, dt_sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

size_t smem_floats(int P, int N) {
  return kQ * P + 2 * kQ * (N + 1) + kQ * (kQ + 1) + P * (N + 1) + 4 * kQ + 1;
}

// NJ: state columns per thread (N <= 16 * NJ).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, T* __restrict__ y,
                     float* __restrict__ state_out, Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, ldn = N + 1;
  float* xs = smem;                 // kQ x P
  float* bs = xs + kQ * P;          // kQ x ldn
  float* cs = bs + kQ * ldn;        // kQ x ldn
  float* w = cs + kQ * ldn;         // kQ x (kQ + 1)
  float* st = w + kQ * (kQ + 1);    // P x ldn, the carried state
  float* dts = st + P * ldn;        // kQ
  float* cum = dts + kQ;            // kQ, inclusive sum of dt a
  float* wk = cum + kQ;             // kQ, exp(cum_end - cum_j) dt_j
  float* ec = wk + kQ;              // kQ, exp(cum_i)
  float* dec_end = ec + kQ;         // 1, exp(cum_end)

  const int b = blockIdx.x / p.H, h = blockIdx.x - (blockIdx.x / p.H) * p.H;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const float ah = a[h];
  const T* xb = x + b * p.x_sb + h * p.x_sh;
  const T* bb = Bm + b * p.b_sb + g * p.b_sg;
  const T* cb = Cm + b * p.c_sb + g * p.c_sg;
  const float* db = dt + b * p.dt_sb + h * p.dt_sh;
  T* yb = y + (static_cast<long long>(b) * p.S * p.H + h) * P;

  for (int i = tid; i < P * ldn; i += kThreads) st[i] = 0.f;
  // State-update ownership: rows pr + 16 i (i < 4), columns nc + 16 j.
  const int pr = tid >> 4, nc = tid & 15;
  // Output ownership: column yp, rows yq + 4 r (r < 8).
  const int yp = tid % kMaxP, yq = tid / kMaxP;

  for (int t0 = 0; t0 < p.S; t0 += kQ) {
    __syncthreads();  // the last chunk's state update has read xs, bs
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, c = i - r * P;
      xs[i] = t0 + r < p.S ? to_f32(xb[(t0 + r) * p.x_ss + c]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, c = i - r * N;
      const bool in = t0 + r < p.S;
      bs[r * ldn + c] = in ? to_f32(bb[(t0 + r) * p.b_ss + c]) : 0.f;
      cs[r * ldn + c] = in ? to_f32(cb[(t0 + r) * p.c_ss + c]) : 0.f;
    }
    if (tid < kQ) {  // warp 0: the chunk's decays
      const float d = t0 + tid < p.S ? db[(t0 + tid) * p.dt_ss] : 0.f;
      float c = d * ah;
#pragma unroll
      for (int o = 1; o < kQ; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, c, o);
        if (tid >= o) c += u;
      }
      const float end = __shfl_sync(0xffffffffu, c, kQ - 1);
      dts[tid] = d;
      cum[tid] = c;
      wk[tid] = expf(end - c) * d;
      ec[tid] = expf(c);
      if (tid == 0) *dec_end = expf(end);
    }
    __syncthreads();

    // W[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0.
    {
      const int j = tid & (kQ - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = (tid >> 5) + 8 * r;
        float s = 0.f;
        if (j <= i) {
          for (int n = 0; n < N; ++n) s = fmaf(cs[i * ldn + n], bs[j * ldn + n], s);
          s *= expf(cum[i] - cum[j]) * dts[j];
        }
        w[i * (kQ + 1) + j] = s;
      }
    }
    __syncthreads();

    // y_i = sum_{j <= i} W[i, j] x_j + exp(cum_i) C_i . s_prev
    if (yp < P) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = yq + 4 * r;
        if (t0 + i >= p.S) continue;
        float yd = 0.f;
        for (int j = 0; j <= i; ++j) yd = fmaf(w[i * (kQ + 1) + j], xs[j * P + yp], yd);
        float yo = 0.f;
        for (int n = 0; n < N; ++n) yo = fmaf(cs[i * ldn + n], st[yp * ldn + n], yo);
        store1(yb + static_cast<long long>(t0 + i) * p.H * P + yp, yd + ec[i] * yo);
      }
    }
    __syncthreads();  // y has read the previous state

    // s = exp(cum_end) s_prev + sum_j (wk_j x_j) (x) B_j
    {
      float acc[4][NJ];
      const float de = *dec_end;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int pp = pr + 16 * i, n = nc + 16 * jn;
          acc[i][jn] = pp < P && n < N ? st[pp * ldn + n] * de : 0.f;
        }
      for (int j = 0; j < kQ; ++j) {
        const float wj = wk[j];
        float u[4], bv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pp = pr + 16 * i;
          u[i] = pp < P ? wj * xs[j * P + pp] : 0.f;
        }
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int n = nc + 16 * jn;
          bv[jn] = n < N ? bs[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jn = 0; jn < NJ; ++jn) acc[i][jn] = fmaf(u[i], bv[jn], acc[i][jn]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int pp = pr + 16 * i, n = nc + 16 * jn;
          if (pp < P && n < N) st[pp * ldn + n] = acc[i][jn];
        }
    }
  }
  __syncthreads();
  float* so = state_out + static_cast<long long>(blockIdx.x) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i - pp * N;
    so[i] = st[pp * ldn + n];
  }
}

template <typename T, int NJ>
int launch(const void* x, const float* dt, const float* a, const void* Bm,
           const void* Cm, void* y, float* state, const Params& p,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.P, p.N);
  static bool attr_set = false;  // the opt-in above 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * smem_floats(kMaxP, 16 * NJ)));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  ssd_chunk_fwd_kernel<T, NJ><<<p.B * p.H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* a, const void* Bm,
             const void* Cm, void* y, float* state, const Params& p,
             cudaStream_t s) {
  if (p.N <= 16) return launch<T, 1>(x, dt, a, Bm, Cm, y, state, p, s);
  if (p.N <= 32) return launch<T, 2>(x, dt, a, Bm, Cm, y, state, p, s);
  if (p.N <= 64) return launch<T, 4>(x, dt, a, Bm, Cm, y, state, p, s);
  return launch<T, 8>(x, dt, a, Bm, Cm, y, state, p, s);
}

}  // namespace

// x (B, S, H, P) with element strides (x_sb, x_ss, x_sh), Bm and Cm (B, S,
// G, N) with strides (b_sb, b_ss, b_sg) and (c_sb, c_ss, c_sg), dt (B, S, H)
// float32 with strides (dt_sb, dt_ss, dt_sh), a (H,) float32 contiguous;
// unit stride along P and N. dtype 0 float32, 1 bfloat16 (x, Bm, Cm and y).
// y (B, S, H, P) and state (B, H, P, N) float32 contiguous. P <= 64, N <=
// 128, H % G == 0, S >= 1. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken).
extern "C" int ssd_chunk_fwd(
    const void* x, const float* dt, const float* a, const void* Bm,
    const void* Cm, void* y, float* state, int B, int S, int H, int G, int P,
    int N, long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long dt_sb, long long dt_ss, long long dt_sh,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, S, H, G, P, N, x_sb, x_ss, x_sh, b_sb, b_ss, b_sg,
                 c_sb, c_ss, c_sg, dt_sb, dt_ss, dt_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = state;
  if (dtype == 0) return dispatch<float>(x, dt, a, Bm, Cm, y, st, p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, dt, a, Bm, Cm, y, st, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
