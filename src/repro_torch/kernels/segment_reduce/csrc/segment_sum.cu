// Segment sum over an edge list, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/segment_reduce/kernel.py
// `segment_sum_kernel` (Pallas body `_segment_sum_kernel`):
//
//   out[g, :] = sum of data[e, :] over the edges e with seg[e] == g,
//
// for g in [0, G); an id outside [0, G) (the padding id -1) is dropped. The
// ids come in any order and may all be equal: the GCN layer passes a
// snapshot's raw src/dst columns, whose padding edges carry id 0 and weight 0.
//
// The TPU kernel multiplies a (G, block_e) one-hot by each edge block on the
// MXU and keeps the whole (G, D) output resident in VMEM over a sequential
// walk of the edge blocks (ops.py tiles G above 2,048 for VMEM). Blocks here
// run in parallel and in no order, so that accumulator cannot be shared.
//
// What bounds it: each input byte read once (E*D*4 + E*4) and each output
// written once (G*D*4). At the snapshot shapes the output dominates (G =
// 9,000 nodes, D = 64: 2.3 MB against 65 KB of edge rows), and E*D adds are
// nothing: the bound is bytes, about 0.7 us on an H100, below the cost of
// a launch.
//
// Design, the simple deterministic one: a block owns a tile of TG segments x
// C columns of the output as float accumulators in shared memory (16 KB).
// Thread t owns column c = t % C and the segments g0 + l + k*L of the tile
// (l = t / C, L = 256 / C lanes). The block stages the ids and their rows'
// C columns through shared memory, 128 edges at a time (the row loads are
// coalesced and many are in flight), and every thread walks the staged ids
// in edge order, adding the row's value when the id is one of its segments.
// A run of edges into the same segment adds in a register that starts from
// the accumulator and is stored back when the run ends: a snapshot's padding
// is one long run into segment 0, which would otherwise chain one dependent
// memory access per edge. So each output element is one thread's float sum
// in edge order: no atomics, the same bits on every run, and the order of
// the CPU's index_add_. Every element of the tile, the zeros of empty
// segments included, is then written once. C is 32 when D >= 32 (a warp stages one
// 128-byte piece of an edge row), else the least power of two >= D, so the
// degree sums (D = 1) still use the whole block, as 256 lanes.
//
// Every thread walks all E ids, and that walk sets the time: about 24 us at
// E = 256 and 167 us at E = 2,048 on an H100 (chip_smoke.py), far above the
// bound. Compacting each block's ids first (one test per id per block), or
// sorting a snapshot's ids once for all the sums that reuse them, is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 4096;    // accumulators per block: 16 KB
constexpr int kChunk = 128;   // edges staged per round: ids and C columns
constexpr int kMaxC = 32;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                   float* __restrict__ out, int E, int D, int G, int C) {
  __shared__ float acc[kAcc];
  __shared__ int ids[kChunk];
  __shared__ float rows[kChunk * kMaxC];
  const int tid = threadIdx.x;
  const int lanes = kThreads / C;   // a power of two
  const int tg = kAcc / C;          // segments in this block's tile
  const int g0 = blockIdx.x * tg;
  const int d0 = blockIdx.y * C;
  const int c = tid % C;
  const int lane = tid / C;
  const bool live = d0 + c < D;

  for (int i = tid; i < kAcc; i += kThreads) acc[i] = 0.f;
  int cur = -1;     // the segment (tile-local) of the current run
  float run = 0.f;  // its running sum, started from the accumulator
  for (int base = 0; base < E; base += kChunk) {
    const int n = min(kChunk, E - base);
    __syncthreads();  // the zeros are in place and the last chunk is read
    for (int i = tid; i < n; i += kThreads) ids[i] = seg[base + i];
    for (int i = tid; i < n * C; i += kThreads) {
      const int e = i / C;
      const int cc = i - e * C;
      rows[i] = d0 + cc < D ? data[static_cast<size_t>(base + e) * D + d0 + cc]
                            : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; i += kUnroll) {
      int g[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // independent loads first
        const int k = min(i + j, n - 1);
        g[j] = i + j < n ? ids[k] : -1;
        v[j] = rows[k * C + c];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // then the adds, in edge order
        const int gl = g[j] - g0;
        if (gl >= 0 && gl < tg && g[j] < G && (gl & (lanes - 1)) == lane) {
          if (gl != cur) {
            if (cur >= 0) acc[cur * C + c] = run;
            cur = gl;
            run = acc[gl * C + c];
          }
          run += v[j];
        }
      }
    }
  }
  if (live && cur >= 0) acc[cur * C + c] = run;
  __syncthreads();

  const int rows_out = min(tg, G - g0);
  for (int i = tid; i < rows_out * C; i += kThreads) {
    const int r = i / C;
    const int cc = i - r * C;
    if (d0 + cc < D) {
      out[static_cast<size_t>(g0 + r) * D + d0 + cc] = acc[r * C + cc];
    }
  }
}

}  // namespace

// data (E, D) float32, seg (E,) int32, out (G, D) float32, all contiguous on
// one device; launches on `stream` and returns cudaGetLastError() (0 when
// the launch was taken). E may be 0: the output is then all zeros.
extern "C" int segment_sum(const float* data, const int* seg, float* out,
                           int E, int D, int G, void* stream) {
  if (E < 0 || D <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int C = 1;
  while (C < D && C < kMaxC) C <<= 1;
  const int tg = kAcc / C;
  const dim3 grid((G + tg - 1) / tg, (D + C - 1) / C);
  segment_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, seg, out, E, D, G, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
