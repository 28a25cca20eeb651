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
// Design: a block of 8 warps owns a tile of TG segments x 32 columns of the
// output as float accumulators in shared memory (at most 16 KB); the wrapper
// sizes the tiles (kernel.py `segment_tiles`) for about four blocks per SM,
// since a snapshot's ids crowd the low segments (the users): the first tile
// holds most of a snapshot's ids, the id-0 run of node 0 and the padding
// among them. Lane l of every warp owns column d0 + l; warp w owns the
// tile's segments g with g % 8 == w.
//   1. Compact. The block reads the E ids once, coalesced, 2,048 at a time
//      (8 per thread), and keeps the edges whose id falls in its tile: a warp
//      ballot, __popc and a block-wide exclusive scan of the 64 warp counts
//      place each kept edge at its rank, so the list keeps the edge order.
//      A block then walks about E / (number of tiles) listed edges, not E
//      (the kernel before this one had every thread of every block walk all
//      E ids: 24 us at the hourly shape, 167 at the daily on an H100).
//   2. Sum, 128 listed edges (a stage) at a time. The stage's 32 columns of
//      its rows come into registers by unguarded loads, all in flight at
//      once, while the stage before is summed, and then into shared memory.
//      Each warp picks out its own edges of the stage by ballot, in order,
//      and walks only those: a run of edges into one segment adds in a
//      register started from the accumulator and parked there when the run
//      ends; 16 edges that all continue the current run (the padding run)
//      take a path of adds only. So each output element is one thread's
//      float sum in edge order: no atomics, the same bits on every run, and
//      the order of the CPU's index_add_.
//   3. Write. Every element of the tile, the zeros of empty segments
//      included, is written once, with 16-byte stores (the tile is a
//      contiguous run of the output when D <= 32; rows of 32 columns else).
// The busiest tile's walk sets the time: its run is one dependent add per
// edge, the stages' loads and barriers one warp's latency each (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                // columns of a tile: a warp's lanes
constexpr int kAcc = 4096;               // accumulators per block: 16 KB
constexpr int kIds = 2048;               // ids compacted per round
constexpr int kRounds = kIds / kThreads; // ids per thread per round
constexpr int kStage = 128;              // listed edges whose rows are staged at once
constexpr int kUnroll = 16;
constexpr int kPerThread = kStage * kCols / kThreads;  // staged values a thread loads

// Columns d0 .. d0 + 31 of the rows of listed edges s0 .. s0 + m - 1 into
// registers, thread t holding value t + 256 u of the (m, 32) block (zeros
// past m and past D); the loads are unguarded, so all of them are in flight.
__device__ __forceinline__ void load_rows(float* staged, const float* __restrict__ data,
                                          const int* edge, int s0, int m, int D, int d0) {
  const int lane = threadIdx.x & 31;
  const int col = min(d0 + lane, D - 1);  // (threadIdx.x + 256 u) % 32 == lane
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const float got = data[static_cast<size_t>(edge[s0 + min(i / kCols, m - 1)]) * D + col];
    staged[u] = i < m * kCols && d0 + lane < D ? got : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                   float* __restrict__ out, int E, int D, int G, int TG) {
  __shared__ __align__(16) float acc[kAcc];
  __shared__ float rows[kStage * kCols];
  __shared__ int edge[kIds];     // the list: edge index ...
  __shared__ short local[kIds];  // ... and its segment within the tile
  __shared__ unsigned char mine[kWarps][kStage];  // each warp's entries of a stage
  __shared__ int rank[kRounds * kWarps];
  __shared__ int listed;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g0 = blockIdx.x * TG;
  const int g_end = min(G, g0 + TG);
  const int d0 = blockIdx.y * kCols;

  for (int i = tid; i < TG * kCols; i += kThreads) acc[i] = 0.f;
  int cur = -1;     // the segment (tile-local) of this warp's current run
  float run = 0.f;  // its running sum (column d0 + lane), started from acc
  for (int base = 0; base < E; base += kIds) {
    // 1. Compact this round's ids: edge base + r * 256 + tid is the r-th id
    // of thread tid, so (r, warp, lane) order is edge order.
    int id[kRounds];
    unsigned keep[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {  // unguarded loads, so all are in flight
      const int e = base + r * kThreads + tid;
      const int got = seg[min(e, E - 1)];
      id[r] = e < E ? got : -1;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      keep[r] = __ballot_sync(0xffffffffu, id[r] >= g0 && id[r] < g_end);
      if (lane == 0) rank[r * kWarps + warp] = __popc(keep[r]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 64 counts, two per lane
      const int a = rank[2 * lane], b = rank[2 * lane + 1];
      int x = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      rank[2 * lane] = x - a - b;
      rank[2 * lane + 1] = x - b;
      if (lane == 31) listed = x;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if ((keep[r] >> lane) & 1u) {
        const int pos = rank[r * kWarps + warp] + __popc(keep[r] & ((1u << lane) - 1u));
        edge[pos] = base + r * kThreads + tid;
        local[pos] = static_cast<short>(id[r] - g0);
      }
    }
    __syncthreads();
    const int n = listed;

    // 2. Sum over the list, kStage edges at a time; a stage's rows are
    // loaded into registers while the stage before it is walked.
    float staged[kPerThread];
    if (n > 0) load_rows(staged, data, edge, 0, min(kStage, n), D, d0);
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int m = min(kStage, n - s0);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u)
        if (tid + u * kThreads < m * kCols) rows[tid + u * kThreads] = staged[u];
      // This warp's entries of the stage (segments = warp mod 8), in order.
      int own = 0;
      for (int k0 = 0; k0 < m; k0 += 32) {
        const int k = k0 + lane;
        const unsigned sel = __ballot_sync(
            0xffffffffu, k < m && (local[s0 + min(k, m - 1)] & (kWarps - 1)) == warp);
        if ((sel >> lane) & 1u)
          mine[warp][own + __popc(sel & ((1u << lane) - 1u))] = static_cast<unsigned char>(k);
        own += __popc(sel);
      }
      __syncthreads();  // the staged rows (and each warp's list) are in place
      if (s0 + kStage < n)
        load_rows(staged, data, edge, s0 + kStage, min(kStage, n - s0 - kStage), D, d0);
      for (int i = 0; i < own; i += kUnroll) {
        int gl[kUnroll];
        float v[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {  // the loads first, all of them
          const int k = mine[warp][min(i + j, own - 1)];
          gl[j] = local[s0 + k];
          v[j] = rows[k * kCols + lane];
        }
        bool same = i + kUnroll <= own;
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) same = same && gl[j] == cur;
        if (same) {
          // The current run goes on through all kUnroll edges: adds only
          // (a snapshot's padding run takes this path).
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) run += v[j];
        } else {
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {  // the adds, in edge order
            if (i + j >= own) break;
            if (gl[j] != cur) {  // a new run: park the last one
              if (cur >= 0) acc[cur * kCols + lane] = run;
              cur = gl[j];
              run = acc[cur * kCols + lane];
            }
            run += v[j];
          }
        }
      }
      __syncthreads();  // the staged rows and the lists are read
    }
  }
  if (cur >= 0) acc[cur * kCols + lane] = run;
  __syncthreads();

  // 3. Write the whole tile.
  const int rows_out = g_end - g0;
  if (D <= kCols) {
    // The tile is rows_out * D contiguous floats from g0 * D, which is
    // 16-byte aligned (TG is a multiple of 4).
    float* dst = out + static_cast<size_t>(g0) * D;
    const int total = rows_out * D;
    const int n4 = total / 4;
    for (int i = tid; i < n4; i += kThreads) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 4 * i + e;
        const int r = f / D;
        v[e] = acc[r * kCols + f - r * D];
      }
      reinterpret_cast<float4*>(dst)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int f = 4 * n4 + tid; f < total; f += kThreads) {
      const int r = f / D;
      dst[f] = acc[r * kCols + f - r * D];
    }
  } else if (D % 4 == 0) {  // rows of 32 columns, 16 bytes at a time
    constexpr int per_row = kCols / 4;
    for (int i = tid; i < rows_out * per_row; i += kThreads) {
      const int r = i / per_row;
      const int cc = (i - r * per_row) * 4;
      if (d0 + cc < D) {
        const float* a = acc + r * kCols + cc;
        *reinterpret_cast<float4*>(out + static_cast<size_t>(g0 + r) * D + d0 + cc) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  } else {
    for (int i = tid; i < rows_out * kCols; i += kThreads) {
      const int r = i / kCols;
      const int cc = i - r * kCols;
      if (d0 + cc < D) out[static_cast<size_t>(g0 + r) * D + d0 + cc] = acc[r * kCols + cc];
    }
  }
}

}  // namespace

// data (E, D) float32, seg (E,) int32, out (G, D) float32, all contiguous on
// one device; TG segments per block (the wrapper's `segment_tiles`: a
// positive multiple of 4, at most 128). Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was taken). E may be 0: the output is
// then all zeros.
extern "C" int segment_sum(const float* data, const int* seg, float* out,
                           int E, int D, int G, int TG, void* stream) {
  if (E < 0 || D <= 0 || G <= 0 || TG <= 0 || TG % 4 || TG * kCols > kAcc)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((G + TG - 1) / TG, (D + kCols - 1) / kCols);
  segment_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, seg, out, E, D, G, TG);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
