// Graph scatter-add for Hopper (sm_90a):  y[n] = sum over e with dst[e] == n
// of vals[e], for 0 <= n < n_nodes.  Edges whose dst lies outside
// [0, n_nodes) (the padding convention dst = -1) contribute nothing.
//
// Replaces: src/repro/stores/graph_kernels.py::scatter_add_pallas, the
// TPU kernel that recasts the scatter as a one-hot matmul because a TPU has
// no fast random scatter.  On Hopper that matmul is O(E * N) work, so this
// kernel is a direct scatter.
//
// Design: run reduction before the atomic.  A zipf-skewed hashtag graph
// sends a fifth of its edges to one node, and float64 atomics on one
// address serialize in L2 (~2.6 ns each), so one atomic per edge costs the
// hub's in-degree times that, whatever the bandwidth.  Here a block of 256
// threads takes a tile of 2048 consecutive edges, 8 per thread (16-byte
// vector loads of dst and vals where both pointers are 16-byte aligned,
// scalar loads elsewhere and in the last, partial tile).  Each thread sums
// its runs of equal dst in float64 registers; a segmented scan across the
// block (warp shuffles, then the eight warp totals through shared memory;
// a head flag wherever dst changes) carries a run that crosses thread and
// warp boundaries to the thread where it ends.  Each run in a tile then
// costs one float64 atomicAdd; runs whose dst is out of range are dropped.
//
// Any edge order is right.  The graph payload hands the kernel its
// dst-ordered edge copy (a stable sort by dst), where equal dst are
// adjacent: the atomics of a launch come to at most N + tiles (a hub's
// 3.6M edges become ~1,800), and dst and vals are read once, in order.  On
// unordered input every edge is its own run, and the kernel degrades to one
// atomic per edge, as a plain scatter does.
//
// Accuracy: atomics add in a run-dependent order.  A float32 running sum of
// millions of terms would drift by ~1e-4 relative from one order to the
// next, so the sums accumulate in a float64 scratch vector (n_nodes
// doubles) and are rounded to float32 once at the end, by a second pass:
// the result agrees with any other order's to within float32 rounding.
//
// Bound: memory.  It reads dst for every edge and vals for the edges that
// land (8 bytes an edge when all land) and writes 4 bytes a node:
// about 8 E + 4 N bytes over 3.35 TB/s.  The gather x[src] * w that
// produces vals stays outside the kernel, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // edges a thread
constexpr int kTile = kThreads * kItems;  // edges a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// An element of the segmented sum: f = a run starts inside the span; s =
// the sum from the span's last run start to its end (all of it when f = 0).
struct Seg {
  int f;
  double s;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {  // a, then b
  return {a.f | b.f, b.f ? b.s : a.s + b.s};
}

__device__ __forceinline__ Seg shfl_up(Seg x, int delta) {
  return {__shfl_up_sync(kFull, x.f, delta),
          __shfl_up_sync(kFull, x.s, delta)};
}

__device__ __forceinline__ void add_run(double* acc, int key, double sum,
                                        int n_nodes) {
  if ((unsigned)key < (unsigned)n_nodes) atomicAdd(acc + key, sum);
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
    scatter_runs_kernel(const float* __restrict__ vals,
                        const int* __restrict__ dst,
                        double* __restrict__ acc, long long n_edges,
                        int n_nodes) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile0 = (long long)blockIdx.x * kTile;
  const long long first = tile0 + (long long)tid * kItems;

  // this thread's edges; past the end: key -1 (dropped), value 0
  int k[kItems];
  double v[kItems];
  if (kVector && tile0 + kTile <= n_edges) {
    const int4* d4 = reinterpret_cast<const int4*>(dst + first);
    const float4* v4 = reinterpret_cast<const float4*>(vals + first);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 dk = __ldg(d4 + q);
      const float4 dv = __ldg(v4 + q);
      k[4 * q] = dk.x;
      k[4 * q + 1] = dk.y;
      k[4 * q + 2] = dk.z;
      k[4 * q + 3] = dk.w;
      v[4 * q] = dv.x;
      v[4 * q + 1] = dv.y;
      v[4 * q + 2] = dv.z;
      v[4 * q + 3] = dv.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = first + j < n_edges;
      k[j] = in ? __ldg(dst + first + j) : -1;
      v[j] = in ? (double)__ldg(vals + first + j) : 0.0;
    }
  }

  // the key before this thread's first edge: the previous lane's last key,
  // or a load at a warp's first lane; the tile's first edge starts a run
  int prev = __shfl_up_sync(kFull, k[kItems - 1], 1);
  if (lane == 0 && tid > 0) {
    prev = first - 1 < n_edges ? __ldg(dst + first - 1) : -1;
  }
  const bool head0 = tid == 0 || k[0] != prev;

  // the thread's own segmented sum
  Seg agg = {head0 ? 1 : 0, v[0]};
#pragma unroll
  for (int j = 1; j < kItems; ++j) {
    if (k[j] != k[j - 1]) {
      agg.f = 1;
      agg.s = v[j];
    } else {
      agg.s += v[j];
    }
  }

  // block-wide exclusive segmented scan: within the warp by shuffles, then
  // across the warps' totals in shared memory
  __shared__ Seg warp_total[kWarps];
  Seg inc = agg;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Seg up = shfl_up(inc, o);
    if (lane >= o) inc = combine(up, inc);
  }
  if (lane == 31) warp_total[warp] = inc;
  Seg excl = shfl_up(inc, 1);
  if (lane == 0) excl = {0, 0.0};
  __syncthreads();
  Seg before = {0, 0.0};
  for (int w = 0; w < warp; ++w) before = combine(before, warp_total[w]);
  // the sum of the run that is open where this thread starts
  const double carry = combine(before, excl).s;

  // one atomic per run that ends in this thread: at each run start the run
  // before it is complete; the tile's last thread adds its open run
  int key = prev;
  double run = carry;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool head = j == 0 ? head0 : k[j] != k[j - 1];
    if (head) {
      if (j > 0 || tid > 0) add_run(acc, key, run, n_nodes);
      key = k[j];
      run = 0.0;
    }
    run += v[j];
  }
  if (tid == kThreads - 1) add_run(acc, key, run, n_nodes);
}

__global__ void round_to_f32_kernel(const double* __restrict__ acc,
                                    float* __restrict__ out, long long n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (float)acc[i];
  }
}

}  // namespace

// acc must hold n_nodes zeros (float64); out receives n_nodes float32 sums.
// Returns cudaGetLastError() after the launches.
extern "C" int scatter_add_f32(const void* vals, const void* dst, void* acc,
                               void* out, long long n_edges, int n_nodes,
                               void* stream) {
  if (n_edges > 0 && n_nodes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned tiles = (unsigned)((n_edges + kTile - 1) / kTile);
    const bool vector = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(dst) % 16 == 0;
    const float* v = static_cast<const float*>(vals);
    const int* d = static_cast<const int*>(dst);
    double* a = static_cast<double*>(acc);
    if (vector) {
      scatter_runs_kernel<true><<<tiles, kThreads, 0, s>>>(v, d, a, n_edges,
                                                           n_nodes);
    } else {
      scatter_runs_kernel<false><<<tiles, kThreads, 0, s>>>(v, d, a, n_edges,
                                                            n_nodes);
    }
    long long blocks = ((long long)n_nodes + kThreads - 1) / kThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // 64 blocks per SM
    round_to_f32_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        a, static_cast<float*>(out), n_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}
