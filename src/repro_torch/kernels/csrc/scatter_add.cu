// Graph scatter-add for Hopper (sm_90a):  y[n] = sum over e with dst[e] == n
// of vals[e], for 0 <= n < n_nodes.  Edges whose dst lies outside
// [0, n_nodes) (the padding convention dst = -1) contribute nothing.
//
// Replaces: src/repro/stores/graph_kernels.py::scatter_add_pallas, the
// TPU kernel that recasts the scatter as a one-hot matmul because a TPU has
// no fast random scatter.  On Hopper that matmul is O(E * N) work, so this
// kernel is the direct scatter instead: one thread per edge (grid-stride),
// one atomicAdd per edge, then one pass that rounds the sums to float32.
//
// Accuracy: atomics add in a run-dependent order.  A hub node of a
// zipf-skewed hashtag graph takes millions of edges, and a float32 running
// sum of that many terms drifts by ~1e-4 relative from one order to the
// next.  So the sums accumulate in a float64 scratch vector (n_nodes
// doubles), where the order changes the sum by ~1e-10 relative, and are
// rounded to float32 once at the end: the result agrees with any other
// order's to within float32 rounding.
//
// Bound: memory.  It reads dst for every edge and vals for the edges that
// land (8 bytes an edge when all land) and writes 4 bytes a node:
// about 8 E + 4 N bytes over 3.35 TB/s.  The gather x[src] * w that
// produces vals stays outside the kernel, as in the reference.
//
// Known cost: zipf-skewed hashtag graphs send a large share of the edges to
// a few destination nodes, whose atomics serialize in L2.
#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_kernel(const float* __restrict__ vals,
                                   const int* __restrict__ dst,
                                   double* __restrict__ acc,
                                   long long n_edges, int n_nodes) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_edges; e += stride) {
    const int d = __ldg(dst + e);
    if (d >= 0 && d < n_nodes) {
      atomicAdd(acc + d, (double)__ldg(vals + e));
    }
  }
}

__global__ void round_to_f32_kernel(const double* __restrict__ acc,
                                    float* __restrict__ out, long long n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (float)acc[i];
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // 64 blocks per SM
  return (unsigned)blocks;
}

}  // namespace

// acc must hold n_nodes zeros (float64); out receives n_nodes float32 sums.
// Returns cudaGetLastError() after the launches.
extern "C" int scatter_add_f32(const void* vals, const void* dst, void* acc,
                               void* out, long long n_edges, int n_nodes,
                               void* stream) {
  if (n_edges > 0 && n_nodes > 0) {
    const int threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    scatter_add_kernel<<<grid_for(n_edges, threads), threads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(dst),
        static_cast<double*>(acc), n_edges, n_nodes);
    round_to_f32_kernel<<<grid_for(n_nodes, threads), threads, 0, s>>>(
        static_cast<const double*>(acc), static_cast<float*>(out), n_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}
