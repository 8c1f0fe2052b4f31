// Mask-weighted group-by for Hopper (sm_90a): in one pass over the rows,
//   sums[g]   = sum over rows r with keys[r] == g of vals[r] * mw[r]
//   counts[g] = sum over rows r with keys[r] == g of mw[r]
// for 0 <= g < n_groups.  Keys outside [0, n_groups) (padding key -1) match
// nothing.
//
// Replaces: src/repro/stores/masked_kernels.py::masked_segment_agg_pallas,
// the TPU kernel that builds a one-hot (rows x groups) tile per block, runs
// two matmuls over it, and skips row blocks whose mask is all zero.  On
// Hopper the one-hot product is O(R * G) work, so this kernel scatters
// directly: one thread per row (grid-stride), two atomicAdds per row, then
// one pass that rounds the sums to float32.  The TPU block skip becomes a
// per-row skip: a row with mw == 0 reads neither its key nor its value and
// adds nothing.
//
// Accuracy: atomics add in a run-dependent order, and zipf(1.3) keys put
// about a quarter of the rows on one group, so a float32 running sum would
// drift by ~1e-4 relative from one order to the next.  The sums accumulate
// in float64 scratch (2 * n_groups doubles) and are rounded once at the
// end.  Counts of 0/1 weights are exact in any order.
//
// Bound: memory.  mw is read for every row (4 bytes), key and value only
// for rows with mw != 0 (8 bytes), and the two outputs are written once
// (8 bytes a group): 4 R + 8 R_active + 8 G bytes over 3.35 TB/s.
//
// Known cost: the hot group's atomics serialize in L2.
#include <cuda_runtime.h>

namespace {

__global__ void masked_segment_agg_kernel(const float* __restrict__ vals,
                                          const int* __restrict__ keys,
                                          const float* __restrict__ mw,
                                          double* __restrict__ sums,
                                          double* __restrict__ counts,
                                          long long n_rows, int n_groups) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rows; r += stride) {
    const float w = __ldg(mw + r);
    if (w == 0.0f) continue;
    const int k = __ldg(keys + r);
    if (k < 0 || k >= n_groups) continue;
    atomicAdd(sums + k, (double)(__ldg(vals + r) * w));
    atomicAdd(counts + k, (double)w);
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

// acc must hold 2 * n_groups zeros (float64: sums, then counts); out
// receives the same 2 * n_groups values as float32.  Returns
// cudaGetLastError() after the launches.
extern "C" int masked_segment_agg_f32(const void* vals, const void* keys,
                                      const void* mw, void* acc, void* out,
                                      long long n_rows, int n_groups,
                                      void* stream) {
  if (n_rows > 0 && n_groups > 0) {
    const int threads = 256;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    double* sums = static_cast<double*>(acc);
    masked_segment_agg_kernel<<<grid_for(n_rows, threads), threads, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(keys),
        static_cast<const float*>(mw), sums, sums + n_groups, n_rows,
        n_groups);
    round_to_f32_kernel<<<grid_for(2LL * n_groups, threads), threads, 0,
                          s>>>(sums, static_cast<float*>(out),
                               2LL * n_groups);
  }
  return static_cast<int>(cudaGetLastError());
}
