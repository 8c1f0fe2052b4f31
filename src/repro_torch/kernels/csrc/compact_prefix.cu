// Prefix compaction for Hopper (sm_90a): C stacked value rows of R entries,
//   out[c, pos[i]] = vals[c, i]   for every row i with keep[i] > 0 and
//                                  0 <= pos[i] < out_capacity,
// where pos is the exclusive valid-prefix sum computed outside.  Rows whose
// slot is at or past out_capacity are dropped (compact's overflow); slots
// no row lands on keep the zeros the caller filled ``out`` with.
//
// Replaces: src/repro/stores/masked_kernels.py::compact_prefix_pallas, the
// TPU kernel that scatters through a (rows x slots) destination one-hot
// matmul and skips row blocks whose keep weights are all zero.  On Hopper
// that product is O(R * cap) work, so this kernel scatters directly: one
// thread per row (grid-stride) reads keep[i] and, only for a kept row that
// fits, reads pos[i] and copies the row's C values.  The TPU's block skip
// becomes a per-row skip.
//
// Exactness: values move as 32-bit words, never through arithmetic, so
// every float (sign of zero and NaN payloads included) and every int32
// viewed as a word arrives bitwise unchanged.
//
// Bound: memory.  keep is read for every row (4 bytes); a kept row reads
// its pos and its C values (4 + 4 C bytes); the output is written once
// (4 C bytes a slot): 4 R + 4 R_kept + 4 C R_kept + 4 C cap bytes over
// 3.35 TB/s.  Loads of one column are coalesced across neighbouring rows;
// stores are coalesced where neighbouring rows are all kept.
#include <cuda_runtime.h>

namespace {

__global__ void compact_prefix_kernel(const unsigned* __restrict__ vals,
                                      const int* __restrict__ pos,
                                      const float* __restrict__ keep,
                                      unsigned* __restrict__ out, int n_cols,
                                      long long n_rows, long long cap) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    if (!(__ldg(keep + i) > 0.0f)) continue;
    const long long j = __ldg(pos + i);
    if (j < 0 || j >= cap) continue;
    for (int c = 0; c < n_cols; ++c) {
      out[c * cap + j] = __ldg(vals + c * n_rows + i);
    }
  }
}

unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // 64 blocks per SM
  return (unsigned)blocks;
}

}  // namespace

// vals: (n_cols, n_rows) 32-bit words, row-major; pos: n_rows int32; keep:
// n_rows float32; out: (n_cols, cap) 32-bit words, pre-filled by the
// caller.  Returns cudaGetLastError() after the launch.
extern "C" int compact_prefix_u32(const void* vals, const void* pos,
                                  const void* keep, void* out, int n_cols,
                                  long long n_rows, long long cap,
                                  void* stream) {
  if (n_rows > 0 && cap > 0 && n_cols > 0) {
    const int threads = 256;
    compact_prefix_kernel<<<grid_for(n_rows, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned*>(vals), static_cast<const int*>(pos),
        static_cast<const float*>(keep), static_cast<unsigned*>(out), n_cols,
        n_rows, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
