// Equi-join probe against a small unique-key build side, for Hopper
// (sm_90a): for every probe key lkeys[i], the index j of the valid build
// row with rkeys[j] == lkeys[i] and a match flag.  Invalid build rows
// (rvalid[j] == 0) never match; unmatched probe rows report index 0.
//
// Replaces: src/repro/stores/masked_kernels.py::join_probe_pallas, the TPU
// kernel that compares a block of probe keys against the whole build side
// as a (probe x build) equality one-hot and reduces it on the MXU -- O(P *
// NR) work that the MXU hides and Hopper's CUDA cores would not.  Here each
// block first builds an open-addressing hash table of the valid build rows
// in shared memory (linear probing, at most half full: NR <= 4096 rows,
// 8192 slots of key + row index = 64 KB), then its threads probe one key
// each (grid-stride) in O(1) expected steps.
//
// The build side's keys are unique among its valid rows (the planner's
// contract for this realization): a key is inserted once, so whichever
// thread wins a slot, the probe finds the one row with that key.
//
// Bound: memory.  Each probe key is read once and its index and flag
// written (4 + 4 + 1 bytes); the build side (4 + 1 bytes a row) is read
// once per block from L2: 9 P + 5 NR bytes over 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuild = 4096;
constexpr int kMaxSlots = 2 * kMaxBuild;

__device__ __forceinline__ unsigned slot_of(int key, unsigned mask) {
  return ((unsigned)key * 2654435761u) & mask;  // Knuth's multiplicative hash
}

__global__ void join_probe_kernel(const int* __restrict__ lkeys,
                                  const int* __restrict__ rkeys,
                                  const unsigned char* __restrict__ rvalid,
                                  int* __restrict__ idx_out,
                                  unsigned char* __restrict__ matched_out,
                                  long long n_probe, int n_build,
                                  int n_slots) {
  extern __shared__ int smem[];
  int* skey = smem;             // n_slots keys
  int* srow = smem + n_slots;   // n_slots build rows, -1 = empty
  const unsigned mask = (unsigned)n_slots - 1u;

  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) srow[s] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < n_build; j += blockDim.x) {
    if (__ldg(rvalid + j) == 0) continue;
    const int key = __ldg(rkeys + j);
    unsigned s = slot_of(key, mask);
    // claim the first empty slot; the key is written by its claimant and
    // read only after the barrier below
    while (atomicCAS(srow + s, -1, j) != -1) s = (s + 1u) & mask;
    skey[s] = key;
  }
  __syncthreads();

  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_probe; i += stride) {
    const int key = __ldg(lkeys + i);
    unsigned s = slot_of(key, mask);
    int found = -1;
    for (;;) {
      const int row = srow[s];
      if (row < 0) break;
      if (skey[s] == key) {
        found = row;
        break;
      }
      s = (s + 1u) & mask;
    }
    idx_out[i] = found < 0 ? 0 : found;
    matched_out[i] = found < 0 ? 0 : 1;
  }
}

}  // namespace

// n_build must lie in [1, 4096].  idx_out receives n_probe int32 indices,
// matched_out n_probe bytes (torch.bool).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a build side out of range).
extern "C" int join_probe_i32(const void* lkeys, const void* rkeys,
                              const void* rvalid, void* idx_out,
                              void* matched_out, long long n_probe,
                              int n_build, void* stream) {
  if (n_build < 1 || n_build > kMaxBuild) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_probe > 0) {
    int n_slots = 32;
    while (n_slots < 2 * n_build) n_slots *= 2;
    const size_t smem = 2 * sizeof(int) * (size_t)n_slots;
    static bool smem_raised = false;  // once per process; idempotent
    if (!smem_raised) {
      cudaFuncSetAttribute(join_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(2 * sizeof(int) * kMaxSlots));
      smem_raised = true;
    }
    const int threads = 256;
    long long blocks = (n_probe + threads - 1) / threads;
    if (blocks > 132LL * 4) blocks = 132LL * 4;  // each block builds a table
    join_probe_kernel<<<(unsigned)blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lkeys), static_cast<const int*>(rkeys),
        static_cast<const unsigned char*>(rvalid),
        static_cast<int*>(idx_out),
        static_cast<unsigned char*>(matched_out), n_probe, n_build,
        n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
