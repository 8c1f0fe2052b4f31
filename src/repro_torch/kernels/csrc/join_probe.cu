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
// 8192 slots of key + row index = 64 KB), then its threads probe in O(1)
// expected steps.
//
// Grid sizing: the work is sized to the probe side.  A thread takes one
// probe key (a warp's loads and stores are contiguous, so coalesced) and
// loads it before its block builds the table, so the two loads from device
// memory overlap.  The grid is ceil(P / 256) blocks, capped at the blocks
// the SMs hold at once at this table size (the occupancy calculator's
// count times the SM count); a capped grid strides over the keys.
// Measured against that: several keys a thread with 16-byte loads, a cap
// of one table for every NR probe keys, and a block's build rows loaded
// all at once were each slower on the card.  The probe is bound by
// latency, not bytes (its bytes take half a microsecond at the full
// rate), and fewer threads in flight hide less of it.
//
// The build side's keys are unique among its valid rows (the planner's
// contract for this realization): a key is inserted once, so whichever
// thread wins a slot, the probe finds the one row with that key.
//
// Bound: memory.  Each probe key is read once and its index and flag
// written (4 + 4 + 1 bytes); the build side (4 + 1 bytes a row) is read
// once per block from L2: 9 P + 5 NR bytes over 3.35 TB/s.  At the path's
// 200,000 keys that is well under a microsecond, below a launch's latency.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuild = 4096;
constexpr int kMaxSlots = 2 * kMaxBuild;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned slot_of(int key, unsigned mask) {
  return ((unsigned)key * 2654435761u) & mask;  // Knuth's multiplicative hash
}

// the build row holding ``key``, or -1
__device__ __forceinline__ int lookup(const int* skey, const int* srow,
                                      unsigned mask, int key) {
  unsigned s = slot_of(key, mask);
  for (;;) {
    const int row = srow[s];
    if (row < 0) return -1;
    if (skey[s] == key) return row;
    s = (s + 1u) & mask;
  }
}

__global__ void __launch_bounds__(kThreads)
    join_probe_kernel(const int* __restrict__ lkeys,
                      const int* __restrict__ rkeys,
                      const unsigned char* __restrict__ rvalid,
                      int* __restrict__ idx_out,
                      unsigned char* __restrict__ matched_out,
                      long long n_probe, int n_build, int n_slots) {
  extern __shared__ int smem[];
  int* skey = smem;             // n_slots keys
  int* srow = smem + n_slots;   // n_slots build rows, -1 = empty
  const unsigned mask = (unsigned)n_slots - 1u;

  // the first probe key is loaded before the table is built, so the two
  // loads from device memory overlap
  const long long step = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  int key = i < n_probe ? __ldg(lkeys + i) : 0;

  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) srow[s] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < n_build; j += blockDim.x) {
    if (__ldg(rvalid + j) == 0) continue;
    const int k = __ldg(rkeys + j);
    unsigned s = slot_of(k, mask);
    // claim the first empty slot; the key is written by its claimant and
    // read only after the barrier below
    while (atomicCAS(srow + s, -1, j) != -1) s = (s + 1u) & mask;
    skey[s] = k;
  }
  __syncthreads();

  for (; i < n_probe; i += step) {
    const int found = lookup(skey, srow, mask, key);
    idx_out[i] = found < 0 ? 0 : found;
    matched_out[i] = found < 0 ? 0 : 1;
    if (i + step < n_probe) key = __ldg(lkeys + i + step);
  }
}

// blocks an SM holds at once, by table size (index: log2 of the slots);
// computed at a size's first launch
int blocks_per_sm[14] = {0};
int sm_count = 0;

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
    int n_slots = 32, log2_slots = 5;
    while (n_slots < 2 * n_build) {
      n_slots *= 2;
      ++log2_slots;
    }
    const size_t smem = 2 * sizeof(int) * (size_t)n_slots;
    if (sm_count == 0) {  // once per process; idempotent
      cudaFuncSetAttribute(join_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)(2 * sizeof(int) * kMaxSlots));
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    }
    int& per_sm = blocks_per_sm[log2_slots];
    if (per_sm == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, join_probe_kernel, kThreads, smem);
      if (per_sm < 1) per_sm = 1;
    }
    // a thread a probe key, at most the blocks the SMs hold at once
    long long blocks = (n_probe + kThreads - 1) / kThreads;
    if (blocks > (long long)sm_count * per_sm) {
      blocks = (long long)sm_count * per_sm;
    }
    join_probe_kernel<<<(unsigned)blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lkeys), static_cast<const int*>(rkeys),
        static_cast<const unsigned char*>(rvalid),
        static_cast<int*>(idx_out),
        static_cast<unsigned char*>(matched_out), n_probe, n_build,
        n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
