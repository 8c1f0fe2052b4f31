// Mask-weighted group-by for Hopper (sm_90a): in one pass over the rows,
//   sums[g]   = sum over rows r with keys[r] == g of vals[r] * mw[r]
//   counts[g] = sum over rows r with keys[r] == g of mw[r]
// for 0 <= g < n_groups.  Keys outside [0, n_groups) (padding key -1) match
// nothing.  A row with mw == 0 reads neither its key nor its value and adds
// nothing: the TPU kernel's skip of all-zero mask blocks, taken per row.
//
// Replaces: src/repro/stores/masked_kernels.py::masked_segment_agg_pallas,
// the TPU kernel that builds a one-hot (rows x groups) tile per block and
// runs two matmuls over it.  On Hopper that product is O(R * G) work, so
// this kernel scatters, and reduces on chip before it scatters.
//
// Why not one atomic a row.  The tweet table's keys are zipf(1.3): one
// group holds a quarter of the active rows (~730,000 at 10M rows), the next
// a tenth.  float64 atomics on one address serialize in L2, so one thread a
// row with two global atomics took ~1.77 ms a call on an H100 at 10M rows,
// ~1 % of the byte bound.  The graph scatter removes the same contention by
// summing runs of equal keys in a key-ordered copy of its edges; that does
// not carry over: the group-by follows a filter whose mask is in table row
// order, the table is not ordered by key, and re-ordering vals, keys and mw
// for each call would cost more gathers than the kernel.  So the reduction
// happens in the SM, on the rows in the order they lie.
//
// Design.
//  * Tiles: the rows are streamed once, each CTA a contiguous range of
//    4-row quads, its threads on neighbouring quads: one 16-byte load of mw
//    a quad, and the key and the value (4 bytes each) only of rows with
//    mw != 0, loaded a quad ahead of their use (mw two ahead).  mw's
//    first 0-3 rows, up to its first 16-byte boundary, and the 0-3 rows
//    past its last whole quad go to warp 0 of CTA 0 as single rows, so any
//    view (vals[1:]) and any R is taken as it is.
//  * Warp queue: each warp appends its active, in-range rows (key, vals *
//    mw, mw) to a queue in shared memory (a ballot and a prefix count per
//    row of a quad) and takes them off 32 at a time, so every round of the
//    steps below has all 32 lanes busy; at 29 % active rows a warp's 128
//    rows make about one round, where one round a row of the quad would
//    make four.  The rest (< 32) waits for the next quad; the last partial
//    round goes at the end.
//  * Warp reduction: a round's lanes meet in __match_any_sync on the key;
//    the lowest lane of each set of equal keys gathers its peers' (sum,
//    count) through shuffles, in float64, and carries the set on alone.
//  * CTA table: a private table in shared memory, kSlots = 4096 slots of
//    (key, float64 sum, float64 count), 80 KB, open-addressed: a Fibonacci
//    hash of the key (the top 12 bits of key * 0x9E3779B1) and linear
//    probing bounded at kProbe = 16 slots.  A lane takes the first slot that
//    holds its key or, by atomicCAS, the first empty one, and adds its pair
//    there with two shared float64 atomics.  Slots are never freed within a
//    CTA, so a key has one slot or none.  Table and the 16 warps' queues
//    (160 entries of 12 bytes each) take 110 KB: two CTAs of 512 threads
//    an SM, which the registers (60 a thread) allow too.
//  * Spill: a key that meets kProbe slots of other keys goes straight to
//    the global float64 atomics, for this row and every later one of the
//    CTA.  No row is dropped or clamped; a table that overflows costs what
//    the old kernel cost, one atomic pair a row, for the overflowing keys
//    (uniform keys over 4M groups spill most rows).
//  * Flush: after the CTA's rows, each occupied slot adds its pair to the
//    global float64 scratch with one atomicAdd each.  The hot group's
//    ~730,000 global atomic pairs become one a CTA.  What is left is about
//    one pair per distinct key and CTA, issued when every CTA ends, and the
//    zipf tail meets most of its keys in one CTA or few: fewer, larger
//    CTAs and tables cut it, which is why a CTA has 512 threads.
//  * Grid: one CTA per kMinQuadsPerThread * kThreads quads, capped at the
//    CTAs the card holds at once (the occupancy API times the SM count), so
//    a call with few rows (the pushdown plan's 200,000) launches few CTAs,
//    and no CTA initialises and flushes a table it does not need.
//  * Nothing depends on the key layout: the table is keyed by the group
//    id, not indexed by it, so hot keys may sit anywhere in [0, G), keys
//    need not be sorted, and G = 1 and G in the millions take the same
//    path.
//
// Shared float64 atomics: with CUDA 12.8's ptxas, atomicAdd on a shared
// double on sm_90a is a 64-bit compare-and-swap loop in SASS
// (ATOMS.CAST.SPIN.64: there is no native shared float64 add), while the
// global one is a single REDG.E.ADD.F64.RN; the key's claim (atomicCAS) is
// one ATOMS.CAS and the match one MATCH.ANY.  The table's pointers come
// from the extern __shared__ array, so nvcc resolves them to the shared
// state space: the plain atomicCAS / atomicAdd and the volatile read
// compile to the same SASS, instruction for instruction, as the same
// operations spelled out in PTX (atom.shared.cas.b32, red.shared.add.f64,
// ld.volatile.shared.s32).  chip_smoke.py's [build] line counts MATCH,
// ATOMS and ATOMS.CAST.SPIN in the built library.  The warp
// reduction keeps the loop short: a slot sees at most one update a warp and
// round, so its CAS contends only with the CTA's other 15 warps.
//
// Accuracy: the order of the atomics varies from run to run, and a
// float32 running sum of 730,000 terms would drift by ~1e-4 relative from
// one order to the next.  Everything past the float32 product vals * mw is
// summed in float64 (warp, table, global scratch of 2 * n_groups doubles,
// zeroed by the entry) and rounded once to float32 by a second pass.
// Counts of 0/1 or dyadic weights are exact in any order.
//
// Bound: memory.  mw is read for every row (4 bytes), key and value only
// for rows with mw != 0 (8 bytes), and the two outputs are written once
// (8 bytes a group): 4 R + 8 R_active + 8 G bytes over 3.35 TB/s.  DRAM
// moves 32-byte sectors, and with 29 % of rows active almost every sector
// of keys and vals holds one, so the traffic is nearer 4 R + 8 R + 8 G
// (chip_smoke.py prints this estimate, computed from the inputs, as
// sectors_mb_est).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLogSlots = 12;
constexpr int kSlots = 1 << kLogSlots;   // 4096 slots: 80 KB a CTA
constexpr int kProbe = 16;               // slots probed before a spill
constexpr int kMinQuadsPerThread = 4;    // grid: a CTA per 4 * 512 quads
constexpr int kStage = 32 + 4 * 32;      // a round's rest + a quad a lane
constexpr int kEmpty = -1;               // no valid key is negative
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory: the table (sums, counts, keys), then each warp's
// staged rows (vals * mw and mw as a float2, then the keys)
constexpr size_t kSmemBytes =
    kSlots * (2 * sizeof(double) + sizeof(int)) +
    kWarps * kStage * (sizeof(float2) + sizeof(int));

struct Table {
  double* sums;
  double* counts;
  int* keys;
};

// A warp's queue of active, in-range rows in shared memory: (vals * mw,
// mw) and the key of entry i at sc[i], key[i]; n entries, warp-uniform.
struct Stage {
  float2* sc;
  int* key;
  int n;
};

// One entry a lane, all 32 lanes present; `valid` marks the lanes that hold
// one.  Equal keys are summed in the warp, then each distinct key goes to
// the CTA's table or, past the probe bound, to the global scratch.
__device__ __forceinline__ void add_rows(const Table& t, int key, double s,
                                         double c, bool valid,
                                         double* __restrict__ gsums,
                                         double* __restrict__ gcounts) {
  const int lane = threadIdx.x & 31;
  // lanes without an entry carry kEmpty, which no valid entry has
  const unsigned peers = __match_any_sync(kFull, valid ? key : kEmpty);
  const bool leader = valid && (__ffs(peers) - 1 == lane);
  unsigned others = leader ? (peers & ~(1u << lane)) : 0u;
  const int rounds = static_cast<int>(
      __reduce_max_sync(kFull, static_cast<unsigned>(__popc(others))));
  double ss = s, cc = c;
  for (int i = 0; i < rounds; ++i) {
    const int src = others ? __ffs(others) - 1 : lane;
    const double s2 = __shfl_sync(kFull, s, src);
    const double c2 = __shfl_sync(kFull, c, src);
    if (others) {
      ss += s2;
      cc += c2;
      others &= others - 1u;
    }
  }
  if (!leader) return;
  const unsigned h = (static_cast<unsigned>(key) * 0x9E3779B1u) >>
                     (32 - kLogSlots);
  for (int p = 0; p < kProbe; ++p) {
    const unsigned slot = (h + p) & (kSlots - 1);
    int cur = *static_cast<volatile int*>(t.keys + slot);
    if (cur == kEmpty) cur = atomicCAS(t.keys + slot, kEmpty, key);
    if (cur == kEmpty || cur == key) {
      atomicAdd(t.sums + slot, ss);
      atomicAdd(t.counts + slot, cc);
      return;
    }
  }
  atomicAdd(gsums + key, ss);
  atomicAdd(gcounts + key, cc);
}

// Appends each lane's row to the warp's queue where `valid`.
__device__ __forceinline__ void stage_row(Stage& q, bool valid, int key,
                                          float s, float c) {
  const unsigned b = __ballot_sync(kFull, valid);
  if (valid) {
    const int at = q.n + __popc(b & ((1u << (threadIdx.x & 31)) - 1u));
    q.sc[at] = make_float2(s, c);
    q.key[at] = key;
  }
  q.n += __popc(b);
}

// Drains whole rounds of 32 entries from the queue, then moves the rest
// (< 32) to its front; with `all`, the rest goes too, as a partial round.
__device__ __forceinline__ void drain(const Table& t, Stage& q, bool all,
                                      double* __restrict__ gsums,
                                      double* __restrict__ gcounts) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  int done = 0;
  for (; q.n - done >= 32; done += 32) {
    const float2 sc = q.sc[done + lane];
    add_rows(t, q.key[done + lane], sc.x, sc.y, true, gsums, gcounts);
  }
  const int rest = q.n - done;
  if (all) {
    if (rest > 0) {
      const bool mine = lane < rest;
      const float2 sc = mine ? q.sc[done + lane] : make_float2(0.f, 0.f);
      add_rows(t, mine ? q.key[done + lane] : kEmpty, sc.x, sc.y, mine,
               gsums, gcounts);
    }
    q.n = 0;
  } else if (done > 0) {
    float2 sc = make_float2(0.f, 0.f);
    int key = kEmpty;
    if (lane < rest) {
      sc = q.sc[done + lane];
      key = q.key[done + lane];
    }
    __syncwarp();
    if (lane < rest) {
      q.sc[lane] = sc;
      q.key[lane] = key;
    }
    q.n = rest;
  }
  __syncwarp();
}

// A thread's quad of 4 rows: mw, and the key and value of the rows with
// mw != 0 (no load for the others).
struct Quad {
  float w[4];
  float v[4];
  int k[4];
};

__device__ __forceinline__ Quad load_quad(const float* __restrict__ vals,
                                          const int* __restrict__ keys,
                                          long long r, float4 w) {
  Quad d;
  d.w[0] = w.x;
  d.w[1] = w.y;
  d.w[2] = w.z;
  d.w[3] = w.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool on = d.w[j] != 0.0f;
    d.k[j] = on ? __ldg(keys + r + j) : kEmpty;
    d.v[j] = on ? __ldg(vals + r + j) : 0.0f;
  }
  return d;
}

// Rows [0, head) and [head + 4 * n_quads, n_rows) are taken one a lane by
// warp 0 of CTA 0; the quads [q_per_cta * b, q_per_cta * (b + 1)) of the
// rows from head on by CTA b.
__global__ void __launch_bounds__(kThreads)
    masked_segment_agg_kernel(const float* __restrict__ vals,
                              const int* __restrict__ keys,
                              const float* __restrict__ mw,
                              double* __restrict__ gsums,
                              double* __restrict__ gcounts, long long n_rows,
                              int n_groups, int head, long long n_quads,
                              long long q_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Table t{reinterpret_cast<double*>(smem),
                reinterpret_cast<double*>(smem) + kSlots,
                reinterpret_cast<int*>(smem + 2 * kSlots * sizeof(double))};
  float2* stage_sc = reinterpret_cast<float2*>(t.keys + kSlots);
  int* stage_key = reinterpret_cast<int*>(stage_sc + kWarps * kStage);
  const int warp = threadIdx.x >> 5;
  Stage q{stage_sc + warp * kStage, stage_key + warp * kStage, 0};
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    t.keys[i] = kEmpty;
    t.sums[i] = 0.0;
    t.counts[i] = 0.0;
  }
  __syncthreads();

  if (blockIdx.x == 0 && warp == 0) {
    const int lane = threadIdx.x;
    const long long tail0 = head + 4 * n_quads;
    const long long r = lane < head ? lane : tail0 + (lane - head);
    const bool mine = lane < head || r < n_rows;
    const float w = mine ? __ldg(mw + r) : 0.0f;
    const int key = w != 0.0f ? __ldg(keys + r) : kEmpty;
    const float v = w != 0.0f ? __ldg(vals + r) : 0.0f;
    stage_row(q, w != 0.0f && static_cast<unsigned>(key) <
                                  static_cast<unsigned>(n_groups),
              key, v * w, w);
  }

  // the loads run ahead: while a thread stages quad i, the keys and values
  // of quad i + 1 and the mw of quad i + 2 are in flight
  const long long q0 = static_cast<long long>(blockIdx.x) * q_per_cta;
  const long long q1 = min(q0 + q_per_cta, n_quads);
  const float4* mw4 = reinterpret_cast<const float4*>(mw + head);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  long long qi = q0 + threadIdx.x;
  float4 wb = qi + kThreads < q1 ? __ldg(mw4 + qi + kThreads) : zero;
  Quad a = load_quad(vals, keys, head + 4 * qi,
                     qi < q1 ? __ldg(mw4 + qi) : zero);
  for (long long base = q0; base < q1; base += kThreads) {
    const long long qc = qi + 2 * kThreads;
    const float4 wc = qc < q1 ? __ldg(mw4 + qc) : zero;
    const Quad b = load_quad(vals, keys, head + 4 * (qi + kThreads), wb);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage_row(q, a.w[j] != 0.0f && static_cast<unsigned>(a.k[j]) <
                                         static_cast<unsigned>(n_groups),
                a.k[j], a.v[j] * a.w[j], a.w[j]);
    drain(t, q, false, gsums, gcounts);
    a = b;
    wb = wc;
    qi += kThreads;
  }
  drain(t, q, true, gsums, gcounts);
  __syncthreads();

  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const int key = t.keys[i];
    if (key != kEmpty) {
      atomicAdd(gsums + key, t.sums[i]);
      atomicAdd(gcounts + key, t.counts[i]);
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

// CTAs of masked_segment_agg_kernel the current device holds at once;
// the first call on a device also raises the kernel's dynamic shared
// memory limit there.
int resident_ctas() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    cudaFuncSetAttribute(masked_segment_agg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemBytes));
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, masked_segment_agg_kernel, kThreads, kSmemBytes);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  return cached[dev];
}

}  // namespace

// acc: scratch for 2 * n_groups float64 (sums, then counts), zeroed here;
// out receives the same 2 * n_groups values as float32.  Returns
// cudaGetLastError() after the launches.
extern "C" int masked_segment_agg_f32(const void* vals, const void* keys,
                                      const void* mw, void* acc, void* out,
                                      long long n_rows, int n_groups,
                                      void* stream) {
  if (n_groups <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* sums = static_cast<double*>(acc);
  cudaMemsetAsync(acc, 0, 2 * sizeof(double) * n_groups, s);
  if (n_rows > 0) {
    // rows before mw's first 16-byte boundary, then whole quads
    const long long mis = (reinterpret_cast<unsigned long long>(mw) & 15) / 4;
    const long long head = mis ? (4 - mis < n_rows ? 4 - mis : n_rows) : 0;
    const long long n_quads = (n_rows - head) / 4;
    const long long per_cta = (long long)kThreads * kMinQuadsPerThread;
    long long blocks = (n_quads + per_cta - 1) / per_cta;
    const long long cap = resident_ctas();
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    const long long q_per_cta = (n_quads + blocks - 1) / blocks;
    masked_segment_agg_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(keys),
        static_cast<const float*>(mw), sums, sums + n_groups, n_rows,
        n_groups, (int)head, n_quads, q_per_cta);
  }
  const int threads = 256;
  long long rblocks = (2LL * n_groups + threads - 1) / threads;
  if (rblocks > 132LL * 16) rblocks = 132LL * 16;
  round_to_f32_kernel<<<(unsigned)rblocks, threads, 0, s>>>(
      sums, static_cast<float*>(out), 2LL * n_groups);
  return static_cast<int>(cudaGetLastError());
}
