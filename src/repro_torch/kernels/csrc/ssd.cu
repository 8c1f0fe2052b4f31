// Mamba2 SSD (state-space dual) scan for Hopper (sm_90a), forward only.
//
// Per (batch b, head h), with a float32 state H (N x P) zeroed at t = 0:
//
//   H[n][p] <- a_t * H[n][p] + b_t[n] * x_t[p]   (update first)
//   y_t[p]   = sum_n c_t[n] * H[n][p]            (then read)
//
// x is (B, T, H, P), a (B, T, H), b and c (B, T, H, N), all float32 or all
// bfloat16, passed with their element strides: b and c may have head
// stride 0, the mamba block's one (T, N) matrix shared by every head, which
// is then never materialized per head.  The loop over t stops at T (the
// reference pads with a = 1, b = 0, which changes nothing).  y comes back
// in x's dtype.  P and N are multiples of 8, at most 128.
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_hmajor (ssd.py:76, body
// _ssd_kernel :27-63), reached through ops.ssd from layers/mamba.py's
// kernel mode (the planner's ssd_pallas impl).  The TPU kernel computes the
// same function in its chunked matmul form on the MXU, carrying H in VMEM
// scratch across a sequential chunk grid axis; here it is the sequential
// recurrence, a loop over t inside the block.
//
// Design (simple first).  Column p of H depends only on x_t[p]: one CTA of
// 32 threads (one warp) per (b*h, tile of 32 columns of P), a thread per
// column holding H[:, p] in registers (NM floats, N rounded up to 16, 32,
// 64 or 128).  a, b and c of a chunk of L = 32 steps and x of the chunk's
// columns are staged in shared memory as float32 (a batch of steps' loads
// in flight together); each step reads only shared memory (float4
// broadcasts, eight rows at a time) and registers.  At zamba2-7b's width
// (H = 112, P = N = 64) a batch-1 prefill runs 224 CTAs.
//
// Bound (B = 1, T = 2048, H = 112, P = N = 64, bf16 I/O, b and c read once
// per step, not per head): 60 MB, 0.018 ms at 3.35 TB/s; 5 N P operations
// a step and head, 4.7 GFLOP, 0.07 ms at the 67 TFLOP/s float32 rate:
// operations bound.  This kernel is bound by neither: its 2048 steps form
// one dependent chain per column, one warp issues each step's N rows of
// shared-memory reads and fused multiply-adds (~35 cycles of latency a
// row), and each CTA reloads the shared b and c.  On an H100 SXM at 700 W
// it takes 2.5 ms at that shape, 2.8 % of the bound (chip_smoke.py,
// PERF.md).  Rebuilding the chunked form's intra-chunk products ((C B^T) o
// L_decay) X on the tensor cores is the redesign: it shortens the chain to
// T / L chunk steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using recurrence::at;
using recurrence::load8;
using recurrence::store;

constexpr int COLS = 32;  // columns of P (threads) per CTA
constexpr int L = 32;     // steps staged in shared memory at a time

struct Params {
  const void* x;
  const void* a;
  const void* b;
  const void* c;
  void* y;
  int batch, steps, heads, p, n;
  // element strides: x (batch, t, head, p), a (batch, t, head, -),
  // b and c (batch, t, head, n), y (batch, t, head, p)
  long long st[5][4];
};

template <typename T, int NM>
__global__ void __launch_bounds__(COLS) ssd_kernel(const Params p) {
  constexpr int Q = (NM + COLS - 1) / COLS;  // a thread's elements a row
  constexpr int LB = 16 / Q;                 // steps loaded per batch
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // [L][NM]
  float* c_s = b_s + L * NM;                     // [L][NM]
  float* x_s = c_s + L * NM;                     // [L][COLS]
  float* a_s = x_s + L * COLS;                    // [L]

  const int bh = blockIdx.y;
  const int bb = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * COLS + tid;
  const bool live = col < p.p;
  const int n_st = p.n;

  float hs[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) hs[i] = 0.f;

  for (int t0 = 0; t0 < p.steps; t0 += L) {
    const int n = min(L, p.steps - t0);
    __syncthreads();  // the previous chunk is consumed
    if (tid < n) a_s[tid] = at<T>(p.a, p.st[1], bb, t0 + tid, h, 0);
    // LB steps at a time: every load of the batch issues before any
    // store, so their latencies overlap instead of adding up
    for (int tb = 0; tb < n; tb += LB) {
      float bv[LB][Q], cv[LB][Q], xv[LB];
#pragma unroll
      for (int e = 0; e < LB; ++e) {
        const int t = t0 + tb + e;
        const bool ok = tb + e < n;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = tid + q * COLS;
          const bool in = ok && i < n_st;
          bv[e][q] = in ? at<T>(p.b, p.st[2], bb, t, h, i) : 0.f;
          cv[e][q] = in ? at<T>(p.c, p.st[3], bb, t, h, i) : 0.f;
        }
        xv[e] = ok && live ? at<T>(p.x, p.st[0], bb, t, h, col) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < LB; ++e) {
        const int tt = tb + e;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = tid + q * COLS;
          if (tt < n && i < NM) {
            b_s[tt * NM + i] = bv[e][q];
            c_s[tt * NM + i] = cv[e][q];
          }
        }
        if (tt < n) x_s[tt * COLS + tid] = xv[e];
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float xp = x_s[tt * COLS + tid];
      const float at_ = a_s[tt];
      const float* bt = b_s + tt * NM;
      const float* ct = c_s + tt * NM;
      float y = 0.f;
      // eight rows at a time: their b and c come in as float4 reads
      // issued together, so one shared-memory latency covers 8 rows
#pragma unroll
      for (int i0 = 0; i0 < NM; i0 += 8) {
        if (i0 < n_st) {  // n is a multiple of 8
          float b8[8], c8[8];
          load8(bt + i0, b8);
          load8(ct + i0, c8);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            hs[i0 + q] = at_ * hs[i0 + q] + b8[q] * xp;  // update ...
            y += c8[q] * hs[i0 + q];                    // ... then read
          }
        }
      }
      if (live) {
        const long long* o = p.st[4];
        store(static_cast<T*>(p.y) + bb * o[0] + (long long)(t0 + tt) * o[1] +
                  h * o[2] + col * o[3],
              y);
      }
    }
  }
}

template <typename T, int NM>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = (2 * L * NM + L * COLS + L) * (int)sizeof(float);
  cudaFuncSetAttribute(ssd_kernel<T, NM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.p + COLS - 1) / COLS, p.batch * p.heads);
  ssd_kernel<T, NM><<<grid, COLS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.n <= 16) return launch<T, 16>(p, stream);
  if (p.n <= 32) return launch<T, 32>(p, stream);
  if (p.n <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, b, c and y).  strides: 20 element
// strides, (batch, t, head, last) of x, a (last unused), b, c and y in that
// order.  The caller checks shapes (p and n multiples of 8 up to 128,
// batch * heads <= 65535).  Returns cudaGetLastError() after the launch.
extern "C" int ssd_fwd(const void* x, const void* a, const void* b,
                       const void* c, void* y, int dtype, int batch,
                       int steps, int heads, int p_dim, int n_dim,
                       const long long* strides, void* stream) {
  Params p;
  p.x = x;
  p.a = a;
  p.b = b;
  p.c = c;
  p.y = y;
  p.batch = batch;
  p.steps = steps;
  p.heads = heads;
  p.p = p_dim;
  p.n = n_dim;
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 4; ++j) p.st[i][j] = strides[4 * i + j];
  if (batch < 1 || steps < 1 || heads < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}
