// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), forward only.
//
// Per (batch b, head h), with a float32 state S (D x D) zeroed at t = 0:
//
//   y_t[j] = v_t[j] * sum_i r_t[i] u[i] k_t[i] + sum_i r_t[i] S[i][j]
//                                                              (read first)
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]                (then update)
//
// r, k, v, w are (B, T, H, D) in float32 or bfloat16, passed with their
// element strides (no transposes, no padding: the loop over t stops at T,
// which is what the reference's padding with w = 1, k = 0 amounts to); u is
// (H, D) float32; y comes back in r's dtype.  D is a multiple of 8, at most
// 128.
//
// Replaces: src/repro/kernels/wkv6/wkv6.py::wkv6_hmajor (wkv6.py:70, body
// _wkv6_kernel :25-49), reached through ops.wkv6 from layers/rwkv.py's
// kernel mode (the planner's wkv6_pallas impl).  The TPU kernel keeps S in
// VMEM scratch across a sequential chunk grid axis; here a loop over t
// inside the block takes that axis's place.
//
// Design (simple first).  Column j of S depends only on column j:
// y_t[j] and S[:, j] need v_t[j] and the whole of r_t, k_t, w_t.  So one
// CTA of 32 threads (one warp) per (b*h, tile of 32 value columns), a
// thread per column holding S[:, j] in registers (DM floats, DM the head
// size rounded up to 16, 32, 64 or 128).  r, k and w of a chunk of L = 32
// steps and v of the chunk's columns are staged in shared memory as
// float32 (each read once from device memory, a batch of steps' loads in
// flight together), with each step's bonus scalar sum_i r_i u_i k_i,
// summed once by the warp while staging; every step then reads only
// shared memory (float4 broadcasts, eight rows at a time) and registers,
// three operations a state row.  At rwkv6-3b's width (H = 40, D = 64) a
// batch-1 prefill runs 80 CTAs.
//
// Bound (B = 1, T = 2048, H = 40, D = 64, bf16 I/O): 52 MB read and
// written, 0.016 ms at 3.35 TB/s; 5 D^2 + 3 D operations a step and head
// (2 D^2 for r S, 3 D^2 for the update, 3 D for the bonus scalar), 1.69
// GFLOP, 0.025 ms at the 67 TFLOP/s float32 rate: operations bound.  This
// kernel is bound by neither: its 2048 steps form one dependent chain per
// column, and one warp issues each step's D rows of shared-memory reads and
// fused multiply-adds, paying tens of cycles of latency a row (chip_smoke.py
// measures it against the bound; PERF.md row 10 holds the times).  A
// redesign splits each column's rows over several threads (y reduced by
// shuffles) or computes the chunked form (the (L x L) intra-chunk products
// of wkv6_chunked) on the tensor cores, so the serial chain is T / L chunk
// steps long.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using recurrence::at;
using recurrence::load8;
using recurrence::store;

constexpr int COLS = 32;  // value columns (threads) per CTA
constexpr int L = 32;     // steps staged in shared memory at a time

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;
  void* y;
  int batch, steps, heads, d;
  // element strides (batch, t, head, dim) of r, k, v, w, y
  long long st[5][4];
};

template <typename T, int DM>
__global__ void __launch_bounds__(COLS) wkv6_kernel(const Params p) {
  constexpr int Q = (DM + COLS - 1) / COLS;  // a thread's elements a row
  constexpr int LB = 16 / Q;                 // steps loaded per batch
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);  // [L][DM]
  float* k_s = r_s + L * DM;                     // [L][DM]
  float* w_s = k_s + L * DM;                     // [L][DM]
  float* v_s = w_s + L * DM;                     // [L][COLS]
  float* g_s = v_s + L * COLS;                   // [L] sum_i r_i u_i k_i

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * COLS + tid;
  const bool live = j < p.d;
  const int d = p.d;

  float uu[Q];  // this thread's elements of u
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = tid + q * COLS;
    uu[q] = i < d ? p.u[h * d + i] : 0.f;
  }

  float s[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) s[i] = 0.f;

  for (int t0 = 0; t0 < p.steps; t0 += L) {
    const int n = min(L, p.steps - t0);
    __syncthreads();  // the previous chunk is consumed
    // LB steps at a time: every load of the batch issues before any
    // store, so their latencies overlap instead of adding up
    for (int tb = 0; tb < n; tb += LB) {
      float rr[LB][Q], kk[LB][Q], ww[LB][Q], vv[LB], g[LB];
#pragma unroll
      for (int e = 0; e < LB; ++e) {
        const int t = t0 + tb + e;
        const bool ok = tb + e < n;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = tid + q * COLS;
          const bool in = ok && i < d;
          rr[e][q] = in ? at<T>(p.r, p.st[0], b, t, h, i) : 0.f;
          kk[e][q] = in ? at<T>(p.k, p.st[1], b, t, h, i) : 0.f;
          ww[e][q] = in ? at<T>(p.w, p.st[3], b, t, h, i) : 0.f;
        }
        vv[e] = ok && live ? at<T>(p.v, p.st[2], b, t, h, j) : 0.f;
      }
      // the bonus term r (diag u) k^T v_j = v_j * sum_i r_i u_i k_i: its
      // scalar is the same for every column, so it is summed here, once a
      // step and off the serial chain (the warp's 32 lanes hold all of i)
#pragma unroll
      for (int e = 0; e < LB; ++e) {
        g[e] = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) g[e] += rr[e][q] * uu[q] * kk[e][q];
      }
#pragma unroll
      for (int off = COLS / 2; off > 0; off /= 2) {
#pragma unroll
        for (int e = 0; e < LB; ++e)
          g[e] += __shfl_xor_sync(0xffffffffu, g[e], off);
      }
#pragma unroll
      for (int e = 0; e < LB; ++e) {
        const int tt = tb + e;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int i = tid + q * COLS;
          if (tt < n && i < DM) {
            r_s[tt * DM + i] = rr[e][q];
            k_s[tt * DM + i] = kk[e][q];
            w_s[tt * DM + i] = ww[e][q];
          }
        }
        if (tt < n) v_s[tt * COLS + tid] = vv[e];
        if (tt < n && tid == 0) g_s[tt] = g[e];
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt * COLS + tid];
      const float* rt = r_s + tt * DM;
      const float* kt = k_s + tt * DM;
      const float* wt = w_s + tt * DM;
      float y = vj * g_s[tt];
      // eight rows at a time: their r, k, w come in as float4 reads
      // issued together, so one shared-memory latency covers 8 rows
#pragma unroll
      for (int i0 = 0; i0 < DM; i0 += 8) {
        if (i0 < d) {  // d is a multiple of 8
          float r8[8], k8[8], w8[8];
          load8(rt + i0, r8);
          load8(kt + i0, k8);
          load8(wt + i0, w8);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            y += r8[q] * s[i0 + q];                       // read the old state
            s[i0 + q] = w8[q] * s[i0 + q] + k8[q] * vj;  // then decay and add
          }
        }
      }
      if (live) {
        const long long* o = p.st[4];
        store(static_cast<T*>(p.y) + b * o[0] + (long long)(t0 + tt) * o[1] +
                  h * o[2] + j * o[3],
              y);
      }
    }
  }
}

template <typename T, int DM>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = (3 * L * DM + L * COLS + L) * (int)sizeof(float);
  cudaFuncSetAttribute(wkv6_kernel<T, DM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.d + COLS - 1) / COLS, p.batch * p.heads);
  wkv6_kernel<T, DM><<<grid, COLS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return launch<T, 16>(p, stream);
  if (p.d <= 32) return launch<T, 32>(p, stream);
  if (p.d <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (r, k, v, w and y); u is float32 (H, D),
// contiguous.  strides: 20 element strides, (batch, t, head, dim) of r, k,
// v, w and y in that order.  The caller checks shapes (d a multiple of 8 up
// to 128, batch * heads <= 65535).  Returns cudaGetLastError() after the
// launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* y, int dtype,
                        int batch, int steps, int heads, int d,
                        const long long* strides, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = static_cast<const float*>(u);
  p.y = y;
  p.batch = batch;
  p.steps = steps;
  p.heads = heads;
  p.d = d;
  for (int a = 0; a < 5; ++a)
    for (int c = 0; c < 4; ++c) p.st[a][c] = strides[4 * a + c];
  if (batch < 1 || steps < 1 || heads < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}
