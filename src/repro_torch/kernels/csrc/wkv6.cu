// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a), forward only.
//
// Per (batch b, head h), with a float32 state S (D x D) zeroed at t = 0:
//
//   y_t[j] = v_t[j] * sum_i r_t[i] u[i] k_t[i] + sum_i r_t[i] S[i][j]
//                                                              (read first)
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]                (then update)
//
// r, k, v, w are (B, T, H, D) in float32 or bfloat16, passed with their
// element strides (no transposes, no padding copies; T is any length
// >= 1); u is (H, D) float32; y comes back in r's dtype, contiguous.  D is
// a multiple of 8, at most 128.
//
// Replaces: src/repro/kernels/wkv6/wkv6.py::wkv6_hmajor (wkv6.py:70, body
// _wkv6_kernel :25-49), reached through ops.wkv6 from layers/rwkv.py's
// kernel mode (the planner's wkv6_pallas impl).  The TPU kernel keeps S in
// VMEM scratch across a sequential chunk grid axis and walks the steps one
// by one on the vector unit.
//
// bfloat16 (the served prefills' dtype): the same function in chunked
// form on the tensor cores (chunk_kernel).  Per chunk of L = 64 steps, cw
// the inclusive cumsum of log2 max(w, 1e-37) inside the chunk (per
// channel, <= 0 and falling) and cw_{-1} = 0:
//
//   y_t   = sum_{s<t} A[t,s] v_s + (sum_d r_t u k_t) v_t
//           + (r_t o 2^cw_{t-1}) S_in
//   A[t,s] = sum_d r_t[d] k_s[d] 2^(cw_{t-1}[d] - cw_s[d])
//   S_out = diag(2^cw_L) S_in + sum_s (k_s o 2^(cw_L - cw_s)) (x) v_s
//
// The decay is per channel, so A does not factor into r 2^cw times
// k 2^-cw: the k side overflows float32 once a chunk's decay passes 2^128
// (7 steps at w = 1e-6).  Nothing is clamped.  A's row block of sub-chunk
// I (16 steps, rows t in [16 I, 16 I + 16)) splits in two:
//   * pairs with s in an earlier sub-chunk factor at the reference point
//     c = 16 I:  (r_t o 2^(cw_{t-1} - cw_{c-1})) . (k_s o 2^(cw_{c-1} - cw_s)),
//     both factors <= 1: a 16 x 16 I product on the tensor cores;
//   * pairs inside the sub-chunk (s <= t; s = t is the bonus u) are summed
//     element by element on the CUDA cores with 2^(cw_{t-1} - cw_s) <= 1.
// Every exponent is <= 0, so a decay near 0 underflows to the right 0.
// (The scheme of flash-linear-attention's chunked RWKV6 kernels.)
//
// Layout: one CTA of eight warps per (b*h, tile of 64 value columns; 32
// where D is not 64): S's column j depends only on v[:, j].  Warps I and
// I + 4 share sub-chunk I: each sums A's row block over half of the
// channels (the earlier sub-chunks' k-steps of its parity, half of the
// in-sub-chunk channels), the pair adds the halves through shared memory,
// and each then takes half of the value columns for y.  The eight warps
// share S's 16 x 8 tiles, kept in float32 registers across chunks.  A is
// the same for every column tile, so at D = 64 a head is one CTA and A is
// computed once: at rwkv6-3b's width (H = 40, D = 64) a batch-1 prefill
// runs 40 CTAs.  The next chunk's r, k, w and v tiles are in flight
// (cp.async, zero-filled past T and D) while the current one computes.
// (Four warps, each with a whole sub-chunk, ran slower: the kernel is
// latency bound, and a second warp on each SM sub-partition hides part of
// it.)
//
// Precision.  r, k and v enter the tensor cores as they are (bf16, exact),
// products accumulate in float32.  The float32 operands (the decayed r
// and k, A, S_in, the decayed k of the state update) are each split into
// two bf16 terms hi + lo (relative error <= 2^-17, recurrence.cuh split2):
// a product with an exact operand takes two mma, one of two split
// operands three (hi.hi + hi.lo + lo.hi).  The result is float32-accurate
// to ~1e-5 of y's scale; S stays float32.
//
// float32: the exact sequential recurrence (exact_kernel), its 1e-4
// tolerance being beyond the bf16 split's reach at large |y|: one warp per
// (b*h, 32 value columns), a thread per column holding S[:, j] in
// registers, r, k, w and v of 32 steps staged in shared memory.
//
// Bound (B = 1, T = 2048, H = 40, D = 64, bf16 I/O): 52 MB read and
// written, 0.016 ms at 3.35 TB/s.  The chunked form's matrix products (per
// chunk of L and head: A's pairs across sub-chunks and A V over the pairs
// s <= t, 2 D each; q S_in and the state update, 2 L D^2 each), 1.9
// GFLOP, take 0.002 ms at the 989 TFLOP/s bf16 rate; its other operations
// (the in-sub-chunk pairs, 3 D each; the operands' decays and the cumsum)
// 0.003 ms at 67 TFLOP/s: bytes bound.  (The sequential form's 5 D^2 + 3 D
// operations a step at the float32 rate, 0.025 ms, bounded the sequential
// kernel; chip_smoke.py computes both.)  What keeps the kernel above its
// bound: 40 CTAs leave 92 of 132 SMs idle, each walks 32 chunks in order,
// and within a chunk the in-sub-chunk pairs (6 powers of two a lane and
// channel) and the earlier sub-chunks' decayed operands run on the
// special-function unit before any product can start.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace recurrence;

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
  bool vec[4];  // r, k, v, w: every 8-element row segment 16-byte aligned
};

// ---- float32: the exact sequential recurrence ---------------------------

constexpr int COLS = 32;  // value columns (threads) per CTA
constexpr int LS = 32;    // steps staged in shared memory at a time

template <int DM>
__global__ void __launch_bounds__(COLS) exact_kernel(const Params p) {
  using T = float;
  constexpr int Q = (DM + COLS - 1) / COLS;  // a thread's elements a row
  constexpr int LB = 16 / Q;                 // steps loaded per batch
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);  // [LS][DM]
  float* k_s = r_s + LS * DM;                     // [LS][DM]
  float* w_s = k_s + LS * DM;                     // [LS][DM]
  float* v_s = w_s + LS * DM;                     // [LS][COLS]
  float* g_s = v_s + LS * COLS;                   // [LS] sum_i r_i u_i k_i

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

  for (int t0 = 0; t0 < p.steps; t0 += LS) {
    const int n = min(LS, p.steps - t0);
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


template <int DM>
int launch_exact(const Params& p, cudaStream_t stream) {
  const int smem = (3 * LS * DM + LS * COLS + LS) * (int)sizeof(float);
  cudaFuncSetAttribute(exact_kernel<DM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.d + COLS - 1) / COLS, p.batch * p.heads);
  exact_kernel<DM><<<grid, COLS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: the chunked form on the tensor cores ---------------------

constexpr int L = 64;              // steps per chunk
constexpr int SUB = 16;            // steps per sub-chunk
constexpr int NSUB = L / SUB;      // sub-chunks: warps I and I + NSUB
constexpr int WARPS = 2 * NSUB;    // share sub-chunk I
constexpr int THREADS = 32 * WARPS;
// tiles of A a warp pair exchanges: sub-chunk I has 2 I + 2 of them
constexpr int A_TILES = NSUB * (NSUB + 1);

// shared memory, in bf16 elements, then the float32 arrays
template <int DP>
struct Layout {
  static constexpr int VT = DP == 64 ? 64 : 32;   // value columns a CTA
  static constexpr int SD = DP + 8;               // row stride of [.][D]
  static constexpr int SV = VT + 8;               // row stride of [.][VT]
  static constexpr int SC = DP + 4;               // row stride of cw
  static constexpr int R = 0;                     // [2][L][SD] r (2 bufs)
  static constexpr int K = R + 2 * L * SD;        // [2][L][SD] k
  static constexpr int W = K + 2 * L * SD;        // [2][L][SD] w
  static constexpr int V = W + 2 * L * SD;        // [2][L][SV] v
  static constexpr int KW = V + 2 * L * SV;       // [2][L][SD] k decayed hi, lo
  static constexpr int S = KW + 2 * L * SD;       // [2][DP][SV] S hi, lo
  static constexpr int END = S + 2 * DP * SV;
  static constexpr int NSEG = THREADS / DP;       // scan segments a channel
  // then float [L + 1][SC] cw (row t: the sum over steps < t), [DP] u,
  // [NSEG][DP] the scan's segment sums, [2][A_TILES][4][32] the halves
  // of A a warp pair exchanges
  static constexpr int BYTES =
      END * 2 + ((L + 1) * SC + DP + NSEG * DP + 2 * A_TILES * 128) * 4;
  static constexpr int UNITS = DP / 16 * (VT / 8);  // S's 16 x 8 tiles
  static constexpr int OWN = (UNITS + WARPS - 1) / WARPS;
};

// the 64 threads of warps I and I + NSUB
__device__ __forceinline__ void pair_sync(int sub) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + sub), "r"(64));
}

template <int DP>
__global__ void __launch_bounds__(THREADS) chunk_kernel(const Params p) {
  using Ly = Layout<DP>;
  constexpr int SD = Ly::SD, SV = Ly::SV, SC = Ly::SC, VT = Ly::VT;
  constexpr int NT = VT / 16;  // a warp's value n-tiles: half of VT
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* cw = reinterpret_cast<float*>(sm + Ly::END);  // [L + 1][SC]
  float* us = cw + (L + 1) * SC;                        // [DP]
  float* tot = us + DP;                                 // [NSEG][DP]
  float* xa = tot + Ly::NSEG * DP;                      // [2][A_TILES][4][32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int sub = warp % NSUB, hf = warp / NSUB;  // sub-chunk, half

  const int bh = blockIdx.y, bb = bh / p.heads, h = bh % p.heads;
  const int col0 = blockIdx.x * VT;
  const int T = p.steps, D = p.d;
  const long long *sr = p.st[0], *sk = p.st[1], *sv = p.st[2],
                  *sw = p.st[3], *sy = p.st[4];
  const bf16* rg = static_cast<const bf16*>(p.r) + bb * sr[0] + h * sr[2];
  const bf16* kg = static_cast<const bf16*>(p.k) + bb * sk[0] + h * sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + bb * sv[0] + h * sv[2];
  const bf16* wg = static_cast<const bf16*>(p.w) + bb * sw[0] + h * sw[2];
  bf16* yg = static_cast<bf16*>(p.y) + bb * sy[0] + h * sy[2];

  // the r, k, w and v tiles of the chunk at t0 into buffer buf
  auto load = [&](int t0, int buf) {
    for (int i = tid; i < L * (DP / 8); i += THREADS) {
      const int rr = i / (DP / 8), c = 8 * (i % (DP / 8));
      const int t = t0 + rr;
      const bool ok = t < T && c < D;
      const int o = (buf * L + rr) * SD + c;
      row8(sm + Ly::R + o, rg + t * sr[1] + c * sr[3], ok, p.vec[0], sr[3],
           rg);
      row8(sm + Ly::K + o, kg + t * sk[1] + c * sk[3], ok, p.vec[1], sk[3],
           kg);
      row8(sm + Ly::W + o, wg + t * sw[1] + c * sw[3], ok, p.vec[3], sw[3],
           wg);
    }
    for (int i = tid; i < L * (VT / 8); i += THREADS) {
      const int rr = i / (VT / 8), c = 8 * (i % (VT / 8));
      const int t = t0 + rr;
      row8(sm + Ly::V + (buf * L + rr) * SV + c,
           vg + t * sv[1] + (col0 + c) * sv[3], t < T && col0 + c < D,
           p.vec[2], sv[3], vg);
    }
  };

  load(0, 0);
  cp_commit();
  for (int i = tid; i < DP; i += THREADS) {
    us[i] = i < D ? p.u[h * D + i] : 0.f;
    cw[i] = 0.f;  // row 0: nothing before the chunk's first step
  }
  for (int i = tid; i < 2 * DP * SV; i += THREADS)
    sm[Ly::S + i] = __float2bfloat16_rn(0.f);
  float sacc[Ly::OWN][4];
#pragma unroll
  for (int o = 0; o < Ly::OWN; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[o][e] = 0.f;

  bf16* kwh = sm + Ly::KW;
  bf16* kwl = kwh + L * SD;
  bf16* shi = sm + Ly::S;
  bf16* slo = shi + DP * SV;
  const int r0 = SUB * sub;      // this warp's rows of A and y
  const int n0 = hf * (VT / 2);  // ... and its value columns
  const int nch = (T + L - 1) / L;
  for (int kc = 0; kc < nch; ++kc) {
    const int buf = kc & 1, t0 = kc * L;
    cp_wait_all();
    __syncthreads();  // chunk kc and S_in in shared memory; kc - 1 done
    if (kc + 1 < nch) {
      load(t0 + L, buf ^ 1);
      cp_commit();
    }
    const bf16* rs = sm + Ly::R + buf * L * SD;
    const bf16* ks = sm + Ly::K + buf * L * SD;
    const bf16* ws = sm + Ly::W + buf * L * SD;
    const bf16* vs = sm + Ly::V + buf * L * SV;

    // cw: per channel, NSEG segments of the chunk scanned in parallel,
    // then each shifted by the sums of the segments before it (log2 w = 0
    // past T: w = 1 changes nothing)
    {
      constexpr int SEG = L / Ly::NSEG;
      const int ch = tid % DP, sg = tid / DP;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const int t = sg * SEG + j;
        if (t0 + t < T)
          acc += lg2(fmaxf(__bfloat162float(ws[t * SD + ch]), 1e-37f));
        cw[(t + 1) * SC + ch] = acc;
      }
      tot[sg * DP + ch] = acc;
      __syncthreads();
      float off = 0.f;
      for (int j = 0; j < sg; ++j) off += tot[j * DP + ch];
      if (sg > 0)
#pragma unroll
        for (int j = 0; j < SEG; ++j) cw[(sg * SEG + j + 1) * SC + ch] += off;
      __syncthreads();
    }

    // A for rows t in sub-chunk sub, each half of the pair summing over
    // its own channels (earlier sub-chunks: the k-steps of parity hf;
    // this sub-chunk: channels [hf DP / 2, (hf + 1) DP / 2))
    const int t1 = r0 + g, t2 = t1 + 8;  // this lane's rows of A and y
    float a[L / 8][4];
#pragma unroll
    for (int j = 0; j < L / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = 0.f;

    // earlier sub-chunks: (r_t 2^(cw_{t-1} - cw_{c-1})) .
    // (k_s 2^(cw_{c-1} - cw_s)), c = r0, on the tensor cores
    if (sub > 0) {
      const float* cref = cw + r0 * SC;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if ((kk & 1) != hf) continue;
        uint32_t qh[4], ql[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int t = f & 1 ? t2 : t1, i = 16 * kk + 2 * q + 8 * (f >> 1);
          const float2 rv = ld2(rs + t * SD + i), c = ld2(cw + t * SC + i);
          const float2 c0 = ld2(cref + i);
          split2(rv.x * ex2(c.x - c0.x), rv.y * ex2(c.y - c0.y), qh[f], ql[f]);
        }
#pragma unroll
        for (int j = 0; j < L / 8 - 2; ++j) {
          if (j < 2 * sub) {
            uint32_t kh[2], kl[2];
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              const int s = 8 * j + g, i = 16 * kk + 2 * q + 8 * f;
              const float2 kv = ld2(ks + s * SD + i);
              const float2 c = ld2(cw + (s + 1) * SC + i);
              const float2 c0 = ld2(cref + i);
              split2(kv.x * ex2(c0.x - c.x), kv.y * ex2(c0.y - c.y), kh[f],
                     kl[f]);
            }
            mma_bf16(a[j], qh, kh[0], kh[1]);
            mma_bf16(a[j], qh, kl[0], kl[1]);
            mma_bf16(a[j], ql, kh[0], kh[1]);
          }
        }
      }
    }

    // this sub-chunk: element by element, 2^(cw_{t-1} - cw_s) for s < t,
    // u for s = t.  This lane's pairs: (t1, s0), (t1, s0 + 1), (t2, s0),
    // (t2, s0 + 1), (t2, s0 + 8), (t2, s0 + 9) with s0 = r0 + 2q;
    // (t1, s0 + 8..9) lie above the diagonal.
    {
      const int s0 = r0 + 2 * q;
      const int ts[6] = {t1, t1, t2, t2, t2, t2};
      const int ss[6] = {s0, s0 + 1, s0, s0 + 1, s0 + 8, s0 + 9};
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int i0 = hf * (DP / 2);
#pragma unroll 4
      for (int i = i0; i < i0 + DP / 2; i += 2) {
        const float2 u2 = ld2(us + i);
        const float2 r1 = ld2(rs + t1 * SD + i), c1 = ld2(cw + t1 * SC + i);
        const float2 r2 = ld2(rs + t2 * SD + i), c2 = ld2(cw + t2 * SC + i);
#pragma unroll
        for (int e = 0; e < 6; ++e) {
          const int s = ss[e], t = ts[e];
          const float2 kv = ld2(ks + s * SD + i);
          const float2 cs_ = ld2(cw + (s + 1) * SC + i);
          const float2 rv = e < 2 ? r1 : r2, ct = e < 2 ? c1 : c2;
          float fx, fy;
          if (e == 2 || e == 3) {  // s < t always
            fx = ex2(ct.x - cs_.x);
            fy = ex2(ct.y - cs_.y);
          } else {
            fx = s < t ? ex2(ct.x - cs_.x) : (s == t ? u2.x : 0.f);
            fy = s < t ? ex2(ct.y - cs_.y) : (s == t ? u2.y : 0.f);
          }
          acc[e] += rv.x * kv.x * fx + rv.y * kv.y * fy;
        }
      }
#pragma unroll
      for (int jp = 0; jp < NSUB; ++jp) {
        if (jp == sub) {  // static register indices
          a[2 * jp][0] += acc[0];
          a[2 * jp][1] += acc[1];
          a[2 * jp][2] += acc[2];
          a[2 * jp][3] += acc[3];
          a[2 * jp + 1][2] += acc[4];
          a[2 * jp + 1][3] += acc[5];
        }
      }
    }

    // the pair's halves of A summed: each writes its own, reads the other
    {
      const int base = sub * (sub + 1);
      float* mine = xa + (hf * A_TILES + base) * 128 + lane;
      const float* other = xa + ((1 - hf) * A_TILES + base) * 128 + lane;
#pragma unroll
      for (int j = 0; j < L / 8; ++j)
        if (j < 2 * sub + 2)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32] = a[j][e];
      pair_sync(sub);
#pragma unroll
      for (int j = 0; j < L / 8; ++j)
        if (j < 2 * sub + 2)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] += other[(j * 4 + e) * 32];
    }

    // y = A V (A as hi + lo) + (r_t 2^cw_{t-1}) S_in (both as hi + lo),
    // this warp's half of the value columns
    float y[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NSUB; ++kk) {
      if (kk <= sub) {
        uint32_t ah[4], al[4];
        split2(a[2 * kk][0], a[2 * kk][1], ah[0], al[0]);
        split2(a[2 * kk][2], a[2 * kk][3], ah[1], al[1]);
        split2(a[2 * kk + 1][0], a[2 * kk + 1][1], ah[2], al[2]);
        split2(a[2 * kk + 1][2], a[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          uint32_t v4[4];
          ldsm_x4_t(v4, vs + frag_bkn(lane, 16 * kk, n0 + 16 * pp, SV));
          mma_bf16(y[2 * pp], ah, v4[0], v4[1]);
          mma_bf16(y[2 * pp + 1], ah, v4[2], v4[3]);
          mma_bf16(y[2 * pp], al, v4[0], v4[1]);
          mma_bf16(y[2 * pp + 1], al, v4[2], v4[3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qh[4], ql[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = f & 1 ? t2 : t1, i = 16 * kk + 2 * q + 8 * (f >> 1);
        const float2 rv = ld2(rs + t * SD + i), c = ld2(cw + t * SC + i);
        split2(rv.x * ex2(c.x), rv.y * ex2(c.y), qh[f], ql[f]);
      }
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        uint32_t hi[4], lo[4];
        ldsm_x4_t(hi, shi + frag_bkn(lane, 16 * kk, n0 + 16 * pp, SV));
        ldsm_x4_t(lo, slo + frag_bkn(lane, 16 * kk, n0 + 16 * pp, SV));
        mma_bf16(y[2 * pp], qh, hi[0], hi[1]);
        mma_bf16(y[2 * pp + 1], qh, hi[2], hi[3]);
        mma_bf16(y[2 * pp], qh, lo[0], lo[1]);
        mma_bf16(y[2 * pp + 1], qh, lo[2], lo[3]);
        mma_bf16(y[2 * pp], ql, hi[0], hi[1]);
        mma_bf16(y[2 * pp + 1], ql, hi[2], hi[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + n0 + 8 * j + 2 * q;
      if (col < D) {
        if (t0 + t1 < T)
          store2(yg + (t0 + t1) * sy[1] + col, y[j][0], y[j][1]);
        if (t0 + t2 < T)
          store2(yg + (t0 + t2) * sy[1] + col, y[j][2], y[j][3]);
      }
    }

    // k_s 2^(cw_L - cw_s) as hi + lo, this warp's 8 rows s
    for (int i = lane; i < SUB / 2 * DP / 2; i += 32) {
      const int s = r0 + hf * (SUB / 2) + i / (DP / 2), c = 2 * (i % (DP / 2));
      const float2 kv = ld2(ks + s * SD + c), ce = ld2(cw + L * SC + c);
      const float2 cs_ = ld2(cw + (s + 1) * SC + c);
      uint32_t hi, lo;
      split2(kv.x * ex2(ce.x - cs_.x), kv.y * ex2(ce.y - cs_.y), hi, lo);
      *reinterpret_cast<uint32_t*>(kwh + s * SD + c) = hi;
      *reinterpret_cast<uint32_t*>(kwl + s * SD + c) = lo;
    }
    __syncthreads();  // k decayed complete; every warp past its S_in reads

    // S_out = diag(2^cw_L) S_in + (k decayed)^T V on this warp's tiles,
    // then S_out as hi + lo for the next chunk
#pragma unroll
    for (int o = 0; o < Ly::OWN; ++o) {
      const int u = warp * Ly::OWN + o;
      if (u < Ly::UNITS) {
        const int mt = u / (VT / 8), nt = u % (VT / 8);
        const int row = 16 * mt + g, c = 8 * nt + 2 * q;
        const float d0 = ex2(cw[L * SC + row]), d1 = ex2(cw[L * SC + row + 8]);
        sacc[o][0] *= d0;
        sacc[o][1] *= d0;
        sacc[o][2] *= d1;
        sacc[o][3] *= d1;
#pragma unroll
        for (int kk = 0; kk < L / 16; ++kk) {
          uint32_t ah[4], al[4], v2[2];
          ldsm_x4_t(ah, kwh + frag_at(lane, 16 * mt, 16 * kk, SD));
          ldsm_x4_t(al, kwl + frag_at(lane, 16 * mt, 16 * kk, SD));
          ldsm_x2_t(v2, vs + frag_bkn(lane, 16 * kk, 8 * nt, SV));
          mma_bf16(sacc[o], ah, v2[0], v2[1]);
          mma_bf16(sacc[o], al, v2[0], v2[1]);
        }
        uint32_t hi, lo;
        split2(sacc[o][0], sacc[o][1], hi, lo);
        *reinterpret_cast<uint32_t*>(shi + row * SV + c) = hi;
        *reinterpret_cast<uint32_t*>(slo + row * SV + c) = lo;
        split2(sacc[o][2], sacc[o][3], hi, lo);
        *reinterpret_cast<uint32_t*>(shi + (row + 8) * SV + c) = hi;
        *reinterpret_cast<uint32_t*>(slo + (row + 8) * SV + c) = lo;
      }
    }
  }
}

template <int DP>
int launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::BYTES;
  static_assert(smem <= 232448, "wkv6: shared memory above 227 KB");
  cudaFuncSetAttribute(chunk_kernel<DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.d + Layout<DP>::VT - 1) / Layout<DP>::VT,
                  p.batch * p.heads);
  chunk_kernel<DP><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    if (p.d <= 16) return launch_chunked<16>(p, stream);
    if (p.d <= 32) return launch_chunked<32>(p, stream);
    if (p.d <= 64) return launch_chunked<64>(p, stream);
    return launch_chunked<128>(p, stream);
  }
  if (p.d <= 16) return launch_exact<16>(p, stream);
  if (p.d <= 32) return launch_exact<32>(p, stream);
  if (p.d <= 64) return launch_exact<64>(p, stream);
  return launch_exact<128>(p, stream);
}

}  // namespace

// dtype: 0 float32 (the exact sequential kernel), 1 bfloat16 (the chunked
// kernel), for r, k, v, w and y; u is float32 (H, D), contiguous.
// strides: 20 element strides, (batch, t, head, dim) of r, k, v, w and y
// in that order; y's last stride is 1.  The caller checks shapes (d a
// multiple of 8 up to 128, batch * heads <= 65535).  Returns
// cudaGetLastError() after the launch.
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
  const void* base[4] = {r, k, v, w};
  for (int a = 0; a < 4; ++a)
    p.vec[a] = recurrence::segments_aligned(base[a], p.st[a]);
  if (batch < 1 || steps < 1 || heads < 1) return 0;
  return dispatch(p, dtype, static_cast<cudaStream_t>(stream));
}
