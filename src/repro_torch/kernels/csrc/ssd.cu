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
// is then never materialized per head.  T is any length >= 1.  y comes back
// in x's dtype, contiguous.  P and N are multiples of 8, at most 128.
//
// Replaces: src/repro/kernels/ssd/ssd.py::ssd_hmajor (ssd.py:76, body
// _ssd_kernel :27-63), reached through ops.ssd from layers/mamba.py's
// kernel mode (the planner's ssd_pallas impl).  The TPU kernel computes the
// same function in its chunked matmul form on the MXU, carrying H in VMEM
// scratch across a sequential chunk grid axis.
//
// bfloat16 (the served prefills' dtype): that chunked form on the tensor
// cores (chunk_kernel).  Per chunk of L = 64 steps, cum the inclusive
// cumsum of log2 max(a, 1e-37) inside the chunk (never across chunks, so
// every exponent below is <= 0 and an underflow to 0 is the right value):
//
//   G     = C B^T                                (L x L over N)  mma
//   M     = G o 2^(cum_t - cum_s) [s <= t]                      CUDA cores
//   Y     = M X + 2^cum_t (C H_in)               (L x P)         mma
//   H_out = 2^cum_L H_in + B^T (2^(cum_L - cum_s) X)  (N x P)    mma
//
// Layout: one CTA of four warps per (b*h, tile of 32 columns of P): column
// p of H depends only on x[:, p], so the tiles share nothing and need no
// workspace.  Warp w owns rows [16 w, 16 w + 16) of a chunk (its G, M and
// Y) and 1/4 of H's 16 x 8 tiles, which it keeps in float32 registers
// across chunks.  The CTA walks the chunks in order; the next chunk's x, b
// and c tiles are in flight (cp.async, zero-filled past T, N and P) while
// the current one computes.  At zamba2-7b's width (H = 112, P = N = 64) a
// batch-1 prefill runs 224 CTAs, two to an SM (67.5 KB of shared memory
// each; tiles of 64 columns, 112 CTAs one to an SM, ran slower: the
// kernel is latency bound).  G is not shared across heads although
// zamba2's b and c are: each CTA recomputes its chunk's G, 1/8 of its
// tensor-core work, so that no CTA waits on another.
//
// Precision.  x, b and c enter the tensor cores as they are (bf16, exact);
// every product accumulates in float32.  The float32 operands M, H_in and
// 2^(cum_L - cum_s) X are each split into two bf16 terms, hi + lo (16 bits
// of mantissa, relative error <= 2^-17, recurrence.cuh split2), and
// multiplied twice, so the result is float32-accurate to ~1e-5 of y's
// scale: one bf16 rounding of M (2^-9) would move y by ~1e-3 of its scale
// and leave the 1e-2 tolerance at small |y|.  H stays float32.
//
// float32: the exact sequential recurrence (exact_kernel), its 1e-4
// tolerance being beyond the bf16 split's reach at large |y|: one warp per
// (b*h, 32 columns of P), a thread per column holding H[:, p] in registers,
// a, b, c and x of 32 steps staged in shared memory.
//
// Bound (B = 1, T = 2048, H = 112, P = N = 64, bf16 I/O, b and c read once,
// not per head): 60 MB, 0.018 ms at 3.35 TB/s.  The chunked form's matrix
// products (per chunk of L and head: M X, L (L + 1) P; C H_in and the
// state update, 2 L N P each; G = C B^T, L (L + 1) N, once per batch since
// b and c are shared), 4.7 GFLOP, take 0.005 ms at the 989 TFLOP/s bf16
// rate, its other operations (decays, scalings) 0.001 ms at 67 TFLOP/s:
// bytes bound.  (The sequential form's 5 N P operations a step at the
// float32 rate, 0.070 ms, bounded the sequential kernel; chip_smoke.py
// computes both.)  What keeps the kernel above its bound: each CTA walks
// 32 chunks in order, and a chunk's steps (G, M, Y, the state update)
// depend on each other through shared memory and two barriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace recurrence;

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
  bool vec[4];  // x, -, b, c: every 8-element row segment 16-byte aligned
};

// ---- float32: the exact sequential recurrence ---------------------------

constexpr int COLS = 32;  // columns of P (threads) per CTA
constexpr int LS = 32;    // steps staged in shared memory at a time

template <int NM>
__global__ void __launch_bounds__(COLS) exact_kernel(const Params p) {
  using T = float;
  constexpr int Q = (NM + COLS - 1) / COLS;  // a thread's elements a row
  constexpr int LB = 16 / Q;                 // steps loaded per batch
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // [LS][NM]
  float* c_s = b_s + LS * NM;                    // [LS][NM]
  float* x_s = c_s + LS * NM;                    // [LS][COLS]
  float* a_s = x_s + LS * COLS;                   // [LS]

  const int bh = blockIdx.y;
  const int bb = bh / p.heads, h = bh % p.heads;
  const int tid = threadIdx.x;
  const int col = blockIdx.x * COLS + tid;
  const bool live = col < p.p;
  const int n_st = p.n;

  float hs[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) hs[i] = 0.f;

  for (int t0 = 0; t0 < p.steps; t0 += LS) {
    const int n = min(LS, p.steps - t0);
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


template <int NM>
int launch_exact(const Params& p, cudaStream_t stream) {
  const int smem = (2 * LS * NM + LS * COLS + LS) * (int)sizeof(float);
  cudaFuncSetAttribute(exact_kernel<NM>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.p + COLS - 1) / COLS, p.batch * p.heads);
  exact_kernel<NM><<<grid, COLS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: the chunked form on the tensor cores ---------------------

constexpr int L = 64;              // steps per chunk
constexpr int WARPS = 4;           // warp w owns rows [16 w, 16 w + 16)
constexpr int THREADS = 32 * WARPS;
constexpr int PT = 32;             // columns of P per CTA
constexpr int SP = PT + 8;         // row stride of the [.][P] tiles: +16 B
                                   // keeps ldmatrix free of bank conflicts

// shared memory, in bf16 elements, then the float32 arrays
template <int NP>
struct Layout {
  static constexpr int SN = NP + 8;               // row stride of [.][N]
  static constexpr int X = 0;                     // [2][L][SP]  x (2 bufs)
  static constexpr int B = X + 2 * L * SP;        // [2][L][SN]  b
  static constexpr int C = B + 2 * L * SN;        // [2][L][SN]  c
  static constexpr int XW = C + 2 * L * SN;       // [2][L][SP]  x w hi, lo
  static constexpr int H = XW + 2 * L * SP;       // [2][NP][SP] H hi, lo
  static constexpr int END = H + 2 * NP * SP;
  // then float [2][L] log2 a, [WARPS][L] each warp's cum
  static constexpr int BYTES = END * 2 + (2 * L + WARPS * L) * 4;
  static constexpr int OWN = NP / 16 * (PT / 8) / WARPS;  // H tiles a warp
};

template <int NP>
__global__ void __launch_bounds__(THREADS) chunk_kernel(const Params p) {
  using Ly = Layout<NP>;
  constexpr int SN = Ly::SN;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* la = reinterpret_cast<float*>(sm + Ly::END);  // [2][L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  float* cum = la + 2 * L + warp * L;  // this warp's copy

  const int bh = blockIdx.y, bb = bh / p.heads, h = bh % p.heads;
  const int col0 = blockIdx.x * PT;
  const int T = p.steps;
  const long long *sx = p.st[0], *sa = p.st[1], *sb = p.st[2],
                  *sc = p.st[3], *sy = p.st[4];
  const bf16* xg = static_cast<const bf16*>(p.x) + bb * sx[0] + h * sx[2];
  const bf16* ag = static_cast<const bf16*>(p.a) + bb * sa[0] + h * sa[2];
  const bf16* bg = static_cast<const bf16*>(p.b) + bb * sb[0] + h * sb[2];
  const bf16* cg = static_cast<const bf16*>(p.c) + bb * sc[0] + h * sc[2];
  bf16* yg = static_cast<bf16*>(p.y) + bb * sy[0] + h * sy[2];

  // the x, b and c tiles of the chunk at t0 into buffer buf
  auto load = [&](int t0, int buf) {
    for (int i = tid; i < L * (PT / 8); i += THREADS) {
      const int r = i / (PT / 8), c = 8 * (i % (PT / 8));
      const int t = t0 + r;
      row8(sm + Ly::X + (buf * L + r) * SP + c,
           xg + t * sx[1] + (col0 + c) * sx[3], t < T && col0 + c < p.p,
           p.vec[0], sx[3], xg);
    }
    for (int i = tid; i < L * (NP / 8); i += THREADS) {
      const int r = i / (NP / 8), c = 8 * (i % (NP / 8));
      const int t = t0 + r;
      const bool ok = t < T && c < p.n;
      row8(sm + Ly::B + (buf * L + r) * SN + c, bg + t * sb[1] + c * sb[3],
           ok, p.vec[2], sb[3], bg);
      row8(sm + Ly::C + (buf * L + r) * SN + c, cg + t * sc[1] + c * sc[3],
           ok, p.vec[3], sc[3], cg);
    }
  };
  // log2 a_t (0 past T: a = 1 changes nothing)
  auto log2a = [&](int t) {
    return t < T ? lg2(fmaxf(__bfloat162float(ag[t * sa[1]]), 1e-37f)) : 0.f;
  };

  load(0, 0);
  cp_commit();
  if (tid < L) la[tid] = log2a(tid);
  for (int i = tid; i < 2 * NP * SP; i += THREADS)
    sm[Ly::H + i] = __float2bfloat16_rn(0.f);
  float hacc[Ly::OWN][4];
#pragma unroll
  for (int o = 0; o < Ly::OWN; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[o][e] = 0.f;

  bf16* xwh = sm + Ly::XW;
  bf16* xwl = xwh + L * SP;
  bf16* hh = sm + Ly::H;
  bf16* hl = hh + NP * SP;
  const int r0 = 16 * warp;
  const int nch = (T + L - 1) / L;
  for (int k = 0; k < nch; ++k) {
    const int buf = k & 1, t0 = k * L;
    cp_wait_all();
    __syncthreads();  // chunk k and H_in in shared memory; chunk k - 1 done
    if (k + 1 < nch) {
      load(t0 + L, buf ^ 1);
      cp_commit();
    }
    const float la_next = tid < L ? log2a(t0 + L + tid) : 0.f;
    const bf16* xs = sm + Ly::X + buf * L * SP;
    const bf16* bs = sm + Ly::B + buf * L * SN;
    const bf16* cs = sm + Ly::C + buf * L * SN;

    // cum: a warp-wide inclusive scan of the chunk's 64 log2 a
    {
      float v0 = la[buf * L + lane], v1 = la[buf * L + 32 + lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(FULL, v0, o);
        const float u1 = __shfl_up_sync(FULL, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(FULL, v0, 31);
      cum[lane] = v0;
      cum[32 + lane] = v1;
      __syncwarp();
    }
    const float cum_g = cum[r0 + g], cum_g8 = cum[r0 + g + 8];
    const float cum_end = cum[L - 1];

    // this warp's 16 rows of C, as A fragments over N
    uint32_t cf[NP / 16][4];
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      ldsm_x4(cf[kk], cs + frag_a(lane, r0, 16 * kk, SN));

    // Y = 2^cum_t (C H_in): H_in as hi + lo
    float y[PT / 8][4];
#pragma unroll
    for (int j = 0; j < PT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
#pragma unroll
      for (int pp = 0; pp < PT / 16; ++pp) {
        uint32_t hi[4], lo[4];
        ldsm_x4_t(hi, hh + frag_bkn(lane, 16 * kk, 16 * pp, SP));
        ldsm_x4_t(lo, hl + frag_bkn(lane, 16 * kk, 16 * pp, SP));
        mma_bf16(y[2 * pp], cf[kk], hi[0], hi[1]);
        mma_bf16(y[2 * pp + 1], cf[kk], hi[2], hi[3]);
        mma_bf16(y[2 * pp], cf[kk], lo[0], lo[1]);
        mma_bf16(y[2 * pp + 1], cf[kk], lo[2], lo[3]);
      }
    }
    {
      const float e0 = ex2(cum_g), e1 = ex2(cum_g8);
#pragma unroll
      for (int j = 0; j < PT / 8; ++j) {
        y[j][0] *= e0;
        y[j][1] *= e0;
        y[j][2] *= e1;
        y[j][3] *= e1;
      }
    }

    // G = C B^T on the column tiles s <= this warp's last row; then
    // M = G o 2^(cum_t - cum_s) [s <= t] and Y += M X, M as hi + lo
    {
      float gm[L / 8][4];
#pragma unroll
      for (int j = 0; j < L / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gm[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NP / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < L / 16; ++jp) {
          if (jp <= warp) {
            uint32_t b4[4];
            ldsm_x4(b4, bs + frag_bnk(lane, 16 * jp, 16 * kk, SN));
            mma_bf16(gm[2 * jp], cf[kk], b4[0], b4[1]);
            mma_bf16(gm[2 * jp + 1], cf[kk], b4[2], b4[3]);
          }
        }
      }
      const int t1 = r0 + g, t2 = t1 + 8;
#pragma unroll
      for (int jp = 0; jp < L / 16; ++jp) {
        if (jp <= warp) {
          float m[2][4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = 16 * jp + 8 * half + 2 * q + e;
              const float cs_ = cum[s];
              const float g1 = gm[2 * jp + half][e] * ex2(cum_g - cs_);
              const float g2 = gm[2 * jp + half][2 + e] * ex2(cum_g8 - cs_);
              m[half][e] = s <= t1 ? g1 : 0.f;
              m[half][2 + e] = s <= t2 ? g2 : 0.f;
            }
          }
          uint32_t mh[4], ml[4];
          split2(m[0][0], m[0][1], mh[0], ml[0]);
          split2(m[0][2], m[0][3], mh[1], ml[1]);
          split2(m[1][0], m[1][1], mh[2], ml[2]);
          split2(m[1][2], m[1][3], mh[3], ml[3]);
#pragma unroll
          for (int pp = 0; pp < PT / 16; ++pp) {
            uint32_t x4[4];
            ldsm_x4_t(x4, xs + frag_bkn(lane, 16 * jp, 16 * pp, SP));
            mma_bf16(y[2 * pp], mh, x4[0], x4[1]);
            mma_bf16(y[2 * pp + 1], mh, x4[2], x4[3]);
            mma_bf16(y[2 * pp], ml, x4[0], x4[1]);
            mma_bf16(y[2 * pp + 1], ml, x4[2], x4[3]);
          }
        }
      }
    }

    // y rows of this warp, bf16 pairs
#pragma unroll
    for (int j = 0; j < PT / 8; ++j) {
      const int col = col0 + 8 * j + 2 * q;
      const int t1 = t0 + r0 + g, t2 = t1 + 8;
      if (col < p.p) {
        if (t1 < T) store2(yg + t1 * sy[1] + col, y[j][0], y[j][1]);
        if (t2 < T) store2(yg + t2 * sy[1] + col, y[j][2], y[j][3]);
      }
    }

    // 2^(cum_L - cum_s) x_s as hi + lo, this warp's rows s
    for (int i = lane; i < 16 * PT / 2; i += 32) {
      const int s = r0 + i / (PT / 2), c = 2 * (i % (PT / 2));
      const float w = ex2(cum_end - cum[s]);
      const float2 xv = ld2(xs + s * SP + c);
      uint32_t hi, lo;
      split2(xv.x * w, xv.y * w, hi, lo);
      *reinterpret_cast<uint32_t*>(xwh + s * SP + c) = hi;
      *reinterpret_cast<uint32_t*>(xwl + s * SP + c) = lo;
    }
    if (tid < L) la[(buf ^ 1) * L + tid] = la_next;
    __syncthreads();  // x w complete; every warp is past its H_in reads

    // H_out = 2^cum_L H_in + B^T (x w) on this warp's tiles of H, then
    // H_out as hi + lo for the next chunk
    const float dec = ex2(cum_end);
#pragma unroll
    for (int o = 0; o < Ly::OWN; ++o) {
      const int u = warp * Ly::OWN + o;
      const int mt = u / (PT / 8), nt = u % (PT / 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[o][e] *= dec;
#pragma unroll
      for (int kk = 0; kk < L / 16; ++kk) {
        uint32_t a4[4], hi[2], lo[2];
        ldsm_x4_t(a4, bs + frag_at(lane, 16 * mt, 16 * kk, SN));
        ldsm_x2_t(hi, xwh + frag_bkn(lane, 16 * kk, 8 * nt, SP));
        ldsm_x2_t(lo, xwl + frag_bkn(lane, 16 * kk, 8 * nt, SP));
        mma_bf16(hacc[o], a4, hi[0], hi[1]);
        mma_bf16(hacc[o], a4, lo[0], lo[1]);
      }
      const int row = 16 * mt + g, c = 8 * nt + 2 * q;
      uint32_t hi, lo;
      split2(hacc[o][0], hacc[o][1], hi, lo);
      *reinterpret_cast<uint32_t*>(hh + row * SP + c) = hi;
      *reinterpret_cast<uint32_t*>(hl + row * SP + c) = lo;
      split2(hacc[o][2], hacc[o][3], hi, lo);
      *reinterpret_cast<uint32_t*>(hh + (row + 8) * SP + c) = hi;
      *reinterpret_cast<uint32_t*>(hl + (row + 8) * SP + c) = lo;
    }
  }
}

template <int NP>
int launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<NP>::BYTES;
  cudaFuncSetAttribute(chunk_kernel<NP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.p + PT - 1) / PT, p.batch * p.heads);
  chunk_kernel<NP><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    if (p.n <= 16) return launch_chunked<16>(p, stream);
    if (p.n <= 32) return launch_chunked<32>(p, stream);
    if (p.n <= 64) return launch_chunked<64>(p, stream);
    return launch_chunked<128>(p, stream);
  }
  if (p.n <= 16) return launch_exact<16>(p, stream);
  if (p.n <= 32) return launch_exact<32>(p, stream);
  if (p.n <= 64) return launch_exact<64>(p, stream);
  return launch_exact<128>(p, stream);
}

}  // namespace

// dtype: 0 float32 (the exact sequential kernel), 1 bfloat16 (the chunked
// kernel), for x, a, b, c and y.  strides: 20 element strides, (batch, t,
// head, last) of x, a (last unused), b, c and y in that order; y's last
// stride is 1.  The caller checks shapes (p and n multiples of 8 up to
// 128, batch * heads <= 65535).  Returns cudaGetLastError() after the
// launch.
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
  const void* base[4] = {x, a, b, c};
  for (int i = 0; i < 4; ++i)
    p.vec[i] = recurrence::segments_aligned(base[i], p.st[i]);
  if (batch < 1 || steps < 1 || heads < 1) return 0;
  return dispatch(p, dtype, static_cast<cudaStream_t>(stream));
}
