// Blocked online-softmax attention for Hopper (sm_90a), forward only.
//
//   out[b, h, i, :] = softmax_k(mask(q[b,h,i,:] . k[b,g(h),k,:] * scale))
//                     @ v[b, g(h), :, :]
//
// with GQA (q head h reads kv head g(h) = h / (H / KH)), the causal mask
// aligned to the ends (query i sits at position i + kv_len - q_len, as in
// decode), an optional sliding window (key k > pos - window), and the true
// lengths q_len and kv_len masked in-kernel (no padding).  Scores, running
// max, normalizer and accumulator are float32; inputs and output are float32
// or bfloat16, head_dim d <= 256 and a multiple of 8.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::
// _attn_kernel, reached by flash_attention_hmajor (flash_attention.py:119)
// and by ops.py::_call_padded (ops.py:110, behind ops.flash_attention).
// Both become the one C entry below; the Python wrappers pass strides, so
// the (B, S, H, D) layout needs no transposed copy.
//
// A fully-masked query row (only when causal and q_len > kv_len) gets the
// plain mean of v over the kv_len keys, as mha_reference gives it (all its
// logits are -1e30 there, so softmax is uniform).  The TPU kernel gives
// sum(v of the first computed block) / block_k for such a row instead.
//
// Both kernels visit only the key tiles that hold a valid key of some row
// of their query tile (tiles wholly in the causal future or wholly before
// the window are skipped), and run the query tiles last-first, so the
// causal tiles with the most key tiles start first.  grid.x is b * h.
//
// bfloat16: tensor cores (flash_wgmma_kernel).  One CTA of two warpgroups
// per (b * h, 128-row query tile); each warpgroup owns 64 query rows and
// both share the K/V tiles.  The head dim is padded to DP = 64, 128, 192 or
// 256 (TMA zero-fills the columns past d; they are never stored); BK = 128
// keys a tile at DP <= 128, 64 above, so S (BK / 2), O (DP / 2) and P (BK /
// 4 registers) fit the 255 registers of a thread (a producer warp would
// cap them at 168).  Thread 0 loads Q once and the first K / V tiles with
// TMA (128-byte swizzle, see hopper.cuh) into a ring of three stages (two
// at DP = 256), each K and V completing on its own mbarrier; the warp that
// releases a stage last refills it, so the next tiles' copies are in
// flight while the current one computes.  S = Q K^T is wgmma m64nBKk16
// with Q and K from shared memory (both K-major as they lie); S of tile j
// is issued beside P V of tile j - 1, so the mask and the online softmax
// of tile j (in registers, exp2 with scale * log2 e multiplied in; row max
// and sum over the 4 lanes of a quad) overlap that product.  P is rounded
// to bfloat16 in registers and is the register A operand of O += P V, with
// V from shared memory read MN-major (transpose bit): m64n64k16 per 64
// columns up to DP = 128, one m64nDPk16 above.  Shared memory: 128 DP (Q)
// + 4 BK DP a stage, 192 KB at DP = 256: one CTA per SM.
//
// float32: the SIMT kernel (flash_fwd_kernel, exact float32 FMAs: a TF32
// tensor-core product would keep ~3 decimal digits).  One CTA of 256
// threads per (b * h, 64-row query tile); Q (transposed), K (transposed), V
// and the probabilities P live in shared memory as float32 (115,712 bytes
// at d = 128, two CTAs an SM; 214,016 at d = 256, one).  Each thread owns a
// 4 x 4 block of the 64 x 64 score tile and 4 rows x 4 NC head-dim columns
// of the output accumulator (NC = 2 for d <= 128, 4 above).
//
// Bound: at the served shapes (qwen3-0.6b, B = 4, H = 16, S = 2048, d =
// 128, causal) the work is 4 B H d pairs = 68.8 GFLOP against 134 MB of q,
// k, v and out: operations bound, 0.0695 ms at the card's 989 TFLOP/s
// bf16 tensor rate.  The float32 kernel runs on the SIMT units (67 TFLOP/s
// peak) and stays ~7 % of the bf16 bound at best.  Measured by
// chip_smoke.py on an H100 SXM at 700 W: the bf16 kernel 0.250 ms there,
// 28 % of the bound (the SIMT kernel it replaces took 3.05 ms on the same
// bf16 inputs);
// scaled_dot_product_attention 0.177 ms.  A GEMM-only build takes about
// half the time: the softmax is not hidden under the products, and one CTA
// per SM leaves each CTA's loads and epilogue exposed.
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per tile
constexpr int DMAX = 256;         // largest head_dim
constexpr int THREADS = 256;
constexpr int PS = BK + 4;        // padded row stride of the P tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, kv_heads, q_len, kv_len, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The keys [lo, hi] row qi may attend to; a row with none (causal, q_len >
// kv_len) attends uniformly to every key, as mha_reference.
struct Range {
  int lo, hi;
  bool uniform;
};

__device__ __forceinline__ Range row_range(int qi, const Params& p) {
  const int pos = qi + p.kv_len - p.q_len;
  int lo = 0, hi = p.kv_len - 1;
  if (p.causal) hi = min(hi, pos);
  if (p.window > 0) lo = max(lo, pos - p.window + 1);
  if (lo > hi) return {0, p.kv_len - 1, true};
  return {lo, hi, false};
}

// float32, NC x 64 head-dim columns (d <= 64 NC)
template <int NC>
__global__ void __launch_bounds__(THREADS, NC == 2 ? 2 : 1)
flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = p.d;
  float* qt = smem;                // [d][BQ]   Q transposed
  float* kt = qt + d * BQ;         // [d][BK]   K transposed
  float* vs = kt + d * BK;         // [BK][d]
  float* ps = vs + BK * d;         // [BQ][PS]  probabilities

  const int tid = threadIdx.x;
  const int ty = tid >> 4;         // rows ty*4 .. ty*4+3
  const int tx = tid & 15;         // score columns tx*4 ..; out cols tx*4+64c
  const int n_qt = (p.q_len + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);

  const float* qb =
      static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb =
      static_cast<const float*>(p.k) + b * p.k_sb + g * p.k_sh;
  const float* vb =
      static_cast<const float*>(p.v) + b * p.v_sb + g * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int d8 = d / 8;

  // Q tile, transposed; rows past q_len are zeros
  for (int idx = tid; idx < BQ * d8; idx += THREADS) {
    const int i = idx % BQ, c8 = idx / BQ;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + i < p.q_len) load8(qb + (q0 + i) * p.q_ss + c8 * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) qt[(c8 * 8 + e) * BQ + i] = x[e];
  }

  // each thread's rows; rows past q_len attend to every key (never stored)
  int lo[4], hi[4];
  bool uni[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    Range rr = (qi < p.q_len) ? row_range(qi, p)
                              : Range{0, p.kv_len - 1, false};
    lo[r] = rr.lo;
    hi[r] = rr.hi;
    uni[r] = rr.uniform;
  }
  // the CTA's keys: lo and hi grow with the row, uniform rows come first
  const Range first = row_range(q0, p);
  const Range last = row_range(min(q0 + BQ, p.q_len) - 1, p);
  const int k_begin = first.uniform ? 0 : first.lo;
  const int k_end = first.uniform ? p.kv_len - 1 : last.hi;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 <= k_end; k0 += BK) {
    __syncthreads();               // the last tile's kt / vs / ps are read
    // K tile transposed (lanes walk keys: conflict-free stores)
    for (int idx = tid; idx < BK * d8; idx += THREADS) {
      const int j = idx % BK, c8 = idx / BK;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < p.kv_len) load8(kb + (k0 + j) * p.k_ss + c8 * 8, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(c8 * 8 + e) * BK + j] = x[e];
    }
    // V tile row-major (lanes walk the head dim: coalesced)
    for (int idx = tid; idx < BK * d8; idx += THREADS) {
      const int c8 = idx % d8, j = idx / d8;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k0 + j < p.kv_len) load8(vb + (k0 + j) * p.v_ss + c8 * 8, x);
      store4(vs + j * d + c8 * 8, x);
      store4(vs + j * d + c8 * 8 + 4, x + 4);
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(qt + dd * BQ + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(kt + dd * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], kv[c], s[r][c]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx * 4 + c;
        const bool ok = key >= lo[r] && key <= hi[r];
        s[r][c] = ok ? (uni[r] ? 0.f : s[r][c] * p.scale) : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[r] - m_new);        // 0 while the row saw no key
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - m_new);  // masked keys: exp(-inf) = 0
          sum += s[r][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[r][c] *= alpha;
      store4(ps + (ty * 4 + r) * PS + tx * 4, s[r]);
    }
    __syncthreads();

    // O += P V
    for (int j = 0; j < BK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            ps + (ty * 4 + r) * PS + j);
        pr[r][0] = x.x; pr[r][1] = x.y; pr[r][2] = x.z; pr[r][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx * 4 + 64 * c;
          if (col < d) {
            const float4 x = *reinterpret_cast<const float4*>(
                vs + (j + jj) * d + col);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][c * 4 + 0] = fmaf(pr[r][jj], x.x, acc[r][c * 4 + 0]);
              acc[r][c * 4 + 1] = fmaf(pr[r][jj], x.y, acc[r][c * 4 + 1]);
              acc[r][c * 4 + 2] = fmaf(pr[r][jj], x.z, acc[r][c * 4 + 2]);
              acc[r][c * 4 + 3] = fmaf(pr[r][jj], x.w, acc[r][c * 4 + 3]);
            }
          }
        }
      }
    }
  }

  // every stored row saw at least one key, so l > 0
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= p.q_len) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d) {
        const float y[4] = {acc[r][c * 4] * inv, acc[r][c * 4 + 1] * inv,
                            acc[r][c * 4 + 2] * inv, acc[r][c * 4 + 3] * inv};
        store4(ob + qi * p.o_ss + col, y);
      }
    }
  }
}

// ------------------------------------------------------ bfloat16, wgmma

constexpr int WQ = 128;           // query rows per CTA (two warpgroups)
constexpr int WG_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct Wg {
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys per tile
  static constexpr int NCH = DP / 64;              // 64-column chunks
  static constexpr int Q_BYTES = WQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;     // one K (or V) stage
  // three K/V stages where they fit the 227 KB of a block, else two
  static constexpr int STAGES =
      Q_BYTES + 6 * KV_BYTES + 1024 + 128 <= 232448 ? 3 : 2;
  // Q, the K and V stages, mbarriers and release counters, 1024 for
  // alignment
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T over the padded head dim: m64nBKk16 per k step, Q and K
// K-major from shared memory
template <int DP>
__device__ __forceinline__ void issue_s(float (&sacc)[Wg<DP>::BK / 2],
                                        uint32_t q_base, uint32_t k_base) {
  constexpr int BKW = Wg<DP>::BK;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = hopper::desc_sw128(
        q_base + (kk >> 2) * WQ * 128 + (kk & 3) * 32, 16, 1024);
    const uint64_t db = hopper::desc_sw128(
        k_base + (kk >> 2) * BKW * 128 + (kk & 3) * 32, 16, 1024);
    if constexpr (BKW == 128)
      hopper::wgmma_m64n128k16_ss<0>(sacc, da, db, kk > 0);
    else
      hopper::wgmma_m64n64k16_ss<0>(sacc, da, db, kk > 0);
  }
}

// O += P V: P the register A operand, V MN-major from shared memory.  Up
// to d = 128, 64 output columns per instruction; above, one m64nDPk16 per
// k step spans the chunks, LBO = BK * 128 bytes apart (o[c][i] is column
// block 8 c + i / 4 of the wide accumulator, the same registers).
template <int DP>
__device__ __forceinline__ void issue_pv(
    float (&o)[Wg<DP>::NCH][32], const uint32_t (&pa)[Wg<DP>::BK / 16][4],
    uint32_t v_base) {
  constexpr int BKW = Wg<DP>::BK;
  float (&wide)[DP / 2] = *reinterpret_cast<float (*)[DP / 2]>(&o[0][0]);
#pragma unroll
  for (int kk = 0; kk < BKW / 16; ++kk) {
    if constexpr (DP == 192) {
      hopper::wgmma_m64n192k16_rs<1>(
          wide, pa[kk],
          hopper::desc_sw128(v_base + kk * 16 * 128, BKW * 128, 1024), 1);
    } else if constexpr (DP == 256) {
      hopper::wgmma_m64n256k16_rs<1>(
          wide, pa[kk],
          hopper::desc_sw128(v_base + kk * 16 * 128, BKW * 128, 1024), 1);
    } else {
#pragma unroll
      for (int c = 0; c < Wg<DP>::NCH; ++c)
        hopper::wgmma_m64n64k16_rs<1>(
            o[c], pa[kk],
            hopper::desc_sw128(v_base + c * BKW * 128 + kk * 16 * 128,
                               BKW * 128, 1024),
            1);
    }
  }
}

// The thread's two rows of one key tile: mask, then the online softmax in
// the log2 domain.  sacc[4 jj + e] is row gr + 8 (e / 2), key k0 + 8 jj + 2
// tq4 + e % 2; on return it holds p = 2^(x - m), alpha the factor that
// rescales the rows' earlier sums, and l this lane's share of the row sums
// (quad-summed at the end).
template <int BKW, bool MASKED>
__device__ __forceinline__ void softmax_tile(
    float (&sacc)[BKW / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int tq4, const int (&lo)[2], const int (&hi)[2],
    const bool (&uni)[2], float sl2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < BKW / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sacc[4 * jj + e] * sl2;
      if (MASKED) {
        const int key = k0 + 8 * jj + 2 * tq4 + (e & 1);
        const bool ok = key >= lo[r] && key <= hi[r];
        x = ok ? (uni[r] ? 0.f : x) : -INFINITY;
      }
      sacc[4 * jj + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row that saw no key yet keeps m = -inf, l = 0, o = 0
    const float mu = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m[r] - mu);
    m[r] = m_new;
    mx[r] = mu;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int jj = 0; jj < BKW / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(sacc[4 * jj + e] - mx[e >> 1]);
      sacc[4 * jj + e] = pe;
      l[e >> 1] += pe;
    }
}

// P in bfloat16 as the m64k16 A fragments: the accumulator layout of keys
// 16 kk .. 16 kk + 15 is the A layout of k step kk
template <int BKW>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKW / 16][4],
                                       const float (&sacc)[BKW / 2]) {
#pragma unroll
  for (int kk = 0; kk < BKW / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = hopper::pack_bf16(sacc[8 * kk + 2 * i],
                                    sacc[8 * kk + 2 * i + 1]);
}

template <int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Wg<DP>;
  constexpr int BKW = C::BK, NCH = C::NCH, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + C::Q_BYTES;             // [S][NCH][BK][64]
  uint8_t* sv = sk + S * C::KV_BYTES;        // [S][NCH][BK][64]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + S * C::KV_BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + S;
  unsigned* released = reinterpret_cast<unsigned*>(full_v + S);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_qt = (p.q_len + WQ - 1) / WQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * WQ;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);

  // the CTA's keys: lo and hi grow with the row, uniform rows come first
  const Range first = row_range(q0, p);
  const Range last = row_range(min(q0 + WQ, p.q_len) - 1, p);
  const int k_begin = first.uniform ? 0 : first.lo;
  const int k_end = first.uniform ? p.kv_len - 1 : last.hi;
  const int t0 = k_begin / BKW;
  const int n_tiles = k_end / BKW - t0 + 1;

  // key tile j into ring stage j % S
  auto load = [&](int j) {
    const int s = j % S, k0 = (t0 + j) * BKW;
    hopper::mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      hopper::tma_load_4d(sk + s * C::KV_BYTES + c * BKW * 128, &tk,
                          &full_k[s], c * 64, k0, g, b);
    hopper::mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      hopper::tma_load_4d(sv + s * C::KV_BYTES + c * BKW * 128, &tv,
                          &full_v[s], c * 64, k0, g, b);
  };
  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
      released[i] = 0;
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {                    // Q once, the first S key tiles
    hopper::mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      hopper::tma_load_4d(sq + c * WQ * 128, &tq, bar_q, c * 64, q0, h, b);
    for (int j = 0; j < S && j < n_tiles; ++j) load(j);
  }
  // Each of the eight warps releases each tile once it has read it; the
  // warp that releases last refills the stage with tile j + S.  A warp
  // releases its tiles in order, and only after their loads completed, so
  // the stage's uses never mix.
  auto release = [&](int j) {
    if (lane == 0) {
      __threadfence_block();
      const unsigned n = atomicAdd(&released[j % S], 1u);
      if ((n & 7u) == 7u && j + S < n_tiles) load(j + S);
    }
    __syncwarp();
  };

  // warpgroup wg owns rows q0 + wg * 64 ..; rows past q_len attend to
  // every key (never stored)
  const int wg = warp >> 2, wq = warp & 3;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int w0 = q0 + wg * 64;
  const bool wg_rows = w0 < p.q_len;
  const Range wf = row_range(wg_rows ? w0 : 0, p);
  const Range wl = row_range(min(w0 + 63, p.q_len - 1), p);
  int lo[2], hi[2];
  bool uni[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w0 + wq * 16 + gr + 8 * r;
    const Range rr = qi < p.q_len ? row_range(qi, p)
                                  : Range{0, p.kv_len - 1, false};
    lo[r] = rr.lo;
    hi[r] = rr.hi;
    uni[r] = rr.uniform;
  }
  // the warpgroup's key tiles [ja, jb] of the CTA's n_tiles
  const int ja = wg_rows ? (wf.uniform ? 0 : wf.lo) / BKW - t0 : n_tiles;
  const int jb = wg_rows ? (wf.uniform ? p.kv_len - 1 : wl.hi) / BKW - t0
                         : n_tiles - 1;
  // a tile outside them: wait for it (so the ring stays in order), free it
  auto pass = [&](int j) {
    const int s = j % S;
    hopper::mbar_wait(&full_k[s], (j / S) & 1);
    hopper::mbar_wait(&full_v[s], (j / S) & 1);
    release(j);
  };

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float sacc[BKW / 2];
  uint32_t pa[BKW / 16][4];
  const float sl2 = p.scale * LOG2E;
  const uint32_t q_base = hopper::smem_u32(sq) + wg * 64 * 128;
  const uint32_t k_smem = hopper::smem_u32(sk);
  const uint32_t v_smem = hopper::smem_u32(sv);
  // the mask only where a row of the warpgroup has an invalid key in the
  // tile
  auto softmax = [&](int j) {
    const int k0 = (t0 + j) * BKW;
    if (wf.uniform || k0 < wl.lo || k0 + BKW - 1 > wf.hi)
      softmax_tile<BKW, true>(sacc, m, l, alpha, k0, tq4, lo, hi, uni, sl2);
    else
      softmax_tile<BKW, false>(sacc, m, l, alpha, k0, tq4, lo, hi, uni, sl2);
  };

  for (int j = 0; j < ja; ++j) pass(j);
  if (ja <= jb) {
    hopper::mbar_wait(bar_q, 0);
    {                                // the first tile: S, softmax, P
      const int s = ja % S;
      hopper::mbar_wait(&full_k[s], (ja / S) & 1);
      hopper::wgmma_fence();
      issue_s<DP>(sacc, q_base, k_smem + s * C::KV_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sacc);
      softmax(ja);
      pack_p<BKW>(pa, sacc);
    }
    // S of tile j runs beside P V of tile j - 1; the softmax of tile j
    // overlaps that P V
    for (int j = ja + 1; j <= jb; ++j) {
      const int s = j % S, sp = (j - 1) % S;
      hopper::mbar_wait(&full_k[s], (j / S) & 1);
      hopper::mbar_wait(&full_v[sp], ((j - 1) / S) & 1);
#pragma unroll
      for (int c = 0; c < NCH; ++c) hopper::fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) hopper::fence_regs(pa[kk]);
      hopper::wgmma_fence();
      issue_s<DP>(sacc, q_base, k_smem + s * C::KV_BYTES);
      hopper::wgmma_commit();
      issue_pv<DP>(o, pa, v_smem + sp * C::KV_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();       // S is done, P V may still run
      hopper::fence_regs(sacc);
      softmax(j);
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) hopper::fence_regs(pa[kk]);
#pragma unroll
      for (int c = 0; c < NCH; ++c) hopper::fence_regs(o[c]);
      release(j - 1);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      pack_p<BKW>(pa, sacc);
    }
    {                                // the last tile's P V
      const int s = jb % S;
      hopper::mbar_wait(&full_v[s], (jb / S) & 1);
#pragma unroll
      for (int c = 0; c < NCH; ++c) hopper::fence_regs(o[c]);
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) hopper::fence_regs(pa[kk]);
      hopper::wgmma_fence();
      issue_pv<DP>(o, pa, v_smem + s * C::KV_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BKW / 16; ++kk) hopper::fence_regs(pa[kk]);
#pragma unroll
      for (int c = 0; c < NCH; ++c) hopper::fence_regs(o[c]);
      release(jb);
    }
  }
  for (int j = max(ja, jb + 1); j < n_tiles; ++j) pass(j);

  // every stored row saw at least one key, so l > 0
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = w0 + wq * 16 + gr + 8 * r;
    if (qi >= p.q_len) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* orow = ob + qi * p.o_ss;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c * 64 + 8 * jj + 2 * tq4;
        if (col < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * jj + 2 * r] * inv,
                                    o[c][4 * jj + 2 * r + 1] * inv);
      }
  }
}

// ------------------------------------------------------------- launches

template <int NC>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p.d) * (BQ + 2 * BK) + BQ * PS);
  static bool attr_set = false;    // once per instantiation
  if (!attr_set) {
    const size_t most = sizeof(float) * (64 * NC * (BQ + 2 * BK) + BQ * PS);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(batch * p.heads, (p.q_len + BQ - 1) / BQ);
  flash_fwd_kernel<NC><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// q (B, H, S, d) as the 4-d map {d, S, H, B}, boxes of 64 x rows
bool encode(CUtensorMap* map, const void* base, int batch, int heads,
            int len, int d, long long sb, long long sh, long long ss,
            int rows) {
  const long long dims[4] = {d, len, heads, batch};
  const long long strides[3] = {ss, sh, sb};
  const int box[4] = {64, rows, 1, 1};
  return hopper::encode_bf16(map, base, 4, dims, strides, box);
}

template <int DP>
int launch_bf16(const Params& p, int batch, cudaStream_t stream) {
  using C = Wg<DP>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, p.q, batch, p.heads, p.q_len, p.d, p.q_sb, p.q_sh,
              p.q_ss, WQ) ||
      !encode(&tk, p.k, batch, p.kv_heads, p.kv_len, p.d, p.k_sb, p.k_sh,
              p.k_ss, C::BK) ||
      !encode(&tv, p.v, batch, p.kv_heads, p.kv_len, p.d, p.v_sb, p.v_sh,
              p.v_ss, C::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * p.heads, (p.q_len + WQ - 1) / WQ);
  flash_wgmma_kernel<DP><<<grid, WG_THREADS, C::SMEM, stream>>>(tq, tk, tv,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// q (B, H, q_len, d), k and v (B, KH, kv_len, d), out (B, H, q_len, d), each
// given by its base pointer and its element strides over (batch, head,
// position); the head dim is contiguous.  dtype 0 = float32, 1 = bfloat16.
// Pointers must be 16-byte aligned and strides multiples of 8 elements
// (the TMA tensor maps of the bfloat16 kernel need both).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue on arguments
// the kernel does not take).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, void* stream) {
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  bool ok = batch >= 1 && heads >= 1 && kv_heads >= 1 &&
            heads % kv_heads == 0 && q_len >= 1 && kv_len >= 1 && d >= 8 &&
            d <= DMAX && d % 8 == 0 &&
            static_cast<long long>(batch) * heads <= 2147483647LL &&
            (q_len + BQ - 1) / BQ <= 65535 && (dtype == 0 || dtype == 1) &&
            aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  for (long long st : strides) ok = ok && st >= 0 && st % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, heads, kv_heads, q_len, kv_len, d,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return d <= 128 ? launch_f32<2>(p, batch, s) : launch_f32<4>(p, batch, s);
  if (d <= 64) return launch_bf16<64>(p, batch, s);
  if (d <= 128) return launch_bf16<128>(p, batch, s);
  if (d <= 192) return launch_bf16<192>(p, batch, s);
  return launch_bf16<256>(p, batch, s);
}
