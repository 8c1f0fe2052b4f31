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
// or bfloat16, head_dim d <= 128 and a multiple of 8.
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
// Design (simple first; no wgmma or TMA yet).  One CTA of 256 threads per
// (b*h, 64-row query tile); a loop over 64-key tiles takes the place of the
// TPU's sequential grid axis, and visits only the key tiles that hold a
// valid key of some row of the query tile: tiles wholly in the causal
// future or wholly before the window are skipped.  Q (transposed), K
// (transposed), V and the probabilities P live in shared memory as float32
// (115,712 bytes at d = 128, set with cudaFuncSetAttribute; two CTAs fit an
// SM).  Each thread owns a 4 x 4 block of the 64 x 64 score tile (S = Q K^T
// with float4 reads along the key and query axes, conflict-free) and 4 rows
// x 8 head-dim columns of the output accumulator; the online-softmax row
// max and sum reduce over the 16 lanes that share a row with shuffles.
// Query tiles run last-first, so the causal tiles with the most key tiles
// start first.
//
// Bound: at the serving shapes (B = 1, H = 16, S = 2048, d = 128, causal)
// the work is 4 B H S^2 d / 2 = 17.2 GFLOP against 33.6 MB of q, k, v and
// out: operations bound, 0.017 ms at the card's 989 TFLOP/s bf16 tensor
// rate.  This kernel runs its products on the float32 SIMT units (67
// TFLOP/s peak), so it cannot pass ~7 % of that bound; the tensor-core
// (wgmma) redesign is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per tile
constexpr int DMAX = 128;         // largest head_dim
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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
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
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
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

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
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
      for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
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
        for (int c = 0; c < 2; ++c) {
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
    for (int c = 0; c < 2; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < d) {
        const float y[4] = {acc[r][c * 4] * inv, acc[r][c * 4 + 1] * inv,
                            acc[r][c * 4 + 2] * inv, acc[r][c * 4 + 3] * inv};
        store4(ob + qi * p.o_ss + col, y);
      }
    }
  }
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p.d) * (BQ + 2 * BK) + BQ * PS);
  static bool attr_set = false;    // once per element type
  if (!attr_set) {
    const size_t most = sizeof(float) * (DMAX * (BQ + 2 * BK) + BQ * PS);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((p.q_len + BQ - 1) / BQ, batch * p.heads);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, q_len, d), k and v (B, KH, kv_len, d), out (B, H, q_len, d), each
// given by its base pointer and its element strides over (batch, head,
// position); the head dim is contiguous.  dtype 0 = float32, 1 = bfloat16.
// Pointers and strides must keep 8-element rows 16-byte aligned.  Returns
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
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 ||
      q_len < 1 || kv_len < 1 || d < 8 || d > DMAX || d % 8 != 0 ||
      static_cast<long long>(batch) * heads > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q, k, v, out, heads, kv_heads, q_len, kv_len, d,
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, batch, s)
                    : launch<__nv_bfloat16>(p, batch, s);
}
