// Grouped expert matmul for Hopper (sm_90a), forward only.
//
//   out[e, c, f] = sum_d x[e, c, d] * w[e, d, f]
//
// x (E, C, D) holds each expert's capacity rows after the MoE dispatch, w
// (E, D, F) each expert's weight; the sum is float32 and the output is
// rounded once to x's dtype (float32 or bfloat16; w has x's dtype).  C, D
// and F are the true sizes, masked in-kernel (no padding), and every
// operand is read through the element strides it is given, so a layer's
// slice of a stacked (L, E, D, F) weight tree is read in place.
//
// Replaces: src/repro/kernels/moe_gmm/moe_gmm.py::gmm (moe_gmm.py:49), the
// Pallas kernel behind ops.py::grouped_matmul, which pads C, D and F to its
// 128 tiles and accumulates over the innermost sequential grid axis in a
// VMEM scratch tile.  Here a loop over D inside the block takes the place of
// that grid axis.
//
// Design (simple first; no wgmma, TMA or persistent schedule yet).  One CTA
// per (F tile, C tile, expert).
//   * bfloat16: a 128 x 128 output tile, 8 warps of 64 x 32, warp-level
//     mma.sync.m16n8k16 with float32 accumulators in registers.  D advances
//     32 at a time through two shared-memory buffers of x and w tiles
//     (rows padded by 8 elements, so the ldmatrix row reads are
//     conflict-free); the next tile's global loads are issued before the
//     current tile's products, one barrier a step.  When x and w have a unit
//     inner stride, 8-element-aligned outer strides and D, F multiples of 8,
//     loads are 16-byte vectors; otherwise element by element.
//   * float32: exact float32 FMA on the SIMT units (a TF32 tensor-core
//     product would keep ~3 decimal digits), a 64 x 64 tile, each thread
//     4 x 4 outputs summed over d in ascending order, D 16 at a time.
//
// Bound: at the served bucket 2048 and width 4 (dbrx-132b: E 16, cap 1024
// a row, so C = 4096; D 6144, F 10752) one launch computes 2 E C D F =
// 8.66 TFLOP against 4.33 GB of x, w and out: operations bound, 8.75 ms at
// the card's 989 TFLOP/s bf16 dense rate.  Capacity slots the dispatch
// left empty are zero rows and are computed all the same (the bound counts
// E C rows).  mma.sync reaches at most about two thirds of that rate on
// Hopper (only wgmma reaches the full rate), and this kernel's
// single-stage register staging less; the wgmma / TMA pipeline is the next
// step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bfloat16
constexpr int BM = 128;           // C rows per CTA
constexpr int BN = 128;           // F columns per CTA
constexpr int BK = 32;            // D per step
constexpr int AS = BK + 8;        // padded row of the x tile [BM][AS]
constexpr int BS = BN + 8;        // padded row of the w tile [BK][BS]
constexpr int THREADS = 256;

// ---------------------------------------------------------------- float32
constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;

struct Params {
  const void* x;
  const void* w;
  void* out;
  int experts, c, d, f;
  long long x_se, x_sc, x_sd;
  long long w_se, w_sd, w_sf;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 pack8(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (uint32_t(v[1]) << 16),
                    v[2] | (uint32_t(v[3]) << 16),
                    v[4] | (uint32_t(v[5]) << 16),
                    v[6] | (uint32_t(v[7]) << 16));
}

// One step's share of the global loads of one thread: 2 x 8 elements of
// the x tile and 2 x 8 of the w tile, zero outside C, D and F.
struct Stage {
  uint4 a[2];
  uint4 b[2];
};

template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& s, const Params& p,
                                           const uint16_t* xe,
                                           const uint16_t* we, int c0,
                                           int f0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // x tile: 128 rows x 4 chunks of 8 along d
    const int idx = tid + i * THREADS;
    const int m = idx >> 2, kc = (idx & 3) * 8;
    const int row = c0 + m, k = k0 + kc;
    uint16_t v[8];
    if (VEC) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row < p.c && k < p.d)
        u = *reinterpret_cast<const uint4*>(xe + row * p.x_sc + k);
      s.a[i] = u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (row < p.c && k + j < p.d)
                   ? xe[row * p.x_sc + (k + j) * p.x_sd]
                   : uint16_t(0);
      s.a[i] = pack8(v);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // w tile: 32 rows of d x 16 chunks of 8 along f
    const int idx = tid + i * THREADS;
    const int kk = idx >> 4, nc = (idx & 15) * 8;
    const int k = k0 + kk, col = f0 + nc;
    uint16_t v[8];
    if (VEC) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k < p.d && col < p.f)
        u = *reinterpret_cast<const uint4*>(we + k * p.w_sd + col);
      s.b[i] = u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (k < p.d && col + j < p.f)
                   ? we[k * p.w_sd + (col + j) * p.w_sf]
                   : uint16_t(0);
      s.b[i] = pack8(v);
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& s, uint16_t* as,
                                            uint16_t* bs, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    *reinterpret_cast<uint4*>(as + (idx >> 2) * AS + (idx & 3) * 8) = s.a[i];
    *reinterpret_cast<uint4*>(bs + (idx >> 4) * BS + (idx & 15) * 8) = s.b[i];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const Params p) {
  __shared__ __align__(16) uint16_t as[2][BM * AS];
  __shared__ __align__(16) uint16_t bs[2][BK * BS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64;     // the warp's 64 rows
  const int wn = (warp & 3) * 32;      // and 32 columns
  const int f0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const uint16_t* xe = static_cast<const uint16_t*>(p.x) + e * p.x_se;
  const uint16_t* we = static_cast<const uint16_t*>(p.w) + e * p.w_se;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int steps = (p.d + BK - 1) / BK;
  Stage st;
  if (steps > 0) {
    load_stage<VEC>(st, p, xe, we, c0, f0, 0, tid);
    store_stage(st, as[0], bs[0], tid);
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < steps;
    if (more) load_stage<VEC>(st, p, xe, we, c0, f0, (s + 1) * BK, tid);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm + mi * 16 + (lane & 15);
        const int col = ks + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], smem_addr(as[buf] + row * AS + col));
      }
      uint32_t b[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int krow = ks + (lane & 15);
        const int col = wn + nj * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b[nj], smem_addr(bs[buf] + krow * BS + col));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                   b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (more) store_stage(st, as[buf ^ 1], bs[buf ^ 1], tid);
    __syncthreads();
  }

  // accumulator (mi, ni): rows g and g + 8 of the m16 tile, columns
  // 2 tig and 2 tig + 1 of the n8 tile
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* oe = static_cast<__nv_bfloat16*>(p.out) +
                      static_cast<long long>(e) * p.c * p.f;
  const bool pairs = (p.f & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = c0 + wm + mi * 16 + g + half * 8;
      if (row >= p.c) continue;
      __nv_bfloat16* orow = oe + static_cast<long long>(row) * p.f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = f0 + wn + ni * 8 + tig * 2;
        const float v0 = acc[mi][ni][half * 2];
        const float v1 = acc[mi][ni][half * 2 + 1];
        if (pairs && col + 1 < p.f) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < p.f) orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < p.f) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gmm_f32_kernel(const Params p) {
  __shared__ __align__(16) float as[FK][FM + 4];   // x tile, transposed
  __shared__ __align__(16) float bs[FK][FN + 4];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;          // 4 x 4 outputs each
  const int f0 = blockIdx.x * FN;
  const int c0 = blockIdx.y * FM;
  const int e = blockIdx.z;
  const float* xe = static_cast<const float*>(p.x) + e * p.x_se;
  const float* we = static_cast<const float*>(p.w) + e * p.w_se;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < p.d; k0 += FK) {
#pragma unroll
    for (int i = 0; i < FM * FK / THREADS; ++i) {
      const int idx = tid + i * THREADS;           // lanes walk d
      const int m = idx / FK, kk = idx % FK;
      const int row = c0 + m, k = k0 + kk;
      as[kk][m] = (row < p.c && k < p.d) ? xe[row * p.x_sc + k * p.x_sd]
                                         : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FK * FN / THREADS; ++i) {
      const int idx = tid + i * THREADS;           // lanes walk f
      const int kk = idx / FN, n = idx % FN;
      const int k = k0 + kk, col = f0 + n;
      bs[kk][n] = (k < p.d && col < p.f) ? we[k * p.w_sd + col * p.w_sf]
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* oe = static_cast<float*>(p.out) +
              static_cast<long long>(e) * p.c * p.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = c0 + ty * 4 + r;
    if (row >= p.c) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = f0 + tx * 4 + c;
      if (col < p.f) oe[static_cast<long long>(row) * p.f + col] = acc[r][c];
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// x (E, C, D) and w (E, D, F), each given by its base pointer and element
// strides; out (E, C, F) contiguous, in x's dtype.  dtype 0 = float32, 1 =
// bfloat16 (x and w alike).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue on arguments the kernel does not take).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int dtype,
                       int experts, int c, int d, int f,
                       long long x_se, long long x_sc, long long x_sd,
                       long long w_se, long long w_sd, long long w_sf,
                       void* stream) {
  const int tile_m = dtype == 0 ? FM : BM;
  const int tile_n = dtype == 0 ? FN : BN;
  const long long ctas_m = (static_cast<long long>(c) + tile_m - 1) / tile_m;
  const long long ctas_n = (static_cast<long long>(f) + tile_n - 1) / tile_n;
  if (experts < 1 || c < 1 || d < 0 || f < 1 || experts > 65535 ||
      ctas_m > 65535 || ctas_n > 2147483647LL || x_se < 0 || x_sc < 0 ||
      x_sd < 0 || w_se < 0 || w_sd < 0 || w_sf < 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{x, w, out, experts, c, d, f,
                 x_se, x_sc, x_sd, w_se, w_sd, w_sf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(ctas_n), static_cast<unsigned>(ctas_m),
                  static_cast<unsigned>(experts));
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, THREADS, 0, s>>>(p);
  } else {
    const bool vec = x_sd == 1 && w_sf == 1 && d % 8 == 0 && f % 8 == 0 &&
                     x_se % 8 == 0 && x_sc % 8 == 0 && w_se % 8 == 0 &&
                     w_sd % 8 == 0 && aligned16(x) && aligned16(w);
    if (vec) {
      gmm_bf16_kernel<true><<<grid, THREADS, 0, s>>>(p);
    } else {
      gmm_bf16_kernel<false><<<grid, THREADS, 0, s>>>(p);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
