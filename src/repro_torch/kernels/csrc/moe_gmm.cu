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
// bfloat16: tensor cores (gmm_wgmma_kernel).  One CTA per 128 x 256 output
// tile of one expert: two consumer warpgroups of 64 rows each and one
// producer warp.  D advances 64 at a time (128 bytes of bfloat16, the
// 128-byte swizzle) through a ring of four shared-memory stages of 48 KB
// (an x tile 128 x 64 and a w tile 64 x 256 as four 64-column chunks); the
// producer warp's lane 0 fills it with TMA, each stage completing on a
// "full" mbarrier, and waits on the stage's "empty" mbarrier, which the
// eight consumer warps arrive on once their products have read it.  Each
// consumer warpgroup runs wgmma m64n256k16 with x from shared memory
// (K-major) and w from shared memory read MN-major (transpose bit: w is
// (D, F) with F contiguous), keeping one k tile's products in flight
// (wgmma.wait_group 1) while it waits for the next stage.  TMA zero-fills
// the ragged C, D and F edges; the store masks the rows past C and the
// columns past F.  The tensor maps need a unit inner stride, 16-byte
// aligned base and outer strides: the wrapper (moe_gmm.py) makes a copy
// otherwise.  Output tiles run in groups of 8 C tiles of one expert, so the
// CTAs in flight share their x and w tiles in L2.  A launch captured in a
// CUDA graph would keep the tensor maps (and so the pointers) of the
// captured launch.
//
// float32: exact float32 FMA on the SIMT units (a TF32 tensor-core product
// would keep ~3 decimal digits), a 64 x 64 tile, each thread 4 x 4 outputs
// summed over d in ascending order, D 16 at a time.
//
// Bound: at the served bucket 2048 and width 4 (dbrx-132b: E 16, cap 1024
// a row, so C = 4096; D 6144, F 10752) one launch computes 2 E C D F =
// 8.66 TFLOP against 4.33 GB of x, w and out: operations bound, 8.75 ms at
// the card's 989 TFLOP/s bf16 dense rate.  Capacity slots the dispatch
// left empty are zero rows and are computed all the same (the bound counts
// E C rows).  Measured by chip_smoke.py on an H100 SXM at 700 W: 12.55 ms
// at C = 4096, 70 % of the bound (the mma.sync kernel it replaces took
// 31.3 ms; torch.bmm 10.7).  One CTA per SM (197 KB) leaves each tile's
// pipeline fill and epilogue exposed; a 192 x 256 tile was no faster.
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bfloat16
constexpr int BM = 128;           // C rows per CTA
constexpr int BN = 256;           // F columns per CTA
constexpr int BK = 64;            // D per stage
constexpr int STAGES = 4;
constexpr int GROUP = 8;          // C tiles per raster group
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int WG_SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int WG_THREADS = 288;   // two consumer warpgroups + a producer warp

// ---------------------------------------------------------------- float32
constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(WG_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  // output tile: experts outermost, then groups of GROUP C tiles, C tile
  // fastest within a group
  const int tc = (p.c + BM - 1) / BM, tf = (p.f + BN - 1) / BN;
  const long long per_e = static_cast<long long>(tc) * tf;
  const int e = static_cast<int>(blockIdx.x / per_e);
  const int r = static_cast<int>(blockIdx.x % per_e);
  const int first = (r / (GROUP * tf)) * GROUP;
  const int gsize = min(tc - first, GROUP);
  const int in_group = r % (GROUP * tf);
  const int c0 = (first + in_group % gsize) * BM;
  const int f0 = (in_group / gsize) * BN;
  const int k_tiles = (p.d + BK - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                   // producer
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) hopper::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* sa = sm + s * STAGE_BYTES;
        hopper::mbar_expect_tx(&full[s], STAGE_BYTES);
        hopper::tma_load_3d(sa, &tx, &full[s], kt * BK, c0, e);
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb)
          hopper::tma_load_3d(sa + A_BYTES + cb * BK * 128, &tw, &full[s],
                              f0 + cb * 64, kt * BK, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. of the tile
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t base = hopper::smem_u32(sm);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * 64 * 128;
    const uint32_t bw = base + s * STAGE_BYTES + A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_m64n256k16_ss<1>(
          acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
          hopper::desc_sw128(bw + kk * 16 * 128, BK * 128, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();         // the previous k tile's products are done
    if (kt > 0 && lane == 0) hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // acc[4 j + q]: row g + 8 (q / 2) of the warp's 16, column 8 j + 2 t +
  // q % 2
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* oe = static_cast<__nv_bfloat16*>(p.out) +
                      static_cast<long long>(e) * p.c * p.f;
  const bool pairs = (p.f & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = c0 + wg * 64 + (warp & 3) * 16 + g + 8 * half;
    if (row >= p.c) continue;
    __nv_bfloat16* orow = oe + static_cast<long long>(row) * p.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = f0 + 8 * j + 2 * t;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
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

int launch_bf16(const Params& p, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const long long xd[3] = {p.d, p.c, p.experts};
  const long long xs[2] = {p.x_sc, p.x_se};
  const int xbox[3] = {BK, BM, 1};
  const long long wd[3] = {p.f, p.d, p.experts};
  const long long ws[2] = {p.w_sd, p.w_se};
  const int wbox[3] = {64, BK, 1};
  CUtensorMap tx, tw;
  if (!hopper::encode_bf16(&tx, p.x, 3, xd, xs, xbox) ||
      !hopper::encode_bf16(&tw, p.w, 3, wd, ws, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(p.experts) *
                          ((p.c + BM - 1) / BM) * ((p.f + BN - 1) / BN);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  gmm_wgmma_kernel<<<static_cast<unsigned>(tiles), WG_THREADS, WG_SMEM,
                     stream>>>(tx, tw, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, C, D) and w (E, D, F), each given by its base pointer and element
// strides; out (E, C, F) contiguous, in x's dtype.  dtype 0 = float32, 1 =
// bfloat16 (x and w alike).  bfloat16 needs D >= 1, unit inner strides
// (x_sd = w_sf = 1), 16-byte aligned x and w, and the other strides of
// x and w multiples of 8 elements wherever their dimension exceeds 1 (the
// TMA tensor maps).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue on arguments the kernel does not take).
extern "C" int gmm_fwd(const void* x, const void* w, void* out, int dtype,
                       int experts, int c, int d, int f,
                       long long x_se, long long x_sc, long long x_sd,
                       long long w_se, long long w_sd, long long w_sf,
                       void* stream) {
  if (experts < 1 || c < 1 || d < 0 || f < 1 || x_se < 0 || x_sc < 0 ||
      x_sd < 0 || w_se < 0 || w_sd < 0 || w_sf < 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{x, w, out, experts, c, d, f,
                 x_se, x_sc, x_sd, w_se, w_sd, w_sf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool tma = d >= 1 && x_sd == 1 && w_sf == 1 && aligned16(x) &&
                     aligned16(w) && (experts == 1 || x_se % 8 == 0) &&
                     (c == 1 || x_sc % 8 == 0) &&
                     (experts == 1 || w_se % 8 == 0) &&
                     (d == 1 || w_sd % 8 == 0);
    if (!tma) return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16(p, s);
  }
  const long long ctas_m = (static_cast<long long>(c) + FM - 1) / FM;
  const long long ctas_n = (static_cast<long long>(f) + FN - 1) / FN;
  if (experts > 65535 || ctas_m > 65535 || ctas_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas_n), static_cast<unsigned>(ctas_m),
                  static_cast<unsigned>(experts));
  gmm_f32_kernel<<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
