// Device helpers shared by the recurrence kernels (wkv6.cu, ssd.cu).
// build.py hashes every csrc/*.cuh with each source, so an edit here
// rebuilds both.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace recurrence {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// eight consecutive floats of shared memory, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// a read-only element load (ld.global.nc) of a (batch, t, head, i) tensor
// with element strides s: loads of a chunk issue back to back, free to pass
// the shared-memory stores between them
template <typename T>
__device__ __forceinline__ float at(const void* base, const long long* s,
                                    int b, int t, int h, int i) {
  const T* p = static_cast<const T*>(base);
  return to_f32(__ldg(p + b * s[0] + t * s[1] + h * s[2] + i * s[3]));
}

// ---- the chunked bf16 kernels' tensor-core helpers (mma.sync) ----------
//
// Fragments of mma.sync.m16n8k16 (bf16 in, float32 accumulate), lane
// g = lane / 4, q = lane % 4:
//   A (16 x 16, row-major) a[0..3]: (g, 2q..2q+1), (g + 8, 2q..),
//                                   (g, 2q + 8..), (g + 8, 2q + 8..)
//   B (16 x 8, k x n)      b[0..1]: (k 2q..2q+1, n g), (k 2q + 8.., n g)
//   C (16 x 8, float32)    c[0..3]: (g, 2q), (g, 2q + 1), (g + 8, 2q),
//                                   (g + 8, 2q + 1)
// so the C fragments of two neighbouring n-tiles are, packed in pairs,
// the A fragment of one 16-deep k-step.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8 (16-byte aligned rows)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// two transposed matrices (lanes 0-15 give the addresses)
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Lane addresses (as element offsets row * stride + col) for ldmatrix:
// an A fragment (16 x 16 at (r0, c0)) of a row-major [m][k] tile ...
__device__ __forceinline__ int frag_a(int lane, int r0, int c0, int stride) {
  const int m = lane >> 3;
  return (r0 + (lane & 7) + 8 * (m & 1)) * stride + c0 + 8 * (m >> 1);
}
// ... a B fragment pair (two n-tiles, rows n0.., k0..) of an [n][k] tile,
// non-transposed: r[0..1] n-tile n0, r[2..3] n-tile n0 + 8 ...
__device__ __forceinline__ int frag_bnk(int lane, int n0, int k0,
                                        int stride) {
  const int m = lane >> 3;
  return (n0 + (lane & 7) + 8 * (m >> 1)) * stride + k0 + 8 * (m & 1);
}
// ... a B fragment pair of a [k][n] tile, transposed (ldsm_x4_t):
// r[0..1] n-tile n0, r[2..3] n-tile n0 + 8; for ldsm_x2_t lanes 0-15
// give one n-tile's b[0..1] ...
__device__ __forceinline__ int frag_bkn(int lane, int k0, int n0,
                                        int stride) {
  const int m = lane >> 3;
  return (k0 + (lane & 7) + 8 * (m & 1)) * stride + n0 + 8 * (m >> 1);
}
// ... and an A fragment of the transpose of a [k][m] tile (ldsm_x4_t):
// A = X^T for X stored [k][m], the 16 x 16 block at (m0, k0)
__device__ __forceinline__ int frag_at(int lane, int m0, int k0, int stride) {
  const int m = lane >> 3;
  return (k0 + (lane & 7) + 8 * (m >> 1)) * stride + m0 + 8 * (m & 1);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
// Two float32 values as the sum of two bf16 pairs, hi + lo: hi the
// rounded values, lo the rounded remainders.  hi + lo holds 16 of the 24
// bits (relative error <= 2^-17), so a product with an exact bf16 operand
// on the tensor cores, hi.b + lo.b, is float32-accurate to ~1e-5.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack2(hx, hy);
  lo = pack2(__float2bfloat16_rn(x - __bfloat162float(hx)),
             __float2bfloat16_rn(y - __bfloat162float(hy)));
}
// a bf16 or float32 pair from memory, and a float pair stored as bf16
// (4-byte aligned)
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x and log2(x) on the special-function unit (MUFU.EX2 / MUFU.LG2:
// relative error ~2^-22; 2^x flushes to 0 below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (the source address must still be a valid one)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One row segment of 8 bf16 (16 bytes) of a strided (batch, t, head, i)
// tensor into shared memory: cp.async where the caller found every such
// segment 16-byte aligned (vec), else eight element loads; zeros where
// !valid.
__device__ __forceinline__ void row8(__nv_bfloat16* dst,
                                     const __nv_bfloat16* src, bool valid,
                                     bool vec, long long stride,
                                     const __nv_bfloat16* any) {
  if (vec) {
    cp16(dst, valid ? src : any, valid);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = valid ? src[e * stride] : __float2bfloat16_rn(0.f);
  }
}

// whether every 8-element segment of a (batch, t, head, i) bf16 tensor
// with element strides s starts 16-byte aligned (host side)
inline bool segments_aligned(const void* base, const long long* s) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s[3] == 1 &&
         s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

}  // namespace recurrence
