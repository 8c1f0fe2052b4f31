// Device helpers shared by the recurrence kernels (wkv6.cu, ssd.cu).
// build.py hashes every csrc/*.cuh with each source, so an edit here
// rebuilds both.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace recurrence
