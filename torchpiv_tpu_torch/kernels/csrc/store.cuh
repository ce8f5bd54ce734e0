// Streaming window stores in a resampling kernel's output element type.
//
// The window-shift and deformation kernels (shift_windows.cu,
// shift_windows_bicubic.cu, def_windows.cu) compute every pixel in float32
// and store it as float, bfloat16 or half: the TPU kernels' `out_dtype`,
// which rounds at the store (`.astype(out_ref.dtype)`).  The narrow types
// round to nearest even (`__float2bfloat16_rn`, `__float2half_rn`), as
// `.astype` in JAX and `.to()` in torch do, so a kernel's narrow store
// equals its plain version's float32 result cast with `.to(out_dtype)`.
// Every store is streaming (`st.global.cs`), so the windows do not evict
// the frame from L2.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace piv {

// The bits of v rounded to the 16-bit type that `p` points to.
__device__ __forceinline__ unsigned short narrow_bits(const __nv_bfloat16*, float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned short narrow_bits(const __half*, float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// One value.
__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }

template <typename T>
__device__ __forceinline__ void store_cs(T* p, float v) {
  asm volatile("st.global.cs.u16 [%0], %1;" ::"l"(p), "h"(narrow_bits(p, v))
               : "memory");
}

// Four consecutive values, p aligned to four elements: one 16-byte store
// (float) or one 8-byte store (16-bit types).
__device__ __forceinline__ void store4_cs(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <typename T>
__device__ __forceinline__ void store4_cs(T* p, const float (&v)[4]) {
  const unsigned lo = narrow_bits(p, v[0]) | ((unsigned)narrow_bits(p, v[1]) << 16);
  const unsigned hi = narrow_bits(p, v[2]) | ((unsigned)narrow_bits(p, v[3]) << 16);
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(lo), "r"(hi)
               : "memory");
}

}  // namespace piv

// F(suffix, type) for each output element type: a kernel's C entry points
// are `<name>_f32` (float), `<name>_store_bf16` and `<name>_store_f16`.
#define PIV_STORE_TYPES(F)     \
  F(f32, float)                \
  F(store_bf16, __nv_bfloat16) \
  F(store_f16, __half)
