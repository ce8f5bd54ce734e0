// The bilinear window shift of one window by one block: the clamped
// (w+1)^2 tile staged in shared memory, and the blend of its four corner
// slices with per-window scalar weights.  Shared by shift_windows.cu (the
// windows go to device memory) and fused_pass.cu (they stay in the block),
// so both produce the same windows bit for bit.
//
// Numerics: the weights and the blend use explicitly rounded
// multiplications and additions (__fmul_rn / __fadd_rn / __fsub_rn), in
// the TPU kernel's term order, so no multiply-add is contracted and the
// result matches the plain PyTorch version (`blend_reference` in
// torchpiv_tpu_torch/ops/shifts.py) to the last bit.  A window whose shift
// is an integer in either axis copies the floor corner.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace piv {

// Copy the T x T tile at (ty, tx), clamped into the Hp x Wp frame, to
// `tile`.  Called by every thread of the block; the caller synchronises.
__device__ __forceinline__ void stage_tile(const float* __restrict__ frame,
                                           int Hp, int Wp, int ty, int tx,
                                           int T, float* tile) {
  ty = min(max(ty, 0), Hp - T);
  tx = min(max(tx, 0), Wp - T);
  const float* src = frame + (int64_t)ty * Wp + tx;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int ri = i / T;
    tile[i] = src[(int64_t)ri * Wp + (i - ri * T)];
  }
}

// The four corner weights of a window's fractional shift (fy, fx).
struct Blend {
  bool copy;  // an integer shift in either axis: the floor corner
  float w11, w21, w12, w22;
};

__device__ __forceinline__ Blend blend_weights(float fy, float fx) {
  Blend b;
  b.copy = fy == 0.0f || fx == 0.0f;
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  b.w11 = __fmul_rn(gx, gy);
  b.w21 = __fmul_rn(fx, gy);
  b.w12 = __fmul_rn(gx, fy);
  b.w22 = __fmul_rn(fx, fy);
  return b;
}

// The shifted window's pixel whose floor corner is t[0] in a tile of row
// length T.
__device__ __forceinline__ float blend_pixel(const float* t, int T,
                                             const Blend& b) {
  if (b.copy) return t[0];
  float acc = __fmul_rn(t[0], b.w11);
  acc = __fadd_rn(acc, __fmul_rn(t[1], b.w21));
  acc = __fadd_rn(acc, __fmul_rn(t[T], b.w12));
  acc = __fadd_rn(acc, __fmul_rn(t[T + 1], b.w22));
  return acc;
}

}  // namespace piv
