// The bilinear window shift of one window by one block: the clamped
// (w+1)^2 tile staged in shared memory, and the blend of its four corner
// slices with per-window scalar weights.  The staging is fused_pass.cu's
// (the windows stay in the block); the blend is shared by it,
// shift_windows.cu (which keeps a window's rows in a warp's registers) and
// the shift variants (shift_windows_{bf16,phases,lanephases,mxu}.cu, which
// stage the tile in other ways), so all produce the same windows bit for
// bit.
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

// The shifted window's pixel from its four tile corners: t11 the floor
// corner, t21 its right neighbour, t12 the one below, t22 the diagonal.
__device__ __forceinline__ float blend_corners(float t11, float t21, float t12,
                                               float t22, const Blend& b) {
  if (b.copy) return t11;
  float acc = __fmul_rn(t11, b.w11);
  acc = __fadd_rn(acc, __fmul_rn(t21, b.w21));
  acc = __fadd_rn(acc, __fmul_rn(t12, b.w12));
  acc = __fadd_rn(acc, __fmul_rn(t22, b.w22));
  return acc;
}

// The shifted window's pixel whose floor corner is t[0] in a tile of row
// length T.
__device__ __forceinline__ float blend_pixel(const float* t, int T,
                                             const Blend& b) {
  return blend_corners(t[0], t[1], t[T], t[T + 1], b);
}

// The clamped origin of window `n` (row-major over a grid of `n_cols`
// columns) shifted by (dy, dx): the (ty, tx) of its T x T tile.
__device__ __forceinline__ void tile_origin(int n, int n_cols, int step, int off,
                                            int dy, int dx, int Hp, int Wp,
                                            int T, int* ty, int* tx) {
  const int r = n / n_cols;
  const int c = n - r * n_cols;
  *ty = min(max(r * step + off + dy, 0), Hp - T);
  *tx = min(max(c * step + off + dx, 0), Wp - T);
}

// One 16-byte asynchronous copy from device to shared memory; both
// addresses are 16-byte aligned.  `cp_async_wait` waits for the thread's
// copies; the caller synchronises the block afterwards.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// The same for 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy the T x T tile at (ty, tx), clamped into the Hp x Wp frame, to
// `tile` by asynchronous copies, by every thread of a group of `size`
// threads, each with its `rank`: all of a thread's copies are in flight at
// once and pass through no register.  The caller waits (`cp_async_wait`)
// and synchronises the group.
__device__ __forceinline__ void stage_tile_async(const float* __restrict__ frame,
                                                 int Hp, int Wp, int ty, int tx,
                                                 int T, float* tile, int rank,
                                                 int size) {
  ty = min(max(ty, 0), Hp - T);
  tx = min(max(tx, 0), Wp - T);
  const float* src = frame + (int64_t)ty * Wp + tx;
  for (int i = rank; i < T * T; i += size) {
    const int ri = i / T;
    cp_async4(tile + i, src + (int64_t)ri * Wp + (i - ri * T));
  }
}

}  // namespace piv
