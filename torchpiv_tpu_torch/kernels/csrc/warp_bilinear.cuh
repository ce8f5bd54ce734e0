// The bilinear window shift with a window in a warp's registers, on
// warp_lanes.cuh's lane map (reach 1), generic in the frame's element type:
// shift_windows_phases.cu reads a bfloat16 frame and widens each sample,
// shift_windows_bf16.cu reads the float32 frame and rounds each sample to
// bfloat16 (`RoundedF32`), shift_windows_lanephases.cu reads the float32
// frame as it is.  One design with three loads; the plain version of all
// is `blend_reference_variant` in torchpiv_tpu_torch/ops/shifts.py, which
// `warp_window_steps` there replays lane by lane.
//
// A warp owns a window (or 32 / G windows of up to 16 px); the warp walks
// the w + 1 tile rows, each one coalesced `__ldg` a slot widened to
// float32, kRows rows loaded before their first store; the right neighbour
// comes by one shuffle a slot; the blend is shift.cuh's `blend_corners`,
// each output row one coalesced streaming store (`__stcs`).  No shared
// memory, no barrier, no integer division.

#pragma once

#include "shift.cuh"
#include "warp_lanes.cuh"

namespace piv {
namespace warp {

// frame: [B, Hp, pitch] elements of type T (columns from Wp on are not
// read); dy, dx: [B, N] i32; fy, fx: [B, N] f32; out: [B, N, w, w] f32.
// Block (x, r, b) of kWarps warps serves grid row r of frame b.
template <int K, int kRows, typename T>
__device__ __forceinline__ void bilinear_windows(
    const T* __restrict__ frame, const int* __restrict__ dy,
    const int* __restrict__ dx, const float* __restrict__ fy,
    const float* __restrict__ fx, float* __restrict__ out, int Hp, int Wp,
    int pitch, int n_rows, int n_cols, int w, int step, int off, int row_start,
    int lg) {
  const int G = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int c = lane & (G - 1);  // the lane's first column
  const int r = blockIdx.y;      // row of the block's windows in the row block
  const int b = blockIdx.z;      // frame of the batch
  const int col = ((blockIdx.x * kWarps + (threadIdx.x >> 5)) << (5 - lg)) +
                  (lane >> lg);  // grid column of the group's window
  const bool live = col < n_cols;  // a ragged row's last groups only load
  const int64_t wi = ((int64_t)b * n_rows + r) * n_cols + min(col, n_cols - 1);
  const int T1 = w + 1;

  const int ty = min(max((row_start + r) * step + off + dy[wi], 0), Hp - T1);
  const int tx = min(max(min(col, n_cols - 1) * step + off + dx[wi], 0), Wp - T1);
  const T* src = frame + ((int64_t)b * Hp + ty) * pitch + tx;
  const Blend blend = blend_weights(fy[wi], fx[wi]);
  float* dst = out + wi * w * w;

  float top[K + 1], top_right[K];
  load_row<K>(src, pitch, 0, c, G, w, top);
  right_at<K>(top, c, G, 1, top_right);
  for (int i0 = 0; i0 < w; i0 += kRows) {
    float below[kRows][K + 1];
#pragma unroll
    for (int u = 0; u < kRows; ++u) load_row<K>(src, pitch, i0 + u + 1, c, G, w, below[u]);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = i0 + u;  // output row: tile rows i and i + 1
      if (i >= w) break;     // the same for the whole warp
      float below_right[K];
      right_at<K>(below[u], c, G, 1, below_right);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = c + G * k;
        const float val = blend_corners(top[k], top_right[k], below[u][k],
                                        below_right[k], blend);
        if (live && j < w) __stcs(dst + i * w + j, val);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        top[k] = below[u][k];
        top_right[k] = below_right[k];
      }
      top[K] = below[u][K];
    }
  }
}

// The grid of a launch: blocks of kWarps warps along a grid row, one grid
// row and frame a block column.
inline dim3 bilinear_grid(int B, int n_rows, int n_cols, const Lanes& l) {
  const int per_block = kWarps * l.P;  // windows a block
  return dim3((n_cols + per_block - 1) / per_block, n_rows, B);
}

// out[0..4] of a `<name>_describe` entry for `kernel` on the lane map l.
template <class Kernel>
int describe_bilinear(Kernel kernel, const Lanes& l, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kWarps * 32;
  out[4] = kWarps * l.P;
  return 0;
}

}  // namespace warp
}  // namespace piv
