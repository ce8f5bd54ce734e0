// Per-window CWS/DWS window shift on a bfloat16 frame for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel `_shift_kernel_bf16` behind
// `shift_windows_pallas(variant="bf16")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu, on a padded frame that the wrapper has rounded to
// bfloat16: every window reads a (w+1)^2 tile at its origin plus the
// window's integer shift, clamped into the frame, and blends the tile's
// four corner slices in float32 with per-window scalar weights; a window
// whose shift is an integer in either axis copies the floor corner.  The
// plain PyTorch version is `blend_reference_variant(..., "bf16")` in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The idea kept from the TPU variant: all data movement runs on half-width
// data, and only the blend sees float32.  The TPU packs two bfloat16 rows
// into a 32-bit sublane and needs two row phases for odd row offsets; on
// this card two adjacent columns share a 32-bit word, so the tile is
// staged with 32-bit (`__nv_bfloat162`-wide) loads from the even column at
// or before the tile's origin, and an odd origin reads the staged words
// one element further in: two column phases.  The TPU's band DMA, its
// 256-lane block and the rotates have no counterpart here.
//
// Bound on an H100: bytes.  At the main path's pass-2 shape (2048^2 frame,
// w = 32, o = 16, S = 16: 16129 windows) a frame costs N*w*w*4 = 66.1 MB of
// output and a 2080*2080*2 = 8.7 MB frame, half of shift_windows.cu's
// 17.3 MB; the (w+1) x (w+2) bfloat16 tile takes 2.2 KB of shared memory
// against 4.4 KB.  The output dominates either way, so the saving is small:
// about 22 us against 25 us per frame at 3.35 TB/s.
//
// The frame's row pitch is even (the wrapper pads it to a multiple of 8
// with zeros beyond Wp), so every row starts on a 32-bit boundary; the
// clamps use the logical Wp.  The blend is shift.cuh's: the result matches
// the plain version to the last bit.

#include <cuda_bf16.h>

#include "shift.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shift_windows_bf16_kernel(const __nv_bfloat16* __restrict__ frame,
                          const int* __restrict__ dy,
                          const int* __restrict__ dx,
                          const float* __restrict__ fy,
                          const float* __restrict__ fx,
                          float* __restrict__ out,
                          int Hp, int Wp, int pitch, int n_cols, int n_win,
                          int w, int step, int off) {
  extern __shared__ uint32_t words[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  int ty, tx;
  piv::tile_origin(n, n_cols, step, off, dy[wi], dx[wi], Hp, Wp, T, &ty, &tx);

  // words per tile row: T + 1 columns from the even column tx - phase
  const int phase = tx & 1;
  const int nw = T / 2 + 1;
  const int wpitch = pitch / 2;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      frame + ((int64_t)b * Hp + ty) * pitch + (tx - phase));
  for (int i = threadIdx.x; i < T * nw; i += blockDim.x) {
    const int ri = i / nw;
    words[i] = src[(int64_t)ri * wpitch + (i - ri * nw)];
  }
  __syncthreads();

  const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(words) + phase;
  const int tp = 2 * nw;  // the staged row's length in elements
  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    const __nv_bfloat16* t = tile + ri * tp + (i - ri * w);
    dst[i] = piv::blend_corners(__bfloat162float(t[0]), __bfloat162float(t[1]),
                                __bfloat162float(t[tp]),
                                __bfloat162float(t[tp + 1]), blend);
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] bf16, pitch a multiple of 8 and >= Wp + 2, zeros
// beyond column Wp; dy, dx: [B, N] i32; fy, fx: [B, N] f32; out:
// [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
int shift_windows_bf16_f32(const void* frame, const int* dy, const int* dx,
                           const float* fy, const float* fx, float* out,
                           int B, int Hp, int Wp, int pitch, int n_rows,
                           int n_cols, int w, int step, int off, void* stream) {
  if (pitch % 8 != 0 || pitch < Wp + 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(w + 1) * ((w + 1) / 2 + 1) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  shift_windows_bf16_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(frame), dy, dx, fy, fx, out, Hp, Wp,
      pitch, n_cols, n_win, w, step, off);
  return (int)cudaGetLastError();
}

const char* shift_windows_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
