// Per-window CWS/DWS window shift for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel` behind `shift_windows_pallas`
// (torchpiv_tpu/kernels/shift_pallas.py).  Same function: every window of
// every frame reads a (w+1)^2 tile of the padded frame at its origin plus
// the window's integer shift (dy, dx), clamped into the frame, and blends
// the tile's four corner slices with per-window scalar weights built from
// the fractional shift (fy, fx); a window whose shift is an integer in
// either axis copies the floor corner.  The plain PyTorch version is
// `blend_reference` in torchpiv_tpu_torch/ops/shifts.py.
//
// Bound on an H100: bytes.  At the main path's pass-2 shape (2048^2 frame,
// w = 32, o = 16, S = 16: N = 127^2 = 16129 windows) one launch per frame
// writes N*w*w*4 = 66.1 MB and reads the 2080^2*4 = 17.3 MB padded frame
// plus 4 maps of N*4 bytes, about 83.7 MB: about 25 us at 3.35 TB/s.  The
// blend is 7 flops a pixel (0.12 GFLOP), far below the card's f32 rate.
//
// What the design does about the bound: each input byte is read from
// device memory about once per window that covers it (the tile sits in
// shared memory, and the four corner slices are read from there), and the
// output, the largest stream, is written once with coalesced stores (one
// block writes its window's w*w floats contiguously).  Neighbouring
// windows overlap by half at o = w/2, so a frame pixel is fetched by up to
// four blocks; the L2 cache (50 MB) holds the 17 MB frame and absorbs that.
// Making the tile loads asynchronous (cp.async / TMA rings) is later work.
//
// With `packed` the windows go out in the lane-packed layout of the TPU
// pass-fusion kernels instead: window c of row r at out[r, :, c*w:(c+1)*w]
// of a [n_rows, w, Lp] tensor, Lp = n_cols_pad * w, the columns past n_cols
// repeating the last window.  The port's own kernels read [N, w, w]; the
// layout exists to be held against the JAX functions that speak it.
//
// The tile staging and the blend, with their numerics, are in shift.cuh,
// shared with fused_pass.cu: the result matches the plain PyTorch version
// to the last bit, and integer shifts copy tile values.

#include "shift.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
shift_windows_kernel(const float* __restrict__ frame,
                     const int* __restrict__ dy,
                     const int* __restrict__ dx,
                     const float* __restrict__ fy,
                     const float* __restrict__ fx,
                     float* __restrict__ out,
                     int Hp, int Wp, int n_cols, int n_win,
                     int w, int step, int off, int packed, int n_cols_pad) {
  extern __shared__ float tile[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  const int r = n / n_cols;
  const int c = n - r * n_cols;

  piv::stage_tile(frame + (int64_t)b * Hp * Wp, Hp, Wp,
                  r * step + off + dy[wi], c * step + off + dx[wi], T, tile);
  __syncthreads();

  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);
  if (!packed) {
    float* dst = out + wi * w * w;
    for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
      const int ri = i / w;
      dst[i] = piv::blend_pixel(tile + ri * T + (i - ri * w), T, blend);
    }
    return;
  }
  const int64_t Lp = (int64_t)n_cols_pad * w;
  const int n_rows = n_win / n_cols;
  // the last window of a row also fills the row's tail columns
  const int copies = c == n_cols - 1 ? n_cols_pad - n_cols + 1 : 1;
  float* dst = out + ((int64_t)b * n_rows + r) * w * Lp + (int64_t)c * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    const int ci = i - ri * w;
    const float val = piv::blend_pixel(tile + ri * T + ci, T, blend);
    for (int k = 0; k < copies; ++k) dst[ri * Lp + k * w + ci] = val;
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx: [B, N] f32;
// out: [B, N, w, w] f32 with N = n_rows * n_cols, or with `packed`
// [B, n_rows, w, n_cols_pad * w].  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
int shift_windows_f32(const float* frame, const int* dy, const int* dx,
                      const float* fy, const float* fx, float* out,
                      int B, int Hp, int Wp, int n_rows, int n_cols,
                      int w, int step, int off, int packed, int n_cols_pad,
                      void* stream) {
  const size_t smem = (size_t)(w + 1) * (w + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  shift_windows_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, n_cols, n_win, w, step, off, packed,
      n_cols_pad);
  return (int)cudaGetLastError();
}

const char* shift_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
