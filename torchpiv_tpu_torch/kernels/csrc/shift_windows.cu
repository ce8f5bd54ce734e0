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
// Numerics: the weights and the blend use explicitly rounded
// multiplications and additions (__fmul_rn / __fadd_rn / __fsub_rn), in
// the TPU kernel's term order, so no multiply-add is contracted and the
// result matches the plain PyTorch version to the last bit.  Integer
// shifts copy tile values and are bit-exact by construction.

#include <cuda_runtime.h>
#include <stdint.h>

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
                     int w, int step, int off) {
  extern __shared__ float tile[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  const int r = n / n_cols;
  const int c = n - r * n_cols;

  int ty = r * step + off + dy[wi];
  int tx = c * step + off + dx[wi];
  ty = min(max(ty, 0), Hp - T);
  tx = min(max(tx, 0), Wp - T);
  const float* src = frame + (int64_t)b * Hp * Wp + (int64_t)ty * Wp + tx;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int ri = i / T;
    tile[i] = src[(int64_t)ri * Wp + (i - ri * T)];
  }
  __syncthreads();

  const float fyv = fy[wi];
  const float fxv = fx[wi];
  float* dst = out + wi * w * w;
  if (fyv == 0.0f || fxv == 0.0f) {
    for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
      const int ri = i / w;
      dst[i] = tile[ri * T + (i - ri * w)];
    }
    return;
  }
  const float gx = __fsub_rn(1.0f, fxv);
  const float gy = __fsub_rn(1.0f, fyv);
  const float w11 = __fmul_rn(gx, gy);
  const float w21 = __fmul_rn(fxv, gy);
  const float w12 = __fmul_rn(gx, fyv);
  const float w22 = __fmul_rn(fxv, fyv);
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    const float* t = tile + ri * T + (i - ri * w);
    float acc = __fmul_rn(t[0], w11);
    acc = __fadd_rn(acc, __fmul_rn(t[1], w21));
    acc = __fadd_rn(acc, __fmul_rn(t[T], w12));
    acc = __fadd_rn(acc, __fmul_rn(t[T + 1], w22));
    dst[i] = acc;
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx: [B, N] f32;
// out: [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int shift_windows_f32(const float* frame, const int* dy, const int* dx,
                      const float* fy, const float* fx, float* out,
                      int B, int Hp, int Wp, int n_rows, int n_cols,
                      int w, int step, int off, void* stream) {
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
      frame, dy, dx, fy, fx, out, Hp, Wp, n_cols, n_win, w, step, off);
  return (int)cudaGetLastError();
}

const char* shift_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
