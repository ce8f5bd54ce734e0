// Per-window bicubic (Keys cubic convolution, a = -0.5) window shift for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel_bicubic` behind
// `shift_windows_pallas(interp="bicubic")`
// (torchpiv_tpu/kernels/shift_pallas.py).  Same function: every window of
// every frame reads a (w+4)^2 tile of the padded frame at its origin plus
// the window's integer shift minus one (the stencil reaches floor-1 ..
// floor+2), clamped into the frame, and sums the tile's 16 shifted slices
// with per-window scalar weights cubic_weights(fy), cubic_weights(fx):
//   out = sum_ky wy[ky] * (sum_kx wx[kx] * tile[i+ky, j+kx]).
// Integer shifts give the weights (0, 1, 0, 0) exactly, so they copy the
// integer sample.  The plain PyTorch version is `blend_reference_bicubic`
// in torchpiv_tpu_torch/ops/shifts.py.
//
// Bound on an H100: bytes.  At the pass-2 shape of a 4 MP run (2048^2
// frame, w = 32, o = 16, S = 16: N = 16129 windows, pad S + 2) one frame
// writes N*w*w*4 = 66.1 MB and reads the 2084^2*4 = 17.4 MB padded frame
// plus 4 maps of N*4 bytes: about 25 us at 3.35 TB/s.  The stencil is 40
// flops a pixel (0.66 GFLOP a frame, 10 us at the f32 rate), still below
// the byte time.
//
// What the design does about the bound: as `shift_windows.cu`, one block
// per window stages its clamped tile in shared memory, so device memory is
// read about once per covering window (the 50 MB L2 holds the frame) and
// the output, the largest stream, is written once with coalesced stores.
// The eight weights are computed once per block.
//
// Numerics: weights and sums use explicitly rounded operations
// (__fmul_rn / __fadd_rn / __fsub_rn) in the TPU kernel's term order, so no
// multiply-add is contracted and the result matches the plain PyTorch
// version to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 1 <= |d| < 2:  a*d^3 - 5a*d^2 + 8a*d - 4a  with a = -0.5
__device__ __forceinline__ float keys_outer(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  float r = __fsub_rn(__fmul_rn(-0.5f, d3), __fmul_rn(-2.5f, d2));
  r = __fadd_rn(r, __fmul_rn(-4.0f, d));
  return __fsub_rn(r, -2.0f);
}

// |d| <= 1:  (a+2)*d^3 - (a+3)*d^2 + 1
__device__ __forceinline__ float keys_inner(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  const float r = __fsub_rn(__fmul_rn(1.5f, d3), __fmul_rn(2.5f, d2));
  return __fadd_rn(r, 1.0f);
}

__device__ __forceinline__ void cubic_weights(float t, float* w) {
  w[0] = keys_outer(__fadd_rn(t, 1.0f));
  w[1] = keys_inner(t);
  w[2] = keys_inner(__fsub_rn(1.0f, t));
  w[3] = keys_outer(__fsub_rn(2.0f, t));
}

__global__ void __launch_bounds__(kThreads)
shift_windows_bicubic_kernel(const float* __restrict__ frame,
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
  const int T = w + 4;
  const int r = n / n_cols;
  const int c = n - r * n_cols;

  int ty = r * step + off + dy[wi] - 1;
  int tx = c * step + off + dx[wi] - 1;
  ty = min(max(ty, 0), Hp - T);
  tx = min(max(tx, 0), Wp - T);
  const float* src = frame + (int64_t)b * Hp * Wp + (int64_t)ty * Wp + tx;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int ri = i / T;
    tile[i] = src[(int64_t)ri * Wp + (i - ri * T)];
  }
  __syncthreads();

  float wy[4], wx[4];
  cubic_weights(fy[wi], wy);
  cubic_weights(fx[wi], wx);
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    const float* t = tile + ri * T + (i - ri * w);
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      float row_acc = 0.0f;
#pragma unroll
      for (int kx = 0; kx < 4; ++kx)
        row_acc = __fadd_rn(row_acc, __fmul_rn(wx[kx], t[ky * T + kx]));
      acc = __fadd_rn(acc, __fmul_rn(wy[ky], row_acc));
    }
    dst[i] = acc;
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx: [B, N] f32;
// out: [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int shift_windows_bicubic_f32(const float* frame, const int* dy, const int* dx,
                              const float* fy, const float* fx, float* out,
                              int B, int Hp, int Wp, int n_rows, int n_cols,
                              int w, int step, int off, void* stream) {
  const size_t smem = (size_t)(w + 4) * (w + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_bicubic_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  shift_windows_bicubic_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, n_cols, n_win, w, step, off);
  return (int)cudaGetLastError();
}

const char* shift_windows_bicubic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
