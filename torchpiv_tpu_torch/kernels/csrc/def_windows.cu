// Window-deformation (DEF) resampling for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_def_kernel` behind `def_windows_pallas`
// (torchpiv_tpu/kernels/def_pallas.py).  Same function: every window of
// every frame is resampled with a per-PIXEL displacement, the window's
// centre shift plus its gradient times the pixel's offset from the window
// centre.  A window reads a T^2 tile of the padded frame, T = w + 2M + 1
// (bilinear) or w + 2M + 4 (bicubic), at its origin plus the integer shift
// minus BASE = M (M + 1 bicubic), clamped into the frame.  Per pixel (i, j)
// the residual position is
//   ry = ((M + fy) + gyi*ioff) + gyj*joff,  ioff = i - (w-1)/2,
// clipped to [0, 2M + 1 - 1e-3] (rx alike), and the sample is
//   bilinear: hat weights max(0, 1 - |r - k|) on the 2x2 neighbours; a
//             pixel whose ry OR rx is an integer takes the floor corner;
//   bicubic:  Keys weights (a = -0.5) on the 4x4 neighbours.
// The plain PyTorch version is `def_reference` in
// torchpiv_tpu_torch/ops/deform.py.
//
// The TPU kernel sums (wy*wx)*tile over all (2M+2)^2 or (2M+4)^2 static
// tile shifts because it cannot address per pixel; every term outside the
// pixel's own 2x2 or 4x4 neighbours is an exact zero.  Here each thread
// gathers its own taps from shared memory, in ascending ky then kx, each as
// (wy*wx)*tile, which is the same float32 sum.
//
// Bound on an H100: bytes.  At the pass-2 shape of a 4 MP run (2048^2
// frame, w = 32, o = 16, S = 16, M = 2: N = 16129 windows, pad S + M + 1)
// one frame writes N*w*w*4 = 66.1 MB and reads the 2086^2*4 = 17.4 MB
// padded frame plus 8 maps of N*4 bytes: about 25 us at 3.35 TB/s.  The
// bilinear sample is about 40 flops a pixel, the bicubic about 150 (2.5
// GFLOP a frame, 37 us at the f32 rate): bicubic is bound by operations.
//
// What the design does about the bound: one block per window stages its
// clamped tile in shared memory (37^2 floats at w = 32, up to 129^2 = 66.6
// KB, above 48 KB through the dynamic shared-memory attribute), so device
// memory is read about once per covering window (the 50 MB L2 holds the
// frame) and the output is written once with coalesced stores.
//
// Numerics: ry decides floor(ry) and ry == floor(ry), so a contracted
// multiply-add would move pixels between cells.  The residual, the weights
// and the sum use explicitly rounded operations (__fmul_rn / __fadd_rn /
// __fsub_rn) in the TPU kernel's order, and the result matches the plain
// PyTorch version to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Keys cubic-convolution weight, a = -0.5, in the TPU kernel's term order.
__device__ __forceinline__ float keys(float d) {
  const float ad = fabsf(d);
  const float ad2 = __fmul_rn(ad, ad);
  const float ad3 = __fmul_rn(ad2, ad);
  if (ad <= 1.0f) {
    const float r = __fsub_rn(__fmul_rn(1.5f, ad3), __fmul_rn(2.5f, ad2));
    return __fadd_rn(r, 1.0f);
  }
  if (ad < 2.0f) {
    float r = __fsub_rn(__fmul_rn(-0.5f, ad3), __fmul_rn(-2.5f, ad2));
    r = __fadd_rn(r, __fmul_rn(-4.0f, ad));
    return __fsub_rn(r, -2.0f);
  }
  return 0.0f;
}

__device__ __forceinline__ float hat(float r, float k) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(r, k))));
}

__device__ __forceinline__ float residual(float base, float gi, float ioff,
                                          float gj, float joff, float hi) {
  float r = __fadd_rn(base, __fmul_rn(gi, ioff));
  r = __fadd_rn(r, __fmul_rn(gj, joff));
  return fminf(fmaxf(r, 0.0f), hi);
}

template <bool kCubic>
__global__ void __launch_bounds__(kThreads)
def_windows_kernel(const float* __restrict__ frame,
                   const int* __restrict__ dy, const int* __restrict__ dx,
                   const float* __restrict__ fy, const float* __restrict__ fx,
                   const float* __restrict__ gyi, const float* __restrict__ gyj,
                   const float* __restrict__ gxi, const float* __restrict__ gxj,
                   float* __restrict__ out,
                   int Hp, int Wp, int n_cols, int n_win,
                   int w, int step, int off, int M) {
  extern __shared__ float tile[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 2 * M + (kCubic ? 4 : 1);
  const int base = M + (kCubic ? 1 : 0);
  const int r = n / n_cols;
  const int c = n - r * n_cols;

  int ty = r * step + off + dy[wi] - base;
  int tx = c * step + off + dx[wi] - base;
  ty = min(max(ty, 0), Hp - T);
  tx = min(max(tx, 0), Wp - T);
  const float* src = frame + (int64_t)b * Hp * Wp + (int64_t)ty * Wp + tx;
  for (int i = threadIdx.x; i < T * T; i += blockDim.x) {
    const int ri = i / T;
    tile[i] = src[(int64_t)ri * Wp + (i - ri * T)];
  }
  __syncthreads();

  const float by = __fadd_rn((float)M, fy[wi]);
  const float bx = __fadd_rn((float)M, fx[wi]);
  const float gyi_ = gyi[wi], gyj_ = gyj[wi], gxi_ = gxi[wi], gxj_ = gxj[wi];
  const float half = (float)(w - 1) * 0.5f;  // exact: a half-integer
  const float hi = __fsub_rn((float)(2 * M + 1), 1e-3f);  // floor(r) <= 2M
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int pi = i / w;
    const int pj = i - pi * w;
    const float ioff = __fsub_rn((float)pi, half);
    const float joff = __fsub_rn((float)pj, half);
    float ry = residual(by, gyi_, ioff, gyj_, joff, hi);
    float rx = residual(bx, gxi_, ioff, gxj_, joff, hi);
    const float fry = floorf(ry);
    const float frx = floorf(rx);
    const float* t = tile + (pi + (int)fry) * T + (pj + (int)frx);
    float acc = 0.0f;
    if (kCubic) {
      float wy[4], wx[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // tap k sits at tile row floor(ry) + k: distance (ry + 1) - ky
        wy[k] = keys(__fsub_rn(__fadd_rn(ry, 1.0f), __fadd_rn(fry, (float)k)));
        wx[k] = keys(__fsub_rn(__fadd_rn(rx, 1.0f), __fadd_rn(frx, (float)k)));
      }
#pragma unroll
      for (int ky = 0; ky < 4; ++ky)
#pragma unroll
        for (int kx = 0; kx < 4; ++kx)
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy[ky], wx[kx]),
                                         t[ky * T + kx]));
    } else {
      // integer sample coordinate in EITHER axis -> floor corner
      if (ry == fry || rx == frx) {
        ry = fry;
        rx = frx;
      }
      float wy[2], wx[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        wy[k] = hat(ry, __fadd_rn(fry, (float)k));
        wx[k] = hat(rx, __fadd_rn(frx, (float)k));
      }
#pragma unroll
      for (int ky = 0; ky < 2; ++ky)
#pragma unroll
        for (int kx = 0; kx < 2; ++kx)
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy[ky], wx[kx]),
                                         t[ky * T + kx]));
    }
    dst[i] = acc;
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx and the four gradient
// maps: [B, N] f32; out: [B, N, w, w] f32 with N = n_rows * n_cols.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).
int def_windows_f32(const float* frame, const int* dy, const int* dx,
                    const float* fy, const float* fx,
                    const float* gyi, const float* gyj,
                    const float* gxi, const float* gxj, float* out,
                    int B, int Hp, int Wp, int n_rows, int n_cols,
                    int w, int step, int off, int M, int cubic, void* stream) {
  const int T = w + 2 * M + (cubic ? 4 : 1);
  const size_t smem = (size_t)T * T * sizeof(float);
  auto kernel = cubic ? def_windows_kernel<true> : def_windows_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      frame, dy, dx, fy, fx, gyi, gyj, gxi, gxj, out,
      Hp, Wp, n_cols, n_win, w, step, off, M);
  return (int)cudaGetLastError();
}

const char* def_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
