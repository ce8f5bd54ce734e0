// One whole PIV pass for Hopper (sm_90a), plain C interface: window shift
// of both frames, correlation and peak fit in one kernel.  Neither the
// windows nor the correlation maps reach device memory.
//
// Replaces the TPU kernel `_fused_kernel` behind `fused_piv_pass`
// (torchpiv_tpu/experimental/fused_pass.py).  Per window: the bilinear
// shift of shift_windows.cu for frame a and for frame b, each with its own
// per-window shift (zero shifts: a plain first pass; integer shifts: the
// DWS tile copy), then the correlation and fit of corrfit.cu.  The plain
// PyTorch version is `fused_pass_reference` in
// torchpiv_tpu_torch/ops/corrfit.py.
//
// Bound on an H100: operations.  The two padded frames are read once
// (2 * 4 * 2080^2 * 4 bytes = 138 MB for a batch of 4 at the pass-2 shape,
// about 0.041 ms at 3.35 TB/s) and 9 bytes a window come out, so the least
// time is that of the transforms: about 6 GFLOP at pass 2 (three real 2-D
// FFTs a window, the blend, the product and the fit), 0.09 ms at the
// card's float32 rate.
//
// What the design does about the bound: one block per window stages the
// clamped (w+1)^2 tile of frame a in shared memory and blends it into the
// real part of the block's complex array, then the tile of frame b into the
// imaginary part (shift.cuh: the windows are bit for bit those of
// shift_windows.cu), and continues with corrfit.cuh's in-place FFTs and
// fit.  One tile buffer serves both frames, so w = 128 fits (194 KB).
// Neighbouring windows overlap by half, so a frame pixel is fetched by up
// to four blocks; the 50 MB L2 holds both 17 MB frames.  The band DMAs,
// the scalar-prefetch maps (and their grid-size limit) and the lane
// packing of the TPU kernel do not come across.

#include "corrfit.cuh"
#include "shift.cuh"

namespace {

__global__ void fused_pass_kernel(
    const float* __restrict__ frame_a, const float* __restrict__ frame_b,
    const int* __restrict__ dya, const int* __restrict__ dxa,
    const float* __restrict__ fya, const float* __restrict__ fxa,
    const int* __restrict__ dyb, const int* __restrict__ dxb,
    const float* __restrict__ fyb, const float* __restrict__ fxb,
    const float2* __restrict__ twiddle,
    float* __restrict__ u, float* __restrict__ v,
    unsigned char* __restrict__ invalid,
    int Hp, int Wp, int n_cols, int n_win, int w, int logw, int step, int off,
    int vw, float val_ratio, int dc_normalize) {
  extern __shared__ __align__(16) float smem[];
  __shared__ piv::FitScratch scratch;
  const int n2 = w * w;
  const int T = w + 1;
  float* re = smem;
  float* im = smem + n2;
  float2* tw = reinterpret_cast<float2*>(smem + 2 * n2);
  float* tile = smem + 2 * n2 + w;
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // pair of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int r = n / n_cols;
  const int c = n - r * n_cols;
  const int64_t frame_off = (int64_t)b * Hp * Wp;

  for (int j = threadIdx.x; j < (w >> 1); j += blockDim.x) tw[j] = twiddle[j];

  piv::stage_tile(frame_a + frame_off, Hp, Wp, r * step + off + dya[wi],
                  c * step + off + dxa[wi], T, tile);
  __syncthreads();
  piv::Blend blend = piv::blend_weights(fya[wi], fxa[wi]);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const int ri = i / w;
    re[i] = piv::blend_pixel(tile + ri * T + (i - ri * w), T, blend);
  }
  __syncthreads();  // the tile is free again

  piv::stage_tile(frame_b + frame_off, Hp, Wp, r * step + off + dyb[wi],
                  c * step + off + dxb[wi], T, tile);
  __syncthreads();
  blend = piv::blend_weights(fyb[wi], fxb[wi]);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    const int ri = i / w;
    im[i] = piv::blend_pixel(tile + ri * T + (i - ri * w), T, blend);
  }
  __syncthreads();

  piv::correlate_fit(re, im, tw, w, logw, vw, val_ratio, dc_normalize, scratch,
                     u + wi, v + wi,
                     invalid == nullptr ? nullptr : invalid + wi);
}

}  // namespace

extern "C" {

// frame_a, frame_b: [B, Hp, Wp] f32 (flat-wrap padded by `off`); dy*, dx*:
// [B, N] i32 and fy*, fx*: [B, N] f32, the floor and fraction of each
// frame's per-window shift; twiddle: [w/2, 2] f32; u, v: [B, N] f32;
// invalid: [B, N] bytes (0/1), or null to skip the validation.  Launches on
// `stream` and returns cudaGetLastError() of the launch (0 on success).
int fused_pass_f32(const float* frame_a, const float* frame_b,
                   const int* dya, const int* dxa, const float* fya,
                   const float* fxa, const int* dyb, const int* dxb,
                   const float* fyb, const float* fxb, const float* twiddle,
                   float* u, float* v, unsigned char* invalid,
                   int B, int Hp, int Wp, int n_rows, int n_cols, int w,
                   int step, int off, int vw, float val_ratio,
                   int dc_normalize, void* stream) {
  const size_t smem =
      (size_t)(2 * w * w + w + (w + 1) * (w + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  fused_pass_kernel<<<grid, piv::corrfit_threads(w), smem,
                      (cudaStream_t)stream>>>(
      frame_a, frame_b, dya, dxa, fya, fxa, dyb, dxb, fyb, fxb,
      reinterpret_cast<const float2*>(twiddle), u, v, invalid, Hp, Wp, n_cols,
      n_win, w, piv::ilog2(w), step, off, vw, val_ratio, dc_normalize);
  return (int)cudaGetLastError();
}

const char* fused_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
