// Fused correlation and peak fit for Hopper (sm_90a), plain C interface: no
// correlation map reaches device memory.
//
// Replaces the TPU kernel `_corrfit_kernel` behind
// `correlate_peakfit_pallas` (torchpiv_tpu/experimental/fused_pass.py),
// which computes the same function by DFT-matrix products on lane-packed
// window groups.  Per window pair (a, b) of w x w pixels, w a power of two
// in 4..128:
//   corr = fftshift(real(IDFT2(conj(DFT2 a) * DFT2 b)));
//   with dc_normalize, corr * w^4 / (sum a * sum b);
//   x = (corr - min) + EPS, first flat argmax, gauss3 fit with the
//   flat-index edge rules, peak-ratio validation (see fit.cuh).
// The plain PyTorch version is `correlate_peakfit_reference` in
// torchpiv_tpu_torch/ops/corrfit.py.
//
// Bound on an H100: bytes.  Each window is read once: at the pass-2 shape
// of a 4 MP run (4 pairs, N = 64516 pairs of 32^2) 2 * 264 MB, about
// 0.158 ms at 3.35 TB/s; the least work for the function, three real 2-D
// FFTs of 5 * w^2 * log2(w^2) / 2 operations each plus the product and the
// fit, is about 6 GFLOP, 0.09 ms at the card's float32 rate.
//
// What the design does about the bound: one block per window pair loads
// both windows once, as the real and imaginary part of one complex array
// in shared memory (8 KB at 32^2, 32 KB at 64^2, 128 KB at 128^2), runs one
// forward and one inverse radix-2 FFT in place (corrfit.cuh) and fits the
// map where it lies; 9 bytes a pair come out.  The lane packing, the
// block-diagonal operators and the roll-trees of the TPU kernel serve its
// 128-lane registers and matrix unit and do not come across.  The kernel
// is bound by the latency of its 4 * log2(w) synchronised butterfly
// stages, not by bytes; registers-resident row transforms are later work.

#include "corrfit.cuh"

namespace {

__global__ void corrfit_kernel(const float* __restrict__ wa,
                               const float* __restrict__ wb,
                               const float2* __restrict__ twiddle,
                               float* __restrict__ u, float* __restrict__ v,
                               unsigned char* __restrict__ invalid,
                               int w, int logw, int vw, float val_ratio,
                               int dc_normalize) {
  extern __shared__ __align__(16) float smem[];
  __shared__ piv::FitScratch scratch;
  const int n2 = w * w;
  float* re = smem;
  float* im = smem + n2;
  float2* tw = reinterpret_cast<float2*>(smem + 2 * n2);
  const int64_t n = blockIdx.x;
  const float* a = wa + n * n2;
  const float* b = wb + n * n2;
  for (int p = threadIdx.x; p < n2; p += blockDim.x) {
    re[p] = a[p];
    im[p] = b[p];
  }
  for (int j = threadIdx.x; j < (w >> 1); j += blockDim.x) tw[j] = twiddle[j];
  __syncthreads();
  piv::correlate_fit(re, im, tw, w, logw, vw, val_ratio, dc_normalize, scratch,
                     u + n, v + n, invalid == nullptr ? nullptr : invalid + n);
}

}  // namespace

extern "C" {

// wa, wb: [N, w, w] f32; twiddle: [w/2, 2] f32, (cos, -sin)(2*pi*j/w);
// u, v: [N] f32; invalid: [N] bytes (0/1), or null to skip the validation.
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success).
int corrfit_f32(const float* wa, const float* wb, const float* twiddle,
                float* u, float* v, unsigned char* invalid, int N, int w,
                int vw, float val_ratio, int dc_normalize, void* stream) {
  const size_t smem = (size_t)(2 * w * w + w) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corrfit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  corrfit_kernel<<<N, piv::corrfit_threads(w), smem, (cudaStream_t)stream>>>(
      wa, wb, reinterpret_cast<const float2*>(twiddle), u, v, invalid, w,
      piv::ilog2(w), vw, val_ratio, dc_normalize);
  return (int)cudaGetLastError();
}

const char* corrfit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
