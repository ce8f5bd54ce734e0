// Fused peak fit for Hopper (sm_90a), plain C interface: first peak,
// 3-point Gaussian sub-pixel fit and peak-ratio validation in one pass over
// each correlation map.
//
// Replaces the TPU kernel `_peakfit_kernel` behind
// `correlation_to_displacement_pallas`
// (torchpiv_tpu/experimental/peakfit_pallas.py).  Same function, per map:
//   x = (corr - min(corr)) + EPS   (or corr + EPS without min_subtract);
//   m = first flat index with x >= max(x);
//   the four flat-index neighbours m+1, m-1, m+k, m-k, each replaced by m
//   itself at the ends of the flat map;
//   du = (ln cr - ln cl) / (2*(ln cl + ln cr) - 4*ln cm), dv alike;
//   u = nan_to_num(col + du - k/2), v = nan_to_num(row + dv - d/2);
//   second peak: the maximum of x outside the flat-offset neighbourhood
//   {i + k*j : |i|, |j| <= vw} of m, whose out-of-range offsets collapse
//   onto flat index 0 and kd-1; invalid = cm / c2 < val_ratio, or all four
//   neighbours replaced (a degenerate map).
// The plain PyTorch version is `correlation_to_displacement` in
// torchpiv_tpu_torch/ops/peakfit.py.
//
// The TPU kernel reads a neighbour value with a masked reduction because it
// has no gather; here the values are read from shared memory directly.
//
// Bound on an H100: bytes.  Each map is read once (N*d*k*4 bytes) and 9
// bytes come out: at the pass-2 shape of a 4 MP run (4 pairs, N = 64516
// maps of 32^2) 264 MB, about 79 us at 3.35 TB/s; the work is about 15
// operations a sample.
//
// What the design does about the bound: one block per map copies the map
// into shared memory once (4 KB at 32^2, 16 KB at 64^2, 64 KB at 128^2)
// and makes its three passes (minimum; maximum with its first index;
// masked second maximum) from there, so device memory is read exactly once
// and nothing of size N*d*k is written.  The chain of torch ops it stands
// in for writes and re-reads several [N, d*k] index and mask tensors.
//
// The fit itself (`fit_map`, with its numerics) is in fit.cuh, shared with
// corrfit.cu and fused_pass.cu.  EPS is added after the subtraction of the
// minimum, as the TPU kernel does; the plain version adds (EPS - min) in one
// step, which can differ in the last bit of samples below 2.

#include "fit.cuh"

namespace {

constexpr int kThreads = 128;
// 16 blocks fill an SM's 2048 threads; the bound keeps the kernel within
// the 32 registers a thread that this takes
constexpr int kBlocksPerSM = 16;

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
peakfit_kernel(const float* __restrict__ corr, float* __restrict__ u,
               float* __restrict__ v, unsigned char* __restrict__ invalid,
               int d, int k, int vw, float val_ratio, int min_subtract) {
  extern __shared__ float x[];
  __shared__ piv::FitScratch scratch;
  const int kd = d * k;
  const int64_t n = blockIdx.x;
  const float* src = corr + n * kd;

  // stage the map, minimum
  float mn = INFINITY;
  for (int p = threadIdx.x; p < kd; p += blockDim.x) {
    const float c = src[p];
    x[p] = c;
    mn = fminf(mn, c);
  }
  piv::fit_map(x, mn, d, k, vw, val_ratio, min_subtract, scratch, u + n, v + n,
               invalid == nullptr ? nullptr : invalid + n);
}

}  // namespace

extern "C" {

// corr: [N, d, k] f32 (d == k); u, v: [N] f32; invalid: [N] bytes (0/1), or
// null to skip the validation.  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
int peakfit_f32(const float* corr, float* u, float* v, unsigned char* invalid,
                int N, int d, int k, int vw, float val_ratio,
                int min_subtract, void* stream) {
  const size_t smem = (size_t)d * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        peakfit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  peakfit_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(
      corr, u, v, invalid, d, k, vw, val_ratio, min_subtract);
  return (int)cudaGetLastError();
}

const char* peakfit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
