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
// Numerics: logf and IEEE division (no fast-math), the fit's products and
// sums explicitly rounded (__fmul_rn / __fadd_rn / __fsub_rn) in the TPU
// kernel's order.  EPS is added after the subtraction of the minimum, as
// the TPU kernel does; the plain version adds (EPS - min) in one step, which
// can differ in the last bit of samples below 2.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

// Block-wide minimum of v; every thread gets the result.
__device__ float block_min(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from an earlier reduction
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) v = fminf(v, red[i]);
  return v;
}

// Block-wide maximum of v and the least index among its holders.
__device__ void block_argmax(float& v, int& idx, float* red, int* red_i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
    if (ov > v || (ov == v && oi < idx)) {
      v = ov;
      idx = oi;
    }
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = v;
    red_i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  v = red[0];
  idx = red_i[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    if (red[i] > v || (red[i] == v && red_i[i] < idx)) {
      v = red[i];
      idx = red_i[i];
    }
  }
}

__device__ __forceinline__ float gauss3(float lm, float ll, float lr) {
  // (lr - ll) / (2*(ll + lr) - 4*lm)
  const float num = __fsub_rn(lr, ll);
  const float den = __fsub_rn(__fmul_rn(2.0f, __fadd_rn(ll, lr)),
                              __fmul_rn(4.0f, lm));
  return __fdiv_rn(num, den);
}

__global__ void __launch_bounds__(kThreads)
peakfit_kernel(const float* __restrict__ corr, float* __restrict__ u,
               float* __restrict__ v, unsigned char* __restrict__ invalid,
               int d, int k, int vw, float val_ratio, int min_subtract) {
  extern __shared__ float x[];
  __shared__ float red[kWarps];
  __shared__ int red_i[kWarps];
  const int kd = d * k;
  const int64_t n = blockIdx.x;
  const float* src = corr + n * kd;

  // pass 1: stage the map, minimum
  float mn = INFINITY;
  for (int p = threadIdx.x; p < kd; p += blockDim.x) {
    const float c = src[p];
    x[p] = c;
    mn = fminf(mn, c);
  }
  if (min_subtract) mn = block_min(mn, red);

  // pass 2: x = (corr - min) + EPS, its maximum and first maximal index
  float best = -INFINITY;
  int m = kd;
  for (int p = threadIdx.x; p < kd; p += blockDim.x) {
    float c = x[p];
    if (min_subtract) c = __fsub_rn(c, mn);
    c = __fadd_rn(c, kEps);
    x[p] = c;
    if (c > best) {  // ascending p: the first index of a thread's maximum
      best = c;
      m = p;
    }
  }
  block_argmax(best, m, red, red_i);  // its barriers publish x[] as well
  if (m >= kd) m = 0;  // an all-NaN map: argmax of the plain version is moot
  const float cm = best;

  const int left = (m + 1 >= kd - 1) ? m : m + 1;
  const int right = (m - 1 <= 0) ? m : m - 1;
  const int top = (m + k >= kd - 1) ? m : m + k;
  const int bot = (m - k <= 0) ? m : m - k;

  if (threadIdx.x == 0) {
    const float lcm = logf(cm);
    const float lcl = logf(x[left]);
    const float lcr = logf(x[right]);
    const float lct = logf(x[top]);
    const float lcb = logf(x[bot]);
    const float du = gauss3(lcm, lcl, lcr);
    const float dv = gauss3(lcm, lct, lcb);
    const float row = (float)(m / d);  // maps are square (d == k)
    const float col = (float)(m % k);
    u[n] = nan_to_num(__fsub_rn(__fadd_rn(col, du), (float)(k / 2)));
    v[n] = nan_to_num(__fsub_rn(__fadd_rn(row, dv), (float)(d / 2)));
  }
  if (invalid == nullptr) return;

  // pass 3: second peak outside the flat-offset neighbourhood of m
  const bool lo = (m - (vw + k * vw)) < 0;
  const bool hi = (m + (vw + k * vw)) > kd - 1;
  float c2 = 0.0f;  // an excluded sample counts as 0
  for (int p = threadIdx.x; p < kd; p += blockDim.x) {
    const int dd = p - m;
    const int j = (int)rintf(__fdiv_rn((float)dd, (float)k));  // half to even
    bool excl = abs(j) <= vw && abs(dd - k * j) <= vw;
    excl = excl || (p == 0 && lo) || (p == kd - 1 && hi);
    if (!excl) c2 = fmaxf(c2, x[p]);
  }
  c2 = -block_min(-c2, red);
  if (threadIdx.x == 0) {
    const bool degenerate =
        left >= kd - 1 && right <= 0 && top >= kd - 1 && bot <= 0;
    invalid[n] = (__fdiv_rn(cm, c2) < val_ratio || degenerate) ? 1 : 0;
  }
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
