// The peak fit of one correlation map held in shared memory, by one block:
// first peak, 3-point Gaussian sub-pixel fit and peak-ratio validation.
// Shared by peakfit.cu (maps from device memory), corrfit.cu and
// fused_pass.cu (maps that never leave the block).
//
// The function, per map of d rows and k columns (square, d == k):
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
//
// Numerics: logf and IEEE division (no fast-math), the fit's products and
// sums explicitly rounded (__fmul_rn / __fadd_rn / __fsub_rn) in the TPU
// kernels' order; EPS is added after the subtraction of the minimum.
//
// The threads that fit one map form a group: a whole block (BlockGroup,
// block-wide barriers; the block size a multiple of 32, at most 1024) or
// one warp (WarpGroup, shuffles and warp barriers only, so the warps of a
// block fit their own maps independently).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace piv {

constexpr float kEps = 1e-7f;
constexpr int kMaxWarps = 32;

// Scratch of the block-wide reductions, in static shared memory.
struct FitScratch {
  float red[kMaxWarps];
  int red_i[kMaxWarps];
};

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

// Block-wide minimum of v; every thread gets the result.
__device__ __forceinline__ float block_min(float v, FitScratch& s) {
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read from an earlier reduction
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s.red[0];
  for (int i = 1; i < warps; ++i) v = fminf(v, s.red[i]);
  return v;
}

// Block-wide maximum of v and the least index among its holders.
__device__ __forceinline__ void block_argmax(float& v, int& idx, FitScratch& s) {
  const int warps = (blockDim.x + 31) >> 5;
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
    s.red[threadIdx.x >> 5] = v;
    s.red_i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  v = s.red[0];
  idx = s.red_i[0];
  for (int i = 1; i < warps; ++i) {
    if (s.red[i] > v || (s.red[i] == v && s.red_i[i] < idx)) {
      v = s.red[i];
      idx = s.red_i[i];
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

// All threads of a block.
struct BlockGroup {
  FitScratch& s;
  __device__ __forceinline__ explicit BlockGroup(FitScratch& scratch) : s(scratch) {}
  __device__ __forceinline__ int rank() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ float min(float v) const { return block_min(v, s); }
  __device__ __forceinline__ void argmax(float& v, int& idx) const {
    block_argmax(v, idx, s);
  }
};

// The 32 threads of one warp; every lane must be active.
struct WarpGroup {
  __device__ __forceinline__ explicit WarpGroup(FitScratch&) {}
  __device__ __forceinline__ int rank() const { return threadIdx.x & 31; }
  __device__ __forceinline__ int size() const { return 32; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ float min(float v) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  // like block_argmax, it publishes the group's earlier shared-memory writes
  __device__ __forceinline__ void argmax(float& v, int& idx) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, o);
      if (ov > v || (ov == v && oi < idx)) {
        v = ov;
        idx = oi;
      }
    }
    __syncwarp();
  }
};

// Fit the raw map x[d*k] in shared memory and write this map's u, v and,
// unless `invalid` is null, its validation flag.  Called by every thread of
// the group g.  On entry thread t has written the samples p = t, t + size,
// ... of x itself and `mn` is the minimum over those; x is overwritten.
template <class Group>
__device__ __forceinline__ void fit_map(const Group& g, float* x, float mn, int d,
                                        int k, int vw, float val_ratio,
                                        int min_subtract, float* u, float* v,
                                        unsigned char* invalid) {
  const int kd = d * k;
  if (min_subtract) mn = g.min(mn);

  // x = (corr - min) + EPS, its maximum and first maximal index
  float best = -INFINITY;
  int m = kd;
  for (int p = g.rank(); p < kd; p += g.size()) {
    float c = x[p];
    if (min_subtract) c = __fsub_rn(c, mn);
    c = __fadd_rn(c, kEps);
    x[p] = c;
    if (c > best) {  // ascending p: the first index of a thread's maximum
      best = c;
      m = p;
    }
  }
  g.argmax(best, m);  // its barriers publish x[] as well
  if (m >= kd) m = 0;  // an all-NaN map: argmax of the plain version is moot
  const float cm = best;

  const int left = (m + 1 >= kd - 1) ? m : m + 1;
  const int right = (m - 1 <= 0) ? m : m - 1;
  const int top = (m + k >= kd - 1) ? m : m + k;
  const int bot = (m - k <= 0) ? m : m - k;

  if (g.rank() == 0) {
    const float lcm = logf(cm);
    const float lcl = logf(x[left]);
    const float lcr = logf(x[right]);
    const float lct = logf(x[top]);
    const float lcb = logf(x[bot]);
    const float du = gauss3(lcm, lcl, lcr);
    const float dv = gauss3(lcm, lct, lcb);
    const float row = (float)(m / d);  // maps are square (d == k)
    const float col = (float)(m % k);
    *u = nan_to_num(__fsub_rn(__fadd_rn(col, du), (float)(k / 2)));
    *v = nan_to_num(__fsub_rn(__fadd_rn(row, dv), (float)(d / 2)));
  }
  if (invalid == nullptr) return;

  // second peak outside the flat-offset neighbourhood of m
  const bool lo = (m - (vw + k * vw)) < 0;
  const bool hi = (m + (vw + k * vw)) > kd - 1;
  float c2 = 0.0f;  // an excluded sample counts as 0
  // dd / k: by a power of two, the product with 1 / k is the same number
  const bool pow2 = (k & (k - 1)) == 0;
  const float inv_k = __fdiv_rn(1.0f, (float)k);
  for (int p = g.rank(); p < kd; p += g.size()) {
    const int dd = p - m;
    const float q = pow2 ? __fmul_rn((float)dd, inv_k)
                         : __fdiv_rn((float)dd, (float)k);
    const int j = (int)rintf(q);  // half to even
    bool excl = abs(j) <= vw && abs(dd - k * j) <= vw;
    excl = excl || (p == 0 && lo) || (p == kd - 1 && hi);
    if (!excl) c2 = fmaxf(c2, x[p]);
  }
  c2 = -g.min(-c2);
  if (g.rank() == 0) {
    const bool degenerate =
        left >= kd - 1 && right <= 0 && top >= kd - 1 && bot <= 0;
    *invalid = (__fdiv_rn(cm, c2) < val_ratio || degenerate) ? 1 : 0;
  }
}

// The same by a whole block, with its reduction scratch.
__device__ __forceinline__ void fit_map(float* x, float mn, int d, int k, int vw,
                                        float val_ratio, int min_subtract,
                                        FitScratch& s, float* u, float* v,
                                        unsigned char* invalid) {
  fit_map(BlockGroup(s), x, mn, d, k, vw, val_ratio, min_subtract, u, v, invalid);
}

}  // namespace piv
