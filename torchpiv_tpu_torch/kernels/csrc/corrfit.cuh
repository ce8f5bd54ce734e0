// Cross-correlation of one window pair in shared memory followed by the
// peak fit, by one block.  Shared by corrfit.cu (windows from device
// memory) and fused_pass.cu (windows shifted inside the block).
//
// The function, for two real w x w windows a and b, w a power of two:
//   corr = fftshift(real(IDFT2(conj(DFT2 a) * DFT2 b)));
//   with dc_normalize (pass 1), corr * w^4 / (sum a * sum b);
//   then the fit of fit.cuh with min_subtract.
//
// How: a and b are the real and imaginary part of one complex array
// z = a + i*b, so ONE complex 2-D transform gives both spectra,
//   A[k] = (Z[k] + conj(Z[-k])) / 2,  B[k] = (Z[k] - conj(Z[-k])) / (2i),
// and the Hermitian product C = conj(A) * B transforms back to the real
// map.  The transforms are radix-2 FFTs over the rows and then the columns
// of the array where it lies: forward by decimation in frequency (natural
// order in, bit-reversed order out), inverse by decimation in time
// (bit-reversed in, natural out), so no reordering pass is needed; the
// product step addresses Z[-k] through the bit reversal.  The fftshift is
// the sign (-1)^(k1+k2) on the product, the inverse's 1/w^2 a power of two
// folded into the same factor.  The twiddle factors exp(-2*pi*i*j/w),
// j < w/2, come from a table computed on the host in float64.
//
// Everything is float32 (no TF32, no bfloat16).  The sums run in another
// order than the plain version's (torch.fft), so the two agree to a
// tolerance, not to the last bit.

#pragma once

#include "fit.cuh"

namespace piv {

// One radix-2 transform of every row (along_rows) or column of the w x w
// complex array (re, im); tw[j] = (cos, -sin)(2*pi*j/w).  Ends synchronised.
template <bool kInverse>
__device__ __forceinline__ void fft_axis(float* re, float* im, const float2* tw,
                                         int w, int logw, bool along_rows) {
  const int hw = w >> 1;
  const int nb = w * hw;  // butterflies a stage
  for (int s = 0; s < logw; ++s) {
    const int half = kInverse ? (1 << s) : (w >> (s + 1));
    const int tstep = hw / half;
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      // neighbouring threads take neighbouring addresses
      int line, bf;
      if (along_rows) {
        line = t / hw;
        bf = t - line * hw;
      } else {
        bf = t / w;
        line = t - bf * w;
      }
      const int j = bf & (half - 1);
      const int i0 = ((bf - j) << 1) + j;
      const int i1 = i0 + half;
      const int p0 = along_rows ? line * w + i0 : i0 * w + line;
      const int p1 = along_rows ? line * w + i1 : i1 * w + line;
      const float2 c = tw[j * tstep];
      const float ar = re[p0], ai = im[p0], br = re[p1], bi = im[p1];
      if (!kInverse) {
        const float dr = ar - br, di = ai - bi;
        re[p0] = ar + br;
        im[p0] = ai + bi;
        re[p1] = dr * c.x - di * c.y;
        im[p1] = dr * c.y + di * c.x;
      } else {  // b * conj(c)
        const float tr = br * c.x + bi * c.y;
        const float ti = bi * c.x - br * c.y;
        re[p0] = ar + tr;
        im[p0] = ai + ti;
        re[p1] = ar - tr;
        im[p1] = ai - ti;
      }
    }
    __syncthreads();
  }
}

// Position, in bit-reversed storage, of the frequency opposite to the one
// stored at position p.
__device__ __forceinline__ int opposite(int p, int w, int logw) {
  const int k = (int)(__brev((unsigned)p) >> (32 - logw));
  return (int)(__brev((unsigned)((w - k) & (w - 1))) >> (32 - logw));
}

// On entry re[] holds window a and im[] window b (w*w floats each, row
// major, visible to the whole block) and tw[] the twiddle table; all three
// are overwritten or read by every thread of the block.  Writes this
// window pair's u, v and, unless `invalid` is null, its validation flag.
__device__ __forceinline__ void correlate_fit(float* re, float* im,
                                              const float2* tw, int w, int logw,
                                              int vw, float val_ratio,
                                              int dc_normalize, FitScratch& s,
                                              float* u, float* v,
                                              unsigned char* invalid) {
  const int n = w * w;
  fft_axis<false>(re, im, tw, w, logw, true);
  fft_axis<false>(re, im, tw, w, logw, false);

  // Z[0] = sum(a) + i * sum(b)
  const float sum_a = re[0], sum_b = im[0];
  __syncthreads();  // every thread has read Z[0] before the product lands

  // C = conj(A) * B on each pair of opposite frequencies
  const float scale = 1.0f / (float)n;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int p = idx / w, q = idx - p * w;
    const int idn = opposite(p, w, logw) * w + opposite(q, w, logw);
    if (idn < idx) continue;  // its partner writes both
    const float zr = re[idx], zi = im[idx], nr = re[idn], ni = im[idn];
    const float a_r = 0.5f * (zr + nr), a_i = 0.5f * (zi - ni);
    const float b_r = 0.5f * (zi + ni), b_i = -0.5f * (zr - nr);
    const int k1 = (int)(__brev((unsigned)p) >> (32 - logw));
    const int k2 = (int)(__brev((unsigned)q) >> (32 - logw));
    const float sg = ((k1 + k2) & 1) ? -scale : scale;
    const float c_r = (a_r * b_r + a_i * b_i) * sg;
    const float c_i = (a_r * b_i - a_i * b_r) * sg;
    re[idx] = c_r;
    im[idx] = c_i;
    re[idn] = c_r;
    im[idn] = -c_i;
  }
  __syncthreads();

  fft_axis<true>(re, im, tw, w, logw, false);
  fft_axis<true>(re, im, tw, w, logw, true);

  // re[] is the map; scale it (pass 1) and take the minimum
  float norm = 1.0f;
  if (dc_normalize) {
    const float w2 = (float)n;
    norm = __fdiv_rn(__fmul_rn(w2, w2), __fmul_rn(sum_a, sum_b));
  }
  float mn = INFINITY;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    float c = re[p];
    if (dc_normalize) c = __fmul_rn(c, norm);
    re[p] = c;
    mn = fminf(mn, c);
  }
  fit_map(re, mn, w, w, vw, val_ratio, 1, s, u, v, invalid);
}

// Threads of a block for window size w: one per butterfly of a stage, up
// to 256, in whole warps.
inline int corrfit_threads(int w) {
  const int nb = w * w / 2;
  return nb >= 256 ? 256 : (nb < 32 ? 32 : nb);
}

inline int ilog2(int w) {
  int l = 0;
  while ((1 << l) < w) ++l;
  return l;
}

}  // namespace piv
