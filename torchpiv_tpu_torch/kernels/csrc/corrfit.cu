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
// What the design does about the bound: a group of threads (one warp for
// w <= 32, four windows a block; one block of 256 threads for w = 64, of
// 512 for 128) loads both windows once, neighbouring threads on
// neighbouring addresses, as the real and imaginary part of one complex
// array in shared memory (8.3 KB at 32^2, 33 KB at 64^2, 129 KB at 128^2,
// plus the map), transforms it with whole lines in registers (corrfit.cuh:
// one trip through shared memory per axis and direction for w <= 32 and
// two above, where one radix-2 stage per block-wide barrier took log2(w)
// trips) and fits the map where it lies; 9 bytes a pair come out.  The
// lane packing, the block-diagonal operators and the roll-trees of the TPU
// kernel serve its 128-lane registers and matrix unit and do not come
// across.

#include "corrfit.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(piv::Geometry<W>::BLOCK)
corrfit_kernel(const float* __restrict__ wa, const float* __restrict__ wb,
               const __grid_constant__ piv::Twiddles tw,
               float* __restrict__ u, float* __restrict__ v,
               unsigned char* __restrict__ invalid, int N, int vw,
               float val_ratio, int dc_normalize) {
  using Geo = piv::Geometry<W>;
  extern __shared__ __align__(16) float smem[];
  __shared__ piv::FitScratch scratch;
  const typename piv::GroupOf<W>::type g(scratch);
  const int slot = threadIdx.x / Geo::THREADS;  // window of the block
  const int64_t n = (int64_t)blockIdx.x * Geo::WINDOWS + slot;
  if (n >= N) return;  // a whole group, and its barriers are its own
  constexpr int N2 = W * W;
  float* mine = smem + slot * (Geo::Z_FLOATS + N2);
  float2* z = reinterpret_cast<float2*>(mine);
  float* map = mine + Geo::Z_FLOATS;
  const float* a = wa + n * N2;
  const float* b = wb + n * N2;
  for (int p = g.rank(); p < N2; p += g.size())
    z[(p / W) * Geo::PITCH + (p & (W - 1))] = make_float2(a[p], b[p]);
  g.sync();
  piv::correlate_fit<W>(
      z, map, tw, vw, val_ratio, dc_normalize, g, u + n, v + n,
      invalid == nullptr ? nullptr : invalid + n,
      [&](int row, int col) { return z[row * Geo::PITCH + col]; });
}

template <int W>
size_t shared_bytes() {
  return (size_t)piv::Geometry<W>::WINDOWS *
         (piv::Geometry<W>::Z_FLOATS + W * W) * sizeof(float);
}

template <int W>
int launch(const float* wa, const float* wb, const float* twiddle, float* u,
           float* v, unsigned char* invalid, int N, int vw, float val_ratio,
           int dc_normalize, cudaStream_t stream) {
  using Geo = piv::Geometry<W>;
  const size_t smem = shared_bytes<W>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corrfit_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + Geo::WINDOWS - 1) / Geo::WINDOWS;
  corrfit_kernel<W><<<blocks, Geo::BLOCK, smem, stream>>>(
      wa, wb, piv::full_twiddles(twiddle, W), u, v, invalid, N, vw, val_ratio,
      dc_normalize);
  return (int)cudaGetLastError();
}

template <int W>
int describe(int* out) {
  return piv::describe_kernel<W>(corrfit_kernel<W>, shared_bytes<W>(), out);
}

}  // namespace

extern "C" {

// wa, wb: [N, w, w] f32 on the device; twiddle: [w/2, 2] f32 in HOST memory,
// (cos, -sin)(2*pi*j/w); u, v: [N] f32; invalid: [N] bytes (0/1), or null to
// skip the validation.  w is a power of two in 4..128.  Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int corrfit_f32(const float* wa, const float* wb, const float* twiddle,
                float* u, float* v, unsigned char* invalid, int N, int w,
                int vw, float val_ratio, int dc_normalize, void* stream) {
  PIV_FOR_WINDOW(w, launch, wa, wb, twiddle, u, v, invalid, N, vw, val_ratio,
                 dc_normalize, (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance for window size w.  Returns a CUDA error code, 0 on success.
int corrfit_describe(int w, int* out) { PIV_FOR_WINDOW(w, describe, out); }

const char* corrfit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
