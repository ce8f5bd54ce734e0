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
// What the design does about the bound: a group of threads (one warp for
// w <= 32, four windows a block; one block of 256 or 512 threads above) stages the
// clamped (w+1)^2 tiles of both frames in shared memory at once by
// asynchronous copies (that of frame b where the complex array will lie), and the threads of the first
// row transform blend their samples of a + i*b straight from the two tiles
// into registers (shift.cuh: the windows are bit for bit those of
// shift_windows.cu; threads a row apart in a tile of odd pitch meet on no
// bank), so the windows themselves are never stored; it continues with
// corrfit.cuh's transforms, whole lines in registers, and fit.  The tile
// buffer of frame a then holds the map, so w = 128 fits (195 KB).  Neighbouring windows
// overlap by half, so a frame pixel is fetched by up to four groups; the
// 50 MB L2 holds both 17 MB frames.  The band DMAs, the scalar-prefetch
// maps (and their grid-size limit) and the lane packing of the TPU kernel
// do not come across.

#include "corrfit.cuh"
#include "shift.cuh"

namespace {

// floats of a window's tile, which later holds its map; even, so that the
// next window's complex array stays aligned
template <int W>
constexpr int kTileFloats = ((W + 1) * (W + 1) + 1) & ~1;

template <int W>
__global__ void __launch_bounds__(piv::Geometry<W>::BLOCK) fused_pass_kernel(
    const float* __restrict__ frame_a, const float* __restrict__ frame_b,
    const int* __restrict__ dya, const int* __restrict__ dxa,
    const float* __restrict__ fya, const float* __restrict__ fxa,
    const int* __restrict__ dyb, const int* __restrict__ dxb,
    const float* __restrict__ fyb, const float* __restrict__ fxb,
    const __grid_constant__ piv::Twiddles tw,
    float* __restrict__ u, float* __restrict__ v,
    unsigned char* __restrict__ invalid,
    int Hp, int Wp, int n_cols, int n_win, int n_total, int step, int off,
    int vw, float val_ratio, int dc_normalize) {
  using Geo = piv::Geometry<W>;
  extern __shared__ __align__(16) float smem[];
  __shared__ piv::FitScratch scratch;
  const typename piv::GroupOf<W>::type g(scratch);
  constexpr int T = W + 1;
  const int slot = threadIdx.x / Geo::THREADS;  // window of the block
  const int64_t wi = (int64_t)blockIdx.x * Geo::WINDOWS + slot;
  if (wi >= n_total) return;  // a whole group, and its barriers are its own
  float* mine = smem + slot * (Geo::Z_FLOATS + kTileFloats<W>);
  float2* z = reinterpret_cast<float2*>(mine);
  float* tile = mine + Geo::Z_FLOATS;
  const int b = (int)(wi / n_win);  // pair of the batch
  const int n = (int)(wi - (int64_t)b * n_win);  // window, row-major over the grid
  const int r = n / n_cols;
  const int c = n - r * n_cols;
  const int64_t frame_off = (int64_t)b * Hp * Wp;

  // tile a in the tile buffer, tile b where the complex array will lie
  float* tile_b = mine;
  piv::stage_tile_async(frame_a + frame_off, Hp, Wp, r * step + off + dya[wi],
                        c * step + off + dxa[wi], T, tile, g.rank(), g.size());
  piv::stage_tile_async(frame_b + frame_off, Hp, Wp, r * step + off + dyb[wi],
                        c * step + off + dxb[wi], T, tile_b, g.rank(), g.size());
  const piv::Blend blend_a = piv::blend_weights(fya[wi], fxa[wi]);
  const piv::Blend blend_b = piv::blend_weights(fyb[wi], fxb[wi]);
  piv::cp_async_wait();
  g.sync();

  // the row transforms blend their samples straight from the two tiles
  piv::correlate_fit<W>(
      z, tile, tw, vw, val_ratio, dc_normalize, g, u + wi, v + wi,
      invalid == nullptr ? nullptr : invalid + wi, [&](int row, int col) {
        const int at = row * T + col;
        return make_float2(piv::blend_pixel(tile + at, T, blend_a),
                           piv::blend_pixel(tile_b + at, T, blend_b));
      });
}

template <int W>
size_t shared_bytes() {
  return (size_t)piv::Geometry<W>::WINDOWS *
         (piv::Geometry<W>::Z_FLOATS + kTileFloats<W>) * sizeof(float);
}

template <int W>
int launch(const float* frame_a, const float* frame_b, const int* dya,
           const int* dxa, const float* fya, const float* fxa, const int* dyb,
           const int* dxb, const float* fyb, const float* fxb,
           const float* twiddle, float* u, float* v, unsigned char* invalid,
           int B, int Hp, int Wp, int n_rows, int n_cols, int step, int off,
           int vw, float val_ratio, int dc_normalize, cudaStream_t stream) {
  using Geo = piv::Geometry<W>;
  const size_t smem = shared_bytes<W>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_pass_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  const int64_t n_total = (int64_t)B * n_win;
  if (n_total > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n_total + Geo::WINDOWS - 1) / Geo::WINDOWS);
  fused_pass_kernel<W><<<blocks, Geo::BLOCK, smem, stream>>>(
      frame_a, frame_b, dya, dxa, fya, fxa, dyb, dxb, fyb, fxb,
      piv::full_twiddles(twiddle, W), u, v, invalid, Hp, Wp, n_cols, n_win,
      (int)n_total, step, off, vw, val_ratio, dc_normalize);
  return (int)cudaGetLastError();
}

template <int W>
int describe(int* out) {
  return piv::describe_kernel<W>(fused_pass_kernel<W>, shared_bytes<W>(), out);
}

}  // namespace

extern "C" {

// frame_a, frame_b: [B, Hp, Wp] f32 (flat-wrap padded by `off`); dy*, dx*:
// [B, N] i32 and fy*, fx*: [B, N] f32, the floor and fraction of each
// frame's per-window shift; twiddle: [w/2, 2] f32 in HOST memory; u, v:
// [B, N] f32; invalid: [B, N] bytes (0/1), or null to skip the validation.
// w is a power of two in 4..128.  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
int fused_pass_f32(const float* frame_a, const float* frame_b,
                   const int* dya, const int* dxa, const float* fya,
                   const float* fxa, const int* dyb, const int* dxb,
                   const float* fyb, const float* fxb, const float* twiddle,
                   float* u, float* v, unsigned char* invalid,
                   int B, int Hp, int Wp, int n_rows, int n_cols, int w,
                   int step, int off, int vw, float val_ratio,
                   int dc_normalize, void* stream) {
  PIV_FOR_WINDOW(w, launch, frame_a, frame_b, dya, dxa, fya, fxa, dyb, dxb, fyb,
                 fxb, twiddle, u, v, invalid, B, Hp, Wp, n_rows, n_cols, step,
                 off, vw, val_ratio, dc_normalize, (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance for window size w.  Returns a CUDA error code, 0 on success.
int fused_pass_describe(int w, int* out) { PIV_FOR_WINDOW(w, describe, out); }

const char* fused_pass_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
