// Per-window CWS/DWS window shift of the bfloat16 frame for Hopper
// (sm_90a), plain C interface: the "phases" variant.
//
// Replaces the TPU kernel `_shift_kernel_phases` behind
// `shift_windows_pallas(variant="phases")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu, on a padded frame that the wrapper has rounded to
// bfloat16: every window reads a (w+1)^2 tile at its origin plus the
// window's integer shift, clamped into the frame, and blends the tile's
// four corner slices in float32 with per-window scalar weights; a window
// whose shift is an integer in either axis copies the floor corner.  The
// plain PyTorch version is `blend_reference_variant(..., "phases")` in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The TPU variant keeps a table of pre-shifted copies of the source so
// that no window realigns its tile: on the TPU a tile that starts off the
// (8, 128) grid costs rolls.  An earlier design here kept that means: a
// prologue kernel wrote 8 column-shifted copies of each bfloat16 frame
// (69.5 MB a 4 MP frame, 278 MB of scratch for a batch of 4) so that each
// window could stage its tile by aligned 16-byte `cp.async` copies.  On
// this card a window that is not staged at all has nothing to align: a
// warp reads each tile row straight into registers at any column, so the
// table, its prologue pass and its memory are gone.  The function is the
// same; only the means were the TPU's.
//
// Bound on an H100: bytes, the output plus one bfloat16 frame.  At the main
// path's pass-2 shape (2048^2 frame, w = 32, o = 16, S = 16: N = 16129
// windows) one frame writes N*w*w*4 = 66.1 MB and reads the 2080^2*2 =
// 8.7 MB bfloat16 frame plus 4 maps of N*4 bytes: about 22 us at
// 3.35 TB/s.
//
// What the design does about the bound: shift_windows.cu's, with the lane
// map of warp_lanes.cuh (reach 1), in warp_bilinear.cuh's body, which
// shift_windows_bf16.cu shares: a warp owns a window; the warp walks the
// w + 1 tile rows, each one coalesced 2-byte `__ldg` a slot widened to
// float32 (`__bfloat162float`), `rows_ahead` rows before their first
// store; the right neighbour comes by one shuffle a slot; the blend is
// shift.cuh's `blend_corners`, and each output row one coalesced streaming
// store (`__stcs`).  No shared memory, no barrier, no integer division.
//
// The blend is shift.cuh's: the result matches the plain version to the
// last bit.

#include "warp_bilinear.cuh"

namespace {

using piv::warp::kWarps;
using piv::warp::Lanes;

// Tile rows loaded ahead of their first store, and blocks an SM the
// register budget is cut for, by columns a lane: shift_windows.cu's, but
// six rows for one column a lane, not eight, which spill here (the widened
// bfloat16 loads need more registers); seven were slower, and the rows
// refilled one by one as they are used slower still (timed on an H100,
// PERF.md §6).
template <int K>
__host__ __device__ constexpr int rows_ahead() { return K == 1 ? 6 : 4; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 3 ? 4 : 2; }

template <int K>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<K>())
shift_windows_phases_kernel(const __nv_bfloat16* __restrict__ frame,
                            const int* __restrict__ dy,
                            const int* __restrict__ dx,
                            const float* __restrict__ fy,
                            const float* __restrict__ fx,
                            float* __restrict__ out,
                            int Hp, int Wp, int pitch, int n_rows, int n_cols,
                            int w, int step, int off, int row_start, int lg) {
  piv::warp::bilinear_windows<K, rows_ahead<K>()>(
      frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_rows, n_cols, w, step, off,
      row_start, lg);
}

template <int K>
int launch(const __nv_bfloat16* frame, const int* dy, const int* dx,
           const float* fy, const float* fx, float* out, int B, int Hp, int Wp,
           int pitch, int n_rows, int n_cols, int w, int step, int off,
           int row_start, const Lanes& l, cudaStream_t stream) {
  shift_windows_phases_kernel<K>
      <<<piv::warp::bilinear_grid(B, n_rows, n_cols, l), kWarps * 32, 0, stream>>>(
          frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_rows, n_cols, w, step, off,
          row_start, l.lg);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Lanes& l, int* out) {
  return piv::warp::describe_bilinear(shift_windows_phases_kernel<K>,
                                      l, out);
}

constexpr int kReach = 1;  // tile columns the blend reads past the window
constexpr int kMaxWind = 128;  // four columns a lane

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] bf16 (columns from Wp on are not read); dy, dx:
// [B, N] i32; fy, fx: [B, N] f32; out: [B, N, w, w] f32 with
// N = n_rows * n_cols.  w in 1..128.  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
int shift_windows_phases_f32(const void* frame, const int* dy, const int* dx,
                             const float* fy, const float* fx, float* out,
                             int B, int Hp, int Wp, int pitch, int n_rows,
                             int n_cols, int w, int step, int off,
                             int row_start, void* stream) {
  if (w < 1 || w > kMaxWind || pitch < Wp) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, launch, static_cast<const __nv_bfloat16*>(frame), dy, dx,
                fy, fx, out, B, Hp, Wp, pitch, n_rows, n_cols, w, step, off, row_start, l,
                (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance that serves window size w.  Returns a CUDA error code, 0
// on success.
int shift_windows_phases_describe(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, describe, l, out);
}

const char* shift_windows_phases_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
