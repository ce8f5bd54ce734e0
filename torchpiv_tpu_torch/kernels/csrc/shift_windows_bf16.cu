// Per-window CWS/DWS window shift of the frame rounded to bfloat16 for
// Hopper (sm_90a), plain C interface: the "bf16" variant.
//
// Replaces the TPU kernel `_shift_kernel_bf16` behind
// `shift_windows_pallas(variant="bf16")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu, on the flat-wrap-padded frame rounded to bfloat16
// (round to nearest even): every window reads a (w+1)^2 tile at its origin
// plus the window's integer shift, clamped into the frame, and blends the
// tile's four corner slices in float32 with per-window scalar weights; a
// window whose shift is an integer in either axis copies the floor corner.
// The plain PyTorch version is `blend_reference_variant(..., "bf16")` in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The TPU variant cast the padded frame to bfloat16 so that its band DMAs
// and rolls moved half the bytes; only the blend saw float32.  On this card
// half-width loads buy nothing: the warp-a-window shift of the bfloat16
// frame ("phases", the same body) took 0.1791 ms a launch at the 4 MP
// pass-2 shape against 0.1746 for shift_windows.cu on the float32 frame in
// the same run (PERF.md §6), and the bfloat16 frame cost the wrapper a cast
// and pad pass of its own (0.097 ms).  Half-width data is the TPU's means;
// the function is the rounding.  So this kernel reads the float32 frame
// that shift_windows.cu reads and rounds the loaded samples in registers,
// two to a `cvt.rn.bf16x2.f32` (then each widened back by a shift or a
// mask): no pass and no copy of the frame.  Rounding one sample at a time
// (two instructions each) took 0.203 ms; two at a time, 0.163.
//
// Bound on an H100: bytes, row 1's.  At the main path's pass-2 shape
// (2048^2 frame, w = 32, o = 16, S = 16: N = 16129 windows) one frame
// writes N*w*w*4 = 66.1 MB and reads the 2080*2088*4 = 17.4 MB float32
// frame plus 4 maps of N*4 bytes: 83.7 MB, about 25 us at 3.35 TB/s (the
// earlier bound of this variant, 22 us, counted the bfloat16 frame and left
// out the cast's read of the float32 one).
//
// What the design does about the bound: warp_bilinear.cuh's body, shared
// with shift_windows_phases.cu, with the lane map of warp_lanes.cuh (reach
// 1): a warp owns a window; the warp walks the w + 1 tile rows, each one
// coalesced 4-byte `__ldg` a slot rounded to bfloat16 in registers,
// `rows_ahead` rows before their first store; the right neighbour comes by
// one shuffle a slot; the blend is shift.cuh's `blend_corners`, each output
// row one coalesced streaming store.  No shared memory, no barrier, no
// integer division.  The earlier design here staged each window's tile in
// shared memory from a bfloat16 copy, behind a block barrier, with an
// integer division a pixel.
//
// The blend is shift.cuh's: the result matches the plain version to the
// last bit.

#include "warp_bilinear.cuh"

namespace {

using piv::warp::kWarps;
using piv::warp::Lanes;
using piv::warp::RoundedF32;

// Tile rows loaded ahead of their first store, and blocks an SM the
// register budget is cut for, by columns a lane: those of
// shift_windows_phases.cu, whose loads widen alike.  Six and seven rows
// timed alike (0.1645, 0.1621 ms), eight spill, four are slower (0.1930;
// tools/warp_shift_depth_cuda.py on an H100, PERF.md §6).
template <int K>
__host__ __device__ constexpr int rows_ahead() { return K == 1 ? 6 : 4; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 3 ? 4 : 2; }

template <int K>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<K>())
shift_windows_bf16_kernel(const RoundedF32* __restrict__ frame,
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
int launch(const RoundedF32* frame, const int* dy, const int* dx, const float* fy,
           const float* fx, float* out, int B, int Hp, int Wp, int pitch,
           int n_rows, int n_cols, int w, int step, int off, int row_start,
           const Lanes& l,
           cudaStream_t stream) {
  shift_windows_bf16_kernel<K>
      <<<piv::warp::bilinear_grid(B, n_rows, n_cols, l), kWarps * 32, 0, stream>>>(
          frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_rows, n_cols, w, step, off,
          row_start, l.lg);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Lanes& l, int* out) {
  return piv::warp::describe_bilinear(shift_windows_bf16_kernel<K>, l,
                                      out);
}

constexpr int kReach = 1;  // tile columns the blend reads past the window
constexpr int kMaxWind = 128;  // four columns a lane

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] f32, the padded frame itself (columns from Wp on
// are not read); dy, dx: [B, N] i32; fy, fx: [B, N] f32; out: [B, N, w, w]
// f32 with N = n_rows * n_cols.  w in 1..128.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
int shift_windows_bf16_f32(const void* frame, const int* dy, const int* dx,
                           const float* fy, const float* fx, float* out,
                           int B, int Hp, int Wp, int pitch, int n_rows,
                           int n_cols, int w, int step, int off, int row_start,
                           void* stream) {
  if (w < 1 || w > kMaxWind || pitch < Wp) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, launch, static_cast<const RoundedF32*>(frame), dy, dx, fy, fx,
                out, B, Hp, Wp, pitch, n_rows, n_cols, w, step, off, row_start, l,
                (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance that serves window size w.  Returns a CUDA error code, 0
// on success.
int shift_windows_bf16_describe(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, describe, l, out);
}

const char* shift_windows_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
