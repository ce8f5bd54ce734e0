// Per-window CWS/DWS window shift for Hopper (sm_90a), plain C interface:
// the "lanephases" variant.
//
// Replaces the TPU kernel `_shift_kernel_lanephases` behind
// `shift_windows_pallas(variant="lanephases")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu on the same float32 padded frame: every window reads a
// (w+1)^2 tile at its origin plus the window's integer shift, clamped into
// [0, Hp-w-1] x [0, Wp-w-1], and blends the tile's four corner slices with
// per-window scalar weights; a window whose shift is an integer in either
// axis copies the floor corner.  The plain PyTorch version is
// `blend_reference_variant(..., "lanephases")` in
// torchpiv_tpu_torch/ops/shifts.py, whose `warp_window_steps` replays this
// kernel's lanes on the CPU.
//
// The TPU variant's idea was a coarse bulk move of a grid row's band and a
// remainder that costs only an address.  Its Hopper form was tried and
// measured first: a ring of shared-memory stages a warp, each window's tile
// brought by the copy engine (`cp.async.bulk`, a tile row a copy; tensor-map
// boxes fault on the machines this port is measured on) or by 16-byte
// `cp.async` pieces, `mbarrier`-synchronised, blended from shared memory
// (tools/lanephases_ring.cu).  At the main path's pass-2 shape it took
// 0.1735 ms at best (16-byte pieces, two stages, eight warps a block;
// 0.1788 with the copy engine), against 0.1555 for this kernel in the same
// run: the ring's shared memory caps the warps an SM holds, and more
// warps, not deeper rings, made it faster (PERF.md §6, PR 10,
// tools/lanephases_ring_cuda.py on an NVIDIA H100).  So the variant takes
// the faster design: warp_bilinear.cuh's body on the float32 frame, the
// body of "bf16" (which rounds each sample) and "phases" (which reads a
// bfloat16 frame), with the lane map of warp_lanes.cuh (reach 1).  A warp
// owns a window (or 32 / G windows of up to 16 px) and walks its w + 1
// tile rows, each one coalesced `__ldg` a slot, `rows_ahead` rows before
// their first store; the right neighbour comes by one shuffle a slot; the
// blend is shift.cuh's `blend_corners`, each output row one coalesced
// streaming store.  No shared memory, no barrier, no integer division.
// The earlier design here staged a strip for a run of up to 8 windows in
// shared memory behind a block barrier, sized for the widest spread the
// clamp allows, with an integer division a pixel, on a frame padded to a
// pitch of Wp + 4 (0.271 ms plus a 0.087 ms pad).  This one reads the
// padded frame itself.
//
// Bound on an H100: bytes, row 1's.  At the main path's pass-2 shape
// (2048^2 frame, w = 32, o = 16, S = 16: N = 16129 windows) one frame
// writes N*w*w*4 = 66.1 MB and reads the 2080*2088*4 = 17.4 MB frame plus
// 4 maps of N*4 bytes: 83.7 MB, about 25 us at 3.35 TB/s.
//
// The blend is shift.cuh's: the result matches the plain version, and
// shift_windows.cu, to the last bit.

#include "warp_bilinear.cuh"

namespace {

using piv::warp::kWarps;
using piv::warp::Lanes;

// Tile rows loaded ahead of their first store, and blocks an SM the
// register budget is cut for, by columns a lane.  Six, seven and eight
// rows took 0.1588, 0.1555 and 0.1522 ms; eight spill (8 B) at the 64
// registers that four blocks of 256 threads an SM leave
// (tools/lanephases_ring_cuda.py on an H100, PERF.md §6).
template <int K>
__host__ __device__ constexpr int rows_ahead() { return K == 1 ? 7 : 4; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 3 ? 4 : 2; }

template <int K>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<K>())
shift_windows_lanephases_kernel(const float* __restrict__ frame,
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
int launch(const float* frame, const int* dy, const int* dx, const float* fy,
           const float* fx, float* out, int B, int Hp, int Wp, int pitch,
           int n_rows, int n_cols, int w, int step, int off, int row_start,
           const Lanes& l,
           cudaStream_t stream) {
  shift_windows_lanephases_kernel<K>
      <<<piv::warp::bilinear_grid(B, n_rows, n_cols, l), kWarps * 32, 0, stream>>>(
          frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_rows, n_cols, w, step, off,
          row_start, l.lg);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Lanes& l, int* out) {
  return piv::warp::describe_bilinear(shift_windows_lanephases_kernel<K>, l, out);
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
int shift_windows_lanephases_f32(const float* frame, const int* dy, const int* dx,
                                 const float* fy, const float* fx, float* out, int B,
                                 int Hp, int Wp, int pitch, int n_rows, int n_cols,
                                 int w, int step, int off, int row_start,
                                 void* stream) {
  if (w < 1 || w > kMaxWind || pitch < Wp) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, launch, frame, dy, dx, fy, fx, out, B, Hp, Wp, pitch, n_rows,
                n_cols, w, step, off, row_start, l, (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance that serves window size w.  Returns a CUDA error code, 0
// on success.
int shift_windows_lanephases_describe(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, describe, l, out);
}

const char* shift_windows_lanephases_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
