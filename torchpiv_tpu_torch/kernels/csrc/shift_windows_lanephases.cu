// Per-window CWS/DWS window shift, a run of windows per block, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel_lanephases` behind
// `shift_windows_pallas(variant="lanephases")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu on the same float32 padded frame: every window reads a
// (w+1)^2 tile at its origin plus the window's integer shift, clamped into
// the frame, and blends the tile's four corner slices with per-window
// scalar weights; a window whose shift is an integer in either axis copies
// the floor corner.  The plain PyTorch version is `blend_reference`
// (`blend_reference_variant(..., "lanephases")`) in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The idea kept from the TPU variant: a coarse, aligned fetch whose cost is
// shared by the windows of one grid row, and a small bounded remainder per
// window.  The TPU builds a bank of 16 copies of the row's band, rotated in
// steps of 8 lanes, once per window row, and each window finishes with a
// rotate of 0..7 lanes.  Here one block owns a run of adjacent windows of
// one grid row.  It finds the rectangle that covers all their tiles, widens
// it to 16-byte (4-pixel) column boundaries and copies it to shared memory
// once with 16-byte asynchronous copies (the coarse move); neighbouring
// windows overlap by w - step columns, so a frame pixel is fetched once per
// run and not once per window.  Each window then reads its tile at its own
// offset inside the strip: the remainder costs an address, not a move.
//
// Bound on an H100: bytes, the same as shift_windows.cu (at the main path's
// pass-2 shape 66.1 MB of windows and a 17.3 MB frame per frame of the
// batch).  The strip is sized for the widest spread the clamp allows
// (shifts of -S and +S inside one run: 2S more rows and columns than one
// tile), so with random shifts it fetches up to (2S + w + 1) rows where a
// window needs w + 1; a smooth predictor, the engine's case, spreads by a
// pixel or two.
//
// The frame's row pitch is a multiple of 4 and at least Wp + 4 (the wrapper
// pads with zeros beyond Wp); the clamps use the logical Wp.  The blend is
// shift.cuh's: the result matches the plain version to the last bit.

#include <algorithm>

#include "shift.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRun = 8;
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks an SM at the least

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// Floats of shared memory that a run of `run` windows can need.
inline size_t strip_floats(int run, int w, int step, int S) {
  const int T = w + 1;
  const int spread = run > 1 ? 2 * S : 0;
  const int rows = T + spread;
  const int cols = round_up4(T + 3 + (run > 1 ? (run - 1) * step + 2 * S : 0));
  return (size_t)rows * cols;
}

__global__ void __launch_bounds__(kThreads)
shift_windows_lanephases_kernel(const float* __restrict__ frame,
                                const int* __restrict__ dy,
                                const int* __restrict__ dx,
                                const float* __restrict__ fy,
                                const float* __restrict__ fx,
                                float* __restrict__ out,
                                int Hp, int Wp, int pitch, int n_cols,
                                int n_win, int w, int step, int off, int run,
                                int runs_per_row) {
  extern __shared__ __align__(16) float strip[];
  __shared__ int s_ty[kMaxRun], s_tx[kMaxRun];
  const int r = blockIdx.x / runs_per_row;  // grid row
  const int c0 = (blockIdx.x - r * runs_per_row) * run;  // first window
  const int b = blockIdx.y;  // frame of the batch
  const int count = min(run, n_cols - c0);
  const int T = w + 1;
  const int64_t w0 = (int64_t)b * n_win + (int64_t)r * n_cols + c0;

  if (threadIdx.x < count) {
    const int64_t wi = w0 + threadIdx.x;
    piv::tile_origin(r * n_cols + c0 + threadIdx.x, n_cols, step, off, dy[wi],
                     dx[wi], Hp, Wp, T, &s_ty[threadIdx.x], &s_tx[threadIdx.x]);
  }
  __syncthreads();
  int row_lo = s_ty[0], row_hi = s_ty[0], col_lo = s_tx[0], col_hi = s_tx[0];
  for (int g = 1; g < count; ++g) {
    row_lo = min(row_lo, s_ty[g]);
    row_hi = max(row_hi, s_ty[g]);
    col_lo = min(col_lo, s_tx[g]);
    col_hi = max(col_hi, s_tx[g]);
  }
  col_lo &= ~3;  // the coarse, 16-byte aligned origin
  const int rows = row_hi + T - row_lo;
  const int cols = round_up4(col_hi + T - col_lo);
  const int cpr = cols / 4;  // 16-byte pieces of a strip row
  const float* src = frame + ((int64_t)b * Hp + row_lo) * pitch + col_lo;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int ri = i / cpr;
    const int cj = i - ri * cpr;
    piv::cp_async16(strip + ri * cols + 4 * cj, src + (int64_t)ri * pitch + 4 * cj);
  }
  piv::cp_async_wait();
  __syncthreads();

  const int ww = w * w;
  float* dst = out + w0 * ww;  // the run's windows are adjacent in `out`
  for (int i = threadIdx.x; i < count * ww; i += blockDim.x) {
    const int g = i / ww;
    const int k = i - g * ww;
    const int ri = k / w;
    const piv::Blend blend = piv::blend_weights(fy[w0 + g], fx[w0 + g]);
    const float* t = strip + (s_ty[g] - row_lo + ri) * cols
                     + (s_tx[g] - col_lo) + (k - ri * w);
    dst[i] = piv::blend_pixel(t, cols, blend);
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] f32, pitch a multiple of 4 and >= Wp + 4, zeros
// beyond column Wp; dy, dx: [B, N] i32 in [-S, S]; fy, fx: [B, N] f32;
// out: [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success).
int shift_windows_lanephases_f32(const float* frame, const int* dy,
                                 const int* dx, const float* fy,
                                 const float* fx, float* out, int B, int Hp,
                                 int Wp, int pitch, int n_rows, int n_cols,
                                 int w, int step, int off, int S,
                                 void* stream) {
  if (pitch % 4 != 0 || pitch < Wp + 4 || S < 0) return (int)cudaErrorInvalidValue;
  // the longest run whose widest strip fits the budget
  int run = std::min(kMaxRun, n_cols);
  while (run > 1 && strip_floats(run, w, step, S) * sizeof(float) > kSmemBudget)
    --run;
  const size_t smem = strip_floats(run, w, step, S) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_lanephases_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int runs_per_row = (n_cols + run - 1) / run;
  dim3 grid(n_rows * runs_per_row, B);
  shift_windows_lanephases_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_cols, n_rows * n_cols, w,
      step, off, run, runs_per_row);
  return (int)cudaGetLastError();
}

const char* shift_windows_lanephases_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
