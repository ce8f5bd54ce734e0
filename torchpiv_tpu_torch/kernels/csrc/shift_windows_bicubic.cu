// Per-window bicubic (Keys cubic convolution, a = -0.5) window shift for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel_bicubic` behind
// `shift_windows_pallas(interp="bicubic")`
// (torchpiv_tpu/kernels/shift_pallas.py).  Same function: every window of
// every frame reads a (w+4)^2 tile of the padded frame at its origin plus
// the window's integer shift minus one (the stencil reaches floor-1 ..
// floor+2), clamped into the frame, and sums the tile's 16 shifted slices
// with per-window scalar weights cubic_weights(fy), cubic_weights(fx):
//   out = sum_ky wy[ky] * (sum_kx wx[kx] * tile[i+ky, j+kx]).
// Integer shifts give the weights (0, 1, 0, 0) exactly, so they copy the
// integer sample.  The plain PyTorch version is `blend_reference_bicubic`
// in torchpiv_tpu_torch/ops/shifts.py; its steps, lane by lane, are
// replayed on the CPU by `warp_bicubic_steps` there.
//
// Bound on an H100: bytes.  At the pass-2 shape of a 4 MP run (2048^2
// frame, w = 32, o = 16, S = 16: N = 16129 windows, pad S + 2) one frame
// writes N*w*w*4 = 66.1 MB and reads the 2084^2*4 = 17.4 MB padded frame
// plus 4 maps of N*4 bytes: about 25 us at 3.35 TB/s.  The stencil as the
// plain version writes it is 40 operations a pixel (0.66 GFLOP a frame,
// 10 us at the f32 rate), below the byte time.  A bfloat16 or half store
// (the TPU kernel's `out_dtype`; the output element type is a template
// parameter, store.cuh) halves the windows' bytes: about 15 us a frame.
//
// What the design does about the bound.  The stores, the largest stream,
// must run at the memory rate, so everything else has to cost fewer
// instructions than they take time.  Staging the tile in shared memory with
// an integer division per element, and 16 shared reads and 40 rounded
// operations a pixel, did not.  Here a warp owns a window and keeps it in
// registers, with the lane map of warp_lanes.cuh (reach 3: the stencil reads
// tile columns 0..w+2 and rows 0..w+2):
//
// * the sum is separable in the plain version's own order: the inner sum
//   over kx for tile row r and column j does not depend on the output row,
//   so the warp walks the w + 3 tile rows, loads each once (one coalesced
//   `__ldg` a slot, `rows_ahead` rows at a time), takes the
//   neighbours j+1..j+3 by three shuffles a slot, and forms once per tile
//   row and column
//     h[r][j] = (((0 + wx0 t[r][j]) + wx1 t[r][j+1]) + wx2 t[r][j+2]) + wx3 t[r][j+3];
// * it keeps the last four rows of h in a ring of registers; when tile row
//   i + 3 arrives, output row i is
//     (((0 + wy0 h[i]) + wy1 h[i+1]) + wy2 h[i+2]) + wy3 h[i+3],
//   exactly the plain version's sum, stored as one coalesced streaming row
//   (`__stcs`, so the windows do not evict the frame from L2);
// * the eight Keys weights are computed once a window.
// About 16.75 rounded operations a pixel instead of 40; no shared memory, no
// barrier, no integer division.
//
// Numerics: weights and sums use explicitly rounded operations
// (__fmul_rn / __fadd_rn / __fsub_rn) in the TPU kernel's term order, so no
// multiply-add is contracted and the result matches the plain PyTorch
// version to the last bit.

#include "store.cuh"
#include "warp_lanes.cuh"

namespace {

using piv::warp::kWarps;
using piv::warp::Lanes;

// Tile rows loaded together before the first of them is used, and blocks
// an SM the register budget is cut for, by columns a lane.  The ring of h
// is indexed by the tile row modulo 4, a constant in the unrolled loop
// because the rows a batch are a multiple of 4.  Twelve rows for one column
// a lane (w <= 32, the main path: the w + 3 rows in three batches) fit 64
// registers; sixteen spill, and eight, or the rows refilled one by one as
// they are used, leave more of the loads' latency exposed (timed on an
// H100, PERF.md §6).
template <int K>
__host__ __device__ constexpr int rows_ahead() { return K == 1 ? 12 : 4; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 3 ? 4 : 2; }

// 1 <= |d| < 2:  a*d^3 - 5a*d^2 + 8a*d - 4a  with a = -0.5
__device__ __forceinline__ float keys_outer(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  float r = __fsub_rn(__fmul_rn(-0.5f, d3), __fmul_rn(-2.5f, d2));
  r = __fadd_rn(r, __fmul_rn(-4.0f, d));
  return __fsub_rn(r, -2.0f);
}

// |d| <= 1:  (a+2)*d^3 - (a+3)*d^2 + 1
__device__ __forceinline__ float keys_inner(float d) {
  const float d2 = __fmul_rn(d, d);
  const float d3 = __fmul_rn(d2, d);
  const float r = __fsub_rn(__fmul_rn(1.5f, d3), __fmul_rn(2.5f, d2));
  return __fadd_rn(r, 1.0f);
}

__device__ __forceinline__ void cubic_weights(float t, float (&w)[4]) {
  w[0] = keys_outer(__fadd_rn(t, 1.0f));
  w[1] = keys_inner(t);
  w[2] = keys_inner(__fsub_rn(1.0f, t));
  w[3] = keys_outer(__fsub_rn(2.0f, t));
}

// (((0 + w0 a) + w1 b) + w2 c) + w3 d, each step rounded
__device__ __forceinline__ float taps(const float (&w)[4], float a, float b,
                                      float c, float d) {
  float acc = __fadd_rn(0.0f, __fmul_rn(w[0], a));
  acc = __fadd_rn(acc, __fmul_rn(w[1], b));
  acc = __fadd_rn(acc, __fmul_rn(w[2], c));
  return __fadd_rn(acc, __fmul_rn(w[3], d));
}

template <int K, typename Out>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<K>())
shift_windows_bicubic_kernel(const float* __restrict__ frame,
                             const int* __restrict__ dy,
                             const int* __restrict__ dx,
                             const float* __restrict__ fy,
                             const float* __restrict__ fx,
                             Out* __restrict__ out,
                             int Hp, int Wp, int n_rows, int n_cols, int w,
                             int step, int off, int row_start, int lg) {
  const int G = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int c = lane & (G - 1);  // the lane's first column
  const int r = blockIdx.y;      // row of the block's windows in the row block
  const int b = blockIdx.z;      // frame of the batch
  const int col = ((blockIdx.x * kWarps + (threadIdx.x >> 5)) << (5 - lg)) +
                  (lane >> lg);  // grid column of the group's window
  const bool live = col < n_cols;  // a ragged row's last groups only load
  const int64_t wi = ((int64_t)b * n_rows + r) * n_cols + min(col, n_cols - 1);
  const int T = w + 4;
  const int last = w + 2;  // the last tile row and column the stencil reads

  // tile origin = window origin + floor(shift) - 1 (the stencil's margin)
  const int ty = min(max((row_start + r) * step + off + dy[wi] - 1, 0), Hp - T);
  const int tx = min(max(min(col, n_cols - 1) * step + off + dx[wi] - 1, 0), Wp - T);
  const float* src = frame + ((int64_t)b * Hp + ty) * Wp + tx;
  float wy[4], wx[4];
  cubic_weights(fy[wi], wy);
  cubic_weights(fx[wi], wx);
  Out* dst = out + wi * w * w;

  float h[4][K];  // the ring: h[r & 3] holds tile row r's horizontal sums
  constexpr int kRows = rows_ahead<K>();
  for (int r0 = 0; r0 <= last; r0 += kRows) {
    float rows[kRows][K + 1];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      piv::warp::load_row<K>(src, Wp, r0 + u, c, G, last, rows[u]);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int tr = r0 + u;  // tile row
      if (tr > last) break;   // the same for the whole warp
      float n1[K], n2[K], n3[K];
      piv::warp::right_at<K>(rows[u], c, G, 1, n1);
      piv::warp::right_at<K>(rows[u], c, G, 2, n2);
      piv::warp::right_at<K>(rows[u], c, G, 3, n3);
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[u & 3][k] = taps(wx, rows[u][k], n1[k], n2[k], n3[k]);
      if (tr < 3) continue;  // output row tr - 3 needs tile rows tr-3 .. tr
      const int i = tr - 3;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = c + G * k;
        const float val = taps(wy, h[(u + 1) & 3][k], h[(u + 2) & 3][k],
                               h[(u + 3) & 3][k], h[u & 3][k]);
        if (live && j < w) piv::store_cs(dst + i * w + j, val);
      }
    }
  }
}

template <int K, typename Out>
int launch(const float* frame, const int* dy, const int* dx, const float* fy,
           const float* fx, Out* out, int B, int Hp, int Wp, int n_rows,
           int n_cols, int w, int step, int off, int row_start, const Lanes& l,
           cudaStream_t stream) {
  const int per_block = kWarps * l.P;  // windows a block
  dim3 grid((n_cols + per_block - 1) / per_block, n_rows, B);
  shift_windows_bicubic_kernel<K, Out><<<grid, kWarps * 32, 0, stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, n_rows, n_cols, w, step, off,
      row_start, l.lg);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Lanes& l, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, shift_windows_bicubic_kernel<K, float>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kWarps * 32;
  out[4] = kWarps * l.P;
  return 0;
}

constexpr int kReach = 3;  // tile columns the stencil reads past the window
constexpr int kMaxWind = 128;  // four columns a lane

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx: [B, N] f32;
// out: [B, N, w, w] with N = n_rows * n_cols, in the entry point's store
// type (`_f32`: float; `_store_bf16`, `_store_f16`: the float32 result
// rounded to nearest even).  w in 1..128.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
#define PIV_SHIFT_WINDOWS_BICUBIC(SUFFIX, TYPE)                               \
  int shift_windows_bicubic_##SUFFIX(                                         \
      const float* frame, const int* dy, const int* dx, const float* fy,      \
      const float* fx, TYPE* out, int B, int Hp, int Wp, int n_rows,          \
      int n_cols, int w, int step, int off, int row_start, void* stream) {    \
    if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;             \
    const Lanes l = piv::warp::lanes_for(w, kReach);                          \
    PIV_FOR_SLOTS(l.K, launch, frame, dy, dx, fy, fx, out, B, Hp, Wp, n_rows, \
                  n_cols, w, step, off, row_start, l, (cudaStream_t)stream);  \
  }
PIV_STORE_TYPES(PIV_SHIFT_WINDOWS_BICUBIC)

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance that serves window size w.  Returns a CUDA error code, 0
// on success.
int shift_windows_bicubic_describe(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Lanes l = piv::warp::lanes_for(w, kReach);
  PIV_FOR_SLOTS(l.K, describe, l, out);
}

const char* shift_windows_bicubic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
