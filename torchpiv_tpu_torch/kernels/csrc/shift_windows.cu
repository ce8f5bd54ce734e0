// Per-window CWS/DWS window shift for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel` behind `shift_windows_pallas`
// (torchpiv_tpu/kernels/shift_pallas.py).  Same function: every window of
// every frame reads a (w+1)^2 tile of the padded frame at its origin plus
// the window's integer shift (dy, dx), clamped into the frame, and blends
// the tile's four corner slices with per-window scalar weights built from
// the fractional shift (fy, fx); a window whose shift is an integer in
// either axis copies the floor corner.  The plain PyTorch version is
// `blend_reference` in torchpiv_tpu_torch/ops/shifts.py; its steps, lane by
// lane, are replayed on the CPU by `warp_window_steps` there.
//
// Bound on an H100: bytes.  At the main path's pass-2 shape (2048^2 frame,
// w = 32, o = 16, S = 16: N = 127^2 = 16129 windows) one launch per frame
// writes N*w*w*4 = 66.1 MB and reads the 2080^2*4 = 17.3 MB padded frame
// plus 4 maps of N*4 bytes, about 83.7 MB: about 25 us at 3.35 TB/s.  The
// blend is 7 flops a pixel (0.12 GFLOP), far below the card's f32 rate.
//
// What the design does about the bound.  The window's stores (the largest
// stream) must run at the memory rate, so every other part of the work has
// to cost fewer instructions than the stores take time: staging a tile in
// shared memory with an integer division per staged element and per pixel
// is about 70 k lane-instructions a window, more than the stores allow.
// Here a warp owns a window and keeps it in registers:
//
// * lane c of a group of G lanes (G a power of two) holds the tile columns
//   c, c + G, ... (K = ceil(w / G) of them, plus column G*K in lane 0 where
//   the tile reaches it), and the warp walks the w + 1 tile rows: each row
//   is one coalesced load a slot, read through L1 (`__ldg`);
// * a pixel's right neighbour comes from lane c + 1 by one shuffle a slot
//   (lane G-1 reads lane 0's next slot, which lane 0 offers in place of its
//   own); the row below is the next step's load, so each tile row is loaded
//   and shuffled once and kept in registers for the row after it;
// * `rows_ahead` rows are loaded before the first of their output rows is
//   blended and stored (one coalesced w*4-byte store a row, streaming, so
//   the windows do not evict the frame from L2);
// * w <= 32 packs 32 / G windows into a warp (G the next power of two of
//   w), w > 32 gives each lane K = ceil(w / 32) columns; a block holds
//   kWarps warps and the windows of one grid row, the window coming from
//   blockIdx and the warp and group index, the pixel from the lane and the
//   loop counter.  No shared memory, no barrier, no integer division.
//
// With `packed` the windows go out in the lane-packed layout of the TPU
// pass-fusion kernels instead: window c of row r at out[r, :, c*w:(c+1)*w]
// of a [n_rows, w, Lp] tensor, Lp = n_cols_pad * w, the columns past n_cols
// repeating the last window.  The port's own kernels read [N, w, w]; the
// layout exists to be held against the JAX functions that speak it.
//
// The blend and its numerics are shift.cuh's (`blend_weights`,
// `blend_corners`), shared with fused_pass.cu and the shift variants: the
// result matches the plain PyTorch version to the last bit, and integer
// shifts copy tile values.

#include "shift.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kAll = 0xffffffffu;

// Tile rows loaded ahead of their first store, and blocks an SM the
// register budget is cut for, by columns a lane: eight rows for one column
// (w <= 32, the main path: more loads in flight; the anatomy tool's
// `rowbyrow` mode shows what they buy), four for more, and room for the
// three- and four-column instances' registers, which spill at 64.
template <int K>
__host__ __device__ constexpr int rows_ahead() { return K == 1 ? 8 : 4; }
template <int K>
__host__ __device__ constexpr int min_blocks() { return K < 3 ? 4 : 2; }

// Where a warp's lanes sit: groups of G lanes (G = 1 << lg), one window a
// group, K columns a lane.
struct Lanes {
  int G, lg, P, K;
};

Lanes lanes_for(int w) {
  Lanes l;
  if (w > 32) {
    l.G = 32;
    l.K = (w + 31) / 32;
  } else {
    l.G = 1;
    while (l.G < w) l.G <<= 1;
    l.K = 1;
  }
  l.lg = 0;
  while ((1 << l.lg) < l.G) ++l.lg;
  l.P = 32 / l.G;
  return l;
}

// Tile row `row` into slot k of lane c: column c + G*k, where the tile
// (w + 1 columns, w + 1 rows) has it.
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int Wp,
                                         int row, int c, int G, int w,
                                         float (&v)[K + 1]) {
  const float* p = src + (int64_t)row * Wp + c;
#pragma unroll
  for (int k = 0; k <= K; ++k) {
    const bool in_tile = row <= w && c + G * k <= w;
    v[k] = in_tile ? __ldg(p + G * k) : 0.0f;
  }
}

// The right neighbour of each slot's column: lane c + 1's value, and for
// the group's last lane lane 0's next slot (which lane 0 offers instead of
// its own value: no lane reads lane 0's own slot).  `row` points at the
// tile row's first column, for the anatomy tool's mode that loads the
// neighbours instead.
template <int K>
__device__ __forceinline__ void right_neighbours(const float (&v)[K + 1],
                                                 const float* __restrict__ row,
                                                 int c, int G, int w,
                                                 float (&right)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = c == 0 ? v[k + 1] : v[k];
    right[k] = __shfl_sync(kAll, x, (c + 1) & (G - 1), G);
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<K>())
shift_windows_kernel(const float* __restrict__ frame,
                     const int* __restrict__ dy,
                     const int* __restrict__ dx,
                     const float* __restrict__ fy,
                     const float* __restrict__ fx,
                     float* __restrict__ out,
                     int Hp, int Wp, int n_rows, int n_cols, int w, int step,
                     int off, int row_start, int lg, int packed,
                     int n_cols_pad) {
  const int G = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int c = lane & (G - 1);  // the lane's first column
  const int r = blockIdx.y;      // row of the block's windows in the row block
  const int b = blockIdx.z;      // frame of the batch
  const int col = ((blockIdx.x * kWarps + (threadIdx.x >> 5)) << (5 - lg)) +
                  (lane >> lg);  // grid column of the group's window
  const bool live = col < n_cols;  // a ragged row's last groups only load
  const int64_t wi = ((int64_t)b * n_rows + r) * n_cols + min(col, n_cols - 1);
  const int T = w + 1;

  const int ty = min(max((row_start + r) * step + off + dy[wi], 0), Hp - T);
  const int tx = min(max(min(col, n_cols - 1) * step + off + dx[wi], 0), Wp - T);
  const float* src = frame + ((int64_t)b * Hp + ty) * Wp + tx;
  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);

  float* dst;
  int64_t pitch;  // floats from one output row to the next
  int copies = 1;
  if (!packed) {
    dst = out + wi * w * w;
    pitch = w;
  } else {
    pitch = (int64_t)n_cols_pad * w;
    dst = out + ((int64_t)b * n_rows + r) * w * pitch + (int64_t)col * w;
    // the last window of a row also fills the row's tail columns
    if (col == n_cols - 1) copies = n_cols_pad - n_cols + 1;
  }

  float top[K + 1], top_right[K];
  load_row<K>(src, Wp, 0, c, G, w, top);
  right_neighbours<K>(top, src, c, G, w, top_right);
  constexpr int kRows = rows_ahead<K>();
  for (int i0 = 0; i0 < w; i0 += kRows) {
    float below[kRows][K + 1];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      load_row<K>(src, Wp, i0 + u + 1, c, G, w, below[u]);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = i0 + u;  // output row: tile rows i and i + 1
      if (i >= w) break;     // the same for the whole warp
      float below_right[K];
      right_neighbours<K>(below[u], src + (int64_t)(i + 1) * Wp, c, G, w,
                          below_right);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = c + G * k;
        const float val = piv::blend_corners(top[k], top_right[k], below[u][k],
                                             below_right[k], blend);
        if (live && j < w)
          for (int q = 0; q < copies; ++q) __stcs(dst + i * pitch + q * w + j, val);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        top[k] = below[u][k];
        top_right[k] = below_right[k];
      }
      top[K] = below[u][K];
    }
  }
}

template <int K>
int launch(const float* frame, const int* dy, const int* dx, const float* fy,
           const float* fx, float* out, int B, int Hp, int Wp, int n_rows,
           int n_cols, int w, int step, int off, int row_start, int packed,
           int n_cols_pad, const Lanes& l, cudaStream_t stream) {
  const int per_block = kWarps * l.P;  // windows a block
  dim3 grid((n_cols + per_block - 1) / per_block, n_rows, B);
  shift_windows_kernel<K><<<grid, kWarps * 32, 0, stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, n_rows, n_cols, w, step, off,
      row_start, l.lg, packed, n_cols_pad);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Lanes& l, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, shift_windows_kernel<K>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kWarps * 32;
  out[4] = kWarps * l.P;
  return 0;
}

}  // namespace

// `return fn<K>(...)` for the instance that serves K columns a lane.
#define PIV_FOR_COLUMNS(K, fn, ...)        \
  switch (K) {                             \
    case 1: return fn<1>(__VA_ARGS__);     \
    case 2: return fn<2>(__VA_ARGS__);     \
    case 3: return fn<3>(__VA_ARGS__);     \
    case 4: return fn<4>(__VA_ARGS__);     \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx: [B, N] f32;
// out: [B, N, w, w] f32 with N = n_rows * n_cols, or with `packed`
// [B, n_rows, w, n_cols_pad * w].  w in 1..128.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
int shift_windows_f32(const float* frame, const int* dy, const int* dx,
                      const float* fy, const float* fx, float* out,
                      int B, int Hp, int Wp, int n_rows, int n_cols,
                      int w, int step, int off, int row_start, int packed,
                      int n_cols_pad, void* stream) {
  if (w < 1 || w > 128) return (int)cudaErrorInvalidValue;
  const Lanes l = lanes_for(w);
  PIV_FOR_COLUMNS(l.K, launch, frame, dy, dx, fy, fx, out, B, Hp, Wp, n_rows,
                  n_cols, w, step, off, row_start, packed, n_cols_pad, l,
                  (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the instance that serves window size w.  Returns a CUDA error code, 0
// on success.
int shift_windows_describe(int w, int* out) {
  if (w < 1 || w > 128) return (int)cudaErrorInvalidValue;
  const Lanes l = lanes_for(w);
  PIV_FOR_COLUMNS(l.K, describe, l, out);
}

const char* shift_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
