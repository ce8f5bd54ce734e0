// Per-window CWS/DWS window shift from a phase table of the bfloat16 frame
// for Hopper (sm_90a), plain C interface.
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
// The idea kept from the TPU variant: a table of pre-shifted copies of the
// source buys aligned copies, so that no window realigns its tile.  The TPU
// keeps 16 row-shifted copies of a band in VMEM (rows are its expensive
// axis).  On this card the expensive alignment is that of the 16-byte
// asynchronous copy (`cp.async`), which needs both addresses on 16-byte
// boundaries, that is 8 bfloat16 columns: a prologue kernel writes P = 8
// copies of the frame to device memory, copy p shifted left by p columns,
//     table[p][row][c] = frame[row][c + p]   (0 beyond column Wp),
// and a window whose tile starts at column tx copies its rows from copy
// p = tx % 8 at the aligned column tx - p, in whole 16-byte pieces, with
// no per-window realignment; rows need no alignment here.  The table costs
// 8 times the frame's memory (the TPU variant: 16 times the band's VMEM)
// and one more pass over it per launch.  The wrapper allocates the table;
// nothing is allocated here.
//
// Bound on an H100: bytes, the same as shift_windows_bf16.cu (output plus
// one bfloat16 frame; the table is this design's own traffic and not part
// of the bound).  At the main path's pass-2 shape (2048^2 frame, w = 32,
// o = 16, S = 16) the prologue writes 8 * 2080 * 2088 * 2 = 69.5 MB a
// frame, about as much as the windows it then helps to write (66.1 MB), so
// the variant cannot win there; its time is written down beside row 1's.
//
// The blend is shift.cuh's: the result matches the plain version to the
// last bit.

#include <cuda_bf16.h>

#include "shift.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPhases = 8;  // bfloat16 elements in 16 bytes

// table[b][p][row][8 * ch .. 8 * ch + 7] by one thread
__global__ void __launch_bounds__(kThreads)
phase_table_kernel(const unsigned short* __restrict__ frame,
                   uint4* __restrict__ table, int64_t n_chunks, int Hp, int Wp,
                   int pitch, int tpitch) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_chunks) return;
  const int cpr = tpitch / 8;  // chunks per table row
  const int ch = (int)(i % cpr);
  const int64_t line = i / cpr;  // (b * kPhases + p) * Hp + row
  const int row = (int)(line % Hp);
  const int64_t bp = line / Hp;
  const int p = (int)(bp % kPhases);
  const int64_t b = bp / kPhases;
  const unsigned short* src = frame + (b * Hp + row) * pitch;
  const int c0 = ch * 8 + p;
  unsigned v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = c0 + k < Wp ? src[c0 + k] : 0u;
  table[i] = make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                        v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

__global__ void __launch_bounds__(kThreads)
shift_windows_phases_kernel(const __nv_bfloat16* __restrict__ table,
                            const int* __restrict__ dy,
                            const int* __restrict__ dx,
                            const float* __restrict__ fy,
                            const float* __restrict__ fx,
                            float* __restrict__ out,
                            int Hp, int Wp, int tpitch, int n_cols, int n_win,
                            int w, int step, int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  int ty, tx;
  piv::tile_origin(n, n_cols, step, off, dy[wi], dx[wi], Hp, Wp, T, &ty, &tx);

  const int p = tx % kPhases;
  const int chunks = (T + 7) / 8;  // 16-byte pieces of a tile row
  const int sp = 8 * chunks;       // the staged row's length in elements
  const __nv_bfloat16* src =
      table + (((int64_t)b * kPhases + p) * Hp + ty) * tpitch + (tx - p);
  for (int i = threadIdx.x; i < T * chunks; i += blockDim.x) {
    const int ri = i / chunks;
    const int cj = i - ri * chunks;
    piv::cp_async16(tile + ri * sp + 8 * cj, src + (int64_t)ri * tpitch + 8 * cj);
  }
  piv::cp_async_wait();
  __syncthreads();

  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    const __nv_bfloat16* t = tile + ri * sp + (i - ri * w);
    dst[i] = piv::blend_corners(__bfloat162float(t[0]), __bfloat162float(t[1]),
                                __bfloat162float(t[sp]),
                                __bfloat162float(t[sp + 1]), blend);
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] bf16 (columns beyond Wp are not read); table:
// [B, 8, Hp, tpitch] bf16 scratch, tpitch a multiple of 8 and >= Wp + 8,
// 16-byte aligned; dy, dx: [B, N] i32; fy, fx: [B, N] f32; out:
// [B, N, w, w] f32 with N = n_rows * n_cols.  `stages` selects what runs:
// 1 the prologue that fills the table, 2 the shift from a filled table,
// 3 both (what the wrapper asks for).  Launches on `stream` and returns
// the first launch error (0 on success).
int shift_windows_phases_f32(const void* frame, void* table, const int* dy,
                             const int* dx, const float* fy, const float* fx,
                             float* out, int B, int Hp, int Wp, int pitch,
                             int tpitch, int n_rows, int n_cols, int w,
                             int step, int off, int stages, void* stream) {
  if (tpitch % 8 != 0 || tpitch < Wp + 8 || pitch < Wp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (stages & 1) {
    const int64_t n_chunks = (int64_t)B * kPhases * Hp * (tpitch / 8);
    const int64_t blocks = (n_chunks + kThreads - 1) / kThreads;
    phase_table_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(frame), static_cast<uint4*>(table),
        n_chunks, Hp, Wp, pitch, tpitch);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (stages & 2) {
    const int T = w + 1;
    const size_t smem = (size_t)T * 8 * ((T + 7) / 8) * sizeof(__nv_bfloat16);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          shift_windows_phases_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int n_win = n_rows * n_cols;
    dim3 grid(n_win, B);
    shift_windows_phases_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(table), dy, dx, fy, fx, out, Hp, Wp,
        tpitch, n_cols, n_win, w, step, off);
  }
  return (int)cudaGetLastError();
}

const char* shift_windows_phases_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
