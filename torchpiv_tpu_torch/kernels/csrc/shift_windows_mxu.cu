// Per-window CWS/DWS window shift with the tile placed by tensor-core
// products, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_shift_kernel_mxu` behind
// `shift_windows_pallas(variant="mxu")`
// (torchpiv_tpu/experimental/shift_variants.py).  Same function as
// shift_windows.cu, on a padded frame that the wrapper has rounded to
// bfloat16: every window reads a (w+1)^2 tile at its origin plus the
// window's integer shift, clamped into the frame, and blends the tile's
// four corner slices in float32 with per-window scalar weights; a window
// whose shift is an integer in either axis copies the floor corner.  The
// plain PyTorch version is `blend_reference_variant(..., "mxu")` in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The idea kept from the TPU variant: the dynamic placement of the tile is
// not a data move but two one-hot selection products on the matrix unit,
//     tile = Wy @ block @ Wx,   Wx[s_col + j, j] = 1,  Wy[i, s_row + i] = 1,
// with bfloat16 operands and float32 accumulation.  One block per window
// stages a KP x KP block of the frame whose origin is the tile's origin
// rounded down to 8 rows and 8 columns (16-byte asynchronous copies;
// KP = roundup16(T + 7), T = w + 1).  The products are in the kernel's body
// on the TPU and so they are here: no library product is called.
//
// What the design does about its time: the products are
// `mma.sync.aligned.m16n8k16` (bfloat16) with hand-laid fragments, so the
// selectors never exist in memory: a lane builds its part of a one-hot
// operand in registers from its row and column indices and the remainders
// s_row, s_col.  A warp owns a 16-row strip of the tile end to end: it
// computes Wy @ block for its strip 16 columns at a time (the block's
// fragments come from shared memory with `ldmatrix`), packs the float32
// accumulators to bfloat16 (exact, see below) into the layout of the next
// product's first operand, and multiplies by Wx without a trip through
// shared memory.  Both selectors are banded (the remainders are below 8):
// a strip sums two 16-deep slices of the block's rows, and 16 output
// columns sum over their own 16-deep slice and 8 of the next.  The only
// block-wide barriers are the one after staging and the one before the
// blend, which reads its four corners from the float32 tile in shared
// memory.  `wgmma` does not fit: it takes 64 rows a warpgroup and operands
// in swizzled shared memory, where the tile has 33-48 rows and the
// selectors should not be in memory at all.
//
// Exactness: every sum has one non-zero term, a frame value times 1, so
// the float32 accumulator holds the bfloat16 value and the cast back to
// bfloat16 between the products loses nothing.  It needs finite frames:
// 0 * inf is NaN in a product and not in a gather.  Block rows beyond the
// frame and columns beyond the row pitch are zero-filled, never read.
//
// Bound on an H100: bytes, the same as shift_windows_bf16.cu (output plus
// one bfloat16 frame).  The products add 7 `mma` of 4096 operations per 16
// rows and 16 columns of the padded tile (0.26 MFLOP a window at w = 32,
// 17 GFLOP for 64516 windows, 17 us at the card's bfloat16 rate).
//
// The frame's row pitch is a multiple of 8 (the wrapper pads with zeros
// beyond Wp); the clamps use the logical Wp.  The blend is shift.cuh's:
// the result matches the plain version to the last bit.

#include <cuda_bf16.h>

#include "shift.cuh"

namespace {

constexpr int kAlign = 8;  // bfloat16 elements in 16 bytes
constexpr int kRowPad = 8;  // elements added to a block row: ldmatrix rows
                            // then fall on distinct banks

__host__ __device__ inline int round_up16(int x) { return (x + 15) & ~15; }

// Row pitch in floats of the float32 tile: at least T + 1 and 8 modulo 32,
// so that the rows g and g + 8 of an accumulator fragment do not meet on a
// bank.
__host__ __device__ inline int tile_pitch(int T) {
  return ((T + 1 - 8 + 31) & ~31) + 8;
}

// Two bfloat16 values in a register, each 1 or 0.
__device__ __forceinline__ unsigned one_hot(bool lo, bool hi) {
  return (lo ? 0x3F80u : 0u) | (hi ? 0x3F800000u : 0u);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a @ b, a 16 x 16 (row major) and b 16 x 8 (column major) bfloat16
// fragments, d a 16 x 8 float32 one.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The second-operand fragments of two neighbouring 16 x 8 tiles of a
// row-major bfloat16 matrix in shared memory: b[0], b[1] of the tile at
// `row_ptr`'s column, b[2], b[3] of the next.  `row_ptr` is this lane's row
// (lane & 15) at the first tile's column, plus 8 columns for lanes 16-31.
__device__ __forceinline__ void load_b_pair(unsigned (&b)[4],
                                            const __nv_bfloat16* row_ptr) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row_ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

__global__ void shift_windows_mxu_kernel(const __nv_bfloat16* __restrict__ frame,
                                         const int* __restrict__ dy,
                                         const int* __restrict__ dx,
                                         const float* __restrict__ fy,
                                         const float* __restrict__ fx,
                                         float* __restrict__ out,
                                         int Hp, int Wp, int pitch, int n_cols,
                                         int n_win, int w, int step, int off,
                                         int row_start) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  const int Tp = round_up16(T);
  const int KP = round_up16(T + kAlign - 1);
  const int ldb = KP + kRowPad;  // elements a row of the staged block
  const int ldt = tile_pitch(T);
  __nv_bfloat16* block = reinterpret_cast<__nv_bfloat16*>(smem);
  float* tile = reinterpret_cast<float*>(block + KP * ldb);

  int ty, tx;
  // the row block's window n is window n + row_start * n_cols of the grid
  piv::tile_origin(n + row_start * n_cols, n_cols, step, off, dy[wi], dx[wi], Hp,
                   Wp, T, &ty, &tx);
  const int s_row = ty % kAlign, s_col = tx % kAlign;
  const int ty0 = ty - s_row, tx0 = tx - s_col;

  // the aligned KP x KP block, zero outside the frame's rows and pitch
  const int cpr = KP / kAlign;
  const __nv_bfloat16* src = frame + ((int64_t)b * Hp + ty0) * pitch + tx0;
  for (int i = threadIdx.x; i < KP * cpr; i += blockDim.x) {
    const int ri = i / cpr;
    const int cj = (i - ri * cpr) * kAlign;
    __nv_bfloat16* dst = block + ri * ldb + cj;
    if (ty0 + ri < Hp && tx0 + cj + kAlign <= pitch)
      piv::cp_async16(dst, src + (int64_t)ri * pitch + cj);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  piv::cp_async_wait();
  __syncthreads();

  // this warp's strip: rows i0 .. i0 + 15 of the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int i0 = warp * 16;

  // Wy for the strip, the two 16-deep slices of block rows that it can
  // select: row r takes block row s_row + i0 + r, which is column
  // s_row + r - 16 * s of slice i0 / 16 + s
  unsigned wy[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int lo = s_row - 16 * s + g;  // the column that row g selects
    wy[s][0] = one_hot(t2 == lo, t2 + 1 == lo);
    wy[s][1] = one_hot(t2 == lo + 8, t2 + 1 == lo + 8);
    wy[s][2] = one_hot(t2 + 8 == lo, t2 + 9 == lo);
    wy[s][3] = one_hot(t2 + 8 == lo + 8, t2 + 9 == lo + 8);
  }
  // Wx: output column n of a 16-wide chunk takes strip column n + s_col:
  // the left 8 outputs from the chunk's own slice (wx_a), the right 8 from
  // its columns 8 + n + s_col (wx_b) and from the next slice's columns
  // n + s_col - 8 (wx_c)
  const int sel = g + s_col;
  const unsigned wx_a0 = one_hot(t2 == sel, t2 + 1 == sel);
  const unsigned wx_a1 = one_hot(t2 + 8 == sel, t2 + 9 == sel);
  const unsigned wx_b0 = one_hot(t2 == sel + 8, t2 + 1 == sel + 8);
  const unsigned wx_b1 = one_hot(t2 + 8 == sel + 8, t2 + 9 == sel + 8);
  const unsigned wx_c = one_hot(t2 == sel - 8, t2 + 1 == sel - 8);

  // 16 columns of Wy @ block for the strip, as the first operand of the
  // second product
  const __nv_bfloat16* lane_rows =
      block + (i0 + (lane & 15)) * ldb + (lane >> 4) * 8;
  auto strip_slice = [&](int col0, unsigned (&a)[4]) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    if (col0 < KP) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (i0 + 16 * s < KP) {
          unsigned bb[4];
          load_b_pair(bb, lane_rows + 16 * s * ldb + col0);
          mma_bf16(c0, wy[s], bb[0], bb[1]);
          mma_bf16(c1, wy[s], bb[2], bb[3]);
        }
      }
    }
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
  };

  unsigned cur[4], nxt[4];
  strip_slice(0, cur);
  for (int col = 0; col < Tp; col += 16) {
    strip_slice(col + 16, nxt);
    float left[4] = {0.f, 0.f, 0.f, 0.f}, right[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(left, cur, wx_a0, wx_a1);
    mma_bf16(right, cur, wx_b0, wx_b1);
    const unsigned part[4] = {nxt[0], nxt[1], 0u, 0u};
    mma_bf16(right, part, wx_c, 0u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the fragments
      const int row = i0 + g + 8 * h;
      if (row < T) {
        float* dst = tile + row * ldt + col + t2;
        if (col + t2 < T)
          *reinterpret_cast<float2*>(dst) = make_float2(left[2 * h], left[2 * h + 1]);
        if (col + 8 + t2 < T)
          *reinterpret_cast<float2*>(dst + 8) =
              make_float2(right[2 * h], right[2 * h + 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
  }
  __syncthreads();

  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    dst[i] = piv::blend_pixel(tile + ri * ldt + (i - ri * w), ldt, blend);
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] bf16, finite, pitch a multiple of 8 and >= Wp,
// zeros beyond column Wp; dy, dx: [B, N] i32; fy, fx: [B, N] f32; out:
// [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
int shift_windows_mxu_f32(const void* frame, const int* dy, const int* dx,
                          const float* fy, const float* fx, float* out,
                          int B, int Hp, int Wp, int pitch, int n_rows,
                          int n_cols, int w, int step, int off, int row_start,
                          void* stream) {
  if (pitch % kAlign != 0 || pitch < Wp) return (int)cudaErrorInvalidValue;
  const int T = w + 1;
  const int Tp = round_up16(T);
  const int KP = round_up16(T + kAlign - 1);
  const size_t smem = (size_t)KP * (KP + kRowPad) * 2 + (size_t)T * tile_pitch(T) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  // one warp per 16-row strip of the padded tile
  shift_windows_mxu_kernel<<<grid, 32 * (Tp / 16), smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(frame), dy, dx, fy, fx, out, Hp, Wp,
      pitch, n_cols, n_win, w, step, off, row_start);
  return (int)cudaGetLastError();
}

const char* shift_windows_mxu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
