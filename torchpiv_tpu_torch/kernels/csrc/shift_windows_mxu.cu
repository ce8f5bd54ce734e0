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
// loads a KP x KP block of the frame whose origin is the tile's origin
// rounded down to 8 rows and 8 columns (16-byte vector loads), builds the
// selectors from index compares, and runs both products with
// `nvcuda::wmma` (m16n16k16, bfloat16) on shared memory; T = w + 1 is odd
// for the usual even windows, so the selectors and the tile are padded
// with zeros to multiples of 16 (Tp), and KP = roundup16(T + 7).  The
// selectors are banded (the remainders are below 8), so an output tile
// sums over two 16-deep slices of the contraction and skips the others,
// which hold only zeros.  The products are in the kernel's body on the
// TPU and so they are here: no library product is called.
//
// Exactness: every sum has one non-zero term, a frame value times 1, so
// the float32 accumulator holds the bfloat16 value and the cast back to
// bfloat16 between the products loses nothing.  It needs finite frames:
// 0 * inf is NaN in a product and not in a gather.  Block rows beyond the
// frame and columns beyond the row pitch are zero-filled, never read.
//
// Bound on an H100: bytes, the same as shift_windows_bf16.cu (output plus
// one bfloat16 frame).  The products add 2 * 2 * 16 * (KP + Tp) * Tp
// operations a window on top (0.3 MFLOP at w = 32, 4.8 GFLOP a frame of
// 16129 windows, 5 us at the card's bfloat16 rate), four block-wide
// barriers and three passes over shared memory per window, which is what
// its time is made of; it stays, whatever its time, as the counterpart of
// its TPU kernel.
//
// The frame's row pitch is a multiple of 8 (the wrapper pads with zeros
// beyond Wp); the clamps use the logical Wp.  The blend is shift.cuh's:
// the result matches the plain version to the last bit.

#include <cuda_bf16.h>
#include <mma.h>

#include "shift.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kAlign = 8;  // bfloat16 elements in 16 bytes

__host__ __device__ inline int round_up16(int x) { return (x + 15) & ~15; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[mt, nt] = sum over kt in {band(mt, nt), band(mt, nt) + 1} of
// a[mt, kt] @ b[kt, nt], 16 x 16 tiles, for every (mt, nt) of an
// m_tiles x n_tiles output; the warps share the output tiles.  `band_on_n`
// says whether the one-hot operand is b (band follows nt) or a (mt).
__device__ __forceinline__ void banded_product(
    const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
    float* out, int ldo, int m_tiles, int n_tiles, int k_tiles, bool band_on_n) {
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  for (int t = warp; t < m_tiles * n_tiles; t += n_warps) {
    const int mt = t / n_tiles;
    const int nt = t - mt * n_tiles;
    const int k0 = band_on_n ? nt : mt;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kt = k0; kt < min(k0 + 2, k_tiles); ++kt) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + (mt * lda + kt) * 16, lda);
      wmma::load_matrix_sync(fb, b + (kt * ldb + nt) * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + (mt * ldo + nt) * 16, acc, ldo,
                            wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads)
shift_windows_mxu_kernel(const __nv_bfloat16* __restrict__ frame,
                         const int* __restrict__ dy,
                         const int* __restrict__ dx,
                         const float* __restrict__ fy,
                         const float* __restrict__ fx,
                         float* __restrict__ out,
                         int Hp, int Wp, int pitch, int n_cols, int n_win,
                         int w, int step, int off) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = blockIdx.x;  // window, row-major over the grid
  const int b = blockIdx.y;  // frame of the batch
  const int64_t wi = (int64_t)b * n_win + n;
  const int T = w + 1;
  const int Tp = round_up16(T);
  const int KP = round_up16(T + kAlign - 1);
  // block, later the first product as bfloat16; selector; float32 results
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* buf_s = buf_a + KP * KP;
  float* buf_f = reinterpret_cast<float*>(buf_s + KP * Tp);

  int ty, tx;
  piv::tile_origin(n, n_cols, step, off, dy[wi], dx[wi], Hp, Wp, T, &ty, &tx);
  const int s_row = ty % kAlign, s_col = tx % kAlign;
  const int ty0 = ty - s_row, tx0 = tx - s_col;
  const __nv_bfloat16 one = __float2bfloat16(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  // the aligned KP x KP block, zero outside the frame's rows and pitch
  const int cpr = KP / kAlign;
  const __nv_bfloat16* src = frame + ((int64_t)b * Hp + ty0) * pitch + tx0;
  for (int i = threadIdx.x; i < KP * cpr; i += blockDim.x) {
    const int ri = i / cpr;
    const int cj = (i - ri * cpr) * kAlign;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ty0 + ri < Hp && tx0 + cj + kAlign <= pitch)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)ri * pitch + cj);
    *reinterpret_cast<uint4*>(buf_a + ri * KP + cj) = v;
  }
  // Wx [KP, Tp]: column j takes block column s_col + j
  for (int i = threadIdx.x; i < KP * Tp; i += blockDim.x) {
    const int k = i / Tp;
    const int j = i - k * Tp;
    buf_s[i] = (j < T && k == s_col + j) ? one : zero;
  }
  __syncthreads();

  // t1 [KP, Tp] = block @ Wx
  banded_product(buf_a, KP, buf_s, Tp, buf_f, Tp, KP / 16, Tp / 16, KP / 16, true);
  __syncthreads();

  // t1 back to bfloat16 (exact), and Wy [Tp, KP]: row i takes t1 row s_row + i
  for (int i = threadIdx.x; i < KP * Tp; i += blockDim.x) {
    buf_a[i] = __float2bfloat16(buf_f[i]);
    const int r = i / KP;
    const int k = i - r * KP;
    buf_s[i] = (r < T && k == s_row + r) ? one : zero;
  }
  __syncthreads();

  // tile [Tp, Tp] = Wy @ t1
  banded_product(buf_s, KP, buf_a, Tp, buf_f, Tp, Tp / 16, Tp / 16, KP / 16, false);
  __syncthreads();

  const piv::Blend blend = piv::blend_weights(fy[wi], fx[wi]);
  float* dst = out + wi * w * w;
  for (int i = threadIdx.x; i < w * w; i += blockDim.x) {
    const int ri = i / w;
    dst[i] = piv::blend_pixel(buf_f + ri * Tp + (i - ri * w), Tp, blend);
  }
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] bf16, finite, pitch a multiple of 8 and >= Wp,
// zeros beyond column Wp; dy, dx: [B, N] i32; fy, fx: [B, N] f32; out:
// [B, N, w, w] f32 with N = n_rows * n_cols.  Launches on `stream` and
// returns cudaGetLastError() of the launch (0 on success).
int shift_windows_mxu_f32(const void* frame, const int* dy, const int* dx,
                          const float* fy, const float* fx, float* out,
                          int B, int Hp, int Wp, int pitch, int n_rows,
                          int n_cols, int w, int step, int off, void* stream) {
  if (pitch % kAlign != 0 || pitch < Wp) return (int)cudaErrorInvalidValue;
  const int Tp = round_up16(w + 1);
  const int KP = round_up16(w + kAlign);
  const size_t smem = (size_t)KP * KP * 2 + (size_t)KP * Tp * (2 + 4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shift_windows_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_win = n_rows * n_cols;
  dim3 grid(n_win, B);
  shift_windows_mxu_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(frame), dy, dx, fy, fx, out, Hp, Wp,
      pitch, n_cols, n_win, w, step, off);
  return (int)cudaGetLastError();
}

const char* shift_windows_mxu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
