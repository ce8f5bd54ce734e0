// Window-deformation (DEF) resampling for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_def_kernel` behind `def_windows_pallas`
// (torchpiv_tpu/kernels/def_pallas.py).  Same function: every window of
// every frame is resampled with a per-PIXEL displacement, the window's
// centre shift plus its gradient times the pixel's offset from the window
// centre.  A window reads a T^2 tile of the padded frame, T = w + 2M + 1
// (bilinear) or w + 2M + 4 (bicubic), at its origin plus the integer shift
// minus BASE = M (M + 1 bicubic), clamped into the frame.  Per pixel (i, j)
// the residual position is
//   ry = ((M + fy) + gyi*ioff) + gyj*joff,  ioff = i - (w-1)/2,
// clipped to [0, 2M + 1 - 1e-3] (rx alike), and the sample is
//   bilinear: hat weights max(0, 1 - |r - k|) on the 2x2 neighbours; a
//             pixel whose ry OR rx is an integer takes the floor corner;
//   bicubic:  Keys weights (a = -0.5) on the 4x4 neighbours.
// The plain PyTorch version is `def_reference` in
// torchpiv_tpu_torch/ops/deform.py; `def_block_steps` there replays this
// kernel's work split, thread by thread, on the CPU.
//
// The TPU kernel sums (wy*wx)*tile over all (2M+2)^2 or (2M+4)^2 static
// tile shifts because it cannot address per pixel; every term outside the
// pixel's own 2x2 or 4x4 neighbours is an exact zero.  Here each thread
// gathers its own taps from shared memory, in ascending ky then kx, each as
// (wy*wx)*tile, which is the same float32 sum.
//
// Bound on an H100: bytes for bilinear, operations for bicubic.  At the
// pass-2 shape of a 4 MP run (2048^2 frame, w = 32, o = 16, S = 16, M = 2:
// N = 16129 windows, pad S + M + 1) one frame writes N*w*w*4 = 66.1 MB and
// reads the 2086^2*4 = 17.4 MB padded frame plus 8 maps of N*4 bytes: about
// 25 us at 3.35 TB/s.  The bilinear sample is about 40 flops a pixel, the
// bicubic about 150 (2.5 GFLOP a frame, 37 us at the f32 rate).  The
// rounding rule below forbids FMA contraction, and the card's 67 TFLOP/s
// f32 rate counts an FMA as two operations, so under it the card issues at
// most about 33.5 T of these instructions a second: the bicubic batch of 4
// needs about 0.31 ms for its arithmetic alone.
//
// What the design does about the bound.  The taps are gathered at a
// per-pixel floor(r), so the tile stays in shared memory; what the design
// cuts is the instructions around it, which an earlier design (one block a
// window, an integer division per staged element and per pixel, both
// residuals recomputed in full per pixel, two data-dependent branches per
// Keys weight) spent more time on than the bytes take:
//
// * a block walks kWindows windows of one grid row through a ring of
//   kStages tile buffers (rows at an odd pitch, against bank conflicts):
//   each window's clamped tile is staged by 4-byte `cp.async` (thread t
//   copies elements t, t + blockDim, ... in row-major order, all lanes
//   busy) while the window before it is computed (a third buffer bought
//   nothing; tools/def_anatomy_cuda.py splits the time into staging,
//   sampling and stores);
// * thread t computes the column quad q = t % Q (Q = ceil(w / 4)) of the
//   pixel rows t / Q, t / Q + R, ... (R = rows a pass): four divisions a
//   thread (these two and the staging walk's start), none a pixel or a
//   staged element;
// * the row-invariant part of each residual, by + gyi*ioff, is computed
//   once a pixel row and thread, the column part gyj*joff once a window and
//   column: the same operations in the same order as the full residual;
// * each Keys weight evaluates the piece that the tap's position fixes
//   (`keys_tap`), without a branch or a select, to the same bits;
// * a row's four pixels go out as one 16-byte store where w % 4 == 0
//   (8 bytes in a 16-bit store type; streaming, so the windows do not
//   evict the frame from L2).
//
// The output element type is a template parameter: float, or bfloat16 or
// half rounded at the store (the TPU kernel's `out_dtype`, store.cuh),
// which halves the windows' bytes (bilinear: about 15 us a frame).
//
// Numerics: ry decides floor(ry) and ry == floor(ry), so a contracted
// multiply-add would move pixels between cells.  The residual, the weights
// and the sum use explicitly rounded operations (__fmul_rn / __fadd_rn /
// __fsub_rn) in the TPU kernel's order, and the result matches the plain
// PyTorch version to the last bit.

#include "shift.cuh"
#include "store.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block, at most
constexpr int kWindows = 8;    // windows of a grid row a block walks
constexpr int kStages = 2;     // tile buffers: the next window arrives while one is computed

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keys cubic-convolution weight, a = -0.5, in the TPU kernel's term order:
//   |d| <= 1:     (1.5|d|^3 - 2.5|d|^2) + 1              (the inner piece)
//   1 < |d| < 2:  ((-0.5|d|^3 - -2.5|d|^2) + -4|d|) - -2  (the outer piece)
//   otherwise 0.
// Tap k of a pixel sits at distance d = (r + 1) - (floor(r) + k), and with
// r + 1 rounded and the subtraction exact, |d| lies in [1, 2] for taps 0
// and 3 and in [0, 1] for taps 1 and 2.  So the tap's position fixes the
// piece the branch would choose, and no weight needs a branch or a select:
// taps 1 and 2 take the inner piece, taps 0 and 3 the outer one, which at
// |d| = 1 and |d| = 2 gives +0 as the inner piece and the zero branch do.
// Every weight is the branchy version's to the last bit.
__device__ __forceinline__ float keys_inner(float ad) {
  const float ad2 = __fmul_rn(ad, ad);
  const float ad3 = __fmul_rn(ad2, ad);
  return __fadd_rn(__fsub_rn(__fmul_rn(1.5f, ad3), __fmul_rn(2.5f, ad2)), 1.0f);
}

__device__ __forceinline__ float keys_outer(float ad) {
  const float ad2 = __fmul_rn(ad, ad);
  const float ad3 = __fmul_rn(ad2, ad);
  float r = __fsub_rn(__fmul_rn(-0.5f, ad3), __fmul_rn(-2.5f, ad2));
  r = __fadd_rn(r, __fmul_rn(-4.0f, ad));
  return __fsub_rn(r, -2.0f);
}

// The Keys weight of tap k at distance d.
__device__ __forceinline__ float keys_tap(float d, int k) {
  return k == 1 || k == 2 ? keys_inner(fabsf(d)) : keys_outer(fabsf(d));
}

__device__ __forceinline__ float hat(float r, float k) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(r, k))));
}

// The pixel at (pi, pj) of the window, from its residuals (ry, rx) and the
// window's tile, whose rows lie TP floats apart in shared memory.
template <bool kCubic>
__device__ __forceinline__ float sample(const float* tile, int TP, int pi,
                                        int pj, float ry, float rx) {
  const float fry = floorf(ry);
  const float frx = floorf(rx);
  const float* t = tile + (pi + (int)fry) * TP + (pj + (int)frx);
  float acc = 0.0f;
  if (kCubic) {
    float wy[4], wx[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // tap k sits at tile row floor(ry) + k: distance (ry + 1) - ky
      wy[k] = keys_tap(__fsub_rn(__fadd_rn(ry, 1.0f), __fadd_rn(fry, (float)k)), k);
      wx[k] = keys_tap(__fsub_rn(__fadd_rn(rx, 1.0f), __fadd_rn(frx, (float)k)), k);
    }
#pragma unroll
    for (int ky = 0; ky < 4; ++ky)
#pragma unroll
      for (int kx = 0; kx < 4; ++kx)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy[ky], wx[kx]),
                                       t[ky * TP + kx]));
  } else {
    // integer sample coordinate in EITHER axis -> floor corner
    if (ry == fry || rx == frx) {
      ry = fry;
      rx = frx;
    }
    float wy[2], wx[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      wy[k] = hat(ry, __fadd_rn(fry, (float)k));
      wx[k] = hat(rx, __fadd_rn(frx, (float)k));
    }
#pragma unroll
    for (int ky = 0; ky < 2; ++ky)
#pragma unroll
      for (int kx = 0; kx < 2; ++kx)
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy[ky], wx[kx]),
                                       t[ky * TP + kx]));
  }
  return acc;
}

// Threads a block and pixel rows a pass for window size w: Q = ceil(w / 4)
// column quads a row, R = min(w, kThreads / Q) rows a pass (w32: two rows a
// thread), and the block rounded up to whole warps.
struct Geometry {
  int Q, R, threads;
};

Geometry geometry_for(int w) {
  Geometry g;
  g.Q = (w + 3) / 4;
  g.R = w < kThreads / g.Q ? w : kThreads / g.Q;
  const int threads = (g.Q * g.R + 31) / 32 * 32;
  g.threads = threads < 32 ? 32 : threads;
  return g;
}

int tile_side(int w, int M, bool cubic) { return w + 2 * M + (cubic ? 4 : 1); }

// The tile's row pitch in shared memory: T rounded up to an odd number, so
// that the rows a warp reads start in banks of different residues mod 4
// (w32 bicubic: T = 40 put four rows' taps in the same eight banks).
__host__ __device__ int tile_pitch(int T) { return T | 1; }

template <bool kCubic, typename Out>
__global__ void __launch_bounds__(kThreads, 6)
def_windows_kernel(const float* __restrict__ frame,
                   const int* __restrict__ dy, const int* __restrict__ dx,
                   const float* __restrict__ fy, const float* __restrict__ fx,
                   const float* __restrict__ gyi, const float* __restrict__ gyj,
                   const float* __restrict__ gxi, const float* __restrict__ gxj,
                   Out* __restrict__ out,
                   int Hp, int Wp, int n_rows, int n_cols,
                   int w, int step, int off, int row_start, int M, int Q,
                   int R) {
  extern __shared__ float smem[];
  const int T = w + 2 * M + (kCubic ? 4 : 1);
  const int TP = tile_pitch(T);
  const int base = M + (kCubic ? 1 : 0);
  const int r = blockIdx.y;  // row of the block's windows in the row block
  const int b = blockIdx.z;  // frame of the batch
  const int c0 = blockIdx.x * kWindows;
  const int n_mine = min(kWindows, n_cols - c0);
  const int64_t w0 = ((int64_t)b * n_rows + r) * n_cols + c0;  // first window
  const float* fb = frame + (int64_t)b * Hp * Wp;
  const int q = threadIdx.x % Q;   // the thread's column quad
  const int p0 = threadIdx.x / Q;  // its first pixel row; p0 >= R: idle
  // the staging walk: tile element e = threadIdx.x + m * blockDim.x, row
  // major, its row and column stepped on from the thread's first ones
  const int row_step = blockDim.x / T;
  const int col_step = blockDim.x - row_step * T;
  const int row0 = threadIdx.x / T;
  const int col0 = threadIdx.x - row0 * T;
  const float half = (float)(w - 1) * 0.5f;  // exact: a half-integer
  const float hi = __fsub_rn((float)(2 * M + 1), 1e-3f);  // floor(r) <= 2M
  const bool vec = (w & 3) == 0;

  // window k of the block's run: its clamped tile into buffer k % kStages
  auto stage = [&](int k) {
    float* tile = smem + (k % kStages) * T * TP;
    const int64_t wi = w0 + k;
    const int ty = min(max((row_start + r) * step + off + dy[wi] - base, 0), Hp - T);
    const int tx = min(max((c0 + k) * step + off + dx[wi] - base, 0), Wp - T);
    const float* src = fb + (int64_t)ty * Wp + tx;
    int i = row0, j = col0;
    for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
      piv::cp_async4(tile + i * TP + j, src + (int64_t)i * Wp + j);
      i += row_step;
      j += col_step;
      if (j >= T) {
        j -= T;
        ++i;
      }
    }
  };

  // one group of copies a window, empty past the run's end, so that
  // waiting for all but the last kStages - 1 groups waits for window k
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_mine) stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_mine; ++k) {
    if (k + kStages - 1 < n_mine) stage(k + kStages - 1);  // into k - 1's buffer
    cp_async_commit();
    cp_async_wait_group<kStages - 1>();
    __syncthreads();
    if (p0 < R) {
      const float* tile = smem + (k % kStages) * T * TP;
      const int64_t wi = w0 + k;
      const float by = __fadd_rn((float)M, fy[wi]);
      const float bx = __fadd_rn((float)M, fx[wi]);
      const float gyi_ = gyi[wi], gxi_ = gxi[wi];
      const float gyj_ = gyj[wi], gxj_ = gxj[wi];
      // the column parts of the residuals: gyj*joff and gxj*joff
      float col_y[4], col_x[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float joff = __fsub_rn((float)(4 * q + jj), half);
        col_y[jj] = __fmul_rn(gyj_, joff);
        col_x[jj] = __fmul_rn(gxj_, joff);
      }
      Out* dst = out + wi * w * w + 4 * q;
      for (int pi = p0; pi < w; pi += R) {
        const float ioff = __fsub_rn((float)pi, half);
        // the row-invariant parts: by + gyi*ioff and bx + gxi*ioff
        const float row_y = __fadd_rn(by, __fmul_rn(gyi_, ioff));
        const float row_x = __fadd_rn(bx, __fmul_rn(gxi_, ioff));
        float px[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int pj = 4 * q + jj;
          px[jj] = 0.0f;
          if (pj < w) {
            const float ry = fminf(fmaxf(__fadd_rn(row_y, col_y[jj]), 0.0f), hi);
            const float rx = fminf(fmaxf(__fadd_rn(row_x, col_x[jj]), 0.0f), hi);
            px[jj] = sample<kCubic>(tile, TP, pi, pj, ry, rx);
          }
        }
        if (vec) {
          piv::store4_cs(dst + pi * w, px);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * q + jj < w) piv::store_cs(dst + pi * w + jj, px[jj]);
        }
      }
    }
    __syncthreads();  // buffer k % kStages is staged again for window k + kStages
  }
}

template <typename Out>
int launch(const float* frame, const int* dy, const int* dx, const float* fy,
           const float* fx, const float* gyi, const float* gyj,
           const float* gxi, const float* gxj, Out* out, int B, int Hp, int Wp,
           int n_rows, int n_cols, int w, int step, int off, int row_start,
           int M, int cubic, cudaStream_t stream) {
  const int T = tile_side(w, M, cubic);
  if (w < 1 || M < 1 || T > 129) return (int)cudaErrorInvalidValue;
  const size_t smem = kStages * (size_t)T * tile_pitch(T) * sizeof(float);
  auto kernel = cubic ? def_windows_kernel<true, Out> : def_windows_kernel<false, Out>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Geometry g = geometry_for(w);
  dim3 grid((n_cols + kWindows - 1) / kWindows, n_rows, B);
  kernel<<<grid, g.threads, smem, stream>>>(
      frame, dy, dx, fy, fx, gyi, gyj, gxi, gxj, out,
      Hp, Wp, n_rows, n_cols, w, step, off, row_start, M, g.Q, g.R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// frame: [B, Hp, Wp] f32; dy, dx: [B, N] i32; fy, fx and the four gradient
// maps: [B, N] f32; out: [B, N, w, w] with N = n_rows * n_cols, in the
// entry point's store type (`def_windows_f32`: float; `_store_bf16`,
// `_store_f16`: the float32 result rounded to nearest even).  The tile side
// w + 2M + (4 | 1) is at most 129.  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
// The launch serves window rows row_start .. row_start + n_rows - 1 of the
// grid (the maps and out hold just those rows; 0 and all rows for the whole
// grid); frame is the whole padded frame and a window's origin row is
// (row_start + r) * step + off.
#define PIV_DEF_WINDOWS(SUFFIX, TYPE)                                          \
  int def_windows_##SUFFIX(const float* frame, const int* dy, const int* dx,   \
                           const float* fy, const float* fx,                   \
                           const float* gyi, const float* gyj,                 \
                           const float* gxi, const float* gxj, TYPE* out,      \
                           int B, int Hp, int Wp, int n_rows, int n_cols,      \
                           int w, int step, int off, int row_start, int M,     \
                           int cubic, void* stream) {                          \
    return launch(frame, dy, dx, fy, fx, gyi, gyj, gxi, gxj, out, B, Hp, Wp,   \
                  n_rows, n_cols, w, step, off, row_start, M, cubic,           \
                  (cudaStream_t)stream);                                       \
  }
PIV_STORE_TYPES(PIV_DEF_WINDOWS)

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, windows a block
// of the launch for window size w, margin M and `cubic`.  Returns a CUDA
// error code, 0 on success.
int def_windows_describe(int w, int M, int cubic, int* out) {
  const int T = tile_side(w, M, cubic);
  if (w < 1 || M < 1 || T > 129) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(
      &attr, cubic ? def_windows_kernel<true, float> : def_windows_kernel<false, float>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes +
                 kStages * (size_t)T * tile_pitch(T) * sizeof(float));
  out[3] = geometry_for(w).threads;
  out[4] = kWindows;
  return 0;
}

const char* def_windows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
