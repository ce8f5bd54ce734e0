// The "lanephases" window shift as a ring of shared-memory stages fed by
// the copy engine (the Tensor Memory Accelerator), for Hopper (sm_90a),
// plain C interface: the design that the package's
// csrc/shift_windows_lanephases.cu was measured against and that lost to
// it (PERF.md §6, PR 10).  Not a kernel of the package: the tool
// tools/lanephases_ring_cuda.py builds it, under the variant's name, into
// a copy of the package's csrc/ (it includes shift.cuh and warp_lanes.cuh),
// and times it at several depths and block sizes; `tma_ring_steps` there
// replays its rows, ring stages, phases and shared-memory reads on the CPU.
//
// Same function as the TPU kernel `_shift_kernel_lanephases` behind
// `shift_windows_pallas(variant="lanephases")`
// (torchpiv_tpu/experimental/shift_variants.py) and shift_windows.cu, on
// the same float32 padded frame: every window reads a (w+1)^2 tile at its
// origin plus the window's integer shift, clamped into [0, Hp-w-1] x
// [0, Wp-w-1], and blends the tile's four corner slices with per-window
// scalar weights; a window whose shift is an integer in either axis copies
// the floor corner.  The plain PyTorch version is
// `blend_reference_variant(..., "lanephases")` in
// torchpiv_tpu_torch/ops/shifts.py.
//
// The idea kept from the TPU variant: a coarse bulk move and a remainder
// that costs only an address.  On Hopper the bulk move is the copy engine
// (the Tensor Memory Accelerator): one lane asks for a tile row's bytes
// with one `cp.async.bulk` and the copy lands in shared memory without
// passing through a register; an `mbarrier` counts the bytes.  A row copy
// starts at the 16-byte boundary at or before the tile's first column (the
// engine's rule) and runs to the next one after its last, so a window's
// tile is w + 1 copies of round_up(s + w + 1, 4) floats, s = tx & 3 the
// window's column within its first 16-byte piece; the blend reads the
// tile at column s of its slot: the remainder is an address.  The frame's
// row pitch must be a whole number of 16-byte pieces, and a copy never
// passes the pitch (round_up(tx + w + 1, 4) <= round_up(Wp, 4)).
//
// Tensor-map loads (`cp.async.bulk.tensor`, one box a window, zeros past
// Wp) would be one instruction a window, and were this design's first
// form; on the H100 machines this port is measured on (driver 13.0,
// runtime 12.9) every tensor-map load faults with cudaErrorIllegalInstruction,
// whether the descriptor is a `__grid_constant__` parameter, in constant
// or in global memory, 2-D or 3-D, from `cuTensorMapEncodeTiled` found by
// any entry point or linked, while the 1-D bulk copy of the same engine
// runs (PERF.md, PR 10).  So the rows are copied one by one.
//
// Bound on an H100: bytes, row 1's.  At the main path's pass-2 shape
// (2048^2 frame, w = 32, o = 16, S = 16: N = 16129 windows) one frame
// writes N*w*w*4 = 66.1 MB and reads the 2080*2088*4 = 17.4 MB frame plus
// 4 maps of N*4 bytes: 83.7 MB, about 25 us at 3.35 TB/s.  The copies read
// 33 x 36 x 4 = 4752 B a window at most from L2, which serves the overlap
// of neighbouring windows.
//
// What the design does about the bound.  The window's stores run at the
// memory rate only if the loads before them are in flight early enough;
// the warp-a-window kernels (shift_windows.cu, warp_bilinear.cuh) keep
// them in flight in registers, and registers cap how many rows ahead.
// Here:
//
// * Persistent warps: the launcher sizes the grid to the warps the card
//   holds at once, and each warp walks a run of consecutive windows of the
//   flat [B, n_rows, n_cols] order (windows of up to 16 px share a warp as
//   in warp_lanes.cuh's map: a group of G lanes a window, 32 / G windows
//   an item).  No block barrier anywhere: each warp owns its barriers and
//   its ring.
// * A ring of D stages a warp: item k + D's rows are asked for as soon as
//   item k's blend has read its stage, so D - 1 items' copies overlap a
//   blend; the warp waits on the stage's `mbarrier` phase
//   (`try_wait.parity`, parity k / D & 1), not on a block barrier.  Lane c
//   of a group copies tile rows c, c + G, ...; the group's first lane
//   adds its window's bytes to the barrier (`expect_tx`), lane 0 arrives.
// * The blend reads shared memory: lane c of a group takes tile columns
//   c + G*k (and c + G*k + 1, its right neighbour) of a row, consecutive
//   words (conflict-free for G = 32; the 32 / G windows of a narrower
//   item may share banks, off the main path), kRows rows read ahead of
//   their stores, the row above kept in registers; each output row is one
//   coalesced streaming store (`__stcs`).  No integer division a pixel;
//   one a window (its grid position).
// * The map's per-window operands (dy, dx, fy, fx) are read one item
//   ahead of their use, so their latency hides behind a blend.
//
// D and the warps a block are chosen by w (`plan_for`): kWarps warps of
// kDepth stages while they fit kSmemBudget (two blocks an SM), fewer warps,
// then fewer stages, down to one warp of as many stages as the block's
// 227 KB hold.  Two stages of eight warps timed best (0.1788 ms at the
// pass-2 shape; 16-byte `cp.async` pieces in place of the row copies
// 0.1735): deeper rings cost blocks an SM, and the warps an SM holds set
// the pace.
//
// The blend is shift.cuh's: the result matches the plain version, and
// shift_windows.cu, to the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "shift.cuh"
#include "warp_lanes.cuh"

namespace {

using piv::warp::Lanes;

constexpr int kMaxWind = 128;    // four columns a lane
constexpr int kWarps = 8;        // warps a block, at most
constexpr int kDepth = 2;        // stages a warp's ring, at most
constexpr int kMaxDepth = 8;     // barriers a warp has room for
constexpr int kRows = 4;         // tile rows read ahead of their stores
constexpr size_t kSmemBudget = 100 * 1024;  // two blocks an SM
constexpr size_t kSmemMax = 232448;         // a block's most on this card

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Where a warp's tiles sit and how deep its ring is, for window size w.
struct Plan {
  Lanes l;
  int box_w;         // floats of a tile row's slot: the longest row copy
  int slot_floats;   // a window's tile: w + 1 rows of box_w
  int stage_floats;  // an item's tiles: 32 / G windows
  int warps, depth;
  size_t smem;       // dynamic shared memory a block
};

Plan plan_for(int w) {
  Plan p;
  p.l = piv::warp::lanes_for(w, 1);
  p.box_w = round_up(w + 4, 4);  // 3 columns before the tile at most
  p.slot_floats = (w + 1) * p.box_w;
  p.stage_floats = p.l.P * p.slot_floats;
  const size_t stage = (size_t)p.stage_floats * 4;
  p.warps = kWarps;
  p.depth = kDepth;
  while (p.warps > 1 && p.warps * p.depth * stage > kSmemBudget) p.warps >>= 1;
  while (p.depth > 2 && p.warps * p.depth * stage > kSmemBudget) --p.depth;
  if (p.warps * p.depth * stage > kSmemBudget)  // one warp: what a block holds
    p.depth = std::min<int>(kDepth, (int)(kSmemMax / stage));
  p.smem = p.warps * p.depth * stage;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Add `bytes` to the phase's transaction count, without arriving.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from `src` to shared memory at `dst`, both
// 16-byte aligned, by the copy engine; the bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The window that group `p` serves in flat item f.
struct Window {
  int b, r, col;
  int64_t wi;  // flat window index, clamped into the row
  bool live;   // the window exists (a ragged row's last item may be short)
};

__device__ __forceinline__ Window window_of(int64_t f, int items_per_row, int n_rows,
                                            int n_cols, int P, int p) {
  Window win;
  const int64_t row = f / items_per_row;  // one division a window
  const int ic = (int)(f - row * items_per_row);
  win.b = (int)(row / n_rows);
  win.r = (int)(row - (int64_t)win.b * n_rows);
  win.col = ic * P + p;
  win.live = win.col < n_cols;
  win.wi = ((int64_t)win.b * n_rows + win.r) * n_cols + min(win.col, n_cols - 1);
  return win;
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
shift_windows_lanephases_kernel(const float* __restrict__ frame,
                                const int* __restrict__ dy,
                                const int* __restrict__ dx,
                                const float* __restrict__ fy,
                                const float* __restrict__ fx,
                                float* __restrict__ out, int Hp, int Wp, int pitch,
                                int n_rows, int n_cols, int w, int step, int off,
                                int lg, int box_w, int depth, int64_t n_items,
                                int run) {
  __shared__ __align__(8) uint64_t bars[kWarps * kMaxDepth];
  extern __shared__ __align__(16) float smem_ring[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = 1 << lg;
  const int P = 32 >> lg;
  const int c = lane & (G - 1);  // the lane's first column
  const int p = lane >> lg;      // the lane's window in an item
  const int64_t first = ((int64_t)blockIdx.x * (blockDim.x >> 5) + warp) * run;
  const int64_t end = first + run < n_items ? first + run : n_items;
  if (first >= end) return;  // the whole warp: nothing of the run is left
  const int count = (int)(end - first);
  const int items_per_row = (n_cols + P - 1) / P;
  const int T1 = w + 1;
  const int slot_floats = T1 * box_w;
  const int stage_floats = P * slot_floats;
  float* ring = smem_ring + (size_t)warp * depth * stage_floats;
  const uint32_t ring_addr = smem_addr(ring);
  const uint32_t bar0 = smem_addr(&bars[warp * kMaxDepth]);
  if (lane == 0) {
    for (int s = 0; s < depth; ++s) bar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the clamped tile column of group p's window, shifted by ddx
  auto tile_x = [&](const Window& win, int ddx) {
    return min(max(win.col * step + off + ddx, 0), Wp - T1);
  };
  // Ask for item f's tiles into stage s: each live window's first lane adds
  // its bytes to the barrier, lane 0 arrives, and lane c of the group
  // copies tile rows c, c + G, ... from the 16-byte boundary before the
  // tile's first column.
  auto issue = [&](int64_t f, int s, int ddy, int ddx) {
    const Window win = window_of(f, items_per_row, n_rows, n_cols, P, p);
    const uint32_t bar = bar0 + 8 * s;
    const int ty = min(max(win.r * step + off + ddy, 0), Hp - T1);
    const int tx = tile_x(win, ddx);
    const int x0 = tx & ~3;
    const int len = round_up(tx - x0 + T1, 4);  // floats a row copy
    if (c == 0 && win.live) bar_expect(bar, (uint32_t)(T1 * len * 4));
    __syncwarp();
    if (lane == 0) bar_arrive(bar);
    if (win.live) {
      const float* src = frame + ((int64_t)win.b * Hp + ty) * pitch + x0;
      const uint32_t dst = ring_addr + 4u * (uint32_t)(s * stage_floats + p * slot_floats);
      for (int row = c; row < T1; row += G)
        bulk_copy(dst + 4u * (uint32_t)(row * box_w), src + (int64_t)row * pitch,
                  (uint32_t)(len * 4), bar);
    }
  };

  // the integer shifts of the next item to issue, read one issue ahead
  auto shifts_of = [&](int k, int& ddy, int& ddx) {
    ddy = ddx = 0;
    if (k < count) {
      const Window win = window_of(first + k, items_per_row, n_rows, n_cols, P, p);
      ddy = __ldg(dy + win.wi);
      ddx = __ldg(dx + win.wi);
    }
  };
  const int ahead = min(depth, count);
  for (int k = 0; k < ahead; ++k) {
    int ddy, ddx;
    shifts_of(k, ddy, ddx);
    issue(first + k, k, ddy, ddx);
  }
  int next_dy, next_dx;  // item `depth`'s shifts
  shifts_of(depth, next_dy, next_dx);
  Window win = window_of(first, items_per_row, n_rows, n_cols, P, p);
  float cur_fy = __ldg(fy + win.wi), cur_fx = __ldg(fx + win.wi);
  int cur_dx = __ldg(dx + win.wi);

  int s = 0;
  uint32_t parity = 0;
  for (int k = 0; k < count; ++k) {
    // the next item's operands, in flight during this blend
    Window nxt = win;
    float nxt_fy = 0.0f, nxt_fx = 0.0f;
    int nxt_dx = 0;
    if (k + 1 < count) {
      nxt = window_of(first + k + 1, items_per_row, n_rows, n_cols, P, p);
      nxt_fy = __ldg(fy + nxt.wi);
      nxt_fx = __ldg(fx + nxt.wi);
      nxt_dx = __ldg(dx + nxt.wi);
    }
    const piv::Blend blend = piv::blend_weights(cur_fy, cur_fx);
    float* dst = out + win.wi * w * w;
    // the tile's first column sits at tx & 3 in its slot's rows
    const float* tile = ring + s * stage_floats + p * slot_floats + (tile_x(win, cur_dx) & 3);
    bar_wait(bar0 + 8 * s, parity);

    float top[K], top_right[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = c + G * q;
      top[q] = j < w ? tile[j] : 0.0f;
      top_right[q] = j < w ? tile[j + 1] : 0.0f;
    }
    for (int i0 = 0; i0 < w; i0 += kRows) {
      float below[kRows][K], below_right[kRows][K];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int row = i0 + u + 1;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int j = c + G * q;
          const bool in = row <= w && j < w;
          below[u][q] = in ? tile[row * box_w + j] : 0.0f;
          below_right[u][q] = in ? tile[row * box_w + j + 1] : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + u;  // output row: tile rows i and i + 1
        if (i >= w) break;     // the same for the whole warp
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int j = c + G * q;
          const float val = piv::blend_corners(top[q], top_right[q], below[u][q],
                                               below_right[u][q], blend);
          if (win.live && j < w) __stcs(dst + i * w + j, val);
          top[q] = below[u][q];
          top_right[q] = below_right[u][q];
        }
      }
    }
    // every lane has read stage s: it takes item k + depth
    __syncwarp();
    if (k + depth < count) {
      issue(first + k + depth, s, next_dy, next_dx);
      shifts_of(k + depth + 1, next_dy, next_dx);
    }
    win = nxt;
    cur_fy = nxt_fy;
    cur_fx = nxt_fx;
    cur_dx = nxt_dx;
    if (++s == depth) {
      s = 0;
      parity ^= 1u;
    }
  }
}

// Let the instance take the plan's dynamic shared memory (set before
// every launch: instances of one K serve several w).
template <int K>
int allow_smem(const Plan& p) {
  return (int)cudaFuncSetAttribute(shift_windows_lanephases_kernel<K>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)p.smem);
}

// Blocks of the instance for window size w that an SM holds at once.
template <int K>
int blocks_per_sm(const Plan& p, int* n) {
  const int e = allow_smem<K>(p);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, shift_windows_lanephases_kernel<K>, p.warps * 32, p.smem);
}

template <int K>
int launch(const Plan& pl, const float* frame, const int* dy, const int* dx,
           const float* fy, const float* fx, float* out, int B, int Hp, int Wp,
           int pitch, int n_rows, int n_cols, int w, int step, int off,
           cudaStream_t stream) {
  static int cached[kMaxWind + 1];  // blocks an SM, by w (0: not asked yet)
  int per_sm = cached[w];
  if (per_sm == 0) {
    const int e = blocks_per_sm<K>(pl, &per_sm);
    if (e != 0) return e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached[w] = per_sm;
  } else {
    const int e = allow_smem<K>(pl);
    if (e != 0) return e;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int items_per_row = (n_cols + pl.l.P - 1) / pl.l.P;
  const int64_t n_items = (int64_t)B * n_rows * items_per_row;
  const int64_t resident = (int64_t)sms * per_sm * pl.warps;
  const int64_t warps = std::min<int64_t>(n_items, resident);
  const int64_t blocks = (warps + pl.warps - 1) / pl.warps;
  const int run = (int)((n_items + blocks * pl.warps - 1) / (blocks * pl.warps));
  shift_windows_lanephases_kernel<K><<<(unsigned)blocks, pl.warps * 32, pl.smem, stream>>>(
      frame, dy, dx, fy, fx, out, Hp, Wp, pitch, n_rows, n_cols, w, step, off, pl.l.lg,
      pl.box_w, pl.depth, n_items, run);
  return (int)cudaGetLastError();
}

template <int K>
int describe(const Plan& pl, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, shift_windows_lanephases_kernel<K>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes + pl.smem);
  out[3] = pl.warps * 32;
  out[4] = pl.warps * pl.l.P;
  return 0;
}

}  // namespace

extern "C" {

// frame: [B, Hp, pitch] f32, 16-byte aligned, pitch >= Wp a multiple of 4
// (columns from Wp on are not read into a window); dy, dx: [B, N] i32;
// fy, fx: [B, N] f32; out: [B, N, w, w] f32 with N = n_rows * n_cols.
// w in 1..128.  Launches on `stream` and returns cudaGetLastError() of the
// launch (0 on success), cudaErrorMisalignedAddress for a frame the copy
// engine cannot read.
int shift_windows_lanephases_f32(const float* frame, const int* dy, const int* dx,
                                 const float* fy, const float* fx, float* out, int B,
                                 int Hp, int Wp, int pitch, int n_rows, int n_cols,
                                 int w, int step, int off, void* stream) {
  if (w < 1 || w > kMaxWind || pitch < Wp || Hp < w + 1 || Wp < w + 1)
    return (int)cudaErrorInvalidValue;
  if (pitch % 4 != 0 || reinterpret_cast<uintptr_t>(frame) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const Plan pl = plan_for(w);
  PIV_FOR_SLOTS(pl.l.K, launch, pl, frame, dy, dx, fy, fx, out, B, Hp, Wp, pitch,
                n_rows, n_cols, w, step, off, (cudaStream_t)stream);
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block (barriers and ring), threads a
// block, windows a block in flight at once, of the instance that serves
// window size w.  Returns a CUDA error code, 0 on success.
int shift_windows_lanephases_describe(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(w);
  PIV_FOR_SLOTS(pl.l.K, describe, pl, out);
}

// out[0..5]: warps a block, stages a warp's ring, floats of a tile row's
// slot, floats of a window's slot, dynamic shared memory a block, blocks
// an SM holds, for window size w (`lanephases_plan` in ops/shifts.py
// mirrors the first five).  Returns a CUDA error code, 0 on success.
int shift_windows_lanephases_plan(int w, int* out) {
  if (w < 1 || w > kMaxWind) return (int)cudaErrorInvalidValue;
  const Plan pl = plan_for(w);
  out[0] = pl.warps;
  out[1] = pl.depth;
  out[2] = pl.box_w;
  out[3] = pl.slot_floats;
  out[4] = (int)pl.smem;
  PIV_FOR_SLOTS(pl.l.K, blocks_per_sm, pl, &out[5]);
}

const char* shift_windows_lanephases_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
