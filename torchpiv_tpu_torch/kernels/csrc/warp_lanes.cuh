// The lane map of a window kept in a warp's registers, shared by the
// redesigned window shifts shift_windows_bicubic.cu and, through
// warp_bilinear.cuh, shift_windows_phases.cu, shift_windows_bf16.cu and
// shift_windows_lanephases.cu
// (shift_windows.cu has its own copy, which its anatomy tool edits by
// text).
//
// A window belongs to a group of G lanes (G a power of two).  Lane c of
// the group holds the tile columns c, c + G, ..., c + G*(K-1) in slots
// 0..K-1, and in an extra slot K the column c + G*K where the stencil
// reads it: the stencil reads `reach` columns past the window's last one
// (1 bilinear, 3 bicubic), so the group's first `reach` lanes hold the
// tile's last columns there.  w <= 32 packs 32 / G windows into a warp (G
// the next power of two of max(w, reach)), w > 32 gives each lane K =
// ceil(w / 32) columns.  The warp walks the tile rows; each row is one
// coalesced load a slot, read through L1 (`__ldg`), widened to float32.
// The column d to the right of a slot's column (d <= G) comes from lane
// c + d by one shuffle a slot: a lane whose c + d passes the group's end
// reads lane c + d - G's next slot, which every lane c' < d offers in place
// of its own value.  No shared memory, no barrier, no integer division.
// `ops/shifts.py` replays the map on the CPU (`warp_window_steps`,
// `warp_bicubic_steps`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace piv {
namespace warp {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kAll = 0xffffffffu;

// Where a warp's lanes sit: groups of G lanes (G = 1 << lg), one window a
// group, P windows a warp, K columns a lane.
struct Lanes {
  int G, lg, P, K;
};

inline Lanes lanes_for(int w, int reach) {
  Lanes l;
  if (w > 32) {
    l.G = 32;
    l.K = (w + 31) / 32;
  } else {
    l.G = 1;
    while (l.G < w || l.G < reach) l.G <<= 1;
    l.K = 1;
  }
  l.lg = 0;
  while ((1 << l.lg) < l.G) ++l.lg;
  l.P = 32 / l.G;
  return l;
}

// A float32 frame element that is read as the nearest bfloat16 (round to
// nearest even, as torch's `.to(torch.bfloat16)`), widened back.
struct RoundedF32 {
  float value;
};

// One element of a frame row as float32: a float32 frame's own value, a
// bfloat16 frame's value widened exactly.
__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
// x rounded to bfloat16 and widened back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Tile row `row` into slots 0..K of lane c: column c + G*k where the row
// and the column are at most `last` (the last the stencil reads), else 0.
// A RoundedF32 row is rounded two slots an instruction (`cvt.rn.bf16x2`).
template <int K, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int pitch,
                                         int row, int c, int G, int last,
                                         float (&v)[K + 1]) {
  const T* p = src + (int64_t)row * pitch + c;
  if constexpr (std::is_same<T, RoundedF32>::value) {
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      const bool in_tile = row <= last && c + G * k <= last;
      v[k] = in_tile ? __ldg(&p[G * k].value) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k + 1 <= K; k += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[k], v[k + 1]);
      v[k] = __low2float(h);
      v[k + 1] = __high2float(h);
    }
    if (K % 2 == 0) v[K] = round_bf16(v[K]);
  } else {
#pragma unroll
    for (int k = 0; k <= K; ++k) {
      const bool in_tile = row <= last && c + G * k <= last;
      v[k] = in_tile ? load_float(p + G * k) : 0.0f;
    }
  }
}

// Column j + d of each slot's column j, 1 <= d <= G: lane c + d's slot,
// or, past the group's end, lane c + d - G's next slot, which it offers in
// place of its own (every lane c < d offers v[k + 1]).
template <int K>
__device__ __forceinline__ void right_at(const float (&v)[K + 1], int c, int G,
                                         int d, float (&out)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = c < d ? v[k + 1] : v[k];
    out[k] = __shfl_sync(kAll, x, (c + d) & (G - 1), G);
  }
}

}  // namespace warp
}  // namespace piv

// `return fn<K>(...)` for the instance that serves K columns a lane.
#define PIV_FOR_SLOTS(K, fn, ...)          \
  switch (K) {                             \
    case 1: return fn<1>(__VA_ARGS__);     \
    case 2: return fn<2>(__VA_ARGS__);     \
    case 3: return fn<3>(__VA_ARGS__);     \
    case 4: return fn<4>(__VA_ARGS__);     \
    default: return (int)cudaErrorInvalidValue; \
  }
