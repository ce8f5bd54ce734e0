// Fused peak fit for Hopper (sm_90a), plain C interface: first peak,
// 3-point Gaussian sub-pixel fit and peak-ratio validation in one pass over
// each correlation map.
//
// Replaces the TPU kernel `_peakfit_kernel` behind
// `correlation_to_displacement_pallas`
// (torchpiv_tpu/experimental/peakfit_pallas.py).  Same function, per map:
//   x = (corr - min(corr)) + EPS   (or corr + EPS without min_subtract);
//   m = first flat index of the largest corr;
//   the four flat-index neighbours m+1, m-1, m+k, m-k, each replaced by m
//   itself at the ends of the flat map;
//   du = (ln cr - ln cl) / (2*(ln cl + ln cr) - 4*ln cm), dv alike;
//   u = nan_to_num(col + du - k/2), v = nan_to_num(row + dv - d/2);
//   second peak: the maximum of x outside the flat-offset neighbourhood
//   {i + k*j : |i|, |j| <= vw} of m, whose out-of-range offsets collapse
//   onto flat index 0 and kd-1, and at least 0; invalid = cm / c2 <
//   val_ratio, or all four neighbours replaced (a degenerate map).
// A map that holds a NaN fits as the plain version's does: m is its first
// NaN, u = v = 0, and invalid only where that m is degenerate.  The plain
// PyTorch version is `correlation_to_displacement` in
// torchpiv_tpu_torch/ops/peakfit.py; `warp_fit_steps` there replays this
// kernel's lanes, reductions and band on the CPU.
//
// Bound on an H100: bytes.  Each map is read once (N*d*k*4 bytes) and 9
// bytes come out: at the pass-2 shape of a 4 MP run (4 pairs, N = 64516
// maps of 32^2) 264 MB, about 79 us at 3.35 TB/s; at pass 1 (15876 maps of
// 64^2) 260 MB, 78 us.  The operations, per sample: a minimum, a compare
// and two selects for the first maximum, a maximum for the second peak
// (and, at d > 32, one for the chunk's maximum); about twelve more on the
// samples of the 2*vw + 3 rows that can hold the exclusion set: 8.6 k a
// map at pass 2, about 8 us at 67 TOP/s, so the bytes bound it.
//
// What the design does about the bound.  A warp owns a map, four maps a
// block; nothing is shared between warps, and there is no barrier.  Lane l
// holds the samples l, l + 32, l + 64, ... (one coalesced 128-byte load a
// slot).  The first walk takes the minimum (NaN-propagating, which is how a
// NaN is found), the first maximum and its flat index, then shuffles reduce
// them; the five samples the fit reads are loaded again, one a lane, and
// their logarithms taken side by side, lane 0 fitting u, lane 1 v.  The
// second-peak exclusion set lies within vw + 1 rows of m's row, so only
// the slots that meet those rows run the exclusion test (bit for bit the
// TPU kernel's, `fit.cuh`'s); every other slot takes a plain maximum.
//   d <= 32: the map stays in registers (1 to 32 slots a lane) between the
//   two walks.
//   32 < d <= 128: the map is walked in chunks of 8 or 16 slots, the next
//   chunk's loads issued before the current one is reduced; each lane keeps
//   each chunk's maximum, so the second walk reads back from memory (from
//   the cache, just read) only the chunks that meet the band.
//   d > 128 (up to the 227 KB map of MAX_MAP_BYTES): one block of 128
//   threads a map stages it into shared memory and fits it with `fit.cuh`
//   (argmax of x, NaN ignored), the design before this one.
// The earlier design gave every map a block (64516 blocks at pass 2),
// three block-wide reductions with two barriers each, a serial tail on
// thread 0 while 127 threads waited, and the exclusion test (about 20
// instructions) on every sample: it was bound by instructions and
// barriers, not bytes.
//
// EPS is added after the subtraction of the minimum, as the TPU kernel
// does; the plain version adds (EPS - min) in one step, which can differ in
// the last bit of samples below 2.

#include "fit.cuh"

namespace {

constexpr int kWarps = 4;  // maps a block of the warp kernel
constexpr int kThreads = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;
// the block kernel: 16 blocks fill an SM's 2048 threads; the bound keeps
// it within the 32 registers a thread that this takes
constexpr int kBlockThreads = 128;
constexpr int kBlocksPerSM = 16;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// x of a raw sample
__device__ __forceinline__ float shifted(float c, float mn, int min_subtract) {
  if (min_subtract) c = __fsub_rn(c, mn);
  return __fadd_rn(c, piv::kEps);
}

// The map's neighbour indices and whether all four were replaced.
struct Neighbours {
  int left, right, top, bot;
  __device__ __forceinline__ Neighbours(int m, int k, int kd)
      : left((m + 1 >= kd - 1) ? m : m + 1),
        right((m - 1 <= 0) ? m : m - 1),
        top((m + k >= kd - 1) ? m : m + k),
        bot((m - k <= 0) ? m : m - k) {}
  __device__ __forceinline__ bool degenerate(int kd) const {
    return left >= kd - 1 && right <= 0 && top >= kd - 1 && bot <= 0;
  }
};

// The second-peak exclusion test of fit.cuh, and the flat range of the rows
// that can hold the excluded samples: |i|, |j| <= vw puts m + i + k*j
// within vw + 1 rows of m's row.  The collapses onto 0 and kd - 1 lie in
// the range too: lo means m < vw*(k+1), so m's row is at most vw when vw <
// k, and the range starts at row 0 (hi alike); vw >= k makes it the map.
struct Exclusion {
  int m, k, kd, vw, band_lo, band_hi;
  bool lo, hi, pow2;
  float inv_k;
  __device__ __forceinline__ Exclusion(int m_, int k_, int vw_)
      : m(m_), k(k_), kd(k_ * k_), vw(vw_) {
    const int row = m / k;
    band_lo = max(row - vw - 1, 0) * k;
    band_hi = min(row + vw + 2, k) * k - 1;
    lo = (m - (vw + k * vw)) < 0;
    hi = (m + (vw + k * vw)) > kd - 1;
    pow2 = (k & (k - 1)) == 0;  // dd / k: the product with 1 / k is the same
    inv_k = __fdiv_rn(1.0f, (float)k);
  }
  // the 32 samples first, first + 1, ..., first + 31 miss the band
  __device__ __forceinline__ bool misses(int first) const {
    return first + 31 < band_lo || first > band_hi;
  }
  __device__ __forceinline__ bool excluded(int p) const {
    const int dd = p - m;
    const float q = pow2 ? __fmul_rn((float)dd, inv_k)
                         : __fdiv_rn((float)dd, (float)k);
    const int j = (int)rintf(q);  // half to even
    const bool excl = abs(j) <= vw && abs(dd - k * j) <= vw;
    return excl || (p == 0 && lo) || (p == kd - 1 && hi);
  }
};

// Slots base/32 .. base/32 + CH - 1 of lane `lane`: sample base + lane + 32*s,
// or -inf past the map's end (a ragged last chunk).
template <int CH, bool kRagged>
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, int base,
                                           int lane, int kd, float (&c)[CH]) {
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    const int p = base + lane + 32 * s;
    c[s] = (!kRagged || p < kd) ? __ldg(src + p) : -INFINITY;
  }
}

// The first walk over a chunk: the NaN-propagating minimum, the first
// maximum (its slot; slots ascend, so `>` keeps the first) and the chunk's
// maximum.  -inf pads a ragged chunk: it never wins a maximum, and the
// minimum skips it.
template <int CH, bool kRagged>
__device__ __forceinline__ void scan_chunk(const float (&c)[CH], int slot0, int lane,
                                           int kd, float& mn, float& best,
                                           int& best_slot, float& cmax) {
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    if (!kRagged || lane + 32 * (slot0 + s) < kd) mn = min_nan(mn, c[s]);
    if (c[s] > best) {
      best = c[s];
      best_slot = slot0 + s;
    }
    cmax = fmaxf(cmax, c[s]);
  }
}

// The second walk over a chunk of raw samples: the maximum of those the
// exclusion set does not hold, the test only on slots that meet the band.
template <int CH>
__device__ __forceinline__ float second_chunk(const float (&c)[CH], int slot0, int lane,
                                              const Exclusion& e, float c2) {
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    const int first = 32 * (slot0 + s);
    if (e.misses(first) || !e.excluded(first + lane)) c2 = fmaxf(c2, c[s]);
  }
  return c2;
}

// Blocks an SM the register budget of an instance is cut for (CH slots a
// chunk, at most MAXC chunks; MAXC == 1: the map stays in registers): 64
// registers a thread for up to 16 slots in registers, 80 for 32 (64
// spilled) and for the chunk maxima with two chunks in flight of 8, 128
// with two of 16.
template <int CH, int MAXC>
__host__ __device__ constexpr int min_blocks() {
  return MAXC == 1 ? (CH < 32 ? 8 : 6) : MAXC <= 16 ? 6 : 4;
}

template <int CH, int MAXC>
__global__ void __launch_bounds__(kThreads, min_blocks<CH, MAXC>())
peakfit_warp_kernel(const float* __restrict__ corr, float* __restrict__ u,
                    float* __restrict__ v, unsigned char* __restrict__ invalid,
                    int N, int d, int vw, float val_ratio, int min_subtract) {
  constexpr int kChunk = 32 * CH;  // samples a chunk
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // a whole warp: nothing waits for it
  const int k = d;
  const int kd = d * k;
  const int nc = (kd + kChunk - 1) / kChunk;
  const bool ragged = kd % kChunk != 0;
  const float* src = corr + n * kd;

  // first walk
  float mn = INFINITY, best = -INFINITY;
  int best_slot = -1;
  float cmax[MAXC];
  float cur[CH];
  if (nc == 1 && ragged) load_chunk<CH, true>(src, 0, lane, kd, cur);
  else load_chunk<CH, false>(src, 0, lane, kd, cur);
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < nc) {
      const bool last = j + 1 == nc;
      float next[CH];
      if (MAXC > 1 && !last) {  // the next chunk's loads before this reduction
        if (j + 2 == nc && ragged)
          load_chunk<CH, true>(src, (j + 1) * kChunk, lane, kd, next);
        else
          load_chunk<CH, false>(src, (j + 1) * kChunk, lane, kd, next);
      }
      cmax[j] = -INFINITY;
      if (last && ragged)
        scan_chunk<CH, true>(cur, j * CH, lane, kd, mn, best, best_slot, cmax[j]);
      else
        scan_chunk<CH, false>(cur, j * CH, lane, kd, mn, best, best_slot, cmax[j]);
      if (MAXC > 1 && !last) {
#pragma unroll
        for (int s = 0; s < CH; ++s) cur[s] = next[s];
      }
    }
  }
  int m = best_slot < 0 ? kd : lane + 32 * best_slot;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = min_nan(mn, __shfl_xor_sync(kAll, mn, o));
    const float ob = __shfl_xor_sync(kAll, best, o);
    const int om = __shfl_xor_sync(kAll, m, o);
    if (ob > best || (ob == best && om < m)) {
      best = ob;
      m = om;
    }
  }

  if (isnan(mn)) {  // the whole warp: m is the first NaN, the fit NaN
    int first = kd;
    for (int p = lane; p < kd; p += 32) {
      if (isnan(__ldg(src + p))) {
        first = p;
        break;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_xor_sync(kAll, first, o));
    if (lane == 0) {
      u[n] = 0.0f;
      v[n] = 0.0f;
      if (invalid != nullptr) invalid[n] = Neighbours(first, k, kd).degenerate(kd) ? 1 : 0;
    }
    return;
  }
  if (m >= kd) m = 0;  // every sample -inf: the first index, as argmax gives

  // the five samples the fit reads, one a lane: m, left, right, top, bot
  const Neighbours nb(m, k, kd);
  const int at = lane == 1 ? nb.left : lane == 2 ? nb.right
               : lane == 3 ? nb.top : lane == 4 ? nb.bot : m;
  const float x = shifted(__ldg(src + at), mn, min_subtract);
  const float lx = logf(x);
  const float lcm = __shfl_sync(kAll, lx, 0);
  const int a = lane == 1 ? 3 : 1;  // lane 0 fits u from lanes 1-2, lane 1 v from 3-4
  const float ll = __shfl_sync(kAll, lx, a);
  const float lr = __shfl_sync(kAll, lx, a + 1);
  const float dq = piv::gauss3(lcm, ll, lr);
  if (lane == 0)
    u[n] = piv::nan_to_num(__fsub_rn(__fadd_rn((float)(m % k), dq), (float)(k / 2)));
  if (lane == 1)
    v[n] = piv::nan_to_num(__fsub_rn(__fadd_rn((float)(m / d), dq), (float)(d / 2)));
  if (invalid == nullptr) return;

  // second walk
  const float cm = __shfl_sync(kAll, x, 0);
  const Exclusion e(m, k, vw);
  float c2 = -INFINITY;
  if (MAXC == 1) {
    c2 = second_chunk<CH>(cur, 0, lane, e, c2);
  } else {
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < nc) {
        if (e.band_hi < j * kChunk || e.band_lo >= (j + 1) * kChunk) {
          c2 = fmaxf(c2, cmax[j]);
        } else {  // meets the band: read back
          if (j + 1 == nc && ragged) load_chunk<CH, true>(src, j * kChunk, lane, kd, cur);
          else load_chunk<CH, false>(src, j * kChunk, lane, kd, cur);
          c2 = second_chunk<CH>(cur, j * CH, lane, e, c2);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c2 = fmaxf(c2, __shfl_xor_sync(kAll, c2, o));
  // an excluded sample counts as 0 (the plain version's clamp, NaN kept)
  c2 = max_nan(shifted(c2, mn, min_subtract), 0.0f);
  if (lane == 0)
    invalid[n] = (__fdiv_rn(cm, c2) < val_ratio || nb.degenerate(kd)) ? 1 : 0;
}

__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSM)
peakfit_block_kernel(const float* __restrict__ corr, float* __restrict__ u,
                     float* __restrict__ v, unsigned char* __restrict__ invalid,
                     int d, int k, int vw, float val_ratio, int min_subtract) {
  extern __shared__ float x[];
  __shared__ piv::FitScratch scratch;
  const int kd = d * k;
  const int64_t n = blockIdx.x;
  const float* src = corr + n * kd;

  // stage the map, minimum
  float mn = INFINITY;
  for (int p = threadIdx.x; p < kd; p += blockDim.x) {
    const float c = src[p];
    x[p] = c;
    mn = fminf(mn, c);
  }
  piv::fit_map(x, mn, d, k, vw, val_ratio, min_subtract, scratch, u + n, v + n,
               invalid == nullptr ? nullptr : invalid + n);
}

constexpr int kMaxWarpD = 128;  // larger maps take the block kernel

// `return fn<CH, MAXC>(...)` for the warp kernel's instance that serves d x d
// maps (d <= kMaxWarpD): CH the least power of two with 32*CH >= d*d up to
// d = 32, then chunks.  Timed on an H100 (tools/peakfit_anatomy_cuda.py,
// PERF.md §6): 32^2 in registers 0.112 ms a launch at pass 2, in 4 chunks
// of 8 slots 0.123; 64^2 in 16 chunks of 8 0.119 at pass 1, in 8 of 16
// alike (and it spills), in 32 of 4 0.169.
#define PIV_FOR_MAP(d, fn, ...)                              \
  do {                                                       \
    if ((d) <= 5) return fn<1, 1>(__VA_ARGS__);              \
    if ((d) <= 8) return fn<2, 1>(__VA_ARGS__);              \
    if ((d) <= 11) return fn<4, 1>(__VA_ARGS__);             \
    if ((d) <= 16) return fn<8, 1>(__VA_ARGS__);             \
    if ((d) <= 22) return fn<16, 1>(__VA_ARGS__);            \
    if ((d) <= 32) return fn<32, 1>(__VA_ARGS__);            \
    if ((d) <= 64) return fn<8, 16>(__VA_ARGS__);            \
    if ((d) <= 128) return fn<16, 32>(__VA_ARGS__);          \
    return (int)cudaErrorInvalidValue;                       \
  } while (0)

template <int CH, int MAXC>
int launch_warp(const float* corr, float* u, float* v, unsigned char* invalid,
                int N, int d, int vw, float val_ratio, int min_subtract,
                cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  peakfit_warp_kernel<CH, MAXC><<<blocks, kThreads, 0, stream>>>(
      corr, u, v, invalid, N, d, vw, val_ratio, min_subtract);
  return (int)cudaGetLastError();
}

template <class Kernel>
int fill_describe(Kernel kernel, int threads, int maps, int dynamic_smem, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes + dynamic_smem;
  out[3] = threads;
  out[4] = maps;
  return 0;
}

template <int CH, int MAXC>
int describe_warp(int* out) {
  return fill_describe(peakfit_warp_kernel<CH, MAXC>, kThreads, kWarps, 0, out);
}

}  // namespace

extern "C" {

// corr: [N, d, k] f32 (d == k); u, v: [N] f32; invalid: [N] bytes (0/1), or
// null to skip the validation.  Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success).
int peakfit_f32(const float* corr, float* u, float* v, unsigned char* invalid,
                int N, int d, int k, int vw, float val_ratio,
                int min_subtract, void* stream) {
  if (d != k || d < 1) return (int)cudaErrorInvalidValue;
  if (d <= kMaxWarpD)
    PIV_FOR_MAP(d, launch_warp, corr, u, v, invalid, N, d, vw, val_ratio,
                min_subtract, (cudaStream_t)stream);
  const size_t smem = (size_t)d * k * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        peakfit_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  peakfit_block_kernel<<<N, kBlockThreads, smem, (cudaStream_t)stream>>>(
      corr, u, v, invalid, d, k, vw, val_ratio, min_subtract);
  return (int)cudaGetLastError();
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills and
// stack), bytes of shared memory a block, threads a block, maps a block of
// the instance that serves d x d maps.  Returns a CUDA error code, 0 on
// success.
int peakfit_describe(int d, int* out) {
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (d <= kMaxWarpD) PIV_FOR_MAP(d, describe_warp, out);
  return fill_describe(peakfit_block_kernel, kBlockThreads, 1,
                       d * d * (int)sizeof(float), out);
}

const char* peakfit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
