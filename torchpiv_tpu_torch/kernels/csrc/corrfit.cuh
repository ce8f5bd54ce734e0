// Cross-correlation of one window pair in shared memory followed by the
// peak fit, by one group of threads.  Shared by corrfit.cu (windows from
// device memory) and fused_pass.cu (windows shifted inside the block).
//
// The function, for two real W x W windows a and b, W a power of two:
//   corr = fftshift(real(IDFT2(conj(DFT2 a) * DFT2 b)));
//   with dc_normalize (pass 1), corr * W^4 / (sum a * sum b);
//   then the fit of fit.cuh with min_subtract.
//
// How: a and b are the real and imaginary part of one complex array
// z = a + i*b, so ONE complex 2-D transform gives both spectra,
//   A[k] = (Z[k] + conj(Z[-k])) / 2,  B[k] = (Z[k] - conj(Z[-k])) / (2i),
// and the Hermitian product C = conj(A) * B transforms back to the real
// map.  The fftshift is the sign (-1)^(k1+k2) on the product, the inverse's
// 1/W^2 a power of two folded into the same factor.
//
// The transforms keep whole lines in registers.  W = P * L (Plan<W>); a
// thread loads P samples of one line, runs the P-point transform on them
// with every loop unrolled and every index a constant, and stores them
// back where they came from: one trip through shared memory per axis for
// W <= 32 (L = 1), two for W = 64 and 128, where a line is split into L
// interleaved parts,
//   X[k2 + P k1] = sum_n1 W_L^(n1 k1) W_W^(n1 k2) sum_n2 x[L n2 + n1] W_P^(n2 k2),
// first the P-point transforms over n2 with the twiddle W_W^(n1 k2), then
// the L-point ones over n1.  All is in place, so the spectrum lies in
// digit-reversed order along each axis: position L*k2 + k1 holds frequency
// k2 + P*k1 (the natural order for L = 1); the product step addresses
// Z[-k] through that map and the inverse undoes the steps in reverse, so
// no reordering pass is needed.  The complex array is stored as float2 on
// a row pitch of W + 1: neighbouring threads take neighbouring lines, and
// neither the row steps (threads a pitch apart) nor the column steps
// (threads one element apart) meet on a bank.  The exchange between the
// parts of a split line goes through shared memory and not through warp
// shuffles: a shuffle moves 4 bytes a lane where a shared-memory access
// moves 8, and an SM dispatches as many of the one as of the other.
//
// The twiddle factors exp(-2*pi*i*j/W), j < W, are computed on the host in
// float64, rounded once, and passed as a kernel parameter: a factor whose
// index is a constant after unrolling is an operand from the constant bank
// and costs neither a register nor a load.
//
// Windows up to 32 are owned by one warp each (four windows a block of 128
// threads): the warp's steps are separated by warp barriers only and the
// fit reduces with shuffles, so the warps of a block never wait for each
// other.  A window of 64 takes a block of 256 threads, one of 128 a block
// of 512.
//
// Tensor cores (wgmma) and TMA are not the tools here: the work is float32
// butterflies, not a matrix product (a DFT-matrix product in bfloat16 or
// TF32 would break the float32 parity rule), and the tiles start at
// unaligned, per-window clamped origins.
//
// Everything is float32 (no TF32, no bfloat16).  The sums run in another
// order than the plain version's (torch.fft), so the two agree to a
// tolerance, not to the last bit.  `correlate_fit_steps` in
// torchpiv_tpu_torch/ops/corrfit.py walks the same steps with tensor ops.

#pragma once

#include "fit.cuh"

namespace piv {

constexpr int kMaxWind = 128;

// v[j] = (cos, -sin)(2*pi*j/W), j < W.
struct Twiddles {
  float2 v[kMaxWind];
};

// W = P * L: the radix of the step that a thread runs on P strided samples
// and of the one it runs on L neighbouring samples (L = 1: none); THREADS a
// window: 32 means one warp owns the window.
template <int W>
struct Plan;
template <> struct Plan<4> { static constexpr int P = 4, L = 1, THREADS = 32; };
template <> struct Plan<8> { static constexpr int P = 8, L = 1, THREADS = 32; };
template <> struct Plan<16> { static constexpr int P = 16, L = 1, THREADS = 32; };
template <> struct Plan<32> { static constexpr int P = 32, L = 1, THREADS = 32; };
template <> struct Plan<64> { static constexpr int P = 8, L = 8, THREADS = 256; };
template <> struct Plan<128> { static constexpr int P = 16, L = 8, THREADS = 512; };

template <int W>
struct Geometry {
  static constexpr int THREADS = Plan<W>::THREADS;
  static constexpr bool WARP = THREADS == 32;
  static constexpr int BLOCK = WARP ? 128 : THREADS;  // threads a block
  static constexpr int WINDOWS = BLOCK / THREADS;     // windows a block
  static constexpr int PITCH = W + 1;                 // float2 a row of z
  static constexpr int Z_FLOATS = 2 * W * PITCH;      // floats of z a window
};

template <int W, bool WARP = Geometry<W>::WARP>
struct GroupOf {
  using type = BlockGroup;
};
template <int W>
struct GroupOf<W, true> {
  using type = WarpGroup;
};

__host__ __device__ constexpr int bit_reverse(int x, int n) {
  int r = 0;
  for (int b = 1; b < n; b <<= 1) {
    r = (r << 1) | (x & 1);
    x >>= 1;
  }
  return r;
}

__host__ __device__ constexpr int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// x * tw.v[t], or x * conj(tw.v[t]) for the inverse.
template <bool kInverse>
__device__ __forceinline__ float2 twiddled(float2 x, float2 c) {
  const float s = kInverse ? -c.y : c.y;
  return make_float2(x.x * c.x - x.y * s, x.x * s + x.y * c.x);
}

// The N-point transform of x[] in registers by radix-2 decimation in
// frequency: natural order in, x[q] holds frequency bit_reverse(q) on
// return.  The twiddles are tw.v[t * (W / N)].
template <int N, int W, bool kInverse>
__device__ __forceinline__ void fft_registers(float2 (&x)[N], const Twiddles& tw) {
  constexpr int STAGES = log2_of(N);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    const int half = (N / 2) >> s;
#pragma unroll
    for (int b = 0; b < N / 2; ++b) {
      const int j = b & (half - 1);
      const int i0 = ((b - j) << 1) + j;
      const int i1 = i0 + half;
      const int t = j * (N / (2 * half)) * (W / N);  // the factor W_W^t
      const float2 p = x[i0], q = x[i1];
      x[i0] = make_float2(p.x + q.x, p.y + q.y);
      const float2 d = make_float2(p.x - q.x, p.y - q.y);
      if (t == 0) {
        x[i1] = d;
      } else if (4 * t == W) {  // times -i, or +i for the inverse
        x[i1] = kInverse ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
      } else {
        x[i1] = twiddled<kInverse>(d, tw.v[t]);
      }
    }
  }
}

// Where work item (line, sub) of a step of radix R finds its samples: the
// first at the returned address, the others at multiples of item_step; they
// are the positions kStride * j + sub (kStride > 1) or R * sub + j
// (kStride == 1), j < R, of row (kRows) or column `line` of z.
template <int W, int kStride, bool kRows>
constexpr int item_step = kRows ? kStride : kStride * Geometry<W>::PITCH;

template <int W, int R, int kStride, bool kRows>
__device__ __forceinline__ float2* item_base(float2* z, int line, int sub) {
  constexpr int PITCH = Geometry<W>::PITCH;
  const int p0 = kStride == 1 ? R * sub : sub;
  return kRows ? z + line * PITCH + p0 : z + p0 * PITCH + line;
}

// Transform the R samples x[] of a work item and store them from `base` on:
// output k goes to the item's position k, with kTwiddle times W_W^(sub * k)
// (its conjugate for the inverse).
template <int W, int R, int kStep, bool kInverse, bool kTwiddle>
__device__ __forceinline__ void transform_store(float2 (&x)[R], float2* base,
                                                const Twiddles& tw, int sub) {
  fft_registers<R, W, kInverse>(x, tw);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int k = bit_reverse(q, R);
    float2 val = x[q];
    if (kTwiddle && k != 0) val = twiddled<kInverse>(val, tw.v[sub * k]);
    base[k * kStep] = val;
  }
}

// One step of the transform of every row or column of z, in place: per line
// W / R work items of R samples each.  The caller synchronises the group.
template <int W, int R, int kStride, bool kInverse, bool kRows, bool kTwiddle,
          class Group>
__device__ __forceinline__ void fft_step(float2* z, const Twiddles& tw,
                                         const Group& g) {
  constexpr int ITEMS = W * (W / R);
  constexpr int STEP = item_step<W, kStride, kRows>;
  for (int i = g.rank(); i < ITEMS; i += Geometry<W>::THREADS) {
    const int sub = i / W;  // neighbouring threads, neighbouring lines
    float2* base = item_base<W, R, kStride, kRows>(z, i & (W - 1), sub);
    float2 x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = base[j * STEP];
    transform_store<W, R, STEP, kInverse, kTwiddle>(x, base, tw, sub);
  }
}

// The forward transform of every row with the samples taken from
// `load(row, column)` and the result written to z.  `load` may read the
// memory of z: every thread has its samples in registers before any stores.
// Ends synchronised.
template <int W, class Group, class Load>
__device__ __forceinline__ void fft_rows_from(float2* z, const Twiddles& tw,
                                              const Group& g, Load load) {
  constexpr int P = Plan<W>::P, L = Plan<W>::L;
  constexpr int THREADS = Geometry<W>::THREADS;
  constexpr int ITEMS = W * L;
  constexpr int EACH = (ITEMS + THREADS - 1) / THREADS;  // items a thread
  float2 x[EACH][P];
#pragma unroll
  for (int e = 0; e < EACH; ++e) {
    const int i = g.rank() + e * THREADS;
    if (i < ITEMS) {
#pragma unroll
      for (int j = 0; j < P; ++j) x[e][j] = load(i & (W - 1), L * j + i / W);
    }
  }
  g.sync();
#pragma unroll
  for (int e = 0; e < EACH; ++e) {
    const int i = g.rank() + e * THREADS;
    if (i < ITEMS)
      transform_store<W, P, item_step<W, L, true>, false, (L > 1)>(
          x[e], item_base<W, P, L, true>(z, i & (W - 1), i / W), tw, i / W);
  }
  g.sync();
  if constexpr (L > 1) {
    fft_step<W, L, 1, false, true, false>(z, tw, g);
    g.sync();
  }
}

// The transform of every row or column of z, forward (natural order in,
// digit-reversed out) or inverse (digit-reversed in, natural out).  Ends
// synchronised.
template <int W, bool kInverse, bool kRows, class Group>
__device__ __forceinline__ void fft_axis(float2* z, const Twiddles& tw,
                                         const Group& g) {
  constexpr int P = Plan<W>::P, L = Plan<W>::L;
  if (!kInverse) {
    fft_step<W, P, L, false, kRows, (L > 1)>(z, tw, g);
    g.sync();
    if constexpr (L > 1) {
      fft_step<W, L, 1, false, kRows, false>(z, tw, g);
      g.sync();
    }
  } else {
    if constexpr (L > 1) {
      fft_step<W, L, 1, true, kRows, true>(z, tw, g);
      g.sync();
    }
    fft_step<W, P, L, true, kRows, false>(z, tw, g);
    g.sync();
  }
}

// The position along an axis of the frequency opposite to the one stored at
// position p, and the parity of p's frequency.
template <int W>
__device__ __forceinline__ int opposite(int p) {
  constexpr int P = Plan<W>::P, L = Plan<W>::L;
  const int k = (p / L) + P * (p % L);
  const int n = (W - k) & (W - 1);
  return L * (n % P) + n / P;
}

template <int W>
__device__ __forceinline__ int parity(int p) {
  return (p / Plan<W>::L) & 1;  // P is even
}

// Window a is the real and window b the imaginary part of what
// `load(row, column)` returns, which may read the memory of z: room for W
// rows of W float2 on a pitch of W + 1; `map` has room for W * W floats.
// Both are overwritten.  Writes this window pair's u, v and, unless
// `invalid` is null, its validation flag.  Called by every thread of the
// group, which has synchronised since the memory that `load` reads was
// written.
template <int W, class Group, class Load>
__device__ __forceinline__ void correlate_fit(float2* z, float* map,
                                              const Twiddles& tw, int vw,
                                              float val_ratio, int dc_normalize,
                                              const Group& g, float* u, float* v,
                                              unsigned char* invalid, Load load) {
  constexpr int PITCH = Geometry<W>::PITCH;
  constexpr int THREADS = Geometry<W>::THREADS;
  constexpr int N = W * W;
  constexpr int EACH = (N + THREADS - 1) / THREADS;  // samples a thread
  fft_rows_from<W>(z, tw, g, load);
  fft_axis<W, false, false>(z, tw, g);

  // Z[0] = sum(a) + i * sum(b)
  const float2 sums = z[0];

  // C = conj(A) * B on every frequency, from Z[k] and Z[-k]; held in
  // registers until every thread has read its pair
  const float scale = 1.0f / (float)N;
  float2 c[EACH];
#pragma unroll
  for (int e = 0; e < EACH; ++e) {
    const int idx = g.rank() + e * THREADS;
    if (idx < N) {
      const int pr = idx / W, pc = idx & (W - 1);
      const float2 zk = z[pr * PITCH + pc];
      const float2 zn = z[opposite<W>(pr) * PITCH + opposite<W>(pc)];
      const float a_r = 0.5f * (zk.x + zn.x), a_i = 0.5f * (zk.y - zn.y);
      const float b_r = 0.5f * (zk.y + zn.y), b_i = -0.5f * (zk.x - zn.x);
      const float sg = ((parity<W>(pr) + parity<W>(pc)) & 1) ? -scale : scale;
      c[e] = make_float2((a_r * b_r + a_i * b_i) * sg,
                         (a_r * b_i - a_i * b_r) * sg);
    }
  }
  g.sync();
#pragma unroll
  for (int e = 0; e < EACH; ++e) {
    const int idx = g.rank() + e * THREADS;
    if (idx < N) z[(idx / W) * PITCH + (idx & (W - 1))] = c[e];
  }
  g.sync();

  fft_axis<W, true, false>(z, tw, g);
  fft_axis<W, true, true>(z, tw, g);

  // the real parts are the map; scale it (pass 1), take the minimum and
  // lay it out without the pitch for the fit
  float norm = 1.0f;
  if (dc_normalize) {
    const float w2 = (float)N;
    norm = __fdiv_rn(__fmul_rn(w2, w2), __fmul_rn(sums.x, sums.y));
  }
  float mn = INFINITY;
  for (int p = g.rank(); p < N; p += g.size()) {
    float x = z[(p / W) * PITCH + (p & (W - 1))].x;
    if (dc_normalize) x = __fmul_rn(x, norm);
    map[p] = x;
    mn = fminf(mn, x);
  }
  fit_map(g, map, mn, W, W, vw, val_ratio, 1, u, v, invalid);
}

// The table of a window size from the first half, tw[j] = (cos, -sin)
// (2*pi*j/w) for j < w/2: the second half is its negative.
inline Twiddles full_twiddles(const float* half, int w) {
  Twiddles t = {};
  for (int j = 0; j < w / 2; ++j) {
    t.v[j] = make_float2(half[2 * j], half[2 * j + 1]);
    t.v[j + w / 2] = make_float2(-half[2 * j], -half[2 * j + 1]);
  }
  return t;
}

// out[0..4]: registers a thread, bytes of local memory a thread (spills
// and stack), bytes of shared memory a block (static and `dynamic`), threads
// a block and windows a block of `kernel`, the instance for window size W.
template <int W, class Kernel>
int describe_kernel(Kernel kernel, size_t dynamic, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(attr.sharedSizeBytes + dynamic);
  out[3] = Geometry<W>::BLOCK;
  out[4] = Geometry<W>::WINDOWS;
  return 0;
}

}  // namespace piv

// `return fn<w>(...)` for the supported window sizes, else an error code.
#define PIV_FOR_WINDOW(w, fn, ...)                      \
  switch (w) {                                          \
    case 4: return fn<4>(__VA_ARGS__);                  \
    case 8: return fn<8>(__VA_ARGS__);                  \
    case 16: return fn<16>(__VA_ARGS__);                \
    case 32: return fn<32>(__VA_ARGS__);                \
    case 64: return fn<64>(__VA_ARGS__);                \
    case 128: return fn<128>(__VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;         \
  }
