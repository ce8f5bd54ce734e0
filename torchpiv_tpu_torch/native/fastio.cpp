// fastio: the native bulk decoder of the PyTorch/CUDA port, a copy of
// torchpiv_tpu/native/fastio.cpp, unchanged in function.  Built by
// torchpiv_tpu_torch/native/loader.py at first use into the port's build
// directory (torchpiv_tpu_torch/_build/), without -march=native: the
// library's name carries the compiler and C library it was built with,
// not the CPU.
//
// fastio — native ingest for the PIV frame stream.
//
// The throughput target (4,000 x 4 MP pairs < 60 s) needs ~0.5 GB/s of
// sustained read+decode; Python-side decoding holds the GIL and caps the
// prefetcher's thread pool.  This library does batched file read + decode
// in C++ threads into a caller-provided contiguous buffer.  Formats:
// 8-bit palette BMP (the reference's camera format), uncompressed
// grayscale TIFF at 8 or 16 bits/sample (the scientific-camera staple)
// and Netpbm PGM (P5) at 8/16 bits;
// 16-bit samples are scaled to 8 bits (>> 8), matching what cv2's
// IMREAD_GRAYSCALE — the reference's decoder (PIVbackend.py:136-137) —
// produces for such files.
// (The reference has no native layer at all — its GPU "native" path is
// torch's kernels; this is the ingest half of the TPU rebuild's runtime.)
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfastio.so fastio.cpp -lpthread
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

inline uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline int32_t rd_i32(const uint8_t* p) { return static_cast<int32_t>(rd_u32(p)); }
inline uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Decode an 8-bit uncompressed BMP with a grayscale palette into out[H*W].
// Returns 0 on success, negative error codes otherwise.
int decode_bmp8_into(const uint8_t* buf, int64_t len, uint8_t* out, int64_t H,
                     int64_t W) {
  if (len < 54 || buf[0] != 'B' || buf[1] != 'M') return -1;
  const uint32_t data_offset = rd_u32(buf + 10);
  const uint32_t dib = rd_u32(buf + 14);
  if (dib < 40) return -2;
  const int32_t width = rd_i32(buf + 18);
  const int32_t height = rd_i32(buf + 22);
  const uint16_t bpp = rd_u16(buf + 28);
  const uint32_t compression = rd_u32(buf + 30);
  if (bpp != 8 || compression != 0 || width <= 0) return -3;
  const int64_t h = height > 0 ? height : -static_cast<int64_t>(height);
  if (width != W || h != H) return -4;
  // palette: must be a gray ramp (identity not required; apply the ramp).
  // Bounds-check against the actual file length first — dib and data_offset
  // are both file-controlled, so comparing them only against each other
  // would allow an out-of-bounds read on a corrupt header.
  if (14 + static_cast<uint64_t>(dib) + 1024 > static_cast<uint64_t>(len) ||
      data_offset > static_cast<uint64_t>(len))
    return -5;
  const uint8_t* pal = buf + 14 + dib;
  if (pal + 1024 > buf + data_offset) return -5;
  uint8_t ramp[256];
  bool identity = true;
  for (int i = 0; i < 256; ++i) {
    const uint8_t b = pal[4 * i], g = pal[4 * i + 1], r = pal[4 * i + 2];
    if (b != g || g != r) return -6;  // not grayscale
    ramp[i] = b;
    identity &= (b == i);
  }
  const int64_t stride = (W + 3) & ~int64_t(3);
  if (data_offset + stride * H > static_cast<uint64_t>(len)) return -7;
  const bool flip = height > 0;  // bottom-up rows
  for (int64_t r = 0; r < H; ++r) {
    const uint8_t* src = buf + data_offset + stride * (flip ? (H - 1 - r) : r);
    uint8_t* dst = out + r * W;
    if (identity) {
      std::memcpy(dst, src, static_cast<size_t>(W));
    } else {
      for (int64_t c = 0; c < W; ++c) dst[c] = ramp[src[c]];
    }
  }
  return 0;
}

// ---- TIFF (uncompressed grayscale, 8/16 bits per sample) -------------

inline uint16_t rd_u16e(const uint8_t* p, bool be) {
  return be ? static_cast<uint16_t>((p[0] << 8) | p[1]) : rd_u16(p);
}
inline uint32_t rd_u32e(const uint8_t* p, bool be) {
  return be ? ((static_cast<uint32_t>(p[0]) << 24) |
               (static_cast<uint32_t>(p[1]) << 16) |
               (static_cast<uint32_t>(p[2]) << 8) | p[3])
            : rd_u32(p);
}

struct TiffInfo {
  int64_t width = 0, height = 0;
  int bps = 8;           // bits per sample (8 or 16)
  int photometric = 1;   // 0 = WhiteIsZero (inverted), 1 = BlackIsZero
  int64_t rows_per_strip = 0;
  std::vector<uint64_t> strip_offsets;
  std::vector<uint64_t> strip_counts;
  bool be = false;
};

// Parse the first IFD.  Returns 0 on success, negative error otherwise.
int tiff_parse(const uint8_t* buf, int64_t len, TiffInfo* ti) {
  if (len < 8) return -1;
  if (buf[0] == 'I' && buf[1] == 'I' && buf[2] == 42 && buf[3] == 0) {
    ti->be = false;
  } else if (buf[0] == 'M' && buf[1] == 'M' && buf[2] == 0 && buf[3] == 42) {
    ti->be = true;
  } else {
    return -1;
  }
  const bool be = ti->be;
  const uint64_t ifd = rd_u32e(buf + 4, be);
  if (ifd + 2 > static_cast<uint64_t>(len)) return -20;
  const uint16_t n_entries = rd_u16e(buf + ifd, be);
  if (ifd + 2 + 12ull * n_entries > static_cast<uint64_t>(len)) return -20;

  int compression = 1, spp = 1;
  auto read_values = [&](const uint8_t* e, std::vector<uint64_t>* vals) -> int {
    const uint16_t type = rd_u16e(e + 2, be);
    const uint32_t count = rd_u32e(e + 4, be);
    const int sz = type == 3 ? 2 : (type == 4 ? 4 : 0);
    if (sz == 0) return -21;  // only SHORT/LONG supported
    const uint64_t total = static_cast<uint64_t>(sz) * count;
    const uint8_t* src = e + 8;
    if (total > 4) {
      const uint64_t off = rd_u32e(e + 8, be);
      if (off + total > static_cast<uint64_t>(len)) return -20;
      src = buf + off;
    }
    vals->resize(count);
    for (uint32_t i = 0; i < count; ++i)
      (*vals)[i] = sz == 2 ? rd_u16e(src + 2 * i, be) : rd_u32e(src + 4 * i, be);
    return 0;
  };

  for (uint16_t i = 0; i < n_entries; ++i) {
    const uint8_t* e = buf + ifd + 2 + 12ull * i;
    const uint16_t tag = rd_u16e(e, be);
    std::vector<uint64_t> v;
    switch (tag) {
      case 256: if (read_values(e, &v) || v.empty()) return -22;
                ti->width = static_cast<int64_t>(v[0]); break;
      case 257: if (read_values(e, &v) || v.empty()) return -22;
                ti->height = static_cast<int64_t>(v[0]); break;
      case 258: if (read_values(e, &v) || v.empty()) return -22;
                ti->bps = static_cast<int>(v[0]); break;
      case 259: if (read_values(e, &v) || v.empty()) return -22;
                compression = static_cast<int>(v[0]); break;
      case 262: if (read_values(e, &v) || v.empty()) return -22;
                ti->photometric = static_cast<int>(v[0]); break;
      case 273: if (read_values(e, &ti->strip_offsets)) return -22; break;
      case 277: if (read_values(e, &v) || v.empty()) return -22;
                spp = static_cast<int>(v[0]); break;
      case 278: if (read_values(e, &v) || v.empty()) return -22;
                ti->rows_per_strip = static_cast<int64_t>(v[0]); break;
      case 279: if (read_values(e, &ti->strip_counts)) return -22; break;
      default: break;
    }
  }
  if (ti->width <= 0 || ti->height <= 0) return -23;
  if (compression != 1 || spp != 1) return -24;  // uncompressed gray only
  if (ti->bps != 8 && ti->bps != 16) return -25;
  if (ti->photometric != 0 && ti->photometric != 1) return -25;
  if (ti->strip_offsets.empty()) return -26;
  if (ti->rows_per_strip <= 0) ti->rows_per_strip = ti->height;
  return 0;
}

int decode_tiff_into(const uint8_t* buf, int64_t len, uint8_t* out, int64_t H,
                     int64_t W) {
  TiffInfo ti;
  const int rc = tiff_parse(buf, len, &ti);
  if (rc != 0) return rc;
  if (ti.width != W || ti.height != H) return -4;
  const int64_t bytes_pp = ti.bps / 8;
  const int64_t row_bytes = W * bytes_pp;
  const bool invert = ti.photometric == 0;
  int64_t row = 0;
  for (size_t s = 0; s < ti.strip_offsets.size() && row < H; ++s) {
    const uint64_t off = ti.strip_offsets[s];
    const int64_t rows = std::min<int64_t>(ti.rows_per_strip, H - row);
    if (off + static_cast<uint64_t>(rows) * row_bytes >
        static_cast<uint64_t>(len))
      return -7;
    const uint8_t* src = buf + off;
    for (int64_t r = 0; r < rows; ++r, ++row) {
      uint8_t* dst = out + row * W;
      if (ti.bps == 8) {
        std::memcpy(dst, src + r * row_bytes, static_cast<size_t>(W));
      } else {
        const uint8_t* sp = src + r * row_bytes;
        if (ti.be) {
          for (int64_t c = 0; c < W; ++c) dst[c] = sp[2 * c];      // MSB
        } else {
          for (int64_t c = 0; c < W; ++c) dst[c] = sp[2 * c + 1];  // MSB
        }
      }
      if (invert) {
        for (int64_t c = 0; c < W; ++c) dst[c] = static_cast<uint8_t>(255 - dst[c]);
      }
    }
  }
  return row == H ? 0 : -7;
}

// --- PGM (Netpbm P5 binary graymap): "P5" <ws/comments> width height
// maxval, one whitespace byte, then raw samples (8-bit, or 16-bit
// BIG-endian per the Netpbm spec when maxval > 255, scaled to 8 via the
// high byte like the 16-bit TIFF path).
struct PgmInfo {
  int64_t width = 0, height = 0, maxval = 0, data_off = 0;
};

int pgm_parse(const uint8_t* buf, int64_t len, PgmInfo* pi) {
  if (len < 10 || buf[0] != 'P' || buf[1] != '5') return -1;
  int64_t pos = 2;
  int64_t vals[3];
  for (int v = 0; v < 3; ++v) {
    // skip whitespace and '#' comment lines
    for (;;) {
      while (pos < len && (buf[pos] == ' ' || buf[pos] == '\t' ||
                           buf[pos] == '\r' || buf[pos] == '\n'))
        ++pos;
      if (pos < len && buf[pos] == '#') {
        while (pos < len && buf[pos] != '\n') ++pos;
        continue;
      }
      break;
    }
    int64_t x = 0, digits = 0;
    while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
      x = x * 10 + (buf[pos] - '0');
      ++pos;
      ++digits;
    }
    if (!digits) return -40;
    vals[v] = x;
  }
  if (pos >= len) return -40;
  ++pos;  // exactly one whitespace byte after maxval
  pi->width = vals[0];
  pi->height = vals[1];
  pi->maxval = vals[2];
  pi->data_off = pos;
  if (pi->width <= 0 || pi->height <= 0 || pi->maxval <= 0 ||
      pi->maxval > 65535)
    return -41;
  return 0;
}

int decode_pgm_into(const uint8_t* buf, int64_t len, uint8_t* out, int64_t H,
                    int64_t W) {
  PgmInfo pi;
  const int rc = pgm_parse(buf, len, &pi);
  if (rc != 0) return rc;
  if (pi.height != H || pi.width != W) return -42;
  const int bytes = pi.maxval > 255 ? 2 : 1;
  if (pi.data_off + H * W * bytes > len) return -43;
  const uint8_t* src = buf + pi.data_off;
  if (bytes == 1) {
    std::memcpy(out, src, static_cast<size_t>(H * W));
  } else {  // 16-bit big-endian: high byte first
    for (int64_t i = 0; i < H * W; ++i) out[i] = src[2 * i];
  }
  return 0;
}

int decode_any_into(const uint8_t* buf, int64_t len, uint8_t* out, int64_t H,
                    int64_t W) {
  if (len >= 2 && buf[0] == 'B' && buf[1] == 'M')
    return decode_bmp8_into(buf, len, out, H, W);
  if (len >= 4 && ((buf[0] == 'I' && buf[1] == 'I') ||
                   (buf[0] == 'M' && buf[1] == 'M')))
    return decode_tiff_into(buf, len, out, H, W);
  if (len >= 2 && buf[0] == 'P' && buf[1] == '5')
    return decode_pgm_into(buf, len, out, H, W);
  return -1;
}

int read_decode_one(const char* path, uint8_t* out, int64_t H, int64_t W,
                    std::vector<uint8_t>& scratch) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    return -11;
  }
  scratch.resize(static_cast<size_t>(size));
  const size_t got = std::fread(scratch.data(), 1, scratch.size(), f);
  std::fclose(f);
  if (got != scratch.size()) return -12;
  return decode_any_into(scratch.data(), static_cast<int64_t>(got), out, H, W);
}

}  // namespace

extern "C" {

// Probe one file: returns 0 if this library can decode it, else error code.
// On success writes height/width to dims[0..1].
int fastio_probe_bmp8(const char* path, int64_t* dims) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  uint8_t hdr[54];
  const size_t got = std::fread(hdr, 1, sizeof(hdr), f);
  if (got >= 4 && ((hdr[0] == 'I' && hdr[1] == 'I') ||
                   (hdr[0] == 'M' && hdr[1] == 'M'))) {
    // TIFF: the IFD can live anywhere, so read the whole file to parse it.
    std::fseek(f, 0, SEEK_END);
    const long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(static_cast<size_t>(size > 0 ? size : 0));
    const size_t rd = std::fread(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    if (rd != buf.size()) return -12;
    TiffInfo ti;
    const int rc = tiff_parse(buf.data(), static_cast<int64_t>(rd), &ti);
    if (rc != 0) return rc;
    dims[0] = ti.height;
    dims[1] = ti.width;
    return 0;
  }
  if (got >= 2 && hdr[0] == 'P' && hdr[1] == '5') {
    // PGM: comments can push the dims arbitrarily far in; parse the file.
    std::fseek(f, 0, SEEK_END);
    const long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(static_cast<size_t>(size > 0 ? size : 0));
    const size_t rd = std::fread(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    if (rd != buf.size()) return -12;
    PgmInfo pi;
    const int rc = pgm_parse(buf.data(), static_cast<int64_t>(rd), &pi);
    if (rc != 0) return rc;
    dims[0] = pi.height;
    dims[1] = pi.width;
    return 0;
  }
  std::fclose(f);
  if (got != sizeof(hdr) || hdr[0] != 'B' || hdr[1] != 'M') return -1;
  const uint16_t bpp = rd_u16(hdr + 28);
  const uint32_t compression = rd_u32(hdr + 30);
  if (bpp != 8 || compression != 0) return -3;
  const int32_t width = rd_i32(hdr + 18);
  const int32_t height = rd_i32(hdr + 22);
  dims[0] = height > 0 ? height : -static_cast<int64_t>(height);
  dims[1] = width;
  return 0;
}

// Batched read+decode: n files -> out[n, H, W] uint8 (caller-allocated),
// status[n] per-file error codes (0 = ok).  Runs on `threads` C++ threads
// with the GIL released by the ctypes caller.
void fastio_read_batch(const char** paths, int64_t n, uint8_t* out, int64_t H,
                       int64_t W, int32_t threads, int32_t* status) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = read_decode_one(paths[i], out + i * H * W, H, W, scratch);
    }
  };
  std::vector<std::thread> pool;
  const int nt = static_cast<int>(threads < n ? threads : n);
  pool.reserve(static_cast<size_t>(nt));
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Formatted table writer — the egress half of the runtime.  Writes an
// optional header line then n_rows lines of n_cols "%.6f" numbers joined
// by `sep` (byte-identical to numpy.savetxt(fmt="%.6f"): glibc printf and
// CPython both produce correctly-rounded shortest-fixed output, pinned by
// tests/test_native.py).  Python-side %-formatting of a 16k-row table
// costs ~50-80 ms holding the GIL — at the engine's ~90 pairs/s that
// would make "Save all text" the pipeline bottleneck; here it is ~ms and
// runs with the GIL released by the ctypes caller.
// Returns 0 ok; 1 open failed; 2 format error; 3 write error.
int fastio_write_table(const char* path, const char* header,
                       const double* data, int64_t n_rows, int64_t n_cols,
                       const char* sep) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const size_t seplen = std::strlen(sep);
  if (header && header[0]) {
    std::fwrite(header, 1, std::strlen(header), f);
    std::fwrite("\n", 1, 1, f);
  }
  // format row chunks on a few threads (snprintf's correctly-rounded
  // dtoa dominates, ~0.7 us/value single-threaded), write in order
  const int64_t kChunk = 4096;
  const int64_t n_chunks = n_rows ? (n_rows + kChunk - 1) / kChunk : 0;
  unsigned hw = std::thread::hardware_concurrency();
  const int nt = static_cast<int>(
      std::min<int64_t>(n_chunks, hw > 4 ? 4 : (hw ? hw : 1)));
  std::vector<std::string> bufs(static_cast<size_t>(n_chunks));
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    char tmp[64];
    for (;;) {
      const int64_t ch = next.fetch_add(1);
      if (ch >= n_chunks || err.load()) return;
      std::string& b = bufs[static_cast<size_t>(ch)];
      const int64_t r0 = ch * kChunk;
      const int64_t r1 = std::min(n_rows, r0 + kChunk);
      b.reserve(static_cast<size_t>((r1 - r0) * n_cols * 14));
      for (int64_t r = r0; r < r1; ++r) {
        for (int64_t c = 0; c < n_cols; ++c) {
          const int m =
              std::snprintf(tmp, sizeof tmp, "%.6f", data[r * n_cols + c]);
          if (m < 0 || m >= static_cast<int>(sizeof tmp)) {
            err.store(2);
            return;
          }
          if (c) b.append(sep, seplen);
          b.append(tmp, static_cast<size_t>(m));
        }
        b.push_back('\n');
      }
    }
  };
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(static_cast<size_t>(nt));
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  if (err.load()) {
    std::fclose(f);
    return err.load();
  }
  for (const auto& b : bufs)
    if (!b.empty()) std::fwrite(b.data(), 1, b.size(), f);
  const int rc = std::ferror(f) ? 3 : 0;
  std::fclose(f);
  return rc;
}

}  // extern "C"
