// PNG chunk walk, unfiltering, sample conversion and bilinear resize for the
// port's batch image decoder (thermal3d_torch/native/__init__.py). Host
// code: it runs on the CPU and is built with the host compiler, not nvcc.
//
// Counterpart of the JAX package's libpng-based loader (thermal3d/native/
// loader.cpp), for machines without libpng, cv2 or PIL. t3d_png_scan walks
// a file's chunks and checks their CRCs; Python inflates the IDAT stream
// with the stdlib zlib; t3d_png_decode takes the inflated rows (one filter
// byte, then the packed samples, per row) and does the rest in one call per
// image. Both run without Python's GIL (ctypes releases it), so the thread
// that launches the card's work is interrupted as little as possible:
//   * undo the five filter types (None, Sub, Up, Average, Paeth) in a copy;
//   * expand samples as that loader's libpng transforms do: palette -> RGB,
//     gray of 1/2/4 bits -> 8 bits (scaled to 0..255), alpha stripped,
//     16-bit samples read big-endian into raw counts;
//   * MODE_RAW: write the samples as float32 [h, w, c] (c = 1 or 3);
//     MODE_THERMAL: the plain mean of the colour channels, the half-pixel
//     bilinear resize, then the scale, into float32 [out_h, out_w];
//     MODE_RGB: gray repeated to three channels, resize, scale, into
//     float32 [out_h, out_w, 3].
// The resize is loader.cpp's expression, statement for statement, and the
// library is built with the same compiler flags, so that a decoded batch is
// bit-equal to that loader's.
//
// Build: g++ -O3 -march=native -shared -fPIC png_decode.cpp -o libpng_decode.so

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Mode { MODE_RAW = 0, MODE_THERMAL = 1, MODE_RGB = 2 };

enum Status {
  OK = 0,
  BAD_FILTER = 1,
  BAD_FORMAT = 2,
};

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// rows: h rows of (1 + stride) bytes, unfiltered in place. bpp: bytes per
// complete pixel, at least 1 (the filters' left neighbour distance).
bool unfilter(uint8_t* rows, int h, size_t stride, size_t bpp) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = rows + static_cast<size_t>(y) * (stride + 1);
    const int type = row[0];
    uint8_t* cur = row + 1;
    switch (type) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (prev != nullptr)
          for (size_t i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(cur[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev != nullptr ? prev[i] : 0;
          const int c = (prev != nullptr && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(cur[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

// Sample `index` of an unfiltered row at bit depth `depth` (1, 2, 4, 8, 16).
inline int sample(const uint8_t* row, size_t index, int depth) {
  if (depth == 16) return (row[2 * index] << 8) | row[2 * index + 1];
  if (depth == 8) return row[index];
  const size_t bit = index * depth;
  const int shift = 8 - depth - static_cast<int>(bit % 8);
  return (row[bit / 8] >> shift) & ((1 << depth) - 1);
}

// Half-pixel-center bilinear resize, as thermal3d/native/loader.cpp writes it.
void resize_bilinear(const float* src, int sh, int sw, int c, float* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) { y0 = 0; y1 = 0; wy = 0.f; }
    if (y1 >= sh) { y1 = sh - 1; if (y0 >= sh) y0 = sh - 1; }
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) { x0 = 0; x1 = 0; wx = 0.f; }
      if (x1 >= sw) { x1 = sw - 1; if (x0 >= sw) x0 = sw - 1; }
      for (int ch = 0; ch < c; ++ch) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * c + ch];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * c + ch];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * c + ch];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * c + ch];
        dst[(static_cast<size_t>(y) * dw + x) * c + ch] =
            (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11);
      }
    }
  }
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

extern "C" {

// Walk a PNG file's chunks in memory (after the 8-byte signature, which the
// caller checks) and check their CRCs, as libpng does: a bad CRC fails a
// critical chunk (NOT_PNG) and drops an ancillary one; the walk stops at
// IEND or where the file ends inside a chunk. Writes header[7] (width,
// height, bit depth, colour type, compression, filter, interlace), the
// PLTE's offset and length into plte[2], and up to max_idat (offset, length)
// pairs of IDAT data into idat; returns the number of IDAT chunks (more than
// max_idat means the caller must ask again with room for all), or -1.
int t3d_png_scan(const uint8_t* data, long long len, long long* header, long long* plte,
                 long long* idat, int max_idat) {
  long long pos = 8;
  bool have_header = false;
  int n_idat = 0;
  plte[0] = plte[1] = 0;
  while (pos + 12 <= len) {
    const long long length = be32(data + pos);
    const uint8_t* kind = data + pos + 4;
    const long long end = pos + 8 + length;
    if (end + 4 > len) break;  // truncated inside this chunk
    const bool critical = kind[0] >= 'A' && kind[0] <= 'Z';
    const bool crc_ok = crc32(kind, static_cast<size_t>(length) + 4) == be32(data + end);
    const long long body = pos + 8;
    pos = end + 4;
    if (!crc_ok) {
      if (critical) return -1;
      continue;
    }
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (length != 13) return -1;
      const uint8_t* h = data + body;
      header[0] = be32(h);
      header[1] = be32(h + 4);
      for (int i = 0; i < 5; ++i) header[2 + i] = h[8 + i];
      have_header = true;
    } else if (!have_header) {
      return -1;  // IHDR must come first
    } else if (std::memcmp(kind, "PLTE", 4) == 0) {
      plte[0] = body;
      plte[1] = length;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      if (n_idat < max_idat) {
        idat[2 * n_idat] = body;
        idat[2 * n_idat + 1] = length;
      }
      ++n_idat;
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      return -1;  // a critical chunk this decoder does not know
    }
  }
  return have_header ? n_idat : -1;
}

// Samples per pixel in the file for a PNG colour type (0 if unknown), and
// channels after this decoder's expansion (palette -> 3, alpha stripped).
int t3d_png_channels_in(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

int t3d_png_channels_out(int color_type) {
  return (color_type == 2 || color_type == 3 || color_type == 6) ? 3 : 1;
}

// rows: the inflated IDAT stream, at least h * (1 + stride) bytes, where
// stride = ceil(w * channels_in * bit_depth / 8); unfiltered in a copy.
// palette: n_palette RGB triplets (indices past it read as black).
// MODE_RAW writes out[h, w, channels_out] and ignores out_h/out_w/scale;
// the other modes write out[out_h, out_w(, 3)] = resized * scale, where the
// caller passes the scale (1, 1/255 or 1/65535 as float32).
// Returns OK, BAD_FILTER (an unknown filter type) or BAD_FORMAT.
int t3d_png_decode(const uint8_t* inflated, int w, int h, int bit_depth, int color_type,
                   const uint8_t* palette, int n_palette, int mode, int out_h,
                   int out_w, float scale, float* out) {
  const int cin = t3d_png_channels_in(color_type);
  if (cin == 0 || w <= 0 || h <= 0) return BAD_FORMAT;
  if (bit_depth != 1 && bit_depth != 2 && bit_depth != 4 && bit_depth != 8 && bit_depth != 16)
    return BAD_FORMAT;
  if (bit_depth < 8 && cin != 1) return BAD_FORMAT;
  const size_t stride = (static_cast<size_t>(w) * cin * bit_depth + 7) / 8;
  const size_t bpp = bit_depth < 8 ? 1 : static_cast<size_t>(cin) * bit_depth / 8;
  std::vector<uint8_t> filtered(inflated, inflated + static_cast<size_t>(h) * (stride + 1));
  uint8_t* rows = filtered.data();
  if (!unfilter(rows, h, stride, bpp)) return BAD_FILTER;

  const int cout = t3d_png_channels_out(color_type);
  const size_t n_px = static_cast<size_t>(h) * w;
  std::vector<float> expanded;
  float* img = out;  // MODE_RAW expands straight into the output
  if (mode != MODE_RAW) {
    expanded.resize(n_px * cout);
    img = expanded.data();
  }
  const int gray_mul = bit_depth < 8 ? 255 / ((1 << bit_depth) - 1) : 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rows + static_cast<size_t>(y) * (stride + 1) + 1;
    float* dst = img + static_cast<size_t>(y) * w * cout;
    for (int x = 0; x < w; ++x) {
      if (color_type == 3) {
        const int idx = sample(row, x, bit_depth);
        for (int ch = 0; ch < 3; ++ch)
          dst[static_cast<size_t>(x) * 3 + ch] =
              idx < n_palette ? static_cast<float>(palette[3 * idx + ch]) : 0.f;
      } else {
        for (int ch = 0; ch < cout; ++ch)
          dst[static_cast<size_t>(x) * cout + ch] = static_cast<float>(
              sample(row, static_cast<size_t>(x) * cin + ch, bit_depth) * gray_mul);
      }
    }
  }
  if (mode == MODE_RAW) return OK;
  if (out_h <= 0 || out_w <= 0) return BAD_FORMAT;

  if (mode == MODE_THERMAL) {
    std::vector<float> gray;
    const float* plane = expanded.data();
    if (cout > 1) {
      gray.resize(n_px);
      for (size_t p = 0; p < gray.size(); ++p) {
        float s = 0.f;
        for (int ch = 0; ch < cout; ++ch) s += expanded[p * cout + ch];
        gray[p] = s / cout;
      }
      plane = gray.data();
    }
    std::vector<float> resized(static_cast<size_t>(out_h) * out_w);
    resize_bilinear(plane, h, w, 1, resized.data(), out_h, out_w);
    for (size_t p = 0; p < resized.size(); ++p) out[p] = resized[p] * scale;
    return OK;
  }
  if (mode == MODE_RGB) {
    std::vector<float> rgb;
    const float* src = expanded.data();
    if (cout == 1) {
      rgb.resize(n_px * 3);
      for (size_t p = 0; p < n_px; ++p) rgb[p * 3] = rgb[p * 3 + 1] = rgb[p * 3 + 2] = expanded[p];
      src = rgb.data();
    }
    std::vector<float> resized(static_cast<size_t>(out_h) * out_w * 3);
    resize_bilinear(src, h, w, 3, resized.data(), out_h, out_w);
    for (size_t p = 0; p < resized.size(); ++p) out[p] = resized[p] * scale;
    return OK;
  }
  return BAD_FORMAT;
}

}  // extern "C"
