// Host loops of the port's image codecs (io/png.py, io/gif.py): the PNG row
// unfilter and the GIF LZW encoder. Built with g++ on first use by
// io/codec.py and called through ctypes; host code, not a kernel. Both loops
// are sequential along a row (Avg and Paeth read the byte just decoded; LZW
// walks its dictionary pixel by pixel), which numpy cannot vectorise.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  uint32_t acc = 0;
  int bits = 0;
  bool ok = true;

  void put(uint32_t code, int width) {
    acc |= code << bits;
    bits += width;
    while (bits >= 8) {
      if (n >= cap) { ok = false; return; }
      out[n++] = static_cast<uint8_t>(acc & 0xff);
      acc >>= 8;
      bits -= 8;
    }
  }
  void flush() {
    if (bits > 0) {
      if (n >= cap) { ok = false; return; }
      out[n++] = static_cast<uint8_t>(acc & 0xff);
      acc = 0;
      bits = 0;
    }
  }
};

}  // namespace

extern "C" {

// src: rows x (1 + stride) bytes, each row its filter type then the filtered
// bytes; dst: rows x stride reconstructed bytes; bpp: bytes per complete
// pixel (at least 1). Returns -1, or the first row whose filter type is not
// 0-4 (dst is then partly written).
int64_t png_unfilter(const uint8_t* src, int64_t rows, int64_t stride,
                     int64_t bpp, uint8_t* dst) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* s = src + y * (stride + 1) + 1;
    const uint8_t ft = s[-1];
    uint8_t* d = dst + y * stride;
    const uint8_t* p = y > 0 ? d - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(d, s, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = static_cast<uint8_t>(s[i] + (i >= bpp ? d[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          d[i] = static_cast<uint8_t>(s[i] + (p ? p[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = p ? p[i] : 0;
          d[i] = static_cast<uint8_t>(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? d[i - bpp] : 0;
          const int b = p ? p[i] : 0;
          const int c = (p && i >= bpp) ? p[i - bpp] : 0;
          d[i] = static_cast<uint8_t>(s[i] + paeth(a, b, c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

// GIF LZW: the code stream of `idx` (n palette indices, each below
// 1 << min_code) packed least significant bit first into `out`, without the
// sub-block framing. The width grows when the last code assigned reaches
// 1 << width; at code 4095 a clear code restarts the dictionary. Returns the
// bytes written, or -1 when `cap` is too small.
int64_t gif_lzw(const uint8_t* idx, int64_t n, int64_t min_code,
                uint8_t* out, int64_t cap) {
  const uint32_t clear = 1u << min_code, eoi = clear + 1;
  // child[code * 256 + v]: the code of string(code) + v, 0 where absent
  std::vector<uint16_t> child(4096 * 256);
  BitWriter bw{out, cap};
  int width = static_cast<int>(min_code) + 1;
  uint32_t max_code = eoi;
  bw.put(clear, width);
  if (n > 0) {
    uint32_t cur = idx[0];
    for (int64_t i = 1; i < n && bw.ok; ++i) {
      const uint8_t v = idx[i];
      const uint16_t next = child[cur * 256 + v];
      if (next) {
        cur = next;
        continue;
      }
      bw.put(cur, width);
      ++max_code;
      child[cur * 256 + v] = static_cast<uint16_t>(max_code);
      std::memset(&child[max_code * 256], 0, 256 * sizeof(uint16_t));
      if (max_code >= (1u << width)) ++width;
      if (max_code == 4095) {
        bw.put(clear, width);
        std::memset(child.data(), 0, clear * 256 * sizeof(uint16_t));
        width = static_cast<int>(min_code) + 1;
        max_code = eoi;
      }
      cur = v;
    }
    bw.put(cur, width);
  }
  bw.put(eoi, width);
  bw.flush();
  return bw.ok ? bw.n : -1;
}

}  // extern "C"
