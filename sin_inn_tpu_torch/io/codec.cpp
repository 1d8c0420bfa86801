// Host loops of the port's image codecs (io/png.py, io/gif.py): the PNG row
// unfilter and the GIF LZW encoder. Built with g++ on first use by
// io/codec.py and called through ctypes; host code, not a kernel. Both loops
// are sequential along a row (Avg and Paeth read the byte just decoded; LZW
// walks its dictionary pixel by pixel), which numpy cannot vectorise.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <type_traits>
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

// ---------------------------------------------------------------------------
// Resize (io/resize.py): OpenCV's separable resize, reproduced bit for bit
// from what the cv2 wheel returns. The tables (first source tap of each
// output column / row and its coefficients) come from io/resize.py, so both
// routes share them; here are the passes. Build with -ffp-contract=off: a
// fused multiply-add would round differently.

namespace {

// A pool of up to 7 threads started on first use (starting threads costs
// more than a frame's pass) plus the caller; one job at a time.
class Pool {
 public:
  static Pool& get() {
    static Pool* pool = new Pool();  // never destroyed: its threads wait
    return *pool;
  }
  int parts() const { return static_cast<int>(threads_.size()) + 1; }

  void run(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    std::lock_guard<std::mutex> one(call_);
    Job job{&fn, n, parts()};
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = &job;
      ++gen_;
    }
    wake_.notify_all();
    drain(&job);
    std::unique_lock<std::mutex> lk(mu_);
    job_ = nullptr;
    done_.wait(lk, [&] { return job.left == 0 && job.users == 0; });
  }

 private:
  struct Job {
    const std::function<void(int64_t, int64_t)>* fn;
    int64_t n;
    int parts;
    std::atomic<int> next{0};
    int left;  // parts not yet finished, under mu_
    int users = 0;  // pool threads inside drain(), under mu_
    Job(const std::function<void(int64_t, int64_t)>* f, int64_t n_, int p)
        : fn(f), n(n_), parts(p), left(p) {}
  };

  Pool() {
    const int nt = static_cast<int>(std::min<unsigned>(
        std::max(1u, std::thread::hardware_concurrency()), 8u)) - 1;
    for (int t = 0; t < nt; ++t) threads_.emplace_back([this] { loop(); });
  }

  void loop() {
    uint64_t seen = 0;
    for (;;) {
      Job* job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        wake_.wait(lk, [&] { return gen_ != seen; });
        seen = gen_;
        job = job_;
        if (job == nullptr) continue;
        ++job->users;
      }
      drain(job);
      std::lock_guard<std::mutex> lk(mu_);
      --job->users;
      done_.notify_all();
    }
  }

  void drain(Job* job) {
    for (;;) {
      const int p = job->next.fetch_add(1);
      if (p >= job->parts) return;
      (*job->fn)(job->n * p / job->parts, job->n * (p + 1) / job->parts);
      std::lock_guard<std::mutex> lk(mu_);
      if (--job->left == 0) done_.notify_all();
    }
  }

  std::vector<std::thread> threads_;
  std::mutex call_, mu_;
  std::condition_variable wake_, done_;
  Job* job_ = nullptr;
  uint64_t gen_ = 0;
};

// runs fn(lo, hi) over [0, n), on the pool when the work is large
void parallel_rows(int64_t n, int64_t work,
                   const std::function<void(int64_t, int64_t)>& fn) {
  if (work < (int64_t(1) << 18) || n < 2) {
    fn(0, n);
    return;
  }
  Pool::get().run(n, fn);
}

inline uint8_t sat_u8(int64_t v) {
  return static_cast<uint8_t>(std::min<int64_t>(std::max<int64_t>(v, 0), 255));
}
inline int32_t sat_s16(int32_t v) {
  return std::min(std::max(v, -32768), 32767);
}
inline int clampi(int v, int hi) { return v < 0 ? 0 : (v >= hi ? hi - 1 : v); }
// cvRound: to nearest, ties to even
inline int64_t round_even(double v) { return std::llrint(v); }

// the horizontal pass of every source row some output row reads; KS taps
template <int KS, typename T, typename WT, typename AT, typename MT>
void hpass_k(const T* src, int h, int w, int cn, int dw,
             const std::vector<int64_t>& xi, const AT* xc,
             const std::vector<char>& need, WT* hbuf) {
  const int64_t width = int64_t(dw) * cn;
  parallel_rows(h, int64_t(h) * width * KS, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      if (!need[y]) continue;
      const T* S = src + y * int64_t(w) * cn;
      WT* D = hbuf + y * width;
      for (int dx = 0; dx < dw; ++dx) {
        const AT* a = xc + int64_t(dx) * KS;
        const int64_t* ix = xi.data() + int64_t(dx) * KS;
        for (int c = 0; c < cn; ++c) {
          WT acc = WT(MT(S[ix[0] + c]) * MT(a[0]));
          for (int k = 1; k < KS; ++k)
            acc = acc + WT(MT(S[ix[k] + c]) * MT(a[k]));
          D[dx * cn + c] = acc;
        }
      }
    }
  });
}

template <typename T, typename WT, typename AT, typename MT>
void hpass(const T* src, int h, int w, int cn, int dw, const int32_t* xofs,
           const AT* xc, int ks, const std::vector<char>& need, WT* hbuf) {
  // each tap's clamped source offset, in elements
  std::vector<int64_t> xi(int64_t(dw) * ks);
  for (int dx = 0; dx < dw; ++dx)
    for (int k = 0; k < ks; ++k)
      xi[int64_t(dx) * ks + k] = int64_t(clampi(xofs[dx] + k, w)) * cn;
  switch (ks) {
    case 1: hpass_k<1, T, WT, AT, MT>(src, h, w, cn, dw, xi, xc, need, hbuf); break;
    case 2: hpass_k<2, T, WT, AT, MT>(src, h, w, cn, dw, xi, xc, need, hbuf); break;
    case 4: hpass_k<4, T, WT, AT, MT>(src, h, w, cn, dw, xi, xc, need, hbuf); break;
    default: hpass_k<8, T, WT, AT, MT>(src, h, w, cn, dw, xi, xc, need, hbuf);
  }
}

// the horizontal sums' buffer, kept by each calling thread from one call to
// the next: a video's frames resize at one size, and fresh pages cost more
// than the pass
template <typename WT>
WT* scratch(int64_t n) {
  thread_local std::vector<WT> buf;
  if (int64_t(buf.size()) < n) buf.resize(n);
  return buf.data();
}

std::vector<char> needed_rows(int h, int dh, const int32_t* yofs, int ks) {
  std::vector<char> need(h, 0);
  for (int dy = 0; dy < dh; ++dy)
    for (int k = 0; k < ks; ++k) need[clampi(yofs[dy] + k, h)] = 1;
  return need;
}

}  // namespace

extern "C" {

// uint8 (h, w, cn) -> (dh, dw, cn) in OpenCV's fixed point: int16
// coefficients scaled by 2^11, int32 horizontal sums. vmode picks the
// vertical rounding cv2 applies: 0 the exact integer (sum + 2^21) >> 22;
// 1 the linear route's 16-bit form ((S >> 4) * b >> 16 per tap, then
// (t + 2) >> 2); 2 the cubic route's float form (taps summed from the last,
// rounded to even) on the first `vend` elements of a row, the integer form
// after them.
void resize_sep_u8(const uint8_t* src, int64_t h, int64_t w, int64_t cn,
                   uint8_t* dst, int64_t dh, int64_t dw,
                   const int32_t* xofs, const int16_t* xc,
                   const int32_t* yofs, const int16_t* yc, int64_t ks,
                   int64_t vmode, int64_t vend) {
  const int64_t width = dw * cn;
  std::vector<char> need = needed_rows(h, dh, yofs, ks);
  int32_t* hbuf = scratch<int32_t>(h * width);
  hpass<uint8_t, int32_t, int16_t, int32_t>(src, h, w, cn, dw, xofs, xc, ks,
                                            need, hbuf);
  parallel_rows(dh, dh * width * ks, [&](int64_t lo, int64_t hi) {
    std::vector<const int32_t*> rows(ks);
    for (int64_t dy = lo; dy < hi; ++dy) {
      const int16_t* b = yc + dy * ks;
      for (int k = 0; k < ks; ++k)
        rows[k] = hbuf + clampi(yofs[dy] + k, h) * width;
      uint8_t* D = dst + dy * width;
      int64_t x = 0;
      if (vmode == 1 && ks == 2) {
        const int32_t b0 = b[0], b1 = b[1];
        const int32_t *r0 = rows[0], *r1 = rows[1];
        for (; x < width; ++x) {
          const int32_t t = sat_s16(((sat_s16(r0[x] >> 4) * b0) >> 16) +
                                    ((sat_s16(r1[x] >> 4) * b1) >> 16));
          D[x] = static_cast<uint8_t>(
              std::min(std::max(sat_s16(t + 2) >> 2, 0), 255));
        }
      } else if (vmode == 1) {
        for (; x < width; ++x) {
          int32_t t = 0;
          for (int k = 0; k < ks; ++k)
            t = sat_s16(t + ((sat_s16(rows[k][x] >> 4) * int32_t(b[k])) >> 16));
          D[x] = sat_u8(sat_s16(t + 2) >> 2);
        }
      } else if (vmode == 2) {
        float bf[8];
        for (int k = 0; k < ks; ++k)
          bf[k] = float(b[k]) * (1.0f / float(1 << 22));
        for (; x < vend; ++x) {
          float t = float(rows[ks - 1][x]) * bf[ks - 1];
          for (int k = int(ks) - 2; k >= 0; --k)
            t = float(rows[k][x]) * bf[k] + t;
          D[x] = sat_u8(sat_s16(int32_t(round_even(t))));
        }
      }
      for (; x < width; ++x) {
        int64_t acc = 0;
        for (int k = 0; k < ks; ++k) acc += int64_t(rows[k][x]) * b[k];
        D[x] = sat_u8((acc + (1 << 21)) >> 22);
      }
    }
  });
}

// float32 / float64 (h, w, cn) -> (dh, dw, cn), float coefficients, the
// sums in the source's type, tap by tap from the first; the first `vend`
// elements of an output row sum their rows from the last (cv2's four-lane
// float32 cubic and Lanczos route).
#define RESIZE_SEP_FLOAT(NAME, T)                                            \
  void NAME(const T* src, int64_t h, int64_t w, int64_t cn, T* dst,          \
            int64_t dh, int64_t dw, const int32_t* xofs, const float* xc,    \
            const int32_t* yofs, const float* yc, int64_t ks, int64_t vend) {\
    const int64_t width = dw * cn;                                           \
    std::vector<char> need = needed_rows(h, dh, yofs, ks);                   \
    T* hbuf = scratch<T>(h * width);                                         \
    hpass<T, T, float, T>(src, h, w, cn, dw, xofs, xc, ks, need, hbuf);      \
    parallel_rows(dh, dh * width * ks, [&](int64_t lo, int64_t hi) {         \
      std::vector<const T*> rows(ks);                                        \
      for (int64_t dy = lo; dy < hi; ++dy) {                                 \
        const float* b = yc + dy * ks;                                       \
        for (int k = 0; k < ks; ++k)                                         \
          rows[k] = hbuf + clampi(yofs[dy] + k, h) * width;                  \
        T* D = dst + dy * width;                                             \
        int64_t x = 0;                                                       \
        for (; x < vend; ++x) {                                              \
          T acc = rows[ks - 1][x] * T(b[ks - 1]);                            \
          for (int k = int(ks) - 2; k >= 0; --k)                             \
            acc = rows[k][x] * T(b[k]) + acc;                                \
          D[x] = acc;                                                        \
        }                                                                    \
        for (; x < width; ++x) {                                             \
          T acc = rows[0][x] * T(b[0]);                                      \
          for (int k = 1; k < ks; ++k) acc = acc + rows[k][x] * T(b[k]);     \
          D[x] = acc;                                                        \
        }                                                                    \
      }                                                                      \
    });                                                                      \
  }
RESIZE_SEP_FLOAT(resize_sep_f32, float)
RESIZE_SEP_FLOAT(resize_sep_f64, double)
#undef RESIZE_SEP_FLOAT

}  // extern "C"

namespace {

// OpenCV's INTER_AREA at a whole ratio (sx x sy source pixels a pixel).
// WT is the sum's type (int for uint8); a block the source's edge cuts is
// averaged over the pixels it holds, in float, as cv2 does.
template <typename T, typename WT>
void area_fast(const T* src, int64_t h, int64_t w, int64_t cn, T* dst,
               int64_t dh, int64_t dw, int sx, int sy) {
  const int area = sx * sy;
  const float scale = 1.f / float(area);
  const int64_t full_w = (w / sx) * cn, width = dw * cn, row = w * cn;
  // cv2's 2x2 routes: uint8 (+2) >> 2 at 1, 3 and 4 channels; float32 adds
  // the pairs of each row first at 1 and 4 channels, four lanes at a time
  const bool u8_fast = std::is_same<T, uint8_t>::value && sx == 2 &&
                       sy == 2 && (cn == 1 || cn == 3 || cn == 4);
  const bool f32_fast = std::is_same<T, float>::value && sx == 2 &&
                        sy == 2 && (cn == 1 || cn == 4);
  parallel_rows(dh, dh * width * area, [&](int64_t lo, int64_t hi) {
    for (int64_t dy = lo; dy < hi; ++dy) {
      T* D = dst + dy * width;
      const int64_t sy0 = dy * sy;
      const int64_t wfull = sy0 + sy <= h ? full_w : 0;
      const T* S = src + sy0 * row;
      int64_t dx = 0;
      if (u8_fast) {
        for (int64_t px = 0; px * cn < wfull; ++px)
          for (int64_t c = 0; c < cn; ++c) {
            const int64_t i = px * 2 * cn + c;
            const int v = int(S[i]) + int(S[i + cn]) + int(S[i + row]) +
                          int(S[i + row + cn]);
            D[px * cn + c] = static_cast<T>((v + 2) >> 2);
          }
        dx = wfull;
      } else if (f32_fast) {
        for (const int64_t n4 = wfull / 4 * 4; dx < n4; ++dx) {
          const int64_t i = (dx / cn) * 2 * cn + dx % cn;
          D[dx] = static_cast<T>(((S[i] + S[i + cn]) +
                                  (S[i + row] + S[i + row + cn])) * 0.25f);
        }
      }
      for (; dx < wfull; ++dx) {
        const int64_t base = (dx / cn) * sx * cn + dx % cn;
        WT sum = 0;
        int k = 0;
        for (; k <= area - 4; k += 4) {
          WT v[4];
          for (int j = 0; j < 4; ++j) {
            const int kk = k + j;
            v[j] = S[base + (kk / sx) * row + (kk % sx) * cn];
          }
          sum += v[0] + v[1] + v[2] + v[3];
        }
        for (; k < area; ++k)
          sum += S[base + (k / sx) * row + (k % sx) * cn];
        if (std::is_same<T, uint8_t>::value)
          D[dx] = static_cast<T>(sat_u8(round_even(float(sum) * scale)));
        else
          D[dx] = static_cast<T>(sum * scale);
      }
      for (; dx < width; ++dx) {
        const int64_t sx0 = (dx / cn) * sx * cn + dx % cn;
        WT sum = 0;
        int count = 0;
        for (int j = 0; j < sy && sy0 + j < h; ++j)
          for (int i = 0; i < sx * cn && sx0 + i < row; i += int(cn)) {
            sum += src[(sy0 + j) * row + sx0 + i];
            ++count;
          }
        const float v = count ? float(sum) / float(count) : 0.f;
        if (std::is_same<T, uint8_t>::value)
          D[dx] = static_cast<T>(sat_u8(round_even(v)));
        else
          D[dx] = static_cast<T>(v);
      }
    }
  });
}

// OpenCV's INTER_AREA at any other shrinking ratio: (dst index, src index,
// weight) tables along x and y; WT float for uint8 and float32, double for
// float64. Each output row sums its source rows' weighted x-sums.
template <typename T, typename WT>
void area_general(const T* src, int64_t h, int64_t w, int64_t cn, T* dst,
                  int64_t dh, int64_t dw, const int32_t* xdi,
                  const int32_t* xsi, const float* xa, int64_t nx,
                  const int32_t* ydi, const int32_t* ysi, const float* ya,
                  int64_t ny) {
  const int64_t width = dw * cn, row = w * cn;
  std::vector<int64_t> first(dh + 1, ny);
  for (int64_t j = ny - 1; j >= 0; --j) first[ydi[j]] = j;
  parallel_rows(dh, ny * width, [&](int64_t lo, int64_t hi) {
    std::vector<WT> buf(width), sum(width);
    for (int64_t dy = lo; dy < hi; ++dy) {
      std::fill(sum.begin(), sum.end(), WT(0));
      for (int64_t j = first[dy]; j < ny && ydi[j] == dy; ++j) {
        const T* S = src + int64_t(ysi[j]) * row;
        std::fill(buf.begin(), buf.end(), WT(0));
        for (int64_t k = 0; k < nx; ++k) {
          const int64_t d = int64_t(xdi[k]) * cn, s = int64_t(xsi[k]) * cn;
          const WT a = WT(xa[k]);
          for (int64_t c = 0; c < cn; ++c)
            buf[d + c] = buf[d + c] + WT(S[s + c]) * a;
        }
        const WT beta = WT(ya[j]);
        for (int64_t x = 0; x < width; ++x) sum[x] = sum[x] + beta * buf[x];
      }
      T* D = dst + dy * width;
      for (int64_t x = 0; x < width; ++x) {
        if (std::is_same<T, uint8_t>::value)
          D[x] = static_cast<T>(sat_u8(round_even(sum[x])));
        else
          D[x] = static_cast<T>(sum[x]);
      }
    }
  });
}

}  // namespace

extern "C" {

void resize_area_fast_u8(const uint8_t* s, int64_t h, int64_t w, int64_t cn,
                         uint8_t* d, int64_t dh, int64_t dw, int64_t sx,
                         int64_t sy) {
  area_fast<uint8_t, int>(s, h, w, cn, d, dh, dw, int(sx), int(sy));
}
void resize_area_fast_f32(const float* s, int64_t h, int64_t w, int64_t cn,
                          float* d, int64_t dh, int64_t dw, int64_t sx,
                          int64_t sy) {
  area_fast<float, float>(s, h, w, cn, d, dh, dw, int(sx), int(sy));
}
void resize_area_fast_f64(const double* s, int64_t h, int64_t w, int64_t cn,
                          double* d, int64_t dh, int64_t dw, int64_t sx,
                          int64_t sy) {
  area_fast<double, double>(s, h, w, cn, d, dh, dw, int(sx), int(sy));
}

#define RESIZE_AREA(NAME, T, WT)                                             \
  void NAME(const T* s, int64_t h, int64_t w, int64_t cn, T* d, int64_t dh,  \
            int64_t dw, const int32_t* xdi, const int32_t* xsi,             \
            const float* xa, int64_t nx, const int32_t* ydi,                 \
            const int32_t* ysi, const float* ya, int64_t ny) {               \
    area_general<T, WT>(s, h, w, cn, d, dh, dw, xdi, xsi, xa, nx, ydi, ysi,  \
                        ya, ny);                                             \
  }
RESIZE_AREA(resize_area_u8, uint8_t, float)
RESIZE_AREA(resize_area_f32, float, float)
RESIZE_AREA(resize_area_f64, double, double)
#undef RESIZE_AREA

}  // extern "C"

namespace {

// IPP's float linear, as cv2 takes it for float32 and float64: along x then
// y, each output a + f * (b - a) of its two clamped neighbours.
template <typename T>
void lerp_hv(const T* src, int64_t h, int64_t w, int64_t cn, T* dst,
             int64_t dh, int64_t dw, const int32_t* x0, const int32_t* x1,
             const T* fx, const int32_t* y0, const int32_t* y1, const T* fy) {
  const int64_t width = dw * cn, row = w * cn;
  T* hbuf = scratch<T>(h * width);
  parallel_rows(h, h * width, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      const T* S = src + y * row;
      T* D = hbuf + y * width;
      for (int64_t dx = 0; dx < dw; ++dx)
        for (int64_t c = 0; c < cn; ++c) {
          const T a = S[x0[dx] * cn + c], b = S[x1[dx] * cn + c];
          D[dx * cn + c] = a + fx[dx] * (b - a);
        }
    }
  });
  parallel_rows(dh, dh * width, [&](int64_t lo, int64_t hi) {
    for (int64_t dy = lo; dy < hi; ++dy) {
      const T* A = hbuf + y0[dy] * width;
      const T* B = hbuf + y1[dy] * width;
      const T f = fy[dy];
      T* D = dst + dy * width;
      for (int64_t x = 0; x < width; ++x) D[x] = A[x] + f * (B[x] - A[x]);
    }
  });
}

}  // namespace

extern "C" {

void resize_lerp_f32(const float* s, int64_t h, int64_t w, int64_t cn,
                     float* d, int64_t dh, int64_t dw, const int32_t* x0,
                     const int32_t* x1, const float* fx, const int32_t* y0,
                     const int32_t* y1, const float* fy) {
  lerp_hv<float>(s, h, w, cn, d, dh, dw, x0, x1, fx, y0, y1, fy);
}
void resize_lerp_f64(const double* s, int64_t h, int64_t w, int64_t cn,
                     double* d, int64_t dh, int64_t dw, const int32_t* x0,
                     const int32_t* x1, const double* fx, const int32_t* y0,
                     const int32_t* y1, const double* fy) {
  lerp_hv<double>(s, h, w, cn, d, dh, dw, x0, x1, fx, y0, y1, fy);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG (io/jpeg.py): the entropy decoding of one scan into each component's
// coefficient blocks (baseline, extended and progressive Huffman), and the
// output stage: libjpeg-turbo's accurate integer IDCT ("islow"), its fancy
// (triangle) upsampling and its fixed-point YCbCr -> RGB. io/jpeg.py parses
// the markers and hands the tables over.

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the last coefficient lands here, as libjpeg's
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  // canonical codes: per length, the largest code (-1 where none) and the
  // index of the first value of that length less its first code
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 where the code is longer
  uint16_t look[512];

  // false, with nothing written past the tables, where the codes do not
  // fit their lengths or a DC value passes 15 (io/jpeg.py rejects both first)
  bool build(const uint8_t* bits, const uint8_t* v, bool dc) {
    std::memcpy(vals, v, 256);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      code += bits[l - 1];
      if (code >= (1 << l)) return false;
      code <<= 1;
    }
    for (int i = 0; dc && i < 256; ++i)
      if (vals[i] > 15) return false;
    code = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      const int n = bits[l - 1];
      valoff[l] = k - code;
      maxcode[l] = n ? code + n - 1 : -1;
      for (int i = 0; i < n; ++i, ++code, ++k) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    return true;
  }
};

struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t acc = 0;  // left aligned
  int bits = 0;
  bool at_marker = false, truncated = false;

  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          truncated = true;
          at_marker = true;
        } else if (d[pos] == 0xFF) {
          if (pos + 1 >= n) {
            truncated = true;
            at_marker = true;
          } else if (d[pos + 1] == 0) {
            b = 0xFF;
            pos += 2;
          } else {
            at_marker = true;  // zeros from here, as libjpeg feeds
          }
        } else {
          b = d[pos++];
        }
      }
      acc |= b << (56 - bits);
      bits += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    const int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    bits -= k;
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huff& h) {
    if (bits < 16) fill();
    const int top = static_cast<int>(acc >> 48);
    const int e = h.look[top >> 7];
    if (e) {
      const int l = e >> 8;
      acc <<= l;
      bits -= l;
      return e & 0xff;
    }
    int l = 10;
    while (l <= 16 && (top >> (16 - l)) > h.maxcode[l]) ++l;
    if (l > 16) {  // a corrupt code: libjpeg warns and takes 0
      acc <<= 16;
      bits -= 16;
      return 0;
    }
    acc <<= l;
    bits -= l;
    return h.vals[h.valoff[l] + (top >> (16 - l))];
  }
  // drops the buffered bits; then at a restart marker, consumes it
  void restart() {
    acc = 0;
    bits = 0;
    if (!truncated && pos + 1 < n && d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
        d[pos + 1] <= 0xD7)
      pos += 2;
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return s && v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

// One scan. comps: for each of its ns components (index, h, v, blocks a
// row of its coefficient buffer, rows of blocks it holds, blocks a row and
// rows of blocks it really has, DC table, AC table), 9 ints each; coef: the
// component buffers, 64 int16 a block in natural order; tables: 8 x (16
// code counts + 256 values), DC 0-3 then AC 0-3. Returns the byte offset of
// the marker after the scan, -1 when the data ends inside it, or -2, with
// nothing decoded, for a bad table or scan header.
int64_t jpeg_scan(const uint8_t* data, int64_t len, int64_t pos, int64_t ns,
                  const int32_t* comps, int16_t* const* coef,
                  const uint8_t* tables, int64_t ss, int64_t se, int64_t ah,
                  int64_t al, int64_t restart, int64_t mcux, int64_t mcuy) {
  if (ns < 1 || ns > 4 || ss < 0 || ss > se || se > 63 || ah < 0 || ah > 14 ||
      al < 0 || al > 13)
    return -2;
  for (int c = 0; c < ns; ++c) {
    const int32_t* ci = comps + c * 9;
    if (ci[7] < 0 || ci[7] > 3 || ci[8] < 0 || ci[8] > 3) return -2;
  }
  Huff huff[8];
  for (int t = 0; t < 8; ++t)
    if (!huff[t].build(tables + t * 272, tables + t * 272 + 16, t < 4)) return -2;
  Bits br{data, len, pos};
  int dc_pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  const bool progressive = !(ss == 0 && se == 63 && ah == 0 && al == 0);
  auto block = [&](int c, int16_t* blk) {
    const int32_t* ci = comps + c * 9;
    const Huff& dc = huff[ci[7]];
    const Huff& ac = huff[4 + ci[8]];
    if (!progressive) {
      const int s = br.decode(dc);
      dc_pred[c] += extend(br.get(s), s);
      blk[0] = static_cast<int16_t>(dc_pred[c]);
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(ac);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        const int s = br.decode(dc);
        dc_pred[c] += extend(br.get(s), s);
        blk[0] = static_cast<int16_t>(dc_pred[c] * (1 << al));
      } else if (br.bit()) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = int(ss); k <= se; ++k) {
        const int rs = br.decode(ac);
        const int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s) * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = int(ss);
    auto refine = [&](int16_t* coefp) {
      if (br.bit() && (*coefp & p1) == 0)
        *coefp = static_cast<int16_t>(*coefp >= 0 ? *coefp + p1 : *coefp + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coefp = blk + kZigzag[k];
          if (*coefp != 0) {
            refine(coefp);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coefp = blk + kZigzag[k];
        if (*coefp != 0) refine(coefp);
      }
      --eobrun;
    }
  };
  int64_t todo = restart;
  auto next_unit = [&]() {
    if (restart) {
      if (todo == 0) {
        br.restart();
        std::memset(dc_pred, 0, sizeof(dc_pred));
        eobrun = 0;
        todo = restart;
      }
      --todo;
    }
  };
  if (ns == 1) {
    const int32_t* ci = comps;
    int16_t* base = coef[0];
    for (int by = 0; by < ci[6]; ++by)
      for (int bx = 0; bx < ci[5]; ++bx) {
        next_unit();
        block(0, base + (int64_t(by) * ci[3] + bx) * 64);
        if (br.truncated) return -1;
      }
  } else {
    for (int64_t my = 0; my < mcuy; ++my)
      for (int64_t mx = 0; mx < mcux; ++mx) {
        next_unit();
        for (int c = 0; c < ns; ++c) {
          const int32_t* ci = comps + c * 9;
          for (int v = 0; v < ci[2]; ++v)
            for (int h = 0; h < ci[1]; ++h) {
              const int64_t bx = mx * ci[1] + h, by = my * ci[2] + v;
              block(c, coef[c] + (by * ci[3] + bx) * 64);
            }
        }
        if (br.truncated) return -1;
      }
  }
  // the marker that ends the scan: skip what libjpeg would skip to it
  int64_t p = br.pos;
  while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] != 0 &&
                          !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
    ++p;
  return p + 1 < len ? p : -1;
}

}  // extern "C"

namespace {

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the descaled value masked to 10 bits
inline uint8_t idct_limit(int64_t x) {
  const int i = static_cast<int>(x & 1023);
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

// jpeg_idct_islow of one block (natural order) dequantised by q
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t* wp = ws + c;
    bool ac_zero = true;
    for (int r = 1; r < 8; ++r) ac_zero = ac_zero && ip[8 * r] == 0;
    if (ac_zero) {
      const int64_t dc = int64_t(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                  t12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = descale(t10 + tmp3, n);
    wp[56] = descale(t10 - tmp3, n);
    wp[8] = descale(t11 + tmp2, n);
    wp[48] = descale(t11 - tmp2, n);
    wp[16] = descale(t12 + tmp1, n);
    wp[40] = descale(t12 - tmp1, n);
    wp[24] = descale(t13 + tmp0, n);
    wp[32] = descale(t13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int64_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (wp[0] - wp[4]) * (1 << kConstBits);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2,
                  t12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(t10 + tmp3, n));
    op[7] = idct_limit(descale(t10 - tmp3, n));
    op[1] = idct_limit(descale(t11 + tmp2, n));
    op[6] = idct_limit(descale(t11 - tmp2, n));
    op[2] = idct_limit(descale(t12 + tmp1, n));
    op[5] = idct_limit(descale(t12 - tmp1, n));
    op[3] = idct_limit(descale(t13 + tmp0, n));
    op[4] = idct_limit(descale(t13 - tmp0, n));
  }
}

inline int clamp_index(int64_t i, int64_t n) {
  return static_cast<int>(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

}  // namespace

extern "C" {

// IDCT of every block of one component into its plane (blocks x 8 wide).
void jpeg_idct(const int16_t* coef, const uint16_t* q, int64_t bw, int64_t bh,
               uint8_t* plane) {
  const int64_t stride = bw * 8;
  parallel_rows(bh, bh * bw * 64 * 8, [&](int64_t lo, int64_t hi) {
    for (int64_t by = lo; by < hi; ++by)
      for (int64_t bx = 0; bx < bw; ++bx)
        idct_islow(coef + (by * bw + bx) * 64, q,
                   plane + by * 8 * stride + bx * 8, stride);
  });
}

// One component's plane (its real dw x dh samples at row stride `stride`)
// -> the full (h, w) grid at ratio (rh, rv): libjpeg-turbo's fancy upsampling
// for 2h1v (when dw > 2), 1h2v and 2h2v (when dw > 2), edges replicated,
// else each sample repeated rh x rv times.
void jpeg_upsample(const uint8_t* plane, int64_t stride, int64_t dw,
                   int64_t dh, int64_t rh, int64_t rv, uint8_t* out,
                   int64_t w, int64_t h) {
  auto in = [&](int64_t y, int64_t x) -> int {
    return plane[clamp_index(y, dh) * stride + clamp_index(x, dw)];
  };
  const bool fancy_h2 = rh == 2 && dw > 2 && (rv == 1 || rv == 2);
  const bool fancy_v2 = rh == 1 && rv == 2;
  parallel_rows(h, h * w, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      uint8_t* o = out + y * w;
      if (fancy_h2 && rv == 1) {
        for (int64_t x = 0; x < w; ++x) {
          const int64_t c = x >> 1;
          const int v3 = in(y, c) * 3;
          o[x] = static_cast<uint8_t>(x & 1 ? (v3 + in(y, c + 1) + 2) >> 2
                                            : (v3 + in(y, c - 1) + 1) >> 2);
        }
      } else if (fancy_h2) {
        const int64_t r = y >> 1, nb = y & 1 ? r + 1 : r - 1;
        auto colsum = [&](int64_t c) { return in(r, c) * 3 + in(nb, c); };
        for (int64_t x = 0; x < w; ++x) {
          const int64_t c = x >> 1;
          const int t = colsum(c) * 3;
          o[x] = static_cast<uint8_t>(x & 1 ? (t + colsum(c + 1) + 7) >> 4
                                            : (t + colsum(c - 1) + 8) >> 4);
        }
      } else if (fancy_v2) {
        const int64_t r = y >> 1, nb = y & 1 ? r + 1 : r - 1;
        const int bias = y & 1 ? 2 : 1;
        for (int64_t x = 0; x < w; ++x)
          o[x] = static_cast<uint8_t>((in(r, x) * 3 + in(nb, x) + bias) >> 2);
      } else {
        for (int64_t x = 0; x < w; ++x)
          o[x] = static_cast<uint8_t>(in(y / rv, x / rh));
      }
    }
  });
}

// Full-size Y, Cb, Cr planes -> interleaved RGB with libjpeg's tables.
void jpeg_ycc_rgb(const uint8_t* yp, const uint8_t* cbp, const uint8_t* crp,
                  int64_t n, uint8_t* rgb) {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t half = int64_t(1) << 15;
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((int64_t(1.40200 * 65536 + 0.5) * x + half) >> 16);
    cb_b[i] = static_cast<int>((int64_t(1.77200 * 65536 + 0.5) * x + half) >> 16);
    cr_g[i] = -int64_t(0.71414 * 65536 + 0.5) * x;
    cb_g[i] = -int64_t(0.34414 * 65536 + 0.5) * x + half;
  }
  auto lim = [](int64_t v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  parallel_rows(n, n * 4, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int y = yp[i], cb = cbp[i], cr = crp[i];
      rgb[3 * i] = lim(y + cr_r[cr]);
      rgb[3 * i + 1] = lim(y + ((cb_g[cb] + cr_g[cr]) >> 16));
      rgb[3 * i + 2] = lim(y + cb_b[cb]);
    }
  });
}

}  // extern "C"

extern "C" {

// GIF LZW decode: the code stream `data` (sub-blocks already joined) ->
// up to `npix` palette indices in `out`. Stops at the end code, at the end
// of the data or when `npix` are written; returns how many were written.
// Once the table is full (4096) codes stay 12 bits wide and add nothing,
// until a clear code.
int64_t gif_unlzw(const uint8_t* data, int64_t n, int64_t min_code,
                  uint8_t* out, int64_t npix) {
  const int clear = 1 << min_code, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < clear; ++i) {
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
  }
  int width = static_cast<int>(min_code) + 1, next = eoi + 1, prev = -1;
  uint32_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < npix) {
    while (bits < width && pos < n) {
      acc |= uint32_t(data[pos++]) << bits;
      bits += 8;
    }
    if (bits < width) break;
    const int code = static_cast<int>(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    if (code == clear) {
      width = static_cast<int>(min_code) + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int cur = code, sp = 0;
    if (prev < 0) {
      if (code >= clear) break;  // a stream must start with a literal
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    uint8_t lead;
    if (code < next) {
      lead = first[code];
    } else if (code == next) {  // the string just being defined
      lead = first[prev];
      stack[sp++] = lead;
      cur = prev;
    } else {
      break;  // corrupt: a code not yet defined
    }
    while (cur >= clear) {
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    stack[sp++] = static_cast<uint8_t>(cur);
    while (sp > 0 && written < npix) out[written++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = lead;
      first[next] = first[prev];
      ++next;
      if (next == (1 << width) && width < 12) ++width;
    }
    prev = code;
  }
  return written;
}

}  // extern "C"
