// Windowed bilinear forward splat (the region scatter), for sm_90a: bitwise
// repeatable sums in fixed point.
//
// Replaces the TPU kernel `_region_kernel` of sin_inn_tpu/ops/pallas/splat.py
// (called by `_splat_region_call`). A source pixel s = (sy, sx) of image b
// with flow f = (fx, fy) has the target t = (sy + fy, sx + fx) and adds
//
//   values[b, sy, sx, c] hat(ty - r) hat(tx - k),  hat(d) = max(1 - |d|, 0)
//
// to each output pixel (r, k) in {floor(ty), floor(ty) + 1} x {floor(tx),
// floor(tx) + 1} that lies in the image, but only if s lies in the source
// window the TPU kernel read for the 128 x 128 output tile (i, j) holding
// (r, k): rows [128 i - dy, 128 i - dy + SH), columns [128 j - dx,
// 128 j - dx + SW), with SH = 8 ceil((128 + 2 dy) / 8) and
// SW = 128 ceil((128 + 2 dx) / 128). So the result equals the TPU kernel's
// for every flow, in or out of the window: a tap the TPU kernel could not
// see is dropped here too.
//
// What bounds it on an H100: bytes. At the flow path's shape (1 x 436 x 1024,
// C = 5: a frame times exp(metric), exp(metric) and ones) one launch must
// read the values (8.93 MB) and the flow (3.57 MB) and write the output
// (8.93 MB): 21.4 MB, 0.0064 ms at 3.35 TB/s. The arithmetic is a few dozen
// FLOP per source pixel.
//
// What the design does about it: the TPU had no fast scatter, so its kernel
// turned each output tile's scatter into one-hot matmuls over the tile's
// whole source window. Hopper has fast atomics in L2, so here one thread
// takes one source pixel (x fastest: the value and flow reads of a warp are
// contiguous), computes its four taps, applies the window rule per tap and
// adds the C weighted values to the output with atomics. Float atomics
// would make the sum's order, and so its last bits, change from run to run
// (the JAX path is deterministic); integer addition is associative, so the
// sums are taken in 64-bit fixed point and any order gives the same bits:
//   1. `max_kernel`: per channel c the largest finite |v_c| (an atomicMax
//      on the bits of a non-negative float, which order does not change
//      either), and the fixed-point accumulators and flags zeroed;
//   2. `splat_kernel`: each contribution v wr wk (fp32, as the plain
//      version forms it) rounded to an integer at the scale 2^q_c and added
//      with a 64-bit integer atomicAdd. One output pixel sums at most
//      SH x SW sources (those of its tile's window), each at most |v| over
//      its four taps (the hats sum to 1), so
//      q_c = 62 - ceil(log2(SH SW max|v_c|)) keeps every partial sum under
//      2^62: no overflow whatever the order. At the path's values (in
//      [0, 1]) and window (SH SW = 256 x 384) q is 45, a resolution of
//      3e-14, far below fp32's own rounding of the result;
//   3. `convert_kernel`: each sum times 2^-q_c, rounded once to fp32.
// A contribution that is not finite (a value that is Inf or NaN) sets a
// flag of its output pixel and channel (+Inf, -Inf, NaN) with an atomicOr,
// and such a pixel gets what an fp32 sum gives: NaN if any NaN or both
// infinities reached it, else the infinity. A source pixel with a value
// that is not finite adds to all four taps as the plain version does (a tap
// outside the image or the window has weight 0 at the clamped index 0, and
// Inf x 0 is NaN there), so the NaN and Inf pixels are the plain version's.
// The scratch (8 bytes a value, 4 a pixel) is the wrapper's; at the path's
// shape its 19.6 MB of accumulators and flags are zeroed and read back: 39
// MB more than the function's own bytes, with the atomics in L2 between.
//
// The local-window form (`sininn_splat_region_local`) replaces the same TPU
// kernel as `_splat_region_call_local` runs it (local=True): each output
// tile's window is shifted by (ox, oy) = -off_out[b, i, j], the rounded
// mean flow of the tile's contributors (ops/offsets.py), and dy, dx are the
// local bounds: a tap (r, k) in tile (i, j) = (r / 128, k / 128) is kept iff
// s lies in rows [128 i - dy + oy, ... + SH) and columns [128 j - dx + ox,
// ... + SW). The window now depends on both coordinates of the tap's tile,
// so the test is made per tap pair (four per pixel), not per axis. Source
// pixels outside the image do not exist here, which stands for the TPU
// kernel's zero padding (`top = loc_dy + cap_y`); the caps only size that
// padding, so this kernel does not take them. Bytes bound it as they bound
// the static form, plus one 8-byte offset read per kept tap pair (the 32
// tiles' 256 B of offsets stay in L1): 21.4 MB at the flow path's shape,
// 0.0064 ms at 3.35 TB/s. It sums in the same fixed point, so it is as
// repeatable as the static form: two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // output tile rows and columns
constexpr int kMaxC = 8;     // channels: 3 flag bits each in a 32-bit word
constexpr long long kMaxGridRows = 65535;   // gridDim.y limit
constexpr int kMaxBlocks = 1024;            // blocks of the max and
                                            // conversion passes

typedef unsigned long long u64;

// Flags of a pixel's word, three bits a channel.
constexpr unsigned kPosInf = 1u, kNegInf = 2u, kNaN = 4u;

__device__ __forceinline__ float hat(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

// Whether source coordinate s lies in the window of the tile holding the
// (in-image, non-negative) target coordinate t.
__device__ __forceinline__ bool in_window(int s, int t, int d, int span) {
  const int lo = t / kTile * kTile - d;
  return s >= lo && s < lo + span;
}

// The scratch a launch needs, in 8-byte words: one accumulator a value,
// then one flag word a pixel and one max word a channel (4 bytes each).
__host__ __device__ __forceinline__ long long scratch_words(long long pixels,
                                                            int c) {
  return pixels * c + (pixels + c + 1) / 2;
}

struct Scratch {
  long long* acc;      // (pixels, c) fixed-point sums
  unsigned* flags;     // (pixels) non-finite flags, three bits a channel
  unsigned* vmax;      // (c) bits of the largest finite |v| a channel
};

__host__ __device__ __forceinline__ Scratch scratch_of(void* base,
                                                       long long pixels,
                                                       int c) {
  Scratch s;
  s.acc = static_cast<long long*>(base);
  s.flags = reinterpret_cast<unsigned*>(s.acc + pixels * c);
  s.vmax = s.flags + pixels;
  return s;
}

// q_c of the header: a power-of-two exponent such that span x max|v_c| x
// 2^q < 2^62, within fp32's normal range.
__device__ __forceinline__ int scale_exponent(unsigned vmax_bits,
                                              double span) {
  const double m = (double)__uint_as_float(vmax_bits);
  if (m == 0.0) return 0;
  int ex;
  frexp(span * m, &ex);    // span m < 2^ex
  const int q = 62 - ex;
  return q > 126 ? 126 : (q < -126 ? -126 : q);
}

// Pass 1: the largest finite |v| of each channel, and the accumulators and
// flags zeroed (the max words are zeroed by the launch before this pass).
__global__ void __launch_bounds__(kThreads)
max_kernel(const float* __restrict__ values, long long pixels, int c,
           Scratch s) {
  __shared__ unsigned part[kThreads / 32][kMaxC];
  unsigned m[kMaxC];
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) m[ch] = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pixels; p += stride) {
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch) {
      if (ch < c) {
        const float v = fabsf(values[p * c + ch]);
        // a non-negative float orders as its bits; Inf and NaN left out
        if (v <= 3.402823466e38f) m[ch] = max(m[ch], __float_as_uint(v));
        s.acc[p * c + ch] = 0;
      }
    }
    s.flags[p] = 0u;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[ch] = max(m[ch], __shfl_xor_sync(0xffffffffu, m[ch], off));
    if (lane == 0) part[warp][ch] = m[ch];
  }
  __syncthreads();
  if (threadIdx.x < c) {
    unsigned v = 0u;
    for (int w = 0; w < kThreads / 32; ++w) v = max(v, part[w][threadIdx.x]);
    atomicMax(s.vmax + threadIdx.x, v);
  }
}

// One source pixel (row = b h + sy of the n h image rows, column sx). With
// kLocal, `off` holds the (n, hb, wb, 2) output-tile offsets and each tap
// pair is tested against its own tile's shifted window. The taps are the
// plain version's: a row or column tap outside the image has weight 0 and
// the clamped index 0, and the window rule is applied at the clamped
// indices; a tap of weight 0 is skipped unless a value is not finite.
template <bool kLocal>
__device__ __forceinline__ void splat_pixel(const float* __restrict__ values,
                                            const float* __restrict__ flow,
                                            const float* __restrict__ off,
                                            const Scratch& s,
                                            const float* scale, int row,
                                            int sx, int h, int w, int c,
                                            int dy, int dx, int sh, int sw,
                                            int hb, int wb) {
  const int sy = row % h;
  const long long img = (long long)(row - sy) * w;
  const long long p = (long long)row * w + sx;
  const float tx = __fadd_rn((float)sx, flow[2 * p]);
  const float ty = __fadd_rn((float)sy, flow[2 * p + 1]);
  const float r0 = floorf(ty), k0 = floorf(tx);

  float v[kMaxC];
  bool finite = true;
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch) {
    v[ch] = ch < c ? values[p * c + ch] : 0.0f;
    finite = finite && isfinite(v[ch]);
  }

  float wr[2], wk[2];
  int ir[2], ik[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float r = r0 + (float)q, k = k0 + (float)q;
    const bool r_ok = r >= 0.0f && r <= (float)(h - 1);
    const bool k_ok = k >= 0.0f && k <= (float)(w - 1);
    ir[q] = r_ok ? (int)r : 0;
    ik[q] = k_ok ? (int)k : 0;
    wr[q] = r_ok ? hat(__fsub_rn(ty, r)) : 0.0f;
    wk[q] = k_ok ? hat(__fsub_rn(tx, k)) : 0.0f;
  }

  const float2* toff = nullptr;
  if (kLocal)
    toff = reinterpret_cast<const float2*>(off) + (long long)(row / h) * hb * wb;
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
    if (finite && wr[qr] == 0.0f) continue;
#pragma unroll
    for (int qk = 0; qk < 2; ++qk) {
      bool keep;
      if (kLocal) {
        // the window of the tile holding this tap, shifted by -off_out
        const float2 shift =
            __ldg(toff + (ir[qr] / kTile) * wb + ik[qk] / kTile);
        const int ox = (int)(-shift.x), oy = (int)(-shift.y);
        keep = in_window(sy - oy, ir[qr], dy, sh)
               && in_window(sx - ox, ik[qk], dx, sw);
      } else {
        keep = in_window(sy, ir[qr], dy, sh) && in_window(sx, ik[qk], dx, sw);
      }
      const float wkk = keep ? wk[qk] : 0.0f;
      if (finite && wkk == 0.0f) continue;
      const long long o = img + (long long)ir[qr] * w + ik[qk];
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch) {
        if (ch >= c) break;
        const float t = __fmul_rn(__fmul_rn(v[ch], wr[qr]), wkk);
        if (isfinite(t)) {
          if (t != 0.0f)
            atomicAdd(reinterpret_cast<u64*>(s.acc + o * c + ch),
                      (u64)__float2ll_rn(__fmul_rn(t, scale[ch])));
        } else {
          const unsigned f = isnan(t) ? kNaN : (t > 0.0f ? kPosInf : kNegInf);
          atomicOr(s.flags + o, f << (3 * ch));
        }
      }
    }
  }
}

// The scales 2^q_c of the launch, one a channel, into shared memory.
__device__ __forceinline__ void load_scales(const Scratch& s, int c,
                                            double span, float* scale) {
  if (threadIdx.x < c)
    scale[threadIdx.x] = exp2f((float)scale_exponent(s.vmax[threadIdx.x],
                                                     span));
  __syncthreads();
}

// Pass 2. Grid: x over the columns, y over the n h image rows (strided when
// there are more rows than grid rows), so no thread divides a 64-bit index.
template <bool kLocal>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ values, const float* __restrict__ flow,
             const float* __restrict__ off, Scratch s, int rows, int h, int w,
             int c, int dy, int dx, int sh, int sw, int hb, int wb) {
  __shared__ float scale[kMaxC];
  load_scales(s, c, (double)sh * sw, scale);
  const int sx = blockIdx.x * blockDim.x + threadIdx.x;
  if (sx >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y)
    splat_pixel<kLocal>(values, flow, off, s, scale, row, sx, h, w, c, dy,
                        dx, sh, sw, hb, wb);
}

// Pass 3: out = sum 2^-q_c rounded once to fp32, or the non-finite value
// the flags name. One thread a pixel.
__global__ void __launch_bounds__(kThreads)
convert_kernel(Scratch s, long long pixels, int c, double span,
               float* __restrict__ out) {
  __shared__ double inv[kMaxC];
  if (threadIdx.x < c)
    inv[threadIdx.x] = exp2(-(double)scale_exponent(s.vmax[threadIdx.x],
                                                    span));
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pixels; p += stride) {
    const unsigned flags = s.flags[p];
    for (int ch = 0; ch < c; ++ch) {
      const unsigned f = (flags >> (3 * ch)) & 7u;
      float v;
      if (f == 0u) {
        v = __double2float_rn(__ll2double_rn(s.acc[p * c + ch]) * inv[ch]);
      } else if ((f & kNaN) || f == (kPosInf | kNegInf)) {
        v = __int_as_float(0x7fc00000);
      } else {
        v = __int_as_float(f == kPosInf ? 0x7f800000 : 0xff800000);
      }
      out[p * c + ch] = v;
    }
  }
}

template <bool kLocal>
int launch(const float* values, const float* flow, const float* off,
           float* out, void* scratch, int n, int h, int w, int c, int dy,
           int dx, int sh, int sw, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC || dy < 0 || dx < 0
      || sh <= 0 || sw <= 0 || scratch == nullptr || (kLocal && off == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long pixels = rows * w;
  const Scratch s = scratch_of(scratch, pixels, c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(s.vmax, 0, sizeof(unsigned) * c, st);
  if (err != cudaSuccess) return (int)err;
  const long long want = (pixels + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  max_kernel<<<blocks, kThreads, 0, st>>>(values, pixels, c, s);
  const dim3 grid((w + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridRows ? rows : kMaxGridRows));
  splat_kernel<kLocal><<<grid, kThreads, 0, st>>>(
      values, flow, off, s, (int)rows, h, w, c, dy, dx, sh, sw,
      (h + kTile - 1) / kTile, (w + kTile - 1) / kTile);
  convert_kernel<<<blocks, kThreads, 0, st>>>(s, pixels, c,
                                              (double)sh * sw, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 8-byte words of scratch one launch over n x h x w pixels of c channels
// needs.
long long sininn_splat_region_scratch(int n, int h, int w, int c) {
  return scratch_words((long long)n * h * w, c);
}

// One launch on `stream`, writing all of `out`. values: (n, h, w, c) fp32
// (c <= 8), flow: (n, h, w, 2) fp32 (dx, dy), out: (n, h, w, c) fp32, all
// contiguous; scratch: sininn_splat_region_scratch words, 8-byte aligned,
// no contents needed. dy, dx: the window bounds; sh, sw: the window's rows
// and columns. Returns a cudaError_t.
int sininn_splat_region(const float* values, const float* flow, float* out,
                        void* scratch, int n, int h, int w, int c, int dy,
                        int dx, int sh, int sw, void* stream) {
  return launch<false>(values, flow, nullptr, out, scratch, n, h, w, c, dy,
                       dx, sh, sw, stream);
}

// The local-window form: off_out is (n, ceil(h / 128), ceil(w / 128), 2)
// fp32, contiguous and 8-byte aligned, integer-valued (ox, oy); dy, dx are
// the local bounds and sh, sw the window they give. Returns a cudaError_t.
int sininn_splat_region_local(const float* values, const float* flow,
                              const float* off_out, float* out,
                              void* scratch, int n, int h, int w, int c,
                              int dy, int dx, int sh, int sw, void* stream) {
  return launch<true>(values, flow, off_out, out, scratch, n, h, w, c, dy,
                      dx, sh, sw, stream);
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
