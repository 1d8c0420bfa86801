// Windowed bilinear gather (the resample2d warp) for sm_90a: the forward
// mode and the gradient mode.
//
// Replaces the TPU kernel `_gather_kernel` of sin_inn_tpu/ops/pallas/gather.py
// (called by `_gather_region_call` with grads=False and with grads=True; the
// gradient mode is described above `gather_grads_pixel`). For output pixel (y, x)
// of image b, with flow f = flow[b, y, x] = (fx, fy):
//
//   p = ((x + fx) sx + shx, (y + fy) sy + shy)   (the product and sum fused)
//   out[b, y, x, c] = sum over the taps (r, k) in {floor(py), floor(py) + 1}
//                     x {floor(px), floor(px) + 1} of
//                     hat(py - r) hat(px - k) a[b, r, k, c],  hat(d) = max(1 - |d|, 0)
//
// where a tap counts only if it lies in the image and in the source window
// the TPU kernel read for this pixel: rows [c0 - dy, c0 - dy + 2 dy + 8) with
// c0 = 8 floor(y / 8) (the pixel's 8-row chunk), columns
// [j 128 - dx, j 128 - dx + 128 + 2 dx) with j = floor(x / 128) (its
// 128-column output tile). dy and dx arrive already padded as the TPU kernel
// padded them (`_pad_geometry`: dy to a multiple of 4, dx of 64). So the
// result equals the TPU kernel's for every flow, in or out of the window.
//
// What bounds it on an H100: bytes. At the flow path's shape (1 x 436 x 1024,
// C = 3) one launch must read the image (5.36 MB) and the flow (3.57 MB) and
// write the output (5.36 MB): 14.3 MB, 0.0043 ms at 3.35 TB/s. It does about
// 30 FLOP per output value, far below the card's balance point.
//
// What the design does about it: the TPU kernel DMA'd a (C, 2dy + 128,
// 2dx + 128) window into VMEM and ran the gather as one-hot matmuls on the
// MXU. Here one thread computes one output pixel, x fastest, so the flow
// reads and the output writes of a warp are contiguous; the four taps read
// the NHWC image directly (no channel-planar copy), and neighbouring threads
// read neighbouring taps, so L1 and L2 serve the reuse and no shared memory
// is needed. The forward mode's block is one row of one 128-column tile, so
// its threads share one tile window (and one offset address, local); the
// flow comes as one 8-byte load and, at C = 3, a pixel's 12 tap loads go
// out together. On the card that beat blocks of 2 to 8 such rows (the
// TPU's 8-row chunk), an offset read once a block through shared memory,
// and 2 or 4 adjacent pixels a thread with float4 flow loads and wider
// stores: the byte-bound gather gains most from many small blocks, each
// with its loads in flight. The gradient mode keeps 256 pixels of a row a
// block. The coordinate is one fused multiply-add after the sum (as XLA
// forms it) and the tap sums use round-to-nearest intrinsics with no other
// contraction, so both modes repeat the plain version's arithmetic
// operation for operation.
//
// The local-window forms (either entry given an `off_src` pointer) replace
// the same TPU kernel as `_gather_region_call_local` runs it (local=True), in
// both modes: the window
// of pixel (y, x) is shifted by (ox, oy) = off_src[b, y / 128, x / 128], the
// rounded mean flow of the pixel's own 128 x 128 tile (ops/offsets.py), to
// rows [c0 - dy + oy, c0 + dy + 8 + oy) and columns [j 128 - dx + ox,
// j 128 + 128 + dx + ox), with dy, dx the local bounds padded as
// `_pad_geometry` pads them. The resample coordinates shift taps by up to
// about 1.5 px from the raw flow the offsets come from; that is the
// function, as on the TPU. Each thread reads its tile's offset pair with
// one 8-byte __ldg (32 tiles, 256 B, at Sintel size), so the bytes are the
// static kernels' plus 256 B: 14.3 MB (forward, C = 3, 0.0043 ms at
// 3.35 TB/s), 23.2 MB (grads, C = 3, 0.0069 ms), 33.9 MB (grads, C = 5,
// 0.0101 ms).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // gradient mode: 256 pixels of a row a block
constexpr int kTile = 128;     // output tile width (columns); forward block
constexpr int kChunk = 8;    // output rows per chunk of the TPU kernel
constexpr long long kMaxGridRows = 65535;   // gridDim.y limit

__device__ __forceinline__ float hat(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

// The tap window of output pixel (y, x) of image b, clipped to the image:
// rows [r_lo, r_hi), columns [k_lo, k_hi). With kLocal it is shifted by the
// offset of the pixel's tile, off[b, y / 128, x / 128].
template <bool kLocal>
__device__ __forceinline__ void tap_window(const float* __restrict__ off,
                                           int b, int y, int x, int h, int w,
                                           int dy, int dx, float& r_lo,
                                           float& r_hi, float& k_lo,
                                           float& k_hi) {
  int ox = 0, oy = 0;
  if (kLocal) {
    const int hb = (h + kTile - 1) / kTile, wb = (w + kTile - 1) / kTile;
    const float2 o = __ldg(reinterpret_cast<const float2*>(off)
                           + ((long long)b * hb + y / kTile) * wb + x / kTile);
    ox = (int)o.x;
    oy = (int)o.y;
  }
  const int c0 = y / kChunk * kChunk + oy;
  r_lo = (float)max(c0 - dy, 0);
  r_hi = (float)min(c0 + dy + kChunk, h);     // exclusive
  const int j0 = x / kTile * kTile + ox;
  k_lo = (float)max(j0 - dx, 0);
  k_hi = (float)min(j0 + kTile + dx, w);      // exclusive
}

// The gather at one output pixel (x, y) of the image starting at element
// img / c of a, with its flow (fx, fy) and the tap window of its block,
// into o[0 .. c): the arithmetic of the plain version, operation for
// operation. kC: the channels, or 0 for c at run time.
template <int kC>
__device__ __forceinline__ void gather_px(const float* __restrict__ a,
                                          long long img, int x, int y, int w,
                                          int c, float fx, float fy,
                                          float sx, float shx, float sy,
                                          float shy, float r_lo, float r_hi,
                                          float k_lo, float k_hi, float* o) {
  const float px = __fmaf_rn(__fadd_rn((float)x, fx), sx, shx);
  const float py = __fmaf_rn(__fadd_rn((float)y, fy), sy, shy);
  const float r0 = floorf(py), k0 = floorf(px);
  const float r1 = r0 + 1.0f, k1 = k0 + 1.0f;
  const bool in_r0 = r0 >= r_lo && r0 < r_hi, in_r1 = r1 >= r_lo && r1 < r_hi;
  const bool in_k0 = k0 >= k_lo && k0 < k_hi, in_k1 = k1 >= k_lo && k1 < k_hi;
  const float wy0 = in_r0 ? hat(__fsub_rn(py, r0)) : 0.0f;
  const float wy1 = in_r1 ? hat(__fsub_rn(py, r1)) : 0.0f;
  const float wx0 = in_k0 ? hat(__fsub_rn(px, k0)) : 0.0f;
  const float wx1 = in_k1 ? hat(__fsub_rn(px, k1)) : 0.0f;
  const long long row0 = in_r0 ? img + (long long)r0 * w : -1;
  const long long row1 = in_r1 ? img + (long long)r1 * w : -1;
  const int ik0 = in_k0 ? (int)k0 : -1, ik1 = in_k1 ? (int)k1 : -1;
  const int ch_n = kC > 0 ? kC : c;
#pragma unroll
  for (int ch = 0; ch < ch_n; ++ch) {
    const float a00 =
        (row0 >= 0 && ik0 >= 0) ? a[(row0 + ik0) * ch_n + ch] : 0.0f;
    const float a01 =
        (row0 >= 0 && ik1 >= 0) ? a[(row0 + ik1) * ch_n + ch] : 0.0f;
    const float a10 =
        (row1 >= 0 && ik0 >= 0) ? a[(row1 + ik0) * ch_n + ch] : 0.0f;
    const float a11 =
        (row1 >= 0 && ik1 >= 0) ? a[(row1 + ik1) * ch_n + ch] : 0.0f;
    const float v0 = __fadd_rn(__fmul_rn(a00, wx0), __fmul_rn(a01, wx1));
    const float v1 = __fadd_rn(__fmul_rn(a10, wx0), __fmul_rn(a11, wx1));
    o[ch] = __fadd_rn(__fmul_rn(wy0, v0), __fmul_rn(wy1, v1));
  }
}

// Forward mode. A block is one row of one 128-column output tile (the TPU
// kernel's tile), one thread a pixel: the threads of a block share the
// tile's window and read its offset (kLocal) from one address, one
// transaction a warp. The flow comes in as one 8-byte load a pixel (where
// `vec`: the flow 8-byte aligned); at kC = 3 the channel loop is unrolled,
// so a pixel's 12 tap loads are in flight together. Grid: x over the
// tiles, y over the n h image rows (strided past the grid's limit).
template <bool kLocal, int kC>
__global__ void __launch_bounds__(kTile)
gather_region_kernel(const float* __restrict__ a,
                     const float* __restrict__ flow,
                     const float* __restrict__ off, float* __restrict__ out,
                     int rows, int h, int w, int c, int dy, int dx, float sx,
                     float shx, float sy, float shy, int vec) {
  const int x = blockIdx.x * kTile + threadIdx.x;
  if (x >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const int y = row % h;
    const long long p = (long long)row * w + x;
    float fx, fy;
    if (vec) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + p);
      fx = f.x;
      fy = f.y;
    } else {
      fx = flow[2 * p];
      fy = flow[2 * p + 1];
    }
    float r_lo, r_hi, k_lo, k_hi;
    tap_window<kLocal>(off, row / h, y, x, h, w, dy, dx, r_lo, r_hi, k_lo,
                       k_hi);
    gather_px<kC>(a, (long long)(row - y) * w, x, y, w, c, fx, fy, sx, shx,
                  sy, shy, r_lo, r_hi, k_lo, k_hi, out + p * c);
  }
}

// d/dp of hat(p - k): -sign(d) on |d| < 1, and 0 at d = 0 and beyond, as the
// TPU kernel's `_dhat` selects it.
__device__ __forceinline__ float dhat(float d) {
  if (!(fabsf(d) < 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// Gradient mode (`_gather_kernel` with grads=True): the gather of pixel
// (row, x) as above, and with a payload q[b, y, x, :] the two sums
//   dfx = sum_c q_c sum_taps hat(py - r) dhat(px - k) a[b, r, k, c]
//   dfy = sum_c q_c sum_taps dhat(py - r) hat(px - k) a[b, r, k, c]
// which are d<q, out>/d(px, py). The caller applies the coordinate scales.
// A tap the window rule drops adds to neither. It serves the warp's flow
// gradient (a = image, q = cotangent, resample coordinates) and the splat's
// backward (a = cotangent, q = values, raw coordinates: out is then the
// values' gradient). Bytes bound it as they bound the forward: at C = 5 it
// reads 12 and writes 7 floats per pixel, 33.9 MB at 436 x 1024, 0.010 ms at
// 3.35 TB/s. One thread per pixel again; dfx and dfy leave as one float2.
template <bool kLocal>
__device__ __forceinline__ void gather_grads_pixel(
    const float* __restrict__ a, const float* __restrict__ flow,
    const float* __restrict__ payload, const float* __restrict__ off,
    float* __restrict__ out, float* __restrict__ dp, int row, int x, int h,
    int w, int c, int dy, int dx, float sx, float shx, float sy, float shy) {
  const int y = row % h;
  const long long img = (long long)(row - y) * w;
  const long long p = (long long)row * w + x;
  const float fx = flow[2 * p];
  const float fy = flow[2 * p + 1];
  const float px = __fmaf_rn(__fadd_rn((float)x, fx), sx, shx);
  const float py = __fmaf_rn(__fadd_rn((float)y, fy), sy, shy);

  float r_lo, r_hi, k_lo, k_hi;
  tap_window<kLocal>(off, row / h, y, x, h, w, dy, dx, r_lo, r_hi, k_lo,
                     k_hi);

  const float r0 = floorf(py), k0 = floorf(px);
  const float r1 = r0 + 1.0f, k1 = k0 + 1.0f;
  const bool in_r0 = r0 >= r_lo && r0 < r_hi, in_r1 = r1 >= r_lo && r1 < r_hi;
  const bool in_k0 = k0 >= k_lo && k0 < k_hi, in_k1 = k1 >= k_lo && k1 < k_hi;
  const float ey0 = __fsub_rn(py, r0), ey1 = __fsub_rn(py, r1);
  const float ex0 = __fsub_rn(px, k0), ex1 = __fsub_rn(px, k1);
  const float wy0 = in_r0 ? hat(ey0) : 0.0f, wy1 = in_r1 ? hat(ey1) : 0.0f;
  const float wx0 = in_k0 ? hat(ex0) : 0.0f, wx1 = in_k1 ? hat(ex1) : 0.0f;
  const float gy0 = in_r0 ? dhat(ey0) : 0.0f, gy1 = in_r1 ? dhat(ey1) : 0.0f;
  const float gx0 = in_k0 ? dhat(ex0) : 0.0f, gx1 = in_k1 ? dhat(ex1) : 0.0f;
  const long long row0 = in_r0 ? img + (long long)r0 * w : -1;
  const long long row1 = in_r1 ? img + (long long)r1 * w : -1;
  const int ik0 = in_k0 ? (int)k0 : -1, ik1 = in_k1 ? (int)k1 : -1;

  float* o = out + p * c;
  const float* q = payload + p * c;
  float dfx = 0.0f, dfy = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const float a00 = (row0 >= 0 && ik0 >= 0) ? a[(row0 + ik0) * c + ch] : 0.0f;
    const float a01 = (row0 >= 0 && ik1 >= 0) ? a[(row0 + ik1) * c + ch] : 0.0f;
    const float a10 = (row1 >= 0 && ik0 >= 0) ? a[(row1 + ik0) * c + ch] : 0.0f;
    const float a11 = (row1 >= 0 && ik1 >= 0) ? a[(row1 + ik1) * c + ch] : 0.0f;
    const float v0 = __fadd_rn(__fmul_rn(a00, wx0), __fmul_rn(a01, wx1));
    const float v1 = __fadd_rn(__fmul_rn(a10, wx0), __fmul_rn(a11, wx1));
    o[ch] = __fadd_rn(__fmul_rn(wy0, v0), __fmul_rn(wy1, v1));
    const float d0 = __fadd_rn(__fmul_rn(a00, gx0), __fmul_rn(a01, gx1));
    const float d1 = __fadd_rn(__fmul_rn(a10, gx0), __fmul_rn(a11, gx1));
    const float s1 = __fadd_rn(__fmul_rn(wy0, d0), __fmul_rn(wy1, d1));
    const float s2 = __fadd_rn(__fmul_rn(gy0, v0), __fmul_rn(gy1, v1));
    const float qc = q[ch];
    dfx = __fadd_rn(dfx, __fmul_rn(qc, s1));
    dfy = __fadd_rn(dfy, __fmul_rn(qc, s2));
  }
  reinterpret_cast<float2*>(dp)[p] = make_float2(dfx, dfy);
}

template <bool kLocal>
__global__ void gather_region_grads_kernel(
    const float* __restrict__ a, const float* __restrict__ flow,
    const float* __restrict__ payload, const float* __restrict__ off,
    float* __restrict__ out, float* __restrict__ dp, int rows, int h, int w,
    int c, int dy, int dx, float sx, float shx, float sy, float shy) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y)
    gather_grads_pixel<kLocal>(a, flow, payload, off, out, dp, row, x, h, w,
                               c, dy, dx, sx, shx, sy, shy);
}

// One launch of either mode (payload null: the forward mode) on `stream`.
template <bool kLocal>
int launch(const float* a, const float* flow, const float* payload,
           const float* off, float* out, float* dp, int n, int h, int w,
           int c, int dy, int dx, float sx, float shx, float sy, float shy,
           void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || dy < 0 || dx < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid_y = (unsigned)(rows < kMaxGridRows ? rows
                                                        : kMaxGridRows);
  if (payload == nullptr) {
    const dim3 grid((w + kTile - 1) / kTile, grid_y);
    const int vec = reinterpret_cast<uintptr_t>(flow) % 8 == 0;
    if (c == 3)
      gather_region_kernel<kLocal, 3><<<grid, kTile, 0, st>>>(
          a, flow, off, out, (int)rows, h, w, c, dy, dx, sx, shx, sy, shy,
          vec);
    else
      gather_region_kernel<kLocal, 0><<<grid, kTile, 0, st>>>(
          a, flow, off, out, (int)rows, h, w, c, dy, dx, sx, shx, sy, shy,
          vec);
  } else {
    const dim3 grid((w + kThreads - 1) / kThreads, grid_y);
    gather_region_grads_kernel<kLocal><<<grid, kThreads, 0, st>>>(
        a, flow, payload, off, out, dp, (int)rows, h, w, c, dy, dx, sx, shx,
        sy, shy);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`. a: (n, h, w, c) fp32, flow: (n, h, w, 2) fp32
// (dx, dy), out: (n, h, w, c) fp32, all contiguous. dy, dx: the padded
// window half-widths. off_src: null for the static windows, else the local
// form's (n, ceil(h / 128), ceil(w / 128), 2) fp32 offsets, contiguous,
// 8-byte aligned and integer-valued (ox, oy), with dy, dx the padded local
// half-widths. Returns a cudaError_t.
int sininn_gather_region(const float* a, const float* flow,
                         const float* off_src, float* out, int n, int h,
                         int w, int c, int dy, int dx, float sx, float shx,
                         float sy, float shy, void* stream) {
  return off_src == nullptr
             ? launch<false>(a, flow, nullptr, nullptr, out, nullptr, n, h, w,
                             c, dy, dx, sx, shx, sy, shy, stream)
             : launch<true>(a, flow, nullptr, off_src, out, nullptr, n, h, w,
                            c, dy, dx, sx, shx, sy, shy, stream);
}

// One launch of the gradient mode on `stream`. a, payload: (n, h, w, c) fp32,
// flow: (n, h, w, 2), out: (n, h, w, c), dp: (n, h, w, 2) = (dfx, dfy), all
// contiguous; off_src as above. Returns a cudaError_t.
int sininn_gather_region_grads(const float* a, const float* flow,
                               const float* payload, const float* off_src,
                               float* out, float* dp, int n, int h, int w,
                               int c, int dy, int dx, float sx, float shx,
                               float sy, float shy, void* stream) {
  if (payload == nullptr) return (int)cudaErrorInvalidValue;
  return off_src == nullptr
             ? launch<false>(a, flow, payload, nullptr, out, dp, n, h, w, c,
                             dy, dx, sx, shx, sy, shy, stream)
             : launch<true>(a, flow, payload, off_src, out, dp, n, h, w, c,
                            dy, dx, sx, shx, sy, shy, stream);
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
