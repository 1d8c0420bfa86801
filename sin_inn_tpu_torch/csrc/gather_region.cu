// Windowed bilinear gather (the resample2d warp), forward mode, for sm_90a.
//
// Replaces the TPU kernel `_gather_kernel` of sin_inn_tpu/ops/pallas/gather.py
// (called by `_gather_region_call` with grads=False). For output pixel (y, x)
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
// is needed. The coordinate is one fused multiply-add after the sum (as
// XLA forms it) and the tap sums use round-to-nearest intrinsics with no
// other contraction, so the kernel repeats the plain version's arithmetic
// operation for operation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // output tile width (columns)
constexpr int kChunk = 8;    // output rows per chunk of the TPU kernel
constexpr long long kMaxGridRows = 65535;   // gridDim.y limit

__device__ __forceinline__ float hat(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

// One output pixel (row = b h + y of the n h image rows, column x).
__device__ __forceinline__ void gather_pixel(const float* __restrict__ a,
                                             const float* __restrict__ flow,
                                             float* __restrict__ out, int row,
                                             int x, int h, int w, int c,
                                             int dy, int dx, float sx,
                                             float shx, float sy, float shy) {
  const int y = row % h;
  const long long img = (long long)(row - y) * w;
  const long long p = (long long)row * w + x;
  const float fx = flow[2 * p];
  const float fy = flow[2 * p + 1];
  const float px = __fmaf_rn(__fadd_rn((float)x, fx), sx, shx);
  const float py = __fmaf_rn(__fadd_rn((float)y, fy), sy, shy);

  // the window of taps this pixel may read, clipped to the image
  const int c0 = y / kChunk * kChunk;
  const float r_lo = (float)max(c0 - dy, 0);
  const float r_hi = (float)min(c0 + dy + kChunk, h);     // exclusive
  const int j0 = x / kTile * kTile;
  const float k_lo = (float)max(j0 - dx, 0);
  const float k_hi = (float)min(j0 + kTile + dx, w);      // exclusive

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

  float* o = out + p * c;
  for (int ch = 0; ch < c; ++ch) {
    const float a00 = (row0 >= 0 && ik0 >= 0) ? a[(row0 + ik0) * c + ch] : 0.0f;
    const float a01 = (row0 >= 0 && ik1 >= 0) ? a[(row0 + ik1) * c + ch] : 0.0f;
    const float a10 = (row1 >= 0 && ik0 >= 0) ? a[(row1 + ik0) * c + ch] : 0.0f;
    const float a11 = (row1 >= 0 && ik1 >= 0) ? a[(row1 + ik1) * c + ch] : 0.0f;
    const float v0 = __fadd_rn(__fmul_rn(a00, wx0), __fmul_rn(a01, wx1));
    const float v1 = __fadd_rn(__fmul_rn(a10, wx0), __fmul_rn(a11, wx1));
    o[ch] = __fadd_rn(__fmul_rn(wy0, v0), __fmul_rn(wy1, v1));
  }
}

// Grid: x over the columns, y over the n h image rows (strided when there
// are more rows than grid rows), so no thread divides a 64-bit index.
__global__ void gather_region_kernel(const float* __restrict__ a,
                                     const float* __restrict__ flow,
                                     float* __restrict__ out, int rows, int h,
                                     int w, int c, int dy, int dx, float sx,
                                     float shx, float sy, float shy) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y)
    gather_pixel(a, flow, out, row, x, h, w, c, dy, dx, sx, shx, sy, shy);
}

}  // namespace

extern "C" {

// One launch on `stream`. a: (n, h, w, c) fp32, flow: (n, h, w, 2) fp32
// (dx, dy), out: (n, h, w, c) fp32, all contiguous. dy, dx: the padded
// window half-widths. Returns a cudaError_t.
int sininn_gather_region(const float* a, const float* flow, float* out,
                         int n, int h, int w, int c, int dy, int dx, float sx,
                         float shx, float sy, float shy, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || dy < 0 || dx < 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridRows ? rows : kMaxGridRows));
  gather_region_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a, flow, out, (int)rows, h, w, c, dy, dx, sx, shx, sy, shy);
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
