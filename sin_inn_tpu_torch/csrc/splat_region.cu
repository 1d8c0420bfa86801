// Windowed bilinear forward splat (the region scatter), for sm_90a.
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
// atomicAdds the C weighted values into the zeroed NHWC output (the wrapper
// zeroes it). A smooth flow sends the threads of a warp to neighbouring
// targets, so the atomics coalesce and rarely collide. The price: the order
// of the sums at one output pixel changes from run to run, so the result is
// not bitwise reproducible (the JAX path is). A deterministic version would
// accumulate each output tile in shared memory; 128 x 128 x 5 fp32 is
// 320 KB, over a block's 227 KB, so it needs sub-tiles or channel passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // output tile rows and columns
constexpr long long kMaxGridRows = 65535;   // gridDim.y limit

__device__ __forceinline__ float hat(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

// Whether source coordinate s lies in the window of the tile holding the
// (in-image, non-negative) target coordinate t.
__device__ __forceinline__ bool in_window(int s, int t, int d, int span) {
  const int lo = t / kTile * kTile - d;
  return s >= lo && s < lo + span;
}

// One source pixel (row = b h + sy of the n h image rows, column sx).
__device__ __forceinline__ void splat_pixel(const float* __restrict__ values,
                                            const float* __restrict__ flow,
                                            float* __restrict__ out, int row,
                                            int sx, int h, int w, int c,
                                            int dy, int dx, int sh, int sw) {
  const int sy = row % h;
  const long long img = (long long)(row - sy) * w;
  const long long p = (long long)row * w + sx;
  const float tx = __fadd_rn((float)sx, flow[2 * p]);
  const float ty = __fadd_rn((float)sy, flow[2 * p + 1]);
  const float r0 = floorf(ty), k0 = floorf(tx);

  float wr[2], wk[2];
  int ir[2], ik[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float r = r0 + (float)q, k = k0 + (float)q;
    const bool r_ok = r >= 0.0f && r <= (float)(h - 1);
    const bool k_ok = k >= 0.0f && k <= (float)(w - 1);
    ir[q] = r_ok ? (int)r : -1;
    ik[q] = k_ok ? (int)k : -1;
    wr[q] = (r_ok && in_window(sy, ir[q], dy, sh)) ? hat(__fsub_rn(ty, r)) : 0.0f;
    wk[q] = (k_ok && in_window(sx, ik[q], dx, sw)) ? hat(__fsub_rn(tx, k)) : 0.0f;
  }

  const float* v = values + p * c;
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
    if (wr[qr] == 0.0f) continue;
#pragma unroll
    for (int qk = 0; qk < 2; ++qk) {
      if (wk[qk] == 0.0f) continue;
      float* o = out + (img + (long long)ir[qr] * w + ik[qk]) * c;
      for (int ch = 0; ch < c; ++ch)
        atomicAdd(o + ch, __fmul_rn(__fmul_rn(v[ch], wr[qr]), wk[qk]));
    }
  }
}

// Grid: x over the columns, y over the n h image rows (strided when there
// are more rows than grid rows), so no thread divides a 64-bit index.
__global__ void splat_region_kernel(const float* __restrict__ values,
                                    const float* __restrict__ flow,
                                    float* __restrict__ out, int rows, int h,
                                    int w, int c, int dy, int dx, int sh,
                                    int sw) {
  const int sx = blockIdx.x * blockDim.x + threadIdx.x;
  if (sx >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y)
    splat_pixel(values, flow, out, row, sx, h, w, c, dy, dx, sh, sw);
}

}  // namespace

extern "C" {

// One launch on `stream`, accumulating into `out`, which the caller zeroes.
// values: (n, h, w, c) fp32, flow: (n, h, w, 2) fp32 (dx, dy), out:
// (n, h, w, c) fp32, all contiguous. dy, dx: the window bounds; sh, sw: the
// window's rows and columns. Returns a cudaError_t.
int sininn_splat_region(const float* values, const float* flow, float* out,
                        int n, int h, int w, int c, int dy, int dx, int sh,
                        int sw, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || dy < 0 || dx < 0 || sh <= 0
      || sw <= 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)n * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridRows ? rows : kMaxGridRows));
  splat_region_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      values, flow, out, (int)rows, h, w, c, dy, dx, sh, sw);
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
