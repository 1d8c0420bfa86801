// Device code shared by the two sources of K8, the GLOW half coupling with
// 3x3-conv subnets (csrc/coupling_3x3.cu: forward and inverse;
// csrc/coupling_3x3_bwd.cu: the VJP, whose first stage is the same fused
// kernel in its two backward modes).
//
// One launch of `half_coupling_3x3_kernel` computes, for NHWC fp32 tensors
// x_in (N, H, W, Cin) and x_aff (N, H, W, Caff) with hidden width Hid,
//
//   h = relu(conv1(x_in) + b1)            SAME 3x3, Cin -> Hid
//   r = conv2(h) + b2 = [s | t]           SAME 3x3, Hid -> 2 Caff
//   forward:  y = exp(le(s)) x_aff + t
//   inverse:  y = (x_aff - t) exp(-le(s))
//
// with le(s) = clamp (2/pi) atanf(s / clamp). Each block takes one th x 16
// tile of output pixels of one image. It loads x_in on the tile with a
// 2-pixel halo into shared memory (zero outside the image), computes h on
// the tile with a 1-pixel halo into shared memory (zero outside the image:
// h is conv2's zero padding there, not relu(b1)), then conv2 and the affine
// step on the tile's own pixels. h never leaves the chip. The backward modes
// store h and the cotangents of [s | t] at the tile's own pixels instead of
// y, for the later stages of the VJP.
//
// Convolutions are fp32 FMA. A thread item holds kRP pixels x 4 channels
// (x 2 for conv2: a channel of s and its channel of t) in registers; each
// (tap, input channel) step reads kRP values from shared memory and one
// float4 of weights per channel group through L1 / L2 (`__ldg`), from
// (9, Cin, Cout) row-major copies of the weights prepared in PyTorch.

#pragma once

#include <cuda_runtime.h>

namespace k8 {

constexpr int kThreads = 256;
constexpr int kTileW = 16;   // output tile width in pixels
constexpr int kRP = 4;       // output pixels per thread item
constexpr int kMaxSmem = 232448;

enum Mode { kForward = 0, kInverse = 1, kBackward = 2, kBackwardInverse = 3 };

__device__ __forceinline__ float log_e(float s, float clamp) {
  return clamp * 0.636619772367581343f * atanf(s / clamp);
}

// d/ds le(s) = (2/pi) / (1 + (s / clamp)^2)
__device__ __forceinline__ float log_e_prime(float s, float clamp) {
  const float u = s / clamp;
  return 0.636619772367581343f / (1.f + u * u);
}

__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The (rows x cols)-pixel window of image n of an NHWC tensor whose top-left
// pixel is (y0, x0), channel innermost, into shared memory; pixels outside
// the image are 0.
__device__ void load_window(const float* __restrict__ src, int n, int h,
                            int w, int c, int y0, int x0, int rows, int cols,
                            float* dst) {
  const float* img = src + (size_t)n * h * w * c;
  const int total = rows * cols * c;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int ch = idx % c;
    const int pos = idx / c;
    const int gy = y0 + pos / cols, gx = x0 + pos % cols;
    dst[idx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                   ? __ldg(img + ((size_t)gy * w + gx) * c + ch)
                   : 0.f;
  }
}

// A SAME 3x3 convolution over a tile in shared memory. The input holds
// (oh + 2) x (ow + 2) pixels of cin channels, channel innermost; w is
// (9, cin, cout) row-major in global memory. For each output pixel p of the
// oh x ow tile (row-major) and each group of four output channels at
// columns col + v * vstride (v < kNV), the sums over taps and input
// channels go to epi(p, col, acc). cout / (4 kNV) channel groups; with
// kNV = 2, vstride = cout / 2.
template <int kNV, typename Epi>
__device__ __forceinline__ void conv3x3_tile(const float* in, int cin,
                                             const float* __restrict__ w,
                                             int cout, int vstride, int oh,
                                             int ow, Epi epi) {
  const int in_w = ow + 2;
  const int ncg = cout / (4 * kNV);
  const int n4 = cout / 4;
  const int v4 = vstride / 4;
  const int npos = oh * ow;
  const int npg = (npos + kRP - 1) / kRP;
  for (int item = threadIdx.x; item < npg * ncg; item += blockDim.x) {
    const int cg = item % ncg;
    const int pg = item / ncg;
    int base[kRP];
#pragma unroll
    for (int r = 0; r < kRP; ++r) {
      const int p = min(pg * kRP + r, npos - 1);
      base[r] = ((p / ow) * in_w + p % ow) * cin;
    }
    float acc[kRP][kNV][4];
#pragma unroll
    for (int r = 0; r < kRP; ++r)
#pragma unroll
      for (int v = 0; v < kNV; ++v)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][v][q] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * in_w + tap % 3) * cin;
      const float4* wrow =
          reinterpret_cast<const float4*>(w + (size_t)tap * cin * cout) + cg;
#pragma unroll 4
      for (int ci = 0; ci < cin; ++ci) {
        float4 wv[kNV];
#pragma unroll
        for (int v = 0; v < kNV; ++v)
          wv[v] = __ldg(wrow + (size_t)ci * n4 + v * v4);
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          const float a = in[base[r] + toff + ci];
#pragma unroll
          for (int v = 0; v < kNV; ++v) {
            acc[r][v][0] = fmaf(a, wv[v].x, acc[r][v][0]);
            acc[r][v][1] = fmaf(a, wv[v].y, acc[r][v][1]);
            acc[r][v][2] = fmaf(a, wv[v].z, acc[r][v][2]);
            acc[r][v][3] = fmaf(a, wv[v].w, acc[r][v][3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRP; ++r) {
      const int p = pg * kRP + r;
      if (p < npos) epi(p, cg * 4, acc[r]);
    }
  }
}

// Floats of dynamic shared memory the fused kernel needs for th-row tiles.
__host__ __device__ inline long long half_smem_floats(int th, int cin,
                                                      int hid) {
  return (long long)(th + 4) * (kTileW + 4) * cin +
         (long long)(th + 2) * (kTileW + 2) * hid;
}

struct HalfArgs {
  const float* x_in;   // (N, H, W, Cin)
  const float* x_aff;  // (N, H, W, Caff)
  const float* g;      // (N, H, W, Caff): cotangent of y (backward modes)
  float* out;          // y, or dx_aff in the backward modes
  float* h_out;        // (N, H, W, Hid): h (backward modes)
  float* gr_out;       // (N, H, W, 2 Caff): [gs | gt] (backward modes)
  const float* w1;     // (9, Cin, Hid)
  const float* b1;     // (Hid)
  const float* w2;     // (9, Hid, 2 Caff)
  const float* b2;     // (2 Caff)
  int n, h, w, cin, caff, hid, th;
  float clamp;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
half_coupling_3x3_kernel(HalfArgs a) {
  extern __shared__ float smem[];
  const int th = a.th;
  const int tiles_x = (a.w + kTileW - 1) / kTileW;
  const int tiles_y = (a.h + th - 1) / th;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * th, x0 = tx * kTileW;
  const int hw = kTileW + 2;
  const int hid = a.hid, caff = a.caff;
  float* xs = smem;
  float* hs = smem + (th + 4) * (kTileW + 4) * a.cin;

  load_window(a.x_in, n, a.h, a.w, a.cin, y0 - 2, x0 - 2, th + 4, kTileW + 4,
              xs);
  __syncthreads();

  // h on the tile and its 1-pixel halo; 0 outside the image
  conv3x3_tile<1>(xs, a.cin, a.w1, hid, 0, th + 2, hw,
                  [&](int p, int col, const float (&acc)[1][4]) {
    const int gy = y0 - 1 + p / hw, gx = x0 - 1 + p % hw;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gy >= 0 && gy < a.h && gx >= 0 && gx < a.w) {
      float b[4];
      load4(a.b1 + col, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = fmaxf(acc[0][q] + b[q], 0.f);
    }
    store4(hs + (size_t)p * hid + col, v);
  });
  __syncthreads();

  if (kMode >= kBackward) {
    const int total = th * kTileW * hid;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int j = idx % hid;
      const int pos = idx / hid;
      const int py = pos / kTileW, px = pos % kTileW;
      const int gy = y0 + py, gx = x0 + px;
      if (gy < a.h && gx < a.w)
        a.h_out[(((size_t)n * a.h + gy) * a.w + gx) * hid + j] =
            hs[((py + 1) * hw + px + 1) * hid + j];
    }
  }

  // r = [s | t] on the tile's own pixels, then the affine step
  conv3x3_tile<2>(hs, hid, a.w2, 2 * caff, caff, th, kTileW,
                  [&](int p, int col, const float (&acc)[2][4]) {
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy >= a.h || gx >= a.w) return;
    const size_t pix = ((size_t)n * a.h + gy) * a.w + gx;
    float bs[4], bt[4], xa[4], s[4], t[4];
    load4(a.b2 + col, bs);
    load4(a.b2 + caff + col, bt);
    load4(a.x_aff + pix * caff + col, xa);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[q] = acc[0][q] + bs[q];
      t[q] = acc[1][q] + bt[q];
    }
    if (kMode == kForward || kMode == kInverse) {
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float le = log_e(s[q], a.clamp);
        y[q] = kMode == kInverse ? (xa[q] - t[q]) * expf(-le)
                                 : expf(le) * xa[q] + t[q];
      }
      store4(a.out + pix * caff + col, y);
    } else {
      float g[4], gs[4], gt[4], dxa[4];
      load4(a.g + pix * caff + col, g);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float le = log_e(s[q], a.clamp);
        const float lp = log_e_prime(s[q], a.clamp);
        if (kMode == kBackward) {
          const float e = expf(le);
          gs[q] = g[q] * xa[q] * e * lp;
          gt[q] = g[q];
          dxa[q] = g[q] * e;
        } else {
          const float einv = expf(-le);
          const float xo = (xa[q] - t[q]) * einv;
          gs[q] = -g[q] * xo * lp;
          gt[q] = -g[q] * einv;
          dxa[q] = g[q] * einv;
        }
      }
      store4(a.gr_out + pix * 2 * caff + col, gs);
      store4(a.gr_out + pix * 2 * caff + caff + col, gt);
      store4(a.out + pix * caff + col, dxa);
    }
  });
}

template <int kMode>
cudaError_t launch_half(const HalfArgs& a, cudaStream_t stream) {
  const long long floats = half_smem_floats(a.th, a.cin, a.hid);
  if (a.n <= 0 || a.h <= 0 || a.w <= 0 || a.cin <= 0 || a.th <= 0 ||
      a.caff <= 0 || a.caff % 4 || a.hid <= 0 || a.hid % 4 ||
      floats * (long long)sizeof(float) > kMaxSmem)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)floats;
  auto kernel = half_coupling_3x3_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n * ((a.h + a.th - 1) / a.th) *
                           ((a.w + kTileW - 1) / kTileW);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace k8
