// K8 backward: the VJP of one GLOW half coupling with 3x3-conv subnets, for
// the forward and the inverse flag, for sm_90a.
//
// Replaces `_half_band_bwd_kernel` (sin_inn_tpu/ops/pallas/coupling3x3.py
// :381), the TPU's fused VJP of one half on row bands: dx_in, dx_aff, dW1,
// db1, dW2, db2 for the cotangent g of y. Here it is four hand-written
// stages, with h, gz and gr written to device memory between them (h and gz
// are 115 MB each at the flagship's first octave, batch 8):
//
//   1. the fused kernel of csrc/coupling_3x3.cuh in a backward mode:
//      recompute h and [s | t] per tile (conv1 on a 1-pixel halo), store h
//      and gr = [gs | gt] at the tile's own pixels, and dx_aff. Forward
//      flag: gs = g x_aff e le'(s), gt = g, dx_aff = g e, e = exp(le(s));
//      inverse flag: gs = -g x_out le'(s), gt = -g e^-1, dx_aff = g e^-1,
//      x_out = (x_aff - t) e^-1.
//   2. gz = conv3x3(gr, w2t) where h > 0, else 0 (the relu gate), at image
//      pixels only: gz is 0 outside the image, so no gradient flows through
//      conv2's zero padding into conv1 or the weights.
//   3. dx_in = conv3x3(gz, w1t). w2t and w1t are the flipped, transposed
//      kernels, prepared in PyTorch as the TPU prepares them in XLA.
//   4. the weight and bias gradients as products over the image's own
//      pixels, [dW1 | db1] = im2col(x_in)^T [gz], [dW2 | db2] =
//      im2col(h)^T [gr] (a row of ones gives the bias), split over chunks
//      of 2,048 pixels: each block writes its tile of one chunk's products
//      into that chunk's slot of a partials buffer, and the reduction of
//      csrc/coupling_1x1_bwd.cu sums the slots in a fixed order. No
//      atomics: the backward is bitwise repeatable, as the TPU's sequential
//      grid accumulation is.
//
// What bounds it on an H100: arithmetic, some 117 GFLOP per half at batch 8
// at either flagship octave (the recompute with its halo, the two
// transposed convolutions and the two weight products) against under 1 GB
// of traffic. Stages 2-3 are plain 3x3 convolutions from shared-memory tiles
// with a 1-pixel halo (no recompute); stage 4 is a tiled fp32 product
// (64 x 64 output tiles, 4 x 4 per thread). All fp32 FMA; tensor cores are
// later work.

#include "coupling_3x3.cuh"

namespace {

using k8::kThreads;
using k8::kTileW;

// Floats of dynamic shared memory the convolution kernel needs.
long long conv_smem_floats(int th, int cin) {
  return (long long)(th + 2) * (kTileW + 2) * cin;
}

// out = conv3x3(in, w) (SAME, no bias) at every image pixel; with kGate,
// out = 0 where gate <= 0. in (n, h, w, cin), out and gate (n, h, w, cout),
// w (9, cin, cout).
template <bool kGate>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ in, int cin,
               const float* __restrict__ w, int cout,
               const float* __restrict__ gate, float* __restrict__ out,
               int nimg, int h, int wd, int th) {
  extern __shared__ float smem[];
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + th - 1) / th;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * th, x0 = tx * kTileW;
  k8::load_window(in, n, h, wd, cin, y0 - 1, x0 - 1, th + 2, kTileW + 2,
                  smem);
  __syncthreads();
  k8::conv3x3_tile<1>(smem, cin, w, cout, 0, th, kTileW,
                      [&](int p, int col, const float (&acc)[1][4]) {
    const int gy = y0 + p / kTileW, gx = x0 + p % kTileW;
    if (gy >= h || gx >= wd) return;
    const size_t at = (((size_t)n * h + gy) * wd + gx) * cout + col;
    float v[4] = {acc[0][0], acc[0][1], acc[0][2], acc[0][3]};
    if (kGate) {
      float gv[4];
      k8::load4(gate + at, gv);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = gv[q] > 0.f ? v[q] : 0.f;
    }
    k8::store4(out + at, v);
  });
}

template <bool kGate>
cudaError_t launch_conv(const float* in, int cin, const float* w, int cout,
                        const float* gate, float* out, int n, int h, int wd,
                        int th, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)conv_smem_floats(th, cin);
  if (cout % 4 || th <= 0 || smem > (size_t)k8::kMaxSmem)
    return cudaErrorInvalidValue;
  auto kernel = conv3x3_kernel<kGate>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)n * ((h + th - 1) / th) * ((wd + kTileW - 1) / kTileW);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(in, cin, w, cout, gate,
                                                       out, n, h, wd, th);
  return cudaGetLastError();
}

constexpr int kBM = 64;   // rows (tap, channel) of a weight-gradient tile
constexpr int kBN = 64;   // columns of a weight-gradient tile
constexpr int kBK = 16;   // pixels per shared-memory step

// One weight-gradient product: rows 9 ca + 1 (tap-major im2col of a, then
// the bias row of ones), columns cb, summed over pixels.
struct Product {
  const float* a;
  int ca;
  const float* b;
  int cb;
  long long offset;   // floats into a slot
};

__device__ __forceinline__ int row_tiles(const Product& p) {
  return (9 * p.ca + 1 + kBM - 1) / kBM;
}
__device__ __forceinline__ int col_tiles(const Product& p) {
  return (p.cb + kBN - 1) / kBN;
}

// blockIdx.x: an output tile of product 0 or 1; blockIdx.y: a chunk of
// `chunk` pixels. Writes the tile's sums over the chunk into slot
// blockIdx.y of `partials` (slot floats each).
__global__ void __launch_bounds__(kThreads)
weight_grads_kernel(Product p0, Product p1, int h, int wd, long long m,
                    int chunk, float* __restrict__ partials,
                    long long slot) {
  __shared__ float as[kBK][kBM];
  __shared__ float bs[kBK][kBN];
  int tile = blockIdx.x;
  const int tiles0 = row_tiles(p0) * col_tiles(p0);
  const Product& pr = tile < tiles0 ? p0 : p1;
  if (tile >= tiles0) tile -= tiles0;
  const int ct = col_tiles(pr);
  const int i0 = (tile / ct) * kBM, j0 = (tile % ct) * kBN;
  const int rows = 9 * pr.ca + 1;
  const long long k_begin = (long long)blockIdx.y * chunk;
  const long long k_end = min(k_begin + chunk, m);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kBK * kBM / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int kk = e / kBM, ii = e % kBM;
      const long long px = k0 + kk;
      const int i = i0 + ii;
      float v = 0.f;
      if (px < k_end && i < rows) {
        if (i == rows - 1) {
          v = 1.f;
        } else {
          const int tap = i / pr.ca, c = i % pr.ca;
          const int x = (int)(px % wd);
          const int y = (int)((px / wd) % h);
          const long long n = px / ((long long)wd * h);
          const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
          if (yy >= 0 && yy < h && xx >= 0 && xx < wd)
            v = __ldg(pr.a + ((n * h + yy) * wd + xx) * pr.ca + c);
        }
      }
      as[kk][ii] = v;
      const int j = j0 + ii;
      bs[kk][ii] = (px < k_end && j < pr.cb)
                       ? __ldg(pr.b + px * pr.cb + j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = partials + (long long)blockIdx.y * slot + pr.offset;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j0 + tx + 16 * j;
      if (c < pr.cb) dst[(long long)r * pr.cb + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the fused stage 1 needs with th-row tiles.
long long sininn_coupling_3x3_smem_bytes(int th, int cin, int hid) {
  return (long long)sizeof(float) * k8::half_smem_floats(th, cin, hid);
}

// Bytes of dynamic shared memory stages 2-3 need for cin input channels.
long long sininn_conv3x3_smem_bytes(int th, int cin) {
  return (long long)sizeof(float) * conv_smem_floats(th, cin);
}

// Floats in one slot of weight and bias gradient partials:
// [dW1 (9, cin, hid) | db1 (hid) | dW2 (9, hid, 2 caff) | db2 (2 caff)].
long long sininn_coupling_3x3_bwd_slot_floats(int cin, int caff, int hid) {
  return (long long)(9 * cin + 1) * hid + (long long)(9 * hid + 1) * 2 * caff;
}

// The VJP of one half coupling (inverse = 0: the forward flag) for the
// cotangent g, on `stream`: stages 1-4 above. x_in (n, h, w, cin), x_aff,
// g, dx_aff (n, h, w, caff), dx_in (n, h, w, cin), NHWC fp32. Scratch:
// h_buf and gz_buf (n, h, w, hid), gr_buf (n, h, w, 2 caff), partials
// (ceil(n h w / chunk), slot floats), all written in full. Weights fp32
// row-major: w1 (9, cin, hid), w2 (9, hid, 2 caff), w2t (9, 2 caff, hid),
// w1t (9, hid, cin). th_fwd / th_gz / th_dx: tile rows of stages 1-3.
// cin, caff and hid must be multiples of 4. Returns a cudaError_t.
int sininn_coupling_3x3_bwd(int inverse, const float* x_in,
                            const float* x_aff, const float* g, float* dx_in,
                            float* dx_aff, float* h_buf, float* gz_buf,
                            float* gr_buf, float* partials, int chunk, int n,
                            int h, int w, int cin, int caff, int hid,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* w2t,
                            const float* w1t, float clamp, int th_fwd,
                            int th_gz, int th_dx, void* stream) {
  if (cin <= 0 || cin % 4 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const k8::HalfArgs a{x_in, x_aff, g, dx_aff, h_buf, gr_buf, w1, b1,
                       w2, b2, n, h, w, cin, caff, hid, th_fwd, clamp};
  cudaError_t err = inverse ? k8::launch_half<k8::kBackwardInverse>(a, s)
                            : k8::launch_half<k8::kBackward>(a, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<true>(gr_buf, 2 * caff, w2t, hid, h_buf, gz_buf, n, h, w,
                          th_gz, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_conv<false>(gz_buf, hid, w1t, cin, nullptr, dx_in, n, h, w,
                           th_dx, s);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)n * h * w;
  const Product p0{x_in, cin, gz_buf, hid, 0};
  const Product p1{h_buf, hid, gr_buf, 2 * caff,
                   (long long)(9 * cin + 1) * hid};
  const int tiles =
      ((9 * cin + 1 + kBM - 1) / kBM) * ((hid + kBN - 1) / kBN) +
      ((9 * hid + 1 + kBM - 1) / kBM) * ((2 * caff + kBN - 1) / kBN);
  const long long chunks = (m + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  weight_grads_kernel<<<dim3((unsigned)tiles, (unsigned)chunks), kThreads, 0,
                        s>>>(p0, p1, h, w, m, chunk, partials,
                             sininn_coupling_3x3_bwd_slot_floats(cin, caff,
                                                                 hid));
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
