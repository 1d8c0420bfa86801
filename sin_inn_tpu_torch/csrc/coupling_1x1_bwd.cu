// Backward of the fused GLOW coupling with 1x1-conv subnets, for sm_90a.
//
// Replaces the TPU kernels `_coupling_bwd_kernel` (K3, the VJP of the
// forward) and `_coupling_inv_bwd_kernel` (K4, the VJP of the inverse) of
// sin_inn_tpu/ops/pallas/coupling.py. Per pixel (one row of the (M, C)
// input), with x = [x1 | x2], len1 + len2 = C, hidden width H, r = [s | t],
// le(s) = clamp (2/pi) atan(s / clamp), le'(s) = (2/pi) / (1 + (s/clamp)^2):
//
//   K3: recompute  h2 = relu(W2a x2 + b2a), r2 = W2b h2 + b2b,
//                  y1 = exp(le(s2)) x1 + t2, h1 = relu(W1a y1 + b1a),
//                  r1 = W1b h1 + b1b;
//       then the reverse chain of coupling.py:293-310 for dx, and the eight
//       weight and bias gradients x2'gz2, sum gz2, h2'gr2, sum gr2, y1'gz1,
//       sum gz1, h1'gr1, sum gr1 over all rows.
//   K4: the same for the inverse chain (coupling.py:430-466), from y.
//
// The recompute repeats the forward's arithmetic in the order of K1 and K2
// (csrc/coupling_1x1.cu): one fmaf chain over k from zero, the bias added
// after, atanf and expf, so it reproduces the activations the forward
// produced. The ReLU mask comes from h (z > 0 exactly where h > 0). Math is
// fp32; x, g and dx are stored in fp32 or bf16; the gradients are fp32.
//
// What bounds it on an H100: arithmetic. One launch does 18 H C FLOP per
// pixel (recompute 6 H C, the dx chain 6 H C, the weight gradients 6 H C).
// At the SRF training shapes (batch 8, HR 352x640: M = 112,640 x C = 48 and
// M = 28,160 x C = 192) that is 24.9 GFLOP against about 65 MB of x, g and
// dx: 0.37 ms at the fp32 peak, 0.05 ms at the TF32 peak, ~0.02 ms of bytes.
//
// What the design does about it, and about the gradient sum:
// * The TPU summed the weight gradients across its sequential grid into
//   constant-indexed output blocks. Here blocks run in parallel and in no
//   order, so the sum takes two passes. A persistent grid of P blocks (as
//   many as fit on the SMs at once) walks the 32-row tiles; each block adds
//   its tiles' products into its own fp32 slot of a scratch buffer of P x S
//   floats (S = 37,472 at C = 48, 148,352 at C = 192; the wrapper allocates
//   it). A block's first tile writes its slot, later tiles add to it. No slot
//   is shared, so there are no atomics. A second kernel sums the P slots in
//   a fixed order, so the result is the same on every run.
// * Shared memory: one tile holds the input, the cotangent (which becomes
//   dx in place), both H-wide hidden layers (each overwritten in place by
//   its masked gradient gz once h'gr is taken), s and y1 (x2 in K4), and one
//   [gs | gt] buffer: about 165 KB at C = 192, 91 KB at C = 48.
// * Products with transposed weights (gr W_b', gz W_a') read the weights in
//   their (cout, cin) layout, which is the OIHW conv weight as stored, so a
//   warp still reads consecutive addresses.
// * Rows past M are zeros in the tile: their cotangent is zero, so they add
//   nothing to any gradient, and they are never stored.
// Tensor cores (TF32 wgmma, or 3xTF32 for fp32 accuracy) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;    // pixels per tile
constexpr int kWideRows = 8;     // rows per thread when N is the hidden width
constexpr int kNarrowRows = 2;   // rows per thread when N is len1 or len2
constexpr int kCols = 4;         // columns (or channel pairs) per thread
constexpr int kGradK = 4;        // weight-gradient rows per thread

struct Weights {       // forward order, (cin, cout) row-major
  const float *w2a, *b2a, *w2b, *b2b, *w1a, *b1a, *w1b, *b1b;
};
struct WeightsT {      // (cout, cin) row-major: the OIHW conv weights
  const float *w2a, *w2b, *w1a, *w1b;
};
struct Grads {         // one block's slot of the partial sums
  float *w2a, *b2a, *w2b, *b2b, *w1a, *b1a, *w1b, *b1b;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float log_e(float s, float clamp) {
  return clamp * 0.636619772367581343f * atanf(s / clamp);
}

__device__ __forceinline__ float log_e_prime(float s, float clamp) {
  const float u = s / clamp;
  return 0.636619772367581343f / (1.f + u * u);
}

// Odd row strides keep the rows of a tile on different shared-memory banks.
__host__ __device__ __forceinline__ int padded(int n) { return n | 1; }

// epi(r, n, sum_k a[r][k] w[k][n]) for every tile row r and n < N.
// a: shared memory, row stride lda, k < K. w: (K, N) row-major, global.
template <int kRows, class Epi>
__device__ __forceinline__ void matmul_rows(const float* a, int lda, int K,
                                            const float* __restrict__ w,
                                            int N, Epi epi) {
  const int ncg = (N + kCols - 1) / kCols;
  const int items = (kTileRows / kRows) * ncg;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kRows;
    // columns cg, cg + ncg, ...: a warp reads consecutive weights at once
    int col[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[q] = min(cg + q * ncg, N - 1);
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    for (int k = 0; k < K; ++k) {
      float wv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) wv[q] = __ldg(w + (size_t)k * N + col[q]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float av = a[(r0 + i) * lda + k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(av, wv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (cg + q * ncg >= N) continue;
#pragma unroll
      for (int i = 0; i < kRows; ++i) epi(r0 + i, col[q], acc[i][q]);
    }
  }
}

// The scale/shift layer: r = h w + b with w: (H, 2L) row-major;
// epi(r, j, s, t) with s = r[:, j], t = r[:, L + j] for j < L.
template <class Epi>
__device__ __forceinline__ void affine_rows(const float* h, int ldh, int H,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            int L, Epi epi) {
  const int n = 2 * L;
  const int ncg = (L + kCols - 1) / kCols;
  const int items = (kTileRows / kNarrowRows) * ncg;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kNarrowRows;
    int col[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[q] = min(cg + q * ncg, L - 1);
    float s[kNarrowRows][kCols], t[kNarrowRows][kCols];
#pragma unroll
    for (int i = 0; i < kNarrowRows; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) s[i][q] = t[i][q] = 0.f;
    for (int k = 0; k < H; ++k) {
      float ws[kCols], wt[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        ws[q] = __ldg(w + (size_t)k * n + col[q]);
        wt[q] = __ldg(w + (size_t)k * n + L + col[q]);
      }
#pragma unroll
      for (int i = 0; i < kNarrowRows; ++i) {
        const float av = h[(r0 + i) * ldh + k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          s[i][q] = fmaf(av, ws[q], s[i][q]);
          t[i][q] = fmaf(av, wt[q], t[i][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (cg + q * ncg >= L) continue;
      const float bs = __ldg(b + col[q]);
      const float bt = __ldg(b + L + col[q]);
#pragma unroll
      for (int i = 0; i < kNarrowRows; ++i)
        epi(r0 + i, col[q], s[i][q] + bs, t[i][q] + bt);
    }
  }
}

// This tile's share of a weight gradient and its bias gradient:
// gw[k][n] (+)= sum_r a[r][k] d[r][n] for k < K, n < N, and
// gb[n] (+)= sum_r d[r][n]. The block's first tile writes, later tiles add.
__device__ void weight_grad(const float* a, int lda, int K, const float* d,
                            int ldd, int N, float* __restrict__ gw,
                            float* __restrict__ gb, bool first) {
  const int ncg = (N + kCols - 1) / kCols;
  const int nkg = (K + kGradK - 1) / kGradK;
  const int items = nkg * ncg;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int cg = item % ncg;
    const int k0 = (item / ncg) * kGradK;
    int col[kCols], row[kGradK];
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[q] = min(cg + q * ncg, N - 1);
#pragma unroll
    for (int i = 0; i < kGradK; ++i) row[i] = min(k0 + i, K - 1);
    float acc[kGradK][kCols];
#pragma unroll
    for (int i = 0; i < kGradK; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    for (int r = 0; r < kTileRows; ++r) {
      float dv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) dv[q] = d[r * ldd + col[q]];
#pragma unroll
      for (int i = 0; i < kGradK; ++i) {
        const float av = a[r * lda + row[i]];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(av, dv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kGradK; ++i) {
      if (k0 + i >= K) continue;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        if (cg + q * ncg >= N) continue;
        float* p = gw + (size_t)row[i] * N + col[q];
        *p = first ? acc[i][q] : *p + acc[i][q];
      }
    }
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < kTileRows; ++r) sum += d[r * ldd + n];
    gb[n] = first ? sum : gb[n] + sum;
  }
}

struct Tile {          // shared-memory buffers of one tile
  float *in, *g, *ha, *hb, *sv, *av, *gr;
  int ldc, ldh, ldl, ldr;
};

__host__ __device__ __forceinline__ long long tile_floats(int c, int len1,
                                                          int hidden) {
  const int lmax = len1 > c - len1 ? len1 : c - len1;
  return (long long)kTileRows * (2 * padded(c) + 2 * padded(hidden) +
                                 2 * padded(lmax) + padded(2 * lmax));
}

// K3 on one tile: in = x, g = dy on entry and dx on exit.
__device__ void forward_vjp_tile(const Tile& b, int len1, int len2, int H,
                                 const Weights& wt, const WeightsT& wtt,
                                 float clamp, const Grads& gd, bool first) {
  float* const xs = b.in;
  float* const gs = b.g;
  float* const ha = b.ha;
  float* const hb = b.hb;
  float* const sv = b.sv;
  float* const av = b.av;
  float* const gr = b.gr;
  const int ldc = b.ldc, ldh = b.ldh, ldl = b.ldl, ldr = b.ldr;

  // ---- recompute the forward: h2, s2, y1, h1 ----
  matmul_rows<kWideRows>(xs + len1, ldc, len2, wt.w2a, H,
                         [&](int r, int n, float acc) {
                           ha[r * ldh + n] = fmaxf(acc + __ldg(wt.b2a + n), 0.f);
                         });
  __syncthreads();
  affine_rows(ha, ldh, H, wt.w2b, wt.b2b, len1,
              [&](int r, int j, float s, float t) {
                sv[r * ldl + j] = s;
                av[r * ldl + j] = expf(log_e(s, clamp)) * xs[r * ldc + j] + t;
              });
  __syncthreads();
  matmul_rows<kWideRows>(av, ldl, len1, wt.w1a, H,
                         [&](int r, int n, float acc) {
                           hb[r * ldh + n] = fmaxf(acc + __ldg(wt.b1a + n), 0.f);
                         });
  __syncthreads();
  // ---- y2 = e1 x2 + t1: gr1 = [gy2 x2 e1 le'(s1) | gy2], gx2 = gy2 e1 ----
  affine_rows(hb, ldh, H, wt.w1b, wt.b1b, len2,
              [&](int r, int j, float s, float) {
                const float e = expf(log_e(s, clamp));
                const float gy2 = gs[r * ldc + len1 + j];
                gr[r * ldr + j] = gy2 * xs[r * ldc + len1 + j] * e *
                                  log_e_prime(s, clamp);
                gr[r * ldr + len2 + j] = gy2;
                gs[r * ldc + len1 + j] = gy2 * e;
              });
  __syncthreads();
  weight_grad(hb, ldh, H, gr, ldr, 2 * len2, gd.w1b, gd.b1b, first);
  __syncthreads();
  // gz1 = (gr1 W1b') masked by h1 > 0, in place of h1
  matmul_rows<kWideRows>(gr, ldr, 2 * len2, wtt.w1b, H,
                         [&](int r, int n, float acc) {
                           float* p = hb + r * ldh + n;
                           *p = *p > 0.f ? acc : 0.f;
                         });
  __syncthreads();
  // gy1 += gz1 W1a'; the weight gradient y1'gz1
  matmul_rows<kNarrowRows>(hb, ldh, H, wtt.w1a, len1,
                           [&](int r, int j, float acc) {
                             gs[r * ldc + j] += acc;
                           });
  weight_grad(av, ldl, len1, hb, ldh, H, gd.w1a, gd.b1a, first);
  __syncthreads();
  // ---- y1 = e2 x1 + t2: gr2 = [gy1 x1 e2 le'(s2) | gy1], gx1 = gy1 e2 ----
  for (int idx = threadIdx.x; idx < kTileRows * len1; idx += blockDim.x) {
    const int r = idx / len1, j = idx % len1;
    const float s = sv[r * ldl + j];
    const float e = expf(log_e(s, clamp));
    const float gy1 = gs[r * ldc + j];
    gr[r * ldr + j] = gy1 * xs[r * ldc + j] * e * log_e_prime(s, clamp);
    gr[r * ldr + len1 + j] = gy1;
    gs[r * ldc + j] = gy1 * e;
  }
  __syncthreads();
  weight_grad(ha, ldh, H, gr, ldr, 2 * len1, gd.w2b, gd.b2b, first);
  __syncthreads();
  matmul_rows<kWideRows>(gr, ldr, 2 * len1, wtt.w2b, H,
                         [&](int r, int n, float acc) {
                           float* p = ha + r * ldh + n;
                           *p = *p > 0.f ? acc : 0.f;
                         });
  __syncthreads();
  // gx2 += gz2 W2a'; the weight gradient x2'gz2
  matmul_rows<kNarrowRows>(ha, ldh, H, wtt.w2a, len2,
                           [&](int r, int j, float acc) {
                             gs[r * ldc + len1 + j] += acc;
                           });
  weight_grad(xs + len1, ldc, len2, ha, ldh, H, gd.w2a, gd.b2a, first);
}

// K4 on one tile: in = y, g = dx on entry and dy on exit.
__device__ void inverse_vjp_tile(const Tile& b, int len1, int len2, int H,
                                 const Weights& wt, const WeightsT& wtt,
                                 float clamp, const Grads& gd, bool first) {
  float* const ys = b.in;
  float* const gs = b.g;
  float* const ha = b.ha;
  float* const hb = b.hb;
  float* const sv = b.sv;
  float* const av = b.av;
  float* const gr = b.gr;
  const int ldc = b.ldc, ldh = b.ldh, ldl = b.ldl, ldr = b.ldr;

  // ---- recompute the inverse: h1, s1, x2, h2 ----
  matmul_rows<kWideRows>(ys, ldc, len1, wt.w1a, H,
                         [&](int r, int n, float acc) {
                           hb[r * ldh + n] = fmaxf(acc + __ldg(wt.b1a + n), 0.f);
                         });
  __syncthreads();
  affine_rows(hb, ldh, H, wt.w1b, wt.b1b, len2,
              [&](int r, int j, float s, float t) {
                sv[r * ldl + j] = s;
                av[r * ldl + j] =
                    (ys[r * ldc + len1 + j] - t) * expf(-log_e(s, clamp));
              });
  __syncthreads();
  matmul_rows<kWideRows>(av, ldl, len2, wt.w2a, H,
                         [&](int r, int n, float acc) {
                           ha[r * ldh + n] = fmaxf(acc + __ldg(wt.b2a + n), 0.f);
                         });
  __syncthreads();
  // ---- x1 = (y1 - t2) / e2: gr2 = [-gx1 x1 le'(s2) | -gx1 / e2],
  //      gy1 = gx1 / e2 ----
  affine_rows(ha, ldh, H, wt.w2b, wt.b2b, len1,
              [&](int r, int j, float s, float t) {
                const float einv = expf(-log_e(s, clamp));
                const float x1 = (ys[r * ldc + j] - t) * einv;
                const float gx1 = gs[r * ldc + j];
                gr[r * ldr + j] = -gx1 * x1 * log_e_prime(s, clamp);
                gr[r * ldr + len1 + j] = -gx1 * einv;
                gs[r * ldc + j] = gx1 * einv;
              });
  __syncthreads();
  weight_grad(ha, ldh, H, gr, ldr, 2 * len1, gd.w2b, gd.b2b, first);
  __syncthreads();
  matmul_rows<kWideRows>(gr, ldr, 2 * len1, wtt.w2b, H,
                         [&](int r, int n, float acc) {
                           float* p = ha + r * ldh + n;
                           *p = *p > 0.f ? acc : 0.f;
                         });
  __syncthreads();
  // gx2 += gz2 W2a'; the weight gradient x2'gz2
  matmul_rows<kNarrowRows>(ha, ldh, H, wtt.w2a, len2,
                           [&](int r, int j, float acc) {
                             gs[r * ldc + len1 + j] += acc;
                           });
  weight_grad(av, ldl, len2, ha, ldh, H, gd.w2a, gd.b2a, first);
  __syncthreads();
  // ---- x2 = (y2 - t1) / e1: gr1 = [-gx2 x2 le'(s1) | -gx2 / e1],
  //      gy2 = gx2 / e1 ----
  for (int idx = threadIdx.x; idx < kTileRows * len2; idx += blockDim.x) {
    const int r = idx / len2, j = idx % len2;
    const float s = sv[r * ldl + j];
    const float einv = expf(-log_e(s, clamp));
    const float gx2 = gs[r * ldc + len1 + j];
    gr[r * ldr + j] = -gx2 * av[r * ldl + j] * log_e_prime(s, clamp);
    gr[r * ldr + len2 + j] = -gx2 * einv;
    gs[r * ldc + len1 + j] = gx2 * einv;
  }
  __syncthreads();
  weight_grad(hb, ldh, H, gr, ldr, 2 * len2, gd.w1b, gd.b1b, first);
  __syncthreads();
  matmul_rows<kWideRows>(gr, ldr, 2 * len2, wtt.w1b, H,
                         [&](int r, int n, float acc) {
                           float* p = hb + r * ldh + n;
                           *p = *p > 0.f ? acc : 0.f;
                         });
  __syncthreads();
  // gy1 += gz1 W1a'; the weight gradient y1'gz1
  matmul_rows<kNarrowRows>(hb, ldh, H, wtt.w1a, len1,
                           [&](int r, int j, float acc) {
                             gs[r * ldc + j] += acc;
                           });
  weight_grad(ys, ldc, len1, hb, ldh, H, gd.w1a, gd.b1a, first);
}

__host__ __device__ __forceinline__ long long slot_floats(int c, int len1,
                                                          int hidden) {
  const long long len2 = c - len1;
  return len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1 +
         len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2;
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads)
coupling_1x1_bwd_kernel(const T* __restrict__ in, const T* __restrict__ g,
                        T* __restrict__ dx, long long m_total, int c,
                        int len1, int hidden, Weights wt, WeightsT wtt,
                        float clamp, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int len2 = c - len1;
  const int lmax = max(len1, len2);
  Tile b;
  b.ldc = padded(c);
  b.ldh = padded(hidden);
  b.ldl = padded(lmax);
  b.ldr = padded(2 * lmax);
  b.in = smem;                          // kTileRows x ldc: x or y
  b.g = b.in + kTileRows * b.ldc;       // kTileRows x ldc: cotangent -> dx
  b.ha = b.g + kTileRows * b.ldc;       // kTileRows x ldh: h2, then gz2
  b.hb = b.ha + kTileRows * b.ldh;      // kTileRows x ldh: h1, then gz1
  b.sv = b.hb + kTileRows * b.ldh;      // kTileRows x ldl: s2 (K3), s1 (K4)
  b.av = b.sv + kTileRows * b.ldl;      // kTileRows x ldl: y1 (K3), x2 (K4)
  b.gr = b.av + kTileRows * b.ldl;      // kTileRows x ldr: [gs | gt]

  Grads gd;
  gd.w2a = partials + (long long)blockIdx.x * slot_floats(c, len1, hidden);
  gd.b2a = gd.w2a + (size_t)len2 * hidden;
  gd.w2b = gd.b2a + hidden;
  gd.b2b = gd.w2b + (size_t)hidden * 2 * len1;
  gd.w1a = gd.b2b + 2 * len1;
  gd.b1a = gd.w1a + (size_t)len1 * hidden;
  gd.w1b = gd.b1a + hidden;
  gd.b1b = gd.w1b + (size_t)hidden * 2 * len2;

  const long long tiles = (m_total + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    // rows past m_total are zeros: computed, never stored, no gradient
    for (int idx = threadIdx.x; idx < kTileRows * c; idx += blockDim.x) {
      const int r = idx / c, col = idx % c;
      const long long m = row0 + r;
      const bool live = m < m_total;
      b.in[r * b.ldc + col] = live ? to_float(in[m * c + col]) : 0.f;
      b.g[r * b.ldc + col] = live ? to_float(g[m * c + col]) : 0.f;
    }
    __syncthreads();
    const bool first = tile == blockIdx.x;
    if (kInverse)
      inverse_vjp_tile(b, len1, len2, hidden, wt, wtt, clamp, gd, first);
    else
      forward_vjp_tile(b, len1, len2, hidden, wt, wtt, clamp, gd, first);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTileRows * c; idx += blockDim.x) {
      const int r = idx / c, col = idx % c;
      const long long m = row0 + r;
      if (m < m_total) store(dx + m * c + col, b.g[r * b.ldc + col]);
    }
    __syncthreads();
  }
}

// out[i] = sum over p < blocks, in order, of partials[p][i].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int blocks,
                       long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int p = 0; p < blocks; ++p) sum += partials[(long long)p * n + i];
    out[i] = sum;
  }
}

template <typename T, bool kInverse>
cudaError_t grid_blocks(long long m, int c, int len1, int hidden,
                        int* blocks) {
  const size_t smem = sizeof(float) * tile_floats(c, len1, hidden);
  auto kernel = coupling_1x1_bwd_kernel<T, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  const long long p = (long long)per_sm * sms;
  *blocks = (int)(tiles < p ? tiles : p);
  return cudaSuccess;
}

template <typename T, bool kInverse>
cudaError_t launch(const void* in, const void* g, void* dx, long long m,
                   int c, int len1, int hidden, const Weights& wt,
                   const WeightsT& wtt, float clamp, float* partials,
                   int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile_floats(c, len1, hidden);
  auto kernel = coupling_1x1_bwd_kernel<T, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<const T*>(g), static_cast<T*>(dx),
      m, c, len1, hidden, wt, wtt, clamp, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of the backward needs.
long long sininn_coupling_1x1_bwd_smem_bytes(int c, int len1, int hidden) {
  return (long long)sizeof(float) * tile_floats(c, len1, hidden);
}

// Floats in one block's slot of weight and bias gradient partials:
// [w2a (len2, H) | b2a (H) | w2b (H, 2 len1) | b2b (2 len1) | w1a (len1, H)
//  | b1a (H) | w1b (H, 2 len2) | b1b (2 len2)], weights (cin, cout).
long long sininn_coupling_1x1_bwd_slot_floats(int c, int len1, int hidden) {
  return slot_floats(c, len1, hidden);
}

// The number of blocks P the backward launches for m rows on the current
// device (as many as fit on its SMs at once, at most one per tile), written
// to *blocks. The partials buffer holds P slots. Returns a cudaError_t.
int sininn_coupling_1x1_bwd_blocks(int inverse, int bf16, long long m, int c,
                                   int len1, int hidden, int* blocks) {
  if (m <= 0 || len1 <= 0 || len1 >= c || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (bf16) {
    err = inverse ? grid_blocks<__nv_bfloat16, true>(m, c, len1, hidden, blocks)
                  : grid_blocks<__nv_bfloat16, false>(m, c, len1, hidden, blocks);
  } else {
    err = inverse ? grid_blocks<float, true>(m, c, len1, hidden, blocks)
                  : grid_blocks<float, false>(m, c, len1, hidden, blocks);
  }
  return (int)err;
}

// One launch of K3 (inverse = 0: in = x, g = dy, dx = dx) or K4 (inverse = 1:
// in = y, g = dx, dx = dy) on `stream`, over `blocks` blocks. in/g/dx:
// (m, c) row-major, fp32 (bf16 = 0) or bf16 (bf16 = 1). Weights fp32:
// w2a (len2, H), w2b (H, 2 len1), w1a (len1, H), w1b (H, 2 len2) row-major,
// and their (cout, cin) row-major copies w2a_t, w2b_t, w1a_t, w1b_t.
// partials: blocks x slot floats, written in full. Returns a cudaError_t.
int sininn_coupling_1x1_bwd(int inverse, int bf16, const void* in,
                            const void* g, void* dx, long long m, int c,
                            int len1, int hidden, const float* w2a,
                            const float* b2a, const float* w2b,
                            const float* b2b, const float* w1a,
                            const float* b1a, const float* w1b,
                            const float* b1b, const float* w2a_t,
                            const float* w2b_t, const float* w1a_t,
                            const float* w1b_t, float clamp, float* partials,
                            int blocks, void* stream) {
  if (m <= 0 || len1 <= 0 || len1 >= c || hidden <= 0 || blocks <= 0 ||
      (long long)blocks > (m + kTileRows - 1) / kTileRows)
    return (int)cudaErrorInvalidValue;
  const Weights wt{w2a, b2a, w2b, b2b, w1a, b1a, w1b, b1b};
  const WeightsT wtt{w2a_t, w2b_t, w1a_t, w1b_t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = inverse ? launch<__nv_bfloat16, true>(in, g, dx, m, c, len1, hidden,
                                                wt, wtt, clamp, partials,
                                                blocks, s)
                  : launch<__nv_bfloat16, false>(in, g, dx, m, c, len1, hidden,
                                                 wt, wtt, clamp, partials,
                                                 blocks, s);
  } else {
    err = inverse ? launch<float, true>(in, g, dx, m, c, len1, hidden, wt, wtt,
                                        clamp, partials, blocks, s)
                  : launch<float, false>(in, g, dx, m, c, len1, hidden, wt, wtt,
                                         clamp, partials, blocks, s);
  }
  return (int)err;
}

// out[i] = sum_{p < blocks} partials[p * n + i], summed in order of p.
int sininn_reduce_partials(const float* partials, int blocks, long long n,
                           float* out, void* stream) {
  if (blocks <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 4096) grid = 4096;
  reduce_partials_kernel<<<(unsigned)grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      partials, blocks, n, out);
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
