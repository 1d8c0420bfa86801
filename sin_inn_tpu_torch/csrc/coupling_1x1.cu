// Fused GLOW coupling with 1x1-conv subnets, forward and inverse, for sm_90a.
//
// Replaces the TPU kernels `_coupling_fwd_kernel` and `_coupling_inv_kernel`
// of sin_inn_tpu/ops/pallas/coupling.py. Per pixel (one row of the (M, C)
// input), with x = [x1 | x2], len1 + len2 = C and hidden width H:
//
//   forward:  r2 = W2b relu(W2a x2 + b2a) + b2b;  y1 = exp(le(s2)) x1 + t2
//             r1 = W1b relu(W1a y1 + b1a) + b1b;  y2 = exp(le(s1)) x2 + t1
//   inverse:  the same subnet expressions in the mirrored order,
//             x2 = (y2 - t1) exp(-le(s1)),  x1 = (y1 - t2) exp(-le(s2))
//
// with r = [s | t] and le(s) = clamp (2/pi) atan(s / clamp). Both directions
// run the same device functions, so the inverse stays an exact inverse of the
// forward up to fp32 rounding. Math is fp32; storage is fp32 or bf16.
//
// What bounds it on an H100: arithmetic. At the flagship SRF shapes one
// launch does 12 * L * H FLOP per pixel (L = C / 2): about 41.5 GFLOP against
// about 216 MB of input and output, some 190 FLOP per byte, far above the
// card's fp32 balance point (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte).
//
// What the design does about it: the TPU kernel held every weight in VMEM.
// At C = 192 the weights are about 590 KB, more than a block's 227 KB of
// shared memory, so here a block holds only one tile of activations (64
// pixels: the input tile and the H-wide hidden layer, about 115 KB at
// C = 192) and streams the weights from L2 and L1, where all of them stay
// resident. Only x is read from and y written to device memory. Each thread
// keeps a register tile of outputs (8 rows x 4 columns in the hidden layer,
// 2 rows x 4 channel pairs (s, t) in the scale/shift layer), so every weight
// it loads feeds several FMAs. The ragged last tile is masked, not padded.
// Tensor cores (TF32 wgmma, or 3xTF32 for fp32 accuracy) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;    // pixels per block
constexpr int kHiddenRows = 8;   // rows per thread in the hidden layer
constexpr int kAffineRows = 2;   // rows per thread in the scale/shift layer
constexpr int kCols = 4;         // columns (or channel pairs) per thread

struct Weights {
  const float *w2a, *b2a, *w2b, *b2b, *w1a, *b1a, *w1b, *b1b;
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

// Odd row strides keep the rows of a tile on different shared-memory banks.
__host__ __device__ __forceinline__ int padded(int n) { return n | 1; }

// h[r][n] = relu(sum_k a[r][k] w[k][n] + b[n]) for the tile's rows.
// a: shared memory, row stride lda, k < K. w: (K, H) row-major, global.
__device__ void hidden_layer(const float* a, int lda, int K,
                             const float* __restrict__ w,
                             const float* __restrict__ b, int H,
                             float* h, int ldh) {
  const int ncg = (H + kCols - 1) / kCols;
  const int items = (kTileRows / kHiddenRows) * ncg;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kHiddenRows;
    // columns cg, cg + ncg, ...: a warp reads 32 consecutive weights at once
    int col[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[q] = min(cg + q * ncg, H - 1);
    float acc[kHiddenRows][kCols];
#pragma unroll
    for (int i = 0; i < kHiddenRows; ++i)
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[i][q] = 0.f;
    for (int k = 0; k < K; ++k) {
      float wv[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) wv[q] = __ldg(w + (size_t)k * H + col[q]);
#pragma unroll
      for (int i = 0; i < kHiddenRows; ++i) {
        const float av = a[(r0 + i) * lda + k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[i][q] = fmaf(av, wv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (cg + q * ncg >= H) continue;
      const float bv = __ldg(b + col[q]);
#pragma unroll
      for (int i = 0; i < kHiddenRows; ++i)
        h[(r0 + i) * ldh + col[q]] = fmaxf(acc[i][q] + bv, 0.f);
    }
  }
}

// r = h w + b with w: (H, 2L) row-major; s = r[:, j], t = r[:, L + j].
// Forward:  v[j] = exp(le(s)) v[j] + t.  Inverse: v[j] = (v[j] - t) exp(-le(s)).
template <bool kInverse>
__device__ void affine_layer(const float* h, int ldh, int H,
                             const float* __restrict__ w,
                             const float* __restrict__ b, int L,
                             float* v, int ldv, float clamp) {
  const int n = 2 * L;
  const int ncg = (L + kCols - 1) / kCols;
  const int items = (kTileRows / kAffineRows) * ncg;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kAffineRows;
    int col[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) col[q] = min(cg + q * ncg, L - 1);
    float s[kAffineRows][kCols], t[kAffineRows][kCols];
#pragma unroll
    for (int i = 0; i < kAffineRows; ++i)
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
      for (int i = 0; i < kAffineRows; ++i) {
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
      for (int i = 0; i < kAffineRows; ++i) {
        const float le = log_e(s[i][q] + bs, clamp);
        const float tv = t[i][q] + bt;
        float* p = v + (r0 + i) * ldv + col[q];
        *p = kInverse ? (*p - tv) * expf(-le) : expf(le) * *p + tv;
      }
    }
  }
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads)
coupling_1x1_kernel(const T* __restrict__ in, T* __restrict__ out,
                    long long m_total, int c, int len1, int hidden,
                    Weights wt, float clamp) {
  extern __shared__ float smem[];
  const int ldx = padded(c);
  const int ldh = padded(hidden);
  float* xs = smem;                     // kTileRows x ldx: the pixel tile
  float* hs = smem + kTileRows * ldx;   // kTileRows x ldh: the hidden layer
  const int len2 = c - len1;
  const long long row0 = (long long)blockIdx.x * kTileRows;

  // rows past m_total are zeros: computed, never stored
  for (int idx = threadIdx.x; idx < kTileRows * c; idx += blockDim.x) {
    const int r = idx / c, col = idx % c;
    const long long m = row0 + r;
    xs[r * ldx + col] = m < m_total ? to_float(in[m * c + col]) : 0.f;
  }
  __syncthreads();

  if (!kInverse) {
    hidden_layer(xs + len1, ldx, len2, wt.w2a, wt.b2a, hidden, hs, ldh);
    __syncthreads();
    affine_layer<false>(hs, ldh, hidden, wt.w2b, wt.b2b, len1, xs, ldx, clamp);
    __syncthreads();
    hidden_layer(xs, ldx, len1, wt.w1a, wt.b1a, hidden, hs, ldh);
    __syncthreads();
    affine_layer<false>(hs, ldh, hidden, wt.w1b, wt.b1b, len2, xs + len1, ldx,
                        clamp);
  } else {
    hidden_layer(xs, ldx, len1, wt.w1a, wt.b1a, hidden, hs, ldh);
    __syncthreads();
    affine_layer<true>(hs, ldh, hidden, wt.w1b, wt.b1b, len2, xs + len1, ldx,
                       clamp);
    __syncthreads();
    hidden_layer(xs + len1, ldx, len2, wt.w2a, wt.b2a, hidden, hs, ldh);
    __syncthreads();
    affine_layer<true>(hs, ldh, hidden, wt.w2b, wt.b2b, len1, xs, ldx, clamp);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTileRows * c; idx += blockDim.x) {
    const int r = idx / c, col = idx % c;
    const long long m = row0 + r;
    if (m < m_total) store(out + m * c + col, xs[r * ldx + col]);
  }
}

template <typename T, bool kInverse>
cudaError_t launch(const void* in, void* out, long long m, int c, int len1,
                   int hidden, const Weights& wt, float clamp,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * kTileRows * (size_t)(padded(c) + padded(hidden));
  auto kernel = coupling_1x1_kernel<T, kInverse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (m + kTileRows - 1) / kTileRows;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), m, c, len1, hidden, wt,
      clamp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for c channels and the
// given hidden width.
long long sininn_coupling_1x1_smem_bytes(int c, int hidden) {
  return (long long)sizeof(float) * kTileRows * (padded(c) + padded(hidden));
}

// One launch of the forward (inverse = 0) or inverse (inverse = 1) coupling
// on `stream`. in/out: (m, c) row-major, fp32 (bf16 = 0) or bf16 (bf16 = 1).
// Weights fp32, row-major: w2a (len2, hidden), w2b (hidden, 2 len1),
// w1a (len1, hidden), w1b (hidden, 2 len2). Returns a cudaError_t.
int sininn_coupling_1x1(int inverse, int bf16, const void* in, void* out,
                        long long m, int c, int len1, int hidden,
                        const float* w2a, const float* b2a, const float* w2b,
                        const float* b2b, const float* w1a, const float* b1a,
                        const float* w1b, const float* b1b, float clamp,
                        void* stream) {
  if (m <= 0 || len1 <= 0 || len1 >= c || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  const Weights wt{w2a, b2a, w2b, b2b, w1a, b1a, w1b, b1b};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = inverse ? launch<__nv_bfloat16, true>(in, out, m, c, len1, hidden, wt, clamp, s)
                  : launch<__nv_bfloat16, false>(in, out, m, c, len1, hidden, wt, clamp, s);
  } else {
    err = inverse ? launch<float, true>(in, out, m, c, len1, hidden, wt, clamp, s)
                  : launch<float, false>(in, out, m, c, len1, hidden, wt, clamp, s);
  }
  return (int)err;
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
