// Backward of the fused encoded coordinate MLP (the flow INR), constant
// mask, for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of sin_inn_tpu/ops/pallas/inr.py in
// its `const` mask mode with prog=False (`_fused_bwd_call`). For N points x
// (N, d), an encoding of E channels, L linear layers W_l (K_l, N_l), b_l
// (K_0 = E, hidden width H between, N_{L-1} = O outputs) and the output
// cotangent g (N, O), per tile of points:
//
//   recompute  a_0 = encode(x) * me          (me: a constant (E,) mask)
//              a_{l+1} = relu(a_l W_l + b_l)  for l < L - 1
//   then, from g_{L-1} = g, for l = L - 1 .. 0:
//              dW_l += a_l' g_l,  db_l += sum_rows g_l,
//              g_{l-1} = (g_l W_l') * [a_l > 0]
//
// Only the weight and bias gradients leave: nothing flows into x, the mask
// or the encoding. Encodings, with the arithmetic of the plain forward
// (`sin_inn_tpu_torch/ops/encodings.py`: the contraction over the d
// coordinates is a chain of fp32 multiply-adds):
//   rbf: exp(-max(|x|^2 + |c|^2 - 2 x.c, 0) sigma^2), c (E, d);
//   ff:  p = 2 pi x . F[:, f]; channels (2f, 2f + 1) = (sin p, cos p), the
//        interleaved layout of the plain forward (the TPU kernel's blocked
//        sin || cos layout with permuted W_0 rows answered the TPU's lanes
//        and is not carried over).
// In the bf16 operand mode (kBf16) the operands of every MLP product are
// rounded to bf16 and summed in fp32, as the TPU kernel's `_mm` does; the
// wrapper passes weights already rounded, activations are rounded where
// they are stored, cotangents where they are read (db sums them unrounded).
// The encoding is fp32 in both modes.
//
// What bounds it on an H100: arithmetic. At the flow path's shape
// (N = 446,464, E = 512, H = 256, three hidden layers, O = 4: 263,168
// weights) one launch does 2 N 263,168 FLOP for the recompute, the same for
// the weight gradients and 2 N 132,096 for the g chain: 588 GFLOP, 8.8 ms at
// the fp32 peak of 67 TFLOP/s, against about 15 MB of x, g, weights and
// gradients (0.004 ms).
//
// What the design does about it, and about the gradient sum:
// * A persistent grid of P blocks (one per SM: a tile takes about 164 KB of
//   shared memory) walks the 32-point tiles. a_0 .. a_{L-1} of the tile stay
//   in shared memory; g_l overwrites a_{l+1} in place once dW_{l+1} has read
//   it (the thread that writes g[r][k] is the one that reads a[r][k] > 0).
// * Every product runs on register tiles in fp32 FMA: 8 rows x 4 columns a
//   thread in the layer products, 8 x 4 weights a thread in the weight
//   gradients. A warp reads a row of activations as one broadcast float4 and
//   its weights or cotangents as consecutive float4, so shared memory sees
//   no bank conflicts and no padding is needed.
// * The TPU summed dW across its sequential grid into revisited blocks.
//   Here each block adds its tiles' products into its own slot of a scratch
//   buffer of P x S floats (S = all weights and biases; 263,940 at the
//   path's shape, 139 MB at P = 132, allocated by the wrapper): the first
//   tile writes the slot, later tiles add. No slot is shared: no atomics. The
//   reduction kernel of csrc/coupling_1x1_bwd.cu then sums the P slots in a
//   fixed order, so two launches give the same bits. The slot is read and
//   written once per tile (2.1 MB x 13,952 tiles = 29 GB at the path's
//   shape, far more than the 50 MB L2 holds): that traffic costs about as
//   much as the arithmetic bound and is the first thing a faster version
//   has to remove.
// * g W_l' reads a (N_l, K_l) copy of W_l made by the wrapper, so a warp
//   reads consecutive addresses there too.
// * Rows past N are zeros in g: they add nothing and nothing is stored.
// Tensor cores (wgmma on TF32 or bf16 operands) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // points per tile
constexpr int kRows = 8;        // rows per thread in a layer product
constexpr int kGradK = 8;       // weight-gradient rows per thread
constexpr int kMaxLayers = 8;
constexpr int kMaxDim = 4;

struct Net {
  int n_lin;                      // linear layers L (>= 2)
  int d, e, hidden, out;          // coordinate, encoding, hidden, output width
  const float* w[kMaxLayers];     // W_l (K_l, N_l) row-major
  const float* b[kMaxLayers];     // b_l (N_l)
  const float* wt[kMaxLayers];    // W_l' (N_l, K_l) row-major, 1 <= l < L - 1
  const float* enc_a;             // rbf: centres (E, d); ff: F (d, E / 2)
  const float* enc_b;             // rbf: |c|^2 (E)
  const float* enc_c;             // rbf: sigma^2 (E)
  const float* mask;              // me (E)
};

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <bool kBf16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<kBf16>(v.x), rnd<kBf16>(v.y), rnd<kBf16>(v.z),
                     rnd<kBf16>(v.w));
}

__host__ __device__ __forceinline__ int layer_k(const Net& n, int l) {
  return l == 0 ? n.e : n.hidden;
}
__host__ __device__ __forceinline__ int layer_n(const Net& n, int l) {
  return l == n.n_lin - 1 ? n.out : n.hidden;
}

// Where layer l's [dW_l | db_l] starts in a block's slot.
__host__ __device__ __forceinline__ long long slot_offset(const Net& n,
                                                          int l) {
  long long s = 0;
  for (int j = 0; j < l; ++j)
    s += (long long)layer_k(n, j) * layer_n(n, j) + layer_n(n, j);
  return s;
}

// Floats of one block's slot: [dW_0 | db_0 | dW_1 | db_1 | ...], rounded up
// to a multiple of 4 so that every slot starts on a float4.
__host__ __device__ __forceinline__ long long slot_floats(const Net& n) {
  return (slot_offset(n, n.n_lin) + 3) / 4 * 4;
}

// Floats of shared memory: a_0 (rows, E), a_1 .. a_{L-1} (rows, H) each, and
// the output cotangent (rows, O).
__host__ __device__ __forceinline__ long long tile_floats(const Net& n) {
  return (long long)kTileRows * (n.e + (n.n_lin - 1) * n.hidden + n.out);
}

__device__ __forceinline__ float* act_ptr(float* smem, const Net& n, int l) {
  return l == 0 ? smem
                : smem + kTileRows * n.e + (l - 1) * kTileRows * n.hidden;
}

// a_0 of the tile: the masked encoding of its points (zeros for x past N,
// which only meet zero cotangents).
template <bool kBf16, bool kRbf>
__device__ void encode_tile(const Net& n, const float* __restrict__ x,
                            long long row0, long long n_points, float* a0) {
  const int d = n.d;
  if (kRbf) {
    for (int idx = threadIdx.x; idx < kTileRows * n.e; idx += kThreads) {
      const int r = idx / n.e, e = idx % n.e;
      const long long m = row0 + r;
      float xv[kMaxDim];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        xv[k] = (k < d && m < n_points) ? __ldg(x + m * d + k) : 0.f;
      const float* c = n.enc_a + (size_t)e * d;
      float xc = __fmul_rn(xv[0], __ldg(c));
      float xx = __fmul_rn(xv[0], xv[0]);
#pragma unroll
      for (int k = 1; k < kMaxDim; ++k) {
        if (k < d) {
          xc = __fmaf_rn(xv[k], __ldg(c + k), xc);
          xx = __fadd_rn(xx, __fmul_rn(xv[k], xv[k]));
        }
      }
      float d2 = __fsub_rn(__fadd_rn(xx, __ldg(n.enc_b + e)),
                           __fmul_rn(2.f, xc));
      d2 = fmaxf(d2, 0.f);
      const float code = expf(__fmul_rn(-d2, __ldg(n.enc_c + e)));
      a0[idx] = rnd<kBf16>(__fmul_rn(code, __ldg(n.mask + e)));
    }
  } else {
    const int nf = n.e / 2;
    for (int idx = threadIdx.x; idx < kTileRows * nf; idx += kThreads) {
      const int r = idx / nf, f = idx % nf;
      const long long m = row0 + r;
      float xv[kMaxDim];
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        xv[k] = (k < d && m < n_points)
                    ? __fmul_rn(__ldg(x + m * d + k), 6.283185307179586f)
                    : 0.f;
      float p = __fmul_rn(xv[0], __ldg(n.enc_a + f));
#pragma unroll
      for (int k = 1; k < kMaxDim; ++k)
        if (k < d) p = __fmaf_rn(xv[k], __ldg(n.enc_a + (size_t)k * nf + f), p);
      float s, c;
      sincosf(p, &s, &c);
      a0[r * n.e + 2 * f] = rnd<kBf16>(__fmul_rn(s, __ldg(n.mask + 2 * f)));
      a0[r * n.e + 2 * f + 1] =
          rnd<kBf16>(__fmul_rn(c, __ldg(n.mask + 2 * f + 1)));
    }
  }
}

// epi(r, n0, v[4]) with v[q] = sum_k a[r][k] w[k][n0 + q] for every tile row
// r and every group of four columns n0 < N. a: shared memory (rows, K),
// rounded on the way in when kRoundA. w: (K, N) row-major, global. K and N
// are multiples of 4.
template <bool kRoundA, class Epi>
__device__ __forceinline__ void matmul_rows(const float* a, int K,
                                            const float* __restrict__ w,
                                            int N, Epi epi) {
  const int ncg = N / 4;
  const int items = (kTileRows / kRows) * ncg;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kRows;
    const float4* wp = reinterpret_cast<const float4*>(w) + cg;
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float4 wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = __ldg(wp + (size_t)(k + j) * ncg);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float4 av = *reinterpret_cast<const float4*>(a + (r0 + i) * K + k);
        if (kRoundA) av = rnd4<true>(av);
        const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(ak[j], wv[j].x, acc[i][0]);
          acc[i][1] = fmaf(ak[j], wv[j].y, acc[i][1]);
          acc[i][2] = fmaf(ak[j], wv[j].z, acc[i][2]);
          acc[i][3] = fmaf(ak[j], wv[j].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) epi(r0 + i, 4 * cg, acc[i]);
  }
}

// This tile's share of a weight gradient and its bias gradient:
// gw[k][n] (+)= sum_r a[r][k] dd[r][n] and gb[n] (+)= sum_r dd[r][n], for
// k < K, n < N (multiples of 4). a (rows, K) and dd (rows, N) in shared
// memory; dd is rounded on the way into the product when kRoundD, the bias
// sum takes it as stored. The block's first tile writes, later tiles add.
template <bool kRoundD>
__device__ void weight_grad(const float* a, int K, const float* dd, int N,
                            float* __restrict__ gw, float* __restrict__ gb,
                            bool first) {
  const int ncg = N / 4;
  const int nkg = (K + kGradK - 1) / kGradK;
  const int items = nkg * ncg;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int cg = item % ncg;
    const int k0 = (item / ncg) * kGradK;
    const bool hi = k0 + 4 < K;       // K is a multiple of 4, not always of 8
    float acc[kGradK][4];
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kGradK; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int r = 0; r < kTileRows; ++r) {
      const float4 dv = *reinterpret_cast<const float4*>(dd + r * N + 4 * cg);
      const float4 dr = kRoundD ? rnd4<true>(dv) : dv;
      const float4 a0 = *reinterpret_cast<const float4*>(a + r * K + k0);
      const float4 a1 = hi ? *reinterpret_cast<const float4*>(a + r * K + k0 + 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      const float ak[kGradK] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < kGradK; ++i) {
        acc[i][0] = fmaf(ak[i], dr.x, acc[i][0]);
        acc[i][1] = fmaf(ak[i], dr.y, acc[i][1]);
        acc[i][2] = fmaf(ak[i], dr.z, acc[i][2]);
        acc[i][3] = fmaf(ak[i], dr.w, acc[i][3]);
      }
      bias[0] += dv.x; bias[1] += dv.y; bias[2] += dv.z; bias[3] += dv.w;
    }
#pragma unroll
    for (int i = 0; i < kGradK; ++i) {
      if (i >= 4 && !hi) break;
      float4* p = reinterpret_cast<float4*>(gw + (size_t)(k0 + i) * N) + cg;
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (!first) {
        const float4 o = *p;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p = v;
    }
    if (k0 == 0) {
      float4* p = reinterpret_cast<float4*>(gb) + cg;
      float4 v = make_float4(bias[0], bias[1], bias[2], bias[3]);
      if (!first) {
        const float4 o = *p;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p = v;
    }
  }
}

// The last layer (H, O), O small: its gradients from the output cotangent
// go (rows, O), then g_{L-2} into a (rows, H) in place.
template <bool kBf16>
__device__ void last_layer(float* a, int H, const float* go, int O,
                           const float* __restrict__ w, float* __restrict__ gw,
                           float* __restrict__ gb, bool first) {
  for (int idx = threadIdx.x; idx < H * O; idx += kThreads) {
    const int k = idx / O, n = idx % O;
    float acc = 0.f;
    for (int r = 0; r < kTileRows; ++r)
      acc = fmaf(a[r * H + k], rnd<kBf16>(go[r * O + n]), acc);
    gw[idx] = first ? acc : gw[idx] + acc;
  }
  for (int n = threadIdx.x; n < O; n += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < kTileRows; ++r) acc += go[r * O + n];
    gb[n] = first ? acc : gb[n] + acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileRows * H; idx += kThreads) {
    const int r = idx / H, k = idx % H;
    float acc = 0.f;
    for (int n = 0; n < O; ++n)
      acc = fmaf(rnd<kBf16>(go[r * O + n]), __ldg(w + (size_t)k * O + n), acc);
    a[idx] = a[idx] > 0.f ? acc : 0.f;
  }
  __syncthreads();
}

template <bool kBf16, bool kRbf>
__global__ void __launch_bounds__(kThreads)
inr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               long long n_points, Net net, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  const int L = net.n_lin, H = net.hidden, O = net.out;
  float* go = smem + kTileRows * (net.e + (L - 1) * H);
  float* slot = partials + (long long)blockIdx.x * slot_floats(net);

  const long long tiles = (n_points + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    const bool first = tile == blockIdx.x;
    for (int idx = threadIdx.x; idx < kTileRows * O; idx += kThreads) {
      const long long m = row0 + idx / O;
      go[idx] = m < n_points ? __ldg(g + m * O + idx % O) : 0.f;
    }
    encode_tile<kBf16, kRbf>(net, x, row0, n_points, smem);
    __syncthreads();

    // recompute the hidden activations
    for (int l = 0; l < L - 1; ++l) {
      const float* a = act_ptr(smem, net, l);
      float* z = act_ptr(smem, net, l + 1);
      const float* bias = net.b[l];
      matmul_rows<false>(a, layer_k(net, l), net.w[l], H,
                         [&](int r, int n0, const float* v) {
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n0));
        float4 o;
        o.x = rnd<kBf16>(fmaxf(v[0] + bv.x, 0.f));
        o.y = rnd<kBf16>(fmaxf(v[1] + bv.y, 0.f));
        o.z = rnd<kBf16>(fmaxf(v[2] + bv.z, 0.f));
        o.w = rnd<kBf16>(fmaxf(v[3] + bv.w, 0.f));
        *reinterpret_cast<float4*>(z + r * H + n0) = o;
      });
      __syncthreads();
    }

    // the last layer, then the hidden layers downwards
    for (int l = L - 1; l >= 0; --l) {
      const int K = layer_k(net, l), N = layer_n(net, l);
      float* a = act_ptr(smem, net, l);
      float* gw = slot + slot_offset(net, l);
      float* gb = gw + (size_t)K * N;
      if (l == L - 1) {
        last_layer<kBf16>(a, H, go, O, net.w[l], gw, gb, first);
        continue;
      }
      float* gl = act_ptr(smem, net, l + 1);       // g_l, (rows, H)
      weight_grad<kBf16>(a, K, gl, N, gw, gb, first);
      __syncthreads();
      if (l == 0) break;
      // g_{l-1} = (g_l W_l') [a_l > 0], in place of a_l
      matmul_rows<kBf16>(gl, N, net.wt[l], K,
                         [&](int r, int k0, const float* v) {
        float4* p = reinterpret_cast<float4*>(a + r * K + k0);
        const float4 m = *p;
        *p = make_float4(m.x > 0.f ? v[0] : 0.f, m.y > 0.f ? v[1] : 0.f,
                         m.z > 0.f ? v[2] : 0.f, m.w > 0.f ? v[3] : 0.f);
      });
      __syncthreads();
    }
  }
}

cudaError_t check_net(const Net& n, long long n_points) {
  if (n_points <= 0 || n.n_lin < 2 || n.n_lin > kMaxLayers || n.d < 1 ||
      n.d > kMaxDim || n.e < 4 || n.e % 4 != 0 || n.hidden < 4 ||
      n.hidden % 4 != 0 || n.out < 1)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <bool kBf16, bool kRbf>
cudaError_t configure(const Net& n, int* per_sm) {
  const size_t smem = sizeof(float) * tile_floats(n);
  auto kernel = inr_bwd_kernel<kBf16, kRbf>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

cudaError_t configure(int bf16, int rbf, const Net& n, int* per_sm) {
  if (bf16) return rbf ? configure<true, true>(n, per_sm)
                       : configure<true, false>(n, per_sm);
  return rbf ? configure<false, true>(n, per_sm)
             : configure<false, false>(n, per_sm);
}

Net make_net(int n_lin, int d, int e, int hidden, int out,
             const float* const* w, const float* const* b,
             const float* const* wt, const float* enc_a, const float* enc_b,
             const float* enc_c, const float* mask) {
  Net n{};
  n.n_lin = n_lin; n.d = d; n.e = e; n.hidden = hidden; n.out = out;
  for (int l = 0; l < n_lin && l < kMaxLayers; ++l) {
    n.w[l] = w ? w[l] : nullptr;
    n.b[l] = b ? b[l] : nullptr;
    n.wt[l] = wt ? wt[l] : nullptr;
  }
  n.enc_a = enc_a; n.enc_b = enc_b; n.enc_c = enc_c; n.mask = mask;
  return n;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long sininn_inr_bwd_smem_bytes(int n_lin, int e, int hidden, int out) {
  const Net n = make_net(n_lin, 1, e, hidden, out, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr);
  return (long long)sizeof(float) * tile_floats(n);
}

// Floats in one block's slot of gradient partials:
// [dW_0 (E, H) | db_0 (H) | dW_1 (H, H) | db_1 | ... | dW_{L-1} (H, O) | db],
// rounded up to a multiple of 4 (the padding is never written).
long long sininn_inr_bwd_slot_floats(int n_lin, int e, int hidden, int out) {
  const Net n = make_net(n_lin, 1, e, hidden, out, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr);
  return slot_floats(n);
}

// The number of blocks P the backward launches for n_points on the current
// device (as many as fit on its SMs at once, at most one per tile), written
// to *blocks. The partials buffer holds P slots. Returns a cudaError_t.
int sininn_inr_bwd_blocks(int bf16, int rbf, long long n_points, int n_lin,
                          int d, int e, int hidden, int out, int* blocks) {
  const Net n = make_net(n_lin, d, e, hidden, out, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr);
  cudaError_t err = check_net(n, n_points);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, dev = 0;
  err = configure(bf16, rbf, n, &per_sm);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n_points + kTileRows - 1) / kTileRows;
  const long long p = (long long)per_sm * sms;
  *blocks = (int)(tiles < p ? tiles : p);
  return (int)cudaSuccess;
}

// One launch on `stream`, over `blocks` blocks. x: (n_points, d), g:
// (n_points, out), fp32 contiguous. w, b: n_lin pointers each, W_l (K_l, N_l)
// row-major and b_l; wt: n_lin pointers, W_l' (N_l, K_l) row-major for
// 1 <= l < n_lin - 1 (the others unused). rbf = 1: enc_a = centres (e, d),
// enc_b = |c|^2 (e), enc_c = sigma^2 (e); rbf = 0: enc_a = F (d, e / 2),
// enc_b and enc_c unused. mask: (e). bf16 = 1: bf16 operands in the MLP
// products (weights passed already rounded). partials: blocks x slot floats,
// written in full. Returns a cudaError_t.
int sininn_inr_bwd(int bf16, int rbf, const float* x, const float* g,
                   long long n_points, int n_lin, int d, int e, int hidden,
                   int out, const float* const* w, const float* const* b,
                   const float* const* wt, const float* enc_a,
                   const float* enc_b, const float* enc_c, const float* mask,
                   float* partials, int blocks, void* stream) {
  const Net n = make_net(n_lin, d, e, hidden, out, w, b, wt, enc_a, enc_b,
                         enc_c, mask);
  cudaError_t err = check_net(n, n_points);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0 ||
      (long long)blocks > (n_points + kTileRows - 1) / kTileRows)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  err = configure(bf16, rbf, n, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * tile_floats(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (rbf) inr_bwd_kernel<true, true><<<blocks, kThreads, smem, s>>>(
        x, g, n_points, n, partials);
    else inr_bwd_kernel<true, false><<<blocks, kThreads, smem, s>>>(
        x, g, n_points, n, partials);
  } else {
    if (rbf) inr_bwd_kernel<false, true><<<blocks, kThreads, smem, s>>>(
        x, g, n_points, n, partials);
    else inr_bwd_kernel<false, false><<<blocks, kThreads, smem, s>>>(
        x, g, n_points, n, partials);
  }
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
