// Backward of the fused encoded coordinate MLP (the flow INR), for sm_90a.
//
// Replaces the TPU kernel `_bwd_kernel` of sin_inn_tpu/ops/pallas/inr.py
// (`_fused_bwd_call`) in its three mask modes, with and without the
// coordinate rows of a progressive net. The net, its encodings, the mask
// modes and the bf16 operand mode are set out in inr_common.cuh. For the
// output cotangent g (N, O), per tile of points:
//
//   recompute  a_0 .. a_{L-1} (and xm) as the forward does
//   then, from g_{L-1} = g, for l = L - 1 .. 0:
//              dW_l += a_l' g_l,  db_l += sum_rows g_l,
//              g_{l-1} = (g_l W_l') * [a_l > 0]
//   and for a progressive net  dwc += xm' g_0.
//
// Only the weight and bias gradients leave: nothing flows into x, the mask
// or the encoding. In the bf16 operand mode cotangents are rounded where
// they are read (db sums them unrounded).
//
// What bounds it on an H100: arithmetic. At the flow path's shape
// (N = 446,464, E = 512, H = 256, three hidden layers, O = 4: 263,168
// weights) one launch does 2 N 263,168 FLOP for the recompute, the same for
// the weight gradients and 2 N 132,096 for the g chain: 588 GFLOP, 8.8 ms at
// the fp32 peak of 67 TFLOP/s, against about 15 MB of x, g, weights and
// gradients (0.004 ms). A progressive net adds 4 N d H FLOP for the
// coordinate rows; slab mode adds the mask rebuild (2 N E FLOP per non-zero
// column of wx) and 45 MB of slabs at res 50; point mode streams the 914 MB
// mask (0.27 ms).
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
//   has to remove. A progressive net's slot starts with dwc (d, H), so that
//   [dwc | dW_0] is the gradient of its whole first layer.
// * g W_l' reads a (N_l, K_l) copy of W_l made by the wrapper, so a warp
//   reads consecutive addresses there too.
// * Rows past N are zeros in g: they add nothing and nothing is stored.
// * The mask mode and the coordinate rows are template parameters: the
//   constant-mask kernel of a non-progressive net carries none of their
//   code.
// Tensor cores (wgmma on TF32 or bf16 operands) and TMA are later work.

#include "inr_common.cuh"

namespace {

using namespace inr;

constexpr int kGradK = 8;       // weight-gradient rows per thread

// Rows in front of dW_0 in a slot: the coordinate rows' gradient.
__host__ __device__ __forceinline__ long long coord_floats(const Net& n) {
  return n.prog ? (long long)n.d * n.hidden : 0;
}

// Where layer l's [dW_l | db_l] starts in a block's slot.
__host__ __device__ __forceinline__ long long slot_offset(const Net& n,
                                                          int l) {
  long long s = coord_floats(n);
  for (int j = 0; j < l; ++j)
    s += (long long)layer_k(n, j) * layer_n(n, j) + layer_n(n, j);
  return s;
}

// Floats of one block's slot: [dwc | dW_0 | db_0 | dW_1 | db_1 | ...],
// rounded up to a multiple of 4 so that every slot starts on a float4.
__host__ __device__ __forceinline__ long long slot_floats(const Net& n) {
  return (slot_offset(n, n.n_lin) + 3) / 4 * 4;
}

// Floats of shared memory: a_0 (rows, E), a_1 .. a_{L-1} (rows, H) each, the
// output cotangent (rows, O), then xm and the rows of wx where there are any.
__host__ __device__ __forceinline__ long long act_floats(const Net& n) {
  return (long long)kTileRows * (n.e + (n.n_lin - 1) * n.hidden + n.out);
}
__host__ __device__ __forceinline__ long long tile_floats(const Net& n) {
  return act_floats(n) + extra_floats(n);
}

__device__ __forceinline__ float* act_ptr(float* smem, const Net& n, int l) {
  return l == 0 ? smem
                : smem + kTileRows * n.e + (l - 1) * kTileRows * n.hidden;
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
    // an explicit factor, as in matmul_rows (inr_common.cuh)
#pragma unroll 2
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

// The coordinate rows' share: gwc[k][n] (+)= sum_r xm[r][k] dd[r][n] for
// k < d, n < H. xm (rows, 4) and dd (rows, H) in shared memory.
template <bool kRoundD>
__device__ void coord_grad(const float* xm, int d, const float* dd, int H,
                           float* __restrict__ gwc, bool first) {
  for (int idx = threadIdx.x; idx < d * H; idx += kThreads) {
    const int k = idx / H, n = idx % H;
    float acc = 0.f;
    for (int r = 0; r < kTileRows; ++r)
      acc = fmaf(xm[r * kMaxDim + k], rnd<kRoundD>(dd[r * H + n]), acc);
    gwc[idx] = first ? acc : gwc[idx] + acc;
  }
}

template <bool kBf16, bool kRbf, int kVariant>
__global__ void __launch_bounds__(kThreads)
inr_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
               long long n_points, Net net, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kProg = variant_prog(kVariant);
  const int L = net.n_lin, H = net.hidden, O = net.out;
  float* go = smem + kTileRows * (net.e + (L - 1) * H);
  float* xm = smem + act_floats(net);
  float* wxs = xm + (kProg ? kTileRows * kMaxDim : 0);
  float* slot = partials + (long long)blockIdx.x * slot_floats(net);

  const long long tiles = (n_points + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    const bool first = tile == blockIdx.x;
    for (int idx = threadIdx.x; idx < kTileRows * O; idx += kThreads) {
      const long long m = row0 + idx / O;
      go[idx] = m < n_points ? __ldg(g + m * O + idx % O) : 0.f;
    }
    prepare_tile<kBf16, kRbf, kVariant>(net, x, row0, n_points, smem, xm,
                                        wxs);

    // recompute the hidden activations
    for (int l = 0; l < L - 1; ++l) {
      hidden_layer<kBf16, kProg>(net, act_ptr(smem, net, l), layer_k(net, l),
                                 net.w[l], net.b[l], act_ptr(smem, net, l + 1),
                                 l == 0, xm);
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
      if (kProg && l == 0) coord_grad<kBf16>(xm, net.d, gl, N, slot, first);
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

// Sets the kernel's shared memory and reports how many blocks an SM holds.
cudaError_t configure(int bf16, int rbf, int variant, const Net& n,
                      int* per_sm) {
  const size_t smem = sizeof(float) * tile_floats(n);
  return dispatch(bf16, rbf, variant, [&](auto b, auto r, auto v) {
    auto kernel = inr_bwd_kernel<decltype(b)::value, decltype(r)::value,
                                 decltype(v)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                         kThreads, smem);
  });
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long sininn_inr_bwd_smem_bytes(int n_lin, int e, int hidden, int out,
                                    int prog, int res) {
  return (long long)sizeof(float) *
         tile_floats(shape_net(prog, n_lin, 1, e, hidden, out, res, 0));
}

// Floats in one block's slot of gradient partials:
// [dwc (d, H) if prog | dW_0 (E, H) | db_0 (H) | dW_1 (H, H) | db_1 | ... |
// dW_{L-1} (H, O) | db], rounded up to a multiple of 4 (the padding is never
// written).
long long sininn_inr_bwd_slot_floats(int n_lin, int d, int e, int hidden,
                                     int out, int prog) {
  return slot_floats(shape_net(prog, n_lin, d, e, hidden, out, 0, 0));
}

// The number of blocks P the backward launches for n_points on the current
// device (as many as fit on its SMs at once, at most one per tile), written
// to *blocks. The partials buffer holds P slots. mode: 0 const, 1 point, 2
// slab. Returns a cudaError_t.
int sininn_inr_bwd_blocks(int bf16, int rbf, int mode, int prog,
                          long long n_points, int n_lin, int d, int e,
                          int hidden, int out, int res, int w_img,
                          int* blocks) {
  const Net n = shape_net(prog, n_lin, d, e, hidden, out, res, w_img);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0, dev = 0;
  err = configure(bf16, rbf, variant_of(mode, prog), n, &per_sm);
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
// row-major (W_0: its E encoding rows) and b_l; wt: n_lin pointers, W_l'
// (N_l, K_l) row-major for 1 <= l < n_lin - 1 (the others unused). rbf = 1:
// enc_a = centres (e, d), enc_b = |c|^2 (e), enc_c = sigma^2 (e); rbf = 0:
// enc_a = F (d, e / 2), enc_b and enc_c unused. me, mc, wx by mode: const me
// (e), mc (d); point me (n_points, e), mc (d, n_points); slab me (rows, res,
// e), mc (rows, res, d), wx (w_img, res) with rows x w_img = n_points and
// w_img a multiple of 32. prog = 1: wc (d, hidden), the coordinate rows (mc
// and wc unused otherwise). bf16 = 1: bf16 operands in the products (weights,
// slabs and wx passed already rounded). partials: blocks x slot floats,
// written in full. Returns a cudaError_t.
int sininn_inr_bwd(int bf16, int rbf, int mode, int prog, long long n_points,
                   int n_lin, int d, int e, int hidden, int out, int res,
                   int w_img, const float* x, const float* const* w,
                   const float* const* b, const float* const* wt,
                   const float* enc_a, const float* enc_b, const float* enc_c,
                   const float* me, const float* mc, const float* wx,
                   const float* wc, const float* g, float* partials,
                   int blocks, void* stream) {
  const Net n = make_net(prog, n_lin, d, e, hidden, out, res, w_img, w, b, wt,
                         enc_a, enc_b, enc_c, me, mc, wx, wc);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  if (blocks <= 0 ||
      (long long)blocks > (n_points + kTileRows - 1) / kTileRows)
    return (int)cudaErrorInvalidValue;
  const int variant = variant_of(mode, prog);
  int per_sm = 0;
  err = configure(bf16, rbf, variant, n, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * tile_floats(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, rbf, variant, [&](auto bb, auto r, auto v) {
    inr_bwd_kernel<decltype(bb)::value, decltype(r)::value,
                   decltype(v)::value><<<blocks, kThreads, smem, s>>>(
        x, g, n_points, n, partials);
    return cudaGetLastError();
  });
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
