// What the forward and the backward kernels of the fused encoded coordinate
// MLP (the flow INR) share: the net's description and the tile's encoding
// under each mask mode; and the forward's layer product on register tiles.
//
// The net. N points x (N, d), an encoding of E channels, L linear layers
// W_l (K_l, N_l), b_l (K_0 = E, hidden width H between, N_{L-1} = O
// outputs). A progressive net also feeds the raw coordinates to the first
// layer through d more rows wc (d, H), under their own mask mc:
//
//   a_0 = encode(x) * me          xm = x * mc
//   a_1 = relu(a_0 W_0 + xm wc + b_0)
//   a_{l+1} = relu(a_l W_l + b_l),  out = a_{L-1} W_{L-1} + b_{L-1}
//
// Encodings, with the arithmetic of the plain forward
// (`sin_inn_tpu_torch/ops/encodings.py`: the contraction over the d
// coordinates is a chain of fp32 multiply-adds):
//   rbf: exp(-max(|x|^2 + |c|^2 - 2 x.c, 0) sigma^2), c (E, d);
//   ff:  p = 2 pi x . F[:, f]; channels (2f, 2f + 1) = (sin p, cos p), the
//        interleaved layout of the plain forward (the TPU kernel's blocked
//        sin || cos layout with permuted W_0 rows answered the TPU's lanes
//        and is not carried over).
//
// Mask modes (`_mask_values` of sin_inn_tpu/ops/pallas/inr.py):
//   const: me (E) and mc (d), the same for every point;
//   point: me (N, E) and mc (d, N) streamed per point;
//   slab:  the points are the rows of images of width W (a multiple of the
//          tile's 32 points, so a tile lies in one image row s); the mask of
//          the tile's points is rebuilt on chip from the row's slabs,
//          me[w][e] = sum_j wx[w][j] slab_e[s][j][e] (slab_e (rows, res, E)),
//          mc[w][k] = sum_j wx[w][j] slab_c[s][j][k] (slab_c (rows, res, d)),
//          with wx (W, res) the x-axis hat weights. A row's slab (res x E
//          floats, 102 KB at res 50, E 512) does not fit beside the tile in
//          shared memory: it is read through L2, which the blocks of one
//          image row share (a persistent grid walks neighbouring tiles at
//          the same time). wx has a handful of non-zero columns per tile
//          (two hat taps spread by the box blur); the others are skipped.
//
// In the bf16 operand mode (kBf16) the operands of every product are rounded
// to bf16 and summed in fp32, as the TPU kernel's `_mm` does; the wrapper
// passes weights, slabs and wx already rounded, activations and xm are
// rounded where they are stored. The encoding is fp32 in both modes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace inr {

constexpr int kThreads = 256;
constexpr int kTileRows = 32;   // points per tile
constexpr int kRows = 8;        // rows per thread in a layer product
constexpr int kMaxLayers = 8;
constexpr int kMaxDim = 4;

// Mask modes, as the wrapper numbers them.
constexpr int kConst = 0, kPoint = 1, kSlab = 2;
// Kernel variants: a mask mode with or without the coordinate rows. The
// per-point modes exist for progressive nets only.
constexpr int kVarConst = 0, kVarConstProg = 1, kVarPoint = 2, kVarSlab = 3;

__host__ __device__ constexpr bool variant_prog(int v) { return v != kVarConst; }

struct Net {
  int n_lin;                      // linear layers L (>= 2)
  int d, e, hidden, out;          // coordinate, encoding, hidden, output width
  int prog;                       // 1: coordinate rows in front of W_0
  int res, w_img;                 // slab mode: cells per axis, image width W
  const float* w[kMaxLayers];     // W_l (K_l, N_l) row-major (W_0: E rows)
  const float* b[kMaxLayers];     // b_l (N_l)
  const float* enc_a;             // rbf: centres (E, d); ff: F (d, E / 2)
  const float* enc_b;             // rbf: |c|^2 (E)
  const float* enc_c;             // rbf: sigma^2 (E)
  const float* mask;              // me: (E) | (N, E) | slabs (rows, res, E)
  const float* mc;                // (d) | (d, N) | slabs (rows, res, d)
  const float* wx;                // slab mode: (W, res)
  const float* wc;                // prog: coordinate rows (d, H)
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

// Floats of shared memory a tile needs beside its activations: the masked
// coordinates xm (rows, 4) of a progressive net and, in slab mode, the
// tile's rows of wx (rows, res) with one flag per column.
__host__ __device__ __forceinline__ long long extra_floats(const Net& n) {
  return (n.prog ? kTileRows * kMaxDim : 0) +
         (n.res > 0 ? (long long)(kTileRows + 1) * n.res : 0);
}

// Slab mode, step 1: the tile's rows of wx into shared memory, and per
// column whether any of them is non-zero. Ends synchronised.
__device__ __forceinline__ void load_wx_tile(const Net& n, long long row0,
                                             float* wxs) {
  const int res = n.res;
  const long long w0 = row0 % n.w_img;
  for (int idx = threadIdx.x; idx < kTileRows * res; idx += kThreads)
    wxs[idx] = __ldg(n.wx + w0 * res + idx);
  __syncthreads();
  float* flags = wxs + kTileRows * res;
  for (int j = threadIdx.x; j < res; j += kThreads) {
    bool any = false;
    for (int r = 0; r < kTileRows; ++r) any = any || wxs[r * res + j] != 0.f;
    flags[j] = any ? 1.f : 0.f;
  }
  __syncthreads();
}

// Slab mode, step 2: a0[r][e] = sum_j wxs[r][j] slab[j][e], the encoding
// channels' mask of the tile. Each thread owns 8 rows x 4 columns; a warp
// reads a slab row as consecutive float4 and the weights as broadcasts.
__device__ __forceinline__ void slab_mask_tile(const Net& n, long long row0,
                                               const float* wxs, float* a0) {
  const int res = n.res, E = n.e;
  const float* flags = wxs + kTileRows * res;
  const float* slab = n.mask + (row0 / n.w_img) * (long long)res * E;
  const int ncg = E / 4;
  const int items = (kTileRows / kRows) * ncg;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int cg = item % ncg;
    const int r0 = (item / ncg) * kRows;
    float acc[kRows][4];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
    for (int j = 0; j < res; ++j) {
      if (flags[j] == 0.f) continue;
      const float4 sv =
          __ldg(reinterpret_cast<const float4*>(slab + (size_t)j * E) + cg);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float wv = wxs[(r0 + i) * res + j];
        acc[i][0] = fmaf(wv, sv.x, acc[i][0]);
        acc[i][1] = fmaf(wv, sv.y, acc[i][1]);
        acc[i][2] = fmaf(wv, sv.z, acc[i][2]);
        acc[i][3] = fmaf(wv, sv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      *reinterpret_cast<float4*>(a0 + (r0 + i) * E + 4 * cg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The encoding channel's mask at tile row r (point m), channel e. In slab
// mode a0 holds it (slab_mask_tile), at the element that is about to be
// overwritten by the same thread.
template <int kVariant>
__device__ __forceinline__ float mask_at(const Net& n, const float* a0, int r,
                                         int e, long long m,
                                         long long n_points) {
  if (kVariant == kVarPoint)
    return m < n_points ? __ldg(n.mask + m * n.e + e) : 0.f;
  if (kVariant == kVarSlab) return a0[r * n.e + e];
  return __ldg(n.mask + e);
}

// a_0 of the tile: the masked encoding of its points (zeros for x past N,
// which only meet zero cotangents or are never stored), and for a
// progressive net xm (rows, 4): the masked coordinates, zero-padded.
template <bool kBf16, bool kRbf, int kVariant>
__device__ void encode_tile(const Net& n, const float* __restrict__ x,
                            long long row0, long long n_points, float* a0,
                            float* xm, const float* wxs) {
  const int d = n.d;
  if (variant_prog(kVariant)) {
    for (int idx = threadIdx.x; idx < kTileRows * kMaxDim; idx += kThreads) {
      const int r = idx / kMaxDim, k = idx % kMaxDim;
      const long long m = row0 + r;
      float v = 0.f;
      if (k < d && m < n_points) {
        float mc;
        if (kVariant == kVarPoint) {
          mc = __ldg(n.mc + (long long)k * n_points + m);
        } else if (kVariant == kVarSlab) {
          const float* slab = n.mc + (row0 / n.w_img) * (long long)n.res * d;
          mc = 0.f;
          for (int j = 0; j < n.res; ++j)
            mc = fmaf(wxs[r * n.res + j], __ldg(slab + j * d + k), mc);
        } else {
          mc = __ldg(n.mc + k);
        }
        v = rnd<kBf16>(__fmul_rn(__ldg(x + m * d + k), mc));
      }
      xm[idx] = v;
    }
  }
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
      a0[idx] = rnd<kBf16>(
          __fmul_rn(code, mask_at<kVariant>(n, a0, r, e, m, n_points)));
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
      a0[r * n.e + 2 * f] = rnd<kBf16>(__fmul_rn(
          s, mask_at<kVariant>(n, a0, r, 2 * f, m, n_points)));
      a0[r * n.e + 2 * f + 1] = rnd<kBf16>(__fmul_rn(
          c, mask_at<kVariant>(n, a0, r, 2 * f + 1, m, n_points)));
    }
  }
}

// The tile's mask and encoding, whatever the mode: in slab mode the rows of
// wx and the rebuilt mask first. Ends synchronised.
template <bool kBf16, bool kRbf, int kVariant>
__device__ __forceinline__ void prepare_tile(const Net& n,
                                             const float* __restrict__ x,
                                             long long row0,
                                             long long n_points, float* a0,
                                             float* xm, float* wxs) {
  if (kVariant == kVarSlab) {
    load_wx_tile(n, row0, wxs);
    slab_mask_tile(n, row0, wxs, a0);
    __syncthreads();
  }
  encode_tile<kBf16, kRbf, kVariant>(n, x, row0, n_points, a0, xm, wxs);
  __syncthreads();
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
    // An explicit factor: left to the compiler's own choice, the unrolling
    // of this loop, and with it the registers (75 to 114) and the time of a
    // launch (51 to 66 ms in the backward), changed from one instantiation
    // of the kernels to the next.
#pragma unroll 2
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

// relu(v + [xm wc] + bias) for four columns of a hidden layer, rounded for
// the next product in the bf16 mode; with kCoord the coordinate rows'
// product joins (the first layer of a progressive net).
template <bool kBf16, bool kCoord>
__device__ __forceinline__ float4 hidden_out(const Net& n, const float* v,
                                             const float* bias, int n0,
                                             const float* xm, int r) {
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + n0));
  float z[4] = {v[0], v[1], v[2], v[3]};
  if (kCoord) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < n.d; ++k) {
      const float xk = xm[r * kMaxDim + k];
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(n.wc + (size_t)k * n.hidden +
                                                n0));
      c[0] = fmaf(xk, wv.x, c[0]);
      c[1] = fmaf(xk, wv.y, c[1]);
      c[2] = fmaf(xk, wv.z, c[2]);
      c[3] = fmaf(xk, wv.w, c[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] += c[q];
  }
  float4 o;
  o.x = rnd<kBf16>(fmaxf(z[0] + bv.x, 0.f));
  o.y = rnd<kBf16>(fmaxf(z[1] + bv.y, 0.f));
  o.z = rnd<kBf16>(fmaxf(z[2] + bv.z, 0.f));
  o.w = rnd<kBf16>(fmaxf(z[3] + bv.w, 0.f));
  return o;
}

// One hidden layer of the tile: z = relu(a W + [xm wc] + bias), (rows, K) ->
// (rows, H), both in shared memory. coord_rows is a constant false in the
// kernels of non-progressive nets, which then carry one product only.
template <bool kBf16, bool kProg>
__device__ __forceinline__ void hidden_layer(const Net& n, const float* a,
                                             int K, const float* w,
                                             const float* bias, float* z,
                                             bool first, const float* xm) {
  const int H = n.hidden;
  if (kProg && first) {
    matmul_rows<false>(a, K, w, H, [&](int r, int n0, const float* v) {
      *reinterpret_cast<float4*>(z + r * H + n0) =
          hidden_out<kBf16, true>(n, v, bias, n0, xm, r);
    });
  } else {
    matmul_rows<false>(a, K, w, H, [&](int r, int n0, const float* v) {
      *reinterpret_cast<float4*>(z + r * H + n0) =
          hidden_out<kBf16, false>(n, v, bias, n0, xm, r);
    });
  }
}

inline cudaError_t check_net(const Net& n, long long n_points, int mode) {
  if (n_points <= 0 || n.n_lin < 2 || n.n_lin > kMaxLayers || n.d < 1 ||
      n.d > kMaxDim || n.e < 4 || n.e % 4 != 0 || n.hidden < 4 ||
      n.hidden % 4 != 0 || n.out < 1)
    return cudaErrorInvalidValue;
  if (mode < kConst || mode > kSlab || (mode != kConst && !n.prog))
    return cudaErrorInvalidValue;
  if (mode == kSlab && (n.res < 1 || n.w_img < kTileRows ||
                        n.w_img % kTileRows != 0 || n_points % n.w_img != 0))
    return cudaErrorInvalidValue;
  if (mode != kSlab && n.res != 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline int variant_of(int mode, int prog) {
  if (mode == kPoint) return kVarPoint;
  if (mode == kSlab) return kVarSlab;
  return prog ? kVarConstProg : kVarConst;
}

inline Net make_net(int prog, int n_lin, int d, int e, int hidden, int out,
                    int res, int w_img, const float* const* w,
                    const float* const* b, const float* enc_a, const float* enc_b,
                    const float* enc_c, const float* mask, const float* mc,
                    const float* wx, const float* wc) {
  Net n{};
  n.n_lin = n_lin; n.d = d; n.e = e; n.hidden = hidden; n.out = out;
  n.prog = prog; n.res = res; n.w_img = w_img;
  for (int l = 0; l < n_lin && l < kMaxLayers; ++l) {
    n.w[l] = w ? w[l] : nullptr;
    n.b[l] = b ? b[l] : nullptr;
  }
  n.enc_a = enc_a; n.enc_b = enc_b; n.enc_c = enc_c;
  n.mask = mask; n.mc = mc; n.wx = wx; n.wc = wc;
  return n;
}

inline Net shape_net(int prog, int n_lin, int d, int e, int hidden, int out,
                     int res, int w_img) {
  return make_net(prog, n_lin, d, e, hidden, out, res, w_img, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr);
}

// f(bf16, rbf, variant) with the three as integral constants.
template <class F>
cudaError_t dispatch(int bf16, int rbf, int variant, F f) {
  auto by_variant = [&](auto b, auto r) -> cudaError_t {
    switch (variant) {
      case kVarConst:
        return f(b, r, std::integral_constant<int, kVarConst>{});
      case kVarConstProg:
        return f(b, r, std::integral_constant<int, kVarConstProg>{});
      case kVarPoint:
        return f(b, r, std::integral_constant<int, kVarPoint>{});
      default:
        return f(b, r, std::integral_constant<int, kVarSlab>{});
    }
  };
  if (bf16)
    return rbf ? by_variant(std::true_type{}, std::true_type{})
               : by_variant(std::true_type{}, std::false_type{});
  return rbf ? by_variant(std::false_type{}, std::true_type{})
             : by_variant(std::false_type{}, std::false_type{});
}

}  // namespace inr
