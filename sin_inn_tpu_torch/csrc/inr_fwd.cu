// Forward of the fused encoded coordinate MLP (the flow INR), for sm_90a:
// every product on the tensor cores, a tile's activations on chip.
//
// Replaces the TPU kernel `_fwd_kernel` of sin_inn_tpu/ops/pallas/inr.py
// (`_fused_fwd_call`): per tile of points, encode -> mask -> MLP, in the
// three mask modes, with and without the coordinate rows of a progressive
// net, with fp32 or bf16 operands. The net, its encodings and the modes are
// set out in inr_common.cuh. It is the primal of the per-point mask modes
// (slab, point), in training and in serving, so that the (N, E) mask and
// the (N, E) encoding never exist in device memory; for a constant mask the
// callers keep the plain forward, as the TPU package does, and this kernel
// is launched only to be measured.
//
// What bounds it on an H100: the products. At the flow path's shape
// (N = 446,464, E = 512 + 3 coordinate rows, H = 256, three hidden layers,
// O = 4) one launch does 2 N 263,936 = 235.7 GFLOP, 3.5 ms at the fp32
// peak of 67 TFLOP/s; in three TF32 products a product (3xTF32, below) 707
// TFLOP of TF32 work, 1.43 ms at the dense TF32 peak of 495 TFLOP/s. Beside
// that the slab rebuild (2 N 515 FLOP per non-zero column of wx, about 6 of
// 50) and the encoding's exp or sincos a channel. The bytes are small: x,
// out, the weights and, in slab mode, 45 MB of slabs (0.017 ms); point mode
// streams the 914 MB mask (0.27 ms).
//
// What the design does about it (a "fully fused" MLP: no activation reaches
// device memory):
// * A persistent grid, one block of 16 warps an SM, walks 64-point tiles.
//   Each warp owns 32 rows x 32 columns of a layer's output (2 x 4 tiles of
//   mma.sync.m16n8k8, 32 fp32 accumulators a thread and as many for the
//   run from 0, so 128 registers a thread do), so a block holds the whole
//   hidden width (at most 256); a layer's output goes once into shared
//   memory (64 x H) and is the next layer's A operand there.
// * The weights stream through shared memory in 32-row slices (cp.async,
//   three in flight), the same slices for every tile, so the stream runs on
//   from one tile's last hidden layer into the next tile's first: 1.05 MB of
//   weights from L2 a tile, 7.3 GB a launch at the path's shape.
// * The first layer's A operand u_0 = [xm | encoding x mask | 0] (515
//   columns at PFF; 64 x 515 floats would take 132 KB) is encoded one
//   32-column slice at a time into a double buffer, the slice after the one
//   the tensor cores are on (inr_common.cuh's encoding arithmetic; the slab
//   rebuild over the tile's non-zero columns of wx, the point mask read as
//   it is). The coordinate rows' product is part of this one.
// * fp32 operands: 3xTF32. Each operand is split as hi = its top 19 bits
//   (sign, exponent and the 10 bits of a TF32 mantissa: the value rounded
//   toward zero, which is what the tensor cores read of an fp32 register)
//   and lo = the same of a - hi, which is exact; a b is taken as
//   a_lo b_hi + a_hi b_lo + a_hi b_hi. What is left is the lo lo term
//   and the truncation of lo, about 2^-20 of a product (rounding to nearest
//   would leave 2^-21 for two conversions more an operand; one-pass TF32
//   leaves 2^-10). The tensor cores add with truncation, so every slice's
//   run of at most 12 mma starts from 0 and is added to the accumulator in
//   fp32. bf16 operands (weights, slabs and wx rounded by the wrapper,
//   u_0 and the activations where they are stored) are exact in TF32: one
//   mma a product, summed in fp32 as the TPU kernel's `_mm` sums.
// * The output layer (H x O, O <= 8) is one more product with N padded to
//   8, from a copy of W_{L-1} that the block stages once: its 4 row tiles
//   by 16 warps, each warp a quarter of the depth, the quarters added in
//   fp32 in order.
// Nothing is summed by atomics: two launches give the same bits.

#include "inr_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace inr;

constexpr int kWarpsM = 2;         // warps down a tile's rows
constexpr int kWarpsN = 8;         // warps across the hidden width
constexpr int kWarps = kWarpsM * kWarpsN;
constexpr int kFwdThreads = 32 * kWarps;
constexpr int kBM = 64;            // points of a tile
constexpr int kBK = 32;            // rows of a weight slice: 4 k-steps
constexpr int kStages = 3;         // weight slices in shared memory
constexpr int kMaxHidden = 256;    // 8 warps x 32 columns
constexpr int kNT = kMaxHidden / 8 / kWarpsN;   // 8-column tiles a warp
constexpr int kMaxOut = 8;         // one 8-column tile
constexpr int kA0ld = kBK + 4;     // row stride of a slice of u_0
constexpr int kRowsAWarp = kBM / kWarps;   // rows of u_0 a lane encodes
// slab mode's tile header before the non-zero columns of wx (and after
// them a flag a column): their count, whether the tile's rows lie in one
// image row, and that row
constexpr int kMeta = 3;

// One launch's widths and shared-memory layout, offsets in floats. Strides:
// A rows 4 mod 32 and B rows 8 mod 32 floats, so a fragment's 32 lanes hit
// 32 banks.
struct Plan {
  int dc, k0;          // coordinate rows (d or 0); rows of W_0, dc + E
  int hp;              // H rounded up to 8
  int lda, ldb;        // strides of the activations and a weight slice
  int sl0, sl1;        // slices of the first layer and of a later one
  int per_tile;        // slices a tile: sl0 + (L - 2) sl1
  int act, bs, a0, wout, xs, xq, xm, rows, cols;
  int total;
};

Plan plan_of(const Net& n) {
  Plan p;
  p.dc = n.prog ? n.d : 0;
  p.k0 = p.dc + n.e;
  p.hp = round_up(n.hidden, 8);
  const int wide = round_up(p.hp, 32);
  p.lda = wide + 4;
  p.ldb = wide + 8;
  p.sl0 = (p.k0 + kBK - 1) / kBK;
  p.sl1 = (p.hp + kBK - 1) / kBK;
  p.per_tile = p.sl0 + (n.n_lin - 2) * p.sl1;
  p.act = 0;          // kBM x lda activations; in layer 0 wxs (kBM x res)
  p.bs = p.act + kBM * (p.lda > n.res ? p.lda : n.res);   // kStages x kBK x ldb
  p.a0 = p.bs + kStages * kBK * p.ldb;         // 2 x kBM x kA0ld
  p.wout = p.a0 + 2 * kBM * kA0ld;             // hp x 8, W_{L-1}
  p.xs = p.wout + p.hp * kMaxOut;              // kBM x 4 coordinates
  p.xq = p.xs + kBM * kMaxDim;                 // kBM x 4: |x|^2 or 2 pi x
  p.xm = p.xq + kBM * kMaxDim;                 // kBM x 4 masked ones
  p.rows = p.xm + kBM * kMaxDim;               // kBM x (w, s) ints
  p.cols = p.rows + 2 * kBM;                   // kMeta + 2 res ints
  p.total = p.cols + kMeta + 2 * n.res;
  return p;
}

// The tile's rows: the coordinates (zeros past d and N) and, for the
// encoding, |x|^2 (rbf) or 2 pi x (ff); in slab mode each row's image column
// and row, the tile's header and non-zero columns of wx (in order) and the
// tile's rows of those columns (wxs, kBM x count); for a progressive net xm.
// Ends synchronised.
template <bool kBf16, bool kRbf, int kVariant>
__device__ void load_tile(const Net& n, const float* __restrict__ x,
                          long long row0, long long n_points, float* xs,
                          float* xq, float* xm, int* rows, int* cols,
                          float* wxs) {
  const int d = n.d;
  for (int i = threadIdx.x; i < kBM * kMaxDim; i += kFwdThreads) {
    const int r = i / kMaxDim, k = i % kMaxDim;
    const long long m = row0 + r;
    xs[i] = (k < d && m < n_points) ? __ldg(x + m * d + k) : 0.f;
  }
  if (kVariant == kVarSlab) {
    for (int r = threadIdx.x; r < kBM; r += kFwdThreads) {
      const long long m = row0 + r < n_points ? row0 + r : n_points - 1;
      rows[2 * r] = (int)(m % n.w_img);
      rows[2 * r + 1] = (int)(m / n.w_img);
    }
    for (int j = threadIdx.x; j < n.res; j += kFwdThreads)
      cols[kMeta + n.res + j] = 0;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kBM; r += kFwdThreads) {
    const float* xv = xs + r * kMaxDim;
    if (kRbf) {
      xq[r * kMaxDim] = sq_norm(n, xv);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        xq[r * kMaxDim + k] = __fmul_rn(xv[k], 6.283185307179586f);
    }
  }
  if (kVariant == kVarSlab) {
    // a flag a column of wx that a row of the tile uses, then the list of
    // those columns in order (warp 0), then the tile's rows of them
    int* flags = cols + kMeta + n.res;
    for (int i = threadIdx.x; i < kBM * n.res; i += kFwdThreads) {
      const int r = i / n.res, j = i % n.res;
      if (row0 + r < n_points &&
          __ldg(n.wx + (size_t)rows[2 * r] * n.res + j) != 0.f)
        flags[j] = 1;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int count = 0;
      for (int j0 = 0; j0 < n.res; j0 += 32) {
        const int j = j0 + lane;
        const bool any = j < n.res && flags[j];
        const unsigned ballot = __ballot_sync(0xffffffffu, any);
        if (any) cols[kMeta + count + __popc(ballot & ((1u << lane) - 1u))] = j;
        count += __popc(ballot);
      }
      if (lane == 0) {
        const long long last =
            (row0 + kBM < n_points ? row0 + kBM : n_points) - 1 - row0;
        cols[0] = count;
        cols[1] = rows[1] == rows[2 * last + 1];
        cols[2] = rows[1];
      }
    }
    __syncthreads();
    const int count = cols[0];
    for (int i = threadIdx.x; i < kBM * count; i += kFwdThreads) {
      const int r = i / count, c = i % count;
      wxs[i] = __ldg(n.wx + (size_t)rows[2 * r] * n.res + cols[kMeta + c]);
    }
  }
  __syncthreads();
  if (variant_prog(kVariant)) {
    for (int i = threadIdx.x; i < kBM * kMaxDim; i += kFwdThreads) {
      const int r = i / kMaxDim, k = i % kMaxDim;
      const long long m = row0 + r;
      float v = 0.f;
      if (k < d && m < n_points) {
        float mc;
        if (kVariant == kVarPoint) {
          mc = __ldg(n.mc + (long long)k * n_points + m);
        } else if (kVariant == kVarSlab) {
          // over the columns the tile uses (the others add exact zeros)
          const float* slab = n.mc + (size_t)rows[2 * r + 1] * n.res * d;
          mc = 0.f;
          for (int c = 0; c < cols[0]; ++c)
            mc = fmaf(wxs[r * cols[0] + c],
                      __ldg(slab + cols[kMeta + c] * d + k), mc);
        } else {
          mc = __ldg(n.mc + k);
        }
        v = rnd<kBf16>(__fmul_rn(xs[i], mc));
      }
      xm[i] = v;
    }
  }
  __syncthreads();
}

// The masks of the encoding channel e at the lane's rows r = warp + 16 i of
// the tile (0 past N); in slab mode rebuilt from the rows' slabs over the
// tile's non-zero columns of wx, in their order, the tile's rows of those
// columns of wx staged in wxs (kBM x count).
template <int kVariant>
__device__ __forceinline__ void masks_of(const Net& n, const int* rows,
                                         const int* cols, const float* wxs,
                                         int e, long long row0,
                                         long long n_points,
                                         float (&mask)[kRowsAWarp]) {
  const int warp = threadIdx.x / 32;
  if (kVariant == kVarPoint) {
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i) {
      const long long m = row0 + warp + kWarps * i;
      mask[i] = m < n_points ? __ldg(n.mask + m * n.e + e) : 0.f;
    }
  } else if (kVariant == kVarSlab) {
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i) mask[i] = 0.f;
    const int count = cols[0];
    const size_t plane = (size_t)n.res * n.e;
    const float* wr = wxs + warp * count;     // row warp + 16 i: 16 i count on
    if (cols[1]) {      // one image row: its slab column read once
      const float* slab = n.mask + (size_t)cols[2] * plane + e;
      for (int c = 0; c < count; ++c) {
        const float sv = __ldg(slab + (size_t)cols[kMeta + c] * n.e);
#pragma unroll
        for (int i = 0; i < kRowsAWarp; ++i)
          mask[i] = fmaf(wr[kWarps * i * count + c], sv, mask[i]);
      }
    } else {
      for (int c = 0; c < count; ++c) {
        const size_t j = (size_t)cols[kMeta + c] * n.e + e;
#pragma unroll
        for (int i = 0; i < kRowsAWarp; ++i)
          mask[i] = fmaf(wr[kWarps * i * count + c],
                         __ldg(n.mask + rows[2 * (warp + kWarps * i) + 1] * plane +
                               j),
                         mask[i]);
      }
    }
  } else {
    const float v = __ldg(n.mask + e);
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i) mask[i] = v;
  }
}

// Columns [32 s, 32 s + 32) of u_0 = [xm | encoding x mask | 0] for the
// tile's rows (zeros past N) into a0 (kBM x kA0ld): lane l takes column
// 32 s + l and the rows warp + 16 i, so a channel's constants are read once
// a slice and the rows' arithmetic runs side by side.
template <bool kBf16, bool kRbf, int kVariant>
__device__ void encode_slice(const Net& n, const Plan& p, int s,
                             const float* xs, const float* xq,
                             const float* xm, const int* rows,
                             const int* cols, const float* wxs,
                             long long row0, long long n_points, float* a0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = s * kBK + lane;
  float* dst = a0 + warp * kA0ld + lane;     // row warp + 16 i: 16 i kA0ld on
  if (c < p.dc || c >= p.dc + n.e) {
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i)
      dst[kWarps * i * kA0ld] =
          c < p.dc ? xm[(warp + kWarps * i) * kMaxDim + c] : 0.f;
    return;
  }
  const int e = c - p.dc;
  float code[kRowsAWarp];
  if (kRbf) {
    const RbfChannel ch = rbf_channel(n, e);
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i) {
      const int r = warp + kWarps * i;
      code[i] = rbf_eval(n, xs + r * kMaxDim, xq[r * kMaxDim], ch);
    }
  } else {
    const FfColumn col = ff_column(n, e / 2);
#pragma unroll
    for (int i = 0; i < kRowsAWarp; ++i) {
      float sv, cv;
      sincosf(ff_eval(n, xq + (warp + kWarps * i) * kMaxDim, col), &sv,
              &cv);
      code[i] = (e & 1) ? cv : sv;
    }
  }
  float mask[kRowsAWarp];
  masks_of<kVariant>(n, rows, cols, wxs, e, row0, n_points, mask);
#pragma unroll
  for (int i = 0; i < kRowsAWarp; ++i) {
    const bool live = row0 + warp + kWarps * i < n_points;
    dst[kWarps * i * kA0ld] =
        live ? rnd<kBf16>(__fmul_rn(code[i], mask[i])) : 0.f;
  }
}

// a as the TF32 pair (hi, lo) of the header. The tensor cores read the top
// 19 bits of a TF32 operand's register, so a itself passes as hi and
// a - hi (exact) as lo, each truncated where it is read.
__device__ __forceinline__ void split_rz(float a, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(a);
  lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
}

// A's fragments of two 16-row tiles at depth kk: a0 (row gq, k tq), a1
// (row gq + 8), a2 (k tq + 4), a3. ab points at row gq, column tq.
template <bool kBf16>
__device__ __forceinline__ void a_frags(const float* ab, int lda, int kk,
                                        uint32_t (&hi)[2][4],
                                        uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* a = ab + 16 * i * lda + kk;
    const float v[4] = {a[0], a[8 * lda], a[4], a[8 * lda + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kBf16) hi[i][e] = __float_as_uint(v[e]);
      else split_rz(v[e], hi[i][e], lo[i][e]);
    }
  }
}

// acc += the slice's product: a warp's 32 rows x nt 8-column tiles over
// `steps` k-steps of 8 (at most 4: 12 mma a product in 3xTF32, summed from
// 0). ab: A at the warp's row gq, column tq of the slice; bb: the slice's
// row tq, the warp's column gq.
template <bool kBf16>
__device__ __forceinline__ void slice_mma(const float* ab, int lda,
                                          const float* bb, int ldb, int steps,
                                          int nt, float (&acc)[2][kNT][4]) {
  float t[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    if (ks >= steps) break;
    const int kk = 8 * ks;
    uint32_t ah[2][4], al[2][4];
    a_frags<kBf16>(ab, lda, kk, ah, al);
    // B fragments: column gq of tile j, rows tq and tq + 4
    uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) break;
      const float b0 = bb[kk * ldb + 8 * j], b1 = bb[(kk + 4) * ldb + 8 * j];
      if (kBf16) {
        bh[j][0] = __float_as_uint(b0);
        bh[j][1] = __float_as_uint(b1);
      } else {
        split_rz(b0, bh[j][0], bl[j][0]);
        split_rz(b1, bh[j][1], bl[j][1]);
      }
    }
    // sixteen independent accumulators a term, the small terms first
    if (!kBf16) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) mma(t[i][j], al[i], bh[j][0], bh[j][1]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nt) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) mma(t[i][j], ah[i], bl[j][0], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) mma(t[i][j], ah[i], bh[j][0], bh[j][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
}

// relu(acc + bias) of the warp's tiles into the activations (rounded to bf16
// in the bf16 mode): c0, c1 at row gq, columns 2 tq, 2 tq + 1 of tile j; c2,
// c3 at row gq + 8. Columns from H to hp get relu(0 + 0) = 0.
template <bool kBf16>
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[2][kNT][4],
                                                const float* __restrict__ bias,
                                                int H, float* act, int lda,
                                                int wm, int wn, int nt,
                                                int gq, int tq) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt) break;
    const int col = wn + 8 * j + 2 * tq;
    const float2 b = col < H
                         ? __ldg(reinterpret_cast<const float2*>(bias + col))
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + 16 * i + gq + 8 * h;
        float2 v;
        v.x = rnd<kBf16>(fmaxf(acc[i][j][2 * h] + b.x, 0.f));
        v.y = rnd<kBf16>(fmaxf(acc[i][j][2 * h + 1] + b.y, 0.f));
        *reinterpret_cast<float2*>(act + row * lda + col) = v;
      }
    }
  }
}

// out = act W_{L-1} + b_{L-1} for the tile's rows before N: warp w takes
// row tile w % 4 over the depth's part w / 4 of kParts (k-steps of 8 split
// evenly); the other parts' sums pass through `part` ((kParts - 1) x 4 x 32
// x 4 floats) and are added to the first's in order. Every thread of the
// block calls it.
constexpr int kParts = kWarps / 4;

template <bool kBf16>
__device__ void out_layer(const float* act, int lda, const float* wout,
                          int hp, const float* __restrict__ bias, int O,
                          long long row0, long long n_points, float* part,
                          float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int mt = warp % 4, q = warp / 4;
  const int nks = hp / 8;
  const int ks0 = q * nks / kParts, ks1 = (q + 1) * nks / kParts;
  const float* ab = act + (16 * mt + gq) * lda + tq;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = ks0; k0 < ks1; k0 += kBK / 8) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = k0; ks < k0 + kBK / 8 && ks < ks1; ++ks) {
      const int kk = 8 * ks;
      const float v[4] = {ab[kk], ab[8 * lda + kk], ab[kk + 4],
                          ab[8 * lda + kk + 4]};
      const float b0 = wout[(kk + tq) * kMaxOut + gq];
      const float b1 = wout[(kk + tq + 4) * kMaxOut + gq];
      uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
      if (kBf16) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[e] = __float_as_uint(v[e]);
        mma(t, ah, __float_as_uint(b0), __float_as_uint(b1));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) split_rz(v[e], ah[e], al[e]);
        split_rz(b0, bh0, bl0);
        split_rz(b1, bh1, bl1);
        mma(t, al, bh0, bh1);
        mma(t, ah, bl0, bl1);
        mma(t, ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
  }
  if (q) {
    float* mine = part + (((q - 1) * 4 + mt) * 32 + lane) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[e] = acc[e];
  }
  __syncthreads();
  if (q) return;
  for (int o = 1; o < kParts; ++o) {
    const float* theirs = part + (((o - 1) * 4 + mt) * 32 + lane) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += theirs[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = row0 + 16 * mt + gq + 8 * h;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 2 * tq + c;
      if (m < n_points && col < O)
        out[m * O + col] = acc[2 * h + c] + __ldg(bias + col);
    }
  }
}

template <bool kBf16, bool kRbf, int kVariant>
__global__ void __launch_bounds__(kFwdThreads, 1)
inr_fwd_kernel(const float* __restrict__ x, long long n_points, Net net,
               Plan p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kProg = variant_prog(kVariant);
  float* act = smem + p.act;
  float* bs = smem + p.bs;
  float* a0s = smem + p.a0;
  float* wout = smem + p.wout;
  float* xs = smem + p.xs;
  float* xq = smem + p.xq;
  float* xm = smem + p.xm;
  int* rows = reinterpret_cast<int*>(smem + p.rows);
  int* cols = reinterpret_cast<int*>(smem + p.cols);
  float* wxs = act;     // slab mode: the tile's wx, while layer 0 runs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp / kWarpsN) * 32, wn = (warp % kWarpsN) * 8 * kNT;
  const int nt = p.hp - wn >= 8 * kNT ? kNT : (p.hp > wn ? (p.hp - wn) / 8 : 0);
  const int L = net.n_lin, H = net.hidden, O = net.out;

  // W_{L-1}, zero-padded to hp x 8, once a launch
  for (int i = threadIdx.x; i < p.hp * kMaxOut; i += kFwdThreads) {
    const int k = i / kMaxOut, o = i % kMaxOut;
    wout[i] = (k < H && o < O) ? __ldg(net.w[L - 1] + k * O + o) : 0.f;
  }

  // The weight stream: every tile takes the slices (layer l, rows from
  // kBK s) of its hidden layers in order; slice g of the block's stream
  // lands in stage g % kStages.
  const long long tiles = (n_points + kBM - 1) / kBM;
  const long long total =
      (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * p.per_tile;
  long long issued = 0;
  int il = 0, is = 0;
  // A thread's 16-byte chunks of a slice: flat float index 4 t, 4 t + 1024,
  // ... of the kBK x hp slice, walked without a division.
  const int c_first = 4 * threadIdx.x % p.hp, r_first = 4 * threadIdx.x / p.hp;
  const int dr = 4 * kFwdThreads / p.hp, dc = 4 * kFwdThreads % p.hp;
  auto issue = [&]() {
    if (issued < total) {
      const int K = il == 0 ? p.k0 : H;
      const float* w = il == 0 ? (kProg ? net.wc : net.w[0]) : net.w[il];
      const int k_lo = is * kBK;
      float* dst = bs + (int)(issued % kStages) * kBK * p.ldb;
      for (int r = r_first, c4 = c_first; r < kBK;) {
        const bool ok = k_lo + r < K && c4 < H;
        cp_async16(dst + r * p.ldb + c4,
                   ok ? w + (size_t)(k_lo + r) * H + c4 : w, ok);
        r += dr;
        c4 += dc;
        if (c4 >= p.hp) {
          c4 -= p.hp;
          ++r;
        }
      }
      if (++is == (il == 0 ? p.sl0 : p.sl1)) {
        is = 0;
        il = il + 1 == L - 1 ? 0 : il + 1;
      }
    }
    cp_async_commit();
    ++issued;
  };
  issue();
  issue();

  long long g = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kBM;
    __syncthreads();   // the last tile's output layer is done with a0s
    load_tile<kBf16, kRbf, kVariant>(net, x, row0, n_points, xs, xq, xm,
                                     rows, cols, wxs);
    encode_slice<kBf16, kRbf, kVariant>(net, p, 0, xs, xq, xm, rows, cols,
                                        wxs, row0, n_points, a0s);
    for (int l = 0; l + 1 < L; ++l) {
      const int nsl = l == 0 ? p.sl0 : p.sl1;
      const int ksteps = (l == 0 ? round_up(p.k0, 8) : p.hp) / 8;
      float acc[2][kNT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      for (int s = 0; s < nsl; ++s, ++g) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        issue();
        const float* ab =
            l == 0 ? a0s + (s & 1) * kBM * kA0ld + (wm + gq) * kA0ld + tq
                   : act + (wm + gq) * p.lda + s * kBK + tq;
        const float* bb = bs + (int)(g % kStages) * kBK * p.ldb +
                          tq * p.ldb + wn + gq;
        const int steps = ksteps - 4 * s < 4 ? ksteps - 4 * s : 4;
        // the next slice of u_0: warps 8-15 encode it before their
        // products and warps 0-7 after theirs, so each SM sub-partition
        // (warps w, w + 4, w + 8, w + 12) has warps on the tensor cores
        // while others encode
        const bool next = l == 0 && s + 1 < nsl;
        float* a0n = a0s + ((s + 1) & 1) * kBM * kA0ld;
        if (next && warp >= kWarps / 2)
          encode_slice<kBf16, kRbf, kVariant>(net, p, s + 1, xs, xq, xm,
                                              rows, cols, wxs, row0, n_points,
                                              a0n);
        slice_mma<kBf16>(ab, l == 0 ? kA0ld : p.lda, bb, p.ldb, steps, nt,
                         acc);
        if (next && warp < kWarps / 2)
          encode_slice<kBf16, kRbf, kVariant>(net, p, s + 1, xs, xq, xm,
                                              rows, cols, wxs, row0, n_points,
                                              a0n);
      }
      __syncthreads();   // every warp is done reading the activations
      hidden_epilogue<kBf16>(acc, net.b[l], H, act, p.lda, wm, wn, nt, gq,
                             tq);
    }
    __syncthreads();
    out_layer<kBf16>(act, p.lda, wout, p.hp, net.b[L - 1], O, row0,
                     n_points, a0s, out);
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// One launch on `stream`. x: (n_points, d) fp32 contiguous; out: (n_points,
// out), written in full. The other arguments as `sininn_inr_bwd` of
// inr_bwd.cu takes them; besides, hidden <= 256 and out <= 8. The grid is
// one block an SM, at most one per tile. Returns a cudaError_t.
int sininn_inr_fwd(int bf16, int rbf, int mode, int prog, long long n_points,
                   int n_lin, int d, int e, int hidden, int out_ch, int res,
                   int w_img, const float* x, const float* const* w,
                   const float* const* b, const float* enc_a,
                   const float* enc_b, const float* enc_c, const float* me,
                   const float* mc, const float* wx, const float* wc,
                   float* out, void* stream) {
  const Net n = make_net(prog, n_lin, d, e, hidden, out_ch, res, w_img, w, b,
                         enc_a, enc_b, enc_c, me, mc, wx, wc);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  if (n.hidden > kMaxHidden || n.out > kMaxOut)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n);
  const size_t smem = sizeof(float) * (size_t)p.total;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + kBM - 1) / kBM;
  const int blocks = (int)(tiles < sms ? tiles : sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, rbf, variant_of(mode, prog),
                       [&](auto bb, auto r, auto v) {
    auto kernel = inr_fwd_kernel<decltype(bb)::value, decltype(r)::value,
                                 decltype(v)::value>;
    cudaError_t e2 = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e2 != cudaSuccess) return e2;
    kernel<<<blocks, kFwdThreads, smem, s>>>(x, n_points, n, p, out);
    return cudaGetLastError();
  });
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
