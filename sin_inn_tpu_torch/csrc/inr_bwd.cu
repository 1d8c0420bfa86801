// Backward of the fused encoded coordinate MLP (the flow INR), for sm_90a:
// staged products on the tensor cores.
//
// Replaces the TPU kernel `_bwd_kernel` of sin_inn_tpu/ops/pallas/inr.py
// (`_fused_bwd_call`) in its three mask modes, with and without the
// coordinate rows of a progressive net. The net, its encodings, the mask
// modes and the bf16 operand mode are set out in inr_common.cuh. For the
// output cotangent g (N, O):
//
//   recompute  u_0 = [xm | a_0] (xm only for a progressive net) and
//              a_{l+1} = relu(a_l W_l + b_l), W_0 with the coordinate rows
//   then, from g_{L-1} = g, for l = L - 1 .. 0:
//              dW_l = a_l' g_l (u_0' g_0 for l = 0: [dwc | dW_0]),
//              db_l = sum_rows g_l,  g_{l-1} = (g_l W_l') [a_l > 0]
//
// Only the weight and bias gradients leave: nothing flows into x, the mask
// or the encoding. In the bf16 operand mode cotangents are rounded where
// they are read (db sums them unrounded).
//
// What bounds it on an H100: the products. At the flow path's shape
// (N = 446,464, E = 512, H = 256, three hidden layers, O = 4: 263,168
// weights) one launch does 2 N 263,168 FLOP for the recompute, the same for
// the weight gradients and 2 N 132,096 for the g chain: 587 GFLOP, 8.8 ms at
// the fp32 peak of 67 TFLOP/s. Every product runs as three TF32 products
// (3xTF32, tf32_mma.cuh): 1.76 TFLOP of TF32 work, 3.56 ms at the dense TF32
// peak of 495 TFLOP/s. x, g, the weights and the gradients are about 15 MB
// (0.004 ms); the staged activations below add 3.7 GB written once and
// read at least twice (3.3 ms or more at 3.35 TB/s). A progressive net adds
// the coordinate rows' products, slab mode the mask rebuild and 45 MB of
// slabs at res 50, point mode the 914 MB mask.
//
// Stages. One launch of sininn_inr_bwd runs, on one stream:
//   0. pack_kernel (tf32_mma.cuh, shared with K1-K4; every call, since LAMB
//      updates the weights in place): W_l of the recompute (W_0 with the
//      coordinate rows in front), its biases, and W_l' of the g chain into
//      zero-padded operands (K to 8, H to 64), each weight element split
//      into its TF32 (hi, lo) pair.
//   Then, for each chunk of rows (at most 32,768, the same for every chunk
//   but the last), so that the scratch stays bounded whatever N is:
//   1. prep: per 32-row tile, the encoding and the mask in every mode (the
//      code of the forward kernel, inr_common.cuh) into u_0 = [xm | a_0]
//      (rows, d + E padded to 8), and g padded to 8 columns. a_0 is kept per
//      chunk (65 MB at the path's shape) rather than encoded again in the
//      weight stage: it is written once and read by the first product and
//      the weight stage, which stays the one K3/K4 use.
//   2. L - 1 forward products a_{l+1} = relu(a_l W_l + b_l), rounded to bf16
//      in the bf16 mode, and L - 1 chain products g_{l-1} = (g_l W_l') masked
//      by a_l > 0, each a tiled product (row_gemm_kernel) of 128 rows x 64
//      columns a block: 8 warps of 32 x 32, 32-deep stages of A and of the
//      pre-split B by double-buffered 16-byte cp.async.
//   3. the weight stage (weight_stage.cuh, as K3/K4): [dW_l | db_l] of every
//      layer as a split-K product u_l' g_l over slots of rows, each block
//      writing its tile of its slot once.
//   Then the wrapper's reduction kernel (ops/cuda/coupling.py
//   reduce_weight_grads) sums the slots in order. No slot is shared and
//   nothing is summed by atomics: two launches give the same bits.
//
// Products. fp32 operands: three mma.sync.m16n8k8 TF32 products a product
// (lo hi + hi lo + hi hi), about 2^-21 of each product left, near fp32's own
// 2^-24. bf16 operands: the activations are stored rounded to bf16 and the
// cotangents rounded where they are read, and a bf16 value is a TF32 value,
// so one TF32 product is exact: one mma a product, summed in fp32 as the TPU
// kernel's `_mm` sums. Either way the tensor cores add with truncation, so
// every run of at most 12 mma (one 32-deep stage) starts from 0 and is added
// to the running sum in fp32. The recompute does not repeat the forward's
// order of sums: a relu gate whose pre-activation lies within rounding of 0
// may be set otherwise than in the forward.
//
// Sizes at the path's shape (RBF): 14 chunks of 32,000 rows (the last
// 30,464); scratch 266 MB (u_0, g, three a_l and three g_l of a chunk,
// 2,056 floats a row, and 3.2 MB of packed weights) and 8 slots a chunk of
// 263,940 floats (118 MB): 385 MB a launch (autograd through the plain
// route holds 3 GB for the backward).

#include "inr_common.cuh"
#include "tf32_mma.cuh"
#include "weight_stage.cuh"

namespace {

using namespace inr;

constexpr int kGemmThreads = 256;  // 8 warps: 4 down the rows x 2 across
constexpr int kBM = 128;           // rows of a product tile
constexpr int kBN = 64;            // columns of a product tile
constexpr int kBK = 32;            // depth of a stage (4 k-steps, 12 mma)
// shared row strides: A rows 36 floats (a fragment's 32 lanes hit 32
// banks); B rows of 64 (hi, lo) pairs and 8 more, 8 mod 32 (a half-warp's
// 64-bit loads hit the 32 banks once each)
constexpr int kAld = kBK + 4;
constexpr int kBld = 2 * kBN + 8;
constexpr size_t kGemmSmem = sizeof(float) * 2 * (kBM * kAld + kBK * kBld);
constexpr long long kChunkRows = 32768;    // most rows of a row chunk
constexpr long long kMinSlotRows = 1024;   // least rows of a gradient slot
constexpr int kWeightBlocksPerSm = 2;      // weight-stage blocks an SM holds

// The widths of one launch, padded as the stages read them.
struct Dims {
  int n_lin, dc, e, h, o;   // layers, coordinate rows (d or 0), E, H, O
  int k0;                   // dc + E: the rows of the first layer
  int ld0, hp, op;          // k0 rounded up to 8, H to kBN, O to 8
};

Dims dims_of(const Net& n) {
  Dims d;
  d.n_lin = n.n_lin;
  d.dc = n.prog ? n.d : 0;
  d.e = n.e;
  d.h = n.hidden;
  d.o = n.out;
  d.k0 = d.dc + d.e;
  d.ld0 = round_up(d.k0, 8);
  d.hp = round_up(d.h, kBN);
  d.op = round_up(d.o, 8);
  return d;
}

int rows_of(const Dims& d, int l) { return l == 0 ? d.k0 : d.h; }
int cols_of(const Dims& d, int l) { return l == d.n_lin - 1 ? d.o : d.h; }

// Where [dW_l | db_l] starts in a slot: [dwc | dW_0 | db_0 | dW_1 | ...],
// dwc (d, H) the coordinate rows' gradient of a progressive net, so that
// [dwc | dW_0] is the gradient of its whole first layer.
long long slot_offset(const Dims& d, int l) {
  long long s = 0;
  for (int j = 0; j < l; ++j)
    s += (long long)rows_of(d, j) * cols_of(d, j) + cols_of(d, j);
  return s;
}
long long slot_floats(const Dims& d) { return slot_offset(d, d.n_lin); }

struct Layout {   // offsets in floats into the scratch buffer
  long long fw[kMaxLayers], fb[kMaxLayers];   // recompute: W_l, b_l
  long long cw[kMaxLayers];                   // chain: W_l', 1 <= l < L
  long long u0, go;                           // [xm | a_0 | 0], [g | 0]
  long long act[kMaxLayers];                  // a_l, 1 <= l < L
  long long grad[kMaxLayers];                 // g_l, 0 <= l < L - 1
  long long total;
};

Layout layout_of(const Dims& d, long long rows) {
  Layout l{};
  long long at = 0;
  auto take = [&](long long floats) {
    const long long here = at;
    at += (floats + 63) / 64 * 64;
    return here;
  };
  for (int i = 0; i + 1 < d.n_lin; ++i) {
    l.fw[i] = take(2LL * (i == 0 ? d.ld0 : d.hp) * d.hp);
    l.fb[i] = take(d.hp);
  }
  for (int i = 1; i < d.n_lin; ++i)
    l.cw[i] = take(2LL * (i == d.n_lin - 1 ? d.op : d.hp) * d.hp);
  l.u0 = take(rows * d.ld0);
  l.go = take(rows * d.op);
  for (int i = 1; i < d.n_lin; ++i) l.act[i] = take(rows * d.hp);
  for (int i = 0; i + 1 < d.n_lin; ++i) l.grad[i] = take(rows * d.hp);
  l.total = at;
  return l;
}

// The weight stage's products: [dW_l | db_l] = u_l' g_l, u_0 = [xm | a_0],
// u_l = a_l; g_{L-1} = g. The biases are the column sums of g_l.
Products products_of(const Dims& d, const Layout& l, float* scratch) {
  Products ps{};
  for (int i = 0; i < d.n_lin; ++i) {
    Product& p = ps.pr[i];
    const bool last = i == d.n_lin - 1;
    p.u = scratch + (i == 0 ? l.u0 : l.act[i]);
    p.ldu = i == 0 ? d.ld0 : d.hp;
    p.p = rows_of(d, i);
    p.v = scratch + (last ? l.go : l.grad[i]);
    p.ldv = last ? d.op : d.hp;
    p.q = cols_of(d, i);
    p.out = slot_offset(d, i);
  }
  return ps;
}

int weight_tiles(const Dims& d) {
  int tiles = 0;
  for (int i = 0; i < d.n_lin; ++i) {
    Product p{};
    p.p = rows_of(d, i);
    p.q = cols_of(d, i);
    tiles += tiles_of(p);
  }
  return tiles;
}

struct Plan {
  long long rows;        // rows of a row chunk, a multiple of kBM
  long long chunks;
  long long slot_rows;   // rows of a gradient slot, a multiple of kWK
  long long slots;       // slots over all chunks
  int tiles;             // weight-stage tiles of one slot
};

// Chunks of equal height (the last may be lower), and slots of as many rows
// as make slots x tiles of one chunk about fill the weight-stage blocks the
// device holds at once. A function of the shapes and the device alone: the
// same on every run on one card.
cudaError_t plan_of(const Dims& d, long long n_points, Plan* p) {
  const long long chunks = (n_points + kChunkRows - 1) / kChunkRows;
  p->rows = (long long)round_up(
      (int)((n_points + chunks - 1) / chunks), kBM);
  p->chunks = (n_points + p->rows - 1) / p->rows;
  p->tiles = weight_tiles(d);
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long per = (long long)kWeightBlocksPerSm * sms / p->tiles;
  if (per < 1) per = 1;
  long long r = (p->rows + per - 1) / per;
  r = (r + kWK - 1) / kWK * kWK;
  p->slot_rows = r > kMinSlotRows ? r : kMinSlotRows;
  p->slots = 0;
  for (long long c = 0; c < p->chunks; ++c) {
    const long long left = n_points - c * p->rows;
    const long long rows_c = left < p->rows ? left : p->rows;
    p->slots += (rows_c + p->slot_rows - 1) / p->slot_rows;
  }
  return cudaSuccess;
}

// ---- stage 1: the encoding ----

// One 32-row tile of the chunk starting at row_begin: u_0 = [xm | a_0 | 0]
// (ld ld0) and [g | 0] (ld op); zeros for a tile wholly past N.
template <bool kBf16, bool kRbf, int kVariant>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ x, const float* __restrict__ g,
            long long n_points, Net net, long long row_begin,
            float* __restrict__ u0, int ld0, float* __restrict__ go,
            int op) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kProg = variant_prog(kVariant);
  const int E = net.e, O = net.out, dc = kProg ? net.d : 0;
  float* a0 = smem;
  float* xm = a0 + kTileRows * E;
  float* wxs = xm + (kProg ? kTileRows * kMaxDim : 0);
  const long long row0 = row_begin + (long long)blockIdx.x * kTileRows;
  const bool live = row0 < n_points;
  if (live)
    prepare_tile<kBf16, kRbf, kVariant>(net, x, row0, n_points, a0, xm, wxs);
  float* u = u0 + (long long)blockIdx.x * kTileRows * ld0;
  for (int idx = threadIdx.x; idx < kTileRows * ld0; idx += kThreads) {
    const int r = idx / ld0, c = idx % ld0;
    float v = 0.f;
    if (live && c < dc) v = xm[r * kMaxDim + c];
    else if (live && c < dc + E) v = a0[r * E + c - dc];
    u[idx] = v;
  }
  float* o = go + (long long)blockIdx.x * kTileRows * op;
  for (int idx = threadIdx.x; idx < kTileRows * op; idx += kThreads) {
    const int r = idx / op, c = idx % op;
    const long long m = row0 + r;
    o[idx] = (c < O && m < n_points) ? __ldg(g + m * O + c) : 0.f;
  }
}

// ---- stage 2: the row products ----

struct GemmArgs {
  const float* a;       // rows x k, ld k (k a multiple of 8)
  int k;
  const float* b;       // k x n (hi, lo) pairs, row stride 2 n floats
  int n;                // a multiple of kBN
  const float* bias;    // forward: n floats
  const float* gate;    // chain: a_l, rows x n (ld n)
  float* out;           // rows x n (ld n)
};

// out = relu(a b + bias) (rounded to bf16 in the bf16 mode) or, kChain,
// out = (a b) [gate > 0] with a rounded to bf16 where it is read in the
// bf16 mode (a is then a cotangent). Grid: (n / kBN, rows / kBM).
template <bool kBf16, bool kChain>
__global__ void __launch_bounds__(kGemmThreads, 2)
row_gemm_kernel(GemmArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* const as = smem;                       // 2 x kBM x kAld
  float* const bs = smem + 2 * kBM * kAld;      // 2 x kBK x kBld
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const long long row0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  auto issue = [&](int k0, int buf) {
    float* ad = as + buf * kBM * kAld;
    for (int s = threadIdx.x; s < kBM * (kBK / 4); s += kGemmThreads) {
      const int r = s / (kBK / 4), c = 4 * (s % (kBK / 4));
      const bool ok = k0 + c < g.k;
      cp_async16(ad + r * kAld + c,
                 ok ? g.a + (row0 + r) * g.k + k0 + c : g.a, ok);
    }
    float* bd = bs + buf * kBK * kBld;
    for (int s = threadIdx.x; s < kBK * (2 * kBN / 4); s += kGemmThreads) {
      const int r = s / (2 * kBN / 4), c = 4 * (s % (2 * kBN / 4));
      const bool ok = k0 + r < g.k;
      cp_async16(bd + r * kBld + c,
                 ok ? g.b + (size_t)(k0 + r) * 2 * g.n + 2 * n0 + c : g.b,
                 ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int stages = (g.k + kBK - 1) / kBK;
  issue(0, 0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      issue((st + 1) * kBK, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ab = as + (st & 1) * kBM * kAld + (wm + gq) * kAld + tq;
    const float* bb = bs + (st & 1) * kBK * kBld + tq * kBld + 2 * (wn + gq);
    const int steps = min(kBK, g.k - st * kBK) / 8;
    // the stage's products sum from 0 and are added to acc in fp32
    float t[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      if (ks >= steps) break;
      const int kk = 8 * ks;
      // A fragments: a0 (row gq, k tq), a1 (row gq + 8), a2 (k tq + 4), a3
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = ab + 16 * i * kAld + kk;
        float v[4] = {a[0], a[8 * kAld], a[4], a[8 * kAld + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kBf16) hi[i][e] = tf32(kChain ? round_bf16(v[e]) : v[e]);
          else split(v[e], hi[i][e], lo[i][e]);
        }
      }
      // B fragments (pre-split): column gq of tile j, rows tq and tq + 4
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b0 =
            *reinterpret_cast<const float2*>(bb + kk * kBld + 16 * j);
        const float2 b1 =
            *reinterpret_cast<const float2*>(bb + (kk + 4) * kBld + 16 * j);
        bh[j][0] = __float_as_uint(b0.x);
        bl[j][0] = __float_as_uint(b0.y);
        bh[j][1] = __float_as_uint(b1.x);
        bl[j][1] = __float_as_uint(b1.y);
      }
      // eight independent accumulators a term, the terms in turn
      if (!kBf16) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(t[i][j], lo[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(t[i][j], hi[i], bl[j][0], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(t[i][j], hi[i], bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[i][j][e];
    __syncthreads();
  }

  // c0, c1 at row gq, columns 2 tq, 2 tq + 1 of tile j; c2, c3 at row gq + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + wm + 16 * i + gq + 8 * h;
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (kChain) {
          const float2 m =
              *reinterpret_cast<const float2*>(g.gate + r * g.n + col);
          v.x = m.x > 0.f ? v.x : 0.f;
          v.y = m.y > 0.f ? v.y : 0.f;
        } else {
          const float2 b = __ldg(reinterpret_cast<const float2*>(g.bias + col));
          v.x = rnd<kBf16>(fmaxf(v.x + b.x, 0.f));
          v.y = rnd<kBf16>(fmaxf(v.y + b.y, 0.f));
        }
        *reinterpret_cast<float2*>(g.out + r * g.n + col) = v;
      }
    }
  }
}

// ---- the launch ----

// Stage 0: the recompute's W_l (W_0 with the coordinate rows of a
// progressive net, contiguous in front of it) and b_l, and the chain's W_l'.
cudaError_t pack_weights(const Net& n, const Dims& d, const Layout& l,
                         float* scratch, cudaStream_t s) {
  PackArgs pk{};
  cudaError_t err = cudaSuccess;
  auto add = [&](const PackMat& m) {
    pk.mat[pk.count++] = m;
    if (pk.count == kMaxPack) {
      if (err == cudaSuccess) err = pack(pk, scratch, s);
      pk.count = 0;
    }
  };
  for (int i = 0; i + 1 < d.n_lin; ++i) {
    const float* w = i == 0 && n.prog ? n.wc : n.w[i];
    add(PackMat{l.fw[i], rows_of(d, i), d.h, i == 0 ? d.ld0 : d.hp, d.hp, w,
                d.h, 1, 0, 1});
    add(PackMat{l.fb[i], 1, d.h, 1, d.hp, n.b[i], 0, 1, 0, 0});
  }
  for (int i = 1; i < d.n_lin; ++i) {
    // W_i' (N_i, H): element (r, c) is W_i[c][r]
    const int cols = cols_of(d, i);
    add(PackMat{l.cw[i], cols, d.h, i == d.n_lin - 1 ? d.op : d.hp, d.hp,
                n.w[i], 1, cols, 0, 1});
  }
  if (pk.count > 0 && err == cudaSuccess) err = pack(pk, scratch, s);
  return err;
}

template <bool kBf16, bool kRbf, int kVariant>
cudaError_t run(const Net& n, const Dims& d, const Plan& p,
                const float* x, const float* g, long long n_points,
                float* scratch, float* partials, cudaStream_t s) {
  const Layout l = layout_of(d, p.rows);
  cudaError_t err = pack_weights(n, d, l, scratch, s);
  if (err != cudaSuccess) return err;
  auto prep = prep_kernel<kBf16, kRbf, kVariant>;
  auto fwd = row_gemm_kernel<kBf16, false>;
  auto chain = row_gemm_kernel<kBf16, true>;
  auto wstage = weight_stage_kernel<kBf16>;
  const size_t prep_smem =
      sizeof(float) * ((long long)kTileRows * n.e + extra_floats(n));
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((err = cudaFuncSetAttribute(prep, attr, (int)prep_smem)) ||
      (err = cudaFuncSetAttribute(fwd, attr, (int)kGemmSmem)) ||
      (err = cudaFuncSetAttribute(chain, attr, (int)kGemmSmem)) ||
      (err = cudaFuncSetAttribute(wstage, attr, (int)kWeightSmem)))
    return err;
  const Products ps = products_of(d, l, scratch);
  const long long slot = slot_floats(d);
  long long slot0 = 0;
  for (long long c = 0; c < p.chunks; ++c) {
    const long long begin = c * p.rows;
    const long long rows = n_points - begin < p.rows ? n_points - begin
                                                      : p.rows;
    const long long padded = (rows + kBM - 1) / kBM * kBM;
    prep<<<(unsigned)(padded / kTileRows), kThreads, prep_smem, s>>>(
        x, g, n_points, n, begin, scratch + l.u0, d.ld0, scratch + l.go,
        d.op);
    const dim3 grid((unsigned)(d.hp / kBN), (unsigned)(padded / kBM));
    for (int i = 0; i + 1 < d.n_lin; ++i) {
      const GemmArgs a{scratch + (i == 0 ? l.u0 : l.act[i]),
                       i == 0 ? d.ld0 : d.hp, scratch + l.fw[i], d.hp,
                       scratch + l.fb[i], nullptr, scratch + l.act[i + 1]};
      fwd<<<grid, kGemmThreads, kGemmSmem, s>>>(a);
    }
    for (int i = d.n_lin - 1; i >= 1; --i) {
      const bool last = i == d.n_lin - 1;
      const GemmArgs a{scratch + (last ? l.go : l.grad[i]),
                       last ? d.op : d.hp, scratch + l.cw[i], d.hp, nullptr,
                       scratch + l.act[i], scratch + l.grad[i - 1]};
      chain<<<grid, kGemmThreads, kGemmSmem, s>>>(a);
    }
    const long long slots = (rows + p.slot_rows - 1) / p.slot_rows;
    wstage<<<dim3((unsigned)slots, (unsigned)p.tiles), kWThreads,
             kWeightSmem, s>>>(ps, rows, p.slot_rows,
                               partials + slot0 * slot, slot);
    slot0 += slots;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of one launch for n_points on the current device: floats of
// scratch, gradient slots, and floats a slot ([dwc (d, H) if prog | dW_0
// (E, H) | db_0 (H) | dW_1 (H, H) | db_1 | ... | dW_{L-1} (H, O) |
// db_{L-1}]). mode: 0 const, 1 point, 2 slab. Returns a cudaError_t.
int sininn_inr_bwd_plan(int bf16, int rbf, int mode, int prog,
                        long long n_points, int n_lin, int d, int e,
                        int hidden, int out, int res, int w_img,
                        long long* scratch_floats, long long* slots,
                        long long* slot) {
  (void)bf16;
  (void)rbf;
  const Net n = shape_net(prog, n_lin, d, e, hidden, out, res, w_img);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  const Dims dm = dims_of(n);
  Plan p;
  err = plan_of(dm, n_points, &p);
  if (err != cudaSuccess) return (int)err;
  *scratch_floats = layout_of(dm, p.rows).total;
  *slots = p.slots;
  *slot = slot_floats(dm);
  return (int)cudaSuccess;
}

// One launch on `stream`. x: (n_points, d), g: (n_points, out), fp32
// contiguous. w, b: n_lin pointers each, W_l (K_l, N_l) row-major (W_0: its
// E encoding rows) and b_l. rbf = 1: enc_a = centres (e, d), enc_b = |c|^2
// (e), enc_c = sigma^2 (e); rbf = 0: enc_a = F (d, e / 2), enc_b and enc_c
// unused. me, mc, wx by mode: const me (e), mc (d); point me (n_points, e),
// mc (d, n_points); slab me (rows, res, e), mc (rows, res, d), wx (w_img,
// res) with rows x w_img = n_points and w_img a multiple of 32. prog = 1:
// wc (d, hidden), the coordinate rows, directly in front of W_0's encoding
// rows (mc and wc unused otherwise). bf16 = 1: bf16 operands in the
// products (weights, slabs and wx passed already rounded). scratch and
// partials (slots x slot floats) as sininn_inr_bwd_plan gives them, both
// written before they are read. Returns a cudaError_t.
int sininn_inr_bwd(int bf16, int rbf, int mode, int prog, long long n_points,
                   int n_lin, int d, int e, int hidden, int out, int res,
                   int w_img, const float* x, const float* const* w,
                   const float* const* b, const float* enc_a,
                   const float* enc_b, const float* enc_c, const float* me,
                   const float* mc, const float* wx, const float* wc,
                   const float* g, float* scratch, float* partials,
                   long long slots, void* stream) {
  const Net n = make_net(prog, n_lin, d, e, hidden, out, res, w_img, w, b,
                         enc_a, enc_b, enc_c, me, mc, wx, wc);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  const Dims dm = dims_of(n);
  Plan p;
  err = plan_of(dm, n_points, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.slots != slots) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, rbf, variant_of(mode, prog),
                       [&](auto bb, auto r, auto v) {
    return run<decltype(bb)::value, decltype(r)::value, decltype(v)::value>(
        n, dm, p, x, g, n_points, scratch, partials, s);
  });
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
