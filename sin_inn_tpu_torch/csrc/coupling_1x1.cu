// Fused GLOW coupling with 1x1-conv subnets, forward (K1) and inverse (K2),
// for sm_90a: both halves of the chain in one block, every product on the
// tensor cores in 3xTF32.
//
// Replaces the TPU kernels `_coupling_fwd_kernel` (coupling.py:82) and
// `_coupling_inv_kernel` (:111) of sin_inn_tpu/ops/pallas/coupling.py, both
// launched through `_run_fused` (:148). Per pixel (one row of the (M, C)
// input), with x = [x1 | x2], len1 + len2 = C and hidden width H:
//
//   forward:  r2 = W2b relu(W2a x2 + b2a) + b2b;  y1 = exp(le(s2)) x1 + t2
//             r1 = W1b relu(W1a y1 + b1a) + b1b;  y2 = exp(le(s1)) x2 + t1
//   inverse:  r1 from y1, x2 = (y2 - t1) exp(-le(s1)),
//             r2 from x2, x1 = (y1 - t2) exp(-le(s2))
//
// with r = [s | t] and le(s) = clamp (2/pi) atanf(s / clamp). Math is fp32;
// x and y are stored in fp32 or bf16.
//
// What bounds it on an H100: the products. A launch does 6 C H FLOP a
// pixel, 8.30 GFLOP at either flagship SRF octave at batch 8 (C = 48 on
// 112,640 rows, C = 192 on 28,160) and 41.5 GFLOP at batch 40: 0.124 / 0.62
// ms at the fp32 peak. In 3xTF32 that is 24.9 / 124.6 GFLOP of TF32 work,
// 0.05 / 0.25 ms at the dense TF32 peak. The bytes are x read once and y
// written once (43 MB at batch 8, 217 MB at batch 40 in fp32: 0.013 / 0.065
// ms at 3.35 TB/s); the packed weights (0.6 MB at C = 192) come from L2
// once a block.
//
// What the design does about it. The TPU kernel held every weight in VMEM;
// at C = 192 they are 590 KB, more than a block's 227 KB. Here:
//   0. pack_kernel (tf32_mma.cuh, shared with K3/K4; same stream, every
//      call: the weights change in place between calls under Adam, so
//      nothing is cached) writes the
//      four weights and biases into zero-padded operands: K to a multiple of
//      8, H to 32, and the second product's N as pairs of 8-column tiles (s
//      of 8 channels, then t of the same 8), N = 2 L rounded up to 16; each
//      weight element already split into its TF32 (hi, lo) pair, so the
//      products split only the activations.
//   1. One block owns a tile of 16 W rows (W warps, a 16-row slab each) and
//      holds x1 and x2 in shared memory as fp32, zero padded. Phase A (x2 ->
//      h2 -> r2 forward, y1 -> h1 -> r1 inverse) walks the hidden width in
//      chunks of 32: the chunk of Wa (K x 32) and of Wb (32 x N) comes in by
//      16-byte cp.async and serves all 16 W rows; Wb is double buffered,
//      Wa's next chunk comes in while the second product runs (227 KB hold
//      no more at C = 192: 100 KB of x, 27 KB of Wa, 2 x 49 KB of Wb). The
//      chunk's h = relu(A Wa + ba) stays in registers: the accumulator
//      fragment of the first product is the A fragment of the second, with
//      the chunk's k order permuted (columns 2t, 2t+1 of an 8-column step
//      taken as k = t, t + 4) and Wb read in the same order. The epilogue
//      forms y1 (x2) in shared memory from r in registers: a thread holds s
//      and t of the same channels because of the paired N layout. Phase B
//      runs the other subnet on it and forms y2 (x1); then the tile is
//      written once. Nothing H-wide leaves the SM; there is no scratch
//      beyond the packed weights.
//   Every product is three mma.sync.m16n8k8 TF32 products (tf32_mma.cuh);
//   every run of at most 12 mma starts from 0 and is added in fp32, and the
//   mma of four output tiles are issued in turn (mma3x4), so that a warp
//   always has four independent chains in flight. Where the Wb chunks of
//   all N columns do not fit beside the rest (C > 192), N goes in passes of
//   64 or 16 columns, each of which recomputes h.
//   W is the most warps that fit: 8 at every shape of the SRF path, fewer
//   only above C = 320 at an even split (6 at C = 384). Within a wave the
//   kernel is bound by latency, so a wave takes about as long whatever the
//   height of its blocks, and fewer rows a block only adds waves (on the
//   card, 7-warp blocks were nowhere faster). At C = 192, batch 8, the 28,160
//   rows take two waves of 8-warp blocks (220 blocks, one an SM: 227 KB of
//   shared memory), the second two thirds full; 7-warp blocks would fill
//   it (252) but still take two waves, and one wave would need 14 warps an
//   SM, which neither shared memory nor the registers (about 215 a thread)
//   allow.
//   Narrow N is padded to the mma's 8 columns; a ragged last tile is
//   computed on zeros and not stored. Any len1 in (0, C) and any H.

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;    // at most 8 warps a block
constexpr int kHC = 32;          // hidden chunk
// shared row stride of a Wa chunk in floats: 32 (hi, lo) pairs and 8 more,
// 8 mod 32, so a half-warp's 64-bit loads of a B fragment hit 16 banks
// pairs once each
constexpr int kWaLd = 2 * kHC + 8;

// c[g] += a b[g] for the first `live` of four output tiles g in 3xTF32,
// with a and b[g] split. The three terms go round the accumulators in
// turn, so each mma depends on the one four before it, not on the one
// before it: a warp issues in order, and four independent chains keep the
// tensor cores fed.
__device__ __forceinline__ void mma3x4(float (&c)[4][4],
                                       const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4],
                                       const uint32_t (&bh)[4][2],
                                       const uint32_t (&bl)[4][2],
                                       int live = 4) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (g < live) mma(c[g], lo, bh[g][0], bh[g][1]);
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (g < live) mma(c[g], hi, bl[g][0], bl[g][1]);
#pragma unroll
  for (int g = 0; g < 4; ++g)
    if (g < live) mma(c[g], hi, bh[g][0], bh[g][1]);
}

// The B fragments of four output tiles (the first `live`) from a chunk
// stored as (hi, lo) pairs: tile g's column at w + 16 g, its k + 4 row
// `ld` floats further.
__device__ __forceinline__ void load_b(const float* w, int ld,
                                       uint32_t (&bh)[4][2],
                                       uint32_t (&bl)[4][2], int live = 4) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g >= live) continue;
    const float2 b0 = *reinterpret_cast<const float2*>(w + 16 * g);
    const float2 b1 = *reinterpret_cast<const float2*>(w + ld + 16 * g);
    bh[g][0] = __float_as_uint(b0.x);
    bl[g][0] = __float_as_uint(b0.y);
    bh[g][1] = __float_as_uint(b1.x);
    bl[g][1] = __float_as_uint(b1.y);
  }
}

// ---- stage 1: the coupling ----

// One subnet's packed operands: wa (kp x hp), ba (hp), wb (hp x np, each
// element as its TF32 (hi, lo) pair), bb (np); np = 2 round_up(L, 8) in the
// paired layout; L = the width of s.
struct Sub {
  const float *wa, *ba, *wb, *bb;
  int kp, np, npass, L;
};

struct Args {
  const void* in;
  void* out;
  long long m;
  int c, len1, len2, hp;
  int ldv1, ldv2;       // shared row strides of the x1 and x2 halves
  int wa_buf, wb_buf;   // floats of the Wa chunk buffer, of a Wb one
  float clamp;
  Sub first, second;    // the subnets in the order they run
};

// One phase on the warp's 16-row slab: r = relu(A Wa + ba) Wb + bb over
// the hidden width in chunks of 32, then the affine step on D in place:
// forward D = exp(le(s)) D + t, inverse D = (D - t) exp(-le(s)).
template <int kNT, bool kInv>
__device__ __forceinline__ void phase(const Args& a, const Sub& p,
                                      const float* As, int lda, float* Ds,
                                      int ldd, float* wa_s, float* wb_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int r0 = warp * 16;
  const float* a_lo = As + (r0 + gq) * lda + tq;
  const int nch = a.hp / kHC;
  const int ldb = 2 * p.npass + 4;   // floats: (hi, lo) pairs, 4 mod 16

  for (int pass0 = 0; pass0 < p.np; pass0 += p.npass) {
    const int ncols = min(p.npass, p.np - pass0);
    const int nt = ncols / 8;
    // the chunk of Wa (K x 32, one buffer) and of Wb (32 x ncols, two)
    auto issue_a = [&](int ch) {
      for (int s = threadIdx.x; s < p.kp * (kHC / 2); s += blockDim.x) {
        const int k = s / (kHC / 2), q = 4 * (s % (kHC / 2));
        cp_async16(wa_s + k * kWaLd + q,
                   p.wa + 2 * ((size_t)k * a.hp + ch * kHC) + q, true);
      }
    };
    auto issue_b = [&](int ch, int buf) {
      float* wb_d = wb_s + buf * a.wb_buf;
      const int per_row = ncols / 2;
      for (int s = threadIdx.x; s < kHC * per_row; s += blockDim.x) {
        const int k = s / per_row, q = 4 * (s % per_row);
        cp_async16(wb_d + k * ldb + q,
                   p.wb + 2 * ((size_t)(ch * kHC + k) * p.np + pass0) + q,
                   true);
      }
    };

    float out[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] = 0.f;

    // Wa's next chunk comes in while the second product runs, Wb's while
    // the whole chunk runs
    issue_a(0);
    issue_b(0, 0);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        issue_b(ch + 1, (ch + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* wa_c = wa_s + tq * kWaLd + 2 * gq;
      const float* wb_c = wb_s + (ch & 1) * a.wb_buf + 2 * tq * ldb + 2 * gq;

      // z = A Wa over this chunk's 32 hidden columns, runs of at most 4
      // k-steps (12 mma) from 0, added in fp32
      float z[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
      for (int k0 = 0; k0 < p.kp; k0 += 32) {
        float t[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int k = k0 + 8 * ks;
          if (k >= p.kp) break;
          uint32_t hi[4], lo[4];
          split(a_lo[k], hi[0], lo[0]);
          split(a_lo[8 * lda + k], hi[1], lo[1]);
          split(a_lo[k + 4], hi[2], lo[2]);
          split(a_lo[8 * lda + k + 4], hi[3], lo[3]);
          uint32_t bh[4][2], bl[4][2];
          load_b(wa_c + k * kWaLd, 4 * kWaLd, bh, bl);
          mma3x4(t, hi, lo, bh, bl);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[j][e] += t[j][e];
      }
      __syncthreads();   // every warp is done with this chunk of Wa
      if (ch + 1 < nch) {
        issue_a(ch + 1);
        cp_async_commit();
      }

      // h = relu(z + ba): c0, c1 at row gq, columns 2 tq, 2 tq + 1 of step
      // j; c2, c3 at row gq + 8. Then the permuted split: step j of the
      // chunk takes h's columns 2 tq, 2 tq + 1 as k = tq, tq + 4
      uint32_t zh[4][4], zl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(
            p.ba + ch * kHC + 8 * j + 2 * tq));
        split(fmaxf(z[j][0] + b.x, 0.f), zh[j][0], zl[j][0]);
        split(fmaxf(z[j][2] + b.x, 0.f), zh[j][1], zl[j][1]);
        split(fmaxf(z[j][1] + b.y, 0.f), zh[j][2], zl[j][2]);
        split(fmaxf(z[j][3] + b.y, 0.f), zh[j][3], zl[j][3]);
      }
      // out += h Wb on groups of 4 output tiles, each tile's chunk (12
      // mma) from 0
#pragma unroll
      for (int n0 = 0; n0 < kNT; n0 += 4) {
        if (n0 >= nt) continue;
        float t[4][4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[g][e] = 0.f;
        // tiles past nt (at most the group's last two) read and add
        // nothing
        const int live = min(4, nt - n0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[4][2], bl[4][2];
          load_b(wb_c + 8 * j * ldb + 16 * n0, ldb, bh, bl, live);
          mma3x4(t, zh[j], zl[j], bh, bl, live);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) out[n0 + g][e] += t[g][e];
      }
      __syncthreads();
    }

    // the affine step: tile n (even) holds s of channels 8 q .. 8 q + 7,
    // tile n + 1 t of the same, q = (pass0 + 8 n) / 16
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      if (n >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = pass0 + 8 * n + 2 * tq + (e & 1);
        const int ch = 8 * (col / 16) + (col & 7);
        if (ch >= p.L) continue;
        const float s = out[n][e] + __ldg(p.bb + col);
        const float t = out[n + 1][e] + __ldg(p.bb + col + 8);
        const float le = log_e(s, a.clamp);
        float* d = Ds + (r0 + gq + (e >= 2 ? 8 : 0)) * ldd + ch;
        *d = kInv ? (*d - t) * expf(-le) : expf(le) * *d + t;
      }
    }
  }
}

template <typename T, bool kInv, int kNT>
__global__ void __launch_bounds__(kThreads)
coupling_1x1_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int rows = blockDim.x / 2;   // 16 a warp
  const long long row0 = (long long)blockIdx.x * rows;
  float* const v1 = smem;                    // rows x ldv1: x1 (y1)
  float* const v2 = v1 + rows * a.ldv1;      // rows x ldv2: x2 (y2)
  float* const wa_s = v2 + rows * a.ldv2;    // one Wa chunk
  float* const wb_s = wa_s + a.wa_buf;        // two Wb chunks
  const T* in = static_cast<const T*>(a.in);
  const int w1 = a.ldv1 - 4, w2 = a.ldv2 - 4;   // each half padded to 8
  const int wid = w1 + w2;

  // rows past m and the padding columns are zeros: computed, never stored
  for (int idx = threadIdx.x; idx < rows * wid; idx += blockDim.x) {
    const int r = idx / wid, j = idx % wid;
    const long long m = row0 + r;
    const bool left = j < w1;
    const int jj = left ? j : j - w1;
    const bool real = m < a.m && jj < (left ? a.len1 : a.len2);
    const float v =
        real ? to_float(__ldg(in + m * a.c + (left ? 0 : a.len1) + jj)) : 0.f;
    (left ? v1 + r * a.ldv1 : v2 + r * a.ldv2)[jj] = v;
  }
  __syncthreads();

  if (!kInv) {
    phase<kNT, false>(a, a.first, v2, a.ldv2, v1, a.ldv1, wa_s, wb_s);
    phase<kNT, false>(a, a.second, v1, a.ldv1, v2, a.ldv2, wa_s, wb_s);
  } else {
    phase<kNT, true>(a, a.first, v1, a.ldv1, v2, a.ldv2, wa_s, wb_s);
    phase<kNT, true>(a, a.second, v2, a.ldv2, v1, a.ldv1, wa_s, wb_s);
  }
  __syncthreads();

  T* out = static_cast<T*>(a.out);
  for (int idx = threadIdx.x; idx < rows * a.c; idx += blockDim.x) {
    const int r = idx / a.c, col = idx % a.c;
    const long long m = row0 + r;
    if (m < a.m)
      store(out + m * a.c + col, col < a.len1
                                     ? v1[r * a.ldv1 + col]
                                     : v2[r * a.ldv2 + col - a.len1]);
  }
}

// ---- host side ----

struct Dims {
  int c, len1, len2, hp;
  int kp1, kp2;   // x1 and x2 padded to 8: K of the s1 and s2 subnets
  int np2, np1;   // N of s2 (2 round_up(len1, 8)) and of s1
};

Dims dims_of(int c, int len1, int hidden) {
  Dims d;
  d.c = c;
  d.len1 = len1;
  d.len2 = c - len1;
  d.hp = round_up(hidden, kHC);
  d.kp1 = round_up(len1, 8);
  d.kp2 = round_up(d.len2, 8);
  d.np2 = 2 * d.kp1;
  d.np1 = 2 * d.kp2;
  return d;
}

// Packed operands, in floats: [wa2 | ba2 | wb2 | bb2 | wa1 | ba1 | wb1 | bb1],
// each at a multiple of 64 floats.
struct Layout {
  long long at[8];
  long long total;
};

long long align64(long long n) { return (n + 63) / 64 * 64; }

Layout layout_of(const Dims& d) {
  const long long sizes[8] = {
      2LL * d.kp2 * d.hp, d.hp, 2LL * d.hp * d.np2, d.np2,
      2LL * d.kp1 * d.hp, d.hp, 2LL * d.hp * d.np1, d.np1};
  Layout l;
  long long at = 0;
  for (int i = 0; i < 8; ++i) {
    l.at[i] = at;
    at += align64(sizes[i]);
  }
  l.total = at;
  return l;
}

struct Plan {
  int warps, npass2, npass1, knt;   // npass: Wb columns a pass
  long long smem;                   // bytes
};

long long smem_bytes(const Dims& d, int warps, int np2, int np1) {
  const int kpmax = d.kp1 > d.kp2 ? d.kp1 : d.kp2;
  const int npmax = np2 > np1 ? np2 : np1;
  return 4 * (16LL * warps * (d.kp1 + 4 + d.kp2 + 4) +
              (long long)kpmax * kWaLd +
              2LL * kHC * (2 * npmax + 4));
}

// The widest Wb pass that fits a block of `w` warps. False if none fits.
bool fit(const Dims& d, int w, Plan* p) {
  const int widest = d.np2 > d.np1 ? d.np2 : d.np1;
  const int knt = widest > 64 ? 24 : 8;
  const int caps[3] = {8 * knt, 64, 16};
  for (int cap : caps) {
    const int n2 = d.np2 < cap ? d.np2 : cap, n1 = d.np1 < cap ? d.np1 : cap;
    const long long bytes = smem_bytes(d, w, n2, n1);
    if (bytes <= kMaxSmem) {
      *p = Plan{w, n2, n1, knt, bytes};
      return true;
    }
  }
  return false;
}

// The largest block that fits: its warps, or 0 if none fits.
int widest_block(const Dims& d, Plan* p) {
  int w = kThreads / 32;
  while (w >= 1 && !fit(d, w, p)) --w;
  return w;
}

// The plan of a launch, false if no block fits.
bool plan_of(int c, int len1, int hidden, Plan* p) {
  return len1 > 0 && len1 < c && hidden > 0 &&
         widest_block(dims_of(c, len1, hidden), p) >= 1;
}

template <typename T, bool kInv, int kNT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t s) {
  auto kernel = coupling_1x1_kernel<T, kInv, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const long long rows = 16LL * p.warps;
  const long long blocks = (a.m + rows - 1) / rows;
  kernel<<<(unsigned)blocks, 32 * p.warps, p.smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kInv>
cudaError_t launch_knt(const Args& a, const Plan& p, cudaStream_t s) {
  return p.knt == 24 ? launch<T, kInv, 24>(a, p, s)
                     : launch<T, kInv, 8>(a, p, s);
}

}  // namespace

extern "C" {

// Floats of packed weights one launch needs (the scratch argument).
long long sininn_coupling_1x1_scratch_floats(int c, int len1, int hidden) {
  return layout_of(dims_of(c, len1, hidden)).total;
}

// Bytes of dynamic shared memory of a launch's block, or -1 if no block
// fits.
long long sininn_coupling_1x1_smem_bytes(int c, int len1, int hidden) {
  Plan p;
  return plan_of(c, len1, hidden, &p) ? p.smem : -1;
}

// A launch's plan into out[3]: the warps a block (16 rows each; the most
// that fit, 8 at every shape of the SRF path), then the passes over the
// second product's columns of the s2 and of the s1 subnet. Returns 0, or
// -1 if no block fits.
int sininn_coupling_1x1_plan(int c, int len1, int hidden, int* out) {
  Plan p;
  if (!plan_of(c, len1, hidden, &p)) return -1;
  const Dims d = dims_of(c, len1, hidden);
  out[0] = p.warps;
  out[1] = (d.np2 + p.npass2 - 1) / p.npass2;
  out[2] = (d.np1 + p.npass1 - 1) / p.npass1;
  return 0;
}

// One launch of the forward (inverse = 0) or inverse (inverse = 1) coupling
// on `stream`: pack_kernel (tf32_mma.cuh), then the coupling kernel.
// in/out: (m, c) row-major, fp32 (bf16 = 0) or bf16 (bf16 = 1). Weights:
// the OIHW 1x1 conv weights as stored (contiguous fp32): w2a (H, len2),
// w2b (2 len1, H), w1a (H, len1), w1b (2 len2, H), and the biases.
// scratch: scratch_floats, written before it is read. Returns a
// cudaError_t.
int sininn_coupling_1x1(int inverse, int bf16, const void* in, void* out,
                        long long m, int c, int len1, int hidden,
                        const float* w2a, const float* b2a, const float* w2b,
                        const float* b2b, const float* w1a, const float* b1a,
                        const float* w1b, const float* b1b, float clamp,
                        float* scratch, void* stream) {
  Plan p;
  if (m <= 0 || !plan_of(c, len1, hidden, &p))
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(c, len1, hidden);
  const Layout l = layout_of(d);
  const int l1 = d.len1, l2 = d.len2, H = hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // stage 0. (k, n) of W2a (len2 x H), the (cin, cout) view of w2a
  // (H, len2), is w2a[n * len2 + k], and so on.
  PackArgs pk;
  pk.count = 8;
  pk.mat[0] = PackMat{l.at[0], l2, H, d.kp2, d.hp, w2a, 1, l2, 0, 1};
  pk.mat[1] = PackMat{l.at[1], 1, H, 1, d.hp, b2a, 0, 1, 0, 0};
  pk.mat[2] = PackMat{l.at[2], H, l1, d.hp, d.np2, w2b, 1, H, 1, 1};
  pk.mat[3] = PackMat{l.at[3], 1, l1, 1, d.np2, b2b, 0, 1, 1, 0};
  pk.mat[4] = PackMat{l.at[4], l1, H, d.kp1, d.hp, w1a, 1, l1, 0, 1};
  pk.mat[5] = PackMat{l.at[5], 1, H, 1, d.hp, b1a, 0, 1, 0, 0};
  pk.mat[6] = PackMat{l.at[6], H, l2, d.hp, d.np1, w1b, 1, H, 1, 1};
  pk.mat[7] = PackMat{l.at[7], 1, l2, 1, d.np1, b1b, 0, 1, 1, 0};
  cudaError_t err = pack(pk, scratch, s);
  if (err != cudaSuccess) return (int)err;

  const Sub s2{scratch + l.at[0], scratch + l.at[1], scratch + l.at[2],
               scratch + l.at[3], d.kp2, d.np2, p.npass2, l1};
  const Sub s1{scratch + l.at[4], scratch + l.at[5], scratch + l.at[6],
               scratch + l.at[7], d.kp1, d.np1, p.npass1, l2};
  Args a{};
  a.in = in;
  a.out = out;
  a.m = m;
  a.c = c;
  a.len1 = l1;
  a.len2 = l2;
  a.hp = d.hp;
  a.ldv1 = d.kp1 + 4;
  a.ldv2 = d.kp2 + 4;
  a.wa_buf = (d.kp1 > d.kp2 ? d.kp1 : d.kp2) * kWaLd;
  a.wb_buf = kHC * (2 * (p.npass2 > p.npass1 ? p.npass2 : p.npass1) + 4);
  a.clamp = clamp;
  a.first = inverse ? s1 : s2;
  a.second = inverse ? s2 : s1;
  if (bf16) {
    err = inverse ? launch_knt<__nv_bfloat16, true>(a, p, s)
                  : launch_knt<__nv_bfloat16, false>(a, p, s);
  } else {
    err = inverse ? launch_knt<float, true>(a, p, s)
                  : launch_knt<float, false>(a, p, s);
  }
  return (int)err;
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
