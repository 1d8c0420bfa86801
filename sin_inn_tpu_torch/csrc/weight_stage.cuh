// The weight-gradient stage shared by the staged backward kernels
// (csrc/coupling_1x1_bwd.cu: K3/K4; csrc/inr_bwd.cu: K7 backward;
// csrc/coupling_3x3_bwd.cu: K8 backward, with U gathered): split-K
// products D = U' V over chunks of rows on the tensor cores, one slot of
// partials a chunk, written once. The reduction kernel of
// coupling_1x1_bwd.cu then sums the slots in chunk order, so a launch gives
// the same bits every time.
//
// A D tile is 256 x 32 (8 x 1 warps) for a narrow operand V of at most 32
// columns, else 128 x 64 (4 x 2 warps); 8 warps of 32 x 32, 32 rows a stage
// by double-buffered 16-byte cp.async. The biases are column sums taken in
// row order by the blocks of the first tile row or column.
//
// Operands: fp32 (kBf16 = false): every product is three TF32 products
// (3xTF32, tf32_mma.cuh). bf16 operand mode (kBf16 = true): U holds values
// already rounded to bf16 and V is rounded to bf16 where it is read (the
// bias sums take it unrounded); a bf16 value is a TF32 value, so one TF32
// product is exact and each product is one mma. Either way every run of at
// most 12 mma (one 32-row stage) starts from 0 and is added to the running
// sum in fp32: the tensor cores add with truncation.
//
// Gathered U (kGather = true): U is the im2col of an NHWC image batch that
// is never written out. Row m of U is pixel m of (n, img_h, img_w) images,
// column tap img_c + c its channel c at the 3x3 tap's neighbour (0 outside
// the image); u is the image batch, ldu its channel stride. img_c and ldu
// are multiples of 4, so each 16-byte copy stays within one tap.

#pragma once

#include "tf32_mma.cuh"

namespace {

constexpr int kWThreads = 256;    // weight stage: 8 warps of 32 x 32
constexpr int kWK = 32;           // rows per weight-stage step
constexpr int kUld = 256 + 8, kVld = 64 + 8;  // widest tiles' strides
constexpr int kMaxProducts = 8;

struct Product {
  const float* u;    // rows x p (ld ldu)
  const float* v;    // rows x q (ld ldv)
  int p, ldu, q, ldv;
  long long out;     // slot offset of the weight; its bias follows
  int transpose;     // the weight is (q, p): out[j][i] = D[i][j]
  int bias_u;        // bias = column sums of u (else of v)
  int img_h, img_w, img_c;   // gathered U only
};
struct Products {
  Product pr[kMaxProducts];
};

__host__ __device__ __forceinline__ int tile_p(const Product& p) {
  return p.q <= 32 ? 256 : 128;
}
__host__ __device__ __forceinline__ int tile_q(const Product& p) {
  return p.q <= 32 ? 32 : 64;
}
__host__ __device__ __forceinline__ int tiles_of(const Product& p) {
  return ((p.p + tile_p(p) - 1) / tile_p(p)) *
         ((p.q + tile_q(p) - 1) / tile_q(p));
}

constexpr size_t kWeightSmem = sizeof(float) * 2 * kWK * (kUld + kVld);

// blockIdx.x: a chunk of `chunk` rows of the m; blockIdx.y: a D tile of one
// of the products, in order. Writes the tile (and its share of the bias)
// into the chunk's slot of `partials`.
template <bool kBf16, bool kGather = false>
__global__ void __launch_bounds__(kWThreads)
weight_stage_kernel(Products ps, long long m, long long chunk,
                    float* __restrict__ partials, long long slot) {
  extern __shared__ __align__(16) float smem[];
  int tile = blockIdx.y, which = 0;
  while (tile >= tiles_of(ps.pr[which])) tile -= tiles_of(ps.pr[which++]);
  const Product& pr = ps.pr[which];
  const int tp = tile_p(pr), tq_w = tile_q(pr);
  const int uld = tp + 8, vld = tq_w + 8;   // 8 mod 32: no bank conflicts
  float* const us = smem;                   // 2 x kWK x uld
  float* const vs = us + 2 * kWK * uld;     // 2 x kWK x vld
  const int qt = (pr.q + tq_w - 1) / tq_w;
  const int p0 = (tile / qt) * tp, q0 = (tile % qt) * tq_w;
  const long long k_begin = (long long)blockIdx.x * chunk;
  const long long k_end = min(k_begin + chunk, m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wq = tq_w / 32;                 // warps across q: 1 or 2
  const int pw = (warp / wq) * 32, qw = (warp % wq) * 32;
  const int nt = min(4, max(0, (pr.q - q0 - qw + 7) / 8));
  const bool live = p0 + pw < pr.p && nt > 0;
  const bool sum_u = pr.bias_u && q0 == 0;
  const bool sum_v = !pr.bias_u && p0 == 0;

  // gathered U: the loop below gives a thread the same 16-byte column of
  // the U tile at every row (its stride is a multiple of a row's float4s),
  // so the column's tap and channel are fixed
  const int g_j = p0 + 4 * (threadIdx.x % (tp / 4));
  const int g_tap = kGather ? g_j / pr.img_c : 0;
  const int g_c = g_j - g_tap * (kGather ? pr.img_c : 0);
  const int g_dy = g_tap / 3 - 1, g_dx = g_tap % 3 - 1;
  const bool g_live = g_j < pr.p;

  auto issue = [&](long long k0, int buf) {
    float* ud = us + buf * kWK * uld;
    for (int s = threadIdx.x; s < kWK * (tp / 4); s += kWThreads) {
      const int r = s / (tp / 4), col = 4 * (s % (tp / 4));
      const long long row = k0 + r;
      if (kGather) {
        // m < 2^31 pixels: 32-bit index arithmetic
        const int pix = (int)row, t = pix / pr.img_w;
        const int y = t % pr.img_h + g_dy, x = pix - t * pr.img_w + g_dx;
        const bool ok = row < k_end && g_live && y >= 0 && y < pr.img_h &&
                        x >= 0 && x < pr.img_w;
        cp_async16(ud + r * uld + col,
                   ok ? pr.u + ((long long)(t - t % pr.img_h + y) *
                                    pr.img_w + x) * pr.ldu + g_c
                      : pr.u,
                   ok);
        continue;
      }
      const bool ok = row < k_end && p0 + col < pr.ldu;
      cp_async16(ud + r * uld + col,
                 ok ? pr.u + row * pr.ldu + p0 + col : pr.u, ok);
    }
    float* vd = vs + buf * kWK * vld;
    for (int s = threadIdx.x; s < kWK * (tq_w / 4); s += kWThreads) {
      const int r = s / (tq_w / 4), col = 4 * (s % (tq_w / 4));
      const long long row = k0 + r;
      const bool ok = row < k_end && q0 + col < pr.ldv;
      cp_async16(vd + r * vld + col,
                 ok ? pr.v + row * pr.ldv + q0 + col : pr.v, ok);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  float colsum = 0.f;

  const int stages = (int)((k_end - k_begin + kWK - 1) / kWK);
  issue(k_begin, 0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      issue(k_begin + (long long)(st + 1) * kWK, (st + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ub = us + (st & 1) * kWK * uld;
    const float* vb = vs + (st & 1) * kWK * vld;
    if (live) {
      // the stage's 32 rows sum from 0 (at most 12 mma) and are added to
      // acc in fp32: the tensor cores add with truncation
      float t[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kWK; kk += 8) {
        // A = U' (D rows p, k rows r): a0 (p = gq, r = tq), a1 (p + 8), a2
        // (r + 4), a3 (p + 8, r + 4)
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* u = ub + (kk + tq) * uld + pw + 16 * i + gq;
          const float uv[4] = {u[0], u[8], u[4 * uld], u[4 * uld + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kBf16) hi[i][e] = tf32(uv[e]);
            else split(uv[e], hi[i][e], lo[i][e]);
          }
        }
        const float* v = vb + (kk + tq) * vld + qw + gq;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n >= nt) continue;
          if (kBf16) {
            const uint32_t bh0 = tf32(round_bf16(v[8 * n]));
            const uint32_t bh1 = tf32(round_bf16(v[4 * vld + 8 * n]));
#pragma unroll
            for (int i = 0; i < 2; ++i) mma(t[i][n], hi[i], bh0, bh1);
            continue;
          }
          uint32_t bh0, bl0, bh1, bl1;
          split(v[8 * n], bh0, bl0);
          split(v[4 * vld + 8 * n], bh1, bl1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(t[i][n], lo[i], bh0, bh1);
            mma(t[i][n], hi[i], bl0, bl1);
            mma(t[i][n], hi[i], bh0, bh1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += t[i][n][e];
    }
    if (sum_u && threadIdx.x < tp) {
      for (int r = 0; r < kWK; ++r) colsum += ub[r * uld + threadIdx.x];
    } else if (sum_v && threadIdx.x < tq_w) {
      for (int r = 0; r < kWK; ++r) colsum += vb[r * vld + threadIdx.x];
    }
    __syncthreads();
  }

  float* dst = partials + (long long)blockIdx.x * slot + pr.out;
  if (live) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (n >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + pw + 16 * i + gq + (e >= 2 ? 8 : 0);
          const int q = q0 + qw + 8 * n + 2 * tq + (e & 1);
          if (p < pr.p && q < pr.q)
            dst[pr.transpose ? (long long)q * pr.p + p
                             : (long long)p * pr.q + q] = acc[i][n][e];
        }
      }
    }
  }
  float* bias = dst + (long long)pr.p * pr.q;
  if (sum_u && threadIdx.x < tp && p0 + threadIdx.x < pr.p)
    bias[p0 + threadIdx.x] = colsum;
  if (sum_v && threadIdx.x < tq_w && q0 + threadIdx.x < pr.q)
    bias[q0 + threadIdx.x] = colsum;
}

}  // namespace
