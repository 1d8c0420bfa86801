// Device code shared by the two sources of K8, the GLOW half coupling with
// 3x3-conv subnets (csrc/coupling_3x3.cu: forward and inverse;
// csrc/coupling_3x3_bwd.cu: the VJP, whose first stage is the same fused
// kernel in its two backward modes).
//
// One launch of `half_coupling_3x3_kernel` computes, for NHWC fp32 tensors
// x_in (N, H, W, Cin) and x_aff (N, H, W, Caff) with hidden width Hid,
//
//   h = relu(conv1(x_in) + b1)            SAME 3x3, Cin -> Hid
//   r = conv2(h) + b2 = [s | t]           SAME 3x3, Hid -> 2 Caff
//   forward:  y = exp(le(s)) x_aff + t
//   inverse:  y = (x_aff - t) exp(-le(s))
//
// with le(s) = clamp (2/pi) atanf(s / clamp). The backward modes store h,
// the cotangents gr = [gs | gt] of r and dx_aff instead of y.
//
// Every product is an implicit GEMM on the tensor cores in 3xTF32
// (tf32_mma.cuh: mma.sync.m16n8k8, hi = cvt.rna(a), lo = tf32(a - hi), lo hi
// + hi lo + hi hi; every run of at most 12 mma, 4 k-steps, starts from 0 and
// is added to the running fp32 sum). A is read by address from a window of
// the input in shared memory, K in (tap, channel) order, so no im2col is
// written anywhere; B is a weight operand packed on every call by
// `pack3_kernel` (zero padded, each element as its (hi, lo) pair) and
// streamed through shared memory in 32-row slices of 16-byte cp.async, two
// or three slots in flight.
//
// The fused kernel's plan. A block of 8 warps owns an 8 x tw tile of output
// pixels of one image. x_in on the tile with a 2-pixel halo stays in shared
// memory (Cin padded to 8 with zeros, a pixel every Cin8 + 4 floats). The
// hidden width goes in chunks of 32 channels: conv1 computes the chunk of h
// on the tile and its 1-pixel halo (10 x (tw + 2) pixels: M = 10 (tw + 2),
// K = 9 Cin8, N = 32) into shared memory, 0 outside the image (conv2's zero
// padding, not relu(b1)); conv2 adds the chunk's share of r (M = 8 tw, K =
// 9 x 32, N = 2 Caff8) to accumulators that stay in registers over all
// chunks. So only a chunk of h is ever held, and the tile can be wide:
//   Caff <= 24 (3 [s | t] pairs): 8 x 32 tiles, one conv2 task a warp, conv1
//     1.33x the tile's pixels (10 x 34 / 256);
//   Caff <= 96: 8 x 16 tiles, two conv2 tasks a warp, conv1 1.41x;
//   up to Caff 384: narrower tiles, two tasks a warp (plan_half). A Cin
//   whose x window does not fit takes a narrower tile, down to 8 x 4.
// A conv2 task is 32 pixels x 6 n8 tiles (three pairs of 8 channels of s
// and their 8 of t), so a thread holds s and t of the same channels and
// the affine step runs in registers; a conv1 task is 32 pixels x the
// chunk's 32 columns.
// Shared memory at the SRF flagship's octaves: Cin 24 / Caff 24, 8 x 32
// tiles: x 48.4 KB, h chunk 49.0 KB, three 13.3 KB weight slots: 137.6 KB;
// Cin 96 / Caff 96, 8 x 16 tiles: x 96.0 KB, h chunk 25.9 KB, two 50.2 KB
// slots: 222.3 KB. One block an SM either way, 234-255 registers a thread:
// the conv2 sums of all chunks stay in registers.

#pragma once

#include "tf32_mma.cuh"

namespace k8 {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;          // output tile rows
constexpr int kHC = 32;         // hidden chunk of the fused kernel
constexpr int kSlice = 32;      // k rows of a weight slice: 4 k-steps
constexpr int kLdC = 36;        // shared pixel stride of a 32-channel window
constexpr int kNT1 = 4;         // n8 tiles of a conv1 task (the chunk)
constexpr int kNT2 = 6;         // n8 tiles of a conv2 task: 3 [s | t] pairs

enum Mode { kForward = 0, kInverse = 1, kBackward = 2, kBackwardInverse = 3 };

// d/ds le(s) = (2/pi) / (1 + (s / clamp)^2)
__device__ __forceinline__ float log_e_prime(float s, float clamp) {
  const float u = s / clamp;
  return 0.636619772367581343f / (1.f + u * u);
}

// ---- packing the weights ----

// One operand to pack. A 3x3 weight w (OIHW: cout, cin, 3, 3) becomes the
// (9 rp, cp) row-major operand B[tap rp + r][c], each element as its TF32
// (hi, lo) pair, rows and columns past the real ones 0:
//   flip = 0: B[tap rp + r][c] = w[o(c)][r][tap]       the convolution
//   flip = 1: B[tap rp + r][c] = w[r][c][8 - tap]      its transpose
// o(c) = c, or with paired = L > 0 the columns as pairs of 8-column tiles
// [s | t]: tile 2q is s = channel 8q + j, tile 2q + 1 t = channel L + 8q + j.
// A bias (bias = 1) becomes cp floats b[o(c)].
struct Pack {
  long long dst;        // floats into the packed buffer
  const float* src;
  int cout, cin;        // of w; a bias: cout its length
  int rp, cp;           // rows a tap, columns
  int flip, paired, bias;
};
constexpr int kPacks = 6;
struct Packs {
  Pack p[kPacks];
  int count;
};

// o(c) and whether column c is real
__device__ __forceinline__ int pack_channel(const Pack& d, int c, int real,
                                            bool* ok) {
  if (d.paired) {
    const int ch = 8 * (c / 16) + (c & 7);
    *ok = ch < d.paired;
    return (c & 8) ? d.paired + ch : ch;
  }
  *ok = c < real;
  return c;
}

__global__ void __launch_bounds__(256) pack3_kernel(Packs ps,
                                                    float* __restrict__ out) {
  const Pack& d = ps.p[blockIdx.y];
  const long long total = d.bias ? d.cp : 9LL * d.rp * d.cp;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % d.cp);
    const int row = (int)(e / d.cp);
    bool ok;
    if (d.bias) {
      const int o = pack_channel(d, c, d.cout, &ok);
      out[d.dst + e] = ok ? __ldg(d.src + o) : 0.f;
      continue;
    }
    const int tap = row / d.rp, r = row % d.rp;
    float v = 0.f;
    if (!d.flip) {
      const int o = pack_channel(d, c, d.cout, &ok);
      if (ok && r < d.cin)
        v = __ldg(d.src + ((long long)o * d.cin + r) * 9 + tap);
    } else if (r < d.cout && c < d.cin) {
      v = __ldg(d.src + ((long long)r * d.cin + c) * 9 + 8 - tap);
    }
    uint32_t hi, lo;
    split(v, hi, lo);
    out[d.dst + 2 * e] = __uint_as_float(hi);
    out[d.dst + 2 * e + 1] = __uint_as_float(lo);
  }
}

inline cudaError_t pack3(const Packs& ps, float* out, cudaStream_t s) {
  long long most = 0;
  for (int i = 0; i < ps.count; ++i) {
    const Pack& d = ps.p[i];
    const long long n = d.bias ? d.cp : 9LL * d.rp * d.cp;
    most = n > most ? n : most;
  }
  long long gx = (most + 255) / 256;
  if (gx > 1024) gx = 1024;
  pack3_kernel<<<dim3((unsigned)gx, (unsigned)ps.count), 256, 0, s>>>(ps,
                                                                      out);
  return cudaGetLastError();
}

// ---- the product on one weight slice ----

// acc += A B over `nks` k-steps of a slice for one warp task: 32 rows (two
// m16 tiles) by kNT n8 tiles, of which the first `live` are real. rows[q]
// is the shared-memory offset (floats, with the lane's k column tq) of the
// task's row 8 q + gq; aoff(ks) the offset of k-step ks's first channel
// from a row's; b points at the slice's row tq, column 2 gq of the task's
// first tile ((hi, lo) pairs, `ldb` floats a row). Each run of at most 4
// k-steps (12 mma a tile) sums from 0 and is added to acc in fp32; the
// three products of a k-step go round all the task's tiles in turn, so a
// warp has 2 kNT independent chains in flight.
template <int kNT, typename AOff>
__device__ __forceinline__ void run_slice(float (&acc)[2][kNT][4],
                                          const float* as,
                                          const int (&rows)[4], AOff aoff,
                                          const float* b, int ldb, int live,
                                          int nks) {
  for (int r0 = 0; r0 < nks; r0 += 4) {
    float t[2][kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[i][g][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ks = r0 + s;
      if (ks >= nks) break;
      const int o = aoff(ks);
      // A: a0 (row gq, k tq), a1 (row gq + 8), a2 (k tq + 4), a3 (both)
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p0 = as + rows[2 * i] + o;
        const float* p1 = as + rows[2 * i + 1] + o;
        split(p0[0], hi[i][0], lo[i][0]);
        split(p1[0], hi[i][1], lo[i][1]);
        split(p0[4], hi[i][2], lo[i][2]);
        split(p1[4], hi[i][3], lo[i][3]);
      }
      const float* bk = b + 8 * ks * ldb;
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int g = 0; g < kNT; ++g) {
        if (g >= live) continue;
        const float2 b0 = *reinterpret_cast<const float2*>(bk + 16 * g);
        const float2 b1 =
            *reinterpret_cast<const float2*>(bk + 4 * ldb + 16 * g);
        bh[g][0] = __float_as_uint(b0.x);
        bl[g][0] = __float_as_uint(b0.y);
        bh[g][1] = __float_as_uint(b1.x);
        bl[g][1] = __float_as_uint(b1.y);
      }
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (g < live) mma(t[i][g], lo[i], bh[g][0], bh[g][1]);
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (g < live) mma(t[i][g], hi[i], bl[g][0], bl[g][1]);
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (g < live) mma(t[i][g], hi[i], bh[g][0], bh[g][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] += t[i][g][e];
  }
}

// Waits for the slice `i` of a stream of `total` 32-row slices in a ring of
// `ns` slots (2 or 3), then queues slice i + ns - 1 with issue(j) into slot
// j % ns. The barrier also orders every warp's use of the slot it refills
// and of any buffer the caller wrote before it.
template <typename Issue>
__device__ __forceinline__ void ring_step(int i, int total, int ns,
                                          Issue issue) {
  if (ns == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
  __syncthreads();
  if (i + ns - 1 < total) issue(i + ns - 1);
  cp_async_commit();
}

// ---- the fused half coupling ----

struct HalfArgs {
  const float* x_in;   // (N, H, W, Cin)
  const float* x_aff;  // (N, H, W, Caff)
  const float* g;      // (N, H, W, Caff): cotangent of y (backward modes)
  float* out;          // y, or dx_aff in the backward modes
  float* h_out;        // (N, H, W, hp): h (backward modes)
  float* gr_out;       // (N, H, W, 2 Caff): [gs | gt] (backward modes)
  const float* w1;     // packed (9 cin8, hp) pairs
  const float* b1;     // (hp)
  const float* w2;     // packed (9 hp, n2p) pairs, [s | t] tile pairs
  const float* b2;     // (n2p), the same columns
  int n, h, w, cin, cin8, caff, hp, n2p, tw, ns;
  float clamp;
};

__host__ __device__ inline int slot_floats(int n2p) {
  const int ld1 = 2 * kHC + 8, ld2 = 2 * n2p + 8;
  return kSlice * (ld1 > ld2 ? ld1 : ld2);
}

// Floats of dynamic shared memory of a block with tw-wide tiles.
__host__ __device__ inline long long half_smem_floats(int tw, int cin8,
                                                      int n2p, int ns) {
  return (long long)(kTH + 4) * (tw + 4) * (cin8 + 4) +
         (long long)(kTH + 2) * (tw + 2) * kLdC +
         (long long)ns * slot_floats(n2p);
}

// kT2: conv2 tasks a warp (1 for Caff <= 48, else 2); conv1 tasks a warp
// follow from the tile: at most 2 (8 x 32: 11 of 32 rows).
template <int kMode, int kT2>
__global__ void __launch_bounds__(kThreads, 1)
half_coupling_3x3_kernel(HalfArgs a) {
  constexpr int kT1 = kT2 == 1 ? 2 : 1;
  extern __shared__ __align__(16) float smem[];
  const int tw = a.tw;
  const int tiles_x = (a.w + tw - 1) / tw;
  const int tiles_y = (a.h + kTH - 1) / kTH;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * kTH, x0 = tx * tw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int xw = tw + 4, hw = tw + 2;      // widths of the x window, h tile
  const int ldx = a.cin8 + 4;              // 4 mod 8: no bank conflicts
  const int m1 = (kTH + 2) * hw, mt1 = (m1 + 31) / 32;
  const int mt2 = tw / 4;                  // 8 tw = 32 mt2 output pixels
  const int k1 = 9 * a.cin8, nk1 = (k1 + kSlice - 1) / kSlice;
  const int per = nk1 + 9, total = (a.hp / kHC) * per;
  const int ntiles2 = a.n2p / 8, groups2 = (ntiles2 + kNT2 - 1) / kNT2;
  const int ld1 = 2 * kHC + 8, ld2 = 2 * a.n2p + 8;   // 8 mod 32
  const int slot = slot_floats(a.n2p);
  float* const xs = smem;
  float* const hs = xs + (kTH + 4) * xw * ldx;
  float* const ring = hs + m1 * kLdC;

  // slice j of chunk c: conv1's rows 32 j.. of W1, the chunk's 32 columns;
  // then conv2's tap t: rows t hp + 32 c .. + 32 of W2, every column
  auto issue = [&](int i) {
    float* dst = ring + (i % a.ns) * slot;
    const int c = i / per, j = i % per;
    if (j < nk1) {
      for (int s = threadIdx.x; s < kSlice * (2 * kHC / 4); s += kThreads) {
        const int r = s / (2 * kHC / 4), q = 4 * (s % (2 * kHC / 4));
        const int row = j * kSlice + r;
        const bool ok = row < k1;
        cp_async16(dst + r * ld1 + q,
                   ok ? a.w1 + 2 * ((size_t)row * a.hp + c * kHC) + q : a.w1,
                   ok);
      }
    } else {
      const int row0 = (j - nk1) * a.hp + c * kHC;
      const int per_row = a.n2p / 2;
      for (int s = threadIdx.x; s < kSlice * per_row; s += kThreads) {
        const int r = s / per_row, q = 4 * (s % per_row);
        cp_async16(dst + r * ld2 + q,
                   a.w2 + 2 * (size_t)(row0 + r) * a.n2p + q, true);
      }
    }
  };
  for (int s = 0; s < a.ns - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  // x_in on the tile with a 2-pixel halo; 0 outside the image and in the
  // padding channels
  {
    const float* img = a.x_in + (size_t)n * a.h * a.w * a.cin;
    const int count = (kTH + 4) * xw * a.cin8;
    for (int idx = threadIdx.x; idx < count; idx += kThreads) {
      const int c = idx % a.cin8, px = idx / a.cin8;
      const int gy = y0 - 2 + px / xw, gx = x0 - 2 + px % xw;
      xs[px * ldx + c] =
          (c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.w)
              ? __ldg(img + ((size_t)gy * a.w + gx) * a.cin + c)
              : 0.f;
    }
  }

  // each task's rows: conv1 on the h tile (rows past m1 repeat its last
  // pixel and are never stored), conv2 on the output tile
  int rows1[kT1][4], rows2[kT2][4];
#pragma unroll
  for (int t = 0; t < kT1; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = min(32 * (warp + kWarps * t) + 8 * q + gq, m1 - 1);
      rows1[t][q] = ((p / hw) * xw + p % hw) * ldx + tq;
    }
#pragma unroll
  for (int t = 0; t < kT2; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 32 * ((warp + kWarps * t) % mt2) + 8 * q + gq;
      rows2[t][q] = ((p / tw) * hw + p % tw) * kLdC + tq;
    }

  float acc2[kT2][2][kNT2][4];
#pragma unroll
  for (int t = 0; t < kT2; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kNT2; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[t][i][g][e] = 0.f;

  int i = 0;
  for (int c = 0; c < a.hp / kHC; ++c) {
    float acc1[kT1][2][kNT1][4];
#pragma unroll
    for (int t = 0; t < kT1; ++t)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int g = 0; g < kNT1; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[t][ii][g][e] = 0.f;
    for (int j = 0; j < nk1; ++j, ++i) {
      ring_step(i, total, a.ns, issue);
      const float* b = ring + (i % a.ns) * slot + tq * ld1 + 2 * gq;
      const int k0 = j * kSlice;
      auto aoff = [&](int ks) {
        const int k = k0 + 8 * ks;
        const int tap = k / a.cin8;
        return ((tap / 3) * xw + tap % 3) * ldx + k - tap * a.cin8;
      };
#pragma unroll
      for (int t = 0; t < kT1; ++t)
        if (warp + kWarps * t < mt1)
          run_slice<kNT1>(acc1[t], xs, rows1[t], aoff, b, ld1, kNT1,
                          min(4, (k1 - k0) / 8));
    }
    // the chunk of h: relu(conv1 + b1) on the h tile, 0 outside the image;
    // the backward modes also store it at the tile's own pixels
#pragma unroll
    for (int t = 0; t < kT1; ++t) {
      if (warp + kWarps * t >= mt1) continue;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int g = 0; g < kNT1; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 32 * (warp + kWarps * t) + 16 * ii + gq +
                          (e >= 2 ? 8 : 0);
            if (p >= m1) continue;
            const int col = 8 * g + 2 * tq + (e & 1);
            const int hy = p / hw, hx = p % hw;
            const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
            const bool inside = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
            const float v =
                inside ? fmaxf(acc1[t][ii][g][e] +
                                   __ldg(a.b1 + c * kHC + col), 0.f)
                       : 0.f;
            hs[p * kLdC + col] = v;
            if (kMode >= kBackward && inside && hy >= 1 && hy <= kTH &&
                hx >= 1 && hx <= tw)
              a.h_out[(((size_t)n * a.h + gy) * a.w + gx) * a.hp +
                      c * kHC + col] = v;
          }
    }
    // conv2: the chunk's share of r, tap by tap
    for (int tap = 0; tap < 9; ++tap, ++i) {
      ring_step(i, total, a.ns, issue);
      const float* b = ring + (i % a.ns) * slot + tq * ld2 + 2 * gq;
      const int toff = ((tap / 3) * hw + tap % 3) * kLdC;
      auto aoff = [&](int ks) { return toff + 8 * ks; };
#pragma unroll
      for (int t = 0; t < kT2; ++t) {
        const int gi = (warp + kWarps * t) / mt2;
        if (gi < groups2)
          run_slice<kNT2>(acc2[t], hs, rows2[t], aoff, b + 16 * kNT2 * gi,
                          ld2, min(kNT2, ntiles2 - kNT2 * gi), 4);
      }
    }
  }

  // the affine step: tile 2q of a task holds s of 8 channels, 2q + 1 t of
  // the same
#pragma unroll
  for (int t = 0; t < kT2; ++t) {
    const int task = warp + kWarps * t;
    const int mi = task % mt2, gi = task / mt2;
    if (gi >= groups2) continue;
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int g = 0; g < kNT2; g += 2) {
        const int tile = kNT2 * gi + g;
        if (tile >= ntiles2) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 32 * mi + 16 * ii + gq + (e >= 2 ? 8 : 0);
          const int gy = y0 + p / tw, gx = x0 + p % tw;
          const int w8 = 2 * tq + (e & 1);
          const int ch = 4 * tile + w8;
          if (gy >= a.h || gx >= a.w || ch >= a.caff) continue;
          const size_t pix = ((size_t)n * a.h + gy) * a.w + gx;
          const float s = acc2[t][ii][g][e] + __ldg(a.b2 + 8 * tile + w8);
          const float tt =
              acc2[t][ii][g + 1][e] + __ldg(a.b2 + 8 * tile + 8 + w8);
          const float xa = __ldg(a.x_aff + pix * a.caff + ch);
          const float le = log_e(s, a.clamp);
          if (kMode == kForward) {
            a.out[pix * a.caff + ch] = expf(le) * xa + tt;
          } else if (kMode == kInverse) {
            a.out[pix * a.caff + ch] = (xa - tt) * expf(-le);
          } else {
            const float gv = __ldg(a.g + pix * a.caff + ch);
            const float lp = log_e_prime(s, a.clamp);
            float gs, gt, dxa;
            if (kMode == kBackward) {
              const float ex = expf(le);
              gs = gv * xa * ex * lp;
              gt = gv;
              dxa = gv * ex;
            } else {
              const float einv = expf(-le);
              gs = -gv * ((xa - tt) * einv) * lp;
              gt = -gv * einv;
              dxa = gv * einv;
            }
            a.gr_out[pix * 2 * a.caff + ch] = gs;
            a.gr_out[pix * 2 * a.caff + a.caff + ch] = gt;
            a.out[pix * a.caff + ch] = dxa;
          }
        }
      }
  }
}

// ---- host side ----

struct Plan {
  int t2, tw, ns;
  long long smem;   // bytes
};

// The fused kernel's plan for Cin / Caff: the tile width, conv2 tasks a
// warp and weight slots. Returns -1 if Caff is too wide for any tile (over
// 384), else the bytes of shared memory of the block: the widest tile and
// the most slots (3, else 2) that fit kMaxSmem, or, when none fits, of the
// smallest (8 x 4 pixels, 2 slots), which is over kMaxSmem.
inline long long plan_half(int cin, int caff, Plan* p) {
  const int cin8 = round_up(cin, 8), n2p = 2 * round_up(caff, 8);
  const int groups = (n2p / 8 + kNT2 - 1) / kNT2;
  const int t2 = groups <= 2 ? 1 : 2;
  int mt = kWarps * t2 / groups;
  if (mt > (t2 == 1 ? 8 : 4)) mt = t2 == 1 ? 8 : 4;
  if (mt < 1) return -1;
  p->t2 = t2;
  for (; mt >= 1; --mt)
    for (int ns = 3; ns >= 2; --ns) {
      p->tw = 4 * mt;
      p->ns = ns;
      p->smem = 4 * half_smem_floats(p->tw, cin8, n2p, ns);
      if (p->smem <= kMaxSmem) return p->smem;
    }
  return p->smem;
}

// Floats of the fused kernel's packed weights: [w1 | b1 | w2 | b2].
struct HalfLayout {
  long long w1, b1, w2, b2, total;
};

inline long long align64(long long v) { return (v + 63) / 64 * 64; }

inline HalfLayout half_layout(int cin, int caff, int hid) {
  const int cin8 = round_up(cin, 8), hp = round_up(hid, kHC);
  const int n2p = 2 * round_up(caff, 8);
  HalfLayout l;
  l.w1 = 0;
  l.b1 = l.w1 + align64(2LL * 9 * cin8 * hp);
  l.w2 = l.b1 + align64(hp);
  l.b2 = l.w2 + align64(2LL * 9 * hp * n2p);
  l.total = l.b2 + align64(n2p);
  return l;
}

// The packs of the fused kernel's operands from the OIHW weights w1 (hid,
// cin, 3, 3) and w2 (2 caff, hid, 3, 3) and their biases.
inline void half_packs(Packs* ps, const HalfLayout& l, int cin, int caff,
                       int hid, const float* w1, const float* b1,
                       const float* w2, const float* b2) {
  const int cin8 = round_up(cin, 8), hp = round_up(hid, kHC);
  const int n2p = 2 * round_up(caff, 8);
  ps->p[0] = Pack{l.w1, w1, hid, cin, cin8, hp, 0, 0, 0};
  ps->p[1] = Pack{l.b1, b1, hid, 0, 1, hp, 0, 0, 1};
  ps->p[2] = Pack{l.w2, w2, 2 * caff, hid, hp, n2p, 0, caff, 0};
  ps->p[3] = Pack{l.b2, b2, 2 * caff, 0, 1, n2p, 0, caff, 1};
  ps->count = 4;
}

// Packs the OIHW weights into `packed` (half_layout floats), then runs the
// fused kernel in mode kMode on `s`; a's operands and plan are set here.
template <int kMode>
cudaError_t run_half(HalfArgs a, int hid, const float* w1, const float* b1,
                     const float* w2, const float* b2, float* packed,
                     cudaStream_t s) {
  Plan p;
  if (a.n <= 0 || a.h <= 0 || a.w <= 0 || a.cin <= 0 || a.caff <= 0 ||
      hid <= 0 || plan_half(a.cin, a.caff, &p) < 0 || p.smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const HalfLayout l = half_layout(a.cin, a.caff, hid);
  Packs ps;
  half_packs(&ps, l, a.cin, a.caff, hid, w1, b1, w2, b2);
  cudaError_t err = pack3(ps, packed, s);
  if (err != cudaSuccess) return err;
  a.w1 = packed + l.w1;
  a.b1 = packed + l.b1;
  a.w2 = packed + l.w2;
  a.b2 = packed + l.b2;
  a.cin8 = round_up(a.cin, 8);
  a.hp = round_up(hid, kHC);
  a.n2p = 2 * round_up(a.caff, 8);
  a.tw = p.tw;
  a.ns = p.ns;
  auto kernel = p.t2 == 1 ? half_coupling_3x3_kernel<kMode, 1>
                          : half_coupling_3x3_kernel<kMode, 2>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n * ((a.h + kTH - 1) / kTH) *
                           ((a.w + a.tw - 1) / a.tw);
  kernel<<<(unsigned)blocks, kThreads, p.smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace k8
