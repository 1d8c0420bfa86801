// Windowed bilinear forward splat (the region scatter), for sm_90a: bitwise
// repeatable sums in fixed point, one block per output sub-tile.
//
// Replaces the TPU kernel `_region_kernel` of sin_inn_tpu/ops/pallas/splat.py
// (called by `_splat_region_call`). A source pixel s = (sy, sx) of image b
// with flow f = (fx, fy) has the target t = (sy + fy, sx + fx) and adds
//
//   values[b, sy, sx, c] hat(ty - r) hat(tx - k),  hat(d) = max(1 - |d|, 0)
//
// to each output pixel (r, k) in {floor(ty), floor(ty) + 1} x {floor(tx),
// floor(tx) + 1} that lies in the image, but only if s lies in the source
// window the TPU kernel read for the 128 x 128 output tile (i, j) holding
// (r, k): rows [128 i - dy, 128 i - dy + SH), columns [128 j - dx,
// 128 j - dx + SW), with SH = 8 ceil((128 + 2 dy) / 8) and
// SW = 128 ceil((128 + 2 dx) / 128). So the result equals the TPU kernel's
// for every flow, in or out of the window: a tap the TPU kernel could not
// see is dropped here too.
//
// What bounds it on an H100: bytes. At the flow path's shape (1 x 436 x 1024,
// C = 5: a frame times exp(metric), exp(metric) and ones) one launch must
// read the values (8.93 MB) and the flow (3.57 MB) and write the output
// (8.93 MB): 21.4 MB, 0.0064 ms at 3.35 TB/s. The arithmetic is a few dozen
// FLOP per source pixel.
//
// The sums are taken in 64-bit fixed point, so that any order of the adds
// gives the same bits (integer addition is associative), as the JAX path is
// deterministic: each contribution v wr wk (fp32, as the plain version
// forms it) is rounded to an integer at the scale 2^q_c of its channel and
// added as an int64. One output pixel sums at most SH x SW sources (those
// of its tile's window), each at most |v| over its four taps (the hats sum
// to 1), so q_c = 62 - ceil(log2(SH SW max|v_c|)) keeps every partial sum
// under 2^62: no overflow whatever the order. At the path's values (in
// [0, 1]) and window (SH SW = 256 x 384) q is 45, a resolution of 3e-14,
// far below fp32's own rounding of the result. A contribution that is not
// finite (a value that is Inf or NaN) sets a flag of its output pixel and
// channel (+Inf, -Inf, NaN), and such a pixel gets what an fp32 sum gives:
// NaN if any NaN or both infinities reached it, else the infinity.
//
// What the design does about the bound: the window rule fixes, before the
// kernel runs, which sources can reach an output tile: those of its window.
// The TPU kernel used that to turn each tile's scatter into one-hot matmuls
// over the window; here one block owns a sub-tile of `rows` x 128 outputs
// (`rows_of`: 32 rows up to C = 6, 16 above) and keeps its fixed-point sums
// and flags in shared memory, so a launch has no global accumulator, no
// zero pass, no conversion pass and no global atomic, and its scratch is
// under 64 KB at the path's shape. Two kernels:
//   1. `summary_kernel`, one warp a chunk of 128 pixels of an image row:
//      the range of the chunk's target rows and columns (floor(ty),
//      floor(tx) clamped to [-2, size], 16 bytes a chunk), and for each
//      block of 16 chunks (a slot) the largest finite |v| of each channel
//      (as bits: a non-negative float orders as its bits) and whether any
//      value is not finite. It reads the values and the flow once (12.5 MB).
//   2. `splat_kernel`, one block a sub-tile: it reduces the slots (max and
//      or: order-free) into q_c and walks its tile's window a chunk at a
//      time. A chunk whose target range misses the sub-tile is skipped on
//      its 16 bytes of summary; the flow of the others is read (rows by
//      warp, columns by lane, one 8-byte pair a source, contiguous), a
//      source none of whose taps can land in the sub-tile is dropped after
//      a floor and two compares an axis, and the rest are queued per warp,
//      so that their values are read and their contributions added 32 at a
//      time, one source a lane: the long path never runs on a warp of one
//      or two lanes. Each contribution goes in with two native 32-bit
//      shared atomics, the low words of a tap's channels first and then
//      their carries into the high words (a 64-bit shared atomicAdd is a
//      compare-and-swap loop). The block then converts its own pixels in
//      place in shared memory and writes each output once, a sub-tile row
//      of contiguous floats at a time. The kernel is compiled for each C,
//      so that its loops over the channels and its divisions by C are
//      fixed.
// Without the summaries every sub-tile would read its tile's whole window
// of flow (8.06 M pixels, 64.5 MB at the path's shape, from L2), in one
// dependent load after another; with them a smooth flow reads a few rows
// of three chunk columns. What is left above the bound is the adds: each
// sub-tile takes its sources in one block, so a flow that converges (many
// sources onto a few pixels) loads the blocks that hold its targets more
// than the others, and the adds to one word serialize.
//
// A value that is Inf or NaN reaches every one of its four taps, a tap the
// window drops or one outside the image included (weight 0 at the clamped
// index 0, and Inf x 0 is NaN there), as in the plain version. A dropped
// tap lies in a tile whose window does not hold the source, so no scan
// finds it: when a slot of pass 1 names a non-finite value, each block also
// walks the slot's chunks and sets NaN at the taps in its sub-tile of each
// non-finite source outside its window. That path costs nothing on finite
// values, and then the adds skip every test of finiteness.
//
// The local-window form (`sininn_splat_region_local`) replaces the same TPU
// kernel as `_splat_region_call_local` runs it (local=True): each output
// tile's window is shifted by (ox, oy) = -off_out[b, i, j], the rounded
// mean flow of the tile's contributors (ops/offsets.py), and dy, dx are the
// local bounds: a tap (r, k) in tile (i, j) = (r / 128, k / 128) is kept iff
// s lies in rows [128 i - dy + oy, ... + SH) and columns [128 j - dx + ox,
// ... + SW). A block reads its tile's offset once and scans the shifted
// window. Source pixels outside the image do not exist here, which stands
// for the TPU kernel's zero padding (`top = loc_dy + cap_y`); the caps only
// size that padding, so this kernel does not take them. Bytes bound it as
// they bound the static form: 21.4 MB at the flow path's shape, 0.0064 ms
// at 3.35 TB/s.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;          // output tile rows and columns; chunk
constexpr int kMaxC = 8;            // channels: 3 flag bits each in 32 bits
constexpr int kThreads = 1024;      // a splat block
constexpr int kWarps = kThreads / 32;
constexpr int kSumWarps = 16;       // chunks a summary block, one a warp
constexpr int kMaxRows = 32;        // sub-tile rows where they fit
constexpr int kBatch = kTile / 32;  // sources a lane loads at once
constexpr int kQueue = 64;          // a warp's queue of hits
// dynamic shared memory a block may take: the card's 232,448 bytes less
// room for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// Flags of a pixel's word, three bits a channel.
constexpr unsigned kPosInf = 1u, kNegInf = 2u, kNaN = 4u;

// The scratch: a summary (int4: rows lo, hi, columns lo, hi) for each of
// `chunks` chunks, then c + 1 words for each of `slots` slots.
struct Layout {
  long long chunks, slots, bytes;
};

__host__ __device__ inline Layout layout_of(int n, int h, int w, int c) {
  Layout l;
  l.chunks = (long long)n * h * ((w + kTile - 1) / kTile);
  l.slots = (l.chunks + kSumWarps - 1) / kSumWarps;
  l.bytes = l.chunks * 16 + l.slots * (c + 1) * 4;
  return l;
}

// A splat block: `rows` x 128 outputs, 8 bytes a value and 4 a pixel of
// shared memory, then the warps' queues; 32 rows where they fit, else 16.
__host__ __device__ constexpr int smem_of(int rows, int c) {
  return rows * kTile * (8 * c + 4) + kWarps * kQueue * 4;
}

__host__ __device__ constexpr int rows_of(int c) {
  int rows = kMaxRows;
  while (smem_of(rows, c) > kMaxSmem) rows /= 2;
  return rows;
}

__device__ __forceinline__ float hat(float d) {
  return fmaxf(__fsub_rn(1.0f, fabsf(d)), 0.0f);
}

// The two taps of target coordinate t on an axis of `size` pixels: the
// plain version's, a tap outside the image with the clamped index 0.
__device__ __forceinline__ void tap_index(float t, int size, int idx[2]) {
  const float t0 = floorf(t);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float r = t0 + (float)q;
    idx[q] = (r >= 0.0f && r <= (float)(size - 1)) ? (int)r : 0;
  }
}

// Their weights: 0 outside the image.
__device__ __forceinline__ void tap_weight(float t, int size, float wt[2]) {
  const float t0 = floorf(t);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float r = t0 + (float)q;
    wt[q] = (r >= 0.0f && r <= (float)(size - 1)) ? hat(__fsub_rn(t, r))
                                                  : 0.0f;
  }
}

__device__ __forceinline__ bool inside(int t, int lo, int n) {
  return (unsigned)(t - lo) < (unsigned)n;
}

// q_c of the header: a power-of-two exponent such that span x max|v_c| x
// 2^q < 2^62, within fp32's normal range.
__device__ __forceinline__ int scale_exponent(unsigned vmax_bits,
                                              double span) {
  const double m = (double)__uint_as_float(vmax_bits);
  if (m == 0.0) return 0;
  int ex;
  frexp(span * m, &ex);    // span m < 2^ex
  const int q = 62 - ex;
  return q > 126 ? 126 : (q < -126 ? -126 : q);
}

// Widens [lo, hi] by floor(t) on an axis of `size` pixels, clamped to
// [-2, size]: below -1 both taps are outside the image, as at -2, and from
// size both are, as at size. A NaN target has both taps outside too, and
// fmaxf takes it to -2.
__device__ __forceinline__ void widen(float t, int size, int& lo, int& hi) {
  const int v = (int)fminf(fmaxf(floorf(t), -2.0f), (float)size);
  lo = min(lo, v);
  hi = max(hi, v);
}

// Whether a chunk whose targets' floors span [lo, hi] may send a tap to
// the sub-tile's [a0, a0 + na) of the axis: floor(t) in [a0 - 1,
// a0 + na - 1], or, where the sub-tile holds index 0, a tap outside the
// image (floor(t) < 0 or >= size - 1), which lands on 0 at weight 0 (it
// counts for a value that is not finite).
__device__ __forceinline__ bool spans(int lo, int hi, int a0, int na,
                                      int size) {
  return a0 == 0 ? (lo <= na - 1 || hi >= size - 1)
                 : (lo <= a0 + na - 1 && hi >= a0 - 1);
}

// The same test for one target: a superset of the sources with a tap in
// the sub-tile; `add_source` sorts the taps exactly.
__device__ __forceinline__ bool reaches(float t, int a0, int na, int size) {
  int lo = INT_MAX, hi = INT_MIN;
  widen(t, size, lo, hi);
  return spans(lo, hi, a0, na, size);
}

// Pass 1. Warp w of block g takes chunk 16 g + w: pixels [128 k, 128 k +
// 128) of image row bh = b h + sy. It writes the chunk's summary; the block
// writes slot g: the largest finite |v| of each channel over its chunks,
// then 1 if any of their values is not finite, else 0.
__global__ void __launch_bounds__(kSumWarps * 32)
summary_kernel(const float* __restrict__ values,
               const float2* __restrict__ flow, int h, int w, int c,
               long long chunks, int4* __restrict__ sums,
               unsigned* __restrict__ part) {
  __shared__ unsigned red[kSumWarps][kMaxC + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wb = (w + kTile - 1) / kTile;
  const long long id = (long long)blockIdx.x * kSumWarps + warp;
  unsigned m[kMaxC + 1];
#pragma unroll
  for (int ch = 0; ch <= kMaxC; ++ch) m[ch] = 0u;
  if (id < chunks) {
    const long long bh = id / wb;
    const int k = (int)(id - bh * wb);
    const int sy = (int)(bh % h);
    int rlo = INT_MAX, rhi = INT_MIN, clo = INT_MAX, chi = INT_MIN;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int sx = k * kTile + 32 * u + lane;
      if (sx >= w) continue;
      const long long p = bh * w + sx;
      const float2 f = flow[p];
      widen(__fadd_rn((float)sy, f.y), h, rlo, rhi);
      widen(__fadd_rn((float)sx, f.x), w, clo, chi);
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch) {
        if (ch < c) {
          const float v = fabsf(values[p * c + ch]);
          if (v <= 3.402823466e38f)    // Inf and NaN left out
            m[ch] = max(m[ch], __float_as_uint(v));
          else
            m[kMaxC] = 1u;
        }
      }
    }
    rlo = __reduce_min_sync(kFull, rlo);
    rhi = __reduce_max_sync(kFull, rhi);
    clo = __reduce_min_sync(kFull, clo);
    chi = __reduce_max_sync(kFull, chi);
    if (lane == 0) sums[id] = make_int4(rlo, rhi, clo, chi);
  }
#pragma unroll
  for (int ch = 0; ch <= kMaxC; ++ch) {
    m[ch] = __reduce_max_sync(kFull, m[ch]);
    if (lane == 0) red[warp][ch] = m[ch];
  }
  __syncthreads();
  if (threadIdx.x <= c) {
    const int ch = threadIdx.x < c ? threadIdx.x : kMaxC;
    unsigned v = 0u;
    for (int g = 0; g < kSumWarps; ++g) v = max(v, red[g][ch]);
    part[(long long)blockIdx.x * (c + 1) + threadIdx.x] = v;
  }
}

// What a splat block needs to know of its launch.
struct Geometry {
  int n, h, w;
  int dy, dx, sh, sw;    // the window bounds and the window
  long long chunks, slots;
};

// The contributions of source pixel q (sy w + sx of image offset img; -1:
// none) to the taps in the block's sub-tile (rows r0 + [0, nr), columns
// c0 + [0, nc)), whose tile's window holds the source, so every such tap
// is kept. The arithmetic is the plain version's: a tap of weight 0 is
// skipped unless a value is not finite. kFinite: no value of the launch is
// Inf or NaN (pass 1 says so), so no contribution is either, and a
// contribution of 0 may be added like any other.
//
// A sum is two 32-bit words: the low words add modulo 2^32, and an add
// that wraps one (old + lo < old) carries one into its high word, so each
// pair ends as the exact 64-bit sum, whatever the order.
template <int C, bool kFinite>
__device__ __forceinline__ void add_source(
    const float* __restrict__ values, const float2* __restrict__ flow,
    long long img, int q, const Geometry& g, int r0, int nr, int c0, int nc,
    const float* scale, u64* acc, unsigned* flags) {
  if (q < 0) return;
  const int sy = q / g.w, sx = q - sy * g.w;
  const long long p = img + q;
  const float2 f = flow[p];
  float v[C];
  bool finite = true;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    v[ch] = values[p * C + ch];
    if (!kFinite) finite = finite && isfinite(v[ch]);
  }
  const float ty = __fadd_rn((float)sy, f.y);
  const float tx = __fadd_rn((float)sx, f.x);
  int ir[2], ik[2];
  float wr[2], wk[2];
  tap_index(ty, g.h, ir);
  tap_index(tx, g.w, ik);
  tap_weight(ty, g.h, wr);
  tap_weight(tx, g.w, wk);
#pragma unroll
  for (int qr = 0; qr < 2; ++qr) {
#pragma unroll
    for (int qk = 0; qk < 2; ++qk) {
      if (!inside(ir[qr], r0, nr) || !inside(ik[qk], c0, nc)
          || (finite && (wr[qr] == 0.0f || wk[qk] == 0.0f)))
        continue;
      const int o = (ir[qr] - r0) * kTile + (ik[qk] - c0);
      unsigned* word = reinterpret_cast<unsigned*>(acc + o * C);
      long long x[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float t = __fmul_rn(__fmul_rn(v[ch], wr[qr]), wk[qk]);
        x[ch] = 0;
        if (kFinite || isfinite(t)) {
          x[ch] = __float2ll_rn(__fmul_rn(t, scale[ch]));
        } else {
          const unsigned fl = isnan(t) ? kNaN : (t > 0.0f ? kPosInf : kNegInf);
          atomicOr(flags + o, fl << (3 * ch));
        }
      }
      unsigned old[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        old[ch] = atomicAdd(word + 2 * ch, (unsigned)x[ch]);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const unsigned lo = (unsigned)x[ch];
        const unsigned up = (unsigned)((u64)x[ch] >> 32)
                            + (old[ch] + lo < old[ch] ? 1u : 0u);
        if (up != 0u) atomicAdd(word + 2 * ch + 1, up);
      }
    }
  }
}

// Pass 2. One block a sub-tile of kRows x 128 outputs: blockIdx.x =
// (b ceil(h / kRows) + sub-tile row) ceil(w / 128) + tile column. With
// kLocal, `off` holds the (n, hb, wb) output-tile offsets (ox, oy).
template <int C, bool kLocal>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ values, const float2* __restrict__ flow,
             const float2* __restrict__ off, const int4* __restrict__ sums,
             const unsigned* __restrict__ part, float* __restrict__ out,
             Geometry g) {
  constexpr int kRows = rows_of(C);
  constexpr int kCells = kRows * kTile;          // a sub-tile's pixels
  constexpr int kVals = kCells * C;
  constexpr int kPer = (kVals + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned vmax[kMaxC];
  __shared__ unsigned any_bad;
  __shared__ float scale[kMaxC];
  __shared__ double inv[kMaxC];
  const int h = g.h, w = g.w;
  const int wb = (w + kTile - 1) / kTile;
  const int srows = (h + kRows - 1) / kRows;
  const int j = blockIdx.x % wb;
  const int sr = (blockIdx.x / wb) % srows;
  const int b = blockIdx.x / wb / srows;
  const int r0 = sr * kRows, nr = min(kRows, h - r0);
  const int c0 = j * kTile, nc = min(kTile, w - c0);
  const int i = r0 / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  u64* acc = reinterpret_cast<u64*>(smem);                  // (kRows, 128, C)
  unsigned* flags = reinterpret_cast<unsigned*>(acc + kVals);  // (kRows, 128)

  for (int t = threadIdx.x; t < kVals; t += kThreads) acc[t] = 0ull;
  for (int t = threadIdx.x; t < kCells; t += kThreads) flags[t] = 0u;
  if (threadIdx.x < kMaxC) vmax[threadIdx.x] = 0u;
  if (threadIdx.x == 0) any_bad = 0u;
  __syncthreads();
  // the slots' maxima and flags, by warp (a slot's words loaded together)
  for (long long base = 0; base < g.slots; base += kThreads) {
    const long long s = base + threadIdx.x;
    const unsigned* q = part + s * (C + 1);
    unsigned word[C + 1];
#pragma unroll
    for (int ch = 0; ch <= C; ++ch) word[ch] = s < g.slots ? q[ch] : 0u;
#pragma unroll
    for (int ch = 0; ch <= C; ++ch) {
      const unsigned m = __reduce_max_sync(kFull, word[ch]);
      if (lane == 0 && m != 0u) atomicMax(ch < C ? vmax + ch : &any_bad, m);
    }
  }
  __syncthreads();
  if (threadIdx.x < C) {
    // exactly 2^q and 2^-q, built from their bits
    const int q = scale_exponent(vmax[threadIdx.x], (double)g.sh * g.sw);
    scale[threadIdx.x] = __int_as_float((q + 127) << 23);
    inv[threadIdx.x] = __longlong_as_double((long long)(1023 - q) << 52);
  }
  __syncthreads();

  // the window of the tile (i, j), shifted by -off_out with kLocal, and
  // its part in the image
  int oy = 0, ox = 0;
  if (kLocal) {
    const float2 o = off[((long long)b * ((h + kTile - 1) / kTile) + i) * wb
                         + j];
    ox = (int)(-o.x);
    oy = (int)(-o.y);
  }
  const int wy0 = i * kTile - g.dy + oy, wx0 = j * kTile - g.dx + ox;
  const int ys = max(wy0, 0), ye = min(wy0 + g.sh, h);
  const int xs = max(wx0, 0), xe = min(wx0 + g.sw, w);
  const long long img = (long long)b * h * w;
  const int4* rowsums = sums + (long long)b * h * wb;
  // the warp's queue of sources that may have a tap in the sub-tile: a
  // source is tested in a lane of its own, the hits are added 32 at a time,
  // one a lane, so the long path runs on full warps
  int* queue = reinterpret_cast<int*>(flags + kCells) + warp * kQueue;
  int queued = 0;
  const unsigned below = (1u << lane) - 1u;
  const bool finite = !any_bad;
  auto drain = [&](int q) {
    if (finite)
      add_source<C, true>(values, flow, img, q, g, r0, nr, c0, nc, scale,
                          acc, flags);
    else
      add_source<C, false>(values, flow, img, q, g, r0, nr, c0, nc, scale,
                           acc, flags);
  };
  // the warp's (row, chunk) pairs of the window, 32 at a time: a lane
  // loads one pair's summary, and the warp walks the chunks whose targets
  // may reach the sub-tile
  const int kx0 = xs / kTile;
  const int nk = xe > xs ? (xe - 1) / kTile - kx0 + 1 : 0;
  const int npair = ye > ys + warp ? (ye - ys - warp + kWarps - 1) / kWarps
                                     * nk : 0;
  for (int base = 0; base < npair; base += 32) {
    const int pi = base + lane;
    int my_sy = 0, my_k = 0;
    bool near = false;
    if (pi < npair) {
      my_sy = ys + warp + kWarps * (pi / nk);
      my_k = kx0 + pi % nk;
      const int4 sum = rowsums[(long long)my_sy * wb + my_k];
      near = spans(sum.x, sum.y, r0, nr, h) && spans(sum.z, sum.w, c0, nc, w);
    }
    for (unsigned todo = __ballot_sync(kFull, near); todo != 0u;
         todo &= todo - 1u) {
      const int sy = __shfl_sync(kFull, my_sy, __ffs(todo) - 1);
      const int k = __shfl_sync(kFull, my_k, __ffs(todo) - 1);
      const long long row = img + (long long)sy * w;
      // the chunk's sources in the window, kBatch a lane, their flow loads
      // in flight together
      float2 f[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int sx = k * kTile + 32 * u + lane;
        f[u] = sx >= xs && sx < xe ? flow[row + sx] : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int sx = k * kTile + 32 * u + lane;
        const bool hit = sx >= xs && sx < xe
                         && reaches(__fadd_rn((float)sy, f[u].y), r0, nr, h)
                         && reaches(__fadd_rn((float)sx, f[u].x), c0, nc, w);
        const unsigned m = __ballot_sync(kFull, hit);
        if (hit) queue[queued + __popc(m & below)] = sy * w + sx;
        queued += __popc(m);
        if (queued >= 32) {
          __syncwarp();
          const int q = queue[queued - 32 + lane];
          __syncwarp();
          queued -= 32;
          drain(q);
        }
      }
    }
  }
  __syncwarp();
  drain(lane < queued ? queue[lane] : -1);

  // non-finite sources outside the window: NaN at their taps in the
  // sub-tile, in each channel whose value is not finite (v wr 0); the
  // flagged slots' chunks, 8 at a time
  if (any_bad) {
    for (long long s = 0; s < g.slots; ++s) {
      if (!part[s * (C + 1) + C]) continue;
      for (int e = threadIdx.x; e < kSumWarps * kTile; e += kThreads) {
        const long long id = s * kSumWarps + e / kTile;
        if (id >= g.chunks) break;
        const long long bh = id / wb;
        const int sx = (int)(id - bh * wb) * kTile + e % kTile;
        if (bh / h != b || sx >= w) continue;
        const int sy = (int)(bh % h);
        if (inside(sy, wy0, g.sh) && inside(sx, wx0, g.sw)) continue;
        const long long p = bh * w + sx;
        unsigned bits = 0u;
#pragma unroll
        for (int ch = 0; ch < C; ++ch)
          if (!isfinite(values[p * C + ch])) bits |= kNaN << (3 * ch);
        if (bits == 0u) continue;
        int ir[2], ik[2];
        tap_index(__fadd_rn((float)sy, flow[p].y), h, ir);
        tap_index(__fadd_rn((float)sx, flow[p].x), w, ik);
#pragma unroll
        for (int qr = 0; qr < 2; ++qr)
#pragma unroll
          for (int qk = 0; qk < 2; ++qk)
            if (inside(ir[qr], r0, nr) && inside(ik[qk], c0, nc))
              atomicOr(flags + (ir[qr] - r0) * kTile + ik[qk] - c0, bits);
      }
    }
  }
  __syncthreads();

  // out = sum 2^-q_c rounded once to fp32, or the non-finite value the
  // flags name: converted in place (the floats overwrite the sums in
  // shared memory once all are read), then written out a sub-tile row at a
  // time, contiguous
  float val[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    val[k] = 0.0f;
    if (e >= kVals) continue;
    const int o = e / C, ch = e - o * C;
    const unsigned f = (flags[o] >> (3 * ch)) & 7u;
    if (f == 0u) {
      val[k] = __double2float_rn(__ll2double_rn((long long)acc[e]) * inv[ch]);
    } else if ((f & kNaN) || f == (kPosInf | kNegInf)) {
      val[k] = __int_as_float(0x7fc00000);
    } else {
      val[k] = __int_as_float(f == kPosInf ? 0x7f800000 : 0xff800000);
    }
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < kVals) stage[e] = val[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int ry = e / (kTile * C), xc = e - ry * (kTile * C);
    if (e < kVals && ry < nr && xc < nc * C)
      out[(img + (long long)(r0 + ry) * w + c0) * C + xc] = stage[e];
  }
}

// One splat launch at C channels (the kernel's loops and shared layout
// are fixed by C).
template <int C, bool kLocal>
int splat_launch(const float* values, const float2* flow, const float2* off,
                 const int4* sums, const unsigned* part, float* out,
                 const Geometry& g, cudaStream_t st) {
  constexpr int rows = rows_of(C), smem = smem_of(rows, C);
  const long long blocks = (long long)g.n * ((g.h + rows - 1) / rows)
                           * ((g.w + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      splat_kernel<C, kLocal>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  splat_kernel<C, kLocal><<<(unsigned)blocks, kThreads, smem, st>>>(
      values, flow, off, sums, part, out, g);
  return (int)cudaGetLastError();
}

template <bool kLocal>
int launch(const float* values, const float* flow, const float* off,
           float* out, void* scratch, int n, int h, int w, int c, int dy,
           int dx, int sh, int sw, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > kMaxC || dy < 0 || dx < 0
      || sh <= 0 || sw <= 0 || scratch == nullptr || (kLocal && off == nullptr)
      || reinterpret_cast<uintptr_t>(flow) % 8 != 0
      || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = layout_of(n, h, w, c);
  if (l.slots > 0x7fffffffLL || (long long)h * w > 0x7fffffffLL
      || h > (1 << 24) || w > (1 << 24))
    return (int)cudaErrorInvalidValue;    // (sizes exact as floats)
  int4* sums = static_cast<int4*>(scratch);
  unsigned* part = reinterpret_cast<unsigned*>(sums + l.chunks);
  const float2* flow2 = reinterpret_cast<const float2*>(flow);
  const float2* off2 = reinterpret_cast<const float2*>(off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  summary_kernel<<<(unsigned)l.slots, kSumWarps * 32, 0, st>>>(
      values, flow2, h, w, c, l.chunks, sums, part);
  Geometry g;
  g.n = n; g.h = h; g.w = w;
  g.dy = dy; g.dx = dx; g.sh = sh; g.sw = sw;
  g.chunks = l.chunks;
  g.slots = l.slots;
  typedef int (*Launch)(const float*, const float2*, const float2*,
                        const int4*, const unsigned*, float*,
                        const Geometry&, cudaStream_t);
  const Launch by_c[kMaxC] = {
      splat_launch<1, kLocal>, splat_launch<2, kLocal>,
      splat_launch<3, kLocal>, splat_launch<4, kLocal>,
      splat_launch<5, kLocal>, splat_launch<6, kLocal>,
      splat_launch<7, kLocal>, splat_launch<8, kLocal>};
  return by_c[c - 1](values, flow2, off2, sums, part, out, g, st);
}

}  // namespace

extern "C" {

// 8-byte words of scratch one launch over n x h x w pixels of c channels
// needs: 16 bytes a chunk of 128 pixels of a row, then c + 1 words of 4
// bytes a slot of 16 chunks.
long long sininn_splat_region_scratch(int n, int h, int w, int c) {
  return (layout_of(n, h, w, c).bytes + 7) / 8;
}

// The plan of a launch on c channels into out[2]: a block's sub-tile rows
// and its bytes of dynamic shared memory. Returns 0, or -1 for a c the
// kernel does not take.
int sininn_splat_region_plan(int c, int* out) {
  if (c <= 0 || c > kMaxC) return -1;
  out[0] = rows_of(c);
  out[1] = smem_of(out[0], c);
  return 0;
}

// One launch on `stream`, writing all of `out`. values: (n, h, w, c) fp32
// (c <= 8), flow: (n, h, w, 2) fp32 (dx, dy), 8-byte aligned, out:
// (n, h, w, c) fp32, all contiguous; scratch: sininn_splat_region_scratch
// words, 16-byte aligned, no contents needed. dy, dx: the window bounds;
// sh, sw: the window's rows and columns. Returns a cudaError_t.
int sininn_splat_region(const float* values, const float* flow, float* out,
                        void* scratch, int n, int h, int w, int c, int dy,
                        int dx, int sh, int sw, void* stream) {
  return launch<false>(values, flow, nullptr, out, scratch, n, h, w, c, dy,
                       dx, sh, sw, stream);
}

// The local-window form: off_out is (n, ceil(h / 128), ceil(w / 128), 2)
// fp32, contiguous and 8-byte aligned, integer-valued (ox, oy); dy, dx are
// the local bounds and sh, sw the window they give. Returns a cudaError_t.
int sininn_splat_region_local(const float* values, const float* flow,
                              const float* off_out, float* out,
                              void* scratch, int n, int h, int w, int c,
                              int dy, int dx, int sh, int sw, void* stream) {
  return launch<true>(values, flow, off_out, out, scratch, n, h, w, c, dy,
                      dx, sh, sw, stream);
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
