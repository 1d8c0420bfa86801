// K8 backward: the VJP of one GLOW half coupling with 3x3-conv subnets, for
// the forward and the inverse flag, for sm_90a, every product on the tensor
// cores in 3xTF32.
//
// Replaces `_half_band_bwd_kernel` (sin_inn_tpu/ops/pallas/coupling3x3.py
// :381), the TPU's fused VJP of one half on row bands: dx_in, dx_aff, dW1,
// db1, dW2, db2 for the cotangent g of y. Here it is a pack and four
// stages, with h, gz and gr written to device memory between them (h and gz
// are 115 MB each at the flagship's first octave, batch 8):
//
//   0. pack3_kernel (coupling_3x3.cuh) packs, on every call, W1 and W2 for
//      the convolutions and their flipped transposes W2t, W1t for stages
//      2-3, zero padded, each element as its TF32 (hi, lo) pair.
//   1. the fused kernel of csrc/coupling_3x3.cuh in a backward mode:
//      recompute h and [s | t] per tile (conv1 on a 1-pixel halo), store h
//      and gr = [gs | gt] at the tile's own pixels, and dx_aff. Forward
//      flag: gs = g x_aff e le'(s), gt = g, dx_aff = g e, e = exp(le(s));
//      inverse flag: gs = -g x_out le'(s), gt = -g e^-1, dx_aff = g e^-1,
//      x_out = (x_aff - t) e^-1.
//   2. gz = conv3x3(gr, W2t) where h > 0, else 0 (the relu gate), at image
//      pixels only: gz is 0 outside the image, so no gradient flows through
//      conv2's zero padding into conv1 or the weights.
//   3. dx_in = conv3x3(gz, W1t).
//   4. the weight and bias gradients, [dW1 | db1] = im2col(x_in)^T gz and
//      [dW2 | db2] = im2col(h)^T gr (the biases: column sums of gz, gr), as
//      split-K products over chunks of pixels in weight_stage.cuh with U
//      gathered from x_in and h by 3x3 window (im2col(h) would be 1.04 GB
//      at the first octave, batch 8: it is never written). Each block writes
//      its tile of one chunk's products into that chunk's slot of a
//      partials buffer, and the reduction of csrc/coupling_1x1_bwd.cu sums
//      the slots in a fixed order. No atomics: the backward is bitwise
//      repeatable, as the TPU's sequential grid accumulation is.
//
// What bounds it on an H100: the products, 112.1 GFLOP a half at batch 8 at
// either flagship octave (the recompute, the two transposed convolutions
// and the two weight products; 1.673 ms at the fp32 peak, 0.679 ms of TF32
// work at the dense TF32 peak run as 3xTF32) against under 1 GB of traffic.
// Stages 2-3 are one implicit-GEMM body (`conv3x3_kernel`): an 8 x tw tile
// of output pixels a block, the input's 1-pixel-halo window loaded by
// cp.async 32 channels at a time (double buffered, 0 outside the image),
// the weight slices streamed as in the fused kernel, 8 warps of 32-pixel
// tasks; no recompute, the gate in the epilogue. Stage 2 (N = hidden 256):
// 8 x 16 tiles, each block 128 of the columns, two 32 x 32 tasks a warp;
// stage 3 (N = Cin): 8 x 32 tiles at Cin 24, 8 x 16 at Cin 96, one 32 x 48
// task a warp.

#include "coupling_3x3.cuh"
#include "weight_stage.cuh"

namespace {

using k8::kLdC;
using k8::kSlice;
using k8::kTH;
using k8::kThreads;
using k8::kWarps;

constexpr int kMinChunkRows = 1024;   // least pixels of a gradient slot

struct ConvArgs {
  const float* in;     // (n, h, w, cin) NHWC, cin a multiple of 4
  int cin, cinp;       // cinp = cin rounded up to 32
  const float* b;      // packed (9 cinp, np) (hi, lo) pairs
  int np;              // a multiple of 8
  const float* gate;   // (n, h, w, ldo): out = 0 where gate <= 0; or null
  float* out;          // (n, h, w, ldo): columns < nout written
  int ldo, nout;
  int n, h, w, tw, gpb, ns;   // tile width, column groups a block, slots
};

// out = conv3x3(in, B) (SAME, no bias) at every image pixel, gated with
// kGate. blockIdx.x: an 8 x tw tile of one image; blockIdx.y: a block of
// gpb column groups of kNT n8 tiles. Slice i of the weight stream is
// (channel chunk i / 9, tap i % 9): rows tap cinp + 32 chunk.. of B; the
// chunk's 32-channel window comes in with the chunk's first tap.
template <bool kGate, int kNT, int kT>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tw = a.tw, ww = tw + 2;
  const int tiles_x = (a.w + tw - 1) / tw;
  const int tiles_y = (a.h + kTH - 1) / kTH;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * kTH, x0 = tx * tw;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ntiles = a.np / 8;
  const int groups = (ntiles + kNT - 1) / kNT;
  const int g0 = blockIdx.y * a.gpb;            // the block's first group
  const int ncol = 8 * kNT * a.gpb;             // the block's columns
  const int ldb = 2 * ncol + 8;                 // 8 mod 32
  const int mt = tw / 4;                        // 8 tw = 32 mt pixels
  const int win = (kTH + 2) * ww * kLdC;
  const int slot = kSlice * ldb;
  const int total = (a.cinp / 32) * 9;
  float* const wins = smem;                     // two chunk windows
  float* const ring = smem + 2 * win;

  auto issue = [&](int i) {
    const int cc = i / 9, tap = i % 9;
    if (tap == 0) {
      float* dst = wins + (cc & 1) * win;
      for (int s = threadIdx.x; s < (kTH + 2) * ww * 8; s += kThreads) {
        const int px = s / 8, c = 32 * cc + 4 * (s % 8);
        const int gy = y0 - 1 + px / ww, gx = x0 - 1 + px % ww;
        const bool ok = c < a.cin && gy >= 0 && gy < a.h && gx >= 0 &&
                        gx < a.w;
        cp_async16(dst + px * kLdC + 4 * (s % 8),
                   ok ? a.in + (((size_t)n * a.h + gy) * a.w + gx) * a.cin + c
                      : a.in,
                   ok);
      }
    }
    float* dst = ring + (i % a.ns) * slot;
    const int row0 = tap * a.cinp + 32 * cc;
    const int per_row = ncol / 2;
    for (int s = threadIdx.x; s < kSlice * per_row; s += kThreads) {
      const int r = s / per_row, q = 4 * (s % per_row);
      const int col = 8 * kNT * g0 + q / 2;
      const bool ok = col < a.np;
      cp_async16(dst + r * ldb + q,
                 ok ? a.b + 2 * ((size_t)(row0 + r) * a.np + 8 * kNT * g0) + q
                    : a.b,
                 ok);
    }
  };
  for (int s = 0; s < a.ns - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }

  int rows[kT][4];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 32 * ((warp + kWarps * t) % mt) + 8 * q + gq;
      rows[t][q] = ((p / tw) * ww + p % tw) * kLdC + tq;
    }
  float acc[kT][2][kNT][4];
#pragma unroll
  for (int t = 0; t < kT; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][i][g][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    k8::ring_step(i, total, a.ns, issue);
    const int tap = i % 9;
    const float* w = wins + ((i / 9) & 1) * win;
    const float* b = ring + (i % a.ns) * slot + tq * ldb + 2 * gq;
    const int toff = ((tap / 3) * ww + tap % 3) * kLdC;
    auto aoff = [&](int ks) { return toff + 8 * ks; };
    // a last chunk of fewer than 32 channels skips its zero k-steps
    const int nks = min(4, (round_up(a.cin, 8) - 32 * (i / 9)) / 8);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int gl = (warp + kWarps * t) / mt;  // group within the block
      if (gl < a.gpb && g0 + gl < groups)
        k8::run_slice<kNT>(acc[t], w, rows[t], aoff, b + 16 * kNT * gl, ldb,
                           min(kNT, ntiles - kNT * (g0 + gl)), nks);
    }
  }

#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int task = warp + kWarps * t;
    const int mi = task % mt, gl = task / mt;
    if (gl >= a.gpb || g0 + gl >= groups) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int g = 0; g < kNT; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 32 * mi + 16 * i + gq + (e >= 2 ? 8 : 0);
          const int gy = y0 + p / tw, gx = x0 + p % tw;
          const int col = 8 * (kNT * (g0 + gl) + g) + 2 * tq + (e & 1);
          if (gy >= a.h || gx >= a.w || col >= a.nout) continue;
          const size_t at = (((size_t)n * a.h + gy) * a.w + gx) * a.ldo + col;
          const float v = acc[t][i][g][e];
          a.out[at] = (!kGate || __ldg(a.gate + at) > 0.f) ? v : 0.f;
        }
  }
}

// A stage's plan: kNT, kT as the template; groups a block at most gmax.
struct ConvPlan {
  int tw, gpb, ns, blocks_y;
  long long smem;
};

bool plan_conv(int np, int nt, int kt, int gmax, int mt_max, ConvPlan* p) {
  const int groups = (np / 8 + nt - 1) / nt;
  p->gpb = groups < gmax ? groups : gmax;
  int mt = kWarps * kt / p->gpb;
  if (mt > mt_max) mt = mt_max;
  if (mt < 1) return false;
  p->tw = 4 * mt;
  p->blocks_y = (groups + p->gpb - 1) / p->gpb;
  const long long win = (long long)(kTH + 2) * (p->tw + 2) * kLdC;
  const long long slot = (long long)kSlice * (16 * nt * p->gpb + 8);
  for (p->ns = 3; p->ns >= 2; --p->ns) {
    p->smem = 4 * (2 * win + p->ns * slot);
    if (p->smem <= kMaxSmem) return true;
  }
  return false;
}

// stage 2: N = hp in 32-column groups, 4 a block; stage 3: N = cin8 in
// 48-column groups, up to 8 a block
bool plan_gz(int hp, ConvPlan* p) { return plan_conv(hp, 4, 2, 4, 4, p); }
bool plan_dx(int cin8, ConvPlan* p) {
  return plan_conv(cin8, 6, 1, 8, 8, p);
}

template <bool kGate, int kNT, int kT>
cudaError_t launch_conv(ConvArgs a, const ConvPlan& p, cudaStream_t s) {
  auto kernel = conv3x3_kernel<kGate, kNT, kT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  a.tw = p.tw;
  a.gpb = p.gpb;
  a.ns = p.ns;
  const long long blocks =
      (long long)a.n * ((a.h + kTH - 1) / kTH) * ((a.w + p.tw - 1) / p.tw);
  kernel<<<dim3((unsigned)blocks, (unsigned)p.blocks_y), kThreads, p.smem,
           s>>>(a);
  return cudaGetLastError();
}

// ---- shapes, scratch, gradient products ----

struct Dims {
  long long m;
  int cin, caff, hid, cin8, hp, grp;   // grp: 2 caff rounded up to 32
};

Dims dims_of(long long m, int cin, int caff, int hid) {
  return Dims{m, cin, caff, hid, round_up(cin, 8), round_up(hid, k8::kHC),
              round_up(2 * caff, 32)};
}

// Packed operands in floats: the fused kernel's [w1 | b1 | w2 | b2], then
// W2t (9 grp, hp) and W1t (9 hp, cin8), each element a (hi, lo) pair.
struct Layout {
  k8::HalfLayout half;
  long long w2t, w1t, total;
};

Layout layout_of(const Dims& d) {
  Layout l;
  l.half = k8::half_layout(d.cin, d.caff, d.hid);
  l.w2t = l.half.total;
  l.w1t = l.w2t + k8::align64(2LL * 9 * d.grp * d.hp);
  l.total = l.w1t + k8::align64(2LL * 9 * d.hp * d.cin8);
  return l;
}

// [dW1 | db1] (U = im2col(x_in), V = gz), [dW2 | db2] (U = im2col(h),
// V = gr): weights (9 cin, hid) and (9 hid, 2 caff), tap-major rows
Products products_of(const Dims& d, const float* x_in, const float* h_buf,
                     const float* gz, const float* gr, int img_h,
                     int img_w) {
  Products ps{};
  ps.pr[0] = Product{x_in, gz, 9 * d.cin, d.cin, d.hid, d.hp, 0, 0, 0,
                     img_h, img_w, d.cin};
  ps.pr[1] = Product{h_buf, gr, 9 * d.hid, d.hp, 2 * d.caff, 2 * d.caff,
                     (long long)(9 * d.cin + 1) * d.hid, 0, 0,
                     img_h, img_w, d.hid};
  return ps;
}

long long weight_tiles(const Dims& d) {
  const Products ps = products_of(d, nullptr, nullptr, nullptr, nullptr, 1,
                                  1);
  return tiles_of(ps.pr[0]) + tiles_of(ps.pr[1]);
}

// Pixels of one gradient slot: at least kMinChunkRows, else as many as make
// the weight stage's blocks (chunks x tiles) fill the blocks the device
// holds at once. A function of the shapes and the device alone.
cudaError_t chunk_rows(const Dims& d, long long* rows) {
  auto kernel = weight_stage_kernel<false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWeightSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWThreads, kWeightSmem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long chunks = (long long)per_sm * sms / weight_tiles(d);
  if (chunks < 1) chunks = 1;
  long long r = (d.m + chunks - 1) / chunks;
  r = (r + kWK - 1) / kWK * kWK;
  *rows = r > kMinChunkRows ? r : kMinChunkRows;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Floats of packed weights one launch needs (the scratch argument).
long long sininn_coupling_3x3_bwd_scratch_floats(int cin, int caff,
                                                 int hid) {
  return layout_of(dims_of(1, cin, caff, hid)).total;
}

// Bytes of dynamic shared memory of the largest block of stages 1-3 (more
// than 232,448: some stage fits no block), or -1 if Caff is over 384.
long long sininn_coupling_3x3_bwd_smem_bytes(int cin, int caff, int hid) {
  const Dims d = dims_of(1, cin, caff, hid);
  k8::Plan p;
  ConvPlan gz, dx;
  long long most = k8::plan_half(cin, caff, &p);
  if (most < 0) return -1;
  if (!plan_gz(d.hp, &gz) || !plan_dx(d.cin8, &dx)) return kMaxSmem + 1;
  if (gz.smem > most) most = gz.smem;
  if (dx.smem > most) most = dx.smem;
  return most;
}

// Floats in one slot of weight and bias gradient partials:
// [dW1 (9, cin, hid) | db1 (hid) | dW2 (9, hid, 2 caff) | db2 (2 caff)].
long long sininn_coupling_3x3_bwd_slot_floats(int cin, int caff, int hid) {
  return (long long)(9 * cin + 1) * hid + (long long)(9 * hid + 1) * 2 * caff;
}

// Slots (chunks of pixels) of the partials buffer for m pixels on the
// current device, or -1 on an error.
long long sininn_coupling_3x3_bwd_chunks(long long m, int cin, int caff,
                                         int hid) {
  long long rows = 0;
  if (m <= 0 || chunk_rows(dims_of(m, cin, caff, hid), &rows) != cudaSuccess)
    return -1;
  return (m + rows - 1) / rows;
}

// The VJP of one half coupling (inverse = 0: the forward flag) for the
// cotangent g, on `stream`: stages 0-4 above. x_in (n, h, w, cin), x_aff,
// g, dx_aff (n, h, w, caff), dx_in (n, h, w, cin), NHWC fp32. Scratch:
// h_buf and gz_buf (n, h, w, hp = hid rounded up to 32), gr_buf (n, h, w,
// 2 caff), partials (chunks, slot floats; chunks as
// sininn_coupling_3x3_bwd_chunks), packed (scratch_floats), all written
// before they are read. Weights: OIHW fp32 as stored, w1 (hid, cin, 3, 3),
// w2 (2 caff, hid, 3, 3), and the biases. cin, caff and hid must be
// multiples of 4. Returns a cudaError_t.
int sininn_coupling_3x3_bwd(int inverse, const float* x_in,
                            const float* x_aff, const float* g, float* dx_in,
                            float* dx_aff, float* h_buf, float* gz_buf,
                            float* gr_buf, float* partials, long long chunks,
                            int n, int h, int w, int cin, int caff, int hid,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, float clamp, float* packed,
                            void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 4 || caff <= 0 ||
      caff % 4 || hid <= 0 || hid % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = dims_of((long long)n * h * w, cin, caff, hid);
  const Layout l = layout_of(d);
  ConvPlan pgz, pdx;
  long long rows = 0;
  if (!plan_gz(d.hp, &pgz) || !plan_dx(d.cin8, &pdx))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = chunk_rows(d, &rows);
  if (err != cudaSuccess) return (int)err;
  if ((d.m + rows - 1) / rows != chunks) return (int)cudaErrorInvalidValue;

  // 0-1. the flipped transposes here; the fused kernel's own operands in
  // run_half
  k8::Packs ps;
  ps.count = 2;
  ps.p[0] = k8::Pack{l.w2t, w2, 2 * caff, hid, d.grp, d.hp, 1, 0, 0};
  ps.p[1] = k8::Pack{l.w1t, w1, hid, cin, d.hp, d.cin8, 1, 0, 0};
  err = k8::pack3(ps, packed, s);
  if (err != cudaSuccess) return (int)err;
  k8::HalfArgs a{};
  a.x_in = x_in;
  a.x_aff = x_aff;
  a.g = g;
  a.out = dx_aff;
  a.h_out = h_buf;
  a.gr_out = gr_buf;
  a.n = n;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.caff = caff;
  a.clamp = clamp;
  err = inverse ? k8::run_half<k8::kBackwardInverse>(a, hid, w1, b1, w2, b2,
                                                     packed, s)
                : k8::run_half<k8::kBackward>(a, hid, w1, b1, w2, b2, packed,
                                              s);
  if (err != cudaSuccess) return (int)err;

  // 2. gz = conv3x3(gr, W2t), gated by h
  ConvArgs c2{};
  c2.in = gr_buf;
  c2.cin = 2 * caff;
  c2.cinp = d.grp;
  c2.b = packed + l.w2t;
  c2.np = d.hp;
  c2.gate = h_buf;
  c2.out = gz_buf;
  c2.ldo = d.hp;
  c2.nout = d.hp;
  c2.n = n;
  c2.h = h;
  c2.w = w;
  err = launch_conv<true, 4, 2>(c2, pgz, s);
  if (err != cudaSuccess) return (int)err;

  // 3. dx_in = conv3x3(gz, W1t)
  ConvArgs c3 = c2;
  c3.in = gz_buf;
  c3.cin = d.hp;
  c3.cinp = d.hp;
  c3.b = packed + l.w1t;
  c3.np = d.cin8;
  c3.gate = nullptr;
  c3.out = dx_in;
  c3.ldo = cin;
  c3.nout = cin;
  err = launch_conv<false, 6, 1>(c3, pdx, s);
  if (err != cudaSuccess) return (int)err;

  // 4. the weight and bias gradients, one slot a chunk of pixels
  const Products pr = products_of(d, x_in, h_buf, gz_buf, gr_buf, h, w);
  const long long tiles = weight_tiles(d);
  if (chunks > 0x7fffffffLL || tiles > 65535)
    return (int)cudaErrorInvalidValue;
  weight_stage_kernel<false, true>
      <<<dim3((unsigned)chunks, (unsigned)tiles), kWThreads, kWeightSmem,
         s>>>(pr, d.m, rows, partials,
              sininn_coupling_3x3_bwd_slot_floats(cin, caff, hid));
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
