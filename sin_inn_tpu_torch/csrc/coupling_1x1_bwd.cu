// Backward of the fused GLOW coupling with 1x1-conv subnets, for sm_90a:
// staged products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernels `_coupling_bwd_kernel` (K3, the VJP of the
// forward) and `_coupling_inv_bwd_kernel` (K4, the VJP of the inverse) of
// sin_inn_tpu/ops/pallas/coupling.py. Per pixel (one row of the (M, C)
// input), with x = [x1 | x2], len1 + len2 = C, hidden width H, r = [s | t],
// le(s) = clamp (2/pi) atan(s / clamp), le'(s) = (2/pi) / (1 + (s/clamp)^2):
//
//   K3: recompute  h2 = relu(x2 W2a + b2a), r2 = h2 W2b + b2b,
//                  y1 = exp(le(s2)) x1 + t2, h1 = relu(y1 W1a + b1a),
//                  s1 = h1 W1b[:, :len2] + b1b[:len2];
//       then the reverse chain of coupling.py:293-310 for dx, and the eight
//       weight and bias gradients x2'gz2, sum gz2, h2'gr2, sum gr2, y1'gz1,
//       sum gz1, h1'gr1, sum gr1 over all rows.
//   K4: the same for the inverse chain (coupling.py:430-466), from y.
//
// Every product is a 3xTF32 product on the tensor cores (tf32_mma.cuh, as
// in K1/K2): each fp32 operand a is split into hi = tf32(a) (cvt.rna: to
// nearest, ties away from zero) and lo = tf32(a - hi), and mma.sync.m16n8k8
// (TF32 in, fp32 accumulate) adds a_lo b_hi + a_hi b_lo + a_hi b_hi. The
// dropped lo lo term and the rounding of lo leave about 2^-21 of each
// product, near fp32's own 2^-24; one-pass TF32 (2^-11) would not hold dx to
// 1e-4. The recompute does not repeat K1/K2's order of sums: a relu gate
// whose pre-activation lies within rounding of 0 may be set otherwise than
// in the forward. Math is fp32; x, g and dx are stored in fp32 or bf16; the
// gradients are fp32.
//
// Stages. One launch of sininn_coupling_1x1_bwd runs, on one stream:
//   0. pack: the eight OIHW weights and biases into zero-padded row-major
//      operands of the four row phases (K padded to 8, H to 32, N to 8).
//   1-4. four row phases, each a two-layer product streamed over the hidden
//      width: A (rows x K) -> z = A Wa [+ ba] (rows x H) -> relu or the
//      stored gate -> out = z Wb [+ bb] (rows x N). K3: [x2 -> h2 -> r2],
//      [y1 -> h1 -> s1], [gr1 -> gz1 -> gz1 W1a'], [gr2 -> gz2 -> gz2 W2a'];
//      K4 mirrors it. A block holds a tile of 16 W rows (W warps, one 16-row
//      slab each; W = 8 at every shape the model uses) and its A in shared
//      memory, and walks the hidden width in chunks of 32: the chunk of Wa
//      (K x 32) and of Wb (32 x N) comes in by 16-byte cp.async, double
//      buffered, so each weight byte serves 128 rows. z stays in registers:
//      the accumulator fragment of the first product is the A fragment of the
//      second, with the chunk's k order permuted (columns 2t, 2t+1 of an
//      8-column step taken as k = t, t + 4) and Wb read in the same order.
//      The elementwise chain (y1, gr, dx) runs in the phases' prologues and
//      epilogues. Narrow N is padded to the mma's 8 columns, not given to
//      fewer threads.
//   5. weight products (weight_stage.cuh, shared with K7 backward): [dW |
//      db] of each of the four weights as a split-K product over chunks of
//      rows, D = U' V with U the H-wide operand (h or
//      gz) and V the narrow one, on D tiles of 256 x 32 (V at most 32 wide)
//      or 128 x 64, 8 warps of 32 x 32, 32 rows a stage by double-buffered
//      cp.async. Each block writes its tile of its chunk's slot once; the
//      biases are column sums taken in row order by the blocks of the first
//      tile row or column. A chunk has at least 1,024 rows, and as many as
//      make chunks x tiles fill the blocks the card holds at once (264 on an
//      H100: 44 chunks of 2,560 rows at the first SRF octave, batch 8, 13 of
//      2,176 at the second), so no wave runs part empty.
//   then the reduction kernel sums the slots in chunk order. No atomics:
//   the result is bitwise the same on every run on one card.
// The tensor cores add into an accumulator with truncation, whose bias grows
// with the number of adds, so every run of at most 12 mma (4 k-steps)
// starts from 0 and is added to the running sum in fp32.
//
// Sizes. Scratch (fp32): h1, h2, gz1, gz2 (M x H each, 115 MB each at the
// first SRF octave, batch 8), the narrow r, y1 / x2, gr and mid-chain arrays
// (about 10 C floats a row), the relu gates as bits (one 32-bit word per
// lane, 16-row slab and 32-wide chunk: M H / 2 bytes) and the packed
// weights. Partials: one slot of S floats a chunk (S = 37,472 at C = 48,
// 148,352 at C = 192: 6.6 MB and 7.7 MB at the SRF training shapes).
// Shared memory per row-phase block: 16 W (K + 4) + 2 (40 K + 32 (N + 4))
// floats (at most 187 KB, at C = 192); weight stage 86 KB.
//
// What bounds it on an H100: by its work, the tensor cores and the staged
// bytes. A K4 launch needs 18 H C FLOP per pixel (24.9 GFLOP at either SRF
// octave, batch 8), a K3 launch 17 H C (23.5 GFLOP: its chain never reads
// t1, so the recompute skips that half of the last product), three TF32
// products each: 71-75 GFLOP of TF32 work, 0.14-0.15 ms at the dense TF32
// peak; the H-wide intermediates are written once and read once (0.92 GB
// at C = 48, 0.23 GB at C = 192: 0.28 and 0.07 ms at 3.35 TB/s), plus the
// narrow arrays. The kernels reach about a tenth of that TF32 peak; the
// rest is latency between the chunks' loads, splits and products.

#include "tf32_mma.cuh"
#include "weight_stage.cuh"

namespace {

constexpr int kThreads = 256;     // row phases: at most 8 warps
constexpr int kHC = 32;           // hidden chunk of a row phase
constexpr int kWaLd = kHC + 8;    // shared row stride of a Wa chunk
constexpr int kMinChunkRows = 1024;  // least rows of a gradient slot

__device__ __forceinline__ float log_e_prime(float s, float clamp) {
  const float u = s / clamp;
  return 0.636619772367581343f / (1.f + u * u);
}

// ---- stages 1-4: the row phases ----

struct RowArgs {
  const void* in;
  const void* g;
  void* dx;
  long long m;
  int c, len1, len2, hp;   // hp: H padded to kHC
  float clamp;
  const float *wa, *ba, *wb, *bb;  // this phase's packed operands
  int kp, np, n_out;               // padded K, padded N (ld of Wb), real N
  int npass, nbuf;                 // Wb columns per pass, chunk buffers
  float *a1, *a2, *ra, *rb, *gr1, *gr2, *gmid;
  int ld_a2, ld_ra, ld_rb, ld_gmid;   // the copies of A have ld kp
  float* wide;         // h (phases 0-1) or gz (phases 2-3), ld hp
  uint32_t* mask;      // relu gates: written in phases 0-1, read in 2-3
};

// Per-row loop width L of a phase's prologue (A is L wide, or 2 L for gr).
template <bool kInv, int kPhase>
__device__ __forceinline__ int phase_len(const RowArgs& a) {
  // K3: x2, y1, gr1, gr2; K4: y1, x2, gr2, gr1
  const bool first = (kPhase == 1 || kPhase == 3) != kInv;
  return first ? a.len1 : a.len2;
}

// Build the block's A tile (rows x kp, zero padded) and its global copy
// (a1, a2, gr1 or gr2, the weight stage's narrow operands); the elementwise
// steps of the chain before this phase's products, dx's first half included.
template <typename T, bool kInv, int kPhase>
__device__ void prologue(const RowArgs& a, float* As, int lda, long long row0,
                         int rows) {
  const T* in = static_cast<const T*>(a.in);
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int c = a.c, len1 = a.len1;
  const float clamp = a.clamp;
  constexpr bool kGr = kPhase >= 2;
  const int L = phase_len<kInv, kPhase>(a);
  const int kw = kGr ? 2 * L : L;
  // K3: x2, y1, gr1, gr2; K4: y1, x2, gr2, gr1, each with its A's width kp
  float* const copies[2][4] = {{a.a2, a.a1, a.gr1, a.gr2},
                               {a.a1, a.a2, a.gr2, a.gr1}};
  float* const dst = copies[kInv][kPhase];
  const int ldd = a.kp;
  // every array read here is read-only in this kernel: __ldg lets the
  // loads of several elements run ahead of the stores
#pragma unroll 4
  for (int idx = threadIdx.x; idx < rows * L; idx += blockDim.x) {
    const int r = idx / L, j = idx % L;
    const long long m = row0 + r;
    float v0 = 0.f, v1 = 0.f;
    if (m < a.m) {
      const T* xi = in + m * c;
      const T* gi = g + m * c;
      if (!kInv) {
        if (kPhase == 0) {
          v0 = to_float(__ldg(xi + len1 + j));                 // x2
        } else if (kPhase == 1) {
          const float s2 = __ldg(a.ra + m * a.ld_ra + j);
          const float t2 = __ldg(a.ra + m * a.ld_ra + len1 + j);
          v0 = expf(log_e(s2, clamp)) * to_float(__ldg(xi + j)) + t2;
        } else if (kPhase == 2) {
          const float s1 = __ldg(a.rb + m * a.ld_rb + j);
          const float e1 = expf(log_e(s1, clamp));
          const float gy2 = to_float(__ldg(gi + len1 + j));
          v0 = gy2 * to_float(__ldg(xi + len1 + j)) * e1 *
               log_e_prime(s1, clamp);
          v1 = gy2;                                            // gr1
        } else {
          const float gy1 = __ldg(a.gmid + m * a.ld_gmid + j);
          const float s2 = __ldg(a.ra + m * a.ld_ra + j);
          const float e2 = expf(log_e(s2, clamp));
          v0 = gy1 * to_float(__ldg(xi + j)) * e2 * log_e_prime(s2, clamp);
          v1 = gy1;                                            // gr2
          store(dx + m * c + j, gy1 * e2);                     // gx1
        }
      } else {
        if (kPhase == 0) {
          v0 = to_float(__ldg(xi + j));                        // y1
        } else if (kPhase == 1) {
          const float s1 = __ldg(a.ra + m * a.ld_ra + j);
          const float t1 = __ldg(a.ra + m * a.ld_ra + a.len2 + j);
          v0 = (to_float(__ldg(xi + len1 + j)) - t1) *
               expf(-log_e(s1, clamp));                       // x2
        } else if (kPhase == 2) {
          const float s2 = __ldg(a.rb + m * a.ld_rb + j);
          const float t2 = __ldg(a.rb + m * a.ld_rb + len1 + j);
          const float e2inv = expf(-log_e(s2, clamp));
          const float x1 = (to_float(__ldg(xi + j)) - t2) * e2inv;
          const float gx1 = to_float(__ldg(gi + j));
          v0 = -gx1 * x1 * log_e_prime(s2, clamp);
          v1 = -gx1 * e2inv;                                   // gr2
        } else {
          const float gx2 = __ldg(a.gmid + m * a.ld_gmid + j);
          const float s1 = __ldg(a.ra + m * a.ld_ra + j);
          const float e1inv = expf(-log_e(s1, clamp));
          v0 = -gx2 * __ldg(a.a2 + m * a.ld_a2 + j) * log_e_prime(s1, clamp);
          v1 = -gx2 * e1inv;                                   // gr1
          store(dx + m * c + len1 + j, gx2 * e1inv);           // gy2
        }
      }
      dst[m * ldd + j] = v0;
      if (kGr) dst[m * ldd + L + j] = v1;
    }
    As[r * lda + j] = v0;
    if (kGr) As[r * lda + L + j] = v1;
  }
  const int pad = a.kp - kw;
  for (int idx = threadIdx.x; idx < rows * pad; idx += blockDim.x) {
    const int r = idx / pad, j = kw + idx % pad;
    As[r * lda + j] = 0.f;
    const long long m = row0 + r;
    if (m < a.m) dst[m * ldd + j] = 0.f;
  }
}

// out[row][col] of the second product, for col < np (padded columns too,
// where the phase writes an array of ld np).
template <typename T, bool kInv, int kPhase>
__device__ __forceinline__ void epilogue_one(const RowArgs& a, long long m,
                                             int col, float acc) {
  const T* g = static_cast<const T*>(a.g);
  T* dx = static_cast<T*>(a.dx);
  const int c = a.c, len1 = a.len1;
  if (kPhase == 0) {
    a.ra[m * a.ld_ra + col] = acc + __ldg(a.bb + col);
  } else if (kPhase == 1) {
    a.rb[m * a.ld_rb + col] = acc + __ldg(a.bb + col);
  } else if (col < a.n_out) {
    if (kPhase == 2) {
      // K3: gy1 = gy1 + gz1 W1a';  K4: gx2 = gx2 + gz2 W2a'
      const int off = kInv ? len1 : 0;
      a.gmid[m * a.ld_gmid + col] =
          to_float(__ldg(g + m * c + off + col)) + acc;
    } else if (!kInv) {
      // gx2 = gy2 e1 + gz2 W2a'
      const float e1 =
          expf(log_e(__ldg(a.rb + m * a.ld_rb + col), a.clamp));
      store(dx + m * c + len1 + col,
            to_float(__ldg(g + m * c + len1 + col)) * e1 + acc);
    } else {
      // gy1 = gx1 e2^-1 + gz1 W1a'
      const float e2inv =
          expf(-log_e(__ldg(a.rb + m * a.ld_rb + col), a.clamp));
      store(dx + m * c + col,
            to_float(__ldg(g + m * c + col)) * e2inv + acc);
    }
  }
}

template <typename T, bool kInv, int kPhase, int kNT>
__global__ void __launch_bounds__(kThreads)
row_phase_kernel(RowArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rows = 16 * warps;
  const long long row0 = (long long)blockIdx.x * rows;
  const int lda = a.kp + 4;
  float* const As = smem;
  float* const wa_s = As + rows * lda;
  const int wa_buf = a.kp * kWaLd;
  const int ldb = a.npass + 4;
  float* const wb_s = wa_s + a.nbuf * wa_buf;
  const int wb_buf = kHC * ldb;

  prologue<T, kInv, kPhase>(a, As, lda, row0, rows);
  __syncthreads();

  const int nch = a.hp / kHC;
  const long long slab = (long long)blockIdx.x * warps + warp;
  const int r0 = warp * 16;
  const float* a_lo = As + (r0 + gq) * lda + tq;
  const long long m_lo = row0 + r0 + gq, m_hi = m_lo + 8;

  for (int pass0 = 0; pass0 < a.np; pass0 += a.npass) {
    const int ncols = min(a.npass, a.np - pass0);
    const int nt = ncols / 8;
    auto issue = [&](int ch, int buf) {
      float* wa_d = wa_s + buf * wa_buf;
      for (int s = threadIdx.x; s < a.kp * (kHC / 4); s += blockDim.x) {
        const int k = s / (kHC / 4), q = 4 * (s % (kHC / 4));
        cp_async16(wa_d + k * kWaLd + q,
                   a.wa + (size_t)k * a.hp + ch * kHC + q, true);
      }
      float* wb_d = wb_s + buf * wb_buf;
      const int per_row = ncols / 4;
      for (int s = threadIdx.x; s < kHC * per_row; s += blockDim.x) {
        const int k = s / per_row, q = 4 * (s % per_row);
        cp_async16(wb_d + k * ldb + q,
                   a.wb + (size_t)(ch * kHC + k) * a.np + pass0 + q, true);
      }
    };

    float out[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] = 0.f;

    issue(0, 0);
    cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (a.nbuf == 2 && ch + 1 < nch) {
        issue(ch + 1, (ch + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int buf = a.nbuf == 2 ? (ch & 1) : 0;
      const float* wa_c = wa_s + buf * wa_buf + tq * kWaLd + gq;
      const float* wb_c = wb_s + buf * wb_buf + 2 * tq * ldb + gq;

      // z = A Wa over this chunk's 32 hidden columns. The tensor cores
      // add into an accumulator with truncation, so each run of at most 4
      // k-steps (12 mma) starts from 0 and is added to z in fp32.
      float z[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[j][e] = 0.f;
      for (int k0 = 0; k0 < a.kp; k0 += 32) {
        float t[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int k = k0 + 8 * ks;
          if (k >= a.kp) break;
          uint32_t hi[4], lo[4];
          split(a_lo[k], hi[0], lo[0]);
          split(a_lo[8 * lda + k], hi[1], lo[1]);
          split(a_lo[k + 4], hi[2], lo[2]);
          split(a_lo[8 * lda + k + 4], hi[3], lo[3]);
          const float* w = wa_c + k * kWaLd;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma3(t[j], hi, lo, w[8 * j], w[4 * kWaLd + 8 * j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) z[j][e] += t[j][e];
      }

      // relu (recording the gate) or the stored gate; c0, c1 at row gq,
      // columns 2 tq, 2 tq + 1 of step j; c2, c3 at row gq + 8
      const int n0 = ch * kHC;
      uint32_t* mword = a.mask + (slab * nch + ch) * 32 + lane;
      uint32_t bits = kPhase >= 2 ? *mword : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kPhase < 2) {
          const float* bp = a.ba + n0 + 8 * j + 2 * tq;
          const float2 b = __ldg(reinterpret_cast<const float2*>(bp));
          z[j][0] += b.x;
          z[j][1] += b.y;
          z[j][2] += b.x;
          z[j][3] += b.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (z[j][e] > 0.f) bits |= 1u << (4 * j + e);
            else z[j][e] = 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!((bits >> (4 * j + e)) & 1u)) z[j][e] = 0.f;
        }
      }
      if (pass0 == 0) {
        if (kPhase < 2) *mword = bits;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + 8 * j + 2 * tq;
          if (m_lo < a.m)
            *reinterpret_cast<float2*>(a.wide + m_lo * a.hp + col) =
                make_float2(z[j][0], z[j][1]);
          if (m_hi < a.m)
            *reinterpret_cast<float2*>(a.wide + m_hi * a.hp + col) =
                make_float2(z[j][2], z[j][3]);
        }
      }

      // out += z Wb: step j of the chunk takes z's columns 2 tq, 2 tq + 1
      // as k = tq, tq + 4, and Wb's rows in the same order; each output
      // tile sums the chunk from 0 (12 mma) and adds it to out in fp32
      uint32_t zh[4][4], zl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(z[j][0], zh[j][0], zl[j][0]);
        split(z[j][2], zh[j][1], zl[j][1]);
        split(z[j][1], zh[j][2], zl[j][2]);
        split(z[j][3], zh[j][3], zl[j][3]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n >= nt) continue;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* w = wb_c + 8 * j * ldb + 8 * n;
          mma3(t, zh[j], zl[j], w[0], w[ldb]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) out[n][e] += t[e];
      }
      __syncthreads();
      if (a.nbuf == 1 && ch + 1 < nch) {
        issue(ch + 1, 0);
        cp_async_commit();
      }
    }

#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n >= nt) continue;
      const int col = pass0 + 8 * n + 2 * tq;
      if (m_lo < a.m) {
        epilogue_one<T, kInv, kPhase>(a, m_lo, col, out[n][0]);
        epilogue_one<T, kInv, kPhase>(a, m_lo, col + 1, out[n][1]);
      }
      if (m_hi < a.m) {
        epilogue_one<T, kInv, kPhase>(a, m_hi, col, out[n][2]);
        epilogue_one<T, kInv, kPhase>(a, m_hi, col + 1, out[n][3]);
      }
    }
  }
}

// out[i] = sum over p < blocks, in order, of partials[p][i].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int blocks,
                       long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int p = 0; p < blocks; ++p) sum += partials[(long long)p * n + i];
    out[i] = sum;
  }
}

// ---- host side: shapes, scratch layout, plans ----

struct Dims {
  long long m;
  int c, len1, len2, hidden, hp;
};

Dims dims_of(long long m, int c, int len1, int hidden) {
  return Dims{m, c, len1, c - len1, hidden, round_up(hidden, kHC)};
}

// K and N of the two products of row phase `phase`.
void phase_kn(bool inv, int phase, const Dims& d, int* k, int* n) {
  const int l1 = d.len1, l2 = d.len2;
  const int k3[4][2] = {{l2, 2 * l1}, {l1, l2}, {2 * l2, l1}, {2 * l1, l2}};
  const int k4[4][2] = {{l1, 2 * l2}, {l2, 2 * l1}, {2 * l1, l2}, {2 * l2, l1}};
  *k = inv ? k4[phase][0] : k3[phase][0];
  *n = inv ? k4[phase][1] : k3[phase][1];
}

struct Layout {   // offsets in floats into the scratch buffer
  long long wa[4], ba[4], wb[4], bb[4];
  long long a1, a2, ra, rb, gr1, gr2, gmid, h1, h2, gz1, gz2, mask1, mask2;
  long long total;
  int ld_a1, ld_a2, ld_ra, ld_rb, ld_gr1, ld_gr2, ld_gmid;
};

long long align64(long long n) { return (n + 63) / 64 * 64; }

Layout layout_of(bool inv, const Dims& d) {
  Layout l;
  long long at = 0;
  auto take = [&](long long floats) {
    const long long here = at;
    at += align64(floats);
    return here;
  };
  int kp[4], np[4];
  for (int ph = 0; ph < 4; ++ph) {
    int k, n;
    phase_kn(inv, ph, d, &k, &n);
    kp[ph] = round_up(k, 8);
    np[ph] = round_up(n, 8);
    l.wa[ph] = take((long long)kp[ph] * d.hp);
    l.ba[ph] = take(d.hp);
    l.wb[ph] = take((long long)d.hp * np[ph]);
    l.bb[ph] = take(np[ph]);
  }
  l.ld_a1 = round_up(d.len1, 8);
  l.ld_a2 = round_up(d.len2, 8);
  l.ld_gr1 = round_up(2 * d.len2, 8);
  l.ld_gr2 = round_up(2 * d.len1, 8);
  l.ld_ra = np[0];
  l.ld_rb = np[1];
  l.ld_gmid = np[2];
  l.a1 = take(d.m * l.ld_a1);
  l.a2 = take(d.m * l.ld_a2);
  l.ra = take(d.m * l.ld_ra);
  l.rb = take(d.m * l.ld_rb);
  l.gr1 = take(d.m * l.ld_gr1);
  l.gr2 = take(d.m * l.ld_gr2);
  l.gmid = take(d.m * l.ld_gmid);
  l.h1 = take(d.m * d.hp);
  l.h2 = take(d.m * d.hp);
  l.gz1 = take(d.m * d.hp);
  l.gz2 = take(d.m * d.hp);
  // one word per lane, 16-row slab (rounded up to 8 slabs) and chunk
  const long long slabs = ((d.m + 15) / 16 + 7) / 8 * 8;
  l.mask1 = take(slabs * (d.hp / kHC) * 32);
  l.mask2 = take(slabs * (d.hp / kHC) * 32);
  l.total = at;
  return l;
}

long long row_smem_floats(int warps, int kp, int npass, int nbuf) {
  return 16LL * warps * (kp + 4) +
         (long long)nbuf * ((long long)kp * kWaLd + kHC * (npass + 4));
}

struct Plan {
  int warps, npass, nbuf, wide_nt;
  long long smem;   // bytes
};

// The largest tile (then double buffering, then Wb pass) that fits. The
// warp counts divide 8: the gate words are laid out for 16-row slabs
// rounded up to 8 (layout_of).
bool plan_phase(int kp, int np, Plan* p) {
  const int wide_nt = np > 64;
  const int first = wide_nt ? (np < 192 ? np : 192) : np;
  const int passes[3] = {first, first < 64 ? first : 64, 8};
  for (int warps = 8; warps >= 1; warps /= 2)
    for (int nbuf = 2; nbuf >= 1; --nbuf)
      for (int npass : passes) {
        const long long bytes =
            4 * row_smem_floats(warps, kp, npass, nbuf);
        if (bytes <= kMaxSmem) {
          *p = Plan{warps, npass, nbuf, wide_nt, bytes};
          return true;
        }
      }
  return false;
}

template <typename T, bool kInv, int kPhase>
cudaError_t launch_row_phase(const RowArgs& a, const Plan& p,
                             cudaStream_t s) {
  auto kernel = p.wide_nt ? row_phase_kernel<T, kInv, kPhase, 24>
                          : row_phase_kernel<T, kInv, kPhase, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const long long rows = 16LL * p.warps;
  const long long blocks = (a.m + rows - 1) / rows;
  kernel<<<(unsigned)blocks, 32 * p.warps, p.smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kInv>
cudaError_t launch_row_phases(RowArgs a, const Dims& d, const Layout& l,
                              float* scratch, cudaStream_t s) {
  for (int ph = 0; ph < 4; ++ph) {
    int k, n;
    phase_kn(kInv, ph, d, &k, &n);
    a.kp = round_up(k, 8);
    a.np = round_up(n, 8);
    a.n_out = n;
    Plan p;
    if (!plan_phase(a.kp, a.np, &p)) return cudaErrorInvalidValue;
    a.npass = p.npass;
    a.nbuf = p.nbuf;
    a.wa = scratch + l.wa[ph];
    a.ba = scratch + l.ba[ph];
    a.wb = scratch + l.wb[ph];
    a.bb = scratch + l.bb[ph];
    // h1 / gz1 go with mask1, h2 / gz2 with mask2
    const bool sub1 = (ph == 1 || ph == 2) != kInv;
    a.wide = scratch + (ph < 2 ? (sub1 ? l.h1 : l.h2) : (sub1 ? l.gz1 : l.gz2));
    a.mask = reinterpret_cast<uint32_t*>(scratch + (sub1 ? l.mask1 : l.mask2));
    cudaError_t err;
    switch (ph) {
      case 0: err = launch_row_phase<T, kInv, 0>(a, p, s); break;
      case 1: err = launch_row_phase<T, kInv, 1>(a, p, s); break;
      case 2: err = launch_row_phase<T, kInv, 2>(a, p, s); break;
      default: err = launch_row_phase<T, kInv, 3>(a, p, s); break;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

long long slot_floats(int c, int len1, int hidden) {
  const long long len2 = c - len1;
  return len2 * hidden + hidden + hidden * 2 * len1 + 2 * len1 +
         len1 * hidden + hidden + hidden * 2 * len2 + 2 * len2;
}

// The weight stage's D tiles: 256 x 32 or 128 x 64 of (H, len2), (H, 2 len1),
// (H, len1), (H, 2 len2).
long long weight_tiles(const Dims& d) {
  const int qs[4] = {d.len2, 2 * d.len1, d.len1, 2 * d.len2};
  long long tiles = 0;
  for (int q : qs) {
    Product p{};
    p.p = d.hidden;
    p.q = q;
    tiles += tiles_of(p);
  }
  return tiles;
}

// Rows of one gradient slot: at least kMinChunkRows, else as many as make
// the weight stage's blocks (chunks x tiles) fill the blocks the device
// holds at once, so that no wave of blocks runs part empty. A function of
// the shapes and the device alone: the same on every run on one card.
cudaError_t chunk_rows(const Dims& d, long long* rows) {
  cudaError_t err = cudaFuncSetAttribute(
      weight_stage_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWeightSmem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, weight_stage_kernel<false>, kWThreads, kWeightSmem);
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

// Floats of scratch one K3 (inverse = 0) or K4 launch needs for m rows.
long long sininn_coupling_1x1_bwd_scratch_floats(int inverse, long long m,
                                                 int c, int len1,
                                                 int hidden) {
  return layout_of(inverse != 0, dims_of(m, c, len1, hidden)).total;
}

// Bytes of dynamic shared memory of the largest row-phase block, or -1 if a
// phase fits in none.
long long sininn_coupling_1x1_bwd_smem_bytes(int c, int len1, int hidden) {
  const Dims d = dims_of(1, c, len1, hidden);
  long long most = (long long)kWeightSmem;
  for (int inv = 0; inv < 2; ++inv)
    for (int ph = 0; ph < 4; ++ph) {
      int k, n;
      Plan p;
      phase_kn(inv != 0, ph, d, &k, &n);
      if (!plan_phase(round_up(k, 8), round_up(n, 8), &p)) return -1;
      if (p.smem > most) most = p.smem;
    }
  return most;
}

// Floats in one slot of weight and bias gradient partials:
// [w2a (len2, H) | b2a (H) | w2b (H, 2 len1) | b2b (2 len1) | w1a (len1, H)
//  | b1a (H) | w1b (H, 2 len2) | b1b (2 len2)], weights (cin, cout).
long long sininn_coupling_1x1_bwd_slot_floats(int c, int len1, int hidden) {
  return slot_floats(c, len1, hidden);
}

// Offset in floats, into the scratch of one K3 (inverse = 0) or K4 launch
// for m rows, of h1 (sub = 1) or h2 (sub = 2): (m, hidden rounded up to 32)
// row-major, relu(z) as the row phases computed it, so h > 0 are the relu
// gates that launch set. For checks against the plain version.
long long sininn_coupling_1x1_bwd_hidden_offset(int inverse, long long m,
                                                int c, int len1, int hidden,
                                                int sub) {
  const Layout l = layout_of(inverse != 0, dims_of(m, c, len1, hidden));
  return sub == 1 ? l.h1 : l.h2;
}

// Slots (chunks of rows, see chunk_rows) of the partials buffer for m rows
// on the current device, or -1 on an error.
long long sininn_coupling_1x1_bwd_chunks(long long m, int c, int len1,
                                         int hidden) {
  long long rows = 0;
  if (m <= 0 || chunk_rows(dims_of(m, c, len1, hidden), &rows) != cudaSuccess)
    return -1;
  return (m + rows - 1) / rows;
}

// One launch of K3 (inverse = 0: in = x, g = dy, dx = dx) or K4 (inverse = 1:
// in = y, g = dx, dx = dy) on `stream`: stages 0-5 above. in/g/dx: (m, c)
// row-major, fp32 (bf16 = 0) or bf16 (bf16 = 1). Weights: the OIHW 1x1
// conv weights as stored (contiguous fp32): w2a (H, len2), w2b (2 len1, H),
// w1a (H, len1), w1b (2 len2, H), and the biases. scratch: scratch_floats,
// partials: chunks x slot floats (chunks as sininn_coupling_1x1_bwd_chunks
// gives them), both written before they are read.
// Returns a cudaError_t.
int sininn_coupling_1x1_bwd(int inverse, int bf16, const void* in,
                            const void* g, void* dx, long long m, int c,
                            int len1, int hidden, const float* w2a,
                            const float* b2a, const float* w2b,
                            const float* b2b, const float* w1a,
                            const float* b1a, const float* w1b,
                            const float* b1b, float clamp, float* scratch,
                            float* partials, long long chunks,
                            void* stream) {
  if (m <= 0 || len1 <= 0 || len1 >= c || hidden <= 0)
    return (int)cudaErrorInvalidValue;
  const bool inv = inverse != 0;
  const Dims d = dims_of(m, c, len1, hidden);
  const Layout l = layout_of(inv, d);
  const int l1 = d.len1, l2 = d.len2, H = d.hidden;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // stage 0: the phases' operands. (i, j) of Wa = W2a (len2 x H), the
  // (cin, cout) view of w2a (H, len2), is w2a[j * len2 + i], and so on.
  struct Src { const float* p; int rows, cols, sr, sc; };
  const Src W2a{w2a, l2, H, 1, l2}, W2aT{w2a, H, l2, l2, 1};
  const Src W2b{w2b, H, 2 * l1, 1, H}, W2bT{w2b, 2 * l1, H, H, 1};
  const Src W1a{w1a, l1, H, 1, l1}, W1aT{w1a, H, l1, l1, 1};
  const Src W1b{w1b, H, 2 * l2, 1, H}, W1bT{w1b, 2 * l2, H, H, 1};
  const Src W1bS{w1b, H, l2, 1, H};   // W1b[:, :len2]
  const Src k3a[4] = {W2a, W1a, W1bT, W2bT}, k3b[4] = {W2b, W1bS, W1aT, W2aT};
  const Src k4a[4] = {W1a, W2a, W2bT, W1bT}, k4b[4] = {W1b, W2b, W2aT, W1aT};
  const float* k3ba[2] = {b2a, b1a};
  const float* k3bb[2] = {b2b, b1b};
  const float* k4ba[2] = {b1a, b2a};
  const float* k4bb[2] = {b1b, b2b};
  PackArgs pk;
  pk.count = 0;
  for (int ph = 0; ph < 4; ++ph) {
    int k, n;
    phase_kn(inv, ph, d, &k, &n);
    const int kp = round_up(k, 8), np = round_up(n, 8);
    const Src sa = inv ? k4a[ph] : k3a[ph], sb = inv ? k4b[ph] : k3b[ph];
    pk.mat[pk.count++] = PackMat{l.wa[ph], sa.rows, sa.cols, kp, d.hp,
                                 sa.p, sa.sr, sa.sc, 0, 0};
    pk.mat[pk.count++] = PackMat{l.wb[ph], sb.rows, sb.cols, d.hp, np,
                                 sb.p, sb.sr, sb.sc, 0, 0};
    if (ph < 2) {
      pk.mat[pk.count++] = PackMat{l.ba[ph], 1, H, 1, d.hp,
                                   inv ? k4ba[ph] : k3ba[ph], 0, 1, 0, 0};
      pk.mat[pk.count++] = PackMat{l.bb[ph], 1, n, 1, np,
                                   inv ? k4bb[ph] : k3bb[ph], 0, 1, 0, 0};
    }
  }
  cudaError_t err = pack(pk, scratch, s);
  if (err != cudaSuccess) return (int)err;

  // stages 1-4
  RowArgs a{};
  a.in = in;
  a.g = g;
  a.dx = dx;
  a.m = m;
  a.c = c;
  a.len1 = l1;
  a.len2 = l2;
  a.hp = d.hp;
  a.clamp = clamp;
  a.a1 = scratch + l.a1;
  a.a2 = scratch + l.a2;
  a.ra = scratch + l.ra;
  a.rb = scratch + l.rb;
  a.gr1 = scratch + l.gr1;
  a.gr2 = scratch + l.gr2;
  a.gmid = scratch + l.gmid;
  a.ld_a2 = l.ld_a2;
  a.ld_ra = l.ld_ra;
  a.ld_rb = l.ld_rb;
  a.ld_gmid = l.ld_gmid;
  if (bf16) {
    err = inv ? launch_row_phases<__nv_bfloat16, true>(a, d, l, scratch, s)
              : launch_row_phases<__nv_bfloat16, false>(a, d, l, scratch, s);
  } else {
    err = inv ? launch_row_phases<float, true>(a, d, l, scratch, s)
              : launch_row_phases<float, false>(a, d, l, scratch, s);
  }
  if (err != cudaSuccess) return (int)err;

  // stage 5: [dW2a | db2a] = (gz2' x2)' , [dW2b | db2b] = h2' gr2,
  // [dW1a | db1a] = (gz1' y1)', [dW1b | db1b] = h1' gr1
  const long long o2b = (long long)l2 * H + H;
  const long long o1a = o2b + (long long)H * 2 * l1 + 2 * l1;
  const long long o1b = o1a + (long long)l1 * H + H;
  Products ps{};
  ps.pr[0] = Product{scratch + l.gz2, scratch + l.a2, H, d.hp, l2, l.ld_a2,
                     0, 1, 1};
  ps.pr[1] = Product{scratch + l.h2, scratch + l.gr2, H, d.hp, 2 * l1,
                     l.ld_gr2, o2b, 0, 0};
  ps.pr[2] = Product{scratch + l.gz1, scratch + l.a1, H, d.hp, l1, l.ld_a1,
                     o1a, 1, 1};
  ps.pr[3] = Product{scratch + l.h1, scratch + l.gr1, H, d.hp, 2 * l2,
                     l.ld_gr1, o1b, 0, 0};
  const long long tiles = weight_tiles(d);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  long long rows = 0;
  err = chunk_rows(d, &rows);   // also sets the kernel's shared memory size
  if (err != cudaSuccess) return (int)err;
  if ((m + rows - 1) / rows != chunks) return (int)cudaErrorInvalidValue;
  weight_stage_kernel<false><<<dim3((unsigned)((m + rows - 1) / rows),
                             (unsigned)tiles),
                        kWThreads, kWeightSmem, s>>>(
      ps, m, rows, partials, slot_floats(c, len1, hidden));
  return (int)cudaGetLastError();
}

// out[i] = sum_{p < blocks} partials[p * n + i], summed in order of p.
int sininn_reduce_partials(const float* partials, int blocks, long long n,
                           float* out, void* stream) {
  if (blocks <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > 4096) grid = 4096;
  reduce_partials_kernel<<<(unsigned)grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      partials, blocks, n, out);
  return (int)cudaGetLastError();
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
