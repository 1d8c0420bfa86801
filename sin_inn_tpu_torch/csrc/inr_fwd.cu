// Forward of the fused encoded coordinate MLP (the flow INR), for sm_90a.
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
// What bounds it on an H100: arithmetic. At the flow path's shape
// (N = 446,464, E = 512 + 3 coordinate rows, H = 256, three hidden layers,
// O = 4) one launch does 2 N 263,936 = 236 GFLOP, 3.5 ms at the fp32 peak of
// 67 TFLOP/s, plus the slab rebuild (2 N 515 FLOP per non-zero column of wx,
// 6 of 50 on average). The bytes are small beside that: x, out, the weights
// and, in slab mode, 45 MB of slabs (0.017 ms); point mode streams the 914
// MB mask (0.27 ms).
//
// What the design does about it:
// * A persistent grid walks the 32-point tiles; neighbouring blocks work on
//   neighbouring tiles, so the 32 tiles of an image row read their row's
//   slab from L2 at about the same time.
// * A tile's activations alternate between two buffers in shared memory
//   (32 x max(E, H) and 32 x H floats, 98 KB at the path's shape), so two
//   blocks fit on an SM and one block's products hide the other's encoding.
// * The layer products are the backward's: 8 rows x 4 columns a thread in
//   fp32 FMA, weights streamed from L2 as consecutive float4.
// * The output layer (H x O, O small) gives each warp four rows: a lane
//   sums every 32nd k and the warp adds the lanes' sums by shuffles.
// Tensor cores (wgmma on TF32 or bf16 operands) and TMA are later work.

#include "inr_common.cuh"

namespace {

using namespace inr;

__host__ __device__ __forceinline__ long long buf0_floats(const Net& n) {
  return (long long)kTileRows * (n.e > n.hidden ? n.e : n.hidden);
}

// Floats of shared memory: the two activation buffers, then xm and the
// rows of wx where there are any.
__host__ __device__ __forceinline__ long long tile_floats(const Net& n) {
  return buf0_floats(n) + (long long)kTileRows * n.hidden + extra_floats(n);
}

// out[r][n] = sum_k a[r][k] w[k][n] + b[n] for the tile's rows before N.
__device__ void out_layer(const float* a, int H, const float* __restrict__ w,
                          const float* __restrict__ b, int O, long long row0,
                          long long n_points, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
    for (int n = 0; n < O; ++n) {
      float acc = 0.f;
      for (int k = lane; k < H; k += 32)
        acc = fmaf(a[r * H + k], __ldg(w + (size_t)k * O + n), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0 && row0 + r < n_points)
        out[(row0 + r) * O + n] = acc + __ldg(b + n);
    }
  }
}

template <bool kBf16, bool kRbf, int kVariant>
__global__ void __launch_bounds__(kThreads, 2)
inr_fwd_kernel(const float* __restrict__ x, long long n_points, Net net,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kProg = variant_prog(kVariant);
  const int L = net.n_lin, H = net.hidden;
  float* buf0 = smem;
  float* buf1 = smem + buf0_floats(net);
  float* xm = buf1 + kTileRows * H;
  float* wxs = xm + (kProg ? kTileRows * kMaxDim : 0);

  const long long tiles = (n_points + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * kTileRows;
    prepare_tile<kBf16, kRbf, kVariant>(net, x, row0, n_points, buf0, xm,
                                        wxs);
    float* cur = buf0;
    float* nxt = buf1;
    for (int l = 0; l < L - 1; ++l) {
      hidden_layer<kBf16, kProg>(net, cur, layer_k(net, l), net.w[l],
                                 net.b[l], nxt, l == 0, xm);
      __syncthreads();
      float* done = nxt;
      nxt = cur;
      cur = done;
    }
    out_layer(cur, H, net.w[L - 1], net.b[L - 1], net.out, row0, n_points,
              out);
    __syncthreads();
  }
}

struct Config {
  int per_sm;
  size_t smem;
};

cudaError_t configure(int bf16, int rbf, int variant, const Net& n,
                      Config* cfg) {
  cfg->smem = sizeof(float) * tile_floats(n);
  return dispatch(bf16, rbf, variant, [&](auto b, auto r, auto v) {
    auto kernel = inr_fwd_kernel<decltype(b)::value, decltype(r)::value,
                                 decltype(v)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg->smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cfg->per_sm, kernel, kThreads, cfg->smem);
  });
}

}  // namespace

extern "C" {

// One launch on `stream`. x: (n_points, d) fp32 contiguous; out: (n_points,
// out), written in full. The other arguments as `sininn_inr_bwd` of
// inr_bwd.cu takes them. The grid is as many blocks as the
// device holds at once, at most one per tile. Returns a cudaError_t.
int sininn_inr_fwd(int bf16, int rbf, int mode, int prog, long long n_points,
                   int n_lin, int d, int e, int hidden, int out_ch, int res,
                   int w_img, const float* x, const float* const* w,
                   const float* const* b, const float* enc_a, const float* enc_b, const float* enc_c,
                   const float* me, const float* mc, const float* wx,
                   const float* wc, float* out, void* stream) {
  const Net n = make_net(prog, n_lin, d, e, hidden, out_ch, res, w_img, w, b,
                         enc_a, enc_b, enc_c, me, mc, wx, wc);
  cudaError_t err = check_net(n, n_points, mode);
  if (err != cudaSuccess) return (int)err;
  const int variant = variant_of(mode, prog);
  Config cfg{0, 0};
  err = configure(bf16, rbf, variant, n, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (cfg.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n_points + kTileRows - 1) / kTileRows;
  const long long p = (long long)cfg.per_sm * sms;
  const int blocks = (int)(tiles < p ? tiles : p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(bf16, rbf, variant, [&](auto bb, auto r, auto v) {
    inr_fwd_kernel<decltype(bb)::value, decltype(r)::value,
                   decltype(v)::value><<<blocks, kThreads, cfg.smem, s>>>(
        x, n_points, n, out);
    return cudaGetLastError();
  });
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
