// K8 forward: the GLOW half coupling with 3x3-conv subnets, forward and
// inverse, for sm_90a.
//
// Replaces the primal TPU kernels of sin_inn_tpu/ops/pallas/coupling3x3.py:
// `_coupling3_fwd_kernel` / `_coupling3_inv_kernel` (the whole coupling on
// one image, :93 / :116), `_half_fwd_kernel` (one half, :231) and
// `_half_band_fwd_kernel` (one half on row bands with a 2-row halo, :355).
// The three differ only in how they tile the same function. On this card
// even one image's hidden layer does not fit a block (88 x 160 x 256 fp32
// is 14.4 MB against 227 KB of shared memory), so one launch computes one
// half coupling on 2-D tiles (csrc/coupling_3x3.cuh states the function and
// the tiling), and a whole coupling is two launches with y1 crossing device
// memory once, as in the TPU's halves and banded forms. The TPU's row-band
// VMEM rules (`_BAND`, `_BAND_BWD`) have no counterpart here.
//
// What bounds it on an H100: arithmetic. At the SRF flagship's shapes
// (88 x 160 x 24 -> 256 -> 48 and 44 x 80 x 96 -> 256 -> 192) one half does
// 2 * 9 * Hid * (Cin + 2 Caff) FLOP per pixel, 37.4 GFLOP at batch 8
// against some 35 MB of input and output: over 1,000 FLOP per byte. What
// the design does about it: h stays in shared memory (the fusion the TPU
// kernel exists for), each block recomputes conv1 on a 1-pixel halo
// ((th + 2)(18) / (16 th): 1.41x at th = 8, 1.69x at th = 4), and the
// products run as fp32 FMA from register tiles. Tensor cores (3xTF32
// mma / wgmma) and TMA are later work.

#include "coupling_3x3.cuh"

extern "C" {

// Bytes of dynamic shared memory one block needs with th-row tiles.
long long sininn_coupling_3x3_smem_bytes(int th, int cin, int hid) {
  return (long long)sizeof(float) * k8::half_smem_floats(th, cin, hid);
}

// One launch of the half coupling on `stream`: inverse = 0 computes
// y = exp(le(s)) x_aff + t, inverse = 1 y = (x_aff - t) exp(-le(s)), with
// [s | t] = conv2(relu(conv1(x_in) + b1)) + b2. x_in (n, h, w, cin),
// x_aff and y (n, h, w, caff), NHWC fp32; w1 (9, cin, hid), w2
// (9, hid, 2 caff) row-major fp32; th rows per tile. caff and hid must be
// multiples of 4. Returns a cudaError_t.
int sininn_coupling_3x3(int inverse, const float* x_in, const float* x_aff,
                        float* y, int n, int h, int w, int cin, int caff,
                        int hid, const float* w1, const float* b1,
                        const float* w2, const float* b2, float clamp, int th,
                        void* stream) {
  const k8::HalfArgs a{x_in, x_aff, nullptr, y, nullptr, nullptr, w1, b1,
                       w2, b2, n, h, w, cin, caff, hid, th, clamp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(inverse ? k8::launch_half<k8::kInverse>(a, s)
                       : k8::launch_half<k8::kForward>(a, s));
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
