// K8 forward: the GLOW half coupling with 3x3-conv subnets, forward and
// inverse, for sm_90a, every product on the tensor cores in 3xTF32.
//
// Replaces the primal TPU kernels of sin_inn_tpu/ops/pallas/coupling3x3.py:
// `_coupling3_fwd_kernel` / `_coupling3_inv_kernel` (the whole coupling on
// one image, :93 / :116), `_half_fwd_kernel` (one half, :231) and
// `_half_band_fwd_kernel` (one half on row bands with a 2-row halo, :355).
// The three differ only in how they tile the same function. On this card
// even one image's hidden layer does not fit a block (88 x 160 x 256 fp32
// is 14.4 MB against 227 KB of shared memory), so one launch computes one
// half coupling on 2-D tiles, and a whole coupling is two launches with y1
// crossing device memory once, as in the TPU's halves and banded forms.
//
// What bounds it on an H100: the products. At the SRF flagship's shapes
// (88 x 160 x 24 -> 256 -> 48 and 44 x 80 x 96 -> 256 -> 192) one half does
// 2 * 9 * Hid * (Cin + 2 Caff) FLOP a pixel, 37.4 GFLOP at batch 8 (0.558
// ms at the fp32 peak), against some 35 MB of input and output. Run as
// three TF32 products each that is 112 GFLOP of TF32 work, 0.226 ms at the
// dense TF32 peak. What the design does about it (csrc/coupling_3x3.cuh
// states the function, the tiles and the shared memory): one pack kernel,
// then one fused kernel that runs conv1 and conv2 as implicit GEMMs on
// mma.sync with h kept on the chip a 32-channel chunk at a time, conv2's
// sums in registers over the chunks, the weights streamed through shared
// memory in 32-row slices, and conv1 recomputed on the tile's 1-pixel halo
// (1.33x of conv1 at the first octave, 1.41x at the second).

#include "coupling_3x3.cuh"

extern "C" {

// Floats of packed weights one launch needs (the scratch argument).
long long sininn_coupling_3x3_scratch_floats(int cin, int caff, int hid) {
  return k8::half_layout(cin, caff, hid).total;
}

// Bytes of dynamic shared memory of the fused kernel's block for Cin and
// Caff (more than 232,448: no block fits), or -1 if Caff is over 384.
long long sininn_coupling_3x3_smem_bytes(int cin, int caff) {
  k8::Plan p;
  return k8::plan_half(cin, caff, &p);
}

// One launch of the half coupling on `stream`: the weight pack, then the
// fused kernel. inverse = 0 computes y = exp(le(s)) x_aff + t, inverse = 1
// y = (x_aff - t) exp(-le(s)), with [s | t] = conv2(relu(conv1(x_in) + b1))
// + b2. x_in (n, h, w, cin), x_aff and y (n, h, w, caff), NHWC fp32; w1
// (hid, cin, 3, 3) and w2 (2 caff, hid, 3, 3) OIHW fp32 as stored, b1, b2;
// scratch: scratch_floats, written before it is read. Returns a
// cudaError_t.
int sininn_coupling_3x3(int inverse, const float* x_in, const float* x_aff,
                        float* y, int n, int h, int w, int cin, int caff,
                        int hid, const float* w1, const float* b1,
                        const float* w2, const float* b2, float clamp,
                        float* scratch, void* stream) {
  k8::HalfArgs a{};
  a.x_in = x_in;
  a.x_aff = x_aff;
  a.out = y;
  a.n = n;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.caff = caff;
  a.clamp = clamp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(inverse ? k8::run_half<k8::kInverse>(a, hid, w1, b1, w2, b2,
                                                    scratch, s)
                       : k8::run_half<k8::kForward>(a, hid, w1, b1, w2, b2,
                                                    scratch, s));
}

const char* sininn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
