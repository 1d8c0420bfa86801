// Device helpers shared by the fused 1x1 GLOW coupling kernels
// (csrc/coupling_1x1.cu: K1/K2, forward and inverse; csrc/coupling_1x1_bwd.cu:
// K3/K4, their VJPs): fp32/bf16 storage, the clamped log-scale, fp32
// products as three TF32 products on mma.sync.m16n8k8 (3xTF32), 16-byte
// cp.async, and the kernel that packs the OIHW weights into the products'
// zero-padded operands.
//
// 3xTF32: each fp32 operand a is split into hi = tf32(a) (cvt.rna: to
// nearest, ties away from zero) and lo = tf32(a - hi), and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulation. The dropped
// lo lo term and the rounding of lo leave about 2^-21 of each product, near
// fp32's own 2^-24; one-pass TF32 keeps 2^-11. The tensor cores add into
// the accumulator with truncation, whose bias grows with the number of
// adds: callers start every run of at most 12 mma (4 k-steps) from 0 and
// add it to their running sum in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;   // dynamic shared memory of a Hopper block

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// v rounded to the nearest bf16 value (ties to even), as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// le(s) = clamp (2/pi) atan(s / clamp)
__device__ __forceinline__ float log_e(float s, float clamp) {
  return clamp * 0.636619772367581343f * atanf(s / clamp);
}

// ---- 3xTF32 on mma.sync.m16n8k8 ----

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with a split into (hi, lo) and b = (b0, b1) split here.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, lo, bh0, bh1);
  mma(c, hi, bl0, bl1);
  mma(c, hi, bh0, bh1);
}

// ---- 16-byte cp.async ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- packing the weights ----

// One matrix to pack: element (i, j) of a rows x cols matrix into a
// rows_pad x cols_pad row-major operand, zero padded.
struct PackMat {
  long long dst;       // floats into the packed buffer
  int rows, cols;      // real size (cols: of s alone for a paired matrix)
  int rows_pad, cols_pad;
  const float* src;    // element (i, j) at src[i * sr + j * sc]
  int sr, sc;
  int paired;          // columns as pairs of 8-column tiles [s | t]
  int split;           // each element stored as its TF32 (hi, lo) pair
};
constexpr int kMaxPack = 12;
struct PackArgs {
  PackMat mat[kMaxPack];
  int count;
};

constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(PackArgs p, float* __restrict__ out) {
  const PackMat& d = p.mat[blockIdx.y];
  const long long n = (long long)d.rows_pad * d.cols_pad;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(e / d.cols_pad), j = (int)(e % d.cols_pad);
    int col = j;
    bool ok = j < d.cols;
    if (d.paired) {   // tile 2q: s[8q + w]; tile 2q + 1: t[8q + w]
      const int ch = 8 * (j / 16) + (j & 7);
      ok = ch < d.cols;
      col = (j & 8) ? d.cols + ch : ch;
    }
    const float v = (i < d.rows && ok) ? __ldg(d.src + (long long)i * d.sr +
                                              (long long)col * d.sc)
                                       : 0.f;
    if (d.split) {
      uint32_t hi, lo;
      split(v, hi, lo);
      out[d.dst + 2 * e] = __uint_as_float(hi);
      out[d.dst + 2 * e + 1] = __uint_as_float(lo);
    } else {
      out[d.dst + e] = v;
    }
  }
}

// pack_kernel on `s`, one grid row a matrix.
inline cudaError_t pack(const PackArgs& p, float* out, cudaStream_t s) {
  long long most = 0;
  for (int i = 0; i < p.count; ++i) {
    const long long n = (long long)p.mat[i].rows_pad * p.mat[i].cols_pad;
    most = n > most ? n : most;
  }
  long long gx = (most + kPackThreads - 1) / kPackThreads;
  if (gx > 1024) gx = 1024;
  pack_kernel<<<dim3((unsigned)gx, (unsigned)p.count), kPackThreads, 0, s>>>(
      p, out);
  return cudaGetLastError();
}

}  // namespace
