// Tensor-core and asynchronous-copy helpers shared by the hand-written
// Hopper kernels (linear_attention.cu, step_megakernel.cu): fp32 products
// on the TF32 tensor cores in 3xTF32 (mma.sync m16n8k8), and cp.async
// copies from device to shared memory. Each source that includes this
// header gets its own internal copy; nvcc finds it beside the source.
//
// 3xTF32: each fp32 operand v is split into TF32 parts hi + lo, and a b is
// formed as a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulation,
// which keeps a product to about 2^-19 relative (one-product TF32: 2^-11).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; when `valid` is false nothing is read and the
// destination is filled with zeros.
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
#endif
}
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// fp32 -> (hi, lo) TF32 pair: hi is v with its low 13 mantissa bits
// cleared (a TF32 value), lo = v - hi exactly (|lo| < 2^-10 |v|), of which
// the tensor cores read the top 10 mantissa bits; hi + lo = v to about
// 2^-20 relative. Two full-rate integer and float instructions, not two
// conversions.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 tensor-core product (fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// One step of a 3xTF32 product on fragments already in registers.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

}  // namespace
