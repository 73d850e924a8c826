// The tensor-core building blocks shared by the bf16 kernels of
// hpfg_tpu_torch/csrc (conv3x3.cu, window_attention.cu): bf16 <-> fp32 as raw
// 16-bit patterns, 16-byte cp.async into shared memory, ldmatrix and
// mma.sync m16n8k16 with bf16 operands and fp32 sums.
//
// bf16 tensors are handled as their raw 16-bit patterns (uint16_t) and
// converted with bf2f / f2bf, so no bf16 class crosses the staging code.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

static __device__ __forceinline__ float bf2f(uint32_t h) {
  return __uint_as_float(h << 16);
}
static __device__ __forceinline__ uint32_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}
// two values as one bf16x2 word, lo in the low half (the lower column)
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return f2bf(lo) | (f2bf(hi) << 16);
}

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src
// must still be a mapped address: callers pass the tensor's base then)
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                               const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
static __device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                                 const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
static __device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2],
                                                 const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row-major) * b (16x8, col-major): bf16 in, fp32 sums
static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
