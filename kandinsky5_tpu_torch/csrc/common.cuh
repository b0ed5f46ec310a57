// Shared device helpers for the port's hand-written Hopper kernels.
//
// K5, K7 and T5 (every kernel but K1, K2/K8, K3, K4, K6, T1 and T2, whose
// wgmma building blocks are in hopper.cuh) are built around the warp-level
// tensor-core product mma.sync.m16n8k16 (bf16 x bf16 -> fp32). Its register
// layouts, per lane (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a[0] = (row g,   cols 2t..2t+1)
//                         a[1] = (row g+8, cols 2t..2t+1)
//                         a[2] = (row g,   cols 2t+8..2t+9)
//                         a[3] = (row g+8, cols 2t+8..2t+9)
//   B (16x8, "col"):      b[0] = (k 2t..2t+1, col g), b[1] = (k 2t+8..2t+9, col g)
//   C (16x8, fp32):       c[0..1] = (row g, cols 2t..2t+1), c[2..3] = (row g+8, same)
// Two adjacent C tiles of one row band therefore form one A operand, which
// lets attention feed its softmax weights to the second product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k5 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma.sync.m16n8k32 s8 x s8 -> s32. Its fragments hold the same BYTES as
// m16n8k16's above (four int8 where m16n8k16 holds two bf16): A a[0] =
// (row g, k 4t..4t+3), a[1] = (row g+8, same), a[2]/a[3] = k + 16; B b[0] =
// (k 4t..4t+3, col g), b[1] = k + 16; C as above, in int32. So one
// 32-byte-deep step of either product reads a tile stored row-major (A) or
// (N, K) row-major (B) at the same byte offsets.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values that are not adjacent in memory, packed low-first.
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two floats a packed pair holds after rounding to bf16.
__device__ __forceinline__ float2 unpack_f2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// 16-byte asynchronous copy global -> shared (bypassing L1), and the
// commit / wait of a group of such copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace k5
