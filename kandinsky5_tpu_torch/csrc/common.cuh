// Shared device helpers for the port's hand-written Hopper kernels: the bf16
// type, bf16x2 packing, quad reductions over the four lanes that share a row
// of a tensor-core fragment (lanes 4g..4g+3), and 16-byte cp.async copies.
// The wgmma, TMA and mbarrier building blocks are in hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k5 {

typedef __nv_bfloat16 bf16;

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
