// Hopper (sm_90a) building blocks for the port's warp-specialised kernels:
// mbarriers, TMA tile loads (multicast within a cluster) and stores described
// by a CUtensorMap, wgmma shared-memory descriptors for 128-byte-swizzled
// tiles, the wgmma products themselves, named and cluster barriers and
// register reallocation.
//
// K1's, K4's and K6's tiles and the shared GEMM's (gemm_sm90.cuh: K2, K8,
// T1, T2) are rows of exactly 128 bytes (64 bf16, or 128 int8 in T1)
// written by TMA with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands
// at chunk c ^ (r % 8). Every tile starts on a 1024-byte boundary, so the
// swizzle pattern (a function of the absolute shared address) is the one
// wgmma's 128B layout expects; K4's 512-wide rows are 8 such tiles of 64
// columns (slabs), one TMA box each. K3's weight tiles and K5/K7's int8 Q
// and K tiles (64 int8 a row) are rows of 64 bytes with the 64B swizzle (the
// same rule at half the width, tiles on 512-byte boundaries), and K3's
// activation operand is non-swizzled (``smem_desc``).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k5 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive once and announce ``bytes`` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Make barrier initialisation and generic-proxy shared-memory writes visible
// to the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ---------------------------------------------------------------------

// Load one box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completion is counted in bytes on ``bar``.
// Elements outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The same for a 3-D tensor map at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The same for a 2-D tensor map at (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy ``bytes`` (a multiple of 16, both addresses 16-byte aligned) of
// contiguous global memory into shared memory; completion is counted in
// bytes on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Store one box of shared memory (written by this CTA, then made visible to
// the async proxy with fence_proxy_async) to a 2-D tensor map at (c0, c1).
// Elements outside the tensor are not written. Completion is tracked by
// bulk groups: bulk_commit, then bulk_wait_read (the shared memory may be
// written again) or bulk_wait (the global writes are done).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- thread block clusters ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before it (barrier initialisation included) are
// visible cluster-wide after it, and no block's shared memory is released
// while another block of the cluster may still reach into it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Arrive on the mbarrier at ``bar``'s shared-memory offset in block ``cta``
// of the cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(smem_u32(bar)), "r"(cta)
      : "memory");
}

// tma_load_2d into the same shared-memory offset of every block of the
// cluster in ``mask`` (bit i: block i), counting the bytes on the mbarrier
// at ``bar``'s offset in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (in bytes; the hardware takes them in 16-byte units) and the layout
// ``mode`` in bits 62-63: 0 no swizzle, 1 128B, 2 64B, 3 32B swizzle.
//   128B swizzle, K-major tile (rows of 64 bf16 along K): lbo unused (16),
//     sbo = 1024, the stride between groups of 8 rows; step 16 deep along K
//     by adding 32 bytes to the start address.
//   128B swizzle, MN-major tile (rows of 64 bf16 along N, one row per k):
//     sbo = 1024, the stride between groups of 8 k; lbo = the distance to the
//     next 64 columns of N; step 16 deep along K by adding 16 rows = 2048
//     bytes.
//   64B swizzle, K-major (rows of 64 bytes written by TMA with
//     CU_TENSOR_MAP_SWIZZLE_64B, the tile on a 512-byte boundary): lbo unused
//     (16), sbo = 512; step 32 bytes along K by adding 32 bytes to the start
//     address.
//   No swizzle, K-major: the operand is made of core matrices of 8 rows x 16
//     bytes, each stored as 128 contiguous bytes (row r at 16 r); lbo = the
//     distance between core matrices adjacent in K, sbo = between those
//     adjacent in M (or N), i.e. between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t smem_addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may not
// move their uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define K5_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define K5_F16(a, i) K5_F4(a, i), K5_F4(a, i + 4), K5_F4(a, i + 8), K5_F4(a, i + 12)

// D (64x128, fp32) = or += A (64x16, K-major smem) . B (16x128, K-major smem),
// bf16 operands. ``accumulate`` = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : K5_F16(d, 0), K5_F16(d, 16), K5_F16(d, 32), K5_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64x72, fp32) += A (64x16 bf16, registers: the m16n8k16 A fragment of
// each warp's 16 rows) . B (16x72, MN-major smem, transposed on read).
__device__ __forceinline__ void wgmma_m64n72k16_rs(float (&d)[36], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : K5_F16(d, 0), K5_F16(d, 16), K5_F4(d, 32)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64x32, fp32) = or += A (64x16, K-major smem) . B (16x32, K-major smem),
// bf16 operands.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : K5_F16(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64x64, fp32) = or += A (64x16 bf16, registers: the m16n8k16 A fragment
// of each warp's 16 rows) . B (16x64 smem; TRANS_B = 0: K-major, 1:
// MN-major, transposed on read).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0,
                                                   uint32_t a1, uint32_t a2,
                                                   uint32_t a3, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : K5_F16(d, 0), K5_F16(d, 16)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

// D (64x256, fp32) += A (64x16 bf16, registers as above) . B (16x256,
// MN-major smem, transposed on read).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], uint32_t a0,
                                                    uint32_t a1, uint32_t a2,
                                                    uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : K5_F16(d, 0), K5_F16(d, 16), K5_F16(d, 32), K5_F16(d, 48),
        K5_F16(d, 64), K5_F16(d, 80), K5_F16(d, 96), K5_F16(d, 112)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64x256, fp32) = or += A (64x16, K-major smem) . B (16x256, K-major
// smem), bf16 operands. ``accumulate`` = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : K5_F16(d, 0), K5_F16(d, 16), K5_F16(d, 32), K5_F16(d, 48),
        K5_F16(d, 64), K5_F16(d, 80), K5_F16(d, 96), K5_F16(d, 112)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define K5_R4(a, i) "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3])
#define K5_R16(a, i) K5_R4(a, i), K5_R4(a, i + 4), K5_R4(a, i + 8), K5_R4(a, i + 12)

// D (64x128, int32) = or += A (64x32, K-major smem) . B (32x128, K-major
// smem), s8 operands, exact.
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64], uint64_t da,
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : K5_R16(d, 0), K5_R16(d, 16), K5_R16(d, 32), K5_R16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64x256, int32) = or += A (64x32, K-major smem) . B (32x256, K-major
// smem), s8 operands, exact. The 128-byte k step of a 128B-swizzled tile
// holds four of these, 32 bytes apart, as it holds four bf16 m64n256k16.
__device__ __forceinline__ void wgmma_m64n256k32_s8_ss(int (&d)[128], uint64_t da,
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : K5_R16(d, 0), K5_R16(d, 16), K5_R16(d, 32), K5_R16(d, 48),
        K5_R16(d, 64), K5_R16(d, 80), K5_R16(d, 96), K5_R16(d, 112)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef K5_R16
#undef K5_R4
#undef K5_F16
#undef K5_F4

// ---- warp specialisation -------------------------------------------------------

// Named barrier ``id`` (1-15; 0 is __syncthreads) over ``n`` threads.
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: launch ------------------------------------------------------------

// Raise ``kernel``'s dynamic shared memory limit to ``bytes`` on the current
// device the first time it is launched there (the attribute is per device);
// ``ready`` is the caller's record for this kernel. Returns the CUDA error.
inline int smem_limit_once(bool (&ready)[64], const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && ready[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) ready[dev] = true;
  return 0;
}

// ---- host: tensor maps -------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the CUDA
// runtime's entry-point query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// Tensor map of a bf16 (B, L, H, 64) tensor as 4-D (64, H, L, B), innermost
// first, read in boxes of (64, 1, rows, 1): ``rows`` consecutive positions of
// one head, 128 bytes each, 128-byte swizzled. Rows past L are zero-filled and
// never read the next batch. Returns 0 or a nonzero CUresult.
inline int bhld_map(CUtensorMap* map, const void* base, int B, int L, int H,
                    int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {128, (cuuint64_t)H * 128,
                                 (cuuint64_t)L * H * 128};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                 dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Tensor map of a (taps, rows, K) tensor with K contiguous, as 3-D (K, rows,
// taps), read in boxes of (box_k, box_rows, 1) whose rows are 64 bytes
// (box_k elements), 64-byte swizzled. Returns 0 or a nonzero CUresult.
inline int kmajor_sw64_map(CUtensorMap* map, const void* base,
                           CUtensorMapDataType type, int elem_bytes, int K,
                           int rows, int taps, int box_k, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)taps};
  const cuuint64_t strides[2] = {(cuuint64_t)K * elem_bytes,
                                 (cuuint64_t)rows * K * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_k, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return (int)fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Tensor map of a (rows, K) matrix of ``type`` (elements of ``elem_bytes``)
// whose rows lie ``ld`` elements apart (K contiguous), as 2-D (K, rows), read
// (or written) in boxes of (128 / elem_bytes, box_rows): rows of 128 bytes
// (64 bf16, 128 int8), 128-byte swizzled. Elements past K or past the last
// row are zero-filled on a load and skipped on a store. Returns 0 or a
// nonzero CUresult.
inline int kmajor_sw128_map(CUtensorMap* map, const void* base,
                            CUtensorMapDataType type, int elem_bytes, int K,
                            int rows, int ld, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return (int)fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace k5
