// The port's one GEMM mainloop for Hopper: C = A . B^T with A (M, K) and B
// (N, K) both K-contiguous (B in nn.Linear's (out, in) layout), bf16 x bf16
// -> fp32 or s8 x s8 -> s32, each 8 consecutive outputs of a row handed to an
// epilogue functor. K2's and K8's five products (ff_mod.cu) and T1's and
// T2's (gemm_i8.cu) are instances of it.
//
// Bound: the tensor cores (989 TFLOP/s bf16, 1,979 TOP/s int8), above the
// bytes at every main-path shape. The schedule:
//   * persistent blocks, about one per SM, walk 128 x 256 output tiles row
//     band by row band (a band's tiles run side by side, so its A rows and
//     the weight panel are read from L2);
//   * one producer thread feeds 128-byte k steps (64 bf16 or 128 int8) by
//     TMA, 128-byte swizzled, A 128 x 128 B and B 256 x 128 B: 48 KB a
//     stage either way, into a 4-stage ring with a full and an empty
//     mbarrier per stage. A ragged last row tile, the columns past N and the
//     k steps past K are zero-filled by TMA and masked at the store;
//   * two consumer warpgroups, 64 rows each, run four wgmma m64n256k16 (bf16)
//     or m64n256k32 (s8) per stage, at the same descriptor offsets (+2 per 32
//     bytes), both operands in shared memory, the sums in 128 registers a
//     thread, one k step in flight; setmaxnreg moves registers from the
//     producer to them;
//   * CM = 2 runs blocks in clusters of two along M: the two blocks take
//     row tiles m and m + 1 of the same column tile, each loads its own A
//     and half of B, and TMA multicasts each half into both blocks, so a
//     pair of tiles draws 2 x 128 + 256 rows from L2 per k step instead of
//     2 x (128 + 256): a third less. A stage is refilled once the consumers
//     of both blocks have released it (16 arrivals on its empty barrier);
//   * the epilogue works on the accumulators in registers. DIRECT: a
//     transpose within each quad of lanes gives every lane 8 consecutive
//     columns of its row, handed to ``epi(m, n, y)`` (16-byte accesses).
//     STAGED: each warpgroup writes its outputs (bf16 through ``epi.act``,
//     or the 32-bit sums) into two 8 KB slabs of its own shared memory in
//     the 128-byte swizzled layout and one thread stores them by TMA, which
//     runs on while the warpgroup starts the next tile's products.
//
// An epilogue is a functor with int fields M, N, K; DIRECT calls
// ``operator()(int m, int n, Acc (&y)[8])`` for m < M, n < N (N a multiple of
// 8); STAGED stores ``Epi::Out`` elements (bf16, int or float), calling
// ``float act(float)`` on bf16 ones. Its type must be local to the
// translation unit (an anonymous namespace), so that every instantiation of
// the kernel is too.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace k5 {
namespace sm90 {

constexpr int TM = 128;        // output tile rows
constexpr int BN = 256;        // output tile columns
constexpr int KB = 128;        // bytes of K a stage
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int NS = 4;          // ring stages
constexpr uint32_t A_BYTES = TM * KB;
constexpr uint32_t B_BYTES = BN * KB;
constexpr uint32_t STAGE = A_BYTES + B_BYTES;
constexpr uint32_t SLAB = 64 * 128;  // a staged slab: 64 rows of 128 bytes
constexpr int SLABS = 2;             // staged slabs a warpgroup

enum Store { DIRECT = 0, STAGED = 1 };

// A schedule of the mainloop: CM blocks a cluster (1, or 2 along M sharing B
// by multicast) and the store (DIRECT, or STAGED through SLABS slabs of
// shared memory a warpgroup).
template <int CM_, int STORE_>
struct Schedule {
  static constexpr int CM = CM_, STORE = STORE_;
  static constexpr uint32_t C_BYTES = STORE == STAGED ? SLABS * SLAB : 0;
  static constexpr uint32_t SMEM = 1024 + NS * STAGE + 2 * C_BYTES;
  static_assert(CM == 1 || CM == 2, "clusters of 1 or 2 blocks");
  static_assert(SMEM <= 232448, "shared memory");
};
// K2's and K8's schedule
using Coop = Schedule<1, DIRECT>;
// T1's (clusters of two), and T2's and T1 int8's at K <= 2048 (staged)
using Cluster2 = Schedule<2, DIRECT>;
using Cluster2Staged = Schedule<2, STAGED>;

// The operand type: its accumulator, tensor-map type, elements a k step and
// the wgmma that covers 32 bytes of K.
template <typename T>
struct Operand;

template <>
struct Operand<bf16> {
  using Acc = float;
  static constexpr int BYTES = 2;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int accumulate) {
    wgmma_m64n256k16_ss(d, da, db, accumulate);
  }
};

template <>
struct Operand<int8_t> {
  using Acc = int;
  static constexpr int BYTES = 1;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static __device__ __forceinline__ void mma(int (&d)[128], uint64_t da,
                                             uint64_t db, int accumulate) {
    wgmma_m64n256k32_s8_ss(d, da, db, accumulate);
  }
};

// Lanes t of a quad each hold, for one row, the column pairs 2t, 2t+1 of four
// adjacent 8-column groups (x[j], y[j] of group j). Afterwards lane t holds
// group t whole: x[s], y[s] = columns 2s, 2s+1 of it. Two exchange rounds
// (lane bits 0, then 1), each swapping the two slots whose bit differs from
// the lane's.
template <typename V>
__device__ __forceinline__ void quad_transpose(V (&x)[4], V (&y)[4], int t) {
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool hi = t & bit;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // bit 1 pairs slots (0,1), (2,3); bit 2 pairs (0,2), (1,3); the slots
      // are constants after unrolling, the choice between them a select
      const int a = bit == 1 ? 2 * k : k, b = a + bit;
      const V rx = __shfl_xor_sync(0xffffffffu, hi ? x[a] : x[b], bit);
      const V ry = __shfl_xor_sync(0xffffffffu, hi ? y[a] : y[b], bit);
      if (hi) {
        x[a] = rx;
        y[a] = ry;
      } else {
        x[b] = rx;
        y[b] = ry;
      }
    }
  }
}

// One warp's 16 rows of a 64 x 256 accumulator (wgmma's layout: d[4 j + i] is
// row g + 8 (i / 2), column 8 j + 2 t + i % 2) through the epilogue, 8
// consecutive columns a call. r0 is the row of g, n0 the tile's first column.
template <class Epi, typename Acc>
__device__ __forceinline__ void epilogue_direct(const Acc (&d)[128], const Epi& e,
                                                int r0, int n0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    const bool row_ok = m < e.M;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      Acc x[4], y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = d[4 * (4 * q + j) + 2 * h];
        y[j] = d[4 * (4 * q + j) + 2 * h + 1];
      }
      quad_transpose(x, y, t);
      const int n = n0 + 32 * q + 8 * t;
      if (!row_ok || n >= e.N) continue;
      Acc v[8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        v[2 * s] = x[s];
        v[2 * s + 1] = y[s];
      }
      e(m, n, v);
    }
  }
}

// Two 32-bit sums to shared memory as they are: no conversion may read the
// accumulator registers (a mov from them serializes the wgmma pipeline).
__device__ __forceinline__ void store2(uint8_t* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint8_t* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// A warpgroup's 64 x 256 outputs (Epi::Out: bf16 through epi.act, or the
// 32-bit sums as they are) stored by TMA through its SLABS slabs of shared
// memory ``c``, a round of SLABS slabs at a time: a slab holds 128 bytes of
// each of the 64 rows (64 bf16 or 32 sums), 128-byte swizzled (the 16-byte
// chunk c of row r at c ^ (r % 8)), as the TMA store reads it. Each lane
// writes its column pair (4 or 8 bytes); the 8 rows of a warp's store land
// in distinct chunks, at most two lanes a bank. A round first waits until
// the stores of the last one have read the slabs; the stores themselves run
// on under the next tile's products. r is the warp's row of g within the
// 64, (m0, n0) the warpgroup's first output.
template <class Epi, typename Acc>
__device__ __forceinline__ void epilogue_staged(const Acc (&d)[128], const Epi& e,
                                                const CUtensorMap* tc, uint8_t* c,
                                                int r, int t, int tw, int bar,
                                                int m0, int n0) {
  using Out = typename Epi::Out;
  constexpr int E = sizeof(Out);
  constexpr int COLS = 128 / E;    // columns a slab
  constexpr int NSLAB = BN / COLS;  // slabs of the 256 columns
  constexpr int JS = COLS / 8;      // 8-column groups a slab
  static_assert(NSLAB % SLABS == 0, "whole rounds");
#pragma unroll
  for (int first = 0; first < NSLAB; first += SLABS) {
    if (tw == 0) bulk_wait_read<0>();
    named_sync<128>(bar);
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) {
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
        const int j = (first + sl) * JS + jj;
        const int byte = (8 * jj + 2 * t) * E;  // within the slab's row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          uint8_t* p = c + sl * SLAB + row * 128 +
                       ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15);
          if constexpr (E == 2)
            *reinterpret_cast<uint32_t*>(p) =
                pack_f2(e.act(d[4 * j + 2 * h]), e.act(d[4 * j + 2 * h + 1]));
          else
            store2(p, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
      }
    }
    fence_proxy_async();
    named_sync<128>(bar);
    if (tw == 0) {
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl)
        tma_store_2d(tc, c + sl * SLAB, n0 + (first + sl) * COLS, m0);
      bulk_commit();
    }
  }
}

// The tensor-map type of an output element.
template <typename Out>
constexpr CUtensorMapDataType out_map_type() {
  return sizeof(Out) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<Out, int>::value ? CU_TENSOR_MAP_DATA_TYPE_INT32
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// The first row and column of a cluster's tile ``tile`` in this block
// (``rank`` in the cluster): row band by row band, CM row tiles a band.
template <class S>
__device__ __forceinline__ void tile_origin(int tile, int n_n, uint32_t rank,
                                            int& m0, int& n0) {
  m0 = ((tile / n_n) * S::CM + (int)rank) * TM;
  n0 = (tile % n_n) * BN;
}

template <typename T, class S, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, const Epi e) {
  using Op = Operand<T>;
  using Acc = typename Op::Acc;
  constexpr int CM = S::CM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const uint32_t rank = CM == 1 ? 0 : cluster_ctarank();
  const int n_n = (e.N + BN - 1) / BN;
  const int n_groups = ((e.M + TM - 1) / TM + CM - 1) / CM;  // of CM row tiles
  const int n_tiles = n_groups * n_n;
  const int nk = (e.K * Op::BYTES + KB - 1) / KB;
  const int first = blockIdx.x / CM, stride = gridDim.x / CM;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      // lane 0 of each warp that reads the stage, in each block
      mbar_init(&empty[s], 8 * CM);
    }
    fence_barrier_init();
  }
  if (CM == 1)
    __syncthreads();
  else
    cluster_sync();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full across the tiles ----
    regs_dealloc<24>();
    if (tid == 0) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      int it = 0;
      for (int tile = first; tile < n_tiles; tile += stride) {
        int m0, n0;
        tile_origin<S>(tile, n_n, rank, m0, n0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % NS;
          const int k0 = kt * (KB / Op::BYTES);
          mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          tma_load_2d(st, &ta, &full[s], k0, m0);
          if (CM == 1)
            tma_load_2d(st + A_BYTES, &tb, &full[s], k0, n0);
          else
            tma_load_2d_multicast(st + A_BYTES + rank * (B_BYTES / CM), &tb,
                                  &full[s], k0, n0 + rank * (BN / CM),
                                  (uint16_t)((1u << CM) - 1));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile ----
    regs_alloc<240>();
    const int w = tid / 128 - 1, tw = tid & 127;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
    uint8_t* cst = ring + NS * STAGE + w * S::C_BYTES;  // STAGED only
    const int a_row = w * 64;                         // A rows of this warpgroup
    Acc acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;

    auto release = [&](int s) {
      if (lane != 0) return;
      if (CM == 1) {
        mbar_arrive(&empty[s]);
      } else {
#pragma unroll
        for (int c = 0; c < CM; ++c) mbar_arrive_cluster(&empty[s], c);
      }
    };

    int it = 0;
    for (int tile = first; tile < n_tiles; tile += stride) {
      int m0, n0;
      tile_origin<S>(tile, n_n, rank, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % NS;
        mbar_wait(&full[s], (it / NS) & 1);
        uint8_t* st = ring + s * STAGE;
        const uint64_t da = smem_desc(smem_u32(st + a_row * KB), 16, 1024, 1);
        const uint64_t db = smem_desc(smem_u32(st + A_BYTES), 16, 1024, 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          Op::mma(acc, da + 2 * kk, db + 2 * kk, kt | kk);
        wgmma_commit();
        // the previous k step's products are done: free its stage
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0) release((it - 1) % NS);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % NS);
      if constexpr (S::STORE == DIRECT) {
        epilogue_direct(acc, e, m0 + a_row + warp * 16 + g, n0, t);
      } else {
        epilogue_staged(acc, e, &tc, cst, warp * 16 + g, t, tw, 1 + w,
                                  m0 + a_row, n0);
      }
    }
    if (S::STORE == STAGED && tw == 0) bulk_wait<0>();
  }
  // no block of a cluster leaves while the other may still arrive on its
  // barriers
  if (CM > 1) {
    __syncwarp();
    cluster_sync();
  }
}

// Launch C = A (M, K; rows lda elements apart) . B (N, K; rows ldb apart)^T
// through ``e`` (M, N, K from it) on persistent blocks: one per SM, or per
// cluster slot the card can hold at once. ``c`` (STAGED only) is the (M, N)
// output of Epi::Out, rows N apart. Returns 0 or the first error (a tensor map
// that cannot be encoded returns its CUresult).
template <typename T, class S, class Epi>
int gemm(const void* a, int lda, const void* b, int ldb, void* c, const Epi& e,
         cudaStream_t stream) {
  using Op = Operand<T>;
  constexpr int CM = S::CM;
  auto kernel = gemm_kernel<T, S, Epi>;
  static bool ready[64] = {};
  static int slots[64] = {};  // blocks that run at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CM;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CM > 1 ? 1 : 0;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::SMEM);
    if (err != cudaSuccess) return (int)err;
    if (CM == 1) {
      err = cudaDeviceGetAttribute(&slots[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    } else {
      int clusters = 0;
      cfg.gridDim = dim3(CM);
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      slots[dev] = clusters * CM;
    }
    if (err != cudaSuccess) return (int)err;
    if (slots[dev] < CM) return (int)cudaErrorInvalidConfiguration;
    ready[dev] = true;
  }
  const int groups = ((e.M + TM - 1) / TM + CM - 1) / CM;
  const int tiles = groups * ((e.N + BN - 1) / BN);
  if (tiles == 0) return 0;

  CUtensorMap ta, tb, tc = {};
  int rc = kmajor_sw128_map(&ta, a, Op::MAP, Op::BYTES, e.K, e.M, lda, TM);
  if (rc == 0)
    rc = kmajor_sw128_map(&tb, b, Op::MAP, Op::BYTES, e.K, e.N, ldb, BN / CM);
  if constexpr (S::STORE == STAGED) {
    using Out = typename Epi::Out;
    if (rc == 0)
      rc = kmajor_sw128_map(&tc, c, out_map_type<Out>(), sizeof(Out), e.N, e.M,
                            e.N, 64);
  }
  if (rc != 0) return rc;
  const int clusters = slots[dev] / CM;
  cfg.gridDim = dim3(CM * (tiles < clusters ? tiles : clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, ta, tb, tc, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace k5
