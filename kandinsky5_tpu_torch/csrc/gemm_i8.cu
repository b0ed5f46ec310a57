// T1: the GEMM rate probe, C = A . B^T on tensor cores in two instances:
// int8 (s8 x s8 -> s32, mma.sync m16n8k32) and bf16 (bf16 x bf16 -> f32,
// mma.sync m16n8k16).
//
// Replaces tools/bench_int8mm.py _mm_kernel (reached via mm_pallas), the
// K-gridded tiled matmul that asks whether int8 pays against bf16. The TPU
// kernel carries its accumulator across sequential grid steps; here a block
// loops over K itself. A is (M, K) and B is (N, K), both K-contiguous (B in
// nn.Linear's (out, in) layout; the JAX tool's B is its transpose), so
// both tiles are read row-major and serve as the A and "col" B operands
// directly.
//
// Bound on the H100: tensor-core throughput at these sizes (1,979 TOP/s
// int8, 989 TFLOP/s bf16). Design, simple for now (mma.sync, no
// TMA/wgmma): a 128 x 128 output tile per block of 8 warps (2 x 4, each
// 64 x 32), K in 64-byte steps (64 int8 or 32 bf16) through two cp.async
// shared-memory stages, accumulators in registers, written once. Both
// instances share the byte geometry: a 32-byte-deep product step reads the
// same offsets for either type (common.cuh). M and N must be multiples of
// 128 and the row length in bytes a multiple of 64; the wrapper checks.
//
// T2: the row-block GEMM probe y = bf16(x . W^T), fp32 accumulation.
// Replaces tools/bench_pallas_gemm.py _gemm_kernel (reached via
// pallas_gemm), which keeps the whole (1792, 1792) weight resident in VMEM
// and walks 512-row blocks of x. It is T1's bf16 instance with a bf16
// epilogue (each fp32 sum rounded once): at 6.4 MB the weight cannot stay
// in shared memory here, so its 128 x 32 tiles stream through the same two
// cp.async stages as x's, and the 50 MB L2 keeps it on chip across blocks.
// Bound: tensor-core rate (2 * 47616 * 1792^2 = 0.306 TFLOP, 0.31 ms).
#include <type_traits>

#include "common.cuh"

namespace {
using namespace k5;

constexpr int TM = 128, TN = 128, KB = 64;  // tile rows, cols, K bytes a step
constexpr int ST = KB + 16;                 // smem row stride in bytes

template <bool I8, bool BF16_OUT = false>
__global__ void __launch_bounds__(256)
gemm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
            void* __restrict__ C, int N, int kbytes) {
  __shared__ __align__(16) uint8_t As[2][TM * ST];
  __shared__ __align__(16) uint8_t Bs[2][TN * ST];
  using Acc = typename std::conditional<I8, int, float>::type;

  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, row = idx >> 2, c = (idx & 3) * 16;
      cp_async16(As[s] + row * ST + c, A + (size_t)(m0 + row) * kbytes + k0 + c);
      cp_async16(Bs[s] + row * ST + c, B + (size_t)(n0 + row) * kbytes + k0 + c);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nk = kbytes / KB;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * KB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* as = As[kt & 1];
    const uint8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint8_t* p = as + (wm * 64 + mt * 16 + g) * ST + ks * 32 + 4 * t;
        a[mt][0] = ld32(p);
        a[mt][1] = ld32(p + 8 * ST);
        a[mt][2] = ld32(p + 16);
        a[mt][3] = ld32(p + 8 * ST + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* p = bs + (wn * 32 + nt * 8 + g) * ST + ks * 32 + 4 * t;
        b[nt][0] = ld32(p);
        b[nt][1] = ld32(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if constexpr (I8)
            mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
          else
            mma16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
    }
    __syncthreads();
  }

  if constexpr (BF16_OUT) {
    bf16* c = reinterpret_cast<bf16*>(C);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const size_t row = m0 + wm * 64 + mt * 16 + g;
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(c + row * N + col) =
            pack_f2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<uint32_t*>(c + (row + 8) * N + col) =
            pack_f2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    return;
  }
  Acc* c = reinterpret_cast<Acc*>(C);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const size_t row = m0 + wm * 64 + mt * 16 + g;
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
      Acc* p0 = c + row * N + col;
      Acc* p1 = c + (row + 8) * N + col;
      p0[0] = acc[mt][nt][0];
      p0[1] = acc[mt][nt][1];
      p1[0] = acc[mt][nt][2];
      p1[1] = acc[mt][nt][3];
    }
}

}  // namespace

// a (M, K) int8, b (N, K) int8 -> c (M, N) int32.
extern "C" int k5_gemm_i8(const void* a, const void* b, void* c, int M, int N,
                          int K, void* stream) {
  dim3 grid(N / TN, M / TM);
  gemm_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, c, N, K);
  return (int)cudaGetLastError();
}

// a (M, K) bf16, b (N, K) bf16 -> c (M, N) fp32.
extern "C" int k5_gemm_bf16(const void* a, const void* b, void* c, int M, int N,
                            int K, void* stream) {
  dim3 grid(N / TN, M / TM);
  gemm_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, c, N, 2 * K);
  return (int)cudaGetLastError();
}

// T2: a (M, K) bf16, b (N, K) bf16 -> c (M, N) bf16.
extern "C" int k5_gemm_bf16_out(const void* a, const void* b, void* c, int M,
                                int N, int K, void* stream) {
  dim3 grid(N / TN, M / TM);
  gemm_kernel<false, true><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, c, N, 2 * K);
  return (int)cudaGetLastError();
}
