// T1: the GEMM rate probe, C = A . B^T in two instances: int8 (s8 x s8 ->
// exact s32) and bf16 (bf16 x bf16 -> f32).
//
// Replaces tools/bench_int8mm.py _mm_kernel (reached via mm_pallas), the
// K-gridded tiled matmul that asks whether int8 pays against bf16. The TPU
// kernel carries its accumulator across sequential grid steps; here a block
// loops over K itself. A is (M, K) and B is (N, K), both K-contiguous (B in
// nn.Linear's (out, in) layout; the JAX tool's B is its transpose).
//
// T2: the row-block GEMM probe y = bf16(x . W^T), fp32 accumulation.
// Replaces tools/bench_pallas_gemm.py _gemm_kernel (reached via
// pallas_gemm), which keeps the whole (1792, 1792) weight resident in VMEM
// and walks 512-row blocks of x. At 6.4 MB the weight cannot stay in shared
// memory here; the 50 MB L2 keeps it on chip while its tiles stream past.
//
// Bound on the H100: the tensor cores (1,979 TOP/s int8, 989 TFLOP/s bf16)
// at every shape the tools time; at (47616, 1792, 7168) T1's 32-bit output
// alone is 1.37 GB (0.41 ms at 3.35 TB/s) against a 0.618 ms int8 bound, so
// its epilogue must overlap the products. All three are instances of the
// shared mainloop (gemm_sm90.cuh, the one K2 and K8 run): persistent blocks
// over 128 x 256 tiles, 128-byte k steps (64 bf16 or 128 int8, 48 KB a
// stage either way) fed by TMA, two consumer warpgroups on wgmma
// m64n256k16 (bf16) or m64n256k32 (s8). The instances here run in clusters
// of two blocks along M that share each weight stage by TMA multicast (a
// third less L2 traffic per product). T1 writes 8 consecutive 32-bit sums
// per lane and row as two 16-byte stores; T2, and T1's int8 instance at K
// <= 2048, write their outputs into 16 KB of shared memory a warpgroup, from
// where TMA stores them while the next tile's products run.
#include <type_traits>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

// T1: 8 sums of row m as two 16-byte stores into the (M, N) output.
template <typename Acc>
struct store32 {
  using Out = Acc;
  Acc* out;
  int M, N, K;

  __device__ __forceinline__ void operator()(int m, int n, Acc (&y)[8]) const {
    Acc* p = out + (size_t)m * N + n;
    if constexpr (std::is_same<Acc, int>::value) {
      reinterpret_cast<int4*>(p)[0] = make_int4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<int4*>(p)[1] = make_int4(y[4], y[5], y[6], y[7]);
    } else {
      reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
};

// T2: the sums rounded once to bf16 by the staged store; no activation.
struct store_bf16 {
  using Out = bf16;
  bf16* out;
  int M, N, K;

  __device__ __forceinline__ float act(float v) const { return v; }
};

// C (M, N) of type Out = A (M, K) . B (N, K)^T, operands of type T, on
// schedule S.
template <typename T, typename Out, class S>
int run(const void* a, const void* b, void* c, int M, int N, int K,
        cudaStream_t s) {
  if constexpr (std::is_same<Out, bf16>::value) {
    const store_bf16 e = {(bf16*)c, M, N, K};
    return sm90::gemm<T, S>(a, K, b, K, c, e, s);
  } else {
    const store32<Out> e = {(Out*)c, M, N, K};
    return sm90::gemm<T, S>(a, K, b, K, c, e, s);
  }
}

}  // namespace

// Every pointer 16-byte aligned, N a multiple of 8, K times the element size
// a multiple of 16; any M. Each entry returns the first CUDA error (a tensor
// map that cannot be encoded returns its CUresult).

// a (M, K) int8, b (N, K) int8 -> c (M, N) int32. Up to 16 k steps a tile
// (K <= 2048) the 32-bit outputs cost as much as a good part of the
// products, and storing them by TMA under the next tile's products pays;
// beyond, the direct store does.
extern "C" int k5_gemm_i8(const void* a, const void* b, void* c, int M, int N,
                          int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 16 * sm90::KB)
    return run<int8_t, int, sm90::Cluster2Staged>(a, b, c, M, N, K, s);
  return run<int8_t, int, sm90::Cluster2>(a, b, c, M, N, K, s);
}

// a (M, K) bf16, b (N, K) bf16 -> c (M, N) fp32.
extern "C" int k5_gemm_bf16(const void* a, const void* b, void* c, int M, int N,
                            int K, void* stream) {
  return run<bf16, float, sm90::Cluster2>(a, b, c, M, N, K, (cudaStream_t)stream);
}

// T2: a (M, K) bf16, b (N, K) bf16 -> c (M, N) bf16, stored by TMA.
extern "C" int k5_gemm_bf16_out(const void* a, const void* b, void* c, int M,
                                int N, int K, void* stream) {
  return run<bf16, bf16, sm90::Cluster2Staged>(a, b, c, M, N, K,
                                               (cudaStream_t)stream);
}
