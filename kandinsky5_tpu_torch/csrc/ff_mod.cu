// K2: the DiT block's AdaLN-modulated feed-forward,
//   y = x + gate * ( bf16(gelu_erf(bf16(LN(x) * (1 + scale) + shift) . W1^T)) . W2^T ),
// LayerNorm in fp32 (eps 1e-5, no affine), no biases.
//
// Replaces kandinsky5_tpu/ops/ff_pallas.py _ff_mod_kernel (reached via
// fused_ff_modulated). The TPU kernel carries the (rows x 1792) fp32
// second-product accumulator across its sequential ff-chunk grid steps;
// CUDA blocks cannot carry state, and that accumulator does not fit one
// block's shared memory at a useful row tile. So the work is two kernels:
//   ff_up:   LN + modulation applied while loading each A stage (row mean
//            and rstd computed once per block), GEMM1 on tensor cores,
//            erf-GELU epilogue, bf16 hidden written to device memory;
//   ff_down: GEMM2 over the whole ff width in one block's K loop (fp32
//            accumulation in registers), epilogue x + gate * acc in fp32.
// The TPU kernel also rounds the hidden to bf16 before W2, so the numerics
// match. GELU uses CUDA's erff (Mosaic lacked erf; the TPU kernel used an
// A&S polynomial).
//
// Bound on the H100: tensor-core rate (2 * rows * 1792 * 7168 MACs per
// product); the hidden round trip is 2 * rows * 7168 * 2 bytes, small next
// to it. Weights stay in the torch (out, in) layout, which is exactly the
// K-contiguous B operand mma.sync wants.
//
// K8: the plain fused FF, y = bf16(sum over ff of bf16(gelu_erf(x . W1^T))
// . W2^T) with the second product summed in fp32 (no LN, modulation, gate,
// residual or biases). Replaces kandinsky5_tpu/ops/ff_pallas.py _ff_kernel
// (reached via fused_ff), which the tensor-parallel DiT runs on each rank's
// W1 rows and W2 columns. Same split as K2 and for the same reason: MODE 2
// is the up product with A = x as it is, MODE 3 the down product over the
// whole (per-rank) ff width with the fp32 sum in registers. Bound: as K2.
//
// T3 (tools/bench_pallas_gemm.py _ff_kernel, both weights resident in
// VMEM) is K8's entry at ff 7168: 51 MB of weights cannot stay in 227 KB
// of shared memory, so both products stream their weight tiles through it.
// T4 (tools/bench_pallas_gemm.py _ff_tiled_kernel) keeps the TPU kernel's
// ff-chunk schedule: per chunk of bf columns, MODE 2 makes the (rows, bf)
// hidden and MODE 4 adds its down product to an fp32 accumulator that lives
// in device memory between the chunk launches (the TPU kernel's VMEM
// scratch between grid steps); the last chunk writes the bf16 output.
#include "common.cuh"

namespace {
using namespace k5;

constexpr float LN_EPS = 1e-5f;

// MODE 0: K2 up (A = normalized x, epilogue gelu -> hidden)
// MODE 1: K2 down (A = hidden, epilogue x + gate * acc -> out)
// MODE 2: K8 up (A = x, epilogue gelu -> hidden)
// MODE 3: K8 down (A = hidden, epilogue acc -> out)
// MODE 4: T4 down over one ff chunk (A = the chunk's hidden, epilogue
//         acc32 (+)= acc, and on the last chunk out = bf16(acc32))
// B is (N, K) with row stride ldb (K, but the ff width for a chunk of W2).
template <int MODE>
__global__ void __launch_bounds__(256)
ff_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bw,
          const bf16* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ shift, const float* __restrict__ gate,
          bf16* __restrict__ C, float* __restrict__ acc32, int M, int N,
          int K, int L, int ldb, int first, int last) {
  __shared__ __align__(16) bf16 As[GM * GST];
  __shared__ __align__(16) bf16 Bs[GN * GST];
  __shared__ float mean_s[GM], rstd_s[GM];

  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (MODE == 0) {
    // row statistics: mean, then mean((x - mean)^2), both in fp32
    for (int r = warp; r < GM; r += 8) {
      const int m = m0 + r;
      float mu = 0.f, var = 0.f;
      if (m < M) {
        const bf16* row = A + (size_t)m * K;
        float s = 0.f;
        for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mu = s / K;
        float s2 = 0.f;
        for (int c = lane; c < K; c += 32) {
          const float d = __bfloat162float(row[c]) - mu;
          s2 += d * d;
        }
        for (int o = 16; o; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        var = s2 / K;
      }
      if (lane == 0) {
        mean_s[r] = mu;
        rstd_s[r] = rsqrtf(var + LN_EPS);
      }
    }
    __syncthreads();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 ar[2], br[2];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256, row = idx >> 2, c8 = (idx & 3) * 8;
      const int m = m0 + row;
      uint4 r = make_uint4(0, 0, 0, 0);
      if (m < M) {
        r = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + c8);
        if (MODE == 0) {
          const int bi = m / L;
          const float mu = mean_s[row], rs = rstd_s[row];
          const float* sc = scale + (size_t)bi * K + k0 + c8;
          const float* sh = shift + (size_t)bi * K + k0 + c8;
          uint32_t* w = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_f2(w[e]);
            const float y0 = (f.x - mu) * rs * (sc[2 * e] + 1.f) + sh[2 * e];
            const float y1 = (f.y - mu) * rs * (sc[2 * e + 1] + 1.f) + sh[2 * e + 1];
            w[e] = pack_f2(y0, y1);
          }
        }
      }
      ar[i] = r;
    }
  };

  const int nk = K / GK;
  load_a(0);
  load_b_regs(Bw, ldb, n0, 0, br);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    store_stage_regs(As, ar);
    store_stage_regs(Bs, br);
    __syncthreads();
    if (kt + 1 < nk) {
      load_a((kt + 1) * GK);
      load_b_regs(Bw, ldb, n0, (kt + 1) * GK, br);
    }
    gemm_stage(As, Bs, acc);
  }

  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (MODE == 0 || MODE == 2) {
          v0 = 0.5f * v0 * (1.f + erff(v0 * 0.7071067811865476f));
          v1 = 0.5f * v1 * (1.f + erff(v1 * 0.7071067811865476f));
        } else if (MODE == 1) {
          const int bi = m / L;
          const float2 xr = unpack_f2(ld32(x + (size_t)m * N + n));
          v0 = xr.x + gate[(size_t)bi * N + n] * v0;
          v1 = xr.y + gate[(size_t)bi * N + n + 1] * v1;
        } else if (MODE == 4) {
          float2* a = reinterpret_cast<float2*>(acc32 + (size_t)m * N + n);
          if (!first) {
            const float2 prev = *a;
            v0 = prev.x + v0;
            v1 = prev.y + v1;
          }
          if (!last) {
            *a = make_float2(v0, v1);
            continue;
          }
        }
        *reinterpret_cast<uint32_t*>(C + (size_t)m * N + n) = pack_f2(v0, v1);
      }
    }
}

}  // namespace

// x (B*L, D) bf16; scale/shift/gate (B, D) fp32; w1 (FF, D), w2 (D, FF)
// bf16; hidden (B*L, FF) bf16 scratch; out (B*L, D) bf16.
extern "C" int k5_ff_mod(const void* x, const void* scale, const void* shift,
                         const void* gate, const void* w1, const void* w2,
                         void* hidden, void* out, int B, int L, int D, int FF,
                         void* stream) {
  const int M = B * L;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g1((M + GM - 1) / GM, FF / GN);
  ff_kernel<0><<<g1, 256, 0, s>>>((const bf16*)x, (const bf16*)w1, nullptr,
                                  (const float*)scale, (const float*)shift,
                                  nullptr, (bf16*)hidden, nullptr, M, FF, D,
                                  L, D, 1, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((M + GM - 1) / GM, D / GN);
  ff_kernel<1><<<g2, 256, 0, s>>>((const bf16*)hidden, (const bf16*)w2,
                                  (const bf16*)x, nullptr, nullptr,
                                  (const float*)gate, (bf16*)out, nullptr, M,
                                  D, FF, L, FF, 1, 1);
  return (int)cudaGetLastError();
}

// K8 (and T3): x (M, D) bf16; w1 (FF, D), w2 (D, FF) bf16; hidden (M, FF)
// bf16 scratch; out (M, D) bf16.
extern "C" int k5_ff(const void* x, const void* w1, const void* w2,
                     void* hidden, void* out, int M, int D, int FF,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g1((M + GM - 1) / GM, FF / GN);
  ff_kernel<2><<<g1, 256, 0, s>>>((const bf16*)x, (const bf16*)w1, nullptr,
                                  nullptr, nullptr, nullptr, (bf16*)hidden,
                                  nullptr, M, FF, D, 1, D, 1, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g2((M + GM - 1) / GM, D / GN);
  ff_kernel<3><<<g2, 256, 0, s>>>((const bf16*)hidden, (const bf16*)w2,
                                  nullptr, nullptr, nullptr, nullptr,
                                  (bf16*)out, nullptr, M, D, FF, 1, FF, 1, 1);
  return (int)cudaGetLastError();
}

// T4: as k5_ff over ff chunks of BF columns; hidden (M, BF) bf16 and acc
// (M, D) fp32 scratch. parts selects the kernels, for a timing split: 1 the
// up kernels, 2 the down kernels (MODE 4), 4 the down kernels as MODE 3
// (no fp32 accumulator: each chunk overwrites out). T4 is parts = 3.
extern "C" int k5_ff_chunked(const void* x, const void* w1, const void* w2,
                             void* hidden, void* acc, void* out, int M, int D,
                             int FF, int BF, int parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nj = FF / BF;
  cudaError_t e = cudaSuccess;
  for (int j = 0; j < nj; ++j) {
    if (parts & 1) {
      dim3 g1((M + GM - 1) / GM, BF / GN);
      ff_kernel<2><<<g1, 256, 0, s>>>(
          (const bf16*)x, (const bf16*)w1 + (size_t)j * BF * D, nullptr,
          nullptr, nullptr, nullptr, (bf16*)hidden, nullptr, M, BF, D, 1, D,
          1, 1);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    dim3 g2((M + GM - 1) / GM, D / GN);
    if (parts & 2) {
      ff_kernel<4><<<g2, 256, 0, s>>>(
          (const bf16*)hidden, (const bf16*)w2 + (size_t)j * BF, nullptr,
          nullptr, nullptr, nullptr, (bf16*)out, (float*)acc, M, D, BF, 1, FF,
          j == 0, j == nj - 1);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (parts & 4) {
      ff_kernel<3><<<g2, 256, 0, s>>>(
          (const bf16*)hidden, (const bf16*)w2 + (size_t)j * BF, nullptr,
          nullptr, nullptr, nullptr, (bf16*)out, nullptr, M, D, BF, 1, FF, 1,
          1);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
