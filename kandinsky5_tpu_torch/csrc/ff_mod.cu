// K2: the DiT block's AdaLN-modulated feed-forward,
//   y = x + gate * ( bf16(gelu_erf(bf16(LN(x) * (1 + scale) + shift) . W1^T)) . W2^T ),
// LayerNorm in fp32 (eps 1e-5, no affine), no biases.
//
// Replaces kandinsky5_tpu/ops/ff_pallas.py _ff_mod_kernel (reached via
// fused_ff_modulated). The TPU kernel carries the (rows x 1792) fp32
// second-product accumulator across its sequential ff-chunk grid steps;
// CUDA blocks cannot carry state, and that accumulator does not fit one
// block's shared memory at a useful row tile. So the bf16 hidden goes
// through device memory (682 MB a call at 47,616 rows, about 0.4 ms of
// traffic beside a 2.5 ms bound), and K2 is three kernels:
//   ff_modulate_kernel: one warp per row computes the LayerNorm statistics
//       in fp32 and writes x^ = bf16((x - mean) * rstd * (1 + scale) +
//       shift) once (the TPU kernel's rounding point), into the output
//       buffer, which holds x^ until the down product overwrites it;
//   GEMM, ff_epi<K2_UP>:   hidden = bf16(gelu_erf(x^ . W1^T));
//   GEMM, ff_epi<K2_DOWN>: out = bf16(x + gate[b(m)] * (hidden . W2^T)), with the
//       batch item b(m) = m / L taken per row (a row tile may straddle two).
// GELU uses CUDA's erff (Mosaic lacked erf; the TPU kernel used an A&S
// polynomial).
//
// K8: the plain fused FF, y = bf16(sum over ff of bf16(gelu_erf(x . W1^T))
// . W2^T), the second product summed in fp32 (no LN, modulation, gate,
// residual or biases). Replaces kandinsky5_tpu/ops/ff_pallas.py _ff_kernel
// (reached via fused_ff), which the tensor-parallel DiT runs on each rank's
// W1 rows and W2 columns: ff_epi<K8_UP> then ff_epi<K8_DOWN>, split as K2
// and for the same reason. T3 (tools/bench_pallas_gemm.py _ff_kernel) is
// K8's entry. T4 (tools/bench_pallas_gemm.py _ff_tiled_kernel) keeps the
// TPU kernel's ff-chunk schedule: per chunk of bf columns, K8's up product
// makes the (rows, bf) hidden and ff_epi<T4_DOWN> adds its down product to
// an fp32 accumulator in device memory (the TPU kernel's VMEM scratch
// between grid steps); the last chunk writes the bf16 output.
//
// Bound on the H100: the tensor cores (2 * rows * 1792 * 7168 MACs per
// product, 2.47 ms at 47,616 rows). All five products are instances of the
// shared GEMM mainloop (gemm_sm90.cuh, schedule Coop: persistent blocks
// over 128 x 256 tiles walked row band by row band, a TMA-fed 4-stage ring,
// two consumer warpgroups on wgmma m64n256k16) and differ only in their
// epilogues, ff_epi<MODE>, which get 8 consecutive columns of a row at a
// time: the residual, the gate and the fp32 accumulator are read, and the
// outputs written, 16 bytes at a time.
#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr float LN_EPS = 1e-5f;

// the epilogues (their numbers appear in the kernels' names in a profile:
// 0-1 are K2's, 2-4 K8's and T4's)
enum { K2_UP = 0, K2_DOWN = 1, K8_UP = 2, K8_DOWN = 3, T4_DOWN = 4 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = unpack_f2(w[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_f2(f[0], f[1]), pack_f2(f[2], f[3]),
                    pack_f2(f[4], f[5]), pack_f2(f[6], f[7]));
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// ---- the modulation pass ---------------------------------------------------

// x^ = bf16((x - mean) * rstd * (1 + scale[b]) + shift[b]) per row, one warp
// a row, 8 rows a block; the statistics in fp32, as the plain version's
// separate multiply and add. The row is re-read from L1 for each pass.
__global__ void __launch_bounds__(256)
ff_modulate_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, bf16* __restrict__ xn,
                   int M, int D, int L) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= M) return;
  const bf16* row = x + (size_t)m * D;
  float f[8];
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / D;
  float s2 = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(row + c), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = f[i] - mu;
      s2 = fmaf(d, d, s2);
    }
  }
  const float rs = rsqrtf(warp_sum(s2) / D + LN_EPS);
  const size_t b = (size_t)(m / L) * D;
  for (int c = lane * 8; c < D; c += 256) {
    float sc[8], sh[8];
    unpack8(*reinterpret_cast<const uint4*>(row + c), f);
    load8(scale + b + c, sc);
    load8(shift + b + c, sh);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __fadd_rn(__fmul_rn(__fmul_rn(f[i] - mu, rs), sc[i] + 1.f), sh[i]);
    *reinterpret_cast<uint4*>(xn + (size_t)m * D + c) = pack8(f);
  }
}

// ---- the GEMM epilogues --------------------------------------------------------

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// 8 consecutive fp32 sums y of row m, columns n..n+7, through MODE.
template <int MODE>
struct ff_epi {
  bf16* out;          // (M, N) bf16
  const bf16* x;      // K2_DOWN: the residual, (M, N)
  const float* gate;  // K2_DOWN: (M / L, N)
  float* acc32;       // T4_DOWN: the fp32 sum over chunks, (M, N)
  int M, N, K, L;
  int first, last;    // T4_DOWN: this is the first / last chunk

  __device__ __forceinline__ void operator()(int m, int n, float (&y)[8]) const {
    const size_t at = (size_t)m * N + n;
    if (MODE == K2_UP || MODE == K8_UP) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = gelu_erf(y[i]);
    } else if (MODE == K2_DOWN) {
      float xr[8], gt[8];
      unpack8(*reinterpret_cast<const uint4*>(x + at), xr);
      load8(gate + (size_t)(m / L) * N + n, gt);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(xr[i], __fmul_rn(gt[i], y[i]));
    } else if (MODE == T4_DOWN) {
      if (!first) {
        float prev[8];
        load8(acc32 + at, prev);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] += prev[i];
      }
      if (!last) {
        store8(acc32 + at, y);
        return;
      }
    }
    *reinterpret_cast<uint4*>(out + at) = pack8(y);
  }
};

template <int MODE>
ff_epi<MODE> epi(void* out, int M, int N, int K) {
  ff_epi<MODE> e = {};
  e.out = (bf16*)out;
  e.M = M;
  e.N = N;
  e.K = K;
  e.L = 1;
  return e;
}

// C (M, N) = A (M, K; rows lda apart) . B (N, K; rows ldb apart)^T through
// MODE's epilogue. Returns 0 or the first error.
template <int MODE>
int gemm(const void* a, int lda, const void* b, int ldb, const ff_epi<MODE>& e,
         cudaStream_t stream) {
  return sm90::gemm<bf16, sm90::Coop>(a, lda, b, ldb, nullptr, e, stream);
}

int modulate(const void* x, const void* scale, const void* shift, void* xn,
             int M, int D, int L, cudaStream_t stream) {
  if (M == 0) return 0;
  ff_modulate_kernel<<<(M + 7) / 8, 256, 0, stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)shift, (bf16*)xn, M,
      D, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Every pointer 16-byte aligned (TMA and the 16-byte epilogue accesses);
// D and FF multiples of 8. Each entry returns the first CUDA error (a tensor
// map that cannot be encoded returns its CUresult).

// The modulation pass alone: x (B*L, D) bf16, scale/shift (B, D) fp32 ->
// xn (B*L, D) bf16.
extern "C" int k5_ff_modulate(const void* x, const void* scale,
                              const void* shift, void* xn, int B, int L,
                              int D, void* stream) {
  return modulate(x, scale, shift, xn, B * L, D, L, (cudaStream_t)stream);
}

// K2: x (B*L, D) bf16; scale/shift/gate (B, D) fp32; w1 (FF, D), w2 (D, FF)
// bf16; hidden (B*L, FF) bf16 scratch; out (B*L, D) bf16, which holds x^
// until the down product overwrites it.
extern "C" int k5_ff_mod(const void* x, const void* scale, const void* shift,
                         const void* gate, const void* w1, const void* w2,
                         void* hidden, void* out, int B, int L, int D, int FF,
                         void* stream) {
  const int M = B * L;
  cudaStream_t s = (cudaStream_t)stream;
  int err = modulate(x, scale, shift, out, M, D, L, s);
  if (err == 0) err = gemm(out, D, w1, D, epi<K2_UP>(hidden, M, FF, D), s);
  if (err != 0) return err;
  ff_epi<K2_DOWN> down = epi<K2_DOWN>(out, M, D, FF);
  down.x = (const bf16*)x;
  down.gate = (const float*)gate;
  down.L = L;
  return gemm(hidden, FF, w2, FF, down, s);
}

// K8 (and T3): x (M, D) bf16; w1 (FF, D), w2 (D, FF) bf16; hidden (M, FF)
// bf16 scratch; out (M, D) bf16.
extern "C" int k5_ff(const void* x, const void* w1, const void* w2,
                     void* hidden, void* out, int M, int D, int FF,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = gemm(x, D, w1, D, epi<K8_UP>(hidden, M, FF, D), s);
  if (err != 0) return err;
  return gemm(hidden, FF, w2, FF, epi<K8_DOWN>(out, M, D, FF), s);
}

// T4: as k5_ff over ff chunks of BF columns; hidden (M, BF) bf16 and acc
// (M, D) fp32 scratch. parts selects the kernels, for a timing split: 1 the
// up kernels, 2 the down kernels (T4_DOWN), 4 the down kernels as K8's (no
// fp32 accumulator: each chunk overwrites out). T4 is parts = 3.
extern "C" int k5_ff_chunked(const void* x, const void* w1, const void* w2,
                             void* hidden, void* acc, void* out, int M, int D,
                             int FF, int BF, int parts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nj = FF / BF;
  int err = 0;
  for (int j = 0; j < nj && err == 0; ++j) {
    const bf16* w1j = (const bf16*)w1 + (size_t)j * BF * D;
    const bf16* w2j = (const bf16*)w2 + (size_t)j * BF;
    if (parts & 1) err = gemm(x, D, w1j, D, epi<K8_UP>(hidden, M, BF, D), s);
    if (err == 0 && (parts & 2)) {
      ff_epi<T4_DOWN> down = epi<T4_DOWN>(out, M, D, BF);
      down.acc32 = (float*)acc;
      down.first = j == 0;
      down.last = j == nj - 1;
      err = gemm(hidden, BF, w2j, FF, down, s);
    }
    if (err == 0 && (parts & 4))
      err = gemm(hidden, BF, w2j, FF, epi<K8_DOWN>(out, M, D, BF), s);
  }
  return err;
}
