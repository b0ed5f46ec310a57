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
//   ff_gemm<K2_UP>:   hidden = bf16(gelu_erf(x^ . W1^T));
//   ff_gemm<K2_DOWN>: out = bf16(x + gate[b(m)] * (hidden . W2^T)), with the
//       batch item b(m) = m / L taken per row (a row tile may straddle two).
// GELU uses CUDA's erff (Mosaic lacked erf; the TPU kernel used an A&S
// polynomial).
//
// K8: the plain fused FF, y = bf16(sum over ff of bf16(gelu_erf(x . W1^T))
// . W2^T), the second product summed in fp32 (no LN, modulation, gate,
// residual or biases). Replaces kandinsky5_tpu/ops/ff_pallas.py _ff_kernel
// (reached via fused_ff), which the tensor-parallel DiT runs on each rank's
// W1 rows and W2 columns: ff_gemm<K8_UP> then ff_gemm<K8_DOWN>, split as K2
// and for the same reason. T3 (tools/bench_pallas_gemm.py _ff_kernel) is
// K8's entry. T4 (tools/bench_pallas_gemm.py _ff_tiled_kernel) keeps the
// TPU kernel's ff-chunk schedule: per chunk of bf columns, K8's up product
// makes the (rows, bf) hidden and ff_gemm<T4_DOWN> adds its down product to
// an fp32 accumulator in device memory (the TPU kernel's VMEM scratch
// between grid steps); the last chunk writes the bf16 output.
//
// Bound on the H100: the tensor cores (2 * rows * 1792 * 7168 MACs per
// product, 2.47 ms at 47,616 rows). All five products are one GEMM
// mainloop, C = A . B^T with A (M, K) and B (N, K) both K-contiguous (the
// torch (out, in) weight layout), and differ only in their epilogues:
//   * persistent blocks, one per SM, walk 128 x 256 output tiles row band
//     by row band (a band's tiles run side by side, so its A rows and the
//     weight panel are read from L2);
//   * one producer thread feeds 64-deep k steps by TMA (128-byte swizzle;
//     A 128 x 64, B 256 x 64, 48 KB a stage) into a 4-stage ring with full
//     and empty mbarriers per stage; a ragged last row tile and the columns
//     past N are zero-filled by TMA and masked at the store;
//   * two consumer warpgroups, 64 rows each, run wgmma m64n256k16 with both
//     operands in shared memory (half the shared-memory reads of A per MAC
//     of a 128-wide tile) and fp32 accumulators in registers, one k step in
//     flight; setmaxnreg moves registers from the producer to them;
//   * the epilogue works on the accumulators in registers: a transpose
//     within each quad of lanes gives every lane 8 consecutive columns of
//     its row, so the residual, the gate and the fp32 accumulator are read,
//     and the outputs written, 16 bytes at a time.
#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr float LN_EPS = 1e-5f;
constexpr int BM = 128, BN = 256, BK = 64;  // output tile, k step
constexpr int NS = 4;                       // ring stages
constexpr int THREADS = 384;                // producer + 2 consumer warpgroups
constexpr uint32_t A_BYTES = BM * BK * 2;
constexpr uint32_t B_BYTES = BN * BK * 2;
constexpr uint32_t STAGE = A_BYTES + B_BYTES;
constexpr uint32_t SMEM = 1024 + NS * STAGE;

// the epilogues (their numbers are the kernels' names in a profile: 0-1 are
// K2's, 2-4 K8's and T4's)
enum { K2_UP = 0, K2_DOWN = 1, K8_UP = 2, K8_DOWN = 3, T4_DOWN = 4 };

struct Epi {
  bf16* out;          // (M, N) bf16
  const bf16* x;      // K2_DOWN: the residual, (M, N)
  const float* gate;  // K2_DOWN: (M / L, N)
  float* acc32;       // T4_DOWN: the fp32 sum over chunks, (M, N)
  int M, N, K, L;
  int first, last;    // T4_DOWN: this is the first / last chunk
};

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

// ---- the GEMM ----------------------------------------------------------------

// Lanes t of a quad each hold, for one row, the column pairs 2t, 2t+1 of four
// adjacent 8-column groups (v[j] of group j). Afterwards lane t holds group
// t whole: v[s] = columns 2s, 2s+1 of it. Two exchange rounds (lane bits 0,
// then 1), each swapping the two slots whose bit differs from the lane's.
__device__ __forceinline__ void quad_transpose(float2 (&v)[4], int t) {
  const bool b0 = t & 1, b1 = t & 2;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float2 snd = b0 ? v[2 * k] : v[2 * k + 1];
    const float2 rcv = make_float2(__shfl_xor_sync(0xffffffffu, snd.x, 1),
                                   __shfl_xor_sync(0xffffffffu, snd.y, 1));
    if (b0) v[2 * k] = rcv; else v[2 * k + 1] = rcv;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float2 snd = b1 ? v[k] : v[k + 2];
    const float2 rcv = make_float2(__shfl_xor_sync(0xffffffffu, snd.x, 2),
                                   __shfl_xor_sync(0xffffffffu, snd.y, 2));
    if (b1) v[k] = rcv; else v[k + 2] = rcv;
  }
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
}

// One warp's 16 rows of a 64 x 256 accumulator (wgmma's layout: d[4 j + i]
// is row g + 8 (i / 2), column 8 j + 2 t + i % 2) through MODE's epilogue.
// r0 is the row of g, n0 the tile's first column.
template <int MODE>
__device__ __forceinline__ void epilogue(const float (&d)[128], const Epi& e,
                                         int r0, int n0, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r0 + 8 * h;
    const bool row_ok = m < e.M;
    const size_t row = (size_t)m * e.N;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      float2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = make_float2(d[4 * (4 * q + j) + 2 * h], d[4 * (4 * q + j) + 2 * h + 1]);
      quad_transpose(v, t);
      const int n = n0 + 32 * q + 8 * t;
      if (!row_ok || n >= e.N) continue;
      float y[8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        y[2 * s] = v[s].x;
        y[2 * s + 1] = v[s].y;
      }
      if (MODE == K2_UP || MODE == K8_UP) {
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = gelu_erf(y[i]);
      } else if (MODE == K2_DOWN) {
        float xr[8], gt[8];
        unpack8(*reinterpret_cast<const uint4*>(e.x + row + n), xr);
        load8(e.gate + (size_t)(m / e.L) * e.N + n, gt);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(xr[i], __fmul_rn(gt[i], y[i]));
      } else if (MODE == T4_DOWN) {
        float* a = e.acc32 + row + n;
        if (!e.first) {
          float prev[8];
          load8(a, prev);
#pragma unroll
          for (int i = 0; i < 8; ++i) y[i] += prev[i];
        }
        if (!e.last) {
          store8(a, y);
          continue;
        }
      }
      *reinterpret_cast<uint4*>(e.out + row + n) = pack8(y);
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
ff_gemm(const __grid_constant__ CUtensorMap ta,
        const __grid_constant__ CUtensorMap tb, const Epi e) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int n_n = (e.N + BN - 1) / BN;
  const int n_tiles = ((e.M + BM - 1) / BM) * n_n;
  const int nk = (e.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full across the tiles ----
    regs_dealloc<24>();
    if (tid == 0) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_n) * BM, n0 = (tile % n_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % NS;
          mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
          uint8_t* st = ring + s * STAGE;
          mbar_expect_tx(&full[s], STAGE);
          tma_load_2d(st, &ta, &full[s], kt * BK, m0);
          tma_load_2d(st + A_BYTES, &tb, &full[s], kt * BK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows 64 w .. 64 w + 63 of each tile ----
  regs_alloc<240>();
  const int w = tid / 128 - 1, tw = tid & 127;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_n) * BM, n0 = (tile % n_n) * BN;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % NS;
      mbar_wait(&full[s], (it / NS) & 1);
      uint8_t* st = ring + s * STAGE;
      const uint64_t da = smem_desc(smem_u32(st + w * 64 * 128), 16, 1024, 1);
      const uint64_t db = smem_desc(smem_u32(st + A_BYTES), 16, 1024, 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16_ss(acc, da + 2 * kk, db + 2 * kk, kt | kk);
      wgmma_commit();
      // the previous k step's products are done: free its stage
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % NS]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % NS]);
    epilogue<MODE>(acc, e, m0 + w * 64 + warp * 16 + g, n0, t);
  }
}

// SM count and the shared-memory attribute, once per device and instance
template <int MODE>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const Epi& e,
                cudaStream_t stream) {
  static bool ready[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ff_gemm<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const int tiles = ((e.M + BM - 1) / BM) * ((e.N + BN - 1) / BN);
  if (tiles == 0) return 0;
  ff_gemm<MODE><<<tiles < sms[dev] ? tiles : sms[dev], THREADS, SMEM, stream>>>(
      ta, tb, e);
  return (int)cudaGetLastError();
}

// C (M, N) = A (M, K; rows lda apart) . B (N, K; rows ldb apart)^T through
// MODE's epilogue. Returns 0 or the first error.
template <int MODE>
int gemm(const void* a, int lda, const void* b, int ldb, Epi e,
         cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = kmajor_sw128_map(&ta, a, e.K, e.M, lda, BM);
  if (err == 0) err = kmajor_sw128_map(&tb, b, e.K, e.N, ldb, BN);
  if (err != 0) return err;
  return launch_gemm<MODE>(ta, tb, e, stream);
}

Epi epi(void* out, int M, int N, int K) {
  Epi e = {};
  e.out = (bf16*)out;
  e.M = M;
  e.N = N;
  e.K = K;
  e.L = 1;
  return e;
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
  if (err == 0) err = gemm<K2_UP>(out, D, w1, D, epi(hidden, M, FF, D), s);
  if (err != 0) return err;
  Epi down = epi(out, M, D, FF);
  down.x = (const bf16*)x;
  down.gate = (const float*)gate;
  down.L = L;
  return gemm<K2_DOWN>(hidden, FF, w2, FF, down, s);
}

// K8 (and T3): x (M, D) bf16; w1 (FF, D), w2 (D, FF) bf16; hidden (M, FF)
// bf16 scratch; out (M, D) bf16.
extern "C" int k5_ff(const void* x, const void* w1, const void* w2,
                     void* hidden, void* out, int M, int D, int FF,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = gemm<K8_UP>(x, D, w1, D, epi(hidden, M, FF, D), s);
  if (err != 0) return err;
  return gemm<K8_DOWN>(hidden, FF, w2, FF, epi(out, M, D, FF), s);
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
    if (parts & 1) err = gemm<K8_UP>(x, D, w1j, D, epi(hidden, M, BF, D), s);
    if (err == 0 && (parts & 2)) {
      Epi down = epi(out, M, D, BF);
      down.acc32 = (float*)acc;
      down.first = j == 0;
      down.last = j == nj - 1;
      err = gemm<T4_DOWN>(hidden, BF, w2j, FF, down, s);
    }
    if (err == 0 && (parts & 4))
      err = gemm<K8_DOWN>(hidden, BF, w2j, FF, epi(out, M, D, BF), s);
  }
  return err;
}
