// K5 and K7: int8-QK fixed-shift attention for 64-wide heads (the DiT's
// self-attention under attn_impl "flash_int8" / "flash_int8_pipe"), and T5,
// the pass-by-pass decomposition of K5, as compile-time modes of one kernel.
//
// Replaces kandinsky5_tpu/ops/flash_pallas.py _kernel_fixed_i8 (K5, reached
// via _flash_i8_bhld), _kernel_fixed_i8_pipe (K7, via _flash_i8_pipe_bhld)
// and tools/bench_i8_decomp.py _kernel (T5). The inputs come from the
// pack_int8 pre-pass (ops/flash.py, plain PyTorch as XLA ran it): q8
// (B*H, Lq, 64) and k8 (B*H, Lk, 64) int8, a per-(b*h, key) dequant
// coefficient and ONE log2-domain shift for the call. Per score:
//   s = float(q8_i . k8_j) * coeff_j - shift   (-1e30 for a masked key)
//   p = bf16(exp2(s)),  out_i = sum_j p_ij v_j / max(sum_j p_ij, 1e-30)
// The dequant rounds twice (__fmul_rn, __fsub_rn) as the TPU kernel and the
// plain version do, p is rounded to bf16 before the PV product and the row
// sum adds the rounded p, as the TPU kernel's ones column in V does.
//
// Bound on the H100: the tensor cores, the QK half at the int8 rate (1,979
// TOP/s) and the PV half at the bf16 rate (989 TFLOP/s), and above them the
// special-function units: one exp2 per score at 16 a clock per SM. The
// pointwise pass carries more than K1's (int to float, two rounded
// operations, exp2, bf16 pack), so the design keeps everything but exp2 off
// the special-function units and overlaps the pass with the products. It is
// K1's ring (attn_ring_sm90.cuh: a TMA producer, two consumer warpgroups
// taking turns, P from registers, the normalizer summed by the tensor cores)
// with s8 QK:
//   * per 128-key tile the ring holds the int8 K rows, the bf16 V rows
//     (MN-major, 128-byte swizzle) and the tile's 128 dequant coefficients,
//     NS stages; the block's Q comes once. The grid runs query blocks
//     fastest, so neighbouring blocks share one head's K/V in L2;
//   * Q and K are int8 rows of exactly 64 bytes, read through 3-D tensor
//     maps (64, L, B*H) with the 64-byte swizzle; rows past L are
//     zero-filled and never read the next head. S = Q K^T is two wgmma
//     m64n128k32 s8 per tile (32 bytes deep each, both operands K-major in
//     shared memory) into exact s32 accumulators, whose layout is the fp32
//     one, so K1's map from S to P's A fragments holds;
//   * per score the s32 becomes a float by an integer add and an FADD
//     (|s32| <= 64 * 127^2 < 2^22, so float(x) = as_float(x + 0x4B400000) -
//     12582912 exactly), keeping the conversion (I2F) off the
//     special-function units that exp2 needs; then the two rounded
//     operations, ex2.approx, and a bf16x2 pack into the PV product's A
//     registers; keys are tested only in a tile that can hold a masked or
//     absent key (a mask, or the last tile): zero-filled K rows past Lk
//     score 0 and must be masked;
//   * the coefficients come by TMA from a 2-D map (Lk4, B*H), Lk4 = Lk
//     rounded up to 4 (a TMA row stride is a multiple of 16 bytes; the
//     wrapper pads), 512 bytes a stage, and each thread reads its 32 from
//     shared memory (LDS).
//   K5 and K7 are the ring's two schedules of one body: K7 the lag-1 one
//   (P_j formed under PV_{j-1}), K5 the one that waits for both. The
//   per-tile functions and the order of the accumulations are the same, so
//   K7 equals K5 bit for bit (the JAX package's own contract for the pair).
//   T5's modes change only what a tile does in K5's body: full (K5 without
//   the final normalization), no_exp2 (p = bf16(s)), raw_pv (p =
//   bf16(float(s32))), qk_only (no PV: a thread adds columns c and c + 64
//   of each tile's s32 into output lane c, i.e. the sum over 64-key groups).
// The TPU kernel's 128-lane padding, transposed K and the ones column in V
// serve the TPU's layout and are not carried.
#include "attn_ring_sm90.cuh"

namespace {
using namespace k5;
using namespace k5::attn;

constexpr int NS = 4;             // ring stages
constexpr uint32_t K_TILE = BN * D;           // int8 K tile
constexpr uint32_t C_TILE = BN * 4;           // fp32 coefficients of a tile
constexpr uint32_t STAGE = V_TILE + K_TILE;   // V first: both 1024-aligned
constexpr uint32_t Q_BYTES = BM * D;
constexpr uint32_t SMEM = 1024 + NS * STAGE + V_TILE + Q_BYTES + NS * C_TILE;
constexpr float NEG = -1e30f;

enum Mode { K5_NORM = 0, T5_FULL = 1, T5_NO_EXP2 = 2, T5_RAW_PV = 3, T5_QK_ONLY = 4 };

// float(x) for |x| < 2^22, exact, without I2F: 0x4B400000 is 1.5 * 2^23.
__device__ __forceinline__ float s32_to_f(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
}

// Weights of one 64 x BN score tile as the bf16 A fragments of the PV
// product. s[4 n8 + i] is (row g + 8 (i / 2), key 8 n8 + 2 t + i % 2) of this
// warp's 16 rows; A register 4 kk + r of k-step kk holds (row g, keys 16 kk +
// 2t..) for r = 0, row g + 8 for r = 1, and keys + 8 for r = 2, 3 — the C
// fragments of n8 = 2 kk and 2 kk + 1 in order. cs: the tile's coefficients.
template <int MODE, bool EDGE>
__device__ __forceinline__ void weights(const int (&s)[64], uint32_t (&p)[32],
                                        const float* cs, float shift2, int kv0,
                                        int Lk, const uint8_t* mrow, int t) {
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8) {
    const int col = 8 * n8 + 2 * t;
    float x0 = s32_to_f(s[4 * n8]), x1 = s32_to_f(s[4 * n8 + 1]),
          x2 = s32_to_f(s[4 * n8 + 2]), x3 = s32_to_f(s[4 * n8 + 3]);
    if (MODE != T5_RAW_PV) {
      const float2 c = *reinterpret_cast<const float2*>(cs + col);
      x0 = __fsub_rn(__fmul_rn(x0, c.x), shift2);
      x1 = __fsub_rn(__fmul_rn(x1, c.y), shift2);
      x2 = __fsub_rn(__fmul_rn(x2, c.x), shift2);
      x3 = __fsub_rn(__fmul_rn(x3, c.y), shift2);
      if (EDGE) {
        const int k0 = kv0 + col;
        const bool v0 = k0 < Lk && (mrow == nullptr || mrow[k0] != 0);
        const bool v1 = k0 + 1 < Lk && (mrow == nullptr || mrow[k0 + 1] != 0);
        if (!v0) x0 = x2 = NEG;
        if (!v1) x1 = x3 = NEG;
      }
      if (MODE == K5_NORM || MODE == T5_FULL) {
        x0 = ex2(x0);
        x1 = ex2(x1);
        x2 = ex2(x2);
        x3 = ex2(x3);
      }
    }
    const int r = 4 * (n8 >> 1) + 2 * (n8 & 1);
    p[r] = pack_f2(x0, x1);
    p[r + 1] = pack_f2(x2, x3);
  }
}

// T5's qk_only: output lane c (< 64) adds tile columns c and c + 64.
__device__ __forceinline__ void add_scores(const int (&s)[64], float (&o)[36]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] += s32_to_f(s[i]);
    o[i] += s32_to_f(s[i + 32]);
  }
}

// MODE: K5_NORM or a T5 mode; MASK: a key mask is given; LAG: K7's schedule.
template <int MODE, bool MASK, bool LAG>
__global__ void __launch_bounds__(THREADS, 1)
flash_int8_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tc,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ shift, bf16* __restrict__ out,
                  int Lq, int Lk, int H) {
  static_assert(!LAG || MODE == K5_NORM, "the lag-1 schedule is K7's alone");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], qbar;
  uint8_t* ring = align1024(smem_raw);
  uint8_t* ones = ring + NS * STAGE;
  uint8_t* Qs = ones + V_TILE;
  float* coef = reinterpret_cast<float*>(Qs + Q_BYTES);

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int tid = threadIdx.x;
  const int n_tiles = (Lk + BN - 1) / BN;
  ring_init(full, empty, qbar, ones);

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    regs_dealloc<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tc);
      ring_produce(
          full, empty, qbar, Q_BYTES, STAGE + C_TILE, n_tiles,
          [&](uint64_t* bar) { tma_load_3d(Qs, &tq, bar, 0, qb * BM, bh); },
          [&](int j, int s, uint64_t* bar) {
            uint8_t* st = ring + s * STAGE;
            tma_load_3d(st + V_TILE, &tk, bar, 0, j * BN, bh);
            tma_load_4d(st, &tv, bar, 0, h, j * BN, b);
            tma_load_2d(coef + s * BN, &tc, bar, j * BN, bh);
          });
    }
    return;
  }

  // ---- consumers ----
  regs_alloc<240>();
  const int w = wg - 1;              // consumer warpgroup 0..NWG-1
  const int t = tid & 3;
  const float shift2 = shift[0];
  const uint8_t* mrow = MASK ? mask + (size_t)b * Lk : nullptr;

  const uint64_t dq = smem_desc(smem_u32(Qs + w * 64 * D), 16, 512, 2);
  int sacc[64];
  float o[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;

  ring_consume<NS, LAG, MODE != T5_QK_ONLY>(
      sacc, o, full, empty, qbar, w, n_tiles,
      [&](int s) {
        const uint64_t dk =
            smem_desc(smem_u32(ring + s * STAGE + V_TILE), 16, 512, 2);
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          wgmma_m64n128k32_s8_ss(sacc, dq + 2 * kk, dk + 2 * kk, kk);
      },
      [&](int s) {
        uint8_t* vs = ring + s * STAGE;
        return smem_desc(smem_u32(vs), (uint32_t)(ones - vs), 1024, 1);
      },
      // what tile j does once S_j is in sacc: its weights into pw, or
      // (qk_only) its scores added into o
      [&](int j, uint32_t (&pw)[32]) {
        if constexpr (MODE == T5_QK_ONLY) {
          add_scores(sacc, o);
        } else {
          const int kv0 = j * BN;
          const float* cs = coef + (j % NS) * BN;
          if (MASK || kv0 + BN > Lk)
            weights<MODE, true>(sacc, pw, cs, shift2, kv0, Lk, mrow, t);
          else
            weights<MODE, false>(sacc, pw, cs, shift2, kv0, Lk, mrow, t);
        }
      });
  // K5 divides by its normalizer; T5's modes store O as it is
  store_rows<MODE == K5_NORM>(o, out, b, h, qb, w, Lq, H);
}

// Tensor map of the (B*H, Lk4) fp32 coefficients, Lk4 = Lk rounded up to 4,
// as 2-D (Lk4, B*H) read in boxes of one tile's BN keys; keys past Lk4 are
// zero-filled. Returns 0 or a nonzero CUresult.
int coeff_map(CUtensorMap* map, const void* coeff, int BH, int Lk) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t lk4 = (cuuint64_t)((Lk + 3) / 4 * 4);
  const cuuint64_t dims[2] = {lk4, (cuuint64_t)BH};
  const cuuint64_t strides[1] = {lk4 * 4};
  const cuuint32_t box[2] = {BN, 1};
  const cuuint32_t elem[2] = {1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(coeff),
                 dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int MODE, bool MASK, bool LAG>
int launch(const void* q8, const void* k8, const void* v, const void* coeff,
           const void* mask, const void* shift, void* out, int B, int Lq, int Lk,
           int H, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tc;
  int err = kmajor_sw64_map(&tq, q8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, Lq,
                            B * H, D, BM);
  if (err == 0)
    err = kmajor_sw64_map(&tk, k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, D, Lk,
                          B * H, D, BN);
  if (err == 0) err = bhld_map(&tv, v, B, Lk, H, BN);
  if (err == 0) err = coeff_map(&tc, coeff, B * H, Lk);
  if (err != 0) return err;
  static bool ready[64] = {};
  err = smem_limit_once(ready, (const void*)flash_int8_kernel<MODE, MASK, LAG>,
                        SMEM);
  if (err != 0) return err;
  dim3 grid((Lq + BM - 1) / BM, H, B);
  flash_int8_kernel<MODE, MASK, LAG><<<grid, THREADS, SMEM, stream>>>(
      tq, tk, tv, tc, (const uint8_t*)mask, (const float*)shift, (bf16*)out,
      Lq, Lk, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q8 (B*H, Lq, 64), k8 (B*H, Lk, 64) int8; v and out (B, L, H, 64) bf16;
// coeff (B*H, Lk4) fp32, Lk4 = Lk rounded up to 4 (the columns past Lk are
// never used); mask (B, Lk) uint8 or null; shift (1,) fp32. q8, k8, v and
// coeff 16-byte aligned. Returns the first CUDA error (a tensor map that
// cannot be encoded returns its CUresult).
extern "C" int k5_flash_int8(const void* q8, const void* k8, const void* v,
                             const void* coeff, const void* mask,
                             const void* shift, void* out, int B, int Lq,
                             int Lk, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return mask != nullptr
             ? launch<K5_NORM, true, false>(q8, k8, v, coeff, mask, shift, out,
                                            B, Lq, Lk, H, s)
             : launch<K5_NORM, false, false>(q8, k8, v, coeff, mask, shift, out,
                                             B, Lq, Lk, H, s);
}

extern "C" int k5_flash_int8_pipe(const void* q8, const void* k8, const void* v,
                                  const void* coeff, const void* mask,
                                  const void* shift, void* out, int B, int Lq,
                                  int Lk, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return mask != nullptr
             ? launch<K5_NORM, true, true>(q8, k8, v, coeff, mask, shift, out,
                                           B, Lq, Lk, H, s)
             : launch<K5_NORM, false, true>(q8, k8, v, coeff, mask, shift, out,
                                            B, Lq, Lk, H, s);
}

// T5: mode 1 full, 2 no_exp2, 3 raw_pv, 4 qk_only; no mask.
extern "C" int k5_i8_decomp(const void* q8, const void* k8, const void* v,
                            const void* coeff, const void* shift, void* out,
                            int B, int Lq, int Lk, int H, int mode,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case T5_FULL:
      return launch<T5_FULL, false, false>(q8, k8, v, coeff, nullptr, shift, out,
                                           B, Lq, Lk, H, s);
    case T5_NO_EXP2:
      return launch<T5_NO_EXP2, false, false>(q8, k8, v, coeff, nullptr, shift,
                                              out, B, Lq, Lk, H, s);
    case T5_RAW_PV:
      return launch<T5_RAW_PV, false, false>(q8, k8, v, coeff, nullptr, shift,
                                             out, B, Lq, Lk, H, s);
    case T5_QK_ONLY:
      return launch<T5_QK_ONLY, false, false>(q8, k8, v, coeff, nullptr, shift,
                                              out, B, Lq, Lk, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
