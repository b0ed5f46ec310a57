// K1: fixed-shift softmax attention for 64-wide heads (the DiT's text and
// visual self-attention).
//
// Replaces kandinsky5_tpu/ops/flash_pallas.py _kernel_fixed (reached via
// _flash_fixed_bhld and flash_attention(fixed_shift=True)). It computes
//   out = sum_j p_ij v_j / max(sum_j p_ij, 1e-30),
//   p_ij = exp2(q_i.k_j * log2(e)/sqrt(d) - shift * log2(e))
// with ONE scalar shift for the whole call (max|q| * max|k| / sqrt(d), made
// by the wrapper), so no running max and no rescale pass exist. Masked keys
// (kv_mask == 0, or past Lk) get p = 0. p is rounded to bf16 before the PV
// product and the row sum adds the rounded values, as the TPU kernel's ones
// column in V does.
//
// Bound on the H100: two floors of about the same size, the tensor cores
// (4 L^2 d H flops) and the special-function units' exp2 (L^2 H of them at
// 16 per clock per SM); at d = 64 there are only 128 MACs per exp2. The
// design overlaps the two:
//   * a warp-specialised block: one producer warp issues TMA loads (the
//     block's 128-row Q tile once, then K and V tiles of 128 keys into a ring
//     of NS stages, 128-byte swizzled, completion on mbarriers); two consumer
//     warpgroups own 64 query rows each and free a stage through its "empty"
//     mbarrier once both have read it; setmaxnreg moves registers from the
//     producer to the consumers;
//   * S = Q K^T is one wgmma m64n128k16 per 16 of d, both operands from
//     shared memory; S stays in registers (fp32);
//   * per score one FFMA and one ex2.approx, then cvt to bf16x2 straight into
//     the A registers of the PV wgmma (the C fragment of S is the A fragment
//     of P), so P never touches shared memory; only a tile that can hold a
//     masked or out-of-range key (MASK, or the last tile) tests keys;
//   * O += P V is wgmma m64n72k16 with V read MN-major from shared memory:
//     the 8 columns past d read one constant strip of ones after the ring
//     (each stage's descriptor puts it at its leading byte offset), so the
//     tensor cores also sum the rounded p in fp32 (the normalizer) and the
//     pointwise path carries no unpack or add;
//   * the two consumer warpgroups take turns issuing their products (named
//     barriers): one warpgroup's exp2 pass runs under the other's wgmma; within
//     a warpgroup the next tile's Q K^T is issued before this tile's
//     pointwise pass (wgmma.wait_group 1).
// Layout is the public (B, L, H, 64): TMA reads it through 4-D tensor maps
// (64, H, L, B), so a tile that runs past L is zero-filled and never reads the
// next batch's rows; zero-filled keys are masked explicitly.
#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr int D = 64;
constexpr int NWG = 2;            // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * NWG;      // query rows per block
constexpr int BN = 128;           // keys per tile
constexpr int NS = 3;             // ring stages
constexpr int THREADS = 128 * (NWG + 1);
constexpr uint32_t TILE = BN * 128;           // one K or V tile, bytes
constexpr uint32_t STAGE = 2 * TILE;          // K, V
constexpr uint32_t Q_BYTES = BM * 128;
constexpr uint32_t SMEM = 1024 + Q_BYTES + NS * STAGE + TILE;  // + ones
constexpr float LOG2E = 1.4426950408889634f;

// Weights of one 64 x BN score tile: p = exp2(s c - shift2) as the bf16 A
// fragments of the PV product. s[4 n8 + i] is (row g + 8 (i / 2), key 8 n8 +
// 2 t + i % 2) of this warp's 16 rows; A register 4 kk + r of k-step kk holds
// (row g, keys 16 kk + 2t..) for r = 0, row g + 8 for r = 1, and keys + 8 for
// r = 2, 3 — the C fragments of n8 = 2 kk and 2 kk + 1 in order.
template <bool EDGE>
__device__ __forceinline__ void weights(const float (&s)[64], uint32_t (&p)[32],
                                        float c, float nshift, int kv0, int Lk,
                                        const uint8_t* mrow, int t) {
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8) {
    float x0 = s[4 * n8], x1 = s[4 * n8 + 1], x2 = s[4 * n8 + 2],
          x3 = s[4 * n8 + 3];
    if (EDGE) {
      const int col = kv0 + 8 * n8 + 2 * t;
      const bool v0 = col < Lk && (mrow == nullptr || mrow[col] != 0);
      const bool v1 = col + 1 < Lk && (mrow == nullptr || mrow[col + 1] != 0);
      if (!v0) x0 = x2 = -INFINITY;
      if (!v1) x1 = x3 = -INFINITY;
    }
    const int r = 4 * (n8 >> 1) + 2 * (n8 & 1);
    p[r] = pack_f2(ex2(fmaf(x0, c, nshift)), ex2(fmaf(x1, c, nshift)));
    p[r + 1] = pack_f2(ex2(fmaf(x2, c, nshift)), ex2(fmaf(x3, c, nshift)));
  }
}

__device__ __forceinline__ void qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
}

__device__ __forceinline__ void pv(float (&o)[36], const uint32_t (&p)[32],
                                   uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_m64n72k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                       p[4 * kk + 3], dv + 128 * kk);
}

template <bool MASK>
__global__ void __launch_bounds__(THREADS, 1)
flash_fixed_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ shift, bf16* __restrict__ out,
                   int Lq, int Lk, int H) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], qbar;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* ring = smem + Q_BYTES;
  uint8_t* ones = ring + NS * STAGE;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_tiles = (Lk + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
  // the ones strip: the 8 columns of V past d, whatever the swizzle
  for (int i = tid; i < (int)(TILE / 16); i += THREADS)
    reinterpret_cast<uint4*>(ones)[i] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_proxy_async();
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    regs_dealloc<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(&qbar, Q_BYTES);
      tma_load_4d(Qs, &tq, &qbar, 0, h, qb * BM, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        mbar_wait(&empty[s], ((j / NS) & 1) ^ 1);
        uint8_t* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], 2 * TILE);
        tma_load_4d(st, &tk, &full[s], 0, h, j * BN, b);
        tma_load_4d(st + TILE, &tv, &full[s], 0, h, j * BN, b);
      }
    }
    return;
  }

  // ---- consumers ----
  regs_alloc<240>();
  const int w = wg - 1;              // consumer warpgroup 0..NWG-1
  const int tw = tid - 128 * wg;     // thread in the warpgroup
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float c = LOG2E * 0.125f;    // log2(e) / sqrt(64)
  const float nshift = -shift[0] * LOG2E;
  const uint8_t* mrow = MASK ? mask + (size_t)b * Lk : nullptr;
  const int turn = 1 + w, next_turn = 1 + (w + 1) % NWG;

  const uint64_t dq = smem_desc(smem_u32(Qs + w * 64 * 128), 16, 1024, 1);
  auto dk = [&](int s) { return smem_desc(smem_u32(ring + s * STAGE), 16, 1024, 1); };
  auto dv = [&](int s) {
    uint8_t* vs = ring + s * STAGE + TILE;
    return smem_desc(smem_u32(vs), (uint32_t)(ones - vs), 1024, 1);
  };

  float sacc[64];
  float o[36];
  uint32_t p[32], pn[32];
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;

  // the warpgroups issue their products in turn, warpgroup 0 first
  if (w == NWG - 1) named_arrive<256>(1);
  mbar_wait(&qbar, 0);

  // the weights of tile j into pw, from S_j in sacc
  auto tile_weights = [&](int j, uint32_t (&pw)[32]) {
    const int kv0 = j * BN;
    if (MASK || kv0 + BN > Lk)
      weights<true>(sacc, pw, c, nshift, kv0, Lk, mrow, t);
    else
      weights<false>(sacc, pw, c, nshift, kv0, Lk, mrow, t);
  };
  // one turn: issue S_j = Q K_j^T and O += P_{j-1} V_{j-1} (from pin), then
  // the weights of tile j (into pout) under the PV product
  auto step = [&](int j, uint32_t (&pin)[32], uint32_t (&pout)[32]) {
    const int s = j % NS, sp = (j - 1) % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    named_sync<256>(turn);
    fence_regs(sacc);
    fence_regs(pin);
    fence_regs(o);
    wgmma_fence();
    qk(sacc, dq, dk(s));
    wgmma_commit();
    pv(o, pin, dv(sp));
    wgmma_commit();
    named_arrive<256>(next_turn);
    wgmma_wait<1>();
    fence_regs(sacc);
    tile_weights(j, pout);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pin);
    mbar_arrive(&empty[sp]);
  };
  // the last turn: O += P_{n-1} V_{n-1}
  auto last = [&](uint32_t (&pin)[32]) {
    const int sl = (n_tiles - 1) % NS;
    named_sync<256>(turn);
    fence_regs(pin);
    fence_regs(o);
    wgmma_fence();
    pv(o, pin, dv(sl));
    wgmma_commit();
    named_arrive<256>(next_turn);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pin);
    mbar_arrive(&empty[sl]);
  };

  // first turn: S_0, then its weights
  mbar_wait(&full[0], 0);
  named_sync<256>(turn);
  wgmma_fence();
  qk(sacc, dq, dk(0));
  wgmma_commit();
  named_arrive<256>(next_turn);
  wgmma_wait<0>();
  fence_regs(sacc);
  tile_weights(0, p);
  // two tiles per pass, so the weights alternate between p and pn without
  // copies (a copy would put moves into the PV products' pipeline stage)
  int j = 1;
  for (; j + 1 < n_tiles; j += 2) {
    step(j, p, pn);
    step(j + 1, pn, p);
  }
  if (j < n_tiles) {
    step(j, p, pn);
    last(pn);
  } else {
    last(p);
  }
  if (w == 0) named_sync<256>(1);  // the last warpgroup's final turn signal

  // epilogue: columns 64..71 of O all hold the row sum of the rounded p
  const float i0 = 1.f / fmaxf(o[32], 1e-30f), i1 = 1.f / fmaxf(o[34], 1e-30f);
  const int r0 = qb * BM + w * 64 + warp * 16 + g, r1 = r0 + 8;
  const size_t rs = (size_t)H * D;
  bf16* ob = out + ((size_t)b * Lq * H + h) * D;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = n8 * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + col) =
          pack_f2(o[4 * n8] * i0, o[4 * n8 + 1] * i0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + col) =
          pack_f2(o[4 * n8 + 2] * i1, o[4 * n8 + 3] * i1);
  }
}

template <bool MASK>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const void* mask, const void* shift, void* out, int B, int Lq, int Lk,
           int H, cudaStream_t stream) {
  // the attribute is set per device, so once for each device used
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(flash_fixed_kernel<MASK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  dim3 grid((Lq + BM - 1) / BM, H, B);
  flash_fixed_kernel<MASK><<<grid, THREADS, SMEM, stream>>>(
      tq, tk, tv, (const uint8_t*)mask, (const float*)shift, (bf16*)out, Lq, Lk, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Lq, H, 64), k/v (B, Lk, H, 64) bf16, 16-byte aligned; mask (B, Lk)
// uint8 or null; shift (1,) fp32; out (B, Lq, H, 64) bf16. Returns the first
// CUDA error (a tensor map that cannot be encoded returns its CUresult).
extern "C" int k5_flash_fixed(const void* q, const void* k, const void* v,
                              const void* mask, const void* shift, void* out,
                              int B, int Lq, int Lk, int H, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = bhld_map(&tq, q, B, Lq, H, BM);
  if (err == 0) err = bhld_map(&tk, k, B, Lk, H, BN);
  if (err == 0) err = bhld_map(&tv, v, B, Lk, H, BN);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return mask != nullptr
             ? launch<true>(tq, tk, tv, mask, shift, out, B, Lq, Lk, H, st)
             : launch<false>(tq, tk, tv, mask, shift, out, B, Lq, Lk, H, st);
}
