// K4: online-softmax attention with key mask and monotone segment ids, for
// 512-wide heads (the VAE mid block's frame-causal attention, with the
// streaming decoder's carried past-frame K/V).
//
// Replaces kandinsky5_tpu/ops/flash_pallas.py _kernel_online (reached via
// _flash_bhld and flash_attention(fixed_shift=False, q_ids, kv_ids)). Per
// query row i: s_ij = q_i.k_j / sqrt(d), set to -1e30 where kv_mask[j] == 0
// or q_id[i] < kv_id[j]; running max m, running sum l of the unrounded p,
// acc rescaled by exp(m_old - m_new), p rounded to bf16 for PV; out = acc /
// max(l, 1e-30). The -1e30 fill (not -inf) keeps a row with no allowed key
// NaN-free: its output is the mean of V over the tiles the block visits.
//
// Which tiles a block visits (ops/flash.py online_plan builds the tables):
// the first n_live 32-key tiles, n_live from the TPU kernel's liveness rule
// (a tile is dead where the block's largest q id is below its smallest kv
// id; ids are non-decreasing, so the live tiles are a prefix). Where every
// row of the block has an allowed key, a tile whose keys kv_mask removes
// entirely is skipped too (its p would be exactly 0, or be wiped by an
// alpha of exactly 0); ``nxt`` gives the next tile holding a valid key.
//
// Bound on the H100: the tensor cores (4 d flops per allowed (q, k) pair)
// and the bytes that feed them: each 32-key tile is 64 KB of K and V for
// 64 x 32 x 512 x 4 flops, 64 flops a byte, below the card's ridge of ~295,
// so the design relies on L2 to serve each tile to the blocks that read it
// at about the same time: blocks run longest first (the grid's x index is
// reversed, since work grows with the q ids) and all of them walk their
// tiles upward, so the ~132 resident blocks stream the same frames.
// Design, a warp-specialised block of 64 query rows:
//   * one producer thread loads Q (64 x 512, as 8 TMA boxes of 64 columns,
//     128-byte swizzled) once, then K and V tiles of 32 keys (8 boxes each)
//     and the tile's 32 key codes (kv id where valid, INT_MAX where not;
//     one bulk copy) into a 2-stage ring on mbarriers;
//   * the fp32 output (64 x 512) does not fit one warpgroup's registers, so
//     two consumer warpgroups each own 256 of the 512 channels: PV is
//     wgmma m64n256k16 with P from registers and V read MN-major from the
//     stage, 128 fp32 accumulators a thread;
//   * S = Q K^T is computed once per tile: each warpgroup forms the partial
//     S over its 256 channels of d (16 wgmma m64n32k16, both operands from
//     shared memory), the partials meet in shared memory, and both
//     warpgroups add them in the same commutative order, so they hold the
//     same S bit for bit and run the same online-softmax update (the same
//     m, l and P) with no further exchange;
//   * the output rescale is skipped for a warp whose rows kept their max.
// Layout is the public (B, L, H, 512): the tensor maps see it as (64, 8 H,
// L, B), so a tile that runs past L is zero-filled and never reads the next
// batch's rows; padded keys carry the code INT_MAX, never allowed.
#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr int D = 512;
constexpr int BM = 64;             // query rows per block
constexpr int BN = 32;             // keys per tile
constexpr int NS = 2;              // ring stages
constexpr int SLABS = D / 64;      // 128-byte column slabs of a row
constexpr int THREADS = 384;       // producer warpgroup + two consumers
constexpr uint32_t Q_SLAB = BM * 128;
constexpr uint32_t KV_SLAB = BN * 128;
constexpr uint32_t Q_BYTES = SLABS * Q_SLAB;   // 64 KB
constexpr uint32_t TILE = SLABS * KV_SLAB;     // 32 KB of K or of V
constexpr uint32_t STAGE = 2 * TILE;
constexpr uint32_t CODES = BN * 4;
constexpr int XCH = BM * BN;                   // one warpgroup's partial S
constexpr uint32_t SMEM = 1024 + Q_BYTES + NS * STAGE + 4 * XCH * 4 + NS * CODES;
constexpr float NEG = -1e30f;
constexpr float C = 1.4426950408889634f * 0.044194173824159216f;  // log2(e)/sqrt(512)

__global__ void __launch_bounds__(THREADS, 1)
flash_online_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ codes, const int* __restrict__ plan,
                    const int* __restrict__ nxt, const int* __restrict__ qids,
                    bf16* __restrict__ out, int Lq, int H, int nt, int nqb) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], qbar;
  __shared__ int stage_tile[NS];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* ring = Qs + Q_BYTES;
  float* xch = reinterpret_cast<float*>(ring + NS * STAGE);
  int* code_s = reinterpret_cast<int*>(xch + 4 * XCH);

  const int qb = nqb - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * BM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
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
      for (int sl = 0; sl < SLABS; ++sl)
        tma_load_4d(Qs + sl * Q_SLAB, &tq, &qbar, 0, h * SLABS + sl, q0, b);
      const int n_live = plan[2 * (b * nqb + qb)];
      const int* nx = nxt != nullptr && plan[2 * (b * nqb + qb) + 1]
                          ? nxt + (size_t)b * (nt + 1)
                          : nullptr;
      const int* cb = codes + (size_t)b * nt * BN;
      for (int i = 0, t = 0;; ++i, ++t) {
        if (nx != nullptr) t = nx[t];
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        if (t >= n_live) {  // the end: a stage that carries no tile
          stage_tile[s] = -1;
          mbar_arrive(&full[s]);
          break;
        }
        stage_tile[s] = t;
        uint8_t* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE + CODES);
        for (int sl = 0; sl < SLABS; ++sl) {
          tma_load_4d(st + sl * KV_SLAB, &tk, &full[s], 0, h * SLABS + sl,
                      t * BN, b);
          tma_load_4d(st + TILE + sl * KV_SLAB, &tv, &full[s], 0,
                      h * SLABS + sl, t * BN, b);
        }
        bulk_load(code_s + s * BN, cb + (size_t)t * BN, CODES, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns output channels [256 w, 256 w + 256) ----
  regs_alloc<240>();
  const int w = wg - 1;
  const int tw = tid - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qid0 = qids ? qids[(size_t)b * Lq + min(r0, Lq - 1)] : 0;
  const int qid1 = qids ? qids[(size_t)b * Lq + min(r1, Lq - 1)] : 0;

  // Q's 16 k-steps over this warpgroup's half of d: slab 4 w + kk / 4, 32
  // bytes per step inside a slab (descriptor units of 16 bytes)
  const uint64_t dq = smem_desc(smem_u32(Qs + 4 * w * Q_SLAB), 16, 1024, 1);
  auto qk = [&](float (&s)[16], int st) {
    const uint64_t dk =
        smem_desc(smem_u32(ring + st * STAGE + 4 * w * KV_SLAB), 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      wgmma_m64n32k16_ss(s, dq + (kk / 4) * (Q_SLAB >> 4) + 2 * (kk % 4),
                         dk + (kk / 4) * (KV_SLAB >> 4) + 2 * (kk % 4), kk);
  };
  // V's 256 columns of this warpgroup: 4 slabs KV_SLAB apart (the leading
  // byte offset), 16 keys per step = 2048 bytes
  auto pv = [&](float (&o)[128], const uint32_t (&p)[8], int st) {
    const uint64_t dv = smem_desc(
        smem_u32(ring + st * STAGE + TILE + 4 * w * KV_SLAB), KV_SLAB, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n256k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3], dv + 128 * kk);
  };

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float sacc[16];
  uint32_t p[8];

  mbar_wait(&qbar, 0);
  for (int i = 0;; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    if (stage_tile[s] < 0) break;

    // partial scores over this warpgroup's 256 channels
    wgmma_fence();
    qk(sacc, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    float* mine = xch + ((i & 1) * 2 + w) * XCH;
    const float* theirs = xch + ((i & 1) * 2 + (1 - w)) * XCH;
#pragma unroll
    for (int e = 0; e < 16; ++e) mine[e * 128 + tw] = sacc[e];
    named_sync<256>(1);

    // the full scores, the same bits in both warpgroups (a + b == b + a)
    const int* code = code_s + s * BN;
    float x[16];
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int c0 = code[8 * n8 + 2 * t], c1 = code[8 * n8 + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * n8 + e;
        const float sc = (sacc[idx] + theirs[idx * 128 + tw]) * C;
        const int cd = (e & 1) ? c1 : c0;
        x[idx] = cd <= (e < 2 ? qid0 : qid1) ? sc : NEG;
      }
      mx0 = fmaxf(mx0, fmaxf(x[4 * n8], x[4 * n8 + 1]));
      mx1 = fmaxf(mx1, fmaxf(x[4 * n8 + 2], x[4 * n8 + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const float p0 = ex2(x[4 * n8] - mn0), p1 = ex2(x[4 * n8 + 1] - mn0);
      const float p2 = ex2(x[4 * n8 + 2] - mn1), p3 = ex2(x[4 * n8 + 3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      const int r = 4 * (n8 >> 1) + 2 * (n8 & 1);
      p[r] = pack_f2(p0, p1);
      p[r + 1] = pack_f2(p2, p3);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
      for (int n8 = 0; n8 < 32; ++n8) {
        o[4 * n8] *= a0;
        o[4 * n8 + 1] *= a0;
        o[4 * n8 + 2] *= a1;
        o[4 * n8 + 3] *= a1;
      }
    }

    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv(o, p, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(&empty[s]);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t rs = (size_t)H * D;
  bf16* ob = out + ((size_t)b * Lq * H + h) * D + 256 * w;
#pragma unroll
  for (int n8 = 0; n8 < 32; ++n8) {
    const int col = 8 * n8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + col) =
          pack_f2(o[4 * n8] * i0, o[4 * n8 + 1] * i0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + col) =
          pack_f2(o[4 * n8 + 2] * i1, o[4 * n8 + 3] * i1);
  }
}

}  // namespace

// q (B, Lq, H, 512), k/v (B, Lk, H, 512) bf16, 16-byte aligned; codes
// (B, nt * 32) int32 (kv id where the key is valid, INT_MAX where masked or
// past Lk; 0 for valid keys without ids); plan (B, nqb, 2) int32: live tiles
// and whether masked tiles may be skipped; nxt (B, nt + 1) int32 or null;
// qids (B, Lq) int32 or null; out (B, Lq, H, 512) bf16. nt = ceil(Lk / 32),
// nqb = ceil(Lq / 64). Returns the first CUDA error (a tensor map that
// cannot be encoded returns its CUresult).
extern "C" int k5_flash_online(const void* q, const void* k, const void* v,
                               const void* codes, const void* plan,
                               const void* nxt, const void* qids, void* out,
                               int B, int Lq, int Lk, int H, void* stream) {
  CUtensorMap tq, tk, tv;
  // a 512-wide head seen as 8 heads of 64 columns
  int err = bhld_map(&tq, q, B, Lq, SLABS * H, BM);
  if (err == 0) err = bhld_map(&tk, k, B, Lk, SLABS * H, BN);
  if (err == 0) err = bhld_map(&tv, v, B, Lk, SLABS * H, BN);
  if (err != 0) return err;
  static bool ready[64] = {};
  err = smem_limit_once(ready, (const void*)flash_online_kernel, SMEM);
  if (err != 0) return err;
  const int nt = (Lk + BN - 1) / BN, nqb = (Lq + BM - 1) / BM;
  dim3 grid(nqb, H, B);
  flash_online_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tq, tk, tv, (const int*)codes, (const int*)plan, (const int*)nxt,
      (const int*)qids, (bf16*)out, Lq, H, nt, nqb);
  return (int)cudaGetLastError();
}
