// K6: NABLA block-sparse attention over per-row lists of 64-token KV blocks
// (the DiT's visual self-attention in the 10 s configs).
//
// Replaces kandinsky5_tpu/ops/sparse_pallas.py _kernel (reached via
// _sparse_bhld and sparse_attention with q_rows=1, kv_page_blocks=1). For
// the 64 queries of block i of one (batch, head) it computes
//   out = sum_j p_ij v_j / max(sum_j p_ij, 1e-30),
//   p_ij = exp2(bf16(q_i * log2(e)/sqrt(d)) . k_j - shift * log2(e)),
// over the keys of the first nb[i] blocks listed in kv_inds[i], with ONE
// scalar shift for the call (score_bound, a device scalar), so no running
// max and no rescale exist. p is rounded to bf16 for the PV product, but
// the normalizer sums the unrounded fp32 p, as the TPU kernel does. A row
// with no listed block writes zeros.
//
// Bound on the H100: the tensor cores (4 x 64^3 flops per listed block)
// and, as for K1, the special-function units' exp2 (64 x 64 per listed
// block at 16 per clock per SM: about as long as the products). The bytes,
// each listed 16 KB K/V block once per query block (64 flops a byte), must
// come from L2 and be shared: neighbouring query blocks list mostly the
// same blocks (at 90 % kept, nearly all).
// Design, K1's structure (csrc/flash_fixed.cu) walking lists:
//   * a block takes four neighbouring query blocks of one head (a group,
//     ops/sparse.py GROUP); the groups of a head run together, so its K and
//     V (24 MB at the 10 s shape) stay in L2 while they are read, and
//     longest first within the head (``order``, built by the wrapper from
//     the lists' lengths);
//   * one producer thread merges the group's ascending lists and feeds
//     each distinct KV block once, by TMA (K and V tiles of 64 keys,
//     128-byte swizzled), into an 8-stage ring on mbarriers, with a flag
//     per stage saying which query blocks listed it: a block listed by
//     several is read once for all of them;
//   * four consumer warpgroups, one per query block, own 64 query rows
//     each. Q is loaded by TMA, scaled and rounded to bf16 once into
//     registers (the A fragments of the score product). Per stage it
//     listed: S = Q K^T is wgmma m64n64k16 with Q from registers, one FADD
//     and one ex2.approx per score, the row sum in registers over the
//     unrounded p, p cvt to bf16x2 straight into the A registers of O += P
//     V (wgmma m64n64k16, V read MN-major). The warpgroups' exp2 passes
//     and products interleave; each frees every stage through its "empty"
//     mbarrier, listed or not;
//   * setmaxnreg moves registers from the producer to the consumers (112
//     each, so four fit beside it; K1's in-warpgroup pipelining needs a
//     second P array and does not fit, and gained 3 % with two warpgroups).
// Layout is the public (B, S, H, 64), read through 4-D tensor maps (64, H,
// S, B).
#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr int D = 64, BQ = 64, BKV = 64;
constexpr int NWG = 4;                  // consumer warpgroups = query blocks
constexpr int NS = 8;                   // ring stages
constexpr int THREADS = 128 * (NWG + 1);
constexpr uint32_t TILE = BKV * 128;    // one K or V tile, bytes
constexpr uint32_t STAGE = 2 * TILE;
constexpr uint32_t Q_TILE = BQ * 128;
constexpr uint32_t SMEM = 1024 + NWG * Q_TILE + NS * STAGE;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float QSCALE = LOG2E * 0.125f;  // log2(e) / sqrt(64)

__global__ void __launch_bounds__(THREADS, 1)
sparse_nabla_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const int* __restrict__ inds, const int* __restrict__ nbs,
                    const int* __restrict__ order,
                    const float* __restrict__ shift, bf16* __restrict__ out,
                    int S, int H, int nq, int s1) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NS], empty[NS], qbar;
  __shared__ int stage_flags[NS];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;
  uint8_t* ring = Qs + NWG * Q_TILE;

  const int ng = (nq + NWG - 1) / NWG;
  const int gid = order[blockIdx.x];
  const int grp = gid % ng, h = (gid / ng) % H, b = gid / (ng * H);
  const int tid = threadIdx.x;
  const size_t row0 = ((size_t)b * H + h) * nq + (size_t)grp * NWG;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread merges the lists and keeps the ring full ----
    regs_dealloc<24>();
    if (tid == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      const int nblk = min(NWG, nq - grp * NWG);
      mbar_expect_tx(&qbar, nblk * Q_TILE);
      for (int w = 0; w < nblk; ++w)
        tma_load_4d(Qs + w * Q_TILE, &tq, &qbar, 0, h, (grp * NWG + w) * BQ, b);
      // the group's lists, merged: each distinct block once, in order
      int n[NWG], idx[NWG];
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        n[w] = w < nblk ? nbs[row0 + w] : 0;
        idx[w] = 0;
      }
      for (int i = 0;; ++i) {
        int c[NWG], blk = INT_MAX;
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          c[w] = idx[w] < n[w] ? inds[(row0 + w) * s1 + idx[w]] : INT_MAX;
          blk = min(blk, c[w]);
        }
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        if (blk == INT_MAX) {  // the end: a stage that carries no tile
          stage_flags[s] = -1;
          mbar_arrive(&full[s]);
          break;
        }
        int flags = 0;
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          flags |= (c[w] == blk) << w;
          idx[w] += c[w] == blk;
        }
        stage_flags[s] = flags;
        uint8_t* st = ring + s * STAGE;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_4d(st, &tk, &full[s], 0, h, blk * BKV, b);
        tma_load_4d(st + TILE, &tv, &full[s], 0, h, blk * BKV, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query block NWG grp + w ----
  regs_alloc<112>();
  const int w = wg - 1;
  const int tw = tid - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t = lane & 3;
  const float nshift = -shift[0] * LOG2E;
  const int qrow = (grp * NWG + w) * BQ;

  // Q scaled into the log2 domain and rounded to bf16, as the A fragments
  // of the score product: register 4 kk + r holds (row g + 8 (r & 1), cols
  // 16 kk + 2 t + 8 (r >> 1) ..+1) of this warp's 16 rows, read from the
  // 128-byte-swizzled tile (16-byte chunk c of row r at chunk c ^ (r % 8))
  mbar_wait(&qbar, 0);
  uint32_t qa[16];
  {
    const uint8_t* qt = Qs + w * Q_TILE;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + g + 8 * (r & 1);
      const int col = 16 * (r >> 2) + 2 * t + 8 * ((r >> 1) & 1);
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(
          qt + row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2);
      const float2 f = unpack_f2(raw);
      qa[r] = pack_f2(f.x * QSCALE, f.y * QSCALE);
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  float sacc[32];
  uint32_t p[16];

  auto qk = [&](int st) {
    const uint64_t dk = smem_desc(smem_u32(ring + st * STAGE), 16, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_rs<0>(sacc, qa[4 * kk], qa[4 * kk + 1], qa[4 * kk + 2],
                            qa[4 * kk + 3], dk + 2 * kk, kk);
  };
  auto pv = [&](int st) {
    const uint64_t dv =
        smem_desc(smem_u32(ring + st * STAGE + TILE), TILE, 1024, 1);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_m64n64k16_rs<1>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                            p[4 * kk + 3], dv + 128 * kk, 1);
  };
  // the weights of S: sacc[4 n8 + e] is (row g + 8 (e / 2), key 8 n8 + 2 t +
  // e % 2); the row sums add the unrounded p
  auto weights = [&]() {
#pragma unroll
    for (int n8 = 0; n8 < BKV / 8; ++n8) {
      const float x0 = ex2(sacc[4 * n8] + nshift);
      const float x1 = ex2(sacc[4 * n8 + 1] + nshift);
      const float x2 = ex2(sacc[4 * n8 + 2] + nshift);
      const float x3 = ex2(sacc[4 * n8 + 3] + nshift);
      l0 += x0 + x1;
      l1 += x2 + x3;
      const int r = 4 * (n8 >> 1) + 2 * (n8 & 1);
      p[r] = pack_f2(x0, x1);
      p[r + 1] = pack_f2(x2, x3);
    }
  };

  for (int i = 0;; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    const int flags = stage_flags[s];
    if (flags < 0) break;
    if (flags & (1 << w)) {
      fence_regs(sacc);
      wgmma_fence();
      qk(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      weights();
      fence_regs(p);
      fence_regs(o);
      wgmma_fence();
      pv(s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
    }
    mbar_arrive(&empty[s]);
  }

  if (qrow >= S) return;
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = qrow + warp * 16 + g, r1 = r0 + 8;
  const size_t rs = (size_t)H * D;
  bf16* ob = out + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = n8 * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + r0 * rs + col) =
        pack_f2(o[4 * n8] * i0, o[4 * n8 + 1] * i0);
    *reinterpret_cast<uint32_t*>(ob + r1 * rs + col) =
        pack_f2(o[4 * n8 + 2] * i1, o[4 * n8 + 3] * i1);
  }
}

}  // namespace

// q (B, S, H, 64), k/v (B, Sk, H, 64) bf16, 16-byte aligned, S and Sk
// multiples of 64; inds (B, H, S/64, Sk/64) and nb (B, H, S/64) int32 (a
// row's first nb blocks; the merge consumes every entry once in any order,
// and shares loads when they ascend); order (B * H * ceil(S / 256)) int32, a
// permutation of the groups of four query blocks; shift (1,) fp32. Returns
// the first CUDA error (a tensor map that cannot be encoded returns its
// CUresult).
extern "C" int k5_sparse_nabla(const void* q, const void* k, const void* v,
                               const void* inds, const void* nb,
                               const void* order, const void* shift, void* out,
                               int B, int S, int Sk, int H, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = bhld_map(&tq, q, B, S, H, BQ);
  if (err == 0) err = bhld_map(&tk, k, B, Sk, H, BKV);
  if (err == 0) err = bhld_map(&tv, v, B, Sk, H, BKV);
  if (err != 0) return err;
  static bool ready[64] = {};
  err = smem_limit_once(ready, (const void*)sparse_nabla_kernel, SMEM);
  if (err != 0) return err;
  const int nq = S / BQ, ng = (nq + NWG - 1) / NWG;
  if (B * H * ng == 0) return 0;
  sparse_nabla_kernel<<<B * H * ng, THREADS, SMEM, (cudaStream_t)stream>>>(
      tq, tk, tv, (const int*)inds, (const int*)nb, (const int*)order,
      (const float*)shift, (bf16*)out, S, H, nq, Sk / BKV);
  return (int)cudaGetLastError();
}
