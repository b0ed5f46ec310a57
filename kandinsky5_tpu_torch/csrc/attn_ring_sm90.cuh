// The block structure shared by the fixed-shift attention kernels for
// 64-wide heads: K1 (flash_fixed.cu, bf16 Q K^T) and K5, K7 and T5
// (flash_int8.cu, s8 Q K^T). A kernel supplies its loads, its Q K^T product
// and its pointwise pass; the ring, the turns and the PV product are here.
//
//   * A warp-specialised block of BM = 128 query rows of one (batch, head):
//     one producer thread issues TMA loads (the block's Q once, then what
//     the kernel reads per tile of BN = 128 keys into a ring of NS stages,
//     completion on "full" mbarriers); two consumer warpgroups own 64 query
//     rows each and free a stage through its "empty" mbarrier once both have
//     read it; setmaxnreg moves registers from the producer to the
//     consumers.
//   * S = Q K^T stays in registers (64 fp32 or s32 a thread). Its C fragment
//     is the A fragment of P, so the pointwise pass packs bf16 weights
//     straight into the A registers of the PV product and P never touches
//     shared memory.
//   * O += P V is wgmma m64n72k16 with V read MN-major (128-byte swizzle)
//     from the ring: the 8 columns past d read one constant strip of ones
//     after the ring (each stage's descriptor puts it at its leading byte
//     offset), so the tensor cores also sum the rounded p in fp32 (the
//     normalizer, columns 64..71 of O) and the pointwise pass carries no add.
//   * The two consumer warpgroups take turns issuing their products on named
//     barriers 1 and 2, so one warpgroup's pointwise pass runs under the
//     other's wgmma. At each turn a warpgroup issues S_j and then PV_{j-1}.
//     With LAG it waits for S_j alone (wgmma.wait_group 1) and forms P_j
//     under PV_{j-1} (K1, K7); without it, it waits for both (K5, T5). The
//     products and the order of the accumulations do not depend on LAG.
//   * P alternates between two register arrays, two tiles a pass: a copy
//     would read registers a wgmma still uses, and ptxas then serializes
//     every wgmma (warning C7513).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace k5 {
namespace attn {

constexpr int D = 64;
constexpr int NWG = 2;                    // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG;              // query rows per block
constexpr int BN = 128;                   // keys per tile
constexpr int THREADS = 128 * (NWG + 1);  // the producer's warpgroup first
constexpr uint32_t V_TILE = BN * 128;     // one bf16 V tile; the ones strip

// The dynamic shared memory rounded up to 1024 bytes, as the 128-byte
// swizzle needs. Derived from ``raw`` by pointer arithmetic, so the compiler
// still knows it is shared memory and reads it with LDS (a pointer cast from
// an integer gives generic loads).
__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Every thread: the barriers set up and the ones strip written, both visible
// to TMA and wgmma.
template <int NS>
__device__ __forceinline__ void ring_init(uint64_t (&full)[NS],
                                          uint64_t (&empty)[NS], uint64_t& qbar,
                                          uint8_t* ones) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(&qbar, 1);
    fence_barrier_init();
  }
  // the 8 columns of V past d, whatever the swizzle
  for (int i = threadIdx.x; i < (int)(V_TILE / 16); i += THREADS)
    reinterpret_cast<uint4*>(ones)[i] =
        make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
  fence_proxy_async();
  __syncthreads();
}

// The producer thread: Q (q_bytes) through load_q(bar), then tile j into
// stage s = j % NS once both warpgroups freed it, through load(j, s, bar),
// stage_bytes a tile.
template <int NS, class LoadQ, class LoadTile>
__device__ __forceinline__ void ring_produce(uint64_t (&full)[NS],
                                             uint64_t (&empty)[NS],
                                             uint64_t& qbar, uint32_t q_bytes,
                                             uint32_t stage_bytes, int n_tiles,
                                             LoadQ load_q, LoadTile load) {
  mbar_expect_tx(&qbar, q_bytes);
  load_q(&qbar);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    mbar_wait(&empty[s], ((j / NS) & 1) ^ 1);
    mbar_expect_tx(&full[s], stage_bytes);
    load(j, s, &full[s]);
  }
}

// O += P V for one tile: P's bf16 A fragments in p, dv the stage's V
// descriptor (its leading byte offset reaching the ones strip).
__device__ __forceinline__ void pv_tile(float (&o)[36], const uint32_t (&p)[32],
                                        uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_m64n72k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                       p[4 * kk + 3], dv + 128 * kk);
}

// Consumer warpgroup w's walk over the n_tiles key tiles, once Q has come.
// qk(s) issues S = Q K^T for the tile in stage s into sacc; dv(s) is that
// stage's V descriptor; work(j, p) is tile j's pass once S_j is in sacc,
// writing P_j into p. Without PV no PV product is issued (T5's qk_only,
// whose work adds the scores into o itself).
template <int NS, bool LAG, bool PV, class Acc, class QK, class DV, class Work>
__device__ __forceinline__ void ring_consume(Acc (&sacc)[64], float (&o)[36],
                                             uint64_t (&full)[NS],
                                             uint64_t (&empty)[NS],
                                             uint64_t& qbar, int w, int n_tiles,
                                             QK qk, DV dv, Work work) {
  const int turn = 1 + w, next_turn = 1 + (w + 1) % NWG;
  uint32_t p[32], pn[32];

  // the warpgroups issue their products in turn, warpgroup 0 first
  if (w == NWG - 1) named_arrive<256>(1);
  mbar_wait(&qbar, 0);

  // one turn: issue S_j and PV_{j-1} (from pin), then tile j's work (into
  // pout), under the PV product (LAG) or after it
  auto step = [&](int j, uint32_t (&pin)[32], uint32_t (&pout)[32]) {
    const int s = j % NS, sp = (j - 1) % NS;
    mbar_wait(&full[s], (j / NS) & 1);
    named_sync<256>(turn);
    fence_regs(sacc);
    fence_regs(pin);
    fence_regs(o);
    wgmma_fence();
    qk(s);
    wgmma_commit();
    if constexpr (PV) {
      pv_tile(o, pin, dv(sp));
      wgmma_commit();
    }
    named_arrive<256>(next_turn);
    if constexpr (LAG)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(sacc);
    work(j, pout);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pin);
    mbar_arrive(&empty[sp]);
  };
  // the last turn: PV_{n-1}
  auto last = [&](uint32_t (&pin)[32]) {
    const int sl = (n_tiles - 1) % NS;
    named_sync<256>(turn);
    if constexpr (PV) {
      fence_regs(pin);
      fence_regs(o);
      wgmma_fence();
      pv_tile(o, pin, dv(sl));
      wgmma_commit();
    }
    named_arrive<256>(next_turn);
    if constexpr (PV) {
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pin);
    }
    mbar_arrive(&empty[sl]);
  };

  // first turn: S_0, then its work
  mbar_wait(&full[0], 0);
  named_sync<256>(turn);
  wgmma_fence();
  qk(0);
  wgmma_commit();
  named_arrive<256>(next_turn);
  wgmma_wait<0>();
  fence_regs(sacc);
  work(0, p);
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
}

// Consumer warpgroup w's 64 rows of O (columns 0..63) into out (B, Lq, H,
// 64) bf16 at (b, rows qb * BM + 64 w.., h); with NORM each row divided by
// its normalizer, max(column 64, 1e-30).
template <bool NORM>
__device__ __forceinline__ void store_rows(const float (&o)[36], bf16* out,
                                           int b, int h, int qb, int w, int Lq,
                                           int H) {
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5, g = (tw & 31) >> 2, t = tw & 3;
  float i0 = 1.f, i1 = 1.f;
  if (NORM) {
    i0 = 1.f / fmaxf(o[32], 1e-30f);
    i1 = 1.f / fmaxf(o[34], 1e-30f);
  }
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

}  // namespace attn
}  // namespace k5
