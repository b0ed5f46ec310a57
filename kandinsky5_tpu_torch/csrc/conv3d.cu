// K3: 3x3x3 stride-1 time-causal convolution with replicate padding (the VAE
// decoder's 3x3x3 convs between 128 and 512 channels), in all the TPU
// kernel's modes, on Hopper's wgmma.
//
// Replaces kandinsky5_tpu/ops/conv_pallas.py _kernel (reached via
// _conv_fused and causal_conv3d_fused):
//   y[t,h,w,:] = bias + sum_{dt,dh,dw} f(x[t',h',w',:]) . W[dt,dh,dw]
// where, unpadded, t' = max(t + dt - 2, 0) (two replicated leading frames)
// and, time_padded, t' = t + dt over an input that already carries two
// history frames; h' = clamp(h + dh - 1), w' = clamp(w + dw - 1). The
// replicate padding is an index clamp inside the kernel, so no padded copy
// of the activation is ever written. f is the identity, or with FUSE the
// folded GroupNorm + SiLU prologue (conv_pallas.py:163-182): v * scale[c] +
// shift[c] in fp32, then (act) y * sigmoid(y), rounded to bf16 once; input
// planes t' < prefix (the streaming decode's carried history) pass
// untouched. The prologue commutes with the replicate padding, so it is
// applied to the clamped window.
//
// QUANT (W8A8, conv_pallas.py:183-230): the weight arrives as int8 (27,
// Cout, Cin) with per-Cout scales ws; f(x) is quantized with the scale of
// the TPU tile (t, h / 8, w / bw) of its OUTPUT voxel, q = rint(f(x) * inv)
// (no clip), the s8 x s8 products sum exactly in int32, and y = float(acc) *
// (s * ws[n]) + bias[n]. The scales come from window_rowmax_kernel and
// window_scale_kernel below: the max |f(x)| over the TPU window (3 planes,
// rows [8 hb - 1, 8 hb + 9), columns [wb bw - 1, wb bw + bw + 7), clamped),
// part of K3's body on the TPU.
//
// Bound on the H100: the tensor cores, 27 * Cin MACs per output channel and
// voxel (int8 at twice the bf16 rate); the bytes (the activation read once,
// the output written once) take a fifth of that time or less in bf16 and a
// third under QUANT at every decoder shape (128->128 12x512x768: 4.2 ms of
// bf16 products, 0.8 ms of bytes).
//
// Design: one block of three warpgroups per SM, persistent over the output
// tiles (the tiles of one spatial position, one per 128 output channels, are
// neighbours in the order, so they share their input in L2).
//   * Output tile: TP planes x 8 rows x 16 columns x 128 output channels;
//     TP = 2 in bf16 (256 voxels), TP = 1 under QUANT (128 voxels). Under
//     QUANT a tile lies inside one TPU scale tile (t, h / 8, w / bw), since
//     every bw the wrapper passes (32 ... 256) is a multiple of 16 and rows
//     are taken 8 at a time; so the block has one scale and gives exactly
//     the codes of the TPU kernel, which quantizes its halo window once.
//   * The halo: for each channel slice of 64 bytes (32 bf16 or 64 int8
//     channels) the block stages the tile's input window, (TP + 2) planes x
//     10 rows x 18 columns, in shared memory once: clamped in h and w
//     (replicate) and in t (both time modes). Three producer warps copy it
//     with cp.async, one round trip to L2 per slice (under QUANT into a bf16
//     copy beside the halo), then apply the prologue once per staged element
//     (planes below ``prefix`` untouched), in place and without branches
//     (transform8), and under QUANT quantize it once. An input
//     element is therefore staged (TP + 2) * 10 * 18 / (TP * 8 * 16) times
//     per 128 output channels: 2.81 times in bf16, 4.22 under QUANT, each
//     times Cout / 128 (a gather per tap would take it 27 times per 128
//     output channels). setmaxnreg gives these
//     warps 152 registers a thread, the consumers 176: the prologue's chains
//     are latency-bound and need the registers to overlap.
//   * The 27 taps read shifted windows of that halo, with wgmma taking A
//     from shared memory (of the two ways, the one that leaves the consumers
//     nothing to issue but wgmma and barrier operations, and all their
//     registers to the accumulators; ldmatrix into register fragments would
//     cost issue slots and 16 registers per m64 block). The halo is
//     non-swizzled K-major: the 16-byte chunk c of staged voxel (p, r, x) is
//     at c * CH + ((p * 10 + r) * 18 + x) * 16, so the 8 rows of a core
//     matrix are 8 neighbouring columns, an m64 product covers 8 output rows
//     x 8 output columns of one plane with a uniform stride between its core
//     matrices (sbo = 18 * 16 bytes, lbo = CH), and a tap (dt, dh, dw) only
//     moves the descriptor's base address by ((dt * 10 + dh) * 18 + dw) * 16.
//   * Weights (27, Cout, Cin), bf16 or int8, K contiguous (the B operand):
//     one producer thread feeds them by TMA (3-D tensor map, 64-byte
//     swizzle) through a ring of NS stages of 128 output channels x 64 bytes
//     (one tap of one slice, 8 KB) on full / empty mbarriers.
//   * Two consumer warpgroups issue wgmma m64n128k16 bf16 -> fp32, or
//     m64n128k32 s8 x s8 -> s32 under QUANT (exact: 27 * 512 * 127^2 <
//     2^31): each owns one plane of the tile in bf16 (two m64 blocks, 128
//     accumulator registers) and 8 columns under QUANT (one m64 block). A
//     weight stage is released as soon as the next tap's products are
//     issued (wgmma.wait_group 1).
//   * Overlap: the halo is double-buffered on full / empty mbarriers, so the
//     next slice's (or the next tile's) halo is filled while the current one
//     is in the products, and a tile's epilogue runs while the next tile's
//     first halo is filled.
//   * Epilogue as the TPU kernel's: bf16, acc + bias[n] in fp32 rounded to
//     bf16 once; QUANT, float(acc) * (s * ws[n]) + bias[n] with
//     round-to-nearest multiplies and add, no contraction. Ragged edges (T,
//     H, W not multiples of the tile) are masked at the store; the clamped
//     halo keeps every load inside the input.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {
using namespace k5;

constexpr int BN = 128;                  // output channels per tile
constexpr int TR = 8, TC = 16;           // output rows and columns per tile
constexpr int HR = TR + 2, HC = TC + 2;  // halo rows and columns
constexpr int SLICE = 64;                // bytes of K per staged voxel and stage
constexpr int NCH = SLICE / 16;          // 16-byte chunks of a staged voxel
constexpr int NS = 8;                    // weight ring stages
constexpr uint32_t WSTAGE = BN * SLICE;  // one weight stage, bytes
constexpr int FILLERS = 96;              // halo threads: producer warps 1-3
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = 128 + CONSUMERS;

// The tile of one instance: planes, staged voxels, the chunk stride (the A
// descriptor's lbo), one halo buffer, the m64 blocks of a consumer
// warpgroup, the bf16 copy of a slice that QUANT quantizes from, shared
// memory.
template <bool QUANT>
struct Tile {
  static constexpr int TP = QUANT ? 1 : 2;
  static constexpr int HP = TP + 2;
  static constexpr int VOX = HP * HR * HC;
  static constexpr uint32_t CH = VOX * 16;
  static constexpr uint32_t HALO = NCH * CH;
  static constexpr int G = TP * (TC / 8) / 2;
  static constexpr uint32_t RAW = QUANT ? VOX * NCH * 32 : 0;  // bf16 copies
  static constexpr uint32_t SMEM = 1024 + NS * WSTAGE + 2 * HALO + RAW;
};

struct ConvArgs {
  const bf16* x;
  const float* bias;
  const float* scale;
  const float* shift;
  const float* ws;
  const float* tile_s;
  const float* tile_inv;
  bf16* y;
  int T, H, W, Cin, Cout, time_padded, act, prefix, bw;
  int n_h, n_w, n_cb, n_items;  // tiles along H and W, Cout blocks, all tiles
};

// 1 / d rounded to nearest for 1 <= d < 2^126: the approximate reciprocal
// and one Newton step on the fused multiply-add (from an approximation within
// an ulp the step gives the correctly rounded reciprocal, as
// test_k3_prologue_exact_on_every_bf16 checks through the whole prologue),
// without the IEEE division's branch to its slow path.
__device__ __forceinline__ float rcp_newton(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(__fmaf_rn(-d, r, 1.f), r, r);
}

// The folded GroupNorm + SiLU prologue on 8 bf16 channels of a 16-byte piece,
// given their scales s and shifts h: y = v * s + h in fp32 without
// contraction, then (act) y * (1 / (1 + exp(-y))) as torch computes SiLU on
// the card, rounded to bf16. EXACT divides; otherwise the chains of the 8
// values run without branches (SiLU computed whatever ``act``, then selected;
// the reciprocal by rcp_newton), so that they and those of neighbouring
// pieces overlap, and ``rare`` is set where 1 + exp(-y) >= 2^126, for which
// the caller redoes the piece with EXACT.
template <bool EXACT>
__device__ __forceinline__ uint4 transform8(uint4 r, const float (&s)[8],
                                            const float (&h)[8], int act,
                                            bool& rare) {
  uint32_t* u = reinterpret_cast<uint32_t*>(&r);
  float y[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_f2(u[j]);
    y[2 * j] = __fadd_rn(__fmul_rn(f.x, s[2 * j]), h[2 * j]);
    y[2 * j + 1] = __fadd_rn(__fmul_rn(f.y, s[2 * j + 1]), h[2 * j + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float d = __fadd_rn(1.f, expf(-y[i]));
    if (EXACT) {
      if (act) y[i] = __fmul_rn(y[i], __fdiv_rn(1.f, d));
    } else {
      rare |= d >= 0x1p126f;
      const float silu = __fmul_rn(y[i], rcp_newton(d));
      y[i] = act ? silu : y[i];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = pack_f2(y[2 * j], y[2 * j + 1]);
  return r;
}

// The 8 floats p[c..c+7].
__device__ __forceinline__ void load8(const float* __restrict__ p, int c,
                                      float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + c);
  const float4 b = *reinterpret_cast<const float4*>(p + c + 4);
  out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
  out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
}

// 4 int8 codes rint(v * inv), round half to even, packed low byte first.
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float inv) {
  const float2 a = unpack_f2(lo), b = unpack_f2(hi);
  const int q0 = __float2int_rn(__fmul_rn(a.x, inv));
  const int q1 = __float2int_rn(__fmul_rn(a.y, inv));
  const int q2 = __float2int_rn(__fmul_rn(b.x, inv));
  const int q3 = __float2int_rn(__fmul_rn(b.y, inv));
  return (uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8) |
         ((uint32_t)(q2 & 0xff) << 16) | ((uint32_t)(q3 & 0xff) << 24);
}

// 16 bf16 values (two pieces) -> 16 int8 codes (one piece).
__device__ __forceinline__ uint4 quant16(uint4 r0, uint4 r1, float inv) {
  return make_uint4(quant4(r0.x, r0.y, inv), quant4(r0.z, r0.w, inv),
                    quant4(r1.x, r1.y, inv), quant4(r1.z, r1.w, inv));
}

// The output tile of ``item``: first plane, row and column, Cout block.
struct TileAt {
  int t0, h0, w0, n0;
};

template <bool QUANT>
__device__ __forceinline__ TileAt tile_at(const ConvArgs& a, int item) {
  TileAt at;
  at.n0 = (item % a.n_cb) * BN;
  item /= a.n_cb;
  at.w0 = (item % a.n_w) * TC;
  item /= a.n_w;
  at.h0 = (item % a.n_h) * TR;
  at.t0 = (item / a.n_h) * Tile<QUANT>::TP;
  return at;
}

// Stage slice k of the tile's halo into ``halo`` (one buffer). Filler f of
// FILLERS owns chunk c = f % NCH of the voxels f / NCH + j * FILLERS / NCH.
// First every owned piece is copied with cp.async (one round trip to L2 per
// slice), straight into its place in the halo in bf16, into ``raw`` (bf16, 32
// bytes per chunk) under QUANT. Then, with FUSE or QUANT, the thread reads
// back its own pieces NB at a time, applies the prologue without branches
// (planes below ``prefix`` keep their values) and writes them in place, or
// quantizes two pieces into one 16-byte chunk of int8 codes.
template <bool FUSE, bool QUANT>
__device__ __forceinline__ void fill_halo(uint8_t* halo, uint8_t* raw,
                                          const ConvArgs& a, const TileAt& at, int k,
                                          float inv, int f) {
  using L = Tile<QUANT>;
  constexpr int VSTEP = FILLERS / NCH;
  constexpr int NB = QUANT ? 1 : 4;
  constexpr int PIECES = QUANT ? 2 : 1;
  const int c = f % NCH;
  const int ch = k * (QUANT ? 64 : 32) + c * 8 * PIECES;  // first channel
  const int t_in = a.time_padded ? a.T + 2 : a.T;
  auto plane = [&](int v) {  // the input plane of staged voxel v, clamped
    const int p = v / (HR * HC);
    return min(a.time_padded ? at.t0 + p : max(at.t0 - 2 + p, 0), t_in - 1);
  };
  auto piece = [&](int v, int q) {
    return QUANT ? raw + (v * NCH + c) * 32 + q * 16 : halo + c * L::CH + v * 16;
  };
  for (int v = f / NCH; v < L::VOX; v += VSTEP) {
    const int rr = (v / HC) % HR, xx = v % HC;
    const int hi = min(max(at.h0 - 1 + rr, 0), a.H - 1);
    const int wi = min(max(at.w0 - 1 + xx, 0), a.W - 1);
    const bf16* src = a.x + (((size_t)plane(v) * a.H + hi) * a.W + wi) * a.Cin + ch;
#pragma unroll
    for (int q = 0; q < PIECES; ++q) cp_async16(piece(v, q), src + 8 * q);
  }
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (FUSE || QUANT) {
    float sc[PIECES][8], sh[PIECES][8];  // the thread's channels
    if constexpr (FUSE) {
#pragma unroll
      for (int q = 0; q < PIECES; ++q) {
        load8(a.scale, ch + 8 * q, sc[q]);
        load8(a.shift, ch + 8 * q, sh[q]);
      }
    }
    for (int v0 = f / NCH; v0 < L::VOX; v0 += VSTEP * NB) {
      uint4 r[NB][PIECES];
      bool tr[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int v = v0 + u * VSTEP;
        tr[u] = v < L::VOX && plane(v) >= a.prefix;
#pragma unroll
        for (int q = 0; q < PIECES; ++q)
          r[u][q] = v < L::VOX ? *reinterpret_cast<const uint4*>(piece(v, q))
                               : make_uint4(0, 0, 0, 0);
      }
      if constexpr (FUSE) {
        uint4 tv[NB][PIECES];
        bool rare = false;
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int q = 0; q < PIECES; ++q)
            tv[u][q] = transform8<false>(r[u][q], sc[q], sh[q], a.act, rare);
        if (rare) {
#pragma unroll
          for (int u = 0; u < NB; ++u)
#pragma unroll
            for (int q = 0; q < PIECES; ++q)
              tv[u][q] = transform8<true>(r[u][q], sc[q], sh[q], a.act, rare);
        }
#pragma unroll
        for (int u = 0; u < NB; ++u)
#pragma unroll
          for (int q = 0; q < PIECES; ++q) r[u][q] = tr[u] ? tv[u][q] : r[u][q];
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int v = v0 + u * VSTEP;
        if (v < L::VOX) {
          uint4 out = r[u][0];
          if constexpr (QUANT) out = quant16(r[u][0], r[u][1], inv);
          *reinterpret_cast<uint4*>(halo + c * L::CH + v * 16) = out;
        }
      }
    }
  }
}

template <bool FUSE, bool QUANT>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_kernel(const __grid_constant__ CUtensorMap wmap, const ConvArgs a) {
  using L = Tile<QUANT>;
  using Acc = typename std::conditional<QUANT, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t wfull[NS], wempty[NS], hfull[2], hempty[2];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* halo = smem + NS * WSTAGE;
  uint8_t* raw = halo + 2 * L::HALO;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&hfull[b], FILLERS);
      mbar_init(&hempty[b], CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int n_slices = a.Cin / (QUANT ? 64 : 32);
  const int wg = tid / 128;

  if (wg == 0) {
    // ---- producers: thread 0 keeps the weight ring full, warps 1-3 stage
    // the halo ----
    regs_dealloc<152>();
    if (tid == 0) {
      tma_prefetch_map(&wmap);
      uint32_t wc = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const int n0 = (item % a.n_cb) * BN;
        for (int k = 0; k < n_slices; ++k)
          for (int tap = 0; tap < 27; ++tap, ++wc) {
            const int s = wc % NS;
            mbar_wait(&wempty[s], ((wc / NS) & 1) ^ 1);
            mbar_expect_tx(&wfull[s], WSTAGE);
            tma_load_3d(ring + s * WSTAGE, &wmap, &wfull[s], k * (QUANT ? 64 : 32),
                        n0, tap);
          }
      }
    } else if (tid >= 32) {
      const int f = tid - 32;
      uint32_t hc = 0;
      for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
        const TileAt at = tile_at<QUANT>(a, item);
        float inv = 0.f;
        if (QUANT)
          inv = a.tile_inv[((size_t)at.t0 * (a.H >> 3) + (at.h0 >> 3)) * (a.W / a.bw) +
                           at.w0 / a.bw];
        for (int k = 0; k < n_slices; ++k, ++hc) {
          const int b = hc & 1;
          mbar_wait(&hempty[b], ((hc >> 1) & 1) ^ 1);
          fill_halo<FUSE, QUANT>(halo + b * L::HALO, raw, a, at, k, inv, f);
          fence_proxy_async();  // the generic-proxy stores, before wgmma reads
          mbar_arrive(&hfull[b]);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  regs_alloc<176>();
  const int w = wg - 1;
  const int tw = tid - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31;
  // each m64 block g of this warpgroup: plane tp, column group cg; its base
  // in 16-byte units inside a halo buffer
  int gtp[L::G], gcg[L::G];
  uint32_t gbase[L::G];
#pragma unroll
  for (int g = 0; g < L::G; ++g) {
    const int q = w * L::G + g;
    gtp[g] = q / (TC / 8);
    gcg[g] = q % (TC / 8);
    gbase[g] = (gtp[g] * HR * HC + gcg[g] * 8);
  }
  const uint32_t ring_a = smem_u32(ring), halo_a = smem_u32(halo);
  Acc acc[L::G][64];
  uint32_t wc = 0, hc = 0;

  for (int item = blockIdx.x; item < a.n_items; item += gridDim.x) {
    const TileAt at = tile_at<QUANT>(a, item);
    for (int k = 0; k < n_slices; ++k, ++hc) {
      const int b = hc & 1;
      mbar_wait(&hfull[b], (hc >> 1) & 1);
      const uint64_t da = smem_desc(halo_a + b * L::HALO, L::CH, HC * 16, 0);
      int prev = 0;
#pragma unroll
      for (int tap = 0; tap < 27; ++tap, ++wc) {
        const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
        const int s = wc % NS;
        mbar_wait(&wfull[s], (wc / NS) & 1);
        const uint64_t db = smem_desc(ring_a + s * WSTAGE, 16, 512, 2);
#pragma unroll
        for (int g = 0; g < L::G; ++g) fence_regs(acc[g]);
        wgmma_fence();
#pragma unroll
        for (int g = 0; g < L::G; ++g) {
          const uint64_t dag = da + gbase[g] + (dt * HR + dh) * HC + dw;
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int accumulate = (k | tap | kk) != 0;
            if constexpr (QUANT)
              wgmma_m64n128k32_s8_ss(acc[g], dag + kk * 2 * (L::CH / 16), db + kk * 2,
                                     accumulate);
            else
              wgmma_m64n128k16_ss(acc[g], dag + kk * 2 * (L::CH / 16), db + kk * 2,
                                  accumulate);
          }
        }
        wgmma_commit();
        if (tap > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&wempty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int g = 0; g < L::G; ++g) fence_regs(acc[g]);
      if (lane == 0) {
        mbar_arrive(&wempty[prev]);
        mbar_arrive(&hempty[b]);
      }
    }

    // epilogue: row 16 warp + lane / 4 + 8 half of an m64 block is output
    // row 2 warp + half, column 8 cg + lane / 4 of the tile
    float s = 0.f;
    if (QUANT)
      s = a.tile_s[((size_t)at.t0 * (a.H >> 3) + (at.h0 >> 3)) * (a.W / a.bw) +
                   at.w0 / a.bw];
    const int t4 = lane & 3;
#pragma unroll
    for (int g = 0; g < L::G; ++g) {
      const int t = at.t0 + gtp[g];
      const int col = at.w0 + gcg[g] * 8 + (lane >> 2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = at.h0 + 2 * warp + half;
        if (t >= a.T || h >= a.H || col >= a.W) continue;
        bf16* yrow = a.y + (((size_t)t * a.H + h) * a.W + col) * a.Cout + at.n0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = 8 * j + 2 * t4;
          const int nn = at.n0 + n;
          float v0, v1;
          if constexpr (QUANT) {
            v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[g][4 * j + 2 * half]),
                                     __fmul_rn(s, a.ws[nn])), a.bias[nn]);
            v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[g][4 * j + 2 * half + 1]),
                                     __fmul_rn(s, a.ws[nn + 1])), a.bias[nn + 1]);
          } else {
            v0 = acc[g][4 * j + 2 * half] + a.bias[nn];
            v1 = acc[g][4 * j + 2 * half + 1] + a.bias[nn + 1];
          }
          *reinterpret_cast<uint32_t*>(yrow + n) = pack_f2(v0, v1);
        }
      }
    }
  }
}

// ---- K3's W8A8 window maxima ---------------------------------------------------
//
// s[t, hb, wb] = max(m, 1e-8) / 127 and inv = 1 / s, where m is the largest
// |f(x)| over the TPU window of tile (t, hb, wb): 3 planes (t .. t + 2 of the
// time-padded input), 10 rows [8 hb - 1, 8 hb + 9) and the columns [wb bw - 1,
// wb bw + bw + 7), clamped, all channels (conv_pallas.py:183-198). f is the
// prologue on planes >= prefix with FUSE (transform8<false>, redone with
// EXACT where ``rare`` is set, as K3's producer applies it, so these are the
// maxima of the very values K3 quantizes), else the identity.
//
// Two kernels, the second a programmatic dependent launch of the first:
//   * window_rowmax_kernel, a persistent grid of warps: a warp takes one row
//     of one W window at a time, (bw + 8) x Cin contiguous bf16, and leaves
//     its max |f(x)| in rowmax[p, h, wb]. Every element is read and
//     transformed once (the 8 columns two windows share, twice), which
//     matters: with the prologue the cost is issue (about 20 instructions an
//     element), not bytes. A lane's 16-byte pieces are lane + 32 u (u < U)
//     of each 32 U-piece step, so its channels are fixed (two sets at Cin
//     512) and its scales and shifts live in registers. The max is kept on
//     |bf16| bit patterns (the sign cleared: a non-negative bf16 orders as
//     its bits), two 16-bit lanes a register. Bytes stay in flight as U
//     independent 16-byte loads a lane (1-D bulk copies of the row's steps
//     into a ring of shared-memory stages a warp measured slower, PERF.md
//     §6). U is 4 without the prologue and 2 with it, where the registers of
//     4 pieces in flight through the prologue would spill at the occupancy
//     that hides its latencies.
//     With the prologue a step first bounds |f| over its pieces from the
//     affine part alone (piece_bound: four instructions an element against
//     about twenty for the whole prologue) and skips the prologue when every
//     bound is below the row's max so far (the warp's, after every step), for
//     then no piece can raise it: the maxima stay exactly those of the
//     transformed values, and on data whose maxima are not all at the end
//     of a row most steps skip the exponentials and reciprocals.
//   * window_scale_kernel: a thread a tile gathers its 3 planes x 10 rows of
//     rowmax (from L2) and writes s and inv. It is launched with programmatic
//     stream serialization, so it is resident while the first kernel drains
//     and waits on griddepcontrol.wait for its results. Keeping a band's row
//     maxima in shared memory instead would make each block read, and
//     transform, its two halo rows again (a quarter more at 8 rows a band).
constexpr int WIN_THREADS = 256;
// pieces in flight a lane and blocks an SM, without and with the prologue
constexpr int WIN_U = 4, WIN_U_FUSE = 2;
constexpr int WIN_BLOCKS = 4, WIN_BLOCKS_FUSE = 3;

struct WinArgs {
  const bf16* x;
  const float* scale;
  const float* shift;
  uint32_t* rowmax;  // (T_in, H, W / bw): bits of the max |f(x)| of a row
  float* s;
  float* inv;
  int T_in, T, H, W, Cin, bw, nw, time_padded, act, prefix, rows;
};

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The running max of |v| (bf16 bit patterns, sign cleared) over 8 values.
__device__ __forceinline__ uint32_t absmax8(const uint4& r, uint32_t m) {
  const uint32_t k = 0x7fff7fffu;
  return max_u16x2(m, max_u16x2(max_u16x2(r.x & k, r.y & k),
                                max_u16x2(r.z & k, r.w & k)));
}

// max(a, b), NaN when either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// A bound on |f| over the 8 values of a piece, from the prologue's affine y
// = v * s + h (the rounded operations of transform8): max |y|, and at least
// 0.28 with SiLU (silu(y) <= y for y >= 0 and |silu(y)| < 0.28 for finite
// y < 0, so too after the monotone roundings to fp32 and bf16); NaN when a
// y is. A y of -inf, whose silu is NaN (-inf * 0), bounds at +inf, which no
// running max exceeds strictly, so that its piece is always transformed.
__device__ __forceinline__ float piece_bound(const uint4& r, const float (&s)[8],
                                             const float (&h)[8], int act) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
  float top = act ? 0.28f : 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_f2(w[j]);
    const float y0 = __fadd_rn(__fmul_rn(f.x, s[2 * j]), h[2 * j]);
    const float y1 = __fadd_rn(__fmul_rn(f.y, s[2 * j + 1]), h[2 * j + 1]);
    top = max_nan(top, fabsf(y0));
    top = max_nan(top, fabsf(y1));
  }
  return top;
}

// Fold pieces r[0..U) into the running max m: with ``tr`` through the
// prologue (piece u with channel set u & 1 under TWO; the EXACT redo of all
// U where any is rare), unless every piece's bound is below ``t``, the
// row's max so far, in which case none can raise it and none is
// transformed; a piece with ok false is left out.
template <bool FUSE, bool TWO, int U>
__device__ __forceinline__ uint32_t fold_pieces(const uint4 (&r)[U],
                                                const bool (&ok)[U], bool tr,
                                                const float (&sc)[2][8],
                                                const float (&sh)[2][8], int act,
                                                float t, uint32_t m) {
  static_assert(!TWO || U % 2 == 0, "two channel sets alternate piece by piece");
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = r[u];
  if (FUSE && tr) {
    bool need = false;
#pragma unroll
    for (int u = 0; u < U; ++u)
      need |= ok[u] && !(piece_bound(r[u], sc[TWO ? u & 1 : 0], sh[TWO ? u & 1 : 0],
                                     act) < t);
    if (!need) return m;
    bool rare = false;
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = transform8<false>(r[u], sc[TWO ? u & 1 : 0], sh[TWO ? u & 1 : 0], act, rare);
    if (rare) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = transform8<true>(r[u], sc[TWO ? u & 1 : 0], sh[TWO ? u & 1 : 0], act,
                                rare);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u]) m = absmax8(v[u], m);
  return m;
}

// The warp's max so far as a float (a bf16 value), from each lane's m.
__device__ __forceinline__ float warp_max(uint32_t m) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, max(m & 0xffffu, m >> 16))
                         << 16);
}

// Row window r = (p * H + h) * nw + wb: its first element and its pieces.
__device__ __forceinline__ const bf16* row_at(const WinArgs& a, int r, int& n16, int& p) {
  const int wb = r % a.nw;
  const int h = (r / a.nw) % a.H;
  p = r / (a.nw * a.H);
  const int c_lo = max(wb * a.bw - 1, 0);
  const int c_hi = min(wb * a.bw + a.bw + 6, a.W - 1);
  n16 = (c_hi - c_lo + 1) * (a.Cin / 8);
  return a.x + (((size_t)p * a.H + h) * a.W + c_lo) * a.Cin;
}

template <bool FUSE, bool TWO>
__global__ void __launch_bounds__(WIN_THREADS, FUSE ? WIN_BLOCKS_FUSE : WIN_BLOCKS)
window_rowmax_kernel(const WinArgs a) {
  constexpr int U = FUSE ? WIN_U_FUSE : WIN_U;
  constexpr int STEP = 32 * U;  // pieces of one warp step
  // the scale kernel may be scheduled now; it waits for this grid's results
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (WIN_THREADS / 32);
  float sc[2][8] = {}, sh[2][8] = {};
  if (FUSE) {
#pragma unroll
    for (int q = 0; q < (TWO ? 2 : 1); ++q) {
      const int c = ((lane + 32 * q) * 8) % a.Cin;
      load8(a.scale, c, sc[q]);
      load8(a.shift, c, sh[q]);
    }
  }
  for (int r = blockIdx.x * (WIN_THREADS / 32) + (threadIdx.x >> 5); r < a.rows;
       r += warps) {
    int n16, p;
    const uint4* row = reinterpret_cast<const uint4*>(row_at(a, r, n16, p));
    const bool tr = p >= a.prefix;
    uint32_t m = 0;
    float t = 0.f;  // the row's max so far (with the prologue)
    for (int j0 = 0; j0 < n16; j0 += STEP) {
      uint4 v[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + lane + 32 * u;
        ok[u] = j < n16;
        v[u] = ok[u] ? __ldg(row + j) : make_uint4(0, 0, 0, 0);
      }
      m = fold_pieces<FUSE, TWO, U>(v, ok, tr, sc, sh, a.act, t, m);
      if (FUSE) t = warp_max(m);
    }
    m = __reduce_max_sync(0xffffffffu, max(m & 0xffffu, m >> 16));
    if (lane == 0) a.rowmax[r] = m;
  }
}

// A thread a tile (t, hb, wb): the max of its window's 3 planes x 10 rows of
// rowmax, then s and inv.
__global__ void __launch_bounds__(256) window_scale_kernel(const WinArgs a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int nh = a.H >> 3;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= a.T * nh * a.nw) return;
  const int wb = idx % a.nw, hb = (idx / a.nw) % nh, t = idx / (a.nw * nh);
  uint32_t bits = 0;
  for (int dt = 0; dt < 3; ++dt) {
    const int p = a.time_padded ? t + dt : max(t + dt - 2, 0);
    for (int r = 8 * hb - 1; r <= 8 * hb + 8; ++r) {
      const int rr = min(max(r, 0), a.H - 1);
      bits = max(bits, __ldcg(a.rowmax + ((size_t)p * a.H + rr) * a.nw + wb));
    }
  }
  const float m = __uint_as_float(bits << 16);
  // max(m, 1e-8) keeping a NaN, as torch's clamp_min does
  const float sv = __fdiv_rn(m < 1e-8f ? 1e-8f : m, 127.f);
  a.s[idx] = sv;
  a.inv[idx] = __fdiv_rn(1.f, sv);
}

template <bool FUSE, bool TWO>
int launch_windows(const WinArgs& a, cudaStream_t st) {
  // per device: the blocks a persistent grid may hold
  static int slots[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (slots[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_rowmax_kernel<FUSE, TWO>, WIN_THREADS, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots[dev] = per_sm * sms;
  }
  const int need = (a.rows + WIN_THREADS / 32 - 1) / (WIN_THREADS / 32);
  window_rowmax_kernel<FUSE, TWO>
      <<<need < slots[dev] ? need : slots[dev], WIN_THREADS, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = a.T * (a.H / 8) * a.nw;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, window_scale_kernel, a);
}

template <bool FUSE, bool QUANT>
int launch_conv(const void* x, const void* w, const void* bias, const void* scale,
                const void* shift, const void* ws, const void* s, const void* inv,
                void* y, int T, int H, int W, int Cin, int Cout, int time_padded,
                int act, int prefix, int bw, void* stream) {
  using L = Tile<QUANT>;
  if (T < 1 || H < 1 || W < 1 || Cout % BN != 0 || Cin % (QUANT ? 64 : 32) != 0 ||
      (QUANT && (bw % TC != 0 || H % TR != 0 || W % bw != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  int err = QUANT ? kmajor_sw64_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Cin,
                                    Cout, 27, 64, BN)
                  : kmajor_sw64_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                    Cin, Cout, 27, 32, BN);
  if (err != 0) return err;
  // the attribute is set per device, so once for each device used; the SM
  // count sets the persistent grid
  static int sms[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaFuncSetAttribute(conv3d_kernel<FUSE, QUANT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  ConvArgs a;
  a.x = (const bf16*)x;
  a.bias = (const float*)bias;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.ws = (const float*)ws;
  a.tile_s = (const float*)s;
  a.tile_inv = (const float*)inv;
  a.y = (bf16*)y;
  a.T = T, a.H = H, a.W = W, a.Cin = Cin, a.Cout = Cout;
  a.time_padded = time_padded, a.act = act, a.prefix = prefix, a.bw = bw;
  a.n_h = (H + TR - 1) / TR;
  a.n_w = (W + TC - 1) / TC;
  a.n_cb = Cout / BN;
  const long long items =
      (long long)((T + L::TP - 1) / L::TP) * a.n_h * a.n_w * a.n_cb;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.n_items = (int)items;
  const int grid = (int)(items < sms[dev] ? items : sms[dev]);
  conv3d_kernel<FUSE, QUANT><<<grid, THREADS, L::SMEM, (cudaStream_t)stream>>>(wmap, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (T_in, H, W, Cin) bf16 with T_in = T + 2 when time_padded else T;
// w27 (27, Cout, Cin) bf16; bias (Cout,) fp32; y (T, H, W, Cout) bf16.
extern "C" int k5_conv3d(const void* x, const void* w27, const void* bias,
                         void* y, int T, int H, int W, int Cin, int Cout,
                         int time_padded, void* stream) {
  return launch_conv<false, false>(x, w27, bias, nullptr, nullptr, nullptr,
                                   nullptr, nullptr, y, T, H, W, Cin, Cout,
                                   time_padded, 0, 0, 1, stream);
}

// As k5_conv3d, with the prologue: scale/shift (Cin,) fp32, act, prefix.
extern "C" int k5_conv3d_fused(const void* x, const void* w27, const void* bias,
                               const void* scale, const void* shift, void* y,
                               int T, int H, int W, int Cin, int Cout,
                               int time_padded, int act, int prefix,
                               void* stream) {
  return launch_conv<true, false>(x, w27, bias, scale, shift, nullptr, nullptr,
                                  nullptr, y, T, H, W, Cin, Cout, time_padded,
                                  act, prefix, 1, stream);
}

// The W8A8 scales: s, inv (T, H / 8, W / bw) fp32 out, T = T_in - 2 when
// time_padded else T_in; rowmax (T_in, H, W / bw) 32-bit scratch;
// scale/shift are read only with fuse. Two launches: the row maxima, then,
// dependent on them, the tiles.
extern "C" int k5_conv3d_window_scale(const void* x, const void* scale,
                                      const void* shift, void* rowmax, void* s,
                                      void* inv, int T_in, int H, int W, int Cin,
                                      int bw, int time_padded, int fuse, int act,
                                      int prefix, void* stream) {
  // a lane's channels are fixed: Cin divides 32 * 8 * 2 (two sets at 512)
  if (Cin % 8 != 0 || 512 % Cin != 0 || H % 8 != 0 || bw < 1 || W % bw != 0 ||
      T_in < (time_padded ? 3 : 1) || (long long)T_in * H * (W / bw) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  WinArgs a;
  a.x = (const bf16*)x;
  a.scale = (const float*)scale;
  a.shift = (const float*)shift;
  a.rowmax = (uint32_t*)rowmax;
  a.s = (float*)s;
  a.inv = (float*)inv;
  a.T_in = T_in;
  a.T = time_padded ? T_in - 2 : T_in;
  a.H = H, a.W = W, a.Cin = Cin, a.bw = bw, a.nw = W / bw;
  a.time_padded = time_padded, a.act = act, a.prefix = fuse ? prefix : T_in;
  a.rows = T_in * H * a.nw;
  cudaStream_t st = (cudaStream_t)stream;
  if (!fuse) return launch_windows<false, false>(a, st);
  return Cin > 256 ? launch_windows<true, true>(a, st)
                   : launch_windows<true, false>(a, st);
}

// W8A8 conv: w8 (27, Cout, Cin) int8, ws (Cout,) fp32, s/inv from
// k5_conv3d_window_scale, bw the TPU W tile; the prologue with fuse.
extern "C" int k5_conv3d_quant(const void* x, const void* w8, const void* ws,
                               const void* bias, const void* scale,
                               const void* shift, const void* s, const void* inv,
                               void* y, int T, int H, int W, int Cin, int Cout,
                               int bw, int time_padded, int fuse, int act,
                               int prefix, void* stream) {
  if (fuse)
    return launch_conv<true, true>(x, w8, bias, scale, shift, ws, s, inv, y, T, H,
                                   W, Cin, Cout, time_padded, act, prefix, bw,
                                   stream);
  return launch_conv<false, true>(x, w8, bias, nullptr, nullptr, ws, s, inv, y, T,
                                  H, W, Cin, Cout, time_padded, 0, 0, bw, stream);
}
