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
// Bound on the H100: tensor-core throughput, the QK half at the int8 rate
// (1,979 TOP/s) and the PV half at the bf16 rate (989 TFLOP/s), plus one
// exp2 per score. Design, simple for now (mma.sync, no TMA/wgmma): one
// block = 4 warps = 64 query rows of one (batch, head); each warp keeps its
// 16 int8 Q rows as m16n8k32 A fragments in registers (8 registers), the
// s32 scores stay in registers, are dequantized there and become the bf16
// A operand of the PV m16n8k16 product with no shared-memory round trip;
// K (int8), V (bf16) and each tile's 64 coefficients and mask flags pass
// through shared memory 64 keys at a time. The TPU kernel's 128-lane
// padding, transposed K and the ones column in V serve the TPU's layout and
// are not carried.
//   K5 loads a tile, waits for it, computes it: no overlap.
//   K7 is the lag-1 schedule: at step j it issues tile j+1's cp.async loads
//   (three shared-memory stages), then tile j's int8 QK and dequant, then
//   tile j-1's exp2 and PV, so two score tiles are live per warp. The
//   per-tile functions and the order of the accumulations are K5's, so K7
//   equals K5 bit for bit (the JAX package's own contract for the pair).
//   T5's modes change only what a tile does: full (K5 without the final
//   normalization), no_exp2 (p = bf16(s)), raw_pv (p = bf16(s32)), qk_only
//   (no PV: each thread adds its s32 scores into its own output lanes).
#include "common.cuh"

namespace {
using namespace k5;

constexpr int D = 64, BQ = 64, BKV = 64;
constexpr int KST = D + 16;  // int8 K row stride in bytes: conflict-free reads
constexpr int VST = D + 8;   // bf16 V row stride in elements
constexpr float NEG = -1e30f;

enum Mode { K5_NORM = 0, T5_FULL = 1, T5_NO_EXP2 = 2, T5_RAW_PV = 3, T5_QK_ONLY = 4 };

// One tile in shared memory (V as raw bf16 bits: a __shared__ object must
// have a trivial constructor).
struct __align__(16) Stage {
  int8_t k[BKV * KST];
  uint16_t vbits[BKV * VST];
  float c[BKV];  // dequant coefficient of each key
  float m[BKV];  // 1 where the key exists and is not masked
  __device__ bf16* v() { return reinterpret_cast<bf16*>(vbits); }
  __device__ const bf16* v() const { return reinterpret_cast<const bf16*>(vbits); }
};

struct Args {
  const int8_t* q8;
  const int8_t* k8;
  const bf16* v;
  const float* coeff;
  const uint8_t* mask;
  const float* shift;
  bf16* out;
  int Lq, Lk, H;
};

// Start the copies of the K and V rows of the tile at kv0 into a stage;
// rows past Lk are zero-filled (a zero V row keeps p * v finite).
__device__ __forceinline__ void issue_kv(Stage& st, const int8_t* kb,
                                         const bf16* vb, size_t rs, int kv0,
                                         int Lk, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 128, row = idx >> 2, c16 = (idx & 3) * 16;
    int8_t* dst = st.k + row * KST + c16;
    if (kv0 + row < Lk)
      cp_async16(dst, kb + (size_t)(kv0 + row) * D + c16);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * 128, row = idx >> 3, c8 = (idx & 7) * 8;
    bf16* dst = st.v() + row * VST + c8;
    if (kv0 + row < Lk)
      cp_async16(dst, vb + (size_t)(kv0 + row) * rs + c8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// Threads 0..63 fetch the coefficient and the validity of key kv0 + tid.
__device__ __forceinline__ void fetch_cm(const Args& a, int bh, int b, int kv0,
                                         int tid, float& c, float& m) {
  const int j = kv0 + tid;
  const bool ok = j < a.Lk && (a.mask == nullptr || a.mask[(size_t)b * a.Lk + j]);
  c = j < a.Lk ? a.coeff[(size_t)bh * a.Lk + j] : 0.f;
  m = ok ? 1.f : 0.f;
}

// s32 scores of this warp's 16 rows against the tile's 64 keys.
__device__ __forceinline__ void qk_tile(const Stage& st, const uint32_t qa[2][4],
                                        int g, int t, int acc[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
    const int8_t* kp = st.k + (nt * 8 + g) * KST + 4 * t;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma_s8(acc[nt], qa[kk], ld32(kp + kk * 32), ld32(kp + kk * 32 + 16));
  }
}

// The scores a mode feeds to PV: dequantized log2-domain s (masked keys at
// -1e30), or the raw s32 as float for raw_pv.
template <int MODE>
__device__ __forceinline__ void scores(const Stage& st, const int acc[8][4],
                                       float shift2, int t, float s[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (MODE == T5_RAW_PV) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = (float)acc[nt][e];
      continue;
    }
    const float c0 = st.c[c], c1 = st.c[c + 1];
    const bool v0 = st.m[c] != 0.f, v1 = st.m[c + 1] != 0.f;
    s[nt][0] = v0 ? __fsub_rn(__fmul_rn((float)acc[nt][0], c0), shift2) : NEG;
    s[nt][1] = v1 ? __fsub_rn(__fmul_rn((float)acc[nt][1], c1), shift2) : NEG;
    s[nt][2] = v0 ? __fsub_rn(__fmul_rn((float)acc[nt][2], c0), shift2) : NEG;
    s[nt][3] = v1 ? __fsub_rn(__fmul_rn((float)acc[nt][3], c1), shift2) : NEG;
  }
}

// p = bf16(exp2(s)) (bf16(s) for no_exp2 / raw_pv) as the A operand, the
// row sums of the rounded p, and o += p . V_tile.
template <int MODE>
__device__ __forceinline__ void pv_tile(const bf16* vs, const float s[8][4],
                                        int g, int t, float o[8][4], float& l0,
                                        float& l1) {
  uint32_t pa[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = (MODE == K5_NORM || MODE == T5_FULL) ? exp2f(s[nt][e]) : s[nt][e];
    const uint32_t h0 = pack_f2(p[0], p[1]), h1 = pack_f2(p[2], p[3]);
    if (MODE == K5_NORM) {
      const float2 f0 = unpack_f2(h0), f1 = unpack_f2(h1);
      l0 += f0.x + f0.y;
      l1 += f1.x + f1.y;
    }
    const int kk = nt >> 1, hi = (nt & 1) * 2;
    pa[kk][hi] = h0;
    pa[kk][hi + 1] = h1;
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = nt * 8 + g;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* vp = vs + (kk * 16 + 2 * t) * VST + n;
      mma16816(o[nt], pa[kk], pack2(vp[0], vp[VST]), pack2(vp[8 * VST], vp[9 * VST]));
    }
  }
}

// One tile's work after its scores exist in `acc` (T5's qk_only) or in `s`.
template <int MODE>
__device__ __forceinline__ void consume(const Stage& st, const int acc[8][4],
                                        const float s[8][4], int g, int t,
                                        float o[8][4], float& l0, float& l1) {
  if (MODE == T5_QK_ONLY) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] += (float)acc[nt][e];
  } else {
    pv_tile<MODE>(st.v(), s, g, t, o, l0, l1);
  }
}

__device__ __forceinline__ void load_q(const Args& a, int bh, int r0, int r1,
                                       int t, uint32_t qa[2][4]) {
  const int8_t* q0 = a.q8 + ((size_t)bh * a.Lq + r0) * D + 4 * t;
  const int8_t* q1 = a.q8 + ((size_t)bh * a.Lq + r1) * D + 4 * t;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    qa[kk][0] = r0 < a.Lq ? ld32(q0 + kk * 32) : 0u;
    qa[kk][1] = r1 < a.Lq ? ld32(q1 + kk * 32) : 0u;
    qa[kk][2] = r0 < a.Lq ? ld32(q0 + kk * 32 + 16) : 0u;
    qa[kk][3] = r1 < a.Lq ? ld32(q1 + kk * 32 + 16) : 0u;
  }
}

// out = o / max(l, 1e-30) for K5/K7, the raw o for T5's modes; bf16.
template <int MODE>
__device__ __forceinline__ void store_out(const Args& a, int b, int h, int r0,
                                          int r1, int t, const float o[8][4],
                                          float l0, float l1) {
  float n0 = 1.f, n1 = 1.f;
  if (MODE == K5_NORM) {
    n0 = fmaxf(quad_sum(l0), 1e-30f);
    n1 = fmaxf(quad_sum(l1), 1e-30f);
  }
  const size_t rs = (size_t)a.H * D;
  bf16* ob = a.out + ((size_t)b * a.Lq * a.H + h) * D;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < a.Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
          MODE == K5_NORM ? pack_f2(o[nt][0] / n0, o[nt][1] / n0)
                          : pack_f2(o[nt][0], o[nt][1]);
    if (r1 < a.Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) =
          MODE == K5_NORM ? pack_f2(o[nt][2] / n1, o[nt][3] / n1)
                          : pack_f2(o[nt][2], o[nt][3]);
  }
}

// K5 and T5: load a tile, wait, compute it.
template <int MODE>
__global__ void __launch_bounds__(128) flash_int8_kernel(Args a) {
  __shared__ Stage st;
  const int qb = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)a.H * D;
  const int8_t* kb = a.k8 + (size_t)bh * a.Lk * D;
  const bf16* vb = a.v + ((size_t)b * a.Lk * a.H + h) * D;
  const float shift2 = a.shift[0];
  const int r0 = qb * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[2][4];
  load_q(a, bh, r0, r1, t, qa);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < a.Lk; kv0 += BKV) {
    issue_kv(st, kb, vb, rs, kv0, a.Lk, tid);
    cp_async_commit();
    if (tid < BKV) fetch_cm(a, bh, b, kv0, tid, st.c[tid], st.m[tid]);
    cp_async_wait<0>();
    __syncthreads();
    int acc[8][4];
    float s[8][4];
    qk_tile(st, qa, g, t, acc);
    if (MODE != T5_QK_ONLY) scores<MODE>(st, acc, shift2, t, s);
    consume<MODE>(st, acc, s, g, t, o, l0, l1);
    __syncthreads();
  }
  store_out<MODE>(a, b, h, r0, r1, t, o, l0, l1);
}

// K7: the lag-1 pipeline over three stages (tile j+1 loading, tile j's QK,
// tile j-1's PV).
__global__ void __launch_bounds__(128) flash_int8_pipe_kernel(Args a) {
  __shared__ Stage st[3];
  const int qb = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)a.H * D;
  const int8_t* kb = a.k8 + (size_t)bh * a.Lk * D;
  const bf16* vb = a.v + ((size_t)b * a.Lk * a.H + h) * D;
  const float shift2 = a.shift[0];
  const int ntiles = (a.Lk + BKV - 1) / BKV;
  const int r0 = qb * BQ + warp * 16 + g, r1 = r0 + 8;

  float cr = 0.f, mr = 0.f;
  issue_kv(st[0], kb, vb, rs, 0, a.Lk, tid);
  cp_async_commit();
  if (tid < BKV) fetch_cm(a, bh, b, 0, tid, st[0].c[tid], st[0].m[tid]);
  uint32_t qa[2][4];
  load_q(a, bh, r0, r1, t, qa);
  cp_async_wait<0>();
  __syncthreads();
  if (ntiles > 1) {
    issue_kv(st[1], kb, vb, rs, BKV, a.Lk, tid);
    if (tid < BKV) fetch_cm(a, bh, b, BKV, tid, cr, mr);
  }
  cp_async_commit();

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  float sp[8][4];
  {
    int acc[8][4];
    qk_tile(st[0], qa, g, t, acc);
    scores<K5_NORM>(st[0], acc, shift2, t, sp);
  }
  if (ntiles > 1 && tid < BKV) {
    st[1].c[tid] = cr;
    st[1].m[tid] = mr;
  }

  for (int j = 1; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is past tile j-2's PV
    const int nx = j + 1;
    if (nx < ntiles) {
      issue_kv(st[nx % 3], kb, vb, rs, nx * BKV, a.Lk, tid);
      if (tid < BKV) fetch_cm(a, bh, b, nx * BKV, tid, cr, mr);
    }
    cp_async_commit();
    float sc[8][4];
    {
      int acc[8][4];
      qk_tile(st[j % 3], qa, g, t, acc);
      scores<K5_NORM>(st[j % 3], acc, shift2, t, sc);
    }
    pv_tile<K5_NORM>(st[(j - 1) % 3].v(), sp, g, t, o, l0, l1);
    if (nx < ntiles && tid < BKV) {
      st[nx % 3].c[tid] = cr;
      st[nx % 3].m[tid] = mr;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[nt][e] = sc[nt][e];
  }
  pv_tile<K5_NORM>(st[(ntiles - 1) % 3].v(), sp, g, t, o, l0, l1);
  store_out<K5_NORM>(a, b, h, r0, r1, t, o, l0, l1);
}

Args make_args(const void* q8, const void* k8, const void* v, const void* coeff,
               const void* mask, const void* shift, void* out, int Lq, int Lk,
               int H) {
  return Args{(const int8_t*)q8, (const int8_t*)k8, (const bf16*)v,
              (const float*)coeff, (const uint8_t*)mask, (const float*)shift,
              (bf16*)out, Lq, Lk, H};
}

}  // namespace

// q8 (B*H, Lq, 64), k8 (B*H, Lk, 64) int8; v and out (B, L, H, 64) bf16;
// coeff (B*H, Lk) fp32; mask (B, Lk) uint8 or null; shift (1,) fp32.
extern "C" int k5_flash_int8(const void* q8, const void* k8, const void* v,
                             const void* coeff, const void* mask,
                             const void* shift, void* out, int B, int Lq,
                             int Lk, int H, void* stream) {
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_int8_kernel<K5_NORM><<<grid, 128, 0, (cudaStream_t)stream>>>(
      make_args(q8, k8, v, coeff, mask, shift, out, Lq, Lk, H));
  return (int)cudaGetLastError();
}

extern "C" int k5_flash_int8_pipe(const void* q8, const void* k8, const void* v,
                                  const void* coeff, const void* mask,
                                  const void* shift, void* out, int B, int Lq,
                                  int Lk, int H, void* stream) {
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_int8_pipe_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      make_args(q8, k8, v, coeff, mask, shift, out, Lq, Lk, H));
  return (int)cudaGetLastError();
}

// T5: mode 1 full, 2 no_exp2, 3 raw_pv, 4 qk_only; no mask.
extern "C" int k5_i8_decomp(const void* q8, const void* k8, const void* v,
                            const void* coeff, const void* shift, void* out,
                            int B, int Lq, int Lk, int H, int mode,
                            void* stream) {
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  const Args a = make_args(q8, k8, v, coeff, nullptr, shift, out, Lq, Lk, H);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case T5_FULL: flash_int8_kernel<T5_FULL><<<grid, 128, 0, s>>>(a); break;
    case T5_NO_EXP2: flash_int8_kernel<T5_NO_EXP2><<<grid, 128, 0, s>>>(a); break;
    case T5_RAW_PV: flash_int8_kernel<T5_RAW_PV><<<grid, 128, 0, s>>>(a); break;
    case T5_QK_ONLY: flash_int8_kernel<T5_QK_ONLY><<<grid, 128, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
