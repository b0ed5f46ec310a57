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
// Bound on the H100: tensor-core throughput plus the exp2 per score (d = 64
// gives 128 MACs per exp2). Design: one block = 4 warps = 64 query rows of
// one (batch, head); each warp keeps its 16 Q rows as mma A fragments in
// registers for the whole kv loop, scores stay in registers (C layout ->
// A layout, no shared-memory round trip), K and V stream through shared
// memory 64 keys at a time. Layout is the JAX public (B, L, H, 64), read
// with the head stride directly (no transpose pass).
#include "common.cuh"

namespace {
using namespace k5;

constexpr int D = 64, BQ = 64, BKV = 64, KST = D + 8;
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(128)
flash_fixed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                   const float* __restrict__ shift, bf16* __restrict__ out,
                   int Lq, int Lk, int H) {
  __shared__ __align__(16) bf16 Ks[BKV * KST];
  __shared__ __align__(16) bf16 Vs[BKV * KST];
  __shared__ float Ms[BKV];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const bf16* qb_ = q + ((size_t)b * Lq * H + h) * D;
  const bf16* kb_ = k + ((size_t)b * Lk * H + h) * D;
  const bf16* vb_ = v + ((size_t)b * Lk * H + h) * D;
  const float scale2 = LOG2E * rsqrtf((float)D);
  const float shift2 = shift[0] * LOG2E;

  const int r0 = qb * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < Lq ? ld32(qb_ + r0 * rs + c) : 0u;
    qa[kk][1] = r1 < Lq ? ld32(qb_ + r1 * rs + c) : 0u;
    qa[kk][2] = r0 < Lq ? ld32(qb_ + r0 * rs + c + 8) : 0u;
    qa[kk][3] = r1 < Lq ? ld32(qb_ + r1 * rs + c + 8) : 0u;
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * 128, row = idx >> 3, c8 = (idx & 7) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (kv0 + row < Lk) {
        kr = *reinterpret_cast<const uint4*>(kb_ + (kv0 + row) * rs + c8);
        vr = *reinterpret_cast<const uint4*>(vb_ + (kv0 + row) * rs + c8);
      }
      *reinterpret_cast<uint4*>(Ks + row * KST + c8) = kr;
      *reinterpret_cast<uint4*>(Vs + row * KST + c8) = vr;
    }
    if (tid < BKV) {
      const int j = kv0 + tid;
      Ms[tid] = (j < Lk && (mask == nullptr || mask[(size_t)b * Lk + j])) ? 1.f : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kp = Ks + (nt * 8 + g) * KST + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma16816(s[nt], qa[kk], ld32(kp + kk * 16), ld32(kp + kk * 16 + 8));
    }

    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float m0 = Ms[c], m1 = Ms[c + 1];
      const float p00 = m0 != 0.f ? exp2f(s[nt][0] * scale2 - shift2) : 0.f;
      const float p01 = m1 != 0.f ? exp2f(s[nt][1] * scale2 - shift2) : 0.f;
      const float p10 = m0 != 0.f ? exp2f(s[nt][2] * scale2 - shift2) : 0.f;
      const float p11 = m1 != 0.f ? exp2f(s[nt][3] * scale2 - shift2) : 0.f;
      const uint32_t h0 = pack_f2(p00, p01), h1 = pack_f2(p10, p11);
      const float2 f0 = unpack_f2(h0), f1 = unpack_f2(h1);
      l0 += f0.x + f0.y;
      l1 += f1.x + f1.y;
      const int kk = nt >> 1;
      if (nt & 1) {
        pa[kk][2] = h0;
        pa[kk][3] = h1;
      } else {
        pa[kk][0] = h0;
        pa[kk][1] = h1;
      }
    }

#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* vp = Vs + (kk * 16 + 2 * t) * KST + n;
        mma16816(o[nt], pa[kk], pack2(vp[0], vp[KST]),
                 pack2(vp[8 * KST], vp[9 * KST]));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + ((size_t)b * Lq * H + h) * D;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_f2(o[nt][0] * i0, o[nt][1] * i0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) = pack_f2(o[nt][2] * i1, o[nt][3] * i1);
  }
}

}  // namespace

extern "C" int k5_flash_fixed(const void* q, const void* k, const void* v,
                              const void* mask, const void* shift, void* out,
                              int B, int Lq, int Lk, int H, void* stream) {
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fixed_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (const float*)shift, (bf16*)out, Lq, Lk, H);
  return (int)cudaGetLastError();
}
