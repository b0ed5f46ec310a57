// K4: online-softmax attention with key mask and monotone segment ids, for
// 512-wide heads (the VAE mid block's frame-causal attention, with the
// streaming decoder's carried past-frame K/V).
//
// Replaces kandinsky5_tpu/ops/flash_pallas.py _kernel_online (reached via
// _flash_bhld and flash_attention(fixed_shift=False, q_ids, kv_ids)). Per
// query row i: s_ij = q_i.k_j / sqrt(d), set to -1e30 where kv_mask[j] == 0
// or q_id[i] < kv_id[j]; running max m, running sum l, acc rescaled by
// exp(m_old - m_new); out = acc / max(l, 1e-30). A key tile whose smallest
// kv id exceeds the block's largest q id is skipped (ids are
// non-decreasing), as the TPU kernel skips dead tiles. The -1e30 fill
// (not -inf) keeps fully masked rows NaN-free, with the TPU kernel's result.
//
// Bound on the H100: with d = 512 the fp32 output tile (64 rows x 512 =
// 128 KB) cannot live in one warp's registers. Design: a block = 8 warps =
// 32 query rows; the 4 warps of each 16-row band split the 512 output
// channels (128 each, 64 fp32 registers a lane) and split the 64 keys of a
// tile for the score product (16 keys each, full 512-deep contraction).
// Scores meet in shared memory; every warp of the band then recomputes the
// same row max/sum (bitwise identical) and feeds its bf16 weights to its
// 128-channel slice of P.V from registers. Q, one K tile and one V tile sit
// in shared memory (~175 KB dynamic), so one block runs per SM.
#include "common.cuh"

namespace {
using namespace k5;

constexpr int D = 512, BQ = 32, BKV = 64, ST = D + 8, SST = BKV + 4;
constexpr float NEG = -1e30f;
constexpr size_t SMEM = (size_t)(BQ + 2 * BKV) * ST * sizeof(bf16) +
                        (size_t)BQ * SST * sizeof(float) +
                        (size_t)(2 * BKV + BQ) * sizeof(int);

__global__ void __launch_bounds__(256)
flash_online_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                    const int* __restrict__ qids, const int* __restrict__ kvids,
                    bf16* __restrict__ out, int Lq, int Lk, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ST;
  bf16* Vs = Ks + BKV * ST;
  float* Ss = reinterpret_cast<float*>(Vs + BKV * ST);
  int* Kok = reinterpret_cast<int*>(Ss + BQ * SST);
  int* Kid = Kok + BKV;
  int* Qid = Kid + BKV;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int band = warp >> 2, part = warp & 3;
  const size_t rs = (size_t)H * D;
  const bf16* qb_ = q + ((size_t)b * Lq * H + h) * D;
  const bf16* kb_ = k + ((size_t)b * Lk * H + h) * D;
  const bf16* vb_ = v + ((size_t)b * Lk * H + h) * D;
  const float scale = rsqrtf((float)D);
  const int q0 = qb * BQ;

  for (int idx = tid; idx < BQ * (D / 8); idx += 256) {
    const int row = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
    uint4 r = make_uint4(0, 0, 0, 0);
    if (q0 + row < Lq) r = *reinterpret_cast<const uint4*>(qb_ + (q0 + row) * rs + c8);
    *reinterpret_cast<uint4*>(Qs + row * ST + c8) = r;
  }
  if (tid < BQ) {
    const int r = min(q0 + tid, Lq - 1);
    Qid[tid] = qids ? qids[(size_t)b * Lq + r] : 0;
  }
  // ids are non-decreasing: the block's largest q id is its last row's
  const int qmax = qids ? qids[(size_t)b * Lq + min(q0 + BQ, Lq) - 1] : 0;

  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const int lr0 = band * 16 + g, lr1 = lr0 + 8;  // local rows of this lane

  for (int kv0 = 0; kv0 < Lk; kv0 += BKV) {
    if (kvids && qmax < kvids[(size_t)b * Lk + kv0]) continue;  // dead tile
    __syncthreads();
    for (int idx = tid; idx < BKV * (D / 8); idx += 256) {
      const int row = idx / (D / 8), c8 = (idx % (D / 8)) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (kv0 + row < Lk) {
        kr = *reinterpret_cast<const uint4*>(kb_ + (kv0 + row) * rs + c8);
        vr = *reinterpret_cast<const uint4*>(vb_ + (kv0 + row) * rs + c8);
      }
      *reinterpret_cast<uint4*>(Ks + row * ST + c8) = kr;
      *reinterpret_cast<uint4*>(Vs + row * ST + c8) = vr;
    }
    if (tid < BKV) {
      const int j = kv0 + tid;
      const bool in = j < Lk;
      Kok[tid] = in && (mask == nullptr || mask[(size_t)b * Lk + j]);
      // padded keys never pass the id test (the TPU wrapper pads with 2^30)
      Kid[tid] = !in ? (1 << 30) : (kvids ? kvids[(size_t)b * Lk + j] : 0);
    }
    __syncthreads();

    // scores of this band's 16 rows against this warp's 16 keys
    {
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* ap = Qs + lr0 * ST + 2 * t;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        a[0] = ld32(ap + kk * 16);
        a[1] = ld32(ap + 8 * ST + kk * 16);
        a[2] = ld32(ap + kk * 16 + 8);
        a[3] = ld32(ap + 8 * ST + kk * 16 + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const bf16* bp = Ks + (part * 16 + nt * 8 + g) * ST + kk * 16 + 2 * t;
          mma16816(s[nt], a, ld32(bp), ld32(bp + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = part * 16 + nt * 8 + 2 * t + (e & 1);
          const int r = e < 2 ? lr0 : lr1;
          const bool ok = Kok[c] && Qid[r] >= Kid[c];
          Ss[r * SST + c] = ok ? s[nt][e] * scale : NEG;
        }
    }
    __syncthreads();

    // online softmax over the tile's 64 keys (rows lr0, lr1)
    float sv0[16], sv1[16];
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kk * 16 + 2 * t + (e & 1) + (e >> 1) * 8;
        sv0[kk * 4 + e] = Ss[lr0 * SST + c];
        sv1[kk * 4 + e] = Ss[lr1 * SST + c];
        mx0 = fmaxf(mx0, sv0[kk * 4 + e]);
        mx1 = fmaxf(mx1, sv1[kk * 4 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p0[4], p1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p0[e] = __expf(sv0[kk * 4 + e] - mn0);
        p1[e] = __expf(sv1[kk * 4 + e] - mn1);
        ps0 += p0[e];
        ps1 += p1[e];
      }
      pa[kk][0] = pack_f2(p0[0], p0[1]);
      pa[kk][1] = pack_f2(p1[0], p1[1]);
      pa[kk][2] = pack_f2(p0[2], p0[3]);
      pa[kk][3] = pack_f2(p1[2], p1[3]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }

    // this warp's 128 output channels: o += P . V
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int n = part * 128 + nt * 8 + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* vp = Vs + (kk * 16 + 2 * t) * ST + n;
        mma16816(o[nt], pa[kk], pack2(vp[0], vp[ST]), pack2(vp[8 * ST], vp[9 * ST]));
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + ((size_t)b * Lq * H + h) * D;
  const int r0 = q0 + lr0, r1 = q0 + lr1;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = part * 128 + nt * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_f2(o[nt][0] * i0, o[nt][1] * i0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) = pack_f2(o[nt][2] * i1, o[nt][3] * i1);
  }
}

}  // namespace

extern "C" int k5_flash_online(const void* q, const void* k, const void* v,
                               const void* mask, const void* qids,
                               const void* kvids, void* out, int B, int Lq,
                               int Lk, int H, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_online_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_online_kernel<<<grid, 256, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask,
      (const int*)qids, (const int*)kvids, (bf16*)out, Lq, Lk, H);
  return (int)cudaGetLastError();
}
