// K3: 3x3x3 stride-1 time-causal convolution with replicate padding, as
// an implicit GEMM (the VAE decoder's 3x3x3 convs between 128 and 512
// channels), in all the TPU kernel's modes.
//
// Replaces kandinsky5_tpu/ops/conv_pallas.py _kernel (reached via
// _conv_fused and causal_conv3d_fused):
//   y[t,h,w,:] = bias + sum_{dt,dh,dw} f(x[t',h',w',:]) . W[dt,dh,dw]
// where, unpadded, t' = max(t + dt - 2, 0) (two replicated leading frames)
// and, time_padded, t' = t + dt over an input that already carries two
// history frames; h' = clamp(h + dh - 1), w' = clamp(w + dw - 1). The
// replicate padding is an index clamp inside the kernel, so no padded copy
// of the activation is ever written (the TPU path materialized one, with
// extra W columns for its DMA alignment). f is the identity, or with FUSE
// the folded GroupNorm + SiLU prologue (conv_pallas.py:163-182): v * scale[c]
// + shift[c] in fp32, then (act) y * sigmoid(y), rounded to bf16 once;
// input planes t' < prefix (the streaming decode's carried history) pass
// untouched. The prologue commutes with the replicate padding, so it is
// applied to the clamped gather.
//
// QUANT (W8A8, conv_pallas.py:183-230): the weight arrives as int8 (27,
// Cout, Cin) with per-Cout scales ws; the activation f(x) is quantized with
// the scale of its OUTPUT voxel's TPU tile (t, h / 8, w / bw), q =
// rint(f(x) * inv) (no clip), the s8 x s8 products sum exactly in int32,
// and y = float(acc) * (s * ws[n]) + bias[n]. The TPU kernel quantizes one
// halo window per tile and reuses it for the tile's 27 taps; this kernel's
// tiles are 128 flattened voxels, so each gathered row is quantized with its
// own voxel's tile scale, which gives the same codes. The scales come from
// window_rowmax_kernel + window_scale_kernel below: the max |f(x)| over the
// TPU window (3 planes, rows [8 hb - 1, 8 hb + 9), columns [wb bw - 1,
// wb bw + bw + 7), clamped), part of K3's body on the TPU.
//
// Bound on the H100: tensor-core rate (27 * Cin MACs per output channel
// and voxel; int8 at twice the bf16 rate); the activation is re-read 27
// times, from L2. Design: output tiles of 128 voxels (flattened t,h,w, so
// any W works) x 128 output channels; the K loop walks 27 taps x channel
// slices of 64 bytes (32 bf16 or 64 int8 channels), each thread gathering
// its two rows' 16-byte pieces at the clamped tap address, transforming and
// quantizing them in registers before the shared-memory store. So the
// prologue and the quantization run once per tap, 27 times per input
// element (the TPU kernel transforms each halo window once): simple first,
// its cost is in PERF.md. fp32 (int32) accumulation in registers; the
// epilogue adds the bias (and dequantizes). The weight is read as (27,
// Cout, Cin), the K-contiguous B operand.
#include <type_traits>

#include "common.cuh"

namespace {
using namespace k5;

constexpr int ROWB = GST * 2;  // shared-memory row stride in bytes (80)

// The prologue of one value: fp32 affine without contraction, then SiLU as
// torch computes it on the card (y * (1 / (1 + exp(-y)))).
__device__ __forceinline__ float prologue(float v, float sc, float sh, int act) {
  float y = __fadd_rn(__fmul_rn(v, sc), sh);
  if (act) y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
  return y;
}

// The prologue on 8 bf16 channels c..c+7 of a 16-byte piece, rounded to
// bf16.
__device__ __forceinline__ uint4 transform8(uint4 r, const float* __restrict__ scale,
                                            const float* __restrict__ shift, int c,
                                            int act) {
  const float4 s0 = *reinterpret_cast<const float4*>(scale + c);
  const float4 s1 = *reinterpret_cast<const float4*>(scale + c + 4);
  const float4 h0 = *reinterpret_cast<const float4*>(shift + c);
  const float4 h1 = *reinterpret_cast<const float4*>(shift + c + 4);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  uint32_t* u = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = unpack_f2(u[j]);
    u[j] = pack_f2(prologue(f.x, s[2 * j], h[2 * j], act),
                   prologue(f.y, s[2 * j + 1], h[2 * j + 1], act));
  }
  return r;
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

// The int8 counterpart of common.cuh's gemm_stage: one 64-byte-deep stage
// of s8 x s8 -> s32 products, the same warp layout and byte offsets.
__device__ __forceinline__ void gemm_stage_s8(const uint8_t* As, const uint8_t* Bs,
                                              int acc[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const uint8_t* p = As + (wm * 64 + mt * 16 + g) * ROWB + ks * 32 + 4 * t;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * ROWB);
      a[mt][2] = ld32(p + 16);
      a[mt][3] = ld32(p + 8 * ROWB + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint8_t* p = Bs + (wn * 32 + nt * 8 + g) * ROWB + ks * 32 + 4 * t;
      b[nt][0] = ld32(p);
      b[nt][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

template <bool FUSE, bool QUANT>
__global__ void __launch_bounds__(256)
conv3d_kernel(const bf16* __restrict__ x, const void* __restrict__ wv,
              const float* __restrict__ bias, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ ws,
              const float* __restrict__ tile_s, const float* __restrict__ tile_inv,
              bf16* __restrict__ y, int T, int H, int W, int Cin, int Cout,
              int time_padded, int act, int prefix, int bw) {
  __shared__ __align__(16) uint8_t As[GM * ROWB];
  __shared__ __align__(16) uint8_t Bs[GN * ROWB];
  using Acc = typename std::conditional<QUANT, int, float>::type;
  // channels per 64-byte stage, and per 16-byte piece of a stage row
  constexpr int KC = QUANT ? 64 : 32, PC = KC / 4;

  const int n0 = blockIdx.y * GN;
  const long long m0 = (long long)blockIdx.x * GM;
  const long long M = (long long)T * H * W;  // output voxels
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nh = H >> 3, nw = QUANT ? W / bw : 1;

  int vt[2], vh[2], vw[2], cp[2];
  bool valid[2];
  float inv[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 256, row = idx >> 2;
    cp[i] = (idx & 3) * PC;
    const long long m = m0 + row;
    valid[i] = m < M;
    const long long mm = valid[i] ? m : 0;
    vw[i] = (int)(mm % W);
    vh[i] = (int)((mm / W) % H);
    vt[i] = (int)(mm / ((long long)W * H));
    if (QUANT) inv[i] = tile_inv[((size_t)vt[i] * nh + (vh[i] >> 3)) * nw + vw[i] / bw];
  }

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  uint4 ar[2], br[2];
  const int ncs = Cin / KC;
  auto load = [&](int kt) {
    const int tap = kt / ncs, c0 = (kt % ncs) * KC;
    const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 r = make_uint4(0, 0, 0, 0);
      if (valid[i]) {
        const int ti = time_padded ? vt[i] + dt : max(vt[i] + dt - 2, 0);
        const int hi = min(max(vh[i] + dh - 1, 0), H - 1);
        const int wi = min(max(vw[i] + dw - 1, 0), W - 1);
        const int c = c0 + cp[i];
        const bf16* src = x + (((size_t)ti * H + hi) * W + wi) * Cin + c;
        const bool tr = FUSE && ti >= prefix;
        r = *reinterpret_cast<const uint4*>(src);
        if (tr) r = transform8(r, scale, shift, c, act);
        if (QUANT) {
          uint4 r1 = *reinterpret_cast<const uint4*>(src + 8);
          if (tr) r1 = transform8(r1, scale, shift, c + 8, act);
          r = quant16(r, r1, inv[i]);
        }
      }
      ar[i] = r;
    }
    if (QUANT) {
      const uint8_t* w8 = reinterpret_cast<const uint8_t*>(wv) + (size_t)tap * Cout * Cin;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * 256, row = idx >> 2;
        br[i] = *reinterpret_cast<const uint4*>(w8 + (size_t)(n0 + row) * Cin + c0 +
                                                (idx & 3) * 16);
      }
    } else {
      load_b_regs(reinterpret_cast<const bf16*>(wv) + (size_t)tap * Cout * Cin, Cin,
                  n0, c0, br);
    }
  };

  const int nk = 27 * ncs;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    store_stage_regs(reinterpret_cast<bf16*>(As), ar);
    store_stage_regs(reinterpret_cast<bf16*>(Bs), br);
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
    if constexpr (QUANT)
      gemm_stage_s8(As, Bs, acc);
    else
      gemm_stage(reinterpret_cast<const bf16*>(As), reinterpret_cast<const bf16*>(Bs),
                 acc);
  }

  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
      float s = 0.f;
      if (QUANT) {
        const int ow = (int)(m % W), oh = (int)((m / W) % H);
        const int ot = (int)(m / ((long long)W * H));
        s = tile_s[((size_t)ot * nh + (oh >> 3)) * nw + ow / bw];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * t;
        float v0, v1;
        if constexpr (QUANT) {
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]),
                                   __fmul_rn(s, ws[n])), bias[n]);
          v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                                   __fmul_rn(s, ws[n + 1])), bias[n + 1]);
        } else {
          v0 = acc[mt][nt][2 * half] + bias[n];
          v1 = acc[mt][nt][2 * half + 1] + bias[n + 1];
        }
        *reinterpret_cast<uint32_t*>(y + m * Cout + n) = pack_f2(v0, v1);
      }
    }
}

// rowmax[p, h, wb] = max |f(x[p, h, w, c])| over the columns [wb bw - 1,
// wb bw + bw + 6] (clamped) of TPU W tile wb and all channels: one block
// per (wb, h, p). The columns of a window are contiguous in memory.
template <bool FUSE>
__global__ void __launch_bounds__(256)
window_rowmax_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ rowmax,
                     int H, int W, int Cin, int bw, int act, int prefix) {
  const int wb = blockIdx.x, h = blockIdx.y, p = blockIdx.z, nw = gridDim.x;
  const int c_lo = max(wb * bw - 1, 0), c_hi = min(wb * bw + bw + 6, W - 1);
  const int n = (c_hi - c_lo + 1) * (Cin / 8);
  const bf16* row = x + (((size_t)p * H + h) * W + c_lo) * Cin;
  const bool tr = FUSE && p >= prefix;
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += 256) {
    uint4 r = *reinterpret_cast<const uint4*>(row + (size_t)i * 8);
    if (tr) r = transform8(r, scale, shift, (i * 8) % Cin, act);
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack_f2(u[j]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < 8; ++i) m = fmaxf(m, part[i]);
    rowmax[((size_t)p * H + h) * nw + wb] = m;
  }
}

// One thread per TPU tile (t, hb, wb): m = max of rowmax over the window's
// 3 planes and 10 rows; s = max(m, 1e-8) / 127, inv = 1 / s.
__global__ void __launch_bounds__(256)
window_scale_kernel(const float* __restrict__ rowmax, float* __restrict__ s,
                    float* __restrict__ inv, int T, int H, int nw, int time_padded) {
  const int nh = H >> 3;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= T * nh * nw) return;
  const int wb = idx % nw, hb = (idx / nw) % nh, t = idx / (nw * nh);
  float m = 0.f;
  for (int dt = 0; dt < 3; ++dt) {
    const int p = time_padded ? t + dt : max(t + dt - 2, 0);
    for (int r = 8 * hb - 1; r <= 8 * hb + 8; ++r) {
      const int rr = min(max(r, 0), H - 1);
      m = fmaxf(m, rowmax[((size_t)p * H + rr) * nw + wb]);
    }
  }
  const float sv = __fdiv_rn(fmaxf(m, 1e-8f), 127.f);
  s[idx] = sv;
  inv[idx] = __fdiv_rn(1.f, sv);
}

template <bool FUSE, bool QUANT>
int launch_conv(const void* x, const void* w, const void* bias, const void* scale,
                const void* shift, const void* ws, const void* s, const void* inv,
                void* y, int T, int H, int W, int Cin, int Cout, int time_padded,
                int act, int prefix, int bw, void* stream) {
  const long long M = (long long)T * H * W;
  dim3 grid((unsigned)((M + GM - 1) / GM), Cout / GN);
  conv3d_kernel<FUSE, QUANT><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, w, (const float*)bias, (const float*)scale,
      (const float*)shift, (const float*)ws, (const float*)s, (const float*)inv,
      (bf16*)y, T, H, W, Cin, Cout, time_padded, act, prefix, bw);
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

// The W8A8 scales: rowmax (T_in, H, W / bw) fp32 scratch; s, inv (T, H / 8,
// W / bw) fp32 out. scale/shift are read only with fuse.
extern "C" int k5_conv3d_window_scale(const void* x, const void* scale,
                                      const void* shift, void* rowmax, void* s,
                                      void* inv, int T_in, int H, int W, int Cin,
                                      int bw, int time_padded, int fuse, int act,
                                      int prefix, void* stream) {
  const int nw = W / bw, T = time_padded ? T_in - 2 : T_in;
  const dim3 grid(nw, H, T_in);
  cudaStream_t st = (cudaStream_t)stream;
  if (fuse)
    window_rowmax_kernel<true><<<grid, 256, 0, st>>>(
        (const bf16*)x, (const float*)scale, (const float*)shift, (float*)rowmax, H,
        W, Cin, bw, act, prefix);
  else
    window_rowmax_kernel<false><<<grid, 256, 0, st>>>(
        (const bf16*)x, nullptr, nullptr, (float*)rowmax, H, W, Cin, bw, 0, 0);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int n = T * (H / 8) * nw;
  window_scale_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)rowmax, (float*)s, (float*)inv, T, H, nw, time_padded);
  return (int)cudaGetLastError();
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
