// K3: 3x3x3 stride-1 time-causal convolution with replicate padding, as
// an implicit GEMM (the VAE decoder's 3x3x3 convs between 128 and 512
// channels).
//
// Replaces kandinsky5_tpu/ops/conv_pallas.py _kernel (reached via
// _conv_fused and causal_conv3d_fused), plain and time_padded modes:
//   y[t,h,w,:] = bias + sum_{dt,dh,dw} x[t',h',w',:] . W[dt,dh,dw]
// where, unpadded, t' = max(t + dt - 2, 0) (two replicated leading frames)
// and, time_padded, t' = t + dt over an input that already carries two
// history frames; h' = clamp(h + dh - 1), w' = clamp(w + dw - 1). The
// replicate padding is an index clamp inside the kernel, so no padded copy
// of the activation is ever written (the TPU path materialized one, with
// extra W columns for its DMA alignment).
//
// Bound on the H100: tensor-core rate (27 * Cin MACs per output channel
// and voxel); the activation is re-read 27 times, from L2. Design: output
// tiles of 128 voxels (flattened t,h,w, so any W works) x 128 output
// channels; the K loop walks 27 taps x Cin/32 channel slices, each thread
// gathering its two rows' 16-byte pieces at the clamped tap address; fp32
// accumulation in registers; bias added in the epilogue. The weight is
// read as (27, Cout, Cin), the K-contiguous B operand.
#include "common.cuh"

namespace {
using namespace k5;

__global__ void __launch_bounds__(256)
conv3d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w27,
              const float* __restrict__ bias, bf16* __restrict__ y, int T,
              int H, int W, int Cin, int Cout, int time_padded) {
  __shared__ __align__(16) bf16 As[GM * GST];
  __shared__ __align__(16) bf16 Bs[GN * GST];

  const int n0 = blockIdx.y * GN;
  const long long m0 = (long long)blockIdx.x * GM;
  const long long M = (long long)T * H * W;  // output voxels
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  int vt[2], vh[2], vw[2], c8s[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * 256, row = idx >> 2;
    c8s[i] = (idx & 3) * 8;
    const long long m = m0 + row;
    valid[i] = m < M;
    const long long mm = valid[i] ? m : 0;
    vw[i] = (int)(mm % W);
    vh[i] = (int)((mm / W) % H);
    vt[i] = (int)(mm / ((long long)W * H));
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  uint4 ar[2], br[2];
  const int ncs = Cin / GK;
  auto load = [&](int kt) {
    const int tap = kt / ncs, c0 = (kt % ncs) * GK;
    const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 r = make_uint4(0, 0, 0, 0);
      if (valid[i]) {
        const int ti = time_padded ? vt[i] + dt : max(vt[i] + dt - 2, 0);
        const int hi = min(max(vh[i] + dh - 1, 0), H - 1);
        const int wi = min(max(vw[i] + dw - 1, 0), W - 1);
        const size_t off = (((size_t)ti * H + hi) * W + wi) * Cin + c0 + c8s[i];
        r = *reinterpret_cast<const uint4*>(x + off);
      }
      ar[i] = r;
    }
    load_b_regs(w27 + (size_t)tap * Cout * Cin, Cin, n0, c0, br);
  };

  const int nk = 27 * ncs;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    store_stage_regs(As, ar);
    store_stage_regs(Bs, br);
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
    gemm_stage(As, Bs, acc);
  }

  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(y + m * Cout + n) =
            pack_f2(acc[mt][nt][2 * half] + bias[n], acc[mt][nt][2 * half + 1] + bias[n + 1]);
      }
    }
}

}  // namespace

// x (T_in, H, W, Cin) bf16 with T_in = T + 2 when time_padded else T;
// w27 (27, Cout, Cin) bf16; bias (Cout,) fp32; y (T, H, W, Cout) bf16.
extern "C" int k5_conv3d(const void* x, const void* w27, const void* bias,
                         void* y, int T, int H, int W, int Cin, int Cout,
                         int time_padded, void* stream) {
  const long long M = (long long)T * H * W;
  dim3 grid((unsigned)((M + GM - 1) / GM), Cout / GN);
  conv3d_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w27, (const float*)bias, (bf16*)y, T, H, W,
      Cin, Cout, time_padded);
  return (int)cudaGetLastError();
}
