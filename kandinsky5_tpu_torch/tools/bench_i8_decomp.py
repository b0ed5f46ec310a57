"""T5: where K5's time goes, pass by pass. K5's kernel
(``csrc/flash_int8.cu``) built in four modes, each with passes removed:

  full      QK(s8 s8 -> s32) -> dequant -> exp2 -> bf16 -> PV (K5 without
            its final normalization)
  no_exp2   QK -> dequant -> bf16 -> PV          (exp2 removed)
  raw_pv    QK -> bf16(s32) -> PV                (dequant and exp2 removed)
  qk_only   QK -> each thread adds its s32 scores into its own output
            lanes (PV removed)

Port of ``tools/bench_i8_decomp.py`` (its Pallas ``_kernel`` is the kernel
replaced here). The outputs are garbage by design: the modes exist to be
timed, and the differences between adjacent modes price each pass,
including its serialization against the tensor cores. Each mode has a
plain version computing the same formula (qk_only's over 64-key groups:
K5's 128-key tile adds its columns c and c + 64 into lane c), so the card
can still check the kernel's modes.

    python -m kandinsky5_tpu_torch.tools.bench_i8_decomp

Runs at the 5 s shape (1, 47,616, 28, 64) with QK-RMSNorm'd q, k. Needs a
CUDA device.
"""

from __future__ import annotations

import torch

from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.flash import _row_chunks, int8_operands, pack_int8

MODES = ("full", "no_exp2", "raw_pv", "qk_only")
B, S, H, D = 1, 47616, 28, 64
_TILE = 64


def i8_decomp_plain(q8, k8, v, coeff, shift, mode: str):
    """Plain PyTorch T5 in ``mode``, on pack_int8's outputs (no mask):
      full     out = sum_j cast(exp2(s32_ij * c_j - shift)) v_j
      no_exp2  out = sum_j cast(s32_ij * c_j - shift) v_j
      raw_pv   out = sum_j cast(s32_ij) v_j
      qk_only  out[i, e] = sum over 64-key tiles t of s32[i, 64 t + e]
    with cast = to v.dtype, fp32 sums, the result in v.dtype."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, lk, h, d = v.shape
    lq = q8.shape[1]
    out = torch.empty((b, lq, h, d), dtype=v.dtype, device=v.device)
    n_tiles = -(-lk // _TILE)
    for bi in range(b):
        for hi in range(h):
            bh = bi * h + hi
            kh = k8[bh].float()
            vh = v[bi, :, hi].float()
            c = coeff[bh].float()
            for lo, hi_ in _row_chunks(lq, lk):
                s32 = q8[bh, lo:hi_].float() @ kh.T
                if mode == "qk_only":
                    s32 = torch.nn.functional.pad(s32, (0, n_tiles * _TILE - lk))
                    o = s32.reshape(hi_ - lo, n_tiles, _TILE).sum(1)
                else:
                    if mode == "raw_pv":
                        p = s32
                    else:
                        p = s32 * c - shift.float()
                        if mode == "full":
                            p = torch.exp2(p)
                    o = p.to(v.dtype).float() @ vh
                out[bi, lo:hi_, hi] = o.to(v.dtype)
    return out


def i8_decomp(q8, k8, v, coeff, shift, mode: str):
    """T5 wrapper: one mode of K5's kernel on pack_int8's outputs; v (B, Lk,
    H, 64) bf16. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _kernels.refuse_grad("T5", v, coeff, shift)
    if v.device.type == "cpu":
        return i8_decomp_plain(q8, k8, v, coeff, shift, mode)
    (b, lq, lk, h), coeff = int8_operands("T5", q8, k8, v, coeff, shift)
    out = torch.empty((b, lq, h, 64), dtype=v.dtype, device=v.device)
    _kernels.launch("k5_i8_decomp", "T5_i8_decomp", q8.data_ptr(),
                    k8.data_ptr(), v.data_ptr(), coeff.data_ptr(),
                    shift.data_ptr(), out.data_ptr(), b, lq, lk, h,
                    MODES.index(mode) + 1)
    return out


def inputs(generator, device, shape=(B, S, H, D)):
    """QK-RMSNorm'd q and k and standard normal v in bf16, and their
    pack_int8 outputs."""
    def normed():
        x = torch.randn(shape, generator=generator, device=device)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    q, k = normed(), normed()
    v = torch.randn(shape, generator=generator, device=device).bfloat16()
    return (v,) + pack_int8(q, k)


def main() -> None:
    from kandinsky5_tpu_torch.tools import gpu_line
    from kandinsky5_tpu_torch.tools.bench_int8mm import time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(gpu_line())
    dev = torch.device("cuda")
    v, q8, k8, coeff, shift = inputs(torch.Generator(device=dev).manual_seed(0),
                                     dev)
    flops = 4.0 * S * S * D * H * B
    t = {}
    for mode in MODES:
        t[mode] = time_ms(lambda: i8_decomp(q8, k8, v, coeff, shift, mode),
                          reps=3)
        print(f"  {mode:9s}: {t[mode]:8.3f} ms  {flops / t[mode] / 1e9:6.1f} "
              "TFLOP/s-equivalent", flush=True)
    print(f"  exp2 pass cost:     {t['full'] - t['no_exp2']:8.3f} ms")
    print(f"  dequant cost:       {t['no_exp2'] - t['raw_pv']:8.3f} ms")
    print(f"  PV product cost:    {t['raw_pv'] - t['qk_only']:8.3f} ms")
    print(f"  QK + loads floor:   {t['qk_only']:8.3f} ms")
    print(gpu_line())


if __name__ == "__main__":
    main()
