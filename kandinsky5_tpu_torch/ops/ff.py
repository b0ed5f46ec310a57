"""AdaLN-modulated feed-forward: kernel K2 beside its plain PyTorch version.

Counterpart of ``kandinsky5_tpu/ops/ff_pallas.py`` (``fused_ff_modulated``
with ``use_gate=True``):

    y = x + gate * [ gelu_erf(bf16(LN(x) * (1 + scale) + shift) @ W1^T) @ W2^T ]

LayerNorm in fp32 with eps 1e-5 and no affine; the hidden activation is
made in fp32 and cast to x.dtype before the second product; the second
product accumulates in fp32; no biases. Weights are in the torch (out, in)
layout of ``nn.Linear``: w1 (FF, D), w2 (D, FF). A CPU tensor goes to the
plain version, a CUDA tensor to ``csrc/ff_mod.cu`` (or raises).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels

LN_EPS = 1e-5


def ff_mod_plain(x, scale, shift, w1, w2, gate):
    """Plain PyTorch K2. x (B, L, D); scale/shift/gate (B, D)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    y = y * (scale.float()[:, None] + 1.0) + shift.float()[:, None]
    xn = y.to(x.dtype)
    h = F.gelu(xn.float() @ w1.float().T, approximate="none").to(x.dtype)
    acc = h.float() @ w2.float().T
    return (xf + gate.float()[:, None] * acc).to(x.dtype)


def fused_ff_modulated(x, scale, shift, w1, w2, gate):
    """K2 wrapper. x (B, L, D) bf16; scale/shift/gate (B, D); w1 (FF, D)
    and w2 (D, FF) bf16, with D and FF multiples of 128."""
    if x.device.type == "cpu":
        return ff_mod_plain(x, scale, shift, w1, w2, gate)
    b, l, d = x.shape
    ff = w1.shape[0]
    if x.dtype != torch.bfloat16 or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError("K2 takes bf16 x and weights")
    if w1.shape != (ff, d) or w2.shape != (d, ff) or d % 128 or ff % 128:
        raise ValueError(f"K2 shapes: x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    vecs = [t.reshape(b, d).float().contiguous() for t in (scale, shift, gate)]
    _kernels.check_cuda("K2", x=x, w1=w1, w2=w2, scale=vecs[0],
                        shift=vecs[1], gate=vecs[2])
    hidden = torch.empty((b * l, ff), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _kernels.launch("k5_ff_mod", "K2_ff_mod", x.data_ptr(),
                    vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
                    w1.data_ptr(), w2.data_ptr(), hidden.data_ptr(),
                    out.data_ptr(), b, l, d, ff)
    return out
