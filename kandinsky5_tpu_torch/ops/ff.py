"""The fused feed-forwards: kernels K2 and K8 beside their plain PyTorch
versions.

Counterpart of ``kandinsky5_tpu/ops/ff_pallas.py``. K2 is
``fused_ff_modulated`` with ``use_gate=True``:

    y = x + gate * [ gelu_erf(bf16(LN(x) * (1 + scale) + shift) @ W1^T) @ W2^T ]

LayerNorm in fp32 with eps 1e-5 and no affine. K8 is ``fused_ff``, the same
FF with no LayerNorm, modulation, gate or residual:

    y = bf16( sum over ff of bf16(gelu_erf(x @ W1^T)) @ W2^T )

In both the hidden activation is made in fp32 and cast to x.dtype before the
second product, the second product accumulates in fp32, and there are no
biases. Weights are in the torch (out, in) layout of ``nn.Linear``: w1 (FF,
D), w2 (D, FF). A CPU tensor goes to the plain version, a CUDA tensor to
``csrc/ff_mod.cu`` (or raises). On the card K2 is a modulation pass
(:func:`modulate`: the normed, modulated x in bf16, made once per row) and
two GEMMs on one wgmma mainloop; K8 is the two GEMMs. :func:`ff_supported`
is the JAX package's gate for K8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels

LN_EPS = 1e-5
# K8's routing gate, as in the JAX package: its row tile (rows below it stay
# on the unfused chain) and its ff-chunk target
_BS = 512
_BF_TARGET = 2048


def modulate_plain(x, scale, shift):
    """Plain K2 modulation pass: bf16(LN(x) * (1 + scale) + shift) with the
    LayerNorm in fp32 (the JAX package's ``apply_scale_shift_norm``). x (B,
    L, D); scale/shift (B, D)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    y = y * (scale.float()[:, None] + 1.0) + shift.float()[:, None]
    return y.to(x.dtype)


def ff_mod_plain(x, scale, shift, w1, w2, gate):
    """Plain PyTorch K2. x (B, L, D); scale/shift/gate (B, D)."""
    xn = modulate_plain(x, scale, shift)
    h = F.gelu(xn.float() @ w1.float().T, approximate="none").to(x.dtype)
    acc = h.float() @ w2.float().T
    return (x.float() + gate.float()[:, None] * acc).to(x.dtype)


def _mod_operands(name, x, vecs):
    """Check x (B, L, D) bf16 and the (B, D) vectors for the kernels and
    return the vectors as contiguous fp32."""
    b, _, d = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 x")
    if d % 128 or any(v.numel() != b * d for v in vecs):
        raise ValueError(f"{name} shapes: x {tuple(x.shape)} vectors "
                         f"{[tuple(v.shape) for v in vecs]}")
    vecs = [v.reshape(b, d).float().contiguous() for v in vecs]
    named = dict(x=x, **{f"vector{i}": v for i, v in enumerate(vecs)})
    _kernels.check_cuda(name, **named)
    _kernels.check_tma_aligned(name, **named)
    return vecs


def modulate(x, scale, shift):
    """The modulation pass alone (K2's first kernel): x (B, L, D) bf16,
    scale/shift (B, D) -> (B, L, D) bf16. A CPU tensor takes the plain
    version."""
    _kernels.refuse_grad("K2's modulation pass", x, scale, shift)
    if x.device.type == "cpu":
        return modulate_plain(x, scale, shift)
    b, l, d = x.shape
    sc, sh = _mod_operands("K2 modulation", x, (scale, shift))
    out = torch.empty_like(x)
    _kernels.launch("k5_ff_modulate", "K2_modulate", x.data_ptr(),
                    sc.data_ptr(), sh.data_ptr(), out.data_ptr(), b, l, d)
    return out


def fused_ff_modulated(x, scale, shift, w1, w2, gate):
    """K2 wrapper. x (B, L, D) bf16; scale/shift/gate (B, D); w1 (FF, D)
    and w2 (D, FF) bf16, with D and FF multiples of 128."""
    _kernels.refuse_grad("K2", x, scale, shift, w1, w2, gate)
    if x.device.type == "cpu":
        return ff_mod_plain(x, scale, shift, w1, w2, gate)
    b, l, d = x.shape
    ff = w1.shape[0]
    if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise ValueError("K2 takes bf16 x and weights")
    if w1.shape != (ff, d) or w2.shape != (d, ff) or ff % 128:
        raise ValueError(f"K2 shapes: x {x.shape} w1 {w1.shape} w2 {w2.shape}")
    vecs = _mod_operands("K2", x, (scale, shift, gate))
    _kernels.check_cuda("K2", w1=w1, w2=w2)
    _kernels.check_tma_aligned("K2", w1=w1, w2=w2)
    hidden = torch.empty((b * l, ff), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _kernels.launch("k5_ff_mod", "K2_ff_mod", x.data_ptr(),
                    vecs[0].data_ptr(), vecs[1].data_ptr(), vecs[2].data_ptr(),
                    w1.data_ptr(), w2.data_ptr(), hidden.data_ptr(),
                    out.data_ptr(), b, l, d, ff)
    return out


def _pick_bf(ff: int) -> int:
    """Largest divisor of ff that is <= _BF_TARGET and lane-aligned (the JAX
    package's ``_pick_bf``)."""
    for bf in range(min(_BF_TARGET, ff), 127, -128):
        if ff % bf == 0:
            return bf
    return ff


def ff_supported(x, w1, w2) -> bool:
    """Whether the JAX package sends this FF to its fused kernel
    (``ff_pallas.ff_supported``): bf16 x and weights, D and FF multiples of
    256, at least one 512-row tile and an ff chunk of at least 256. So the
    256-row text blocks decline it. w1 (FF, D), w2 (D, FF)."""
    if (x.dtype != torch.bfloat16 or w1.dtype != torch.bfloat16
            or w2.dtype != torch.bfloat16):
        return False
    ff, d = w1.shape
    if tuple(w2.shape) != (d, ff):
        return False
    rows = 1
    for s in x.shape[:-1]:
        rows *= s
    return (x.shape[-1] == d and d % 256 == 0 and ff % 256 == 0
            and rows >= _BS and _pick_bf(ff) >= 256)


def ff_plain(x, w1, w2):
    """Plain PyTorch K8: gelu_erf(x W1^T) in fp32, rounded to x.dtype, then
    the fp32 product with W2 rounded once. x (..., D)."""
    h = F.gelu(x.float() @ w1.float().T, approximate="none").to(x.dtype)
    return (h.float() @ w2.float().T).to(x.dtype)


def _ff_operands(name, x, w1, w2):
    """Check K8's operands for the kernel and return x as (rows, D)."""
    ff, d = w1.shape
    if x.dtype != torch.bfloat16 or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise ValueError(f"{name} takes bf16 x and weights")
    if x.shape[-1] != d or tuple(w2.shape) != (d, ff) or d % 128 or ff % 128:
        raise ValueError(f"{name} shapes: x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    x2 = x.reshape(-1, d)
    _kernels.check_cuda(name, x=x2, w1=w1, w2=w2)
    _kernels.check_tma_aligned(name, x=x2, w1=w1, w2=w2)
    return x2


def launch_ff(x, w1, w2, counter: str = "K8_ff"):
    """One launch of K8's C entry (its up and down kernels) on CUDA
    tensors, counted under ``counter``; the tools' T3 counts the same entry
    as its own."""
    x2 = _ff_operands(counter, x, w1, w2)
    rows, d = x2.shape
    ff = w1.shape[0]
    hidden = torch.empty((rows, ff), dtype=x.dtype, device=x.device)
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    _kernels.launch("k5_ff", counter, x2.data_ptr(), w1.data_ptr(),
                    w2.data_ptr(), hidden.data_ptr(), out.data_ptr(), rows, d,
                    ff)
    return out.reshape(x.shape)


def fused_ff(x, w1, w2):
    """K8 wrapper: gelu_erf(x W1^T) W2^T. x (..., D) bf16, w1 (FF, D) and w2
    (D, FF) bf16 with D and FF multiples of 128; any number of rows (the
    kernel masks the ragged row tile, where the TPU kernel pads)."""
    _kernels.refuse_grad("K8", x, w1, w2)
    if x.device.type == "cpu":
        return ff_plain(x, w1, w2)
    return launch_ff(x, w1, w2)
