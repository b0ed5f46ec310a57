"""PyTorch primitives for the Kandinsky-5 DiT.

Counterpart of ``kandinsky5_tpu/models/nn.py``. Layers are ``nn.Module``s
whose parameter names follow the released checkpoint (``in_layer.weight``,
``query_norm.weight``, ...); the math lives in plain functions that copy
the JAX package's cast points:

  * products run in the parameter dtype (bf16 in production, fp32 in the
    parity tests);
  * LayerNorm, RMSNorm, modulation, the time embedding and RoPE run in
    fp32;
  * q/k are cast back to the activation dtype right after the RMSNorm.

W8A8: :func:`quantize_linear` turns an ``nn.Linear`` into an
:class:`Int8Linear` (int8 weight per out channel), which :func:`linear`
runs with per-token int8 activations (``_linear_i8``).

Tensor parallelism (the JAX package under a ``(1, 1, tp)`` mesh): an
:class:`Attention` or :class:`FeedForward` built with ``tp > 1`` holds one
rank's columns of Q/K/V and of the FF in layer and its rows of the out
layers; :func:`row_parallel_linear` and :func:`feed_forward` sum the
partial products over the group (a
:class:`~kandinsky5_tpu_torch.parallel.TensorParallel`).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from kandinsky5_tpu_torch.ops.ff import (
    ff_supported,
    fused_ff,
    fused_ff_modulated,
)

# torch.nn.LayerNorm default eps
LAYERNORM_EPS = 1e-5
# RMSNorm(eps=None) on fp32 inputs resolves to fp32 machine eps
RMSNORM_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Modules (parameter containers named like the checkpoint)
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """A bare ``weight`` (and optional ``bias``) vector, as the checkpoint's
    RMSNorm / LayerNorm entries store them."""

    def __init__(self, dim: int, bias: bool = False, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
                     if bias else None)


class TimeEmbeddings(nn.Module):
    def __init__(self, model_dim, time_dim, device=None, dtype=None):
        super().__init__()
        self.in_layer = nn.Linear(model_dim, time_dim, device=device, dtype=dtype)
        self.out_layer = nn.Linear(time_dim, time_dim, device=device, dtype=dtype)


class TextEmbeddings(nn.Module):
    def __init__(self, text_dim, model_dim, device=None, dtype=None):
        super().__init__()
        self.in_layer = nn.Linear(text_dim, model_dim, device=device, dtype=dtype)
        self.norm = Norm(model_dim, bias=True, device=device, dtype=dtype)


class VisualEmbeddings(nn.Module):
    def __init__(self, patch_dim, model_dim, device=None, dtype=None):
        super().__init__()
        self.in_layer = nn.Linear(patch_dim, model_dim, device=device, dtype=dtype)


class Modulation(nn.Module):
    def __init__(self, time_dim, model_dim, num_params, device=None,
                 dtype=None):
        super().__init__()
        self.out_layer = nn.Linear(time_dim, num_params * model_dim,
                                   device=device, dtype=dtype)


class Attention(nn.Module):
    """Self- or cross-attention projections with QK-RMSNorm; with ``tp >
    1`` one rank's share: dim / tp output rows of Q/K/V (whole heads) and
    the out layer's dim / tp input columns."""

    def __init__(self, dim, head_dim, device=None, dtype=None, tp: int = 1):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        local = dim // tp
        self.to_query = nn.Linear(dim, local, **kw)
        self.to_key = nn.Linear(dim, local, **kw)
        self.to_value = nn.Linear(dim, local, **kw)
        self.query_norm = Norm(head_dim, **kw)
        self.key_norm = Norm(head_dim, **kw)
        self.out_layer = nn.Linear(local, dim, **kw)


class Int8Linear(nn.Module):
    """A W8A8 linear (the JAX ``quantize_linear`` params): ``weight_i8``
    (out, in) int8, ``w_scale`` (out,) fp32 and the original ``bias``
    (a Parameter, or None)."""

    def __init__(self, weight_i8, w_scale, bias=None):
        super().__init__()
        self.register_buffer("weight_i8", weight_i8)
        self.register_buffer("w_scale", w_scale)
        self.bias = bias


class FeedForward(nn.Module):
    def __init__(self, dim, ff_dim, device=None, dtype=None):
        super().__init__()
        self.in_layer = nn.Linear(dim, ff_dim, bias=False, device=device,
                                  dtype=dtype)
        self.out_layer = nn.Linear(ff_dim, dim, bias=False, device=device,
                                   dtype=dtype)


# ---------------------------------------------------------------------------
# Elementary functions
# ---------------------------------------------------------------------------

@torch.no_grad()
def quantize_linear(layer: nn.Linear) -> Int8Linear:
    """``nn.Linear`` -> :class:`Int8Linear`, as the JAX ``quantize_linear``:
    a symmetric scale per out channel, max(max|w| over the in axis, 1e-6)
    * (1/127) (a multiply by the reciprocal, as there), w8 = clip(round(w /
    scale), -127, 127). The bias is shared, not copied."""
    w = layer.weight.float()
    s = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    w8 = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return Int8Linear(w8, s[:, 0].contiguous(), layer.bias)


def _int8_product(x8, w8):
    """(M, K) int8 . (N, K)^T int8 -> (M, N) int32, exactly. On the card
    ``torch._int_mm`` (the JAX package leaves this product to XLA, outside
    any Pallas kernel), with the rows padded above its minimum of 17; on
    the CPU an fp64 product, exact since |sum| <= K * 127^2 < 2^53."""
    if x8.device.type == "cpu":
        return (x8.double() @ w8.double().T).to(torch.int32)
    m = x8.shape[0]
    if m <= 16:
        x8 = F.pad(x8, (0, 0, 0, 32 - m))
    return torch._int_mm(x8, w8.t())[:m]


def _linear_i8(layer: Int8Linear, x):
    """W8A8: per-token sx = max(max|x|, 1e-6) * (1/127), x8 = clip(round(x /
    sx), -127, 127), s32 product, y = float(s32) * sx * w_scale (in that
    order) + bias, in x.dtype."""
    with record_function("int8_linear"):
        xf = x.float()
        sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
        x8 = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        y = _int8_product(x8.reshape(-1, x.shape[-1]), layer.weight_i8)
        y = y.reshape(*x.shape[:-1], -1).float() * sx * layer.w_scale
        if layer.bias is not None:
            y = y + layer.bias.float()
        return y.to(x.dtype)


def linear(layer, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """y = x W^T (+ b), computed in ``dtype`` (default: the promotion of x
    and the weight), returned in ``dtype`` or x.dtype. An
    :class:`Int8Linear` runs W8A8 (``dtype`` is not used there)."""
    if isinstance(layer, Int8Linear):
        return _linear_i8(layer, x)
    w, b = layer.weight, layer.bias
    ct = dtype or torch.promote_types(x.dtype, w.dtype)
    y = F.linear(x.to(ct), w.to(ct), None if b is None else b.to(ct))
    return y.to(dtype or x.dtype)


def layer_norm(x, weight=None, bias=None, eps=LAYERNORM_EPS):
    """LayerNorm over the last axis in fp32 (optionally affine)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def rms_norm(x, weight, eps=RMSNORM_EPS):
    """RMSNorm in fp32."""
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return xf * scale * weight.float()


def apply_scale_shift_norm(x, scale, shift, out_dtype=None):
    """AdaLN: LayerNorm(x) * (scale + 1) + shift in fp32, out in x.dtype."""
    y = layer_norm(x)
    y = y * (scale.float() + 1.0) + shift.float()
    return y.to(out_dtype or x.dtype)


def apply_gate_sum(x, out, gate, out_dtype=None):
    """x + gate * out in fp32 -> x.dtype."""
    y = x.float() + gate.float() * out.float()
    return y.to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def get_freqs(dim: int, max_period: float = 10000.0) -> np.ndarray:
    """exp(-log(max_period) * arange(dim) / dim), fp32 on the host."""
    return np.exp(-math.log(max_period) * np.arange(dim, dtype=np.float32)
                  / dim).astype(np.float32)


def _freqs(dim, max_period, device):
    return torch.from_numpy(get_freqs(dim, max_period)).to(device)


def time_embeddings(p, time, model_dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding -> MLP(SiLU), all fp32."""
    freqs = _freqs(model_dim // 2, max_period, time.device)
    args = torch.outer(time.float(), freqs)
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    h = F.silu(linear(p.in_layer, emb, dtype=torch.float32))
    return linear(p.out_layer, h, dtype=torch.float32)


def text_embeddings(p, x, out_dtype=None):
    """Linear + affine LayerNorm; output dtype follows the parameters."""
    out_dtype = out_dtype or p.in_layer.weight.dtype
    h = linear(p.in_layer, x.to(out_dtype))
    h = layer_norm(h, weight=p.norm.weight, bias=p.norm.bias)
    return h.to(out_dtype)


def patchify(x, patch_size: Sequence[int]):
    """(B, T, H, W, C) -> (B, T/p0, H/p1, W/p2, p0*p1*p2*C), inner order
    (p0, p1, p2, C)."""
    b, t, h, w, c = x.shape
    p0, p1, p2 = patch_size
    x = x.reshape(b, t // p0, p0, h // p1, p1, w // p2, p2, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t // p0, h // p1, w // p2, p0 * p1 * p2 * c)


def visual_embeddings(p, x, patch_size: Sequence[int], out_dtype=None):
    out_dtype = out_dtype or p.in_layer.weight.dtype
    return linear(p.in_layer, patchify(x, patch_size).to(out_dtype))


def unpatchify(x, patch_size: Sequence[int], out_dim: int):
    """(B, T', H', W', C*p0*p1*p2) -> (B, T, H, W, C), inner order
    (C, p0, p1, p2) — not the order :func:`patchify` uses."""
    b, t, h, w, _ = x.shape
    p0, p1, p2 = patch_size
    x = x.reshape(b, t, h, w, out_dim, p0, p1, p2)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * p0, h * p1, w * p2, out_dim)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_1d(positions, head_dim: int, max_period: float = 10000.0):
    """cos/sin tables (L, head_dim // 2), fp32."""
    freqs = _freqs(head_dim // 2, max_period, positions.device)
    args = torch.outer(positions.float(), freqs)
    return torch.cos(args), torch.sin(args)


def rope_3d(grid: Tuple[int, int, int], positions, axes_dims: Sequence[int],
            scale_factor: Sequence[float] = (1.0, 1.0, 1.0),
            max_period: float = 10000.0):
    """cos/sin tables (T*H*W, sum(axes_dims) // 2), fp32: per-axis angles
    (positions divided by scale_factor) broadcast over the grid and
    concatenated."""
    t, h, w = grid
    parts = []
    for ax, (dim, pos, sf) in enumerate(zip(axes_dims, positions,
                                            scale_factor)):
        freqs = _freqs(dim // 2, max_period, pos.device)
        args = torch.outer(pos.float(), freqs) / sf
        shape = [1, 1, 1, args.shape[-1]]
        shape[ax] = args.shape[0]
        parts.append(args.reshape(shape).expand(t, h, w, args.shape[-1]))
    args = torch.cat(parts, dim=-1).reshape(t * h * w, -1)
    return torch.cos(args), torch.sin(args)


def apply_rotary(x, cos, sin):
    """Rotate consecutive channel pairs (x0, x1) -> (c x0 - s x1,
    s x0 + c x1) in fp32, out in x.dtype. x (..., L, H, D); cos/sin
    (L, D // 2)."""
    xf = x.float()
    x2 = xf.reshape(*xf.shape[:-1], xf.shape[-1] // 2, 2)
    x0, x1 = x2[..., 0], x2[..., 1]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    y = torch.stack([c * x0 - s * x1, s * x0 + c * x1], dim=-1)
    return y.reshape(xf.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Modulation / FF / attention projections
# ---------------------------------------------------------------------------

def modulation(p, time_embed):
    """SiLU -> Linear in fp32; (B, num_params * model_dim)."""
    return linear(p.out_layer, F.silu(time_embed.float()), dtype=torch.float32)


def sharded_fused_ff(x, w1, w2, tp):
    """The Megatron FF with K8 on each rank (the JAX ``_sharded_fused_ff``):
    the rank's W1 rows (column parallel) and W2 columns (row parallel)
    through ``ops.ff.fused_ff``, then the sum over the group. None when the
    JAX package would not take it, for shapes its gate declines on the
    rank's share (then the caller runs the chain)."""
    if not ff_supported(x, w1, w2):
        return None
    return tp.all_reduce(fused_ff(x, w1, w2))


def feed_forward(p, x, tp=None):
    """Linear -> exact GELU -> Linear, no biases. With ``tp`` the layer
    holds one rank's share and the result is summed over the group: K8 where
    :func:`sharded_fused_ff` takes it, else the chain on the share."""
    if tp is not None:
        y = sharded_fused_ff(x, p.in_layer.weight, p.out_layer.weight, tp)
        if y is not None:
            return y
    h = F.gelu(linear(p.in_layer, x), approximate="none")
    y = linear(p.out_layer, h)
    return y if tp is None else tp.all_reduce(y)


def row_parallel_linear(layer: nn.Linear, x, tp=None):
    """y = x W^T + b where the layer holds one rank's input columns of W:
    the partial product in the layer's dtype, its sum over ``tp``, then the
    bias, added once (on every rank before the sum it would count tp
    times). Without ``tp``, :func:`linear`."""
    if tp is None:
        return linear(layer, x)
    ct = torch.promote_types(x.dtype, layer.weight.dtype)
    y = tp.all_reduce(F.linear(x.to(ct), layer.weight.to(ct)))
    if layer.bias is not None:
        y = y + layer.bias.to(ct)
    return y.to(x.dtype)


def modulated_feed_forward(p, x, scale, shift, gate, tp=None):
    """apply_scale_shift_norm -> feed_forward -> apply_gate_sum as one op.
    It goes to K2 (``ops/ff.py``) exactly where the JAX package sends it to
    its fused kernel: one device, both projections plain bias-free linears,
    per-item modulation, and shapes that :func:`ff_supported` admits (bf16,
    D and FF multiples of 256, at least 512 rows; so the 256-row text
    blocks and a DiT that is not bf16 run the chain). K2's own wrapper
    takes the plain version on the CPU. W8A8 projections
    (:class:`Int8Linear`) take the unfused chain, as the JAX routing does.
    Under tensor parallelism (``tp``) K2 steps aside, as in the JAX
    package: the norm and the gate run plain and the FF through
    :func:`feed_forward` over ``tp``. scale/shift/gate: (B, 1, D)."""
    b = x.shape[0]
    if (tp is None and isinstance(p.in_layer, nn.Linear)
            and isinstance(p.out_layer, nn.Linear)
            and p.in_layer.bias is None and p.out_layer.bias is None
            and scale.shape == (b, 1, x.shape[-1])
            and ff_supported(x, p.in_layer.weight, p.out_layer.weight)):
        return fused_ff_modulated(x, scale[:, 0], shift[:, 0],
                                  p.in_layer.weight, p.out_layer.weight,
                                  gate[:, 0])
    out = apply_scale_shift_norm(x, scale, shift)
    out = feed_forward(p, out, tp)
    return apply_gate_sum(x, out, gate)


def qkv_proj(p, x, num_heads: int):
    """Per-head Q/K/V with fp32 QK-RMSNorm; x (B, L, D) -> (B, L, H, hd)."""
    b, l, _ = x.shape
    q = linear(p.to_query, x).reshape(b, l, num_heads, -1)
    k = linear(p.to_key, x).reshape(b, l, num_heads, -1)
    v = linear(p.to_value, x).reshape(b, l, num_heads, -1)
    q = rms_norm(q, p.query_norm.weight).to(x.dtype)
    k = rms_norm(k, p.key_norm.weight).to(x.dtype)
    return q, k, v
