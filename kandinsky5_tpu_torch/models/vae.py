"""HunyuanVideo 3D causal VAE — decoder half, in PyTorch.

Counterpart of the decoder half of ``kandinsky5_tpu/models/vae.py``.
Activations are NDHWC (B, T, H, W, C) as in the JAX package. Parameters are
a nested dict keyed like the HF checkpoint (``checkpoint.
vae_params_from_state_dict``): Conv3d weights (Cout, Cin, kT, kH, kW),
Linear weights (out, in). GroupNorm and the attention softmax run in fp32.

Routing of the 3x3x3 convs: 128-512 channels go to K3
(``ops/conv.causal_conv3d_fused``), the rest (conv_in with Cin 16, conv_out
with Cout 3) to the plain conv, as ``conv_pallas_supported`` splits them.
The mid attention goes to K4 (``ops/flash.flash_attention`` with segment
ids) once it covers at least 2048 voxels. GroupNorm + SiLU run unfused
ahead of each conv (the streaming decode's default in the JAX package).

Only the streaming decode (``models/vae_stream.py``, the JAX package's
single-device default) is ported; the overlap-tiled decode and the
encoder wait for later work.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops.conv import (
    causal_conv3d_fused,
    conv3d_plain,
    conv_kernel_supported,
)
from kandinsky5_tpu_torch.ops.flash import flash_attention
from kandinsky5_tpu_torch.utils import default_device

GROUPNORM_EPS = 1e-6
SCALING_FACTOR = 0.476986
BLOCK_OUT_CHANNELS = (128, 256, 512, 512)
LAYERS_PER_BLOCK = 2
# the mid attention takes K4 from this many voxels on
FLASH_MIN_TOKENS = 2048


# ---------------------------------------------------------------------------
# Primitive layers (NDHWC)
# ---------------------------------------------------------------------------

def conv1x1(p, x):
    """Pointwise conv: x (..., Cin) -> (..., Cout) in the weight dtype
    (fp32 accumulation, one rounding at the end)."""
    w = p["weight"].reshape(p["weight"].shape[0], p["weight"].shape[1])
    return F.linear(x.to(w.dtype), w, p["bias"].to(w.dtype)).to(x.dtype)


def causal_conv3d(p, x):
    """Time-causal conv with replicate padding (stride 1)."""
    w = p["weight"]
    if tuple(w.shape[2:]) == (1, 1, 1):
        return conv1x1(p, x)
    if conv_kernel_supported(w):
        return causal_conv3d_fused(x, w, p["bias"])
    return conv3d_plain(x, w, p["bias"])


def _gn_fold(p, x, groups: int = 32, eps: float = GROUPNORM_EPS):
    """GroupNorm statistics folded into one per-channel (B, C) scale and
    shift, fp32."""
    b, t, h, w, c = x.shape
    n = t * h * w
    xf = x.reshape(b, n, c).float()
    s1 = xf.sum(1)
    s2 = xf.square().sum(1)
    cg = c // groups
    g1 = s1.reshape(b, groups, cg).sum(-1, keepdim=True)
    g2 = s2.reshape(b, groups, cg).sum(-1, keepdim=True)
    cnt = float(n * cg)
    mean = g1 / cnt
    var = (g2 / cnt - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    wgt = p["weight"].float().reshape(groups, cg)
    bias = p["bias"].float().reshape(groups, cg)
    scale_c = (rstd * wgt).reshape(b, c)
    shift_c = (bias - mean * rstd * wgt).reshape(b, c)
    return scale_c, shift_c


def group_norm(p, x, groups: int = 32, eps: float = GROUPNORM_EPS):
    """GroupNorm(32) over (T, H, W, C / groups) in fp32, out in x.dtype."""
    b, t, h, w, c = x.shape
    scale_c, shift_c = _gn_fold(p, x, groups, eps)
    y = x.reshape(b, -1, c).float() * scale_c[:, None] + shift_c[:, None]
    return y.reshape(b, t, h, w, c).to(x.dtype)


def gn_silu(p, x):
    h = group_norm(p, x)
    return F.silu(h.float()).to(x.dtype)


def resnet_block(p, x):
    """GN -> SiLU -> conv -> GN -> SiLU -> conv + (1x1) shortcut."""
    h = causal_conv3d(p["conv1"], gn_silu(p["norm1"], x))
    h = causal_conv3d(p["conv2"], gn_silu(p["norm2"], h))
    residual = x
    if "conv_shortcut" in p:
        residual = causal_conv3d(p["conv_shortcut"], x)
    return h + residual


def _proj(p, tokens):
    """tokens @ W^T + b in fp32 (the mid attention's q/k/v/out)."""
    return F.linear(tokens.float(), p["weight"].float(), p["bias"].float())


def mid_attention(p, x):
    """Single-head frame-causal attention over all voxels, residual add."""
    b, t, h, w, c = x.shape
    s = h * w
    y = group_norm(p["group_norm"], x)
    tokens = y.reshape(b, t * s, c)
    q = _proj(p["to_q"], tokens)
    k = _proj(p["to_k"], tokens)
    v = _proj(p["to_v"], tokens)
    ids = torch.arange(t, device=x.device).repeat_interleave(s)[None]
    ids = ids.expand(b, t * s)
    if t * s >= FLASH_MIN_TOKENS:
        out = flash_attention(q.to(x.dtype)[:, :, None],
                              k.to(x.dtype)[:, :, None],
                              v.to(x.dtype)[:, :, None], q_ids=ids,
                              kv_ids=ids)[:, :, 0].float()
    else:
        scores = torch.einsum("bld,bmd->blm", q, k) / math.sqrt(c)
        allowed = ids[0][:, None] >= ids[0][None, :]
        scores = scores.masked_fill(~allowed[None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("blm,bmd->bld", probs.to(v.dtype), v)
    out = _proj(p["to_out"]["0"], out)
    return out.reshape(b, t, h, w, c).to(x.dtype) + x


def _repeat_up(x, ft: int, fh: int, fw: int):
    if ft > 1:
        x = x.repeat_interleave(ft, dim=1)
    if fh > 1:
        x = x.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
    return x


def upsample(p, x, factor: Tuple[int, int, int]):
    """Nearest upsample (the first frame only spatially), then a conv."""
    ft, fh, fw = factor
    first = _repeat_up(x[:, :1], 1, fh, fw)
    if x.shape[1] > 1:
        first = torch.cat([first, _repeat_up(x[:, 1:], ft, fh, fw)], dim=1)
    return causal_conv3d(p["conv"], first)


def _up_plan():
    """(add_spatial, add_time) per up block: 4x time, 8x space."""
    n = len(BLOCK_OUT_CHANNELS)
    return [(i < 3, i >= n - 3 and i != n - 1) for i in range(n)]


def up_factor(add_s: bool, add_t: bool) -> Tuple[int, int, int]:
    return (2 if add_t else 1, 2 if add_s else 1, 2 if add_s else 1)


def decoder_forward(p, z):
    """(B, T', H', W', 16) -> (B, T, 8H', 8W', 3), untiled."""
    h = causal_conv3d(p["conv_in"], z)
    mid = p["mid_block"]
    h = resnet_block(mid["resnets"]["0"], h)
    h = mid_attention(mid["attentions"]["0"], h)
    h = resnet_block(mid["resnets"]["1"], h)
    for i, (add_s, add_t) in enumerate(_up_plan()):
        blk = p["up_blocks"][str(i)]
        for j in range(LAYERS_PER_BLOCK + 1):
            h = resnet_block(blk["resnets"][str(j)], h)
        if "upsamplers" in blk:
            h = upsample(blk["upsamplers"]["0"], h, up_factor(add_s, add_t))
    return causal_conv3d(p["conv_out"], gn_silu(p["conv_norm_out"], h))


class HunyuanVideoVAE:
    """Decoder side of the VAE. Layout (B, T, H, W, C) throughout."""

    spatial_compression = 8
    temporal_compression = 4
    scaling_factor = SCALING_FACTOR

    def __init__(self, params: dict, dtype=torch.bfloat16):
        self.params = params
        self.dtype = dtype

    @torch.no_grad()
    def decode(self, z, mode: str = "stream"):
        """(B, T', H', W', 16) latents -> (B, T, H, W, 3) in about [-1, 1],
        by the streaming decode. The JAX package switches to its
        overlap-tiled decode above sqrt(H W) = 900 pixels, which is not
        ported yet, so such sizes raise."""
        from kandinsky5_tpu_torch.models.vae_stream import streaming_decode

        if mode != "stream":
            raise NotImplementedError(f"decode mode {mode!r} is not ported")
        hl, wl = z.shape[2], z.shape[3]
        if math.sqrt(64 * hl * wl) > 900:
            raise NotImplementedError(
                "spatially tiled decode (above 900 px) is not ported")
        return streaming_decode(self.params, z.to(self.dtype))


# ---------------------------------------------------------------------------
# Parameter initialization (tests and smoke runs)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, device, dtype):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-bound, bound, generator=gen).to(dtype)


def _conv_p(gen, k, cin, cout, device, dtype):
    return {"weight": _uniform(gen, (cout, cin, k, k, k),
                               1.0 / math.sqrt(cin * k ** 3), device, dtype),
            "bias": torch.zeros(cout, device=device, dtype=dtype)}


def _gn_p(c, device, dtype):
    return {"weight": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def _resnet_p(gen, cin, cout, device, dtype):
    p = {"norm1": _gn_p(cin, device, dtype),
         "conv1": _conv_p(gen, 3, cin, cout, device, dtype),
         "norm2": _gn_p(cout, device, dtype),
         "conv2": _conv_p(gen, 3, cout, cout, device, dtype)}
    if cin != cout:
        p["conv_shortcut"] = _conv_p(gen, 1, cin, cout, device, dtype)
    return p


def _lin_p(gen, c, device, dtype):
    return {"weight": _uniform(gen, (c, c), 1.0 / math.sqrt(c), device, dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


@torch.no_grad()
def init_vae_params(latent_channels: int = 16, device=None,
                    dtype=torch.bfloat16, seed: int = 0,
                    block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS):
    """Random decoder-side parameters with the checkpoint's layout and the
    JAX ``init_vae_params`` scheme (uniform +-1/sqrt(fan_in) weights, zero
    biases, unit GroupNorms), drawn on ``device``, the CUDA card when
    None."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rev = list(reversed(block_out_channels))
    kw = dict(device=device, dtype=dtype)
    up_blocks = {}
    c_in = rev[0]
    for i, (add_s, add_t) in enumerate(_up_plan()):
        c_out = rev[i]
        blk = {"resnets": {str(j): _resnet_p(gen, c_in if j == 0 else c_out,
                                             c_out, **kw)
                           for j in range(LAYERS_PER_BLOCK + 1)}}
        if add_s or add_t:
            blk["upsamplers"] = {"0": {"conv": _conv_p(gen, 3, c_out, c_out,
                                                       **kw)}}
        up_blocks[str(i)] = blk
        c_in = c_out
    c = rev[0]
    mid = {"resnets": {"0": _resnet_p(gen, c, c, **kw),
                       "1": _resnet_p(gen, c, c, **kw)},
           "attentions": {"0": {"group_norm": _gn_p(c, **kw),
                                "to_q": _lin_p(gen, c, **kw),
                                "to_k": _lin_p(gen, c, **kw),
                                "to_v": _lin_p(gen, c, **kw),
                                "to_out": {"0": _lin_p(gen, c, **kw)}}}}
    lc = latent_channels
    return {
        "decoder": {
            "conv_in": _conv_p(gen, 3, lc, c, **kw),
            "mid_block": mid,
            "up_blocks": up_blocks,
            "conv_norm_out": _gn_p(block_out_channels[0], **kw),
            "conv_out": _conv_p(gen, 3, block_out_channels[0], 3, **kw),
        },
        "post_quant_conv": _conv_p(gen, 1, lc, lc, **kw),
    }
