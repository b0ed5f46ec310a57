"""Shared helpers for the PyTorch port's parity tests: seeded numpy inputs
handed to both the JAX package and the port, and the parameter converters
between them."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.config import DiTParams as JaxDiTParams
from kandinsky5_tpu.models.dit import init_dit_params as jax_init_dit
from kandinsky5_tpu_torch.checkpoint import (
    dit_from_state_dict,
    dit_state_dict_from_jax,
)
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both_cfgs(**kw):
    """The same DiT architecture as a JAX and a port config."""
    return JaxDiTParams(**kw), DiTParams(**kw)


def random_dit_pair(jcfg, pcfg, seed=0, dtype=torch.float32):
    """JAX DiT params with every leaf drawn from a seeded numpy generator
    (modulation not zero, so every block does work) and the port's DiT
    holding the same values through ``dit_state_dict_from_jax``."""
    params = jax_init_dit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "norm" in name and "weight" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.08 * rng.standard_normal(shape)).astype(np.float32)

    params_np = jax.tree_util.tree_map_with_path(draw, params)
    model = DiffusionTransformer3D(pcfg, device="cpu", dtype=dtype)
    dit_from_state_dict(model, dit_state_dict_from_jax(params_np))
    return jax.tree.map(jnp.asarray, params_np), model


def dataclass_kw(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# a code may round the other way where its pre-rounding value lies within
# this many fp32 ulps of a .5 boundary, counted on the magnitudes that
# produced it (see quant_flip_bound)
FLIP_ULPS = 8


def quant_flip_bound(x, weight, time_padded: bool = False, scale=None,
                     shift=None, act: bool = False, prefix_planes: int = 0):
    """How far each output of K3's W8A8 mode may move under rounding flips.

    Two implementations that round the same fp32 quantities still compute
    them a few ulps apart: XLA on the CPU divides by 127, and under jit by
    the weight's per-channel scale, as a multiply by the reciprocal (an ulp),
    and contracts the prologue's x * scale + shift to an FMA (an ulp of x *
    scale, which cancellation may make many ulps of the result). So the
    pre-rounding value v = xt * inv of an activation code may differ by
    about FLIP_ULPS ulps of |v| + inv * (|x * scale| + |shift|), and that of
    a weight code by FLIP_ULPS ulps of |w / ws|; where that reaches a .5
    boundary the code may round the other way, one step. An activation
    flip moves output n of every voxel that reads it by s * ws[n] *
    |w8[tap, n, c]|, a weight flip output n of every voxel by s * ws[n] *
    |x8| of the code it multiplies. This sums both over each output's 27
    taps and Cin channels, with the scales of that output's own TPU tile.
    ``x`` and the mode arguments are the conv's own, x (1, T_in, H, W,
    Cin), weight (Cout, Cin, 3, 3, 3). Returns the bound, (1, T, H, W, Cout)
    fp32, zero wherever no code sits near a boundary, and the larger of the
    shares of activation reads and of weight codes that sit near one."""
    from kandinsky5_tpu_torch.ops.conv import (
        QUANT_BH,
        _pad_time,
        conv_prologue,
        quant_tile_width,
        quantized_weight,
        window_scales,
    )

    x = torch.as_tensor(x).float()
    _, _, h, w, cin = x.shape
    mag = x.abs()
    xt = x
    if scale is not None:
        scale, shift = torch.as_tensor(scale), torch.as_tensor(shift)
        xt = conv_prologue(x, scale, shift, act, prefix_planes)
        mag = mag * scale.float().abs() + shift.float().abs()
        mag[:, :prefix_planes] = x[:, :prefix_planes].abs()
    cout = weight.shape[0]
    bw = quant_tile_width(w, cin, cout)
    s, inv = window_scales(xt, bw, time_padded)
    t_out = s.shape[0]

    def per_voxel(a):
        return a.repeat_interleave(QUANT_BH, 1).repeat_interleave(bw, 2)

    s_vox, inv_vox = per_voxel(s)[..., None], per_voxel(inv)[..., None]
    w8, ws = quantized_weight(weight)
    w_abs = w8.float().abs().transpose(1, 2)  # (27, Cin, Cout)
    wv = weight.float().permute(2, 3, 4, 0, 1).reshape(27, cout, cin)
    wv = wv / ws[:, None]
    w_near = ((wv - torch.floor(wv) - 0.5).abs()
              <= FLIP_ULPS * 2.0 ** -24 * wv.abs()).float().transpose(1, 2)

    def padded(a):
        a = _pad_time(a, time_padded)[0].permute(3, 0, 1, 2)[None]
        a = torch.nn.functional.pad(a, (1, 1, 1, 1, 0, 0), mode="replicate")
        return a[0].permute(1, 2, 3, 0)

    xp, mp = padded(xt), padded(mag)
    bound = torch.zeros((t_out * h * w, cout))
    n_near = 0
    for tap in range(27):
        dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3
        win = (slice(dt, dt + t_out), slice(dh, dh + h), slice(dw, dw + w))
        v = xp[win] * inv_vox
        eps = FLIP_ULPS * 2.0 ** -24 * (v.abs() + mp[win] * inv_vox)
        near = (v - torch.floor(v) - 0.5).abs() <= eps
        n_near += int(near.sum())
        bound += near.reshape(-1, cin).float() @ w_abs[tap]
        bound += torch.round(v).abs().reshape(-1, cin) @ w_near[tap]
    bound = bound * (s_vox.reshape(-1, 1) * ws)
    share = max(n_near / (27 * t_out * h * w * cin), float(w_near.mean()))
    return bound.reshape(1, t_out, h, w, cout), share


def assert_quant_conv_close(got, want, x, weight, tol: float = 1e-5,
                            **mode):
    """K3 W8A8 outputs ``got`` against ``want`` on the same input ``x``
    (with the conv's ``mode`` arguments): equal to ``tol`` of the output's
    scale, except by the rounding flips :func:`quant_flip_bound` allows.
    Guard against a vacuous bound: at most 0.1 % of the activation reads
    and of the weight codes may sit near a rounding boundary."""
    got, want = to_np(got), to_np(want)
    bound, share = quant_flip_bound(x, weight, **mode)
    bound = bound.numpy()
    assert share < 1e-3, share
    excess = np.abs(got - want) - bound - tol * max(1.0, np.abs(want).max())
    assert excess.max() <= 0, (excess.max(), np.sum(excess > 0))
