"""Weights made from the seed, on the device, in a few large calls.

The DiT: every matrix uniform in +-1/sqrt(fan_in), the modulations'
included, zero biases, unit norms (the port's ``init_dit_params`` scheme,
save that its modulations are zero there, which makes every block an
identity); one flat draw, and the port's module holds views of it. (The
``fast_init_dit_params`` scheme, +-0.02 everywhere, leaves the blocks'
share of the velocity below bf16's rounding, so no check could see them.) The VAE decoder: weights
uniform in +-1/sqrt(fan_in), zero biases, unit GroupNorms (the port's
``init_vae_params`` scheme), one flat draw. Both are the benchmark's, keyed
by the released checkpoints' names, and the reference reads them as they
are.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

# every tensor starts on a 128-byte boundary of its flat buffer, as the
# kernels' TMA descriptors need (16 bytes at least)
ALIGN = 64


def _offsets(sizes: Sequence[int]) -> Tuple[List[int], int]:
    offs, off = [], 0
    for n in sizes:
        offs.append(off)
        off += -(-n // ALIGN) * ALIGN
    return offs, off


def seeded_dit(dit_params, seed: int, device, dtype
               ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """(the port's DiT over the benchmark's weights, {checkpoint name:
    tensor}) from one uniform draw on ``device``: every matrix uniform in
    +-1/sqrt(fan_in), the modulations' too; biases zero; norms one."""
    from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D

    with torch.device("meta"):
        model = DiffusionTransformer3D(dit_params, dtype=dtype)
    named = list(model.named_parameters())
    offs, total = _offsets([p.numel() for _, p in named])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    for (name, p), o in zip(named, offs):
        part = flat[o:o + p.numel()]
        if p.dim() == 2:
            part.mul_(1.0 / math.sqrt(p.shape[1]))
        else:
            part.fill_(0.0 if name.endswith("bias") else 1.0)
    flat = flat.to(dtype)
    params = {name: flat[o:o + p.numel()].view(p.shape)
              for (name, p), o in zip(named, offs)}
    for mod_name, mod in model.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)):
            full = f"{mod_name}.{pname}" if mod_name else pname
            mod._parameters[pname] = nn.Parameter(params[full],
                                                  requires_grad=False)
    return model, params


def _vae_leaves(channels: Sequence[int], latent_channels: int,
                layers_per_block: int) -> List[Tuple[tuple, tuple, str]]:
    """(path, shape, kind) of every decoder parameter; kind is "w" (a
    weight, bound 1/sqrt(fan_in)), "zero" or "one"."""
    leaves = []

    def conv(path, cin, cout, k):
        leaves.append((path + ("weight",), (cout, cin, k, k, k), "w"))
        leaves.append((path + ("bias",), (cout,), "zero"))

    def norm(path, c):
        leaves.append((path + ("weight",), (c,), "one"))
        leaves.append((path + ("bias",), (c,), "zero"))

    def resnet(path, cin, cout):
        norm(path + ("norm1",), cin)
        conv(path + ("conv1",), cin, cout, 3)
        norm(path + ("norm2",), cout)
        conv(path + ("conv2",), cout, cout, 3)
        if cin != cout:
            conv(path + ("conv_shortcut",), cin, cout, 1)

    rev = list(reversed(channels))
    dec = ("decoder",)
    conv(dec + ("conv_in",), latent_channels, rev[0], 3)
    mid = dec + ("mid_block",)
    resnet(mid + ("resnets", "0"), rev[0], rev[0])
    att = mid + ("attentions", "0")
    norm(att + ("group_norm",), rev[0])
    for lin in (("to_q",), ("to_k",), ("to_v",), ("to_out", "0")):
        leaves.append((att + lin + ("weight",), (rev[0], rev[0]), "w"))
        leaves.append((att + lin + ("bias",), (rev[0],), "zero"))
    resnet(mid + ("resnets", "1"), rev[0], rev[0])
    c_in = rev[0]
    n = len(channels)
    for i in range(n):
        c_out = rev[i]
        blk = dec + ("up_blocks", str(i))
        for j in range(layers_per_block + 1):
            resnet(blk + ("resnets", str(j)), c_in if j == 0 else c_out, c_out)
        if i < 3:
            conv(blk + ("upsamplers", "0", "conv"), c_out, c_out, 3)
        c_in = c_out
    norm(dec + ("conv_norm_out",), channels[0])
    conv(dec + ("conv_out",), channels[0], 3, 3)
    conv(("post_quant_conv",), latent_channels, latent_channels, 1)
    return leaves


def seeded_vae_decoder(seed: int, device, dtype,
                       channels: Sequence[int] = (128, 256, 512, 512),
                       latent_channels: int = 16,
                       layers_per_block: int = 2) -> dict:
    """The decoder half of the HunyuanVideo VAE's parameters (and
    ``post_quant_conv``) as the diffusers checkpoint nests them."""
    leaves = _vae_leaves(channels, latent_channels, layers_per_block)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    offs, total = _offsets(sizes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    for (_, shape, kind), n, o in zip(leaves, sizes, offs):
        part = flat[o:o + n]
        if kind == "w":
            part.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        else:
            part.fill_(1.0 if kind == "one" else 0.0)
    flat = flat.to(dtype)
    tree: dict = {}
    for (path, shape, _), n, o in zip(leaves, sizes, offs):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[o:o + n].view(shape)
    return tree
