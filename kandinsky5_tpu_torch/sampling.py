"""Flow-matching Euler sampling in PyTorch.

Counterpart of ``kandinsky5_tpu/sampling.py``: the timestep grid,
:class:`DenoiseSpec`, the visual-condition input, the Euler loop of
``denoise``/``denoise_span`` as a Python loop, classifier-free guidance
both as one batch-2 call and as two sequential calls, the NABLA sparse
path of the 10 s configs (``attention_type="nabla"``, faithful mode) and
:func:`generate_latents` with explicit noise. MagCache waits for a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    SparseParams,
    dit_epilogue,
    dit_prologue,
    dit_visual_blocks,
    is_quantized,
)
from kandinsky5_tpu_torch.ops.nabla import sta_mask


def timestep_grid(num_steps: int, scheduler_scale: float) -> np.ndarray:
    """linspace(1 -> 0) warped by s t / (1 + (s - 1) t), fp32."""
    t = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float32)
    t = scheduler_scale * t / (1 + (scheduler_scale - 1) * t)
    return t.astype(np.float32)


@dataclass(frozen=True)
class DenoiseSpec:
    """What one denoise run does."""

    dit_params: DiTParams
    num_steps: int
    guidance_weight: float
    scheduler_scale: float
    scale_factor: Tuple[float, float, float]
    # "auto" (K1 self-attention, dense short-KV cross-attention), "flash",
    # "dense", "flash_int8" (K5) or "flash_int8_pipe" (K7)
    # (ops/attention.py)
    attn_impl: str = "auto"
    # the visual blocks' projections are W8A8 (models/dit.py
    # quantize_dit_params): the model denoised must be quantized exactly
    # when this is set
    int8_linear: bool = False
    # the CFG pair as two forwards instead of one batch-2 call
    sequential_cfg: bool = False
    # "flash" (dense self-attention) or "nabla" (block-sparse, K6)
    attention_type: str = "flash"
    nabla_P: float = 0.9
    nabla_wT: int = 11
    nabla_wH: int = 3
    nabla_wW: int = 3

    @property
    def use_cfg(self) -> bool:
        return abs(self.guidance_weight - 1.0) > 1e-6


def _build_sparse(spec: DenoiseSpec, grid, device) -> Optional[SparseParams]:
    """The STA mask of the token grid (T, H, W) for a nabla spec, else
    None."""
    if spec.attention_type != "nabla":
        return None
    t, h, w = grid
    if h % 8 or w % 8:
        raise ValueError(f"NABLA needs an 8-divisible token grid, got {grid}")
    sta = sta_mask(t, h // 8, w // 8, spec.nabla_wT, spec.nabla_wH,
                   spec.nabla_wW)
    return SparseParams(sta=torch.from_numpy(sta).to(device), P=spec.nabla_P)


def token_grid(cfg: DiTParams, latent_shape) -> Tuple[int, int, int]:
    """(T, H, W) token grid of a (B, T, H, W, C) latent after patching."""
    return tuple(n // p for n, p in zip(latent_shape[1:4], cfg.patch_size))


def _visual_cond_input(cfg: DiTParams, x, pdtype):
    """[x, zeros, zero mask] on channels (33 channels) when visual_cond."""
    if cfg.visual_cond:
        zeros = torch.zeros_like(x)
        zmask = torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
        x = torch.cat([x, zeros, zmask], dim=-1)
    return x.to(pdtype)


def _dit_call(model, spec: DenoiseSpec, sparse, model_in, text, pooled, mask,
              t):
    nb = model_in.shape[0]
    to_fractal = sparse is not None
    time_vec = torch.full((nb,), float(t), dtype=torch.float32,
                          device=model_in.device) * 1000.0
    visual, text_o, time_embed, rope, grid = dit_prologue(
        model, model_in, text, pooled, time_vec, mask, spec.scale_factor,
        spec.attn_impl, to_fractal)
    visual = dit_visual_blocks(model, visual, text_o, time_embed, rope, mask,
                               spec.attn_impl, sparse)
    return dit_epilogue(model, visual, time_embed, grid, to_fractal).float()


@torch.no_grad()
def denoise_span(model: DiffusionTransformer3D, spec: DenoiseSpec, noise,
                 times, dts, cond: dict, uncond: dict, on_step=None):
    """Integrate the Euler steps ``times``/``dts`` (host arrays) from
    ``noise`` (B, T, H, W, C) fp32. cond/uncond: {"text_embeds",
    "pooled_embed", "mask"}. ``on_step(i)`` is called after each step."""
    cfg = spec.dit_params
    if spec.int8_linear != is_quantized(model):
        raise ValueError(f"spec.int8_linear is {spec.int8_linear} but the "
                         "model is " + ("" if is_quantized(model) else "not ")
                         + "W8A8-quantized")
    batch = noise.shape[0]
    pdtype = model.dtype
    use_cfg = spec.use_cfg
    sparse = _build_sparse(spec, token_grid(cfg, noise.shape), noise.device)
    if use_cfg and not spec.sequential_cfg:
        text = torch.cat([cond["text_embeds"], uncond["text_embeds"]])
        pooled = torch.cat([cond["pooled_embed"], uncond["pooled_embed"]])
        mask = torch.cat([cond["mask"], uncond["mask"]])
    x = noise
    for i, (t, dt) in enumerate(zip(times, dts)):
        model_in = _visual_cond_input(cfg, x, pdtype)
        if use_cfg and spec.sequential_cfg:
            v_cond = _dit_call(model, spec, sparse, model_in,
                               cond["text_embeds"], cond["pooled_embed"],
                               cond["mask"], t)
            v_uncond = _dit_call(model, spec, sparse, model_in,
                                 uncond["text_embeds"], uncond["pooled_embed"],
                                 uncond["mask"], t)
            velocity = v_uncond + spec.guidance_weight * (v_cond - v_uncond)
        elif use_cfg:
            pred = _dit_call(model, spec, sparse,
                             torch.cat([model_in, model_in]), text, pooled,
                             mask, t)
            v_cond, v_uncond = pred[:batch], pred[batch:]
            velocity = v_uncond + spec.guidance_weight * (v_cond - v_uncond)
        else:
            velocity = _dit_call(model, spec, sparse, model_in,
                                 cond["text_embeds"], cond["pooled_embed"],
                                 cond["mask"], t)
        x = x + float(dt) * velocity
        if on_step is not None:
            on_step(i)
    return x


def denoise(model, spec: DenoiseSpec, noise, cond: dict, uncond: dict,
            on_step=None):
    """The full Euler integration over :func:`timestep_grid`."""
    ts = timestep_grid(spec.num_steps, spec.scheduler_scale)
    return denoise_span(model, spec, noise, ts[:-1], np.diff(ts), cond,
                        uncond, on_step=on_step)


def generate_latents(model, spec: DenoiseSpec, shape, cond: dict,
                     uncond: dict, seed: Optional[int] = None, noise=None,
                     generator: Optional[torch.Generator] = None,
                     on_step=None):
    """Seed noise (or take ``noise``) and denoise. The noise is standard
    normal fp32 from ``generator`` (or one seeded with ``seed``) on the
    model's device; torch and JAX generators differ, so parity tests pass
    ``noise`` explicitly. Under tensor parallelism every rank integrates
    rank 0's noise, broadcast, whatever seed the others were given."""
    device = next(model.parameters()).device
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(
                0 if seed is None else seed)
        noise = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device)
    noise = noise.to(device=device, dtype=torch.float32)
    if model.tp is not None:
        noise = model.tp.broadcast(noise.contiguous(), src=0)
    return denoise(model, spec, noise, cond, uncond, on_step=on_step)
