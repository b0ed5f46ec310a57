"""Flow-matching Euler sampling in PyTorch.

Counterpart of ``kandinsky5_tpu/sampling.py``: the timestep grid,
:class:`DenoiseSpec`, the visual-condition input, the Euler loop of
``denoise``/``denoise_span`` as a Python loop, classifier-free guidance
both as one batch-2 call and as two sequential calls, the NABLA sparse
path of the 10 s configs (``attention_type="nabla"``, faithful mode),
MagCache and :func:`generate_latents` with explicit noise.

MagCache is a host schedule (:func:`magcache_schedule`): its decisions
depend on the calibrated ``mag_ratios`` alone, never on an activation, so
each step knows before it runs which CFG branches skip the visual blocks.
A skipping branch adds its cached residual (the blocks' last output minus
their input) to its visual tokens; when every branch of a call skips, the
visual blocks do not run at all. The text blocks, the prologue and the
epilogue run on every step.

Data parallelism (``dp``, a :class:`~kandinsky5_tpu_torch.parallel.
DataParallel` group; the JAX package's "dp" mesh axis): each DiT call's
batch, ``b_eff`` items in the order [cond x B, uncond x B] with the CFG
pair batched, is split into dp contiguous blocks; each rank forwards its
block, the predictions are all-gathered over dp, and every rank combines
the CFG velocity on the whole batch and takes the same Euler step. Where
dp does not divide a call's batch, every rank runs it whole (replicated),
as the JAX package's shard_map bodies do. Under MagCache a rank takes its
items' columns of the skip schedule and carries its items' rows of the
residual. Sequence parallelism runs inside the DiT (``models/dit.py``
gathers the visual blocks' output over sp), so a call's prediction is
whole on every rank and the sampler is the same on a (dp, sp, tp) mesh.
The noise is rank 0's on every rank of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from kandinsky5_tpu_torch.config import DiTParams, MagCacheConfig
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


def magcache_schedule(mag_cfg: MagCacheConfig, num_steps: int,
                      no_cfg: bool) -> np.ndarray:
    """The skip decisions of MagCache for every DiT call: bool (num_steps,
    2), [cond, uncond] per step (the uncond column stays False without
    CFG). The calibrated ratios cover the table's step count; another count
    takes each branch's ratios by nearest neighbour."""
    ratios = np.array([1.0, 1.0] + list(mag_cfg.mag_ratios), dtype=np.float64)
    total = num_steps * 2
    if len(ratios) != total:
        def nearest(src, n):
            if n == 1:
                return np.array([src[-1]])
            scale = (len(src) - 1) / (n - 1)
            return src[np.round(np.arange(n) * scale).astype(int)]

        con = nearest(ratios[0::2], num_steps)
        ucon = nearest(ratios[1::2], num_steps)
        ratios = np.stack([con, ucon], axis=1).reshape(-1)

    skip = np.zeros((num_steps, 2), dtype=bool)
    acc_ratio = [1.0, 1.0]
    acc_steps = [0, 0]
    acc_err = [0.0, 0.0]
    warmup = int(total * mag_cfg.retention_ratio)
    calls = range(0, total, 2) if no_cfg else range(total)
    for cnt in calls:
        b = cnt % 2
        step = cnt // 2
        if cnt >= warmup:
            acc_ratio[b] *= ratios[cnt]
            acc_steps[b] += 1
            acc_err[b] += abs(1 - acc_ratio[b])
            if acc_err[b] < mag_cfg.threshold and acc_steps[b] <= mag_cfg.K:
                skip[step, b] = True
            else:
                acc_ratio[b], acc_steps[b], acc_err[b] = 1.0, 0, 0.0
    return skip


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


def skip_schedule(spec: DenoiseSpec,
                  magcache: Optional[MagCacheConfig]) -> Optional[np.ndarray]:
    """The (num_steps, 2) MagCache schedule of a run, or None when MagCache
    is off (no config, or one without ratios)."""
    if magcache is None or len(magcache.mag_ratios) == 0:
        return None
    return magcache_schedule(magcache, spec.num_steps, no_cfg=not spec.use_cfg)


def denoise_residual0(spec: DenoiseSpec, noise_shape) -> Tuple[int, int]:
    """(b_eff, seq_len) of the MagCache residual: one row per DiT batch row
    (both CFG branches), one per visual token."""
    cfg = spec.dit_params
    batch = noise_shape[0]
    b_eff = 2 * batch if spec.use_cfg else batch
    t, h, w = token_grid(cfg, noise_shape)
    return b_eff, t * h * w


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


def _dp(dp):
    """The group when it splits anything (more than one rank), else None."""
    return dp if dp is not None and dp.size > 1 else None


def local_rows(nb: int, dp) -> int:
    """The rows of an ``nb``-item DiT call that one dp rank forwards: its
    block when dp divides ``nb``, else all of them (replicated)."""
    dp = _dp(dp)
    return nb if dp is None or nb % dp.size else nb // dp.size


def dp_splits(spec: DenoiseSpec, batch: int, dp) -> bool:
    """Whether dp splits the DiT calls of a ``batch``-prompt run (False:
    every rank runs them whole, or there is no dp)."""
    nb = batch if spec.sequential_cfg or not spec.use_cfg else 2 * batch
    return _dp(dp) is not None and local_rows(nb, dp) < nb


def _dit_call(model, spec: DenoiseSpec, sparse, model_in, text, pooled, mask,
              t, skip=None, residual=None):
    """One DiT evaluation. ``skip`` (host bools, one per batch row) and
    ``residual`` (B, S, D) are MagCache's: None runs the visual blocks with
    no residual kept. Returns (velocity fp32, residual)."""
    nb = model_in.shape[0]
    to_fractal = sparse is not None
    time_vec = torch.full((nb,), float(t), dtype=torch.float32,
                          device=model_in.device) * 1000.0
    visual, text_o, time_embed, rope, grid = dit_prologue(
        model, model_in, text, pooled, time_vec, mask, spec.scale_factor,
        spec.attn_impl, to_fractal)
    if skip is None:
        visual = dit_visual_blocks(model, visual, text_o, time_embed, rope,
                                   mask, spec.attn_impl, sparse)
    elif all(skip):
        visual = visual + residual
    else:
        out = dit_visual_blocks(model, visual, text_o, time_embed, rope, mask,
                                spec.attn_impl, sparse)
        new_res = (out.float() - visual.float()).to(model.dtype)
        if any(skip):
            # a skipping branch reuses its residual while the other runs
            sk = torch.tensor(skip, device=visual.device)[:, None, None]
            out = torch.where(sk, visual + residual, out)
            new_res = torch.where(sk, residual, new_res)
        visual, residual = out, new_res
    pred = dit_epilogue(model, visual, time_embed, grid, to_fractal).float()
    return pred, residual


def dp_dit_call(model, spec: DenoiseSpec, sparse, model_in, text, pooled,
                mask, t, skip=None, residual=None, dp=None):
    """:func:`_dit_call` on the whole batch of ``model_in`` under ``dp``:
    this rank forwards its block of the batch (``residual`` holds its
    rows), then the predictions are all-gathered; where dp does not divide
    the batch, the whole batch (replicated). Returns (the whole batch's
    velocity fp32, this rank's residual)."""
    nb = model_in.shape[0]
    n = local_rows(nb, dp)
    if n == nb:
        return _dit_call(model, spec, sparse, model_in, text, pooled, mask, t,
                         skip, residual)
    rows = slice(dp.rank * n, (dp.rank + 1) * n)
    pred, residual = _dit_call(model, spec, sparse, model_in[rows],
                               text[rows], pooled[rows], mask[rows], t,
                               None if skip is None else skip[rows], residual)
    return dp.all_gather(pred), residual


@torch.no_grad()
def denoise_span(model: DiffusionTransformer3D, spec: DenoiseSpec, noise,
                 times, dts, cond: dict, uncond: dict, skip=None,
                 residual=None, on_step=None, dp=None):
    """Integrate the Euler steps ``times``/``dts`` (host arrays) from
    ``noise`` (B, T, H, W, C) fp32. cond/uncond: {"text_embeds",
    "pooled_embed", "mask"}. ``skip`` is the (k, 2) slice of the MagCache
    schedule for these steps and ``residual`` the (b_eff, S, D) residual
    carried in (zeros at step 0, :func:`zero_residual`; under ``dp`` this
    rank's rows of it); both None without MagCache. ``on_step(i)`` is
    called after each step. ``dp`` splits each DiT call's batch over its
    ranks (see the module's docstring). Returns (x, residual)."""
    cfg = spec.dit_params
    if spec.int8_linear != is_quantized(model):
        raise ValueError(f"spec.int8_linear is {spec.int8_linear} but the "
                         "model is " + ("" if is_quantized(model) else "not ")
                         + "W8A8-quantized")
    if (skip is None) != (residual is None):
        raise ValueError("MagCache takes a skip schedule and a residual "
                         "together")
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
        skip_c = skip_u = None
        if skip is not None:
            skip_c = (bool(skip[i][0]),) * batch
            skip_u = (bool(skip[i][1]),) * batch
        if use_cfg and spec.sequential_cfg:
            res_c = res_u = None
            if residual is not None:
                rows = local_rows(batch, dp)
                res_c, res_u = residual[:rows], residual[rows:]
            v_cond, res_c = dp_dit_call(model, spec, sparse, model_in,
                                        cond["text_embeds"],
                                        cond["pooled_embed"], cond["mask"],
                                        t, skip_c, res_c, dp)
            v_uncond, res_u = dp_dit_call(model, spec, sparse, model_in,
                                          uncond["text_embeds"],
                                          uncond["pooled_embed"],
                                          uncond["mask"], t, skip_u, res_u,
                                          dp)
            if residual is not None:
                residual = torch.cat([res_c, res_u])
            velocity = v_uncond + spec.guidance_weight * (v_cond - v_uncond)
        elif use_cfg:
            pred, residual = dp_dit_call(
                model, spec, sparse, torch.cat([model_in, model_in]), text,
                pooled, mask, t, None if skip is None else skip_c + skip_u,
                residual, dp)
            v_cond, v_uncond = pred[:batch], pred[batch:]
            velocity = v_uncond + spec.guidance_weight * (v_cond - v_uncond)
        else:
            velocity, residual = dp_dit_call(
                model, spec, sparse, model_in, cond["text_embeds"],
                cond["pooled_embed"], cond["mask"], t, skip_c, residual, dp)
        x = x + float(dt) * velocity
        if on_step is not None:
            on_step(i)
    return x, residual


def zero_residual(model, spec: DenoiseSpec, noise_shape, dp=None):
    """MagCache's residual at step 0: zeros (b_eff, S, D) in the model's
    dtype on its device; under ``dp`` this rank's rows of it."""
    b_eff, seq_len = denoise_residual0(spec, noise_shape)
    if spec.use_cfg and spec.sequential_cfg:
        rows = 2 * local_rows(b_eff // 2, dp)
    else:
        rows = local_rows(b_eff, dp)
    return torch.zeros((rows, seq_len, spec.dit_params.model_dim),
                       dtype=model.dtype,
                       device=next(model.parameters()).device)


def whole_residual(residual, spec: DenoiseSpec, batch: int, dp=None):
    """The whole (b_eff, S, D) MagCache residual, rows [cond x B, uncond x
    B], from the rows of it this rank carries under ``dp``
    (:func:`denoise_span`'s ``residual``, ``batch`` = B): gathered over dp
    where dp splits the DiT calls (with sequential CFG each rank carries
    [its cond rows, its uncond rows], put back in order), as it is where
    every rank runs them whole. Every rank of the dp group calls it."""
    dp = _dp(dp)
    if residual is None or dp is None:
        return residual
    if spec.use_cfg and spec.sequential_cfg:
        rows = local_rows(batch, dp)
        if rows == batch:
            return residual
        parts = dp.all_gather(residual).split(2 * rows)
        return torch.cat([p[:rows] for p in parts]
                         + [p[rows:] for p in parts])
    nb = 2 * batch if spec.use_cfg else batch
    if local_rows(nb, dp) == nb:
        return residual
    return dp.all_gather(residual)


def local_residual(residual, spec: DenoiseSpec, batch: int, dp=None):
    """This dp rank's rows of the whole residual: the inverse of
    :func:`whole_residual`, with no collective."""
    dp = _dp(dp)
    if residual is None or dp is None:
        return residual
    if spec.use_cfg and spec.sequential_cfg:
        rows = local_rows(batch, dp)
        if rows == batch:
            return residual
        mine = slice(dp.rank * rows, (dp.rank + 1) * rows)
        return torch.cat([residual[:batch][mine], residual[batch:][mine]])
    nb = 2 * batch if spec.use_cfg else batch
    n = local_rows(nb, dp)
    return residual if n == nb else residual[dp.rank * n:(dp.rank + 1) * n]


def denoise(model, spec: DenoiseSpec, noise, cond: dict, uncond: dict,
            skip=None, on_step=None, dp=None):
    """The full Euler integration over :func:`timestep_grid`; ``skip`` is
    the MagCache schedule (:func:`magcache_schedule`), None for off;
    ``dp`` as in :func:`denoise_span`."""
    ts = timestep_grid(spec.num_steps, spec.scheduler_scale)
    residual = (None if skip is None
                else zero_residual(model, spec, noise.shape, dp))
    return denoise_span(model, spec, noise, ts[:-1], np.diff(ts), cond,
                        uncond, skip=skip, residual=residual,
                        on_step=on_step, dp=dp)[0]


def seeded_noise(model, shape, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
    """Standard normal fp32 noise of ``shape`` on the model's device from
    ``generator``, or one seeded with ``seed`` (0 when None)."""
    device = next(model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            0 if seed is None else seed)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device)


def generate_latents(model, spec: DenoiseSpec, shape, cond: dict,
                     uncond: dict, seed: Optional[int] = None, noise=None,
                     generator: Optional[torch.Generator] = None,
                     magcache: Optional[MagCacheConfig] = None,
                     on_step=None, dp=None):
    """Seed noise (or take ``noise``) and denoise, with MagCache's schedule
    when ``magcache`` carries ratios. The noise is standard normal fp32 from
    ``generator`` (or one seeded with ``seed``) on the model's device; torch
    and JAX generators differ, so parity tests pass ``noise`` explicitly.
    On a mesh (the model's tp and sp groups, ``dp``) every rank integrates
    rank 0's noise, broadcast over tp, then over sp, then over dp, whatever
    seed the others were given; the MagCache schedule is the same host
    array on every rank."""
    device = next(model.parameters()).device
    if noise is None:
        noise = seeded_noise(model, shape, seed, generator)
    noise = noise.to(device=device, dtype=torch.float32).contiguous()
    # each group's rank 0 holds, after the broadcasts before it, the noise
    # of the rank with every earlier index 0: (d, s, 0), then (d, 0, t),
    # then (0, s, t) all hold rank 0's
    if model.tp is not None:
        noise = model.tp.broadcast(noise, src=0)
    if model.sp is not None:
        noise = model.sp.broadcast(noise, src=0)
    if _dp(dp) is not None:
        noise = dp.broadcast(noise, src=0)
    return denoise(model, spec, noise, cond, uncond,
                   skip=skip_schedule(spec, magcache), on_step=on_step,
                   dp=dp)
