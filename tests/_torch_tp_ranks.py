"""What the ranks of ``tests/test_torch_tp.py`` run, in gloo CPU rank
processes started by ``kandinsky5_tpu_torch.parallel.launch``. This module
imports the port alone (no JAX), so a rank starts quickly; the test holds
what the ranks return against the JAX package's (1, 1, 2) mesh."""

from unittest import mock

import numpy as np
import torch

from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.config import Config, DiTParams, MetricsConfig, ModelConfig
from kandinsky5_tpu_torch.models import nn as port_nn
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    dit_forward,
    fast_init_dit_params,
)
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.parallel.sharding import (
    shard_dit_state_dict,
    shard_tensor,
)
from kandinsky5_tpu_torch.pipeline import RESOLUTIONS, Kandinsky5T2VPipeline, TextEmbeddings
from kandinsky5_tpu_torch.sampling import DenoiseSpec, denoise, generate_latents

FF_W1 = "visual_transformer_blocks.0.feed_forward.in_layer.weight"
FF_W2 = "visual_transformer_blocks.0.feed_forward.out_layer.weight"
# the pipeline case: a tiny DiT with visual conditioning, a 64 x 64 image
PIPE_DIT = dict(in_visual_dim=16, out_visual_dim=16, in_text_dim=32,
                in_text_dim2=16, time_dim=32, model_dim=128, ff_dim=256,
                num_text_blocks=1, num_visual_blocks=2, axes_dims=(16, 24, 24),
                visual_cond=True)


class NoSum:
    """A group whose all-reduce leaves each rank's partial sum as it is:
    the control for a Megatron FF that forgets its all-reduce."""

    def all_reduce(self, x):
        return x


def feed_forward_without_sum(p, x, tp=None, _real=port_nn.feed_forward):
    return _real(p, x, None if tp is None else NoSum())


class StubEmbedder:
    """Seeded conditioning (the same on every rank) with a padded mask."""

    def encode(self, texts, type_of_content="video"):
        g = torch.Generator().manual_seed(len(texts[0]))
        mask = torch.arange(8)[None].repeat(len(texts), 1) < 5
        return TextEmbeddings(torch.randn(len(texts), 8, 32, generator=g),
                              torch.randn(len(texts), 16, generator=g), mask)


def pipeline(tp=None, decode_mode=None, vae_cls=HunyuanVideoVAE,
             guidance_weight=1.0, dit_kw=None, **kw):
    """The tiny pipeline: a seeded DiT (``PIPE_DIT``, updated by ``dit_kw``;
    sharded by the pipeline under ``tp``, a rank's place) and the full VAE
    decoder; ``kw`` go to the pipeline. The caller admits the 64 x 64 image
    (``RESOLUTIONS[512] = [(64, 64)]``)."""
    cfg = DiTParams(**dict(PIPE_DIT, **(dit_kw or {})))
    dit = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32,
                               seed=0, scale=0.05)
    conf = Config(model=ModelConfig(dit_params=cfg, num_steps=2,
                                    guidance_weight=guidance_weight),
                  metrics=MetricsConfig())
    vae = vae_cls(init_vae_params(device="cpu", dtype=torch.float32, seed=1),
                  dtype=torch.float32)
    return Kandinsky5T2VPipeline(dit, conf, StubEmbedder(), vae,
                                 decode_mode=decode_mode, tp=tp, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def run(mesh, ff_case, dit_case):
    """Everything the test asks of two ranks, in one launch."""
    tp = mesh.tp
    torch.set_num_threads(2)
    out = {}
    # the Megatron FF with K8's plain version, bf16
    x, w1, w2 = (_t(a).bfloat16() for a in ff_case)
    w1 = shard_tensor(FF_W1, w1, tp.rank, tp.size)
    w2 = shard_tensor(FF_W2, w2, tp.rank, tp.size)
    out["ff"] = port_nn.sharded_fused_ff(x, w1, w2, tp).float().numpy()

    # the DiT forward and denoise, fp32, from the reference-named weights
    cfg_kw, state_dict, fwd, noise, cond, uncond, spec_kw = dit_case
    cfg = DiTParams(**cfg_kw)
    model = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32,
                                   tp=tp)
    dit_from_state_dict(model, shard_dit_state_dict(state_dict, tp.rank,
                                                    tp.size))
    args = [_t(fwd[k]) for k in ("x", "text", "pooled", "time", "mask")]
    kw = dict(scale_factor=(1.0, 2.0, 2.0), attn_impl="dense")
    tp.reset_stats()
    out["forward"] = dit_forward(model, *args, **kw).numpy()
    out["forward_all_reduces"] = tp.calls
    with mock.patch.object(port_nn, "feed_forward", feed_forward_without_sum):
        out["forward_no_ff_sum"] = dit_forward(model, *args, **kw).numpy()
    spec = DenoiseSpec(dit_params=cfg, **spec_kw)
    cond = {k: _t(v) for k, v in cond.items()}
    uncond = {k: _t(v) for k, v in uncond.items()}
    out["denoise"] = denoise(model, spec, _t(noise), cond, uncond).numpy()
    # each rank seeds its own noise; the ranks must integrate rank 0's
    out["latents_seeded"] = generate_latents(
        model, spec, noise.shape, cond, uncond, seed=10 + tp.rank).numpy()

    RESOLUTIONS[512] = [(64, 64)]  # for good: this is a rank process
    pipe = pipeline(tp)
    frames = pipe("a test image", time_length=0, width=64, height=64,
                  seed=3 + tp.rank, expand_prompts=False)
    out["frames"] = frames
    out["decode_mode"] = pipe.decode_mode
    out["decoded_tiles"] = pipe.timings["decoded_tiles"]
    return out


def card_forward(mesh, cfg_kw, seed):
    """A bf16 DiT forward on the card: the rank's share of the seeded DiT,
    built one parameter at a time, on seeded inputs; the output and the
    kernel launches it made."""
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard

    tp = mesh.tp
    cfg = DiTParams(**cfg_kw)
    model = fast_init_dit_shard(cfg, tp, seed=seed)
    args = card_inputs(cfg, tp.device)
    _kernels.reset_launches()
    out = dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0))
    torch.cuda.synchronize()
    return out.float().cpu(), dict(_kernels.LAUNCHES), tp.calls


def card_inputs(cfg, device, latent=(1, 2, 32, 32), text_len=64):
    """Seeded (x, text, pooled, time, mask) of a forward: 2 x 16 x 16 = 512
    visual tokens (K8's row minimum), a partly padded text."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(*latent, cfg.visual_embed_dim, generator=g)
    text = torch.randn(1, text_len, cfg.in_text_dim, generator=g)
    pooled = torch.randn(1, cfg.in_text_dim2, generator=g)
    mask = torch.arange(text_len)[None] < text_len - 9
    return (x.to(device, torch.bfloat16), text.to(device, torch.bfloat16),
            pooled.to(device, torch.bfloat16),
            torch.tensor([500.0], device=device), mask.to(device))


def magcache_run(mesh, cfg_kw, state_dict, noise, cond, uncond, spec_kw,
                 mag_kw):
    """A MagCache denoise on the rank's share of the DiT, fp32; then the
    same with every carried residual forced to zero (the control)."""
    from kandinsky5_tpu_torch import sampling
    from kandinsky5_tpu_torch.config import MagCacheConfig

    tp = mesh.tp
    torch.set_num_threads(2)
    cfg = DiTParams(**cfg_kw)
    model = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32,
                                   tp=tp)
    dit_from_state_dict(model, shard_dit_state_dict(state_dict, tp.rank,
                                                    tp.size))
    spec = DenoiseSpec(dit_params=cfg, **spec_kw)
    cond = {k: _t(v) for k, v in cond.items()}
    uncond = {k: _t(v) for k, v in uncond.items()}
    mag = MagCacheConfig(**mag_kw)
    tp.reset_stats()
    out = {"latents": generate_latents(model, spec, noise.shape, cond, uncond,
                                       noise=_t(noise), magcache=mag).numpy(),
           "all_reduces": tp.calls}
    real = sampling._dit_call

    def zero_residual(*args, **kw):
        pred, residual = real(*args, **kw)
        return pred, torch.zeros_like(residual)

    with mock.patch.object(sampling, "_dit_call", zero_residual):
        out["latents_zero_residual"] = generate_latents(
            model, spec, noise.shape, cond, uncond, noise=_t(noise),
            magcache=mag).numpy()
    return out
