"""The port's sampler (kandinsky5_tpu_torch/sampling.py) against the JAX
one: the timestep grid exactly, and whole Euler runs from the same noise
without and with classifier-free guidance (batch-2 and sequential), fp32.
Tolerance 2e-4, the JAX golden tests' fp32 bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.sampling import DenoiseSpec as JaxSpec
from kandinsky5_tpu.sampling import generate_latents as jax_generate
from kandinsky5_tpu.sampling import timestep_grid as jax_grid
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    generate_latents,
    timestep_grid,
)

from .ref import TINY_COND
from ._torch_parity import both_cfgs, rand, random_dit_pair, to_np

TINY_D64 = dict(TINY_COND, model_dim=128, ff_dim=256, axes_dims=(16, 24, 24),
                num_visual_blocks=2, patch_size=(1, 2, 2))


@pytest.mark.parametrize("n,s", [(16, 10.0), (50, 5.0), (4, 1.0)])
def test_timestep_grid_exact(n, s):
    np.testing.assert_array_equal(timestep_grid(n, s), jax_grid(n, s))
    assert timestep_grid(n, s).dtype == np.float32


def _cond(rng, b, jcfg, n_valid):
    text = rand(rng, b, 8, jcfg.in_text_dim)
    pooled = rand(rng, b, jcfg.in_text_dim2)
    mask = np.arange(8)[None].repeat(b, 0) < np.asarray(n_valid)[:, None]
    return text, pooled, mask


@pytest.mark.parametrize("guidance,sequential", [(1.0, False), (3.5, False),
                                                 (3.5, True)],
                         ids=["nocfg", "cfg_batch2", "cfg_sequential"])
def test_generate_latents_matches_jax(guidance, sequential):
    jcfg, pcfg = both_cfgs(**TINY_D64)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=5)
    rng = np.random.default_rng(6)
    shape = (1, 2, 4, 6, jcfg.in_visual_dim)
    noise = rand(rng, *shape)
    cond = _cond(rng, 1, jcfg, [6])
    uncond = _cond(rng, 1, jcfg, [4])
    kw = dict(num_steps=3, guidance_weight=guidance, scheduler_scale=5.0,
              scale_factor=(1.0, 2.0, 2.0), sequential_cfg=sequential)
    jspec = JaxSpec(dit_params=jcfg, attn_impl="auto", **kw)
    pspec = DenoiseSpec(dit_params=pcfg, attn_impl="auto", **kw)
    names = ("text_embeds", "pooled_embed", "mask")
    want = jax_generate(jparams, jspec, shape,
                        dict(zip(names, map(jnp.asarray, cond))),
                        dict(zip(names, map(jnp.asarray, uncond))),
                        seed=0, noise=jnp.asarray(noise))
    got = generate_latents(model, pspec, shape,
                           dict(zip(names, map(torch.from_numpy, cond))),
                           dict(zip(names, map(torch.from_numpy, uncond))),
                           noise=torch.from_numpy(noise))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("guidance", [1.0, 3.5], ids=["nocfg", "cfg_sequential"])
def test_denoise_nabla_matches_jax(guidance):
    """Two Euler steps of the NABLA path (fractal order, faithful adaptive
    mask, K6's plain version) against the JAX denoise from the same noise,
    on a (4, 16, 16) token grid of 2x2 tiles per frame with a narrow STA
    window (wT 3, wH 1, wW 1)."""
    jcfg, pcfg = both_cfgs(**TINY_D64)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=11)
    rng = np.random.default_rng(12)
    shape = (1, 4, 32, 32, jcfg.in_visual_dim)
    noise = rand(rng, *shape)
    cond = _cond(rng, 1, jcfg, [6])
    uncond = _cond(rng, 1, jcfg, [4])
    kw = dict(num_steps=2, guidance_weight=guidance, scheduler_scale=5.0,
              scale_factor=(1.0, 2.0, 2.0), sequential_cfg=guidance != 1.0,
              attention_type="nabla", nabla_P=0.9, nabla_wT=3, nabla_wH=1,
              nabla_wW=1, attn_impl="auto")
    jspec = JaxSpec(dit_params=jcfg, nabla_q_rows=1, nabla_method="sort",
                    nabla_max_density=None, **kw)
    pspec = DenoiseSpec(dit_params=pcfg, **kw)
    names = ("text_embeds", "pooled_embed", "mask")
    want = jax_generate(jparams, jspec, shape,
                        dict(zip(names, map(jnp.asarray, cond))),
                        dict(zip(names, map(jnp.asarray, uncond))),
                        seed=0, noise=jnp.asarray(noise))
    got = generate_latents(model, pspec, shape,
                           dict(zip(names, map(torch.from_numpy, cond))),
                           dict(zip(names, map(torch.from_numpy, uncond))),
                           noise=torch.from_numpy(noise))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)
