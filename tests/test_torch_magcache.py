"""MagCache in the port's sampler against the JAX package: the host
schedule for exact bool equality (the four YAMLs that carry ratios, several
step counts, with and without CFG), then whole fp32 Euler runs with
MagCache on from the same noise, tolerance 2e-4 (the JAX golden tests' fp32
bound): batched, sequential and no CFG, a table where only one branch
skips, and NABLA with two prompts in one call. The modulation weights are
random (``random_dit_pair``), so no block is an identity and a skipped
block shows. Controls: MagCache off, and a residual forced to zero, must
each fail the bound. Then MagCache under tp = 2 on gloo CPU ranks against
tp 1 at the smoke's ``TP_BOUND``, with the zero residual as its control."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TP_BOUND
from kandinsky5_tpu.config import MagCacheConfig as JaxMagCache
from kandinsky5_tpu.config import load_config as jax_load_config
from kandinsky5_tpu.sampling import DenoiseSpec as JaxSpec
from kandinsky5_tpu.sampling import generate_latents as jax_generate
from kandinsky5_tpu.sampling import magcache_schedule as jax_schedule
from kandinsky5_tpu_torch import sampling
from kandinsky5_tpu_torch.config import CONFIG_DIR, MagCacheConfig, load_config
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    generate_latents,
    magcache_schedule,
)

from . import _torch_tp_ranks as ranks_mod
from .ref import TINY_COND
from ._torch_parity import both_cfgs, rand, random_dit_pair, to_np

TOL = dict(rtol=2e-4, atol=2e-4)
TINY_D64 = dict(TINY_COND, model_dim=128, ff_dim=256, axes_dims=(16, 24, 24),
                num_visual_blocks=2, patch_size=(1, 2, 2))
YAMLS = ("config_5s_sft", "config_10s_sft", "config_5s_nocfg",
         "config_10s_nocfg")
NAMES = ("text_embeds", "pooled_embed", "mask")

# 6 steps: with CFG, steps 2 and 5 skip both branches, 1 and 4 only the
# uncond one; without CFG, steps 2, 3 and 5 skip
SINE = dict(mag_ratios=tuple(1.0 + 0.02 * np.sin(np.arange(12))),
            threshold=0.05, K=2, retention_ratio=0.25)
# the cond branch's ratios stay near 1 and the uncond one's never do: the
# cond branch skips steps 2, 3 and 5 while the uncond branch runs them
ONE_BRANCH = dict(mag_ratios=tuple(
    [r for i in range(1, 6) for r in (1.0 + 0.002 * i, 1.3)]),
    threshold=0.05, K=2, retention_ratio=0.25)
# 4 steps: steps 1 and 2 skip (both branches with CFG)
SHORT = dict(mag_ratios=tuple(1.0 + 0.01 * np.sin(np.arange(6))),
             threshold=0.05, K=2, retention_ratio=0.25)


@pytest.mark.parametrize("steps", [50, 16, 7, 1])
@pytest.mark.parametrize("name", YAMLS)
def test_schedule_matches_jax(name, steps):
    """The port's schedule equals JAX's exactly, with and without CFG, at
    the table's 50 steps and at counts that re-interpolate it."""
    mine = load_config(f"{CONFIG_DIR}/{name}.yaml").magcache
    theirs = jax_load_config(f"kandinsky5_tpu/configs/{name}.yaml").magcache
    assert len(mine.mag_ratios) == 98 and mine == MagCacheConfig(
        **{k: getattr(theirs, k) for k in ("mag_ratios", "threshold", "K",
                                           "retention_ratio")})
    for no_cfg in (False, True):
        got = magcache_schedule(mine, steps, no_cfg)
        want = jax_schedule(theirs, steps, no_cfg)
        assert got.dtype == np.bool_ and got.shape == (steps, 2)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", YAMLS)
def test_released_schedules_run_24_of_50_steps(name):
    """At the YAMLs' 50 steps and guidance, the visual blocks run on 24
    steps: with CFG both branches skip the same 26 steps (10, 11, 13, 14,
    ..., 46, 47), without CFG the one branch skips 26 (..., 46, 48). The
    smoke's launch gate counts on it."""
    conf = load_config(f"{CONFIG_DIR}/{name}.yaml")
    spec = DenoiseSpec(dit_params=conf.model.dit_params, num_steps=50,
                       guidance_weight=conf.model.guidance_weight,
                       scheduler_scale=5.0, scale_factor=(1.0, 2.0, 2.0))
    skip = sampling.skip_schedule(spec, conf.magcache)
    runs = ~skip[:, :1 + spec.use_cfg].all(axis=1)
    assert runs.sum() == 24 and skip[:, 0].sum() == 26
    if spec.use_cfg:
        np.testing.assert_array_equal(skip[:, 0], skip[:, 1])
    else:
        assert not skip[:, 1].any()
    assert list(np.flatnonzero(skip[:, 0])[:4]) == [10, 11, 13, 14]
    assert list(np.flatnonzero(skip[:, 0])[-2:]) == (
        [46, 47] if spec.use_cfg else [46, 48])


def _cond(rng, b, jcfg, n_valid):
    text = rand(rng, b, 8, jcfg.in_text_dim)
    pooled = rand(rng, b, jcfg.in_text_dim2)
    mask = np.arange(8)[None].repeat(b, 0) < np.asarray(n_valid)[:, None]
    return text, pooled, mask


CASES = {
    # (guidance, sequential, ratios, steps, batch, nabla)
    "cfg_batched": (3.5, False, SINE, 6, 1, False),
    "cfg_sequential": (3.5, True, SINE, 6, 1, False),
    "nocfg": (1.0, False, SINE, 6, 1, False),
    "one_branch_skips": (3.5, False, ONE_BRANCH, 6, 1, False),
    "nabla_batch2": (3.5, True, SHORT, 4, 2, True),
}


def _run_pair(case, magcache=True):
    """JAX's and the port's latents for ``case``, from one noise."""
    guidance, sequential, ratios, steps, batch, nabla = CASES[case]
    jcfg, pcfg = both_cfgs(**TINY_D64)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=5)
    rng = np.random.default_rng(6)
    shape = ((batch, 4, 32, 32, jcfg.in_visual_dim) if nabla
             else (batch, 2, 4, 6, jcfg.in_visual_dim))
    noise = rand(rng, *shape)
    cond = _cond(rng, batch, jcfg, [6, 3][:batch])
    uncond = _cond(rng, batch, jcfg, [4, 8][:batch])
    kw = dict(num_steps=steps, guidance_weight=guidance, scheduler_scale=5.0,
              scale_factor=(1.0, 2.0, 2.0), sequential_cfg=sequential,
              attn_impl="auto")
    jkw = {}
    if nabla:
        kw.update(attention_type="nabla", nabla_P=0.9, nabla_wT=3,
                  nabla_wH=1, nabla_wW=1)
        jkw = dict(nabla_q_rows=1, nabla_method="sort",
                   nabla_max_density=None)
    want = jax_generate(jparams, JaxSpec(dit_params=jcfg, **kw, **jkw), shape,
                        dict(zip(NAMES, map(jnp.asarray, cond))),
                        dict(zip(NAMES, map(jnp.asarray, uncond))), seed=0,
                        noise=jnp.asarray(noise), magcache=JaxMagCache(**ratios))
    got = generate_latents(model, DenoiseSpec(dit_params=pcfg, **kw), shape,
                           dict(zip(NAMES, map(torch.from_numpy, cond))),
                           dict(zip(NAMES, map(torch.from_numpy, uncond))),
                           noise=torch.from_numpy(noise),
                           magcache=MagCacheConfig(**ratios) if magcache
                           else None)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    return to_np(got), to_np(want)


@pytest.mark.parametrize("case", list(CASES))
def test_magcache_latents_match_jax(case):
    got, want = _run_pair(case)
    np.testing.assert_allclose(got, want, **TOL)


def test_magcache_off_fails_the_bound():
    """Control: the same run without MagCache is further from JAX's
    MagCache run than 10 x the tolerance."""
    got, want = _run_pair("cfg_batched", magcache=False)
    assert np.abs(got - want).max() > 10 * TOL["atol"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


def _zero_residual(monkeypatch):
    real = sampling._dit_call

    def dit_call(*args, **kw):
        pred, residual = real(*args, **kw)
        return pred, None if residual is None else torch.zeros_like(residual)

    monkeypatch.setattr(sampling, "_dit_call", dit_call)


@pytest.mark.parametrize("case", ["cfg_batched", "one_branch_skips"])
def test_zero_residual_fails_the_bound(case, monkeypatch):
    """Control: a skipped call that adds a zero residual (the blocks'
    output ignored) fails the bound."""
    _zero_residual(monkeypatch)
    got, want = _run_pair(case)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_magcache_under_tp_matches_tp1():
    """Two gloo CPU ranks (each rank's share of the DiT, the same host
    schedule) against the port's tp 1 run of the same weights and noise:
    rel_l2 within TP_BOUND; with the residual forced to zero on the ranks
    the bound fails."""
    jcfg, pcfg = both_cfgs(**TINY_D64)
    _, model = random_dit_pair(jcfg, pcfg, seed=5)
    rng = np.random.default_rng(6)
    shape = (1, 2, 4, 6, jcfg.in_visual_dim)
    noise = rand(rng, *shape)
    cond = dict(zip(NAMES, _cond(rng, 1, jcfg, [6])))
    uncond = dict(zip(NAMES, _cond(rng, 1, jcfg, [4])))
    spec_kw = dict(num_steps=6, guidance_weight=3.5, scheduler_scale=5.0,
                   scale_factor=(1.0, 2.0, 2.0), attn_impl="dense")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    got = launch(ranks_mod.magcache_run, 2, "gloo", "cpu",
                 args=(TINY_D64, state, noise, cond, uncond, spec_kw, SINE),
                 timeout=300)
    want = to_np(generate_latents(
        model, DenoiseSpec(dit_params=pcfg, **spec_kw), shape,
        {k: torch.from_numpy(v) for k, v in cond.items()},
        {k: torch.from_numpy(v) for k, v in uncond.items()},
        noise=torch.from_numpy(noise), magcache=MagCacheConfig(**SINE)))
    for r in got:
        assert r["all_reduces"] > 0
        assert _rel(r["latents"], want) < TP_BOUND
        assert _rel(r["latents_zero_residual"], want) > TP_BOUND
    np.testing.assert_array_equal(got[0]["latents"], got[1]["latents"])
