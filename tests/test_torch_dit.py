"""The port's DiT (kandinsky5_tpu_torch/models/dit.py) against the JAX DiT
on the same weights (through ``dit_state_dict_from_jax``) and inputs, fp32.

Tolerance 2e-4 (the JAX golden tests' fp32 bound): the port's attention
runs K1's / K4's plain versions where JAX (on the CPU) runs dense
softmax — the same function up to exp2 vs exp and summation order — and
the FF runs K2's plain version where JAX runs the XLA chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.checkpoint import convert_dit_state_dict
from kandinsky5_tpu.checkpoint import dit_params_to_state_dict
from kandinsky5_tpu.models.dit import SparseParams as JaxSparseParams
from kandinsky5_tpu.models.dit import dit_forward as jax_dit_forward
from kandinsky5_tpu.models.dit import init_dit_params as jax_init_dit
from kandinsky5_tpu.ops.nabla import sta_mask as jax_sta_mask
from kandinsky5_tpu_torch.checkpoint import (
    dit_from_state_dict,
    dit_state_dict_from_jax,
    load_state_dict_file,
)
from kandinsky5_tpu_torch.models.dit import (
    SparseParams,
    dit_forward,
    init_dit_params,
)
from kandinsky5_tpu_torch.ops import nabla

from .ref import TINY_COND
from ._torch_parity import both_cfgs, rand, random_dit_pair, to_np

# head dim 64 (axes 16/24/24, two heads): the port's self-attention takes
# K1's plain version, as the 2B model does
TINY_D64 = dict(TINY_COND, model_dim=128, ff_dim=256, axes_dims=[16, 24, 24])


def _cfg_kw(tiny):
    kw = dict(tiny)
    kw["patch_size"] = tuple(kw["patch_size"])
    kw["axes_dims"] = tuple(kw["axes_dims"])
    return kw


def test_converter_inverts_jax_conversion():
    """dit_state_dict_from_jax equals the JAX package's own exporter, and
    the JAX importer maps it back to the same pytree."""
    jcfg, pcfg = both_cfgs(**_cfg_kw(TINY_COND))
    jparams, model = random_dit_pair(jcfg, pcfg)
    sd = dit_state_dict_from_jax({k: v for k, v in jparams.items()})
    ref = dit_params_to_state_dict(jparams)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], np.asarray(ref[k]))
    back = convert_dit_state_dict(sd, jcfg, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(back["visual_transformer_blocks"]["feed_forward"]
                   ["in_layer"]["weight"]),
        np.asarray(jparams["visual_transformer_blocks"]["feed_forward"]
                   ["in_layer"]["weight"]))
    # the port's module tree carries exactly the reference names
    assert sorted(model.state_dict()) == sorted(sd)


@pytest.mark.parametrize("tiny", [TINY_COND, TINY_D64], ids=["hd16", "hd64"])
def test_dit_forward_matches_jax(tiny):
    jcfg, pcfg = both_cfgs(**_cfg_kw(tiny))
    jparams, model = random_dit_pair(jcfg, pcfg, seed=1)
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 2, 4, 6, jcfg.visual_embed_dim)
    text = rand(rng, 2, 8, jcfg.in_text_dim)
    pooled = rand(rng, 2, jcfg.in_text_dim2)
    time = np.array([500.0, 37.0], np.float32)
    mask = np.arange(8)[None] < np.array([[6], [3]])  # padded text
    want = jax_dit_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(text),
                           jnp.asarray(pooled), jnp.asarray(time),
                           text_mask=jnp.asarray(mask),
                           scale_factor=(1.0, 2.0, 2.0))
    got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(text),
                      torch.from_numpy(pooled), torch.from_numpy(time),
                      text_mask=torch.from_numpy(mask),
                      scale_factor=(1.0, 2.0, 2.0))
    assert got.shape == (2, 2, 4, 6, jcfg.out_visual_dim)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)


def test_init_dit_params_follows_jax_scheme():
    """init_dit_params draws what the JAX init draws, leaf by leaf: zero
    modulation weights and biases (every block starts as an identity),
    unit norms, linears uniform in +-1/sqrt(in)."""
    jcfg, pcfg = both_cfgs(**_cfg_kw(TINY_D64))
    jsd = dit_state_dict_from_jax(jax.tree.map(
        np.asarray, jax_init_dit(jax.random.PRNGKey(0), jcfg,
                                 dtype=jnp.float32)))
    sd = {k: v.numpy() for k, v in
          init_dit_params(pcfg, device="cpu", dtype=torch.float32,
                          seed=0).state_dict().items()}
    assert sorted(sd) == sorted(jsd)
    for key, want in jsd.items():
        got = sd[key]
        assert got.shape == want.shape, key
        if not np.any(want) or np.all(want == 1.0):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            bound = 1.0 / np.sqrt(got.shape[1])
            assert np.any(got) and np.abs(got).max() <= bound, key


def test_sharded_safetensors_load_into_the_dit(tmp_path):
    """A reference-named checkpoint split over two safetensors shards loads
    with ``load_state_dict_file`` + ``dit_from_state_dict``, cast to the
    model's dtype, value for value."""
    from safetensors.torch import save_file

    jcfg, pcfg = both_cfgs(**_cfg_kw(TINY_D64))
    _, src = random_dit_pair(jcfg, pcfg, seed=5)
    sd = src.state_dict()
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[::2]}, str(tmp_path / "a.safetensors"))
    save_file({k: sd[k] for k in keys[1::2]}, str(tmp_path / "b.safetensors"))
    loaded = load_state_dict_file(str(tmp_path))
    assert sorted(loaded) == keys
    dst = dit_from_state_dict(init_dit_params(pcfg, device="cpu",
                                              dtype=torch.bfloat16),
                              loaded)
    for k, v in dst.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, sd[k].bfloat16(), rtol=0, atol=0)


def test_padded_text_does_not_leak():
    """Values behind the text mask do not change the output."""
    jcfg, pcfg = both_cfgs(**_cfg_kw(TINY_D64))
    _, model = random_dit_pair(jcfg, pcfg, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rand(rng, 1, 1, 4, 4, jcfg.visual_embed_dim))
    text = torch.from_numpy(rand(rng, 1, 8, jcfg.in_text_dim))
    pooled = torch.from_numpy(rand(rng, 1, jcfg.in_text_dim2))
    mask = torch.arange(8)[None] < 5
    noisy = text.clone()
    noisy[:, 5:] = 100.0
    args = (pooled, torch.tensor([250.0]))
    a = dit_forward(model, x, text, *args, text_mask=mask)
    b = dit_forward(model, x, noisy, *args, text_mask=mask)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dit_forward_nabla_matches_jax():
    """The NABLA path: a latent of 2x2 tiles per frame over 4 frames (1,024
    tokens, 16 blocks) with a narrow STA window (wT 3, wH 1, wW 1: 15.6 %
    of blocks), so the adaptive mask is truly sparse; the JAX DiT in its
    faithful mode (sort, q_rows 1, no cap)."""
    jcfg, pcfg = both_cfgs(**_cfg_kw(TINY_D64))
    jparams, model = random_dit_pair(jcfg, pcfg, seed=8)
    rng = np.random.default_rng(9)
    x = rand(rng, 1, 4, 32, 32, jcfg.visual_embed_dim)
    text = rand(rng, 1, 8, jcfg.in_text_dim)
    pooled = rand(rng, 1, jcfg.in_text_dim2)
    time = np.array([700.0], np.float32)
    mask = np.arange(8)[None] < 5
    sta = jax_sta_mask(4, 2, 2, 3, 1, 1)
    want = jax_dit_forward(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(text), jnp.asarray(pooled),
        jnp.asarray(time), text_mask=jnp.asarray(mask),
        scale_factor=(1.0, 2.0, 2.0),
        sparse=JaxSparseParams(sta=jnp.asarray(sta), P=0.9, max_density=None,
                               q_rows=1, method="sort"))
    with nabla.record_density() as kept:
        got = dit_forward(model, torch.from_numpy(x), torch.from_numpy(text),
                          torch.from_numpy(pooled), torch.from_numpy(time),
                          text_mask=torch.from_numpy(mask),
                          scale_factor=(1.0, 2.0, 2.0),
                          sparse=SparseParams(torch.from_numpy(sta), 0.9))
    densities = [float(d) for d in kept]
    assert got.shape == (1, 4, 32, 32, jcfg.out_visual_dim)
    assert len(densities) == pcfg.num_visual_blocks
    assert all(sta.mean() <= d < 1.0 for d in densities), densities
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)
    dense = dit_forward(model, torch.from_numpy(x), torch.from_numpy(text),
                        torch.from_numpy(pooled), torch.from_numpy(time),
                        text_mask=torch.from_numpy(mask),
                        scale_factor=(1.0, 2.0, 2.0))
    assert np.abs(to_np(dense) - to_np(want)).max() > 1e-3
