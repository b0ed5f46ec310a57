"""The port's VAE encode (``kandinsky5_tpu_torch/models/vae.py``: the strided
plain conv, ``encoder_forward``, ``_encode_tile`` and
``HunyuanVideoVAE.encode_moments`` / ``encode``, untiled and tiled) against
the JAX package's on the CPU.

Weights are the JAX ``init_vae_params`` tree (through
``vae_state_dict_from_jax``), inputs seeded numpy arrays, fp32 throughout.
The JAX package's CPU encode runs XLA convs unfused; the port's fuses
GroupNorm + SiLU into K3's prologue (its plain version here) where the TPU
kernel would, which in fp32 moves nothing but summation order: the bound
is the JAX golden tests' 2e-4. ``test_encode_convs_match_jax`` forces the
JAX encode onto its Pallas conv (interpret mode) with the fused and W8A8
switches and holds the port's encode against it conv by conv."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models import vae as jax_vae
from kandinsky5_tpu_torch.checkpoint import (
    _flatten,
    vae_params_from_state_dict,
    vae_state_dict_from_jax,
)
from kandinsky5_tpu_torch.models import vae as vae_mod
from kandinsky5_tpu_torch.models.vae import (
    ConvMode,
    HunyuanVideoVAE,
    encoder_forward,
    init_vae_params,
    posterior_sample,
    strided_conv3d,
)
from kandinsky5_tpu_torch.ops.conv import tpu_kernel_admits

from ._torch_parity import assert_quant_conv_close, rand, to_np
from .test_torch_vae_tiled import _conv_key, _record_jax_convs


@pytest.fixture(scope="module")
def vae_pair():
    jparams = jax_vae.init_vae_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    sd = vae_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    return jparams, vae_params_from_state_dict(sd, device="cpu",
                                               dtype=torch.float32)


def _pixels(seed, *shape):
    return np.tanh(rand(np.random.default_rng(seed), *shape))


@pytest.mark.parametrize("stride", [(1, 2, 2), (2, 2, 2)])
def test_strided_conv_matches_jax(stride):
    """The encoder's downsampler conv against JAX's ``causal_conv3d`` at
    the same stride (XLA there), fp32, 2e-5."""
    rng = np.random.default_rng(sum(stride))
    w = rand(rng, 3, 3, 3, 8, 16, scale=0.1)  # DHWIO
    b = rand(rng, 16, scale=0.1)
    x = rand(rng, 1, 5, 8, 12, 8)
    want = jax_vae.causal_conv3d({"weight": jnp.asarray(w),
                                  "bias": jnp.asarray(b)},
                                 jnp.asarray(x), stride=stride)
    p = {"weight": torch.from_numpy(np.ascontiguousarray(
        w.transpose(4, 3, 0, 1, 2))), "bias": torch.from_numpy(b)}
    got = strided_conv3d(p, torch.from_numpy(x), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)


def test_encoder_and_encode_tile_match_jax(vae_pair):
    """``encoder_forward`` (moments before ``quant_conv``) and
    ``_encode_tile`` against JAX's at 5 x 32 x 32 px (2 x 4 x 4 latents),
    fp32, 2e-4; the port fuses the 128-channel convs at 32 x 32 px."""
    jparams, params = vae_pair
    x = _pixels(1, 1, 5, 32, 32, 3)
    want_enc = jax_vae.encoder_forward(jparams["encoder"], jnp.asarray(x))
    want_tile = jax_vae._encode_tile(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got_enc = encoder_forward(params["encoder"], xt)
    assert got_enc.shape == want_enc.shape == (1, 2, 4, 4, 32)
    np.testing.assert_allclose(to_np(got_enc), to_np(want_enc), rtol=2e-4,
                               atol=2e-4)
    got_tile = vae_mod._encode_tile(params, xt, ConvMode(fuse=True))
    np.testing.assert_allclose(to_np(got_tile), to_np(want_tile), rtol=2e-4,
                               atol=2e-4)


# (pixel shape, forced (tile, stride) or None for the reference's tables):
# untiled by the tables; 2 x 2 spatial tiles of 32 x 32 px blended over 2
# latent rows and columns; 2 temporal tiles of 9 frames blended over one
# latent frame
ENCODES = {
    "untiled": ((1, 5, 32, 32, 3), None),
    "spatial": ((1, 1, 48, 48, 3), ((1, 32, 32), (1, 16, 16))),
    "temporal": ((1, 13, 32, 32, 3), ((9, 32, 32), (4, 32, 32))),
}


@pytest.mark.parametrize("case", list(ENCODES))
def test_encode_moments_match_jax(vae_pair, case):
    """``encode_moments`` against JAX's, untiled and through each tiled
    path, fp32, 2e-4."""
    jparams, params = vae_pair
    shape, tiling = ENCODES[case]
    x = _pixels(len(case), *shape)
    jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
    tv = HunyuanVideoVAE(params, dtype=torch.float32)
    if tiling:
        jv._apply_tiling(*tiling)
        tv._apply_tiling(*tiling)
    want = to_np(jv.encode_moments(jnp.asarray(x), opt_tiling=tiling is None))
    got = to_np(tv.encode_moments(torch.from_numpy(x),
                                  opt_tiling=tiling is None))
    assert got.shape == want.shape == (1, (shape[1] - 1) // 4 + 1,
                                       shape[2] // 8, shape[3] // 8, 32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_encode_mean_and_seeded_sample(vae_pair):
    """``encode()`` is JAX's posterior mean (2e-4); ``encode(seed=)`` is
    mean + exp(0.5 clip(logvar, -30, 20)) noise with the noise of a CPU
    generator seeded alike, against that sum computed in numpy from JAX's
    moments."""
    jparams, params = vae_pair
    x = _pixels(5, 1, 5, 32, 32, 3)
    jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
    tv = HunyuanVideoVAE(params, dtype=torch.float32)
    moments = to_np(jv.encode_moments(jnp.asarray(x)))
    mean, logvar = np.split(moments, 2, axis=-1)
    np.testing.assert_allclose(to_np(tv.encode(torch.from_numpy(x))),
                               to_np(jv.encode(jnp.asarray(x))), rtol=2e-4,
                               atol=2e-4)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    want = mean + np.exp(0.5 * np.clip(logvar, -30.0, 20.0)) * noise.numpy()
    got = to_np(tv.encode(torch.from_numpy(x), seed=3))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.abs(got - mean).max() > 1e-2
    torch.testing.assert_close(posterior_sample(torch.from_numpy(moments)),
                               torch.from_numpy(mean))


def test_init_vae_params_has_both_halves(vae_pair):
    """The port's random VAE carries every entry of the JAX package's,
    encoder and ``quant_conv`` included, each of the same size."""
    p = init_vae_params(device="cpu", dtype=torch.float32, seed=4)
    got = {k: v.size for k, v in _flatten(
        jax.tree.map(lambda t: t.numpy(), p), "", {}).items()}
    want = {k: v.size for k, v in _flatten(
        jax.tree.map(np.asarray, vae_pair[0]), "", {}).items()}
    assert got == want
    assert p["encoder"]["conv_out"]["weight"].shape == (32, 512, 3, 3, 3)
    assert p["quant_conv"]["weight"].shape == (32, 32, 1, 1, 1)


# (VAE options): the encode fused by default (K3's prologue instance) and
# with W8A8
ENCODE_CONVS = {"fused": {}, "fused-int8": {"int8_conv": True}}


@pytest.mark.parametrize("case", list(ENCODE_CONVS))
def test_encode_convs_match_jax(vae_pair, case, monkeypatch):
    """The port's encode against the JAX package's with its Pallas conv in
    interpret mode where it admits the conv, GroupNorm fused (the JAX
    default) and W8A8 forced for the int8 case, fp32, 5 x 32 x 32 px. Both
    must call the TPU conv in the same order with the same modes; each of
    the port's K3 calls is then held against JAX's on JAX's own input
    (2e-4, or under W8A8 exact to 1e-5 up to rounding flips), and the
    moments against JAX's where no W8A8 flip compounds (2e-4)."""
    jparams, params = vae_pair
    opts = ENCODE_CONVS[case]
    int8 = opts.get("int8_conv", False)
    x = _pixels(7, 1, 5, 32, 32, 3)
    rec = []
    jax.clear_caches()
    with monkeypatch.context() as m:
        _record_jax_convs(m, rec, None, int8)
        jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
        want = to_np(jv.encode_moments(jnp.asarray(x)))
        jax.effects_barrier()
    jax.clear_caches()

    calls = []
    real = vae_mod.causal_conv3d_fused

    def spy(x, w, b, *args, **kw):
        y = real(x, w, b, *args, **kw)
        calls.append((tpu_kernel_admits(x, w),
                      _conv_key(y.shape, kw.get("scale") is not None,
                                kw.get("prefix_planes", 0), kw.get("quant"))))
        return y

    monkeypatch.setattr(vae_mod, "causal_conv3d_fused", spy)
    tv = HunyuanVideoVAE(params, dtype=torch.float32, **opts)
    got = to_np(tv.encode_moments(torch.from_numpy(x)))
    assert got.shape == want.shape
    admitted = [c for ok, c in calls if ok]
    assert not any(c[1] or c[3] for ok, c in calls if not ok)
    assert admitted == [_conv_key(y.shape, bool(gn), md["prefix_planes"],
                                  md["quant"])
                        for md, (x, w, b, y, *gn) in rec]
    # level 0's two resnets at 128 channels, 32 x 32 px: four fused convs
    assert len(admitted) == 4 and all(c[1] for c in admitted)
    assert all(c[3] == int8 for c in admitted)
    for md, (x, w, b, y, *gn) in rec:
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
        kw = dict(time_padded=md["time_padded"], scale=torch.from_numpy(gn[0]),
                  shift=torch.from_numpy(gn[1]), act=md["act"],
                  prefix_planes=md["prefix_planes"])
        out = real(torch.from_numpy(x), wt, torch.from_numpy(b),
                   quant=md["quant"], **kw)
        if md["quant"]:
            assert_quant_conv_close(out, y, x, wt, **kw)
        else:
            np.testing.assert_allclose(to_np(out), y, rtol=2e-4, atol=2e-4)
    if not int8:
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
