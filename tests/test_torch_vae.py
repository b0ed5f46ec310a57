"""The port's streaming VAE decode (kandinsky5_tpu_torch/models/vae_stream.py)
against the JAX one on the same full-channel weights (through
``vae_state_dict_from_jax``), fp32, and the exactness of the carried conv
state. Tolerance 2e-4, the JAX golden tests' fp32 bound."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models.vae import decoder_forward as jax_decoder_forward
from kandinsky5_tpu.models.vae import init_vae_params as jax_init_vae
from kandinsky5_tpu.models.vae import mid_attention as jax_mid_attention
from kandinsky5_tpu.models.vae_stream import conv3d_stream as jax_conv_stream
from kandinsky5_tpu.models.vae_stream import streaming_decode as jax_stream
from kandinsky5_tpu_torch.checkpoint import (
    vae_params_from_state_dict,
    vae_state_dict_from_jax,
)
from kandinsky5_tpu_torch.models import vae as vae_mod
from kandinsky5_tpu_torch.models.vae import (
    HunyuanVideoVAE,
    causal_conv3d,
    decoder_forward,
)
from kandinsky5_tpu_torch.models.vae_stream import conv3d_stream, streaming_decode
from kandinsky5_tpu_torch.ops.flash import flash_attention

from ._torch_parity import rand, to_np


@pytest.fixture(scope="module")
def vae_pair():
    jparams = jax_init_vae(jax.random.PRNGKey(0), dtype=jnp.float32)
    sd = vae_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    return jparams, sd, vae_params_from_state_dict(sd, device="cpu",
                                                    dtype=torch.float32)


def test_state_dict_has_checkpoint_layout(vae_pair):
    _, sd, params = vae_pair
    w = sd["decoder.up_blocks.0.resnets.0.conv1.conv.weight"]
    assert w.shape == (512, 512, 3, 3, 3)  # torch Conv3d (O, I, kT, kH, kW)
    assert "decoder.up_blocks.0.upsamplers.0.conv.conv.weight" in sd
    assert sd["post_quant_conv.weight"].shape == (16, 16, 1, 1, 1)
    assert sd["decoder.mid_block.attentions.0.to_q.weight"].shape == (512, 512)
    assert params["decoder"]["conv_in"]["weight"].shape == (512, 16, 3, 3, 3)


def test_streaming_decode_matches_jax(vae_pair):
    """(1, 5, 8, 8, 16) latents decode as two chunks (4 + 1 latent frames)
    with carried conv and attention state."""
    jparams, _, params = vae_pair
    z = rand(np.random.default_rng(0), 1, 5, 8, 8, 16)
    want = jax_stream(jparams, jnp.asarray(z))
    got = streaming_decode(params, torch.from_numpy(z))
    assert got.shape == (1, 17, 64, 64, 3)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)
    # the decode entry point is the same streaming path
    via_vae = HunyuanVideoVAE(params, dtype=torch.float32).decode(
        torch.from_numpy(z))
    torch.testing.assert_close(via_vae, got)


def test_decoder_forward_matches_jax(vae_pair):
    """The untiled decoder: (1, 2, 4, 4, 16) latents -> 5 frames of 32x32,
    through every up block and the dense mid attention."""
    jparams, _, params = vae_pair
    z = rand(np.random.default_rng(3), 1, 2, 4, 4, 16)
    want = jax_decoder_forward(jparams["decoder"], jnp.asarray(z))
    got = decoder_forward(params["decoder"], torch.from_numpy(z))
    assert got.shape == (1, 5, 32, 32, 3)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)


def test_mid_attention_k4_branch_matches_jax(vae_pair, monkeypatch):
    """From 2048 voxels on, the port's mid attention goes to K4 with frame
    ids (its plain version here); JAX off the TPU runs the dense branch.
    Same function, fp32 summation order apart."""
    jparams, _, params = vae_pair
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("q_ids") is not None)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(vae_mod, "flash_attention", counted)
    x = rand(np.random.default_rng(4), 1, 2, 32, 32, 512)
    want = jax_mid_attention(jparams["decoder"]["mid_block"]["attentions"]["0"],
                             jnp.asarray(x))
    got = vae_mod.mid_attention(params["decoder"]["mid_block"]["attentions"]["0"],
                                torch.from_numpy(x))
    assert calls == [True]
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)


def test_conv3d_stream_chunks_equal_one_shot_conv():
    """Chunked causal conv with the carried two-frame history == the
    one-shot causal conv (both through K3's plain version), and the JAX
    stream conv agrees."""
    rng = np.random.default_rng(1)
    w = rand(rng, 3, 3, 3, 128, 128, scale=0.02)
    b = rand(rng, 128, scale=0.1)
    x = rand(rng, 1, 9, 6, 6, 128)
    p = {"weight": torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()),
         "bias": torch.from_numpy(b)}
    full = causal_conv3d(p, torch.from_numpy(x))
    hist, jhist, outs, jouts = None, None, [], []
    jp = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}
    for lo, hi in ((0, 1), (1, 5), (5, 9)):
        y, hist = conv3d_stream(p, torch.from_numpy(x[:, lo:hi]), hist)
        jy, jhist = jax_conv_stream(jp, jnp.asarray(x[:, lo:hi]), jhist)
        outs.append(y)
        jouts.append(np.asarray(jy))
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(torch.cat(outs, dim=1)),
                               np.concatenate(jouts, axis=1), rtol=1e-4,
                               atol=1e-4)
