"""The port's DiT primitives (kandinsky5_tpu_torch/models/nn.py) against the
JAX ones on the same seeded inputs, in fp32. Tolerance 1e-5: both sides run
the same fp32 arithmetic and differ only in summation order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.models import nn as jnn
from kandinsky5_tpu_torch.models import nn as tnn

from ._torch_parity import rand, to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def _linear_pair(rng, d_in, d_out, bias=True):
    w = rand(rng, d_in, d_out, scale=0.2)
    b = rand(rng, d_out) if bias else None
    layer = torch.nn.Linear(d_in, d_out, bias=bias, dtype=torch.float32)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            layer.bias.copy_(torch.from_numpy(b))
    jp = {"weight": jnp.asarray(w)}
    if bias:
        jp["bias"] = jnp.asarray(b)
    return jp, layer


def test_norms_and_adaln():
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 7, 32, scale=3.0)
    w, b = rand(rng, 32), rand(rng, 32)
    np.testing.assert_allclose(
        to_np(tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))),
        to_np(jnn.layer_norm(jnp.asarray(x), weight=jnp.asarray(w),
                             bias=jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        to_np(tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        to_np(jnn.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    assert tnn.RMSNORM_EPS == jnn.RMSNORM_EPS
    sc, sh, g = rand(rng, 2, 1, 32), rand(rng, 2, 1, 32), rand(rng, 2, 1, 32)
    tx, tsc, tsh, tg = map(torch.from_numpy, (x, sc, sh, g))
    np.testing.assert_allclose(
        to_np(tnn.apply_scale_shift_norm(tx, tsc, tsh)),
        to_np(jnn.apply_scale_shift_norm(jnp.asarray(x), jnp.asarray(sc),
                                         jnp.asarray(sh))), **TOL)
    np.testing.assert_allclose(
        to_np(tnn.apply_gate_sum(tx, tsh, tg)),
        to_np(jnn.apply_gate_sum(jnp.asarray(x), jnp.asarray(sh),
                                 jnp.asarray(g))), **TOL)


def test_embeddings_and_modulation():
    rng = np.random.default_rng(1)
    j_in, t_in = _linear_pair(rng, 16, 8)
    j_out, t_out = _linear_pair(rng, 8, 8)
    temb = tnn.TimeEmbeddings(16, 8, dtype=torch.float32)
    temb.in_layer, temb.out_layer = t_in, t_out
    time = np.array([999.0, 3.5], np.float32)
    np.testing.assert_allclose(
        to_np(tnn.time_embeddings(temb, torch.from_numpy(time), 16)),
        to_np(jnn.time_embeddings({"in_layer": j_in, "out_layer": j_out},
                                  jnp.asarray(time), 16)), **TOL)

    j_lin, t_lin = _linear_pair(rng, 12, 16)
    nw, nb = rand(rng, 16), rand(rng, 16)
    txt = tnn.TextEmbeddings(12, 16, dtype=torch.float32)
    txt.in_layer = t_lin
    with torch.no_grad():
        txt.norm.weight.copy_(torch.from_numpy(nw))
        txt.norm.bias.copy_(torch.from_numpy(nb))
    x = rand(rng, 2, 5, 12)
    np.testing.assert_allclose(
        to_np(tnn.text_embeddings(txt, torch.from_numpy(x))),
        to_np(jnn.text_embeddings(
            {"in_layer": j_lin, "norm": {"weight": jnp.asarray(nw),
                                         "bias": jnp.asarray(nb)}},
            jnp.asarray(x))), **TOL)

    j_mod, t_mod = _linear_pair(rng, 8, 3 * 16)
    mod = tnn.Modulation(8, 16, 3, dtype=torch.float32)
    mod.out_layer = t_mod
    te = rand(rng, 2, 8)
    np.testing.assert_allclose(
        to_np(tnn.modulation(mod, torch.from_numpy(te))),
        to_np(jnn.modulation({"out_layer": j_mod}, jnp.asarray(te))), **TOL)


def test_patchify_unpatchify_orders():
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 2, 4, 6, 5)
    np.testing.assert_array_equal(
        to_np(tnn.patchify(torch.from_numpy(x), (1, 2, 2))),
        to_np(jnn.patchify(jnp.asarray(x), (1, 2, 2))))
    y = rand(rng, 2, 2, 2, 3, 20)
    np.testing.assert_array_equal(
        to_np(tnn.unpatchify(torch.from_numpy(y), (1, 2, 2), 5)),
        to_np(jnn.unpatchify(jnp.asarray(y), (1, 2, 2), 5)))
    # the two inner orders differ: unpatchify is not patchify's inverse
    p = tnn.patchify(torch.from_numpy(x), (1, 2, 2))
    assert not torch.equal(tnn.unpatchify(p, (1, 2, 2), 5),
                           torch.from_numpy(x))


@pytest.mark.parametrize("grid,scale", [((3, 4, 6), (1.0, 2.0, 2.0)),
                                        ((1, 2, 2), (1.0, 1.0, 1.0))])
def test_rope_tables_and_rotary(grid, scale):
    axes = (16, 24, 24)
    pos_t = tuple(torch.arange(g) for g in grid)
    pos_j = tuple(jnp.arange(g) for g in grid)
    cos_t, sin_t = tnn.rope_3d(grid, pos_t, axes, scale)
    cos_j, sin_j = jnn.rope_3d(grid, pos_j, axes, scale)
    np.testing.assert_allclose(to_np(cos_t), to_np(cos_j), **TOL)
    np.testing.assert_allclose(to_np(sin_t), to_np(sin_j), **TOL)
    c1t, s1t = tnn.rope_1d(torch.arange(11), 64)
    c1j, s1j = jnn.rope_1d(jnp.arange(11), 64)
    np.testing.assert_allclose(to_np(c1t), to_np(c1j), **TOL)
    np.testing.assert_allclose(to_np(s1t), to_np(s1j), **TOL)

    rng = np.random.default_rng(3)
    n = int(np.prod(grid))
    x = rand(rng, 2, n, 3, 64)
    np.testing.assert_allclose(
        to_np(tnn.apply_rotary(torch.from_numpy(x), cos_t, sin_t)),
        to_np(jnn.apply_rotary(jnp.asarray(x), cos_j, sin_j)), **TOL)


def test_qkv_proj_casts_after_rmsnorm():
    rng = np.random.default_rng(4)
    attn = tnn.Attention(32, 16, dtype=torch.float32)
    jp = {}
    for name in ("to_query", "to_key", "to_value", "out_layer"):
        jp[name], layer = _linear_pair(rng, 32, 32)
        setattr(attn, name, layer)
    for name in ("query_norm", "key_norm"):
        w = 1.0 + rand(rng, 16, scale=0.1)
        jp[name] = {"weight": jnp.asarray(w)}
        with torch.no_grad():
            getattr(attn, name).weight.copy_(torch.from_numpy(w))
    x = rand(rng, 2, 9, 32)
    for got, want in zip(tnn.qkv_proj(attn, torch.from_numpy(x), 2),
                         jnn.qkv_proj(jp, jnp.asarray(x), 2)):
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    # bf16 activations: q/k come back in the activation dtype
    attn_bf = attn.to(torch.bfloat16)
    q, k, v = tnn.qkv_proj(attn_bf, torch.from_numpy(x).bfloat16(), 2)
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16


def test_modulated_feed_forward_plain_path():
    """fp32 takes the chain (K2 is for bf16 only, as in the JAX package);
    compare with the JAX XLA chain."""
    rng = np.random.default_rng(5)
    ff = tnn.FeedForward(32, 64, dtype=torch.float32)
    j_in, ff.in_layer = _linear_pair(rng, 32, 64, bias=False)
    j_out, ff.out_layer = _linear_pair(rng, 64, 32, bias=False)
    x = rand(rng, 2, 7, 32)
    sc, sh, g = (rand(rng, 2, 1, 32, scale=0.3) for _ in range(3))
    got = tnn.modulated_feed_forward(ff, *map(torch.from_numpy, (x, sc, sh, g)))
    want = jnn.modulated_feed_forward({"in_layer": j_in, "out_layer": j_out},
                                      *map(jnp.asarray, (x, sc, sh, g)))
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
