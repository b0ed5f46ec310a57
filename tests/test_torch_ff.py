"""K2's plain version (kandinsky5_tpu_torch/ops/ff.py) against the JAX
package: the Pallas kernel ``fused_ff_modulated`` in interpret mode (bf16)
and the XLA chain ``modulated_feed_forward`` (fp32); its modulation pass
against ``apply_scale_shift_norm``; the route to K2 against the JAX
package's gate ``ff_supported``, and a 256-row bf16 text block, which the
gate declines, against JAX's chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch.nn.functional as F

from kandinsky5_tpu.models.nn import apply_scale_shift_norm
from kandinsky5_tpu.models.nn import modulated_feed_forward as jax_mff
from kandinsky5_tpu.ops.ff_pallas import ff_supported as jax_ff_supported
from kandinsky5_tpu.ops.ff_pallas import fused_ff_modulated as jax_fused
from kandinsky5_tpu_torch.models import nn as tnn
from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.ff import (
    ff_mod_plain,
    fused_ff_modulated,
    modulate,
    modulate_plain,
)

from ._torch_parity import rand, to_np


def _inputs(rng, b, l, d, ff):
    x = rand(rng, b, l, d)
    sc, sh, g = (rand(rng, b, d, scale=0.2) for _ in range(3))
    w1 = rand(rng, d, ff, scale=1 / np.sqrt(d))   # JAX (in, out)
    w2 = rand(rng, ff, d, scale=1 / np.sqrt(ff))
    return x, sc, sh, g, w1, w2


@pytest.mark.parametrize("b,l", [(1, 600), (2, 131)])
def test_k2_plain_matches_pallas_interpret_bf16(b, l):
    """bf16, rows not a multiple of the kernel's 512-row tile. Both sides
    make the hidden in fp32 and round it to bf16 (the Pallas kernel's A&S
    erf is within 1.5e-7 of erf, which can flip a rare bf16 rounding of
    the hidden), accumulate W2 in fp32 and round the output to bf16:
    agreement to a few bf16 ulps, 2e-2."""
    rng = np.random.default_rng(0)
    x, sc, sh, g, w1, w2 = _inputs(rng, b, l, 256, 512)
    bf = jnp.bfloat16
    want = jax_fused(jnp.asarray(x, bf), jnp.asarray(sc), jnp.asarray(sh),
                     jnp.asarray(w1, bf), jnp.asarray(w2, bf), jnp.asarray(g),
                     use_gate=True, interpret=True)
    tb = torch.bfloat16
    got = fused_ff_modulated(torch.from_numpy(x).to(tb), torch.from_numpy(sc),
                             torch.from_numpy(sh),
                             torch.from_numpy(w1.T.copy()).to(tb),
                             torch.from_numpy(w2.T.copy()).to(tb),
                             torch.from_numpy(g))
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, 256)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2, atol=2e-2)


def test_k2_plain_matches_xla_chain_fp32():
    """fp32: the same arithmetic as apply_scale_shift_norm -> Linear ->
    erf GELU -> Linear -> apply_gate_sum, to fp32 summation order (2e-5)."""
    rng = np.random.default_rng(1)
    x, sc, sh, g, w1, w2 = _inputs(rng, 2, 37, 64, 128)
    p = {"in_layer": {"weight": jnp.asarray(w1)},
         "out_layer": {"weight": jnp.asarray(w2)}}
    want = jax_mff(p, jnp.asarray(x), jnp.asarray(sc[:, None]),
                   jnp.asarray(sh[:, None]), jnp.asarray(g[:, None]))
    got = ff_mod_plain(torch.from_numpy(x), torch.from_numpy(sc),
                       torch.from_numpy(sh), torch.from_numpy(w1.T.copy()),
                       torch.from_numpy(w2.T.copy()), torch.from_numpy(g))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)


def test_k2_wrapper_takes_plain_on_cpu():
    _kernels.reset_launches()
    rng = np.random.default_rng(2)
    x, sc, sh, g, w1, w2 = (torch.from_numpy(a) for a in
                            _inputs(rng, 1, 8, 128, 256))
    fused_ff_modulated(x, sc, sh, w1.T.contiguous(), w2.T.contiguous(), g)
    assert _kernels.LAUNCHES["K2_ff_mod"] == 0


def _bf16_ulp(t):
    """The spacing of bf16 values at each element of t (8 bits of
    mantissa): 2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("b,l,d", [(2, 131, 256), (1, 600, 384)])
def test_modulate_plain_matches_apply_scale_shift_norm(b, l, d):
    """The modulation pass in bf16, B = 2 with a ragged L: the same fp32
    LayerNorm and modulation as the JAX package, rounded once to bf16.
    The two frameworks sum the row statistics in other orders, which can
    move a value that lies near a rounding boundary by one bf16 ulp; where
    the shift cancels the unit-scale normed term to near zero, the bf16
    ulp of the result is finer than the fp32 rounding of the terms, so
    the bound is one bf16 ulp of the value or 2^-20, whichever is
    larger."""
    rng = np.random.default_rng(3)
    x = rand(rng, b, l, d) * 3.0 + 0.5
    sc, sh = rand(rng, b, d, scale=0.2), rand(rng, b, d, scale=0.2)
    want = apply_scale_shift_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(sc[:, None]),
                                  jnp.asarray(sh[:, None]))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = modulate_plain(xt, torch.from_numpy(sc), torch.from_numpy(sh))
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    want_t = torch.from_numpy(to_np(want))
    bound = _bf16_ulp(want_t).clamp_min(2.0 ** -20)
    diff = (got.float() - want_t).abs()
    assert bool((diff <= bound).all()), (diff / bound).max()
    # the bound has teeth: the other batch item's shift moves rows by many
    wrong = modulate_plain(xt, torch.from_numpy(sc),
                           torch.from_numpy(sh).flip(0) if b == 2
                           else torch.from_numpy(sh) + 0.1)
    assert not bool(((wrong.float() - want_t).abs() <= bound).all())


def _ff_mod_plain_single(x, scale, shift, w1, w2, gate):
    """K2's plain version written as one function, before the modulation
    pass became a function of its own."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    y = y * (scale.float()[:, None] + 1.0) + shift.float()[:, None]
    xn = y.to(x.dtype)
    h = F.gelu(xn.float() @ w1.float().T, approximate="none").to(x.dtype)
    acc = h.float() @ w2.float().T
    return (xf + gate.float()[:, None] * acc).to(x.dtype)


@pytest.mark.parametrize("b,l,dtype", [(2, 131, torch.bfloat16),
                                       (1, 40, torch.float32)])
def test_ff_mod_plain_composed_from_modulation_is_unchanged(b, l, dtype):
    """ff_mod_plain built on modulate_plain gives the same bits as the
    single function it replaces."""
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a) for a in _inputs(rng, b, l, 128, 256)]
    x, sc, sh, g, w1, w2 = args
    x, w1, w2 = x.to(dtype), w1.T.contiguous().to(dtype), w2.T.contiguous().to(dtype)
    got = ff_mod_plain(x, sc, sh, w1, w2, g)
    assert torch.equal(got, _ff_mod_plain_single(x, sc, sh, w1, w2, g))


def test_modulate_wrapper_takes_plain_on_cpu():
    _kernels.reset_launches()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rand(rng, 2, 9, 128)).to(torch.bfloat16)
    sc, sh = (torch.from_numpy(rand(rng, 2, 128)) for _ in range(2))
    assert torch.equal(modulate(x, sc, sh), modulate_plain(x, sc, sh))
    assert _kernels.LAUNCHES["K2_modulate"] == 0


def _ff_block(w1, w2, dtype):
    """A FeedForward holding the JAX-layout weights w1 (D, FF), w2 (FF, D)."""
    d, ff = w1.shape
    block = tnn.FeedForward(d, ff, dtype=dtype)
    with torch.no_grad():
        block.in_layer.weight.copy_(torch.from_numpy(w1.T.copy()))
        block.out_layer.weight.copy_(torch.from_numpy(w2.T.copy()))
    return block


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,l", [(1, 256), (1, 512), (2, 1000)],
                         ids=["rows256", "rows512", "rows2x1000"])
def test_modulated_feed_forward_routes_where_jax_does(monkeypatch, b, l,
                                                      dtype, d):
    """modulated_feed_forward calls K2's wrapper exactly where the JAX
    package's ff_supported admits the shapes (bf16, D and FF multiples of
    256, at least 512 rows) and runs the chain (norm -> FF -> gate)
    elsewhere: the 256-row text blocks and fp32 never reach K2."""
    rng = np.random.default_rng(6)
    ff = 2 * d
    x, sc, sh, g, w1, w2 = _inputs(rng, b, l, d, ff)
    calls = []
    real = tnn.fused_ff_modulated

    def recorder(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(tnn, "fused_ff_modulated", recorder)
    block = _ff_block(w1, w2, dtype)
    xt = torch.from_numpy(x).to(dtype)
    vecs = [torch.from_numpy(v[:, None]) for v in (sc, sh, g)]
    # inference runs without autograd; under it K2 refuses the block's
    # parameters (ops/_kernels.refuse_grad)
    with torch.no_grad():
        got = tnn.modulated_feed_forward(block, xt, *vecs)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    admitted = bool(jax_ff_supported(jax.ShapeDtypeStruct(x.shape, jdt),
                                     jax.ShapeDtypeStruct(w1.shape, jdt),
                                     jax.ShapeDtypeStruct(w2.shape, jdt)))
    assert calls == ([(b, l, d)] if admitted else [])
    assert admitted == (dtype == torch.bfloat16 and d == 256 and b * l >= 512)
    if not admitted:
        chain = tnn.apply_gate_sum(
            xt, tnn.feed_forward(block, tnn.apply_scale_shift_norm(
                xt, vecs[0], vecs[1])), vecs[2])
        assert torch.equal(got, chain)


def test_text_block_bf16_matches_jax_chain():
    """A bf16 text block at its full shape, (1, 256, 1792) x 7168, which
    JAX's gate declines: the port's chain against JAX's chain, relative L2
    on the block output. Both round the normed input, the up product, the
    hidden, the FF output and the output to bf16; they differ where JAX
    evaluates GELU's steps in bf16 and in the order of sums (9.3e-4 with
    this seed). K2's plain version skips two of those roundings (the up
    product and the FF output) and lands at 1.2e-3 against JAX, so the
    bound, 1.05e-3 (below the 2.2e-3 that K2's rounding gives at the full
    text block on the card), tells the two apart."""
    rng = np.random.default_rng(0)
    d, ff = 1792, 7168
    x = rand(rng, 1, 256, d)
    sc, sh, g = (rand(rng, 1, 1, d, scale=0.2) for _ in range(3))
    w1 = rand(rng, d, ff, scale=1 / np.sqrt(d))
    w2 = rand(rng, ff, d, scale=1 / np.sqrt(ff))
    bf = jnp.bfloat16
    want = jax_mff({"in_layer": {"weight": jnp.asarray(w1, bf)},
                    "out_layer": {"weight": jnp.asarray(w2, bf)}},
                   jnp.asarray(x, bf), jnp.asarray(sc), jnp.asarray(sh),
                   jnp.asarray(g))
    want = torch.from_numpy(to_np(want)).float()
    block = _ff_block(w1, w2, torch.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    vecs = [torch.from_numpy(v) for v in (sc, sh, g)]
    got = tnn.modulated_feed_forward(block, xt, *vecs)
    assert got.dtype == torch.bfloat16

    def rel(a):
        return ((a.float() - want).norm() / want.norm()).item()

    bound = 1.05e-3
    assert rel(got) < bound, rel(got)
    # the control: K2's rounding on the same inputs must fail the bound
    fused = ff_mod_plain(xt, *(v[:, 0] for v in vecs[:2]),
                         block.in_layer.weight, block.out_layer.weight,
                         vecs[2][:, 0])
    assert rel(fused) > bound, rel(fused)
