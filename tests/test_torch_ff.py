"""K2's plain version (kandinsky5_tpu_torch/ops/ff.py) against the JAX
package: the Pallas kernel ``fused_ff_modulated`` in interpret mode (bf16)
and the XLA chain ``modulated_feed_forward`` (fp32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.models.nn import modulated_feed_forward as jax_mff
from kandinsky5_tpu.ops.ff_pallas import fused_ff_modulated as jax_fused
from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.ff import ff_mod_plain, fused_ff_modulated

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
