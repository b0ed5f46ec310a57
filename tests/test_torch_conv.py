"""K3's plain version (kandinsky5_tpu_torch/ops/conv.py) against the JAX
package: the Pallas implicit-GEMM conv ``causal_conv3d_fused`` in interpret
mode, plain and time_padded, and the XLA ``vae.causal_conv3d``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.models.vae import causal_conv3d as jax_conv
from kandinsky5_tpu.ops.conv_pallas import causal_conv3d_fused as jax_fused
from kandinsky5_tpu_torch.models.vae import causal_conv3d
from kandinsky5_tpu_torch.ops.conv import causal_conv3d_fused, conv3d_plain

from ._torch_parity import rand, to_np


def _conv(rng, cin, cout, k=3):
    w = rand(rng, k, k, k, cin, cout, scale=1 / np.sqrt(27 * cin))  # DHWIO
    b = rand(rng, cout, scale=0.1)
    return w, b, torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())


@pytest.mark.parametrize("time_padded", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_matches_pallas_interpret(time_padded, dtype):
    """Cin = Cout = 128. fp32: the same products in another order, 1e-4.
    bf16: both accumulate in fp32 and round the output once to bf16, so
    they agree to a bf16 ulp at the outputs' scale, 2e-2."""
    rng = np.random.default_rng(0)
    t_in = 5 if time_padded else 3
    x = rand(rng, 1, t_in, 8, 32, 128)
    w, b, wt = _conv(rng, 128, 128)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_fused({"weight": jnp.asarray(w, jdt), "bias": jnp.asarray(b)},
                     jnp.asarray(x, jdt), time_padded=time_padded,
                     interpret=True)
    got = causal_conv3d_fused(torch.from_numpy(x).to(tdt), wt.to(tdt),
                              torch.from_numpy(b), time_padded=time_padded)
    assert got.shape == (1, 3, 8, 32, 128) and got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("cin,cout", [(128, 256), (16, 128), (128, 3)])
def test_causal_conv3d_matches_xla_fp32(cin, cout):
    """The VAE's conv dispatch (K3 route for 128-512 channels, plain for
    conv_in / conv_out) against the JAX XLA conv, fp32, ragged W: 1e-4."""
    rng = np.random.default_rng(1)
    x = rand(rng, 1, 4, 6, 10, cin)
    w, b, wt = _conv(rng, cin, cout)
    want = jax_conv({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x))
    got = causal_conv3d({"weight": wt, "bias": torch.from_numpy(b)},
                        torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4, atol=1e-4)


def test_time_padded_equals_explicit_replicate_frames():
    """Unpadded mode == time_padded over two prepended copies of frame 0."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rand(rng, 1, 3, 5, 7, 128))
    _, b, wt = _conv(rng, 128, 128)
    b = torch.from_numpy(b)
    xt = torch.cat([x[:, :1], x[:, :1], x], dim=1)
    torch.testing.assert_close(conv3d_plain(x, wt, b),
                               conv3d_plain(xt, wt, b, time_padded=True))
