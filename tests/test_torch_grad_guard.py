"""Kernels refuse autograd (``ops/_kernels.refuse_grad``), as the JAX
package's ``pallas_call``s cannot be differentiated: every public kernel
entry raises on the CPU, where it would take its differentiable plain
version, exactly where it would launch on the card; under ``no_grad`` it
runs unchanged; a DiT loss raises where JAX's gradient does, and trains on
the routes that run no kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu import training as jt
from kandinsky5_tpu_torch import training as tt
from kandinsky5_tpu_torch.ops import conv, ff, flash, gemm, sparse
from kandinsky5_tpu_torch.tools import bench_i8_decomp, bench_int8mm
from kandinsky5_tpu_torch.tools import bench_pallas_gemm as bpg

from ._torch_parity import both_cfgs, rand, random_dit_pair


def _t(g, *shape, dtype=torch.float32):
    return (torch.randn(shape, generator=g) * 0.5).to(dtype)


def _attn(g, d=64, l=64):
    return [_t(g, 1, l, 2, d) for _ in range(3)]


def _packed(g):
    q, k, v = _attn(g)
    q8, k8, coeff, shift = flash.pack_int8(q, k)
    return [q8, k8, v, coeff, shift]


def _sparse(g):
    q, k, v = _attn(g, l=128)
    inds = torch.tensor([[[0, 1], [1, 0]]] * 2)[None]
    return [q, k, v, inds, torch.full((1, 2, 2), 2)]


def _conv(g):
    return [_t(g, 1, 2, 8, 32, 128), _t(g, 128, 128, 3, 3, 3) * 0.05,
            _t(g, 128)]


def _ff(g, d=256, f=256):
    return [_t(g, 4, d), _t(g, f, d) * 0.05, _t(g, d, f) * 0.05]


# kernel entry -> (make the inputs from a generator, the call, which inputs
# may require grad: the float ones)
ENTRIES = {
    "K1 flash_fixed": (_attn, flash.flash_fixed),
    "K4 flash_online": (lambda g: _attn(g, d=512, l=16), flash.flash_online),
    "K5 flash_int8": (_attn, flash.flash_int8),
    "K7 flash_int8 pipe": (_attn, lambda q, k, v: flash.flash_int8(
        q, k, v, pipe=True)),
    "K5 flash_int8_packed": (_packed, flash.flash_int8_packed),
    "K2 modulate": (lambda g: [_t(g, 1, 4, 128), _t(g, 1, 128),
                               _t(g, 1, 128)], ff.modulate),
    "K2 fused_ff_modulated": (
        lambda g: [_t(g, 1, 4, 128), _t(g, 1, 128), _t(g, 1, 128),
                   _t(g, 256, 128) * 0.05, _t(g, 128, 256) * 0.05,
                   _t(g, 1, 128)], ff.fused_ff_modulated),
    "K8 fused_ff": (_ff, ff.fused_ff),
    "K6 sparse_attention": (_sparse, sparse.sparse_attention),
    "K3 causal_conv3d_fused": (_conv, conv.causal_conv3d_fused),
    "K3 quant_window_scales": (lambda g: [_t(g, 1, 2, 8, 32, 128)],
                               lambda x: conv.quant_window_scales(x, 32)),
    "T1 gemm": (lambda g: [_t(g, 8, 32), _t(g, 16, 32)], bench_int8mm.gemm),
    "T2 gemm": (lambda g: [_t(g, 8, 32), _t(g, 16, 32)], bpg.gemm),
    "T3 ff": (_ff, bpg.ff),
    "T4 ff_chunked": (_ff, lambda x, w1, w2: bpg.ff_chunked(x, w1, w2,
                                                            bf=128)),
    "T5 i8_decomp": (_packed, lambda *a: bench_i8_decomp.i8_decomp(
        *a, mode="full")),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_kernel_entry_refuses_grad(name):
    """With an input that requires grad, the entry raises naming the
    kernel; under ``no_grad`` the same inputs run and give the output of
    the detached inputs."""
    make, call = ENTRIES[name]
    g = torch.Generator().manual_seed(len(name))
    args = make(g)
    plain = call(*args)
    leaves = [a for a in args if a.is_floating_point()]
    for a in leaves:
        a.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*Pallas"):
        call(*args)
    with torch.no_grad():
        out = call(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(a, b)
    # grad mode on but no operand requiring grad: runs
    for a in leaves:
        a.requires_grad_(False)
    call(*args)


def test_launch_gemm_refuses_grad_before_its_device_check():
    """``ops/gemm.launch_gemm`` (the card-only entry under T1 and T2)
    refuses grad before it looks at the device."""
    a = torch.zeros(8, 32, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(16, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="^T2_gemm has no backward"):
        gemm.launch_gemm("T2_gemm", a, b, torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        gemm.launch_gemm("T2_gemm", a, b, torch.bfloat16)


DIT = dict(in_visual_dim=4, out_visual_dim=4, in_text_dim=32,
           in_text_dim2=16, time_dim=32, patch_size=(1, 2, 2), model_dim=256,
           ff_dim=256, num_text_blocks=1, num_visual_blocks=1,
           axes_dims=(16, 24, 24), visual_cond=False)


def _batch(b=2, t=2, hw=32):
    rng = np.random.default_rng(2)
    return (rand(rng, b, t, hw, hw, 4), rand(rng, b, 8, 32), rand(rng, b, 16),
            np.ones((b, 8), bool), np.full(b, 0.5, np.float32),
            rand(rng, b, t, hw, hw, 4))


@pytest.mark.parametrize("route", ["flash", "auto", "bf16-ff", "dense"])
def test_dit_loss_refuses_kernels_as_jax(route):
    """``flow_matching_loss`` under autograd: with ``attn_impl="flash"``
    the port raises at K1 and JAX's gradient through its Pallas kernel
    (interpret mode) raises too; ``"auto"`` reaches K1 in the port (the
    JAX package would pick its kernel on the TPU); bf16 parameters at an FF
    shape K2 admits (512 rows of 256) raise at K2 even with dense
    attention; fp32 and dense trains, on both packages alike."""
    jcfg, pcfg = both_cfgs(**DIT)
    dtype = torch.bfloat16 if route == "bf16-ff" else torch.float32
    jparams, model = random_dit_pair(jcfg, pcfg, seed=1, dtype=dtype)
    # K2 admits 512 rows and more: 2 x 2 x 16 x 16 visual tokens; the
    # others take one 8 x 8 frame
    x0, te, pe, mask, t, noise = (_batch() if route == "bf16-ff"
                                  else _batch(b=1, t=1, hw=16))
    attn = {"bf16-ff": "dense"}.get(route, route)
    args = [torch.from_numpy(a) for a in (x0, te, pe, mask, t, noise)]
    if route == "dense":
        loss = tt.flow_matching_loss(model, pcfg, *args, attn_impl=attn)
        loss.backward()
        want = jt.flow_matching_loss(jparams, jcfg, *map(jnp.asarray, (
            x0, te, pe, mask, t, noise)), attn_impl=attn)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
        assert all(p.grad is not None for p in model.parameters())
        return
    kernel = {"flash": "K1", "auto": "K1", "bf16-ff": "K2"}[route]
    with pytest.raises(RuntimeError, match=f"^{kernel} has no backward"):
        tt.flow_matching_loss(model, pcfg, *args, attn_impl=attn)
    with torch.no_grad():
        assert torch.isfinite(tt.flow_matching_loss(model, pcfg, *args,
                                                    attn_impl=attn))
    if route == "flash":
        def loss_fn(p):
            return jt.flow_matching_loss(p, jcfg, *map(jnp.asarray, (
                x0, te, pe, mask, t, noise)), attn_impl="flash")

        # the JAX package cannot differentiate a pallas_call either
        with pytest.raises(AssertionError):
            jax.grad(loss_fn)(jparams)
