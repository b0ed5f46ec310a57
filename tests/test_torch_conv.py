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

from ._torch_parity import assert_quant_conv_close, rand, to_np


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


# ---------------------------------------------------------------------------
# K3's prologue, prefix and W8A8 modes against the Pallas kernel in
# interpret mode (driven as tests/test_pallas_interpret.py drives it)
# ---------------------------------------------------------------------------

def _gn(rng, c):
    """A folded GroupNorm's per-channel scale and shift."""
    return ((1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _both(x, w, b, wt, dtype="float32", scale=None, shift=None, **kw):
    """(port plain version, Pallas kernel in interpret mode) on the same
    inputs; ``kw`` are the shared mode arguments."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_fused({"weight": jnp.asarray(w, jdt), "bias": jnp.asarray(b)},
                     jnp.asarray(x, jdt),
                     scale=None if scale is None else jnp.asarray(scale),
                     shift=None if shift is None else jnp.asarray(shift),
                     bh=8, interpret=True, **kw)
    got = causal_conv3d_fused(
        torch.from_numpy(x).to(tdt), wt.to(tdt), torch.from_numpy(b),
        scale=None if scale is None else torch.from_numpy(scale),
        shift=None if shift is None else torch.from_numpy(shift), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    return to_np(got), to_np(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_fused_prologue_matches_pallas_interpret(dtype):
    """The folded GroupNorm + SiLU prologue over two H tiles. fp32: the
    same values (XLA contracts x * scale + shift to an FMA, the port does
    not: an ulp), 2e-4. bf16: both round the transformed input once, but
    that ulp may move a value across a bf16 rounding, 2e-2."""
    rng = np.random.default_rng(3)
    x = rand(rng, 1, 2, 16, 64, 128, scale=0.5)
    w, b, wt = _conv(rng, 128, 128)
    sc, sh = _gn(rng, 128)
    got, want = _both(x, w, b, wt, dtype, sc, sh, act=True)
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_k3_fused_cout_blocked_matches_pallas_interpret():
    """256 -> 512 channels, where the TPU kernel blocks Cout (its 2-D grid
    revisits each transformed input tile); the prologue without SiLU. fp32,
    2e-4."""
    from kandinsky5_tpu.ops.conv_pallas import _pick_tiles

    assert _pick_tiles(64, 256, 512)[1] < 512
    rng = np.random.default_rng(4)
    x = rand(rng, 1, 2, 8, 64, 256, scale=0.3)
    w, b, wt = _conv(rng, 256, 512)
    sc, sh = _gn(rng, 256)
    got, want = _both(x, w, b, wt, "float32", sc, sh, act=False)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_k3_prefix_planes_match_pallas_interpret():
    """``time_padded`` with two carried history planes that pass through
    the prologue untouched (the streaming decode's fused path). fp32,
    2e-4."""
    rng = np.random.default_rng(5)
    x = rand(rng, 1, 5, 8, 64, 128, scale=0.4)
    w, b, wt = _conv(rng, 128, 128)
    sc, sh = _gn(rng, 128)
    got, want = _both(x, w, b, wt, "float32", sc, sh, act=True,
                      time_padded=True, prefix_planes=2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the prefix planes really are untransformed: transforming them too
    # moves the first output frames
    moved, _ = _both(x, w, b, wt, "float32", sc, sh, act=True,
                     time_padded=True)
    assert np.abs(moved[:, :2] - want[:, :2]).max() > 1e-2


def test_k3_quant_one_tile_matches_pallas_interpret():
    """W8A8 on one TPU tile (T 1, H 8, W 64: one scale for the whole
    input), plain: exact to 1e-5 up to rounding flips (see
    ``assert_quant_conv_close``); and within 5 % of the float conv."""
    rng = np.random.default_rng(6)
    x = rand(rng, 1, 1, 8, 64, 128, scale=0.4)
    w, b, wt = _conv(rng, 128, 128)
    got, want = _both(x, w, b, wt, "float32", quant=True)
    assert_quant_conv_close(got, want, x, wt)
    ref = to_np(conv3d_plain(torch.from_numpy(x), wt, torch.from_numpy(b)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05


def test_k3_quant_fused_multitile_matches_pallas_interpret(monkeypatch):
    """W8A8 with the prologue over 2 H tiles and 5 W tiles (W 320:
    ``pick_tiles(..., quant=True)`` gives bw 64, so each scale window
    reaches six columns into the next tile), time_padded with two prefix
    planes. Exact to 1e-5 up to rounding flips (``assert_quant_conv_close``:
    XLA's reciprocal multiply and FMA move a pre-rounding value by an ulp,
    so a code within a few ulps of .5 may round the other way, moving its
    27 output voxels by one step each, and nothing else). Control: the same
    conv with one scale for the whole tensor (the largest window's) fails
    the check, so the per-window partition is what matches."""
    from kandinsky5_tpu_torch.ops import conv as conv_mod

    assert conv_mod.quant_tile_width(320, 128, 128) == 64
    rng = np.random.default_rng(7)
    x = rand(rng, 1, 4, 16, 320, 128, scale=0.4)
    x[:, :, :8, :64] *= 3.0  # windows of different scales
    w, b, wt = _conv(rng, 128, 128)
    sc, sh = _gn(rng, 128)
    kw = dict(act=True, time_padded=True, prefix_planes=2, quant=True)
    got, want = _both(x, w, b, wt, "float32", sc, sh, **kw)
    mode = dict(time_padded=True, scale=sc, shift=sh, act=True,
                prefix_planes=2)
    assert_quant_conv_close(got, want, x, wt, **mode)

    real = conv_mod.window_scales

    def one_scale(*args):
        s, _ = real(*args)
        top = s.max()
        return torch.full_like(s, top), torch.full_like(s, 1.0 / top)

    with monkeypatch.context() as m:
        m.setattr(conv_mod, "window_scales", one_scale)
        control, _ = _both(x, w, b, wt, "float32", sc, sh, **kw)
    with pytest.raises(AssertionError):
        assert_quant_conv_close(control, want, x, wt, **mode)


def test_k3_quant_int8_codes_and_weight_cache():
    """The weight quantization is ``_conv_fused``'s (per-Cout max over taps
    and Cin, divide, round half to even, clip) value for value, and it is
    computed once per weight tensor (again after an in-place change)."""
    from kandinsky5_tpu_torch.ops.conv import (
        quantize_conv_weight,
        quantized_weight,
    )

    rng = np.random.default_rng(8)
    w, _, wt = _conv(rng, 128, 256)
    w27 = jnp.asarray(w).reshape(27, 128, 256)
    ws = jnp.maximum(jnp.max(jnp.abs(w27), axis=(0, 1)), 1e-8) / 127.0
    wq = jnp.clip(jnp.round(w27 / ws), -127, 127).astype(jnp.int8)
    w8, got_ws = quantize_conv_weight(wt)
    np.testing.assert_allclose(got_ws.numpy(), np.asarray(ws), rtol=1e-6)
    diff = np.abs(w8.numpy().transpose(0, 2, 1).astype(int)
                  - np.asarray(wq).astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-4  # w / ws: an ulp
    first = quantized_weight(wt)
    assert quantized_weight(wt)[0] is first[0]
    with torch.no_grad():
        wt.mul_(2.0)
    assert quantized_weight(wt)[0] is not first[0]


CLASSES = [(512, 512), (512, 256), (256, 256), (256, 128), (128, 128),
           (128, 256), (16, 512), (512, 3)]
WIDTHS = [32, 60, 64, 68, 96, 128, 136, 192, 256, 272, 320, 384, 512, 544,
          768, 1024, 1088]


def test_pick_tiles_and_admission_match_conv_pallas(monkeypatch):
    """The port's copy of the TPU tile rule (``pick_tiles``: which W tile,
    both modes) and of ``conv_pallas_supported`` (which convs the JAX
    package fuses and quantizes) over the decoder's channel classes at the
    widths of the 5 s and 10 s tiles, the 1024 px tiles (544, 272, 136, 68
    pixels) and ragged ones."""
    import jax

    from kandinsky5_tpu.ops import conv_pallas
    from kandinsky5_tpu_torch.ops.conv import pick_tiles, tpu_kernel_admits

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for cin, cout in CLASSES:
        for ww in WIDTHS:
            for quant in (False, True):
                assert pick_tiles(ww, cin, cout, quant=quant) == \
                    conv_pallas._pick_tiles(ww, cin, cout, quant=quant)
            for b, hh in ((1, 8), (1, 68), (1, 136), (2, 64)):
                jx = jax.ShapeDtypeStruct((b, 3, hh, ww, cin), jnp.bfloat16)
                jw = jax.ShapeDtypeStruct((3, 3, 3, cin, cout), jnp.bfloat16)
                want = conv_pallas.conv_pallas_supported(jx, jw, (1, 1, 1))
                got = tpu_kernel_admits(
                    torch.empty((b, 3, hh, ww, cin), device="meta"),
                    torch.empty((cout, cin, 3, 3, 3), device="meta"))
                assert got == want, (cin, cout, b, hh, ww)
