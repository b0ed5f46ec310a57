"""The port's decodes against the JAX package's on the CPU, the second half
of ``tests/test_torch_vae_tiled.py`` (split so that the two halves run on
two workers): the stream decode's fall-back to the tiled decode above the
spatial threshold, and the decode with ``fuse_gn`` / ``int8_conv`` held
conv by conv against the JAX decode forced onto its Pallas conv
(interpret mode) with the counterpart switches, as on the TPU.

Weights are the JAX ``init_vae_params`` tree (``vae_pair``, shared with the
first half), inputs seeded numpy arrays, fp32 throughout; the bound is the
JAX golden tests' 2e-4, and W8A8 convs are flip-aware
(``assert_quant_conv_close``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models import vae as jax_vae
from kandinsky5_tpu_torch.models import vae as vae_mod
from kandinsky5_tpu_torch.models import vae_stream
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
from kandinsky5_tpu_torch.ops.conv import tpu_kernel_admits

from ._torch_parity import assert_quant_conv_close, rand, to_np
from .test_torch_vae_tiled import (  # noqa: F401 (vae_pair: the fixture)
    CASES,
    _conv_key,
    _record_jax_convs,
    vae_pair,
)


def test_stream_falls_back_to_tiled_above_the_spatial_threshold(vae_pair):
    """Where spatial tiling applies (here the stride width is below the
    latent width), ``mode="stream"`` decodes tiled: the same frames as
    ``mode="tiled"`` and as the JAX tiled decode (2e-4); below it, the
    streaming decode runs."""
    jparams, params = vae_pair
    shape, tile, stride = CASES["spatial"]
    z = rand(np.random.default_rng(9), *shape, scale=0.5)
    tv = HunyuanVideoVAE(params, dtype=torch.float32)
    tv._apply_tiling(tile, stride)
    via_stream = tv.decode(torch.from_numpy(z), opt_tiling=False,
                           mode="stream")
    torch.testing.assert_close(
        via_stream, tv.decode(torch.from_numpy(z), opt_tiling=False,
                              mode="tiled"), rtol=0, atol=0)
    jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
    jv._apply_tiling(tile, stride)
    want = to_np(jv.decode(jnp.asarray(z), opt_tiling=False, mode="tiled"))
    np.testing.assert_allclose(to_np(via_stream), want, rtol=2e-4, atol=2e-4)
    # 64 x 64 px with the tables: no spatial tiling, so the stream decode
    torch.testing.assert_close(
        tv.decode(torch.from_numpy(z)),
        vae_stream.streaming_decode(params, torch.from_numpy(z)))
    with pytest.raises(ValueError, match="decode mode"):
        tv.decode(torch.from_numpy(z), mode="untiled")


# (VAE options, decode mode, latent shape, forced tiling or None): the
# streaming decode fused (5 latent frames: chunks of 4 and 1, so the second
# chunk's convs carry two prefix planes), fused with W8A8, and the tiled
# decode with W8A8 (2 temporal tiles); pixel frames 8 x 32 or 32 x 32, so
# the last level's convs are ones the TPU kernel admits
DECODES = {
    "stream-fused": (dict(fuse_gn=True), "stream", (1, 5, 1, 4, 16), None),
    "stream-fused-int8": (dict(fuse_gn=True, int8_conv=True), "stream",
                          (1, 5, 1, 4, 16), None),
    "tiled-int8": (dict(int8_conv=True), "tiled", (1, 5, 4, 4, 16),
                   ((9, 32, 32), (8, 32, 32))),
}


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_convs_match_jax(vae_pair, case, monkeypatch):
    """The port's decode with the VAE's ``fuse_gn`` / ``int8_conv``
    options against the JAX package's with the counterpart switches
    (``_fuse_gn_on``, ``_int8_conv_on``) forced and its Pallas conv in
    interpret mode, fp32. Both decodes must call the TPU conv in the same
    order with the same modes (output shape, prologue, prefix planes,
    W8A8); each of the port's K3 calls is then held against JAX's on JAX's
    own input (teacher forcing): 2e-4, or under W8A8 exact to 1e-5 up to
    rounding flips (``assert_quant_conv_close``). The whole decode is held
    against JAX's only without W8A8 (2e-4): with it, flips compound
    through GroupNorm's statistics, and the two packages' whole decodes
    lie about as far apart as the bf16 decode lies from either, while
    each conv agrees up to its flips."""
    jparams, params = vae_pair
    opts, mode, shape, tiling = DECODES[case]
    z = rand(np.random.default_rng(21), *shape, scale=0.5)
    int8 = opts.get("int8_conv", False)

    rec = []
    # jit caches hold traces made under other switches: clear them before
    # and after the forced run
    jax.clear_caches()
    with monkeypatch.context() as m:
        _record_jax_convs(m, rec, opts.get("fuse_gn"), int8)
        jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
        if tiling:
            jv._apply_tiling(*tiling)
        want = to_np(jv.decode(jnp.asarray(z), opt_tiling=tiling is None,
                               mode=mode))
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

    for mod in (vae_mod, vae_stream):
        monkeypatch.setattr(mod, "causal_conv3d_fused", spy)
    tv = HunyuanVideoVAE(params, dtype=torch.float32, **opts)
    if tiling:
        tv._apply_tiling(*tiling)
    got = to_np(tv.decode(torch.from_numpy(z), opt_tiling=tiling is None,
                          mode=mode))
    assert got.shape == want.shape
    admitted = [c for ok, c in calls if ok]
    assert not any(c[1] or c[3] for ok, c in calls if not ok)
    assert admitted == [_conv_key(y.shape, bool(gn), md["prefix_planes"],
                                  md["quant"])
                        for md, (x, w, b, y, *gn) in rec]
    assert any(c[1] for c in admitted)
    assert any(c[2] for c in admitted) == (mode == "stream")
    assert all(c[3] == int8 for c in admitted)

    for md, (x, w, b, y, *gn) in rec:
        wt = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
        kw = dict(time_padded=md["time_padded"])
        if gn:
            kw.update(scale=torch.from_numpy(gn[0]),
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
