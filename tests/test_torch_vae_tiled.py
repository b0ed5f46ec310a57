"""The port's overlap-tiled VAE decode (``HunyuanVideoVAE.decode(mode=
"tiled")``, kandinsky5_tpu_torch/models/vae.py) against the JAX package's on
the CPU, the reference's tiling tables, the fused streaming decode, and the
routing of the fused and W8A8 convs.

Weights are the JAX ``init_vae_params`` tree (through
``vae_state_dict_from_jax``), inputs seeded numpy arrays, fp32 throughout.
The JAX package never fuses or quantizes off its accelerator (its
``conv_pallas_supported`` asks for a TPU), so its CPU decode is the unfused
XLA conv; the port's tiled decode fuses GroupNorm + SiLU into K3's prologue
(its plain version here) wherever the TPU kernel would. In fp32 the two
compute the same values (the fused prologue rounds to fp32, a no-op) up to
summation order and an ulp of the affine, so the bound is the JAX golden
tests' 2e-4. ``test_decode_convs_match_jax`` instead forces the JAX decode
onto its Pallas conv (interpret mode) with the fused and W8A8 switches, as
on the TPU, and holds the port's ``fuse_gn`` and ``int8_conv`` decodes
against it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models import vae as jax_vae
from kandinsky5_tpu.ops import conv_pallas
from kandinsky5_tpu_torch.checkpoint import (
    vae_params_from_state_dict,
    vae_state_dict_from_jax,
)
from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
from kandinsky5_tpu_torch.models import vae as vae_mod
from kandinsky5_tpu_torch.models import vae_stream
from kandinsky5_tpu_torch.models.vae import ConvMode, HunyuanVideoVAE
from kandinsky5_tpu_torch.ops.conv import tpu_kernel_admits
from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

from ._torch_parity import assert_quant_conv_close, rand, to_np


@pytest.fixture(scope="module")
def vae_pair():
    jparams = jax_vae.init_vae_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    sd = vae_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    return jparams, vae_params_from_state_dict(sd, device="cpu",
                                               dtype=torch.float32)


def test_optimal_tiling_matches_jax():
    """Both tables equal the JAX package's, and ``_optimal_tiling`` picks
    the same tiles for every key of both (temporal keys at 256x256, where
    short videos stay untiled, and at 512x768; spatial keys as square
    frames of 17 and 121 frames)."""
    assert vae_mod.OPT_TEMPORAL_TILING == jax_vae.OPT_TEMPORAL_TILING
    assert vae_mod.OPT_SPATIAL_TILING == jax_vae.OPT_SPATIAL_TILING
    jv = jax_vae.HunyuanVideoVAE({})
    tv = HunyuanVideoVAE({})
    for frames in jax_vae.OPT_TEMPORAL_TILING:
        for hw in ((256, 256), (512, 768), (768, 512)):
            assert tv._optimal_tiling(frames, *hw) == \
                jv._optimal_tiling(frames, *hw)
    for size in jax_vae.OPT_SPATIAL_TILING:
        for frames in (17, 121):
            assert tv._optimal_tiling(frames, size, size) == \
                jv._optimal_tiling(frames, size, size)


# (latent shape, tile (frames, h, w), stride (frames, h, w)): temporal
# tiling only (tests/test_vae_stream.py's frame tiles), spatial only (3 x 3
# tiles of 4 x 4 latents; the last tile level, 32 x 32 px at 128 and 256
# channels, is one the TPU kernel admits, so the port fuses there), and
# both (3 temporal x 2 x 2 spatial tiles, blends on every axis)
CASES = {
    "temporal": ((1, 7, 4, 4, 16), (17, 32, 32), (8, 32, 32)),
    "spatial": ((1, 2, 8, 8, 16), (5, 32, 32), (5, 16, 16)),
    "both": ((1, 7, 6, 6, 16), (13, 32, 32), (8, 16, 16)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_decode_matches_jax(vae_pair, case, monkeypatch):
    """The port's tiled decode against ``HunyuanVideoVAE.decode(mode=
    "tiled")`` of the JAX package at forced tile settings, fp32, 2e-4; the
    "spatial" case also counts K3's fused calls (the port fuses where the
    TPU kernel admits the conv)."""
    jparams, params = vae_pair
    shape, tile, stride = CASES[case]
    z = rand(np.random.default_rng(len(case)), *shape, scale=0.5)
    jv = jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32)
    jv._apply_tiling(tile, stride)
    want = to_np(jv.decode(jnp.asarray(z), opt_tiling=False, mode="tiled"))
    fused = []
    real = vae_mod.causal_conv3d_fused

    def spy(x, w, b, *args, **kw):
        fused.append(kw.get("scale") is not None)
        return real(x, w, b, *args, **kw)

    monkeypatch.setattr(vae_mod, "causal_conv3d_fused", spy)
    tv = HunyuanVideoVAE(params, dtype=torch.float32)
    tv._apply_tiling(tile, stride)
    got = to_np(tv.decode(torch.from_numpy(z), opt_tiling=False, mode="tiled"))
    assert got.shape == want.shape == (1, 4 * (shape[1] - 1) + 1,
                                       8 * shape[2], 8 * shape[3], 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if case == "spatial":
        # per tile: up2's upsampler conv (256 ch) runs unfused; up3's three
        # resnets fuse both their convs at 32 x 32 px
        assert fused.count(True) == 9 * 6


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


def _resnet_params(rng, c):
    def conv():
        return {"weight": torch.from_numpy(rand(rng, c, c, 3, 3, 3,
                                                scale=0.05)),
                "bias": torch.from_numpy(rand(rng, c, scale=0.02))}

    def norm():
        return {"weight": torch.from_numpy(1 + rand(rng, c, scale=0.1)),
                "bias": torch.from_numpy(rand(rng, c, scale=0.1))}

    return {"norm1": norm(), "conv1": conv(), "norm2": norm(), "conv2": conv()}


def test_fused_stream_resnet_matches_unfused():
    """The fused streaming resnet (K3's prologue, the carried history
    passing as prefix planes) against the unfused one on the port, across
    chunks of 2, 3 and 1 frames (the last reaches into the carried
    history): per-chunk outputs and carried state, fp32, 2e-4 (as the JAX
    package's test_stream_fused_resnet_matches_unfused)."""
    rng = np.random.default_rng(13)
    p = _resnet_params(rng, 128)
    x = torch.from_numpy(rand(rng, 1, 6, 8, 64, 128, scale=0.3))
    st_u = st_f = None
    for lo, hi in ((0, 2), (2, 5), (5, 6)):
        y_u, st_u = vae_stream.resnet_stream(p, x[:, lo:hi], st_u, ConvMode())
        y_f, st_f = vae_stream.resnet_stream(p, x[:, lo:hi], st_f,
                                             ConvMode(fuse=True))
        torch.testing.assert_close(y_f, y_u, rtol=2e-4, atol=2e-4)
        for key in ("conv1", "conv2"):
            torch.testing.assert_close(st_f[key], st_u[key], rtol=2e-4,
                                       atol=2e-4)


def _jax_admits(p, x):
    """``conv_pallas_supported`` less its backend and dtype tests: the JAX
    package's routing to its Pallas conv as it runs on the TPU."""
    w = p["weight"]
    if tuple(w.shape[:3]) != (3, 3, 3):
        return False
    cin, cout = w.shape[3:]
    b, _, hh, ww, _ = x.shape
    return (cin in (128, 256, 512) and cout in (128, 256, 512) and b == 1
            and hh % 8 == 0 and conv_pallas._pick_tiles(ww, cin, cout)[0] > 0)


def _conv_key(y_shape, fused, prefix, quant):
    return (tuple(y_shape), bool(fused), int(prefix), bool(quant))


def _record_jax_convs(m, rec, fuse, int8):
    """Run the JAX package's decode as on the TPU (its Pallas conv wherever
    it admits the conv, in interpret mode; ``fuse`` and ``int8`` forced)
    and append every Pallas conv's mode, inputs and output to ``rec`` as
    numpy arrays, in call order (ordered debug callbacks, so the records
    survive jit)."""
    real = conv_pallas.causal_conv3d_fused
    m.setattr(jax_vae, "_conv_pallas_on", _jax_admits)
    m.setattr(jax_vae, "_fuse_gn_on",
              lambda default: default if fuse is None else fuse)
    m.setattr(jax_vae, "_int8_conv_on", lambda: int8)

    def fused(p, x, scale=None, shift=None, act=False, bh=None,
              time_padded=False, prefix_planes=0, quant=False,
              interpret=False):
        y = real(p, x, scale=scale, shift=shift, act=act, bh=bh,
                 time_padded=time_padded, prefix_planes=prefix_planes,
                 quant=quant, interpret=True)
        mode = dict(time_padded=time_padded, act=act,
                    prefix_planes=prefix_planes, quant=quant)
        arrays = [x, p["weight"], p["bias"], y]
        if scale is not None:
            arrays += [scale, shift]

        def note(*a):
            rec.append((mode, [np.asarray(v) for v in a]))

        jax.debug.callback(note, *arrays, ordered=True)
        return y

    m.setattr(conv_pallas, "causal_conv3d_fused", fused)


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


class _StubEmbedder:
    pass


def test_pipeline_decode_mode_and_int8_conv_routing(vae_pair, monkeypatch):
    """``decode_mode`` reaches the VAE (None: "stream"), and under
    ``int8_conv`` exactly the convs ``conv_pallas_supported`` admits run
    W8A8, in both decodes: every 3x3x3 conv is recorded with its input and
    held against the JAX rule (with its backend test answered "tpu"); the
    others stay bf16 (K3) or plain. The VAE passed in keeps its options."""
    _, params = vae_pair
    conf = load_config(f"{CONFIG_DIR}/config_5s_distil.yaml")
    vae = HunyuanVideoVAE(params, dtype=torch.float32)
    modes, calls = [], []
    real_decode = HunyuanVideoVAE.decode

    def decode(self, z, opt_tiling=True, mode="stream"):
        modes.append((mode, self.int8_conv))
        return real_decode(self, z, opt_tiling, mode)

    def spy(name, real):
        def run(x, w, b, *args, **kw):
            if tuple(w.shape[2:]) == (3, 3, 3):
                calls.append((tuple(x.shape), tuple(w.shape),
                              bool(kw.get("quant"))))
            return real(x, w, b, *args, **kw)
        return run

    monkeypatch.setattr(HunyuanVideoVAE, "decode", decode)
    for mod in (vae_mod, vae_stream):
        for name in ("causal_conv3d_fused", "conv3d_plain"):
            monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    # 4 x 4 latents: widths 4 to 32 px, so all but the last level's convs
    # fall outside the TPU kernel's tiles and must stay bf16
    z = torch.from_numpy(rand(np.random.default_rng(2), 1, 2, 4, 4, 16))
    Kandinsky5T2VPipeline(None, conf, _StubEmbedder(), vae).decode_latents(z)
    assert modes == [("stream", False)] and not any(q for *_, q in calls)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for dm in ("tiled", "stream"):
        modes.clear()
        calls.clear()
        pipe = Kandinsky5T2VPipeline(None, conf, _StubEmbedder(), vae,
                                     decode_mode=dm, int8_conv=True)
        frames = pipe.decode_latents(z)
        assert frames.shape == (1, 5, 32, 32, 3) and frames.dtype == np.uint8
        assert modes == [(dm, True)] and not vae.int8_conv
        n_quant = 0
        for xs, ws, quant in calls:
            jx = jax.ShapeDtypeStruct(xs, jnp.bfloat16)
            jw = jax.ShapeDtypeStruct((3, 3, 3, ws[1], ws[0]), jnp.bfloat16)
            assert quant == conv_pallas.conv_pallas_supported(jx, jw, (1, 1, 1)), \
                (dm, xs, ws)
            n_quant += quant
        assert 0 < n_quant < len(calls)
        assert pipe.int8_conv
    # the pipeline reports the option of the VAE it was given
    assert Kandinsky5T2VPipeline(None, conf, _StubEmbedder(),
                                 vae.replace(int8_conv=True)).int8_conv
    assert not Kandinsky5T2VPipeline(None, conf, _StubEmbedder(), vae).int8_conv
    with pytest.raises(ValueError, match="decode_mode"):
        Kandinsky5T2VPipeline(None, conf, _StubEmbedder(), vae,
                              decode_mode="untiled")
