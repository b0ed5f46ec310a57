"""The plain references against the port at small sizes on the CPU, and
the controls that the limits must catch."""

import math

import pytest
import torch

from perfbench_tiny import run, tiny_config, tiny_decode_config

from perfbench.reference import dit as ref_dit


@pytest.mark.parametrize("cell,config", [
    ("k5_t2v_5s_distil.denoise", "k5_t2v_5s_distil"),
    ("k5_t2v_10s_distil.denoise", "k5_t2v_10s_distil"),
])
def test_dit_reference_matches_port_fp32(cell, config):
    """In float32 the port's step and the reference's agree to rounding:
    the reference computes the same model (NABLA's mask included)."""
    keep = []
    r = run(cell, tiny_config(config), keep=keep)
    assert r["correct"]
    for value in (c["value"] for c in r["checks"].values()):
        assert value < 1e-4
    if "10s" in cell:
        ref = keep[0]
        assert ref.spec.attention_type == "nabla"


def test_nabla_reference_drops_blocks():
    """At the NABLA test size the reference's mask is neither empty nor
    full, so the comparison above exercises the mask."""
    keep = []
    run("k5_t2v_10s_distil.denoise", tiny_config("k5_t2v_10s_distil"),
        keep=keep)
    drv = keep[0]
    att = drv.cfg["published"]["model"]["attention"]
    ref = ref_dit.DiTReference(drv.params,
                               drv.cfg["published"]["model"]["dit_params"],
                               drv.cfg["published"]["metrics"]["scale_factor"],
                               {k: att[k] for k in ("P", "wT", "wH", "wW")})
    s = drv.sample
    ref.velocity(s["x_in"], s["cond"]["text_embeds"],
                 s["cond"]["pooled_embed"], s["cond"]["mask"], s["t"])
    assert 0.2 < min(ref.kept) and max(ref.kept) < 0.99


def test_vae_reference_matches_port_fp32():
    r = run("k5_t2v_5s_distil.decode", tiny_decode_config())
    assert r["correct"]
    # the frames are truncated to uint8 on both sides: rounding flips a
    # level now and then
    assert r["checks"]["frames_rmse"]["value"] < 0.05


@pytest.mark.parametrize("control", ["fp8", "int8"])
@pytest.mark.parametrize("cell,config", [
    ("k5_t2v_5s_distil.denoise", "k5_t2v_5s_distil"),
    ("k5_t2v_10s_distil.denoise", "k5_t2v_10s_distil"),
])
def test_dit_control_fails_the_limit(cell, config, control):
    """The bf16 port passes the limits; the reference in float8 put in its
    place, and the port's own int8 path, come out not correct through the
    harness's own judgement. The int8 path is caught by the first visual
    self-attention sublayer, not by the step's update."""
    cfg = tiny_config(config, "bfloat16")
    assert run(cell, cfg)["correct"]
    r = run(cell, cfg, control=control)
    assert not r["correct"]
    checks = r["checks"]
    assert checks["attn0_rel_l2"]["value"] > checks["attn0_rel_l2"]["limit"]
    if control == "fp8":
        assert checks["update_rel_l2"]["value"] \
            > checks["update_rel_l2"]["limit"]


def test_dit_sublayer_tap_is_removed():
    """The wrapper that holds the sampled step's sublayer is gone once the
    run has ended, and it held the first visual block's input and output."""
    from kandinsky5_tpu_torch.models import dit

    orig = dit._self_attention
    keep = []
    run("k5_t2v_5s_distil.denoise", tiny_config("k5_t2v_5s_distil"),
        keep=keep)
    assert dit._self_attention is orig
    x, out = keep[0].sample["attn0"]
    assert x.shape == out.shape == (1, 3 * 16 * 16, 128)


def test_decode_control_fails_the_limit():
    """The bf16 decode passes and the port's W8A8 convs fail."""
    cfg = tiny_decode_config("bfloat16")
    assert run("k5_t2v_5s_distil.decode", cfg)["correct"]
    assert not run("k5_t2v_5s_distil.decode", cfg, control="int8")["correct"]


def test_attention_fallback_matches():
    """Rows whose weights all underflow under the global shift take the
    per-row maximum, which gives the same answer where both work."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(256, 2, 64, generator=g) for _ in range(3))
    bm = torch.rand(2, 4, 4, generator=g) > 0.3
    bm |= torch.eye(4, dtype=torch.bool)[None]
    km = torch.arange(256) < 200
    a = ref_dit.attention(q, k, v, km, bm)
    b = ref_dit.attention_rowmax(q, k, v, km, bm)
    assert float((a - b).abs().max()) < 1e-5
    big = ref_dit.attention(q * 30, k * 30, v)
    assert math.isfinite(float(big.abs().max()))
    assert torch.allclose(big, ref_dit.attention_rowmax(q * 30, k * 30, v))
