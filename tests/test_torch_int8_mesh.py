"""The int8 options on the port's mesh against the JAX package's meshes and
the port on one device, on the CPU.

* The W8A8 specs: the split dim of every quantized DiT parameter against
  JAX's ``_adapt_quantized_specs(quantize_dit_params(p),
  dit_param_specs(mesh))``, by name (no launch).
* W8A8 linears (tests/test_int8_linear.py's shapes) on tp 2 and 4, fp32
  and bf16: row parallel (the activation scale's max and the int32 product
  all-reduced) and column parallel, bit-equal to one device's
  ``_linear_i8``; each of the three faults (a rank's own activation scale,
  a weight scale from the rank's slice, the bias added on every rank)
  breaks the equality.
* The rank-local quantization (``fast_init_dit_shard(int8_linear=True)``)
  bit-equal to slicing the whole model's ``quantize_dit_params``.
* tests/test_int8_linear.py's tp 4 W8A8 forward (modulation drawn at
  random, so that every block does work) against JAX's ``make_mesh(4)``
  run of it, flip-aware: each W8A8 linear of the ranks' forward takes the
  JAX run's own input to it (the rank's columns of it where the layer is
  row parallel), as ``tests/test_torch_int8.py`` forces one device's;
  unforced, the ranks' output equals the port's one device bit for bit.
* K5's plain version on (1, 2, 2) ranks against JAX's
  ``attention(..., impl="flash_int8")`` under ``make_mesh(4, sp=2)`` in
  interpret mode (tests/test_tp_parity.py's case), self-attention with K
  and V gathered and masked cross-attention, at
  ``tests/test_torch_int8.py``'s bf16 tolerance for K5 against JAX
  (2e-2), and against the port's one device at JAX's 5e-3.
* A 2-step int8 pipeline with W8A8 on (1, 2, 2) (K5) and on (1, 1, 4) (K7)
  against the port's one device, within the one device's own int8 error.
* ``cli.py --tp 8 --int8_linear --attn flash_int8`` launches.

One launch of four gloo CPU ranks (``tests/_torch_int8_mesh_ranks.py``, no
JAX); JAX computes its side in the test process while the ranks run."""

import concurrent.futures
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kandinsky5_tpu.models.nn as jax_nn
from kandinsky5_tpu.models.dit import dit_forward as jax_dit_forward
from kandinsky5_tpu.models.dit import quantize_dit_params as jax_quantize_dit
from kandinsky5_tpu.ops.attention import attention as jax_attention
from kandinsky5_tpu.parallel.sharding import (
    _adapt_quantized_specs,
    dit_param_specs as jax_dit_param_specs,
    make_mesh,
    shard_dit_params,
    sharding_ctx,
)
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.models import nn as port_nn
from kandinsky5_tpu_torch.models.dit import dit_forward, quantize_dit_params
from kandinsky5_tpu_torch.ops.flash import flash_int8
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.parallel.sharding import split_dim

from . import _torch_int8_mesh_ranks as ranks_mod
from . import _torch_tp_ranks
from ._torch_parity import both_cfgs, random_dit_pair, to_np

# tests/test_int8_linear.py's tp 4 DiT: 8 heads of 16
TINY = dict(in_visual_dim=4, out_visual_dim=4, in_text_dim=32,
            in_text_dim2=16, time_dim=32, model_dim=128, ff_dim=256,
            num_text_blocks=1, num_visual_blocks=2, axes_dims=(8, 4, 4),
            visual_cond=False)
# the JAX W8A8 linears a visual block runs, in the port's call order
BLOCK_OPS = [("self_attention", p) for p in ("to_query", "to_key",
                                             "to_value", "out_layer")] \
    + [("cross_attention", p) for p in ("to_query", "to_key", "to_value",
                                        "out_layer")] \
    + [("feed_forward", "in_layer"), ("feed_forward", "out_layer")]
# K5 against JAX's Pallas kernel in bf16 (tests/test_torch_int8.py); a mesh
# against one device (tests/test_tp_parity.py)
K5_TOL, MESH_TOL = 2e-2, 5e-3


def _linear_case():
    rng = np.random.default_rng(12)
    return dict(w=(rng.standard_normal((96, 256)) * 0.05).astype(np.float32),
                b=(rng.standard_normal(96) * 0.1).astype(np.float32),
                x=rng.standard_normal((2, 33, 256)).astype(np.float32),
                wc=(rng.standard_normal((128, 256)) * 0.05).astype(np.float32),
                bc=(rng.standard_normal(128) * 0.1).astype(np.float32))


def _forward_case():
    """Random weights (modulation included) and inputs as JAX's tp 4 W8A8
    test draws them."""
    jcfg, pcfg = both_cfgs(**TINY)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=7)
    rng = np.random.RandomState(0)
    fwd = dict(x=rng.randn(1, 2, 8, 8, 4).astype(np.float32),
               text=rng.randn(1, 8, 32).astype(np.float32),
               pooled=rng.randn(1, 16).astype(np.float32),
               time=np.full((1,), 400.0, np.float32),
               mask=np.ones((1, 8), bool))
    return jcfg, jparams, model, fwd


def _jax_mesh_forward(jcfg, jparams, fwd):
    """JAX's tp 4 W8A8 forward under ``make_mesh(4)``, recording each W8A8
    linear's (w_scale, x, y) (unordered callbacks: an ordered effect is
    refused on a mesh), then put in the port's call order by matching each
    w_scale to its layer. Returns the output and the (x, y) records."""
    q = jax_quantize_dit(jparams)
    rec = []
    real = jax_nn._linear_i8

    def linear_i8(p, x):
        y = real(p, x)
        jax.debug.callback(lambda *a: rec.append([np.asarray(v) for v in a]),
                           p["w_scale"], x, y)
        return y

    mesh = make_mesh(4)
    args = [jnp.asarray(fwd[k]) for k in ("x", "text", "pooled", "time",
                                          "mask")]
    with mock.patch.object(jax_nn, "_linear_i8", linear_i8), \
            sharding_ctx(mesh):
        out = jax.jit(lambda p, *a: jax_dit_forward(
            p, jcfg, *a[:4], text_mask=a[4], scale_factor=(1.0, 2.0, 2.0),
            attn_impl="dense"))(shard_dit_params(q, mesh), *args)
        out = np.asarray(out)
    jax.effects_barrier()
    vb = q["visual_transformer_blocks"]
    ordered = []
    for i in range(jcfg.num_visual_blocks):
        for part, proj in BLOCK_OPS:
            ws = np.asarray(vb[part][proj]["w_scale"][i])
            hits = [r for r in rec if np.array_equal(r[0], ws)]
            assert len(hits) == 1, (i, part, proj, len(hits))
            ordered.append((hits[0][1], hits[0][2]))
    assert len(rec) == len(ordered)
    return out, ordered


def _attention_case():
    rng = np.random.RandomState(3)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    return dict(q=bf16(rng.randn(1, 256, 4, 64) * 0.5),
                k=bf16(rng.randn(1, 256, 4, 64) * 0.5),
                v=bf16(rng.randn(1, 256, 4, 64)),
                kc=bf16(rng.randn(1, 64, 4, 64) * 0.5),
                vc=bf16(rng.randn(1, 64, 4, 64)),
                mask=rng.rand(1, 64) > 0.3)


def _jax_attention(case):
    mesh = make_mesh(n_devices=4, sp=2)
    q, k, v, kc, vc = (jnp.asarray(case[n], jnp.bfloat16)
                       for n in ("q", "k", "v", "kc", "vc"))
    with sharding_ctx(mesh):
        out = {"self": jax_attention(q, k, v, impl="flash_int8"),
               "cross": jax_attention(q, kc, vc,
                                      kv_mask=jnp.asarray(case["mask"]),
                                      impl="flash_int8")}
    return {name: np.asarray(a, np.float32) for name, a in out.items()}


def _one_device_latents(impl, quantized=True):
    """The tiny pipeline's latents on one device (``impl``, W8A8 or not)."""
    sizes = _torch_tp_ranks.RESOLUTIONS[512]
    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]
    try:
        pipe = _torch_tp_ranks.pipeline(dit_kw=ranks_mod.PIPE_WIDE,
                                        attn_impl=impl, int8_linear=quantized)
        kept = []
        pipe.decode_latents = lambda z, mode=None: kept.append(z)
        pipe("a test image", time_length=0, width=64, height=64, seed=3,
             expand_prompts=False)
        return kept[0].numpy()
    finally:
        _torch_tp_ranks.RESOLUTIONS[512] = sizes


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def int8_ranks():
    """The launch of the (1, 2, 2) mesh and the JAX and one-device sides,
    computed while it runs."""
    jcfg, jparams, model, fwd = _forward_case()
    want_jax, records = _jax_mesh_forward(jcfg, jparams, fwd)
    cases = dict(linear=_linear_case(), tiny_i8=TINY,
                 attention=_attention_case(),
                 forward=(TINY, dit_state_dict_from_jax(
                     jax.tree.map(np.asarray, jparams)), fwd, records))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run, 4, "gloo", "cpu",
                             args=(cases,), timeout=600, sp=2)
        want = dict(forward_jax=want_jax,
                    attention_jax=_jax_attention(cases["attention"]),
                    plain_jax=np.asarray(jax_dit_forward(
                        jparams, jcfg, *(jnp.asarray(fwd[k]) for k in (
                            "x", "text", "pooled", "time", "mask")),
                        scale_factor=(1.0, 2.0, 2.0), attn_impl="dense")))
        args = [torch.from_numpy(np.asarray(fwd[k])) for k in (
            "x", "text", "pooled", "time", "mask")]
        want["forward_one"] = dit_forward(
            quantize_dit_params(model), *args, scale_factor=(1.0, 2.0, 2.0),
            attn_impl="dense").numpy()
        for impl in ("flash_int8", "flash_int8_pipe"):
            want[f"latents_{impl}"] = _one_device_latents(impl)
        want["latents_plain"] = _one_device_latents("auto", quantized=False)
        got = future.result()
    return got, want, cases


def test_quantized_specs_match_jax():
    """Every parameter of the port's quantized DiT has the split dim JAX's
    ``_adapt_quantized_specs`` gives its counterpart (``weight_i8`` as the
    weight; ``w_scale`` with a column-parallel layer's rows, whole for a row
    parallel one; text blocks whole), mapped from JAX's (in, out) layout and
    stacked blocks by name."""
    jcfg, pcfg = both_cfgs(**TINY)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=1)
    q = jax_quantize_dit(jparams)
    specs = _adapt_quantized_specs(q, jax_dit_param_specs(make_mesh(4)))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)
    )[0]:
        keys = [p.key for p in path]
        stacked = keys[0].endswith("_blocks")
        axes = tuple(spec)[1:] if stacked else tuple(spec)
        dim = None
        if "tp" in axes:
            axis = axes.index("tp")
            # a 2-D (in, out) weight: out is the port's dim 0, in its dim 1
            dim = (1 - axis) if len(axes) == 2 else 0
        n = jcfg.num_visual_blocks if keys[0].startswith("visual") \
            else jcfg.num_text_blocks
        for i in range(n) if stacked else [None]:
            name = ".".join(keys if i is None else [keys[0], str(i)] + keys[1:])
            want[name] = dim
    sd = quantize_dit_params(model).state_dict()
    assert sorted(sd) == sorted(want)
    got = {name: split_dim(name) for name in sd}
    assert got == want
    assert got["visual_transformer_blocks.1.self_attention.out_layer.w_scale"] \
        is None
    assert got["visual_transformer_blocks.0.feed_forward.in_layer.w_scale"] == 0
    assert got["visual_transformer_blocks.0.feed_forward.out_layer.weight_i8"] \
        == 1


def _one_device_linears(case):
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        w, b, x, wc, bc = (torch.from_numpy(case[k]).to(dtype)
                           for k in ("w", "b", "x", "wc", "bc"))
        with torch.no_grad():
            out[f"{name}_row"] = port_nn.linear(port_nn.quantize_linear(
                ranks_mod._linear(w, b, dtype)), x).float().numpy()
            out[f"{name}_col"] = port_nn.linear(port_nn.quantize_linear(
                ranks_mod._linear(wc, bc, dtype)), x).float().numpy()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [2, 4])
def test_w8a8_linears_bit_equal_one_device(int8_ranks, tp, dtype):
    """Row parallel: every rank's output equals one device's ``_linear_i8``
    bit for bit (the max and the int32 sum are exact). Column parallel: the
    ranks' columns, side by side, equal it."""
    got, _, cases = int8_ranks
    want = _one_device_linears(cases["linear"])
    ranks = sorted((r[f"rows_tp{tp}"], r[f"linears_tp{tp}"])
                   for r in got[:tp])
    assert [t for t, _ in ranks] == list(range(tp))
    for _, r in ranks:
        np.testing.assert_array_equal(r[f"{dtype}_row_None"],
                                      want[f"{dtype}_row"])
    cols = np.concatenate([r[f"{dtype}_col"] for _, r in ranks], axis=-1)
    np.testing.assert_array_equal(cols, want[f"{dtype}_col"])


@pytest.mark.parametrize("fault", ranks_mod.FAULTS)
def test_w8a8_faults_break_equality(int8_ranks, fault):
    """Each fault breaks the row-parallel output's equality with one
    device's, in both dtypes and at both widths, by at least 1e-3 of its
    scale (a rank's own activation scale is a finer quantization, so it
    moves the output by its int8 resolution: 0.6 % here)."""
    got, _, cases = int8_ranks
    want = _one_device_linears(cases["linear"])
    for tp in (2, 4):
        for dtype in ("float32", "bfloat16"):
            y = got[0][f"linears_tp{tp}"][f"{dtype}_row_{fault}"]
            ref = want[f"{dtype}_row"]
            assert np.abs(y - ref).max() >= 1e-3 * np.abs(ref).max(), \
                (tp, dtype)


@pytest.mark.parametrize("mesh", ["122", "114"])
def test_rank_local_quantization_bit_equal(int8_ranks, mesh):
    """``fast_init_dit_shard(int8_linear=True)`` (the rank's slices
    quantized, row-parallel scales from the max over tp) holds exactly the
    slices of the whole model's ``quantize_dit_params``."""
    got, _, _ = int8_ranks
    for r in got:
        res = r[f"local_{mesh}"]
        assert res["differ"] == [] and res["extra"] == []
        assert res["compared"] > 40


def test_tp4_w8a8_forward_matches_jax_mesh(int8_ranks):
    """tp 4 (1, 1, 4): each W8A8 linear on the JAX mesh run's own input
    gives its output to 1e-6 of the output's scale (the same codes, exact
    int32 products; row parallel over the ranks' columns); the port's own
    input to it agrees with JAX's to 1e-4 (the wiring between the ops); the
    forced forward lies within 1e-4 of JAX's output scale, the unquantized
    JAX forward outside it (control). Unforced, the ranks' output equals
    the port's one-device W8A8 forward bit for bit: rounding flips against
    JAX (tests/test_torch_int8.py) are one device's, not the mesh's."""
    got, want, _ = int8_ranks
    ref = want["forward_jax"]
    bound = 1e-4 * np.abs(ref).max()
    for r in got:
        g = r["gaps"]
        assert g["ops"] == 20 and g["left"] == 0
        assert g["x"] <= 1e-4 and g["y"] <= 1e-6, g
        assert np.abs(r["forced"] - ref).max() <= bound
        np.testing.assert_array_equal(r["forward"], want["forward_one"])
    assert np.abs(got[0]["forced"] - want["plain_jax"]).max() > bound


@pytest.mark.parametrize("kind", ["self", "cross"])
def test_k5_on_the_mesh_matches_jax(int8_ranks, kind):
    """K5's plain version on each (1, 2, 2) rank's rows and heads (K and V
    gathered over sp for self-attention; the masked cross-attention's keys
    whole) against JAX's shard_map'd Pallas kernel in interpret mode under
    ``make_mesh(4, sp=2)`` (2e-2: bf16), and against the port's one device
    (5e-3: the per-shard Q scale and shift differ from one device's at int8
    resolution, JAX's own mesh bound). The port's one-device call, which
    the text blocks make whole on every rank, holds against JAX's per-shard
    call at that 5e-3 too (the routing choice ROADMAP.md section 3 logs)."""
    got, want, cases = int8_ranks
    c = cases["attention"]
    shape = c["q"].shape
    out = np.full(shape, np.nan, np.float32)
    for r in got:
        p = r["attention"][kind]
        (r0, r1), (t, n) = p["rows"], p["heads"]
        h = shape[2] // n
        out[:, r0:r1, t * h:(t + 1) * h] = p["out"]
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, want["attention_jax"][kind],
                               rtol=K5_TOL, atol=K5_TOL)
    k, v, m = ("k", "v", None) if kind == "self" else ("kc", "vc", "mask")
    one = flash_int8(*(torch.from_numpy(c[n]).bfloat16()
                       for n in ("q", k, v)),
                     None if m is None else torch.from_numpy(c[m]))
    np.testing.assert_allclose(out, to_np(one), atol=MESH_TOL)
    np.testing.assert_allclose(to_np(one), want["attention_jax"][kind],
                               atol=MESH_TOL)


@pytest.mark.parametrize("mesh,impl", [("122", "flash_int8"),
                                       ("114", "flash_int8_pipe")])
def test_int8_pipeline_matches_one_device(int8_ranks, mesh, impl):
    """The pipeline with W8A8 and int8-QK attention (K5 on (1, 2, 2), K7 on
    (1, 1, 4)) denoises 2 steps on every rank to the same latents, within
    one device's own int8 error (its latents against the unquantized
    pipeline's) of one device's int8 latents."""
    got, want, _ = int8_ranks
    ref = want[f"latents_{impl}"]
    bound = _rel(ref, want["latents_plain"])
    assert bound > 0
    for r in got:
        p = r[f"pipe_{mesh}"]
        assert p["quantized"] and np.isfinite(p["latents"]).all()
        np.testing.assert_array_equal(p["latents"], got[0][f"pipe_{mesh}"]
                                      ["latents"])
        assert _rel(p["latents"], ref) <= bound
    assert got[0][f"pipe_{mesh}"]["shape"] == ((1, 2, 2) if mesh == "122"
                                               else (1, 1, 4))


def test_cli_tp_int8_launches(monkeypatch):
    """``--tp 8 --int8_linear --attn flash_int8`` launches the (1, 2, 4)
    plan with both options; the launch is recorded, not run."""
    from kandinsky5_tpu_torch import cli, parallel

    calls = []

    def fake_launch(fn, world, backend, device, args=(), dp=1, sp=1, **kw):
        calls.append(dict(world=world, dp=dp, sp=sp, int8=args[0].int8_linear,
                          attn=args[0].attn))
        return ["written.mp4"] + [None] * (world - 1)

    monkeypatch.setattr(parallel, "launch", fake_launch)
    assert cli.main(["--tp", "8", "--device", "cpu", "--int8_linear",
                     "--attn", "flash_int8"]) == "written.mp4"
    assert calls == [dict(world=8, dp=1, sp=2, int8=True, attn="flash_int8")]
