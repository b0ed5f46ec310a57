"""The port's int8 DiT against the JAX package on the CPU: the int8-QK
pre-pass (``pack_int8``), K5/K7's plain version against the Pallas kernels
run in interpret mode, the ``flash_int8`` routing, W8A8 linears and their
DiT quantization, a tiny int8 DiT forward, and the plain versions of the
tools kernels T1 and T5.

Inputs are seeded numpy arrays handed to both packages. Tolerances, with
their reasons, sit in each test."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models.dit import dit_forward as jax_dit_forward
from kandinsky5_tpu.models.dit import quantize_dit_params as jax_quantize_dit
from kandinsky5_tpu.models.nn import linear as jax_linear
from kandinsky5_tpu.models.nn import quantize_linear as jax_quantize_linear
from kandinsky5_tpu.ops.attention import attention as jax_attention
from kandinsky5_tpu.ops.flash_pallas import _pack_int8
from kandinsky5_tpu.ops.flash_pallas import flash_attention as jax_flash
from kandinsky5_tpu_torch.checkpoint import (
    dit_from_state_dict,
    dit_state_dict_from_jax,
)
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    dit_forward,
    is_quantized,
    quantize_dit_params,
)
from kandinsky5_tpu_torch.models.nn import Int8Linear, linear, quantize_linear
from kandinsky5_tpu_torch.ops import attention as tatt
from kandinsky5_tpu_torch.ops.flash import (
    flash_attention,
    flash_int8,
    flash_int8_plain,
    int8_padded_len,
    pack_int8,
    tma_coeff,
)
from kandinsky5_tpu_torch.tools.bench_i8_decomp import MODES, i8_decomp_plain
from kandinsky5_tpu_torch.tools.bench_int8mm import gemm_plain

from ._torch_parity import both_cfgs, rand, random_dit_pair, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _normed(rng, *shape):
    x = rand(rng, *shape)
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))


def _jax_pack(q, k):
    """The JAX package's pre-pass as ``flash_attention`` calls it: heads
    first, K zero-padded to its default int8 kv block."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    qf = jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b * h, lq, d)
    kf = jnp.asarray(k).transpose(0, 2, 1, 3).reshape(b * h, lk, d)
    kf = jnp.pad(kf, ((0, 0), (0, int8_padded_len(lk) - lk), (0, 0)))
    q8, k8t, _, aux, _ = _pack_int8(qf, kf, kf, d)
    return (np.array(q8[..., :d]),
            np.ascontiguousarray(np.array(k8t[:, :d, :lk]).transpose(0, 2, 1)),
            np.array(aux[:, 0, :lk]), np.array(aux[:1, 1, 0]))


def test_int8_padded_len_follows_the_jax_blocks():
    """<= 640 keys pad to 128, longer ones to 512 (flash_pallas BLOCK_K 768
    clamped, then BLOCK_K_I8 512)."""
    assert [int8_padded_len(n) for n in (1, 128, 200, 256, 640, 641, 700,
                                         768, 1025, 47616)] == \
        [128, 128, 256, 256, 640, 1024, 1024, 1024, 1536, 47616]


@pytest.mark.parametrize("lk", [200, 700])
def test_pack_int8_matches_jax(lk):
    """Both padding rules. q8 and k8 equal the JAX pre-pass's, up to a
    rounding tie that K's fp32 mean, summed in another order, may flip (at
    most 1 apart in at most 0.1 % of entries); coeff and shift to 1e-6
    relative. The pre-pass takes no mask: masked keys count like any other
    in K's mean, scales and shift, as in the JAX package (the masked
    flash_int8 cases below hold that end to end)."""
    rng = np.random.default_rng(lk)
    q, k = _normed(rng, 2, 300, 2, 64), _normed(rng, 2, lk, 2, 64) + 0.3
    jq8, jk8, jc, js = _jax_pack(q, k)
    q8, k8, coeff, shift = pack_int8(torch.from_numpy(q), torch.from_numpy(k))
    assert q8.dtype == k8.dtype == torch.int8
    assert q8.shape == (4, 300, 64) and k8.shape == (4, lk, 64)
    for got, want in ((q8, jq8), (k8, jk8)):
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3
    np.testing.assert_allclose(coeff.numpy(), jc, rtol=1e-6)
    np.testing.assert_allclose(shift.numpy(), js, rtol=1e-6)


CASES = [(2, 200, 2), (1, 700, 2)]


@pytest.mark.parametrize("b,l,h", CASES, ids=["l200", "l700"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_int8_matches_pallas_interpret(b, l, h, masked, dtype):
    """K5/K7's plain version against ``flash_attention(qk_int8=True)`` run
    in interpret mode, with pipe=False (K5) and pipe=True (K7). fp32: the
    same quantized scores and weights, summed in another order: 2e-4. bf16:
    both round p and the output to bf16, and the bf16 inputs feed the same
    fp32 pre-pass: 2e-2."""
    rng = np.random.default_rng(b * l)
    q, k = _normed(rng, b, l, h, 64), _normed(rng, b, l, h, 64)
    v = rand(rng, b, l, h, 64)
    mask = (np.arange(l)[None] < np.array([[l - 17], [l // 3]])[:b]
            if masked else None)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    tol = 2e-4 if dtype == "float32" else 2e-2
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    got = flash_int8(tq, tk, tv, tm)
    assert got.dtype == tdt and got.shape == (b, l, h, 64)
    for pipe in (False, True):
        want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                         kv_mask=None if mask is None else jnp.asarray(mask),
                         qk_int8=True, pipe=pipe, interpret=True)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    assert torch.equal(flash_int8(tq, tk, tv, tm, pipe=True), got)


def test_flash_int8_plain_masks_keys():
    """Masked keys take no weight: the plain version with a mask equals the
    plain version run on the valid keys alone (same packed values)."""
    rng = np.random.default_rng(9)
    q, k = _normed(rng, 1, 96, 2, 64), _normed(rng, 1, 96, 2, 64)
    v = torch.from_numpy(rand(rng, 1, 96, 2, 64))
    q8, k8, coeff, shift = pack_int8(torch.from_numpy(q), torch.from_numpy(k))
    mask = torch.arange(96)[None] < 40
    full = flash_int8_plain(q8, k8, v, coeff, shift, mask)
    cut = flash_int8_plain(q8, k8[:, :40], v[:, :40], coeff[:, :40], shift)
    torch.testing.assert_close(full, cut, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lk", [300, 301, 302, 303, 77])
def test_tma_coeff_pads_to_four_keys(lk):
    """K5/K7/T5 read the coefficients at a row length that is a multiple of
    4 keys (their tensor map's 16-byte row stride): zeros are appended past
    Lk, the real coefficients are kept, and an aligned row length passes
    the tensor through untouched."""
    coeff = torch.from_numpy(
        np.random.default_rng(lk).random((3, lk), dtype=np.float32))
    padded = tma_coeff(coeff)
    assert padded.shape == (3, -(-lk // 4) * 4) and padded.is_contiguous()
    assert torch.equal(padded[:, :lk], coeff) and not padded[:, lk:].any()
    assert (padded is coeff) == (lk % 4 == 0)


def test_flash_attention_int8_takes_64_wide_heads_only():
    q = torch.zeros(1, 8, 1, 32)
    with pytest.raises(ValueError, match="64-wide"):
        flash_attention(q, q, q, qk_int8=True)
    q = torch.zeros(1, 8, 1, 64)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="64-wide"):
        flash_attention(q, q, q, q_ids=ids, kv_ids=ids, qk_int8=True)


@pytest.mark.parametrize("impl", ["flash_int8", "flash_int8_pipe"])
def test_int8_attention_routing_matches_jax(impl, monkeypatch):
    """Text self-attention (256 keys, masked) takes the int8 kernel; a
    short-KV cross-attention (1,024 queries on 256 keys) runs dense, as the
    JAX dispatch does for every impl but dense. fp32 against JAX's
    ``attention(impl="flash_int8")`` (the pipelined kernel equals K5 there):
    2e-4."""
    rng = np.random.default_rng(11)
    t = _normed(rng, 1, 256, 2, 64)
    tv = rand(rng, 1, 256, 2, 64)
    vis = _normed(rng, 1, 1024, 2, 64)
    mask = np.arange(256)[None] < 100
    cases = [((t, t, tv), mask), ((vis, t, tv), mask)]
    calls = []
    real = tatt.flash_attention

    def spy(*args, **kw):
        calls.append((args[0].shape[1], kw.get("qk_int8"), kw.get("pipe")))
        return real(*args, **kw)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    for (q, k, v), m in cases:
        want = jax_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             kv_mask=jnp.asarray(m), impl="flash_int8")
        got = tatt.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             kv_mask=torch.from_numpy(m), impl=impl)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4,
                                   atol=2e-4)
    assert calls == [(256, True, impl == "flash_int8_pipe")]


def test_quantize_linear_and_linear_i8_match_jax():
    """Weight int8 values and scales equal the JAX ``quantize_linear``'s
    exactly; the W8A8 output equals ``_linear_i8``'s to 1e-6 (the same
    roundings in the same order; the int32 product is exact on both
    sides)."""
    rng = np.random.default_rng(12)
    w = rand(rng, 96, 160, scale=0.05)  # (out, in)
    bias = rand(rng, 96, scale=0.1)
    x = rand(rng, 2, 33, 160)
    layer = nn.Linear(160, 96)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        layer.bias.copy_(torch.from_numpy(bias))
    q = quantize_linear(layer)
    jq = jax_quantize_linear({"weight": jnp.asarray(w.T), "bias": jnp.asarray(bias)})
    assert isinstance(q, Int8Linear) and q.bias is layer.bias
    np.testing.assert_array_equal(q.weight_i8.numpy(), np.asarray(jq["weight_i8"]).T)
    np.testing.assert_array_equal(q.w_scale.numpy(), np.asarray(jq["w_scale"]))
    got = to_np(linear(q, torch.from_numpy(x)))
    want = to_np(jax_linear(jq, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # W8A8 stays within ~1 % of the float product, as the JAX bound says
    ref = x @ w.T + bias
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.02


TINY_I8 = dict(in_visual_dim=4, out_visual_dim=4, time_dim=32,
               patch_size=(1, 2, 2), model_dim=128, ff_dim=256,
               num_visual_blocks=2, num_text_blocks=1, axes_dims=(16, 24, 24),
               visual_cond=False, in_text_dim=48, in_text_dim2=24)


def test_quantized_weights_match_jax_quantize_dit_params():
    """quantize_dit_params on the port's DiT gives the JAX quantized tree,
    value for value, and that tree (through dit_state_dict_from_jax) loads
    into the port as a W8A8 model; the source model stays unquantized."""
    jcfg, pcfg = both_cfgs(**TINY_I8)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=3)
    jsd = dit_state_dict_from_jax(jax.tree.map(np.asarray, jax_quantize_dit(jparams)))
    qmodel = quantize_dit_params(model)
    sd = qmodel.state_dict()
    assert sorted(sd) == sorted(jsd)
    assert any(k.endswith("weight_i8") for k in jsd)
    for key, want in jsd.items():
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    assert is_quantized(qmodel) and not is_quantized(model)
    assert "visual_transformer_blocks.0.feed_forward.in_layer.weight" \
        in model.state_dict()
    loaded = dit_from_state_dict(DiffusionTransformer3D(pcfg, device="cpu",
                                                        dtype=torch.float32), jsd)
    for key, t in loaded.state_dict().items():
        assert t.dtype == sd[key].dtype
        np.testing.assert_array_equal(t.numpy(), sd[key].numpy(), err_msg=key)


def _record_jax_int8_ops(monkeypatch, rec):
    """Make the JAX DiT append (kind, inputs..., output) to ``rec`` as numpy
    arrays, in call order, at every W8A8 linear and every attention call
    (ordered debug callbacks, so the records survive the scan over the
    visual blocks)."""
    import kandinsky5_tpu.models.dit as jdit
    import kandinsky5_tpu.models.nn as jnn

    real_linear, real_attention = jnn._linear_i8, jdit.attention

    def note(kind):
        return lambda *a: rec.append((kind,) + tuple(np.asarray(v) for v in a))

    def linear_i8(p, x):
        y = real_linear(p, x)
        jax.debug.callback(note("linear"), x, y, ordered=True)
        return y

    def attention(q, k, v, kv_mask=None, impl="auto", **kw):
        out = real_attention(q, k, v, kv_mask=kv_mask, impl=impl, **kw)
        jax.debug.callback(note("attention"), q, k, v, out, ordered=True)
        return out

    monkeypatch.setattr(jnn, "_linear_i8", linear_i8)
    monkeypatch.setattr(jdit, "attention", attention)


def test_int8_dit_forward_matches_jax(monkeypatch):
    """A tiny DiT (tests/test_int8_linear.py's config, widened to 64-wide
    heads because the int8-QK path exists only for them) with flash_int8
    attention and W8A8 projections, against the JAX forward, fp32, with
    teacher forcing at every quantized op.

    Why forcing: the two sides round the same quantities, but the fp32
    values feeding a rounding come out of different summation orders, so a
    value within a few ulps of a .5 boundary rounds one way on one side and
    the other way on the other (a flip), and flips compound through the
    blocks. Measured on this test's DiT: a 1e-6 relative perturbation of x
    moves the port's own output by up to 3.9e-2 (median 1.6e-2, 18 of 20
    draws above 1e-4), against an output scale of 2.6 and 5.0e-2 to the
    unquantized forward; un-forced, DiT seeds 0-5 put the port 1.2e-6 to
    4.1e-2 from JAX. Hooked block by block (seeds 0 and 4), the first
    differing code was one entry off by one step whose pre-rounding value
    lay 1-3 ulps from .5; no code differed by more than one step or where
    the pre-rounding values agreed: flips, not a port fault.

    So each W8A8 linear and each attention call of the port's forward takes
    the JAX forward's own input to that op. Checked there: the port's
    un-forced input agrees with JAX's (1e-4 of its scale: the wiring
    between the ops); a W8A8 output equals JAX's to 1e-6 (same codes, exact
    int32 product); an int8-QK call's q8 equals JAX's pre-pass and its k8
    differs in at most 0.1 % of entries, each by exactly one step (K's mean
    is summed in another order), and on JAX's own codes the port's kernel
    math gives JAX's output to 2e-4, as does the whole call where the codes
    agree; a dense call matches to 2e-4. The forced forward's output then
    lies within 1e-4 of JAX's scale; control: the unquantized JAX forward
    lies outside that bound."""
    jcfg, pcfg = both_cfgs(**TINY_I8)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=4)
    rng = np.random.default_rng(5)
    x = rand(rng, 1, 3, 8, 8, 4)
    text = rand(rng, 1, 16, 48)
    pooled = rand(rng, 1, 24)
    t = np.array([400.0], np.float32)
    mask = np.arange(16)[None] < 11
    jargs = [jnp.asarray(a) for a in (x, text, pooled, t, mask)]
    rec = []
    with monkeypatch.context() as m:
        _record_jax_int8_ops(m, rec)
        want = to_np(jax_dit_forward(jax_quantize_dit(jparams), jcfg, *jargs,
                                     attn_impl="flash_int8"))
        jax.effects_barrier()

    import kandinsky5_tpu_torch.models.dit as pdit
    import kandinsky5_tpu_torch.models.nn as pnn

    real_linear, real_attention = pnn._linear_i8, pdit.attention
    ops = iter(rec)
    n_int8 = []

    def forced(kind, got_inputs):
        rec_op = next(ops)
        assert rec_op[0] == kind
        for g, j in zip(got_inputs, rec_op[1:]):
            assert g.shape == j.shape
            assert np.abs(to_np(g) - j).max() <= 1e-4 * np.abs(j).max()
        return [torch.from_numpy(np.array(a)) for a in rec_op[1:-1]], rec_op[-1]

    def linear_i8(layer, x):
        (xj,), yj = forced("linear", [x])
        y = real_linear(layer, xj)
        np.testing.assert_allclose(to_np(y), yj, rtol=1e-6,
                                   atol=1e-6 * np.abs(yj).max())
        return y

    def attention(q, k, v, kv_mask=None, impl="auto"):
        (qj, kj, vj), oj = forced("attention", [q, k, v])
        out = real_attention(qj, kj, vj, kv_mask=kv_mask, impl=impl)
        same_codes = True
        if not tatt.short_kv(q.shape[1], k.shape[1]):  # int8-QK calls
            n_int8.append(1)
            q8, k8, coeff, shift = pack_int8(qj, kj)
            jq8, jk8, jc, js = _jax_pack(qj.numpy(), kj.numpy())
            np.testing.assert_array_equal(q8.numpy(), jq8)
            diff = np.abs(k8.numpy().astype(np.int32) - jk8.astype(np.int32))
            assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3
            same_codes = diff.max() == 0
            on_jax_codes = flash_int8_plain(
                *(torch.from_numpy(a) for a in (jq8, jk8)), vj,
                torch.from_numpy(jc), torch.from_numpy(js), kv_mask)
            np.testing.assert_allclose(to_np(on_jax_codes), oj, rtol=2e-4,
                                       atol=2e-4)
        if same_codes:
            np.testing.assert_allclose(to_np(out), oj, rtol=2e-4, atol=2e-4)
        return out

    monkeypatch.setattr(pnn, "_linear_i8", linear_i8)
    monkeypatch.setattr(pdit, "attention", attention)
    got = to_np(dit_forward(quantize_dit_params(model),
                            *(torch.from_numpy(a) for a in (x, text, pooled, t,
                                                            mask)),
                            attn_impl="flash_int8"))
    assert next(ops, None) is None
    # every self- and cross-attention (48 visual queries are not 4x the 16
    # text keys, so cross-attention is not short-KV here)
    assert len(n_int8) == 5
    bound = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    plain = to_np(jax_dit_forward(jparams, jcfg, *jargs))
    assert np.abs(got - plain).max() > bound


def _jax_tool(name):
    """A module of the JAX package's ``tools/`` directory (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_t1_plain_matches_jax_mm_xla():
    """T1's plain version against the JAX tool's ``mm_xla`` (B transposed:
    the port takes B as (N, K)): int8 exactly, bf16 to fp32 summation
    order (1e-5); at 128 x 256 and at the kernel's shape rules' edges (M =
    1,000, not a multiple of its 128-row tile; N = 1792 and N = 136, not a
    multiple of its 256-column tile; K = 320 int8 and 96 bf16, not a
    multiple of its 128-byte k step)."""
    mm_xla = _jax_tool("bench_int8mm").mm_xla
    rng = np.random.default_rng(13)
    for m, n in ((128, 256), (1000, 1792), (1000, 136)):
        a8 = rng.integers(-127, 128, (m, 320)).astype(np.int8)
        b8 = rng.integers(-127, 128, (n, 320)).astype(np.int8)
        got = gemm_plain(torch.from_numpy(a8), torch.from_numpy(b8))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(mm_xla(jnp.asarray(a8), jnp.asarray(b8.T))))
        a, b = rand(rng, m, 96), rand(rng, n, 96)
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b.T, jnp.bfloat16)
        got = gemm_plain(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(b).bfloat16())
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(mm_xla(ja, jb)),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_t5_plain_matches_numpy_formula(mode):
    """T5's plain version of each mode, on the JAX pre-pass's own q8, k8,
    coefficients and shift, against the mode's formula in numpy (int64
    scores, fp64 sums), fp32 V so nothing rounds to bf16: 1e-5 of the
    output's scale. The ragged length (150 keys, three 64-key tiles, the
    last part-filled) checks qk_only's tile sum."""
    rng = np.random.default_rng(14)
    q, k = _normed(rng, 1, 96, 2, 64), _normed(rng, 1, 150, 2, 64)
    v = rand(rng, 1, 150, 2, 64)
    q8, k8, coeff, shift = _jax_pack(q, k)
    got = to_np(i8_decomp_plain(*(torch.from_numpy(a) for a in (q8, k8)),
                                torch.from_numpy(v), torch.from_numpy(coeff),
                                torch.from_numpy(shift), mode))
    s32 = np.einsum("bqd,bkd->bqk", q8.astype(np.int64), k8.astype(np.int64))
    vh = v[0].transpose(1, 0, 2).astype(np.float64)  # (H, Lk, 64)
    if mode == "qk_only":
        pad = np.pad(s32, ((0, 0), (0, 0), (0, 192 - 150)))
        want = pad.reshape(2, 96, 3, 64).sum(2).astype(np.float64)
    else:
        s = s32.astype(np.float64)
        if mode != "raw_pv":
            s = (s32.astype(np.float32) * coeff[:, None, :] - shift[0]).astype(np.float64)
            if mode == "full":
                s = np.exp2(s)
        want = np.einsum("hqk,hkd->hqd", s, vh)
    want = want.transpose(1, 0, 2)[None]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
