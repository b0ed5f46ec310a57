"""The port's sequence axis (sp) against the JAX package's sp mesh on the
CPU: the rank layout against ``make_mesh(n, dp, sp)``, the sequence-sharded
visual stack's dense denoise (with a MagCache skip schedule) at (dp, sp) =
(1, 2) and (2, 2) against JAX's denoise under ``make_mesh(8, dp, sp=2)``,
K1's plain version on a rank's query shard against the gathered keys
against JAX's ``_sharded_attention(..., "flash", mesh)`` in interpret mode,
sharded NABLA against JAX's ``_sparse_attention_sharded(...,
interpret=True)`` with a faithful mask at sp = 2 and at sp = 3 over 8 rows
(JAX's padding path; the port runs such a call whole on every sp rank), a
NABLA denoise on (1, 2, 2) and on tp alone, the (1, 3, 1) and (2, 3, 1)
meshes' forward and denoise, and the pipeline on (1, 2, 2) against one
device.

Two launches of gloo CPU ranks (``tests/_torch_sp_ranks.py``, no JAX): a
(1, 2, 2) mesh and a (2, 2, 2) mesh, from whose ranks the smaller meshes
are cut (``parallel.ranks.rank_mesh``); JAX computes its side while the
ranks run. Tolerances are the JAX package's own: rtol 2e-4 / atol 2e-5 for
the fp32 denoises and forwards (tests/test_tp_parity.py), 2e-2 for K1 in
bf16 (tests/test_torch_attention.py) and for sharded NABLA
(tests/test_nabla_semantics.py). Three controls must fail their bound:
ranks that skip the K/V all-gather, every rank taking RoPE rows from 0,
and on NABLA every rank taking STA rows from 0."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models.dit import dit_forward as jax_dit_forward
from kandinsky5_tpu.ops.attention import _sharded_attention
from kandinsky5_tpu.ops.nabla import (
    _sparse_attention_sharded,
    nabla_build_mask as jax_nabla_build_mask,
    sta_mask,
)
from kandinsky5_tpu.parallel.sharding import make_mesh, sharding_ctx
from kandinsky5_tpu.sampling import DenoiseSpec as JaxDenoiseSpec
from kandinsky5_tpu.sampling import denoise as jax_denoise
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.parallel.ranks import rank_grid

from . import _torch_sp_ranks as ranks_mod
from . import _torch_tp_ranks
from .test_torch_dp import NAMES, SKIP, SPEC, _jax_denoise, _nabla_case
from .test_tp_parity import _setup

RTOL, ATOL = 2e-4, 2e-5
K1_TOL = 2e-2
NABLA_TOL = 2e-2


def _close(a, b, rtol=RTOL, atol=ATOL):
    return np.allclose(a, b, rtol=rtol, atol=atol)


def _dense_cases():
    """tests/test_tp_parity.py's CFG denoise; the same with the MagCache
    skip schedule of tests/test_torch_dp.py; a 48-token latent (a (3, 4,
    4) grid, which sp = 3 splits) for the forward and denoise."""
    cfg, params, noise, cond, uncond = _setup()
    np_cond = {k: np.asarray(v) for k, v in cond.items()}
    np_uncond = {k: np.asarray(v) for k, v in uncond.items()}
    dense = dict(noise=np.asarray(noise), cond=np_cond, uncond=np_uncond,
                 spec=dict(SPEC, guidance_weight=5.0))
    skip = dict(dense, skip=SKIP, spec=dict(SPEC, num_steps=len(SKIP),
                                           guidance_weight=5.0))
    rng = np.random.default_rng(4)
    noise48 = rng.standard_normal((1, 3, 8, 8, 4)).astype(np.float32)
    fwd = dict(x=noise48, text=np_cond["text_embeds"],
               pooled=np_cond["pooled_embed"],
               time=np.array([500.0], np.float32),
               mask=np.arange(8)[None] < 6)
    dense48 = dict(dense, noise=noise48, fwd=fwd)
    return cfg, params, dict(dense=dense, skip=skip, dense48=dense48)


def _attn_cases():
    """K1's case (L 256, 4 heads, d 64, bf16 values) and NABLA's (8
    64-token blocks, 4 heads, fp32, peaked blocks so that the mask keeps a
    part of each row; a (2, 2, 2) tile grid's STA mask)."""
    rng = np.random.default_rng(5)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    k1 = dict(bf16=True, **{n: bf16(rng.standard_normal((1, 256, 4, 64))
                                     * (0.5 if n != "v" else 1.0))
                             for n in ("q", "k", "v")})
    s1, heads = 8, 4
    centers = rng.standard_normal((4, heads, 64)).astype(np.float32)
    assign = np.arange(s1) % 4
    qb = centers[assign] * 2.0 + rng.standard_normal((s1, heads, 64)) * 0.3
    kb = centers[assign] * 2.0 + rng.standard_normal((s1, heads, 64)) * 0.3
    noise = [rng.standard_normal((s1 * 64, heads, 64)) * 0.05
             for _ in range(2)]
    q = np.repeat(qb, 64, axis=0) + noise[0]
    k = np.repeat(kb, 64, axis=0) + noise[1]
    v = rng.standard_normal((s1 * 64, heads, 64))
    nabla = dict(q=q[None].astype(np.float32), k=k[None].astype(np.float32),
                 v=v[None].astype(np.float32),
                 sta=sta_mask(2, 2, 2, 1, 1, 1), thr=0.5)
    return k1, nabla


def _assemble(parts, shape):
    """A (B, L, H, D) array from the ranks' (rows, heads) blocks."""
    out = np.full(shape, np.nan, np.float32)
    for p in parts:
        (r0, r1), (t, n) = p["rows"], p["heads"]
        h = shape[2] // n
        out[:, r0:r1, t * h:(t + 1) * h] = p["out"]
    return out


def _jax_attn(k1, nabla):
    jq, jk, jv = (jnp.asarray(k1[n], jnp.bfloat16) for n in ("q", "k", "v"))
    want = {"k1": np.asarray(_sharded_attention(
        jq, jk, jv, None, "flash", make_mesh(n_devices=4, sp=2)), np.float32)}
    q, k, v = (jnp.asarray(nabla[n]) for n in ("q", "k", "v"))
    m = jax_nabla_build_mask(q, k, jnp.asarray(nabla["sta"]),
                             thr=nabla["thr"], q_rows=1, method="sort",
                             max_density=None)
    want["kept"] = float(np.asarray(m.gmask).mean())
    for sp in (2, 3):
        want[f"nabla_sp{sp}"] = np.asarray(_sparse_attention_sharded(
            q, k, v, m, make_mesh(n_devices=2 * sp, sp=sp), interpret=True))
    return want


def _jax_single48(cfg, params, case):
    fwd = case["fwd"]
    forward = np.asarray(jax.jit(lambda p, *a: jax_dit_forward(
        p, cfg, *a[:4], text_mask=a[4], scale_factor=(1.0, 2.0, 2.0),
        attn_impl="dense"))(params, *(jnp.asarray(fwd[k]) for k in (
            "x", "text", "pooled", "time", "mask"))))
    spec = JaxDenoiseSpec(dit_params=cfg, **case["spec"])
    c, u = case["cond"], case["uncond"]
    with sharding_ctx(None):
        den = np.asarray(jax_denoise(
            params, spec, jnp.asarray(case["noise"]),
            *(jnp.asarray(c[k]) for k in NAMES),
            *(jnp.asarray(u[k]) for k in NAMES),
            jnp.zeros((spec.num_steps, 2), bool)))
    return forward, den


@pytest.fixture(scope="module")
def sp_ranks():
    """The two launches, (1, 2, 2) then (2, 2, 2), and the JAX side of
    every check, computed while the first runs."""
    cfg, params, cases = _dense_cases()
    tiny = (dataclasses.asdict(cfg),
            dit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    nabla_dit, nabla_case, nabla_single = _nabla_case()
    k1, nabla_op = _attn_cases()
    work = dict(cases, dits={"tiny": tiny, "nabla": nabla_dit},
                nabla=nabla_case, k1=k1, nabla_op=nabla_op)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run_a, 4, "gloo", "cpu",
                             args=(work,), timeout=600, sp=2)
        want = _jax_attn(k1, nabla_op)
        for dp in (1, 2):
            mesh = make_mesh(n_devices=8, dp=dp, sp=2)
            want[f"denoise_{dp}2"] = _jax_denoise(params, cfg,
                                                  cases["dense"], mesh)
        want["denoise_skip"] = _jax_denoise(params, cfg, cases["skip"],
                                            make_mesh(n_devices=8, sp=2))
        want["forward48"], want["denoise48"] = _jax_single48(
            cfg, params, cases["dense48"])
        want["nabla"] = nabla_single
        want["frames"] = _single_frames()
        got_a = future.result()
    got_b = launch(ranks_mod.run_b, 8, "gloo", "cpu", args=(work,),
                   timeout=600, dp=2, sp=2)
    return got_a, got_b, want, work


def _single_frames():
    """The tiny pipeline's image on one device, tiled (the mesh's decode)."""
    sizes = _torch_tp_ranks.RESOLUTIONS[512]
    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]
    try:
        pipe = _torch_tp_ranks.pipeline(decode_mode="tiled")
        return pipe("a test image", time_length=0, width=64, height=64,
                    seed=3, expand_prompts=False)
    finally:
        _torch_tp_ranks.RESOLUTIONS[512] = sizes


@pytest.mark.parametrize("n,dp,sp", [(8, 1, 2), (8, 2, 2), (3, 1, 3),
                                     (6, 2, 3)])
def test_rank_layout_matches_jax_make_mesh(n, dp, sp):
    """Rank r sits where JAX's ``make_mesh(n, dp, sp=sp)`` puts device r:
    dp index r // (sp tp), sp index (r // tp) % sp, tp index r % tp."""
    mesh = make_mesh(n_devices=n, dp=dp, sp=sp)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert ids.shape == (dp, sp, n // (dp * sp)) == tuple(mesh.shape.values())
    np.testing.assert_array_equal(rank_grid(n, dp, sp), ids)


def test_launch_places_ranks_on_the_mesh(sp_ranks):
    """Each rank of the (2, 2, 2) launch holds the groups of its row of
    ``rank_grid``: tp along the last axis, sp the middle, dp the first."""
    _, got_b, _, _ = sp_ranks
    grid = rank_grid(8, 2, 2)
    for r, out in enumerate(got_b):
        d, s, t = (int(i[0]) for i in np.nonzero(grid == r))
        assert out["shape"] == (2, 2, 2) and out["rank"] == r
        assert out["groups"]["tp"] == grid[d, s].tolist()
        assert out["groups"]["sp"] == grid[d, :, t].tolist()
        assert out["groups"]["dp"] == grid[:, s, t].tolist()


@pytest.mark.parametrize("case", ["12", "12_skip", "22"])
def test_sp_dense_denoise_matches_jax(sp_ranks, case):
    """The sequence-sharded stack's CFG denoise on (1, 2, 2) (plain and on
    MagCache's skip schedule) and on (2, 2, 2), every rank equal, against
    JAX's denoise under ``make_mesh(8, dp, sp=2)``. Each block gathers K and
    V once (two gathers), the stack's output once at its exit."""
    got_a, got_b, want, _ = sp_ranks
    key = {"12": "denoise", "12_skip": "denoise_skip", "22": "denoise"}[case]
    ref = want[{"12": "denoise_12", "12_skip": "denoise_skip",
                "22": "denoise_22"}[case]]
    got = got_a if case != "22" else got_b
    for r in got:
        np.testing.assert_array_equal(r[key], got[0][key])
        np.testing.assert_allclose(r[key], ref, rtol=RTOL, atol=ATOL)
    if case == "12":
        # 2 steps x (the CFG pair batched: 1 call) x (2 blocks x 2 + 1)
        assert all(r["sp_gathers"] == 2 * 5 for r in got_a)


@pytest.mark.parametrize("control", ["no_kv_gather", "rope_from_0"])
def test_sp_controls_fail(sp_ranks, control):
    """Ranks that attend only to their own shard's keys, or that all take
    RoPE rows from 0 instead of their offset, fail the bound."""
    got_a, _, want, _ = sp_ranks
    assert not _close(got_a[0][control], want["denoise_12"])


def test_k1_on_a_query_shard_matches_jax(sp_ranks):
    """K1's plain version on each (1, 2, 2) rank's 128 queries and 2 heads
    against the 256 gathered keys, against JAX's shard_map body with the
    Pallas kernel in interpret mode: the shift is per shard on both sides."""
    got_a, _, want, work = sp_ranks
    out = _assemble([r["k1"] for r in got_a], work["k1"]["q"].shape)
    assert {r["k1"]["rows"] for r in got_a} == {(0, 128), (128, 256)}
    np.testing.assert_allclose(out, want["k1"], rtol=K1_TOL, atol=K1_TOL)


@pytest.mark.parametrize("sp", [2, 3])
def test_sharded_nabla_matches_jax(sp_ranks, sp):
    """Each rank's rows of the faithful mask from its queries against the
    gathered keys, its rows of the STA mask, K6's plain version over the
    whole K/V: JAX's ``_sparse_attention_sharded`` with JAX's faithful
    mask. At sp = 3 the 8 rows do not split: JAX pads a zero-count row,
    the port runs the call whole on every sp rank. The kept fraction
    recorded on every rank is the whole mask's."""
    got_a, _, want, work = sp_ranks
    parts = [r[f"nabla_sp{sp}"] for r in got_a if f"nabla_sp{sp}" in r]
    assert len(parts) == (4 if sp == 2 else 3)
    out = _assemble(parts, work["nabla_op"]["q"].shape)
    np.testing.assert_allclose(out, want[f"nabla_sp{sp}"], rtol=NABLA_TOL,
                               atol=NABLA_TOL)
    assert 0.0 < want["kept"] < 1.0
    for p in parts:
        assert p["kept"] == pytest.approx([want["kept"]], abs=1e-12)


def test_sp_nabla_denoise_matches_one_device(sp_ranks):
    """The NABLA denoise (tests/test_torch_dp.py's case: a CFG pair over 16
    blocks) on (1, 2, 2) and on a (1, 1, 2) mesh (tp alone) against the
    port on one device, which tests/test_torch_sampling.py holds against
    JAX; every rank taking STA rows from 0 fails the bound."""
    got_a, got_b, want, _ = sp_ranks
    for r in got_a:
        np.testing.assert_allclose(r["nabla_denoise"], want["nabla"],
                                   rtol=RTOL, atol=ATOL)
    for r in got_b[:2]:
        np.testing.assert_allclose(r["nabla_tp"], want["nabla"], rtol=RTOL,
                                   atol=ATOL)
    assert not _close(got_a[0]["sta_from_0"], want["nabla"])


@pytest.mark.parametrize("name", ["131", "231"])
def test_sp3_meshes_forward_and_denoise(sp_ranks, name):
    """The (1, 3, 1) and (2, 3, 1) meshes cut from the second launch's ranks
    forward and denoise the 48-token latent (16 tokens a rank) as JAX does
    on one device."""
    _, got_b, want, _ = sp_ranks
    ranks, dp, sp = ranks_mod.SUB_MESHES[name]
    for r in got_b[:len(ranks)]:
        assert r[f"shape_{name}"] == (dp, sp, 1)
        assert r[f"sp_gathers_{name}"] == 2 * 2 + 1
        np.testing.assert_allclose(r[f"forward_{name}"], want["forward48"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r[f"denoise_{name}"], want["denoise48"],
                                   rtol=RTOL, atol=ATOL)


def test_sp_pipeline_matches_one_device(sp_ranks):
    """The (1, 2, 2) pipeline: rank 0 returns the frames (tiles decoded over
    the four ranks), the others None; the single-device tiled decode of the
    same seed to a level of uint8 rounding."""
    got_a, _, want, _ = sp_ranks
    assert all(r["frames"] is None for r in got_a[1:])
    assert all(r["pipe_sp_gathers"] > 0 for r in got_a)
    frames = got_a[0]["frames"]
    assert frames.shape == want["frames"].shape == (1, 1, 64, 64, 3)
    diff = np.abs(frames.astype(int) - want["frames"].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_training_and_int8_refuse_sp(sp_ranks):
    """Training under sp runs: a state of a rank's sp share carries its sp
    group and ``shard_train_state`` takes an sp mesh, and one fp32 step on
    (1, 2, 1) ranks (the 48-token latent split 24 a rank, K and V gathered
    under autograd) gives the loss and every parameter of the port's step on
    one device (rtol 2e-4, atol 2e-5; ``tests/test_torch_train_mesh.py``
    holds training on the mesh against JAX). int8-QK attention (K5's plain
    version) on a (1, 2, 1) mesh runs (its output is not the dense
    forward's) and matches the port's one device within JAX's own mesh
    bound for it, 5e-3 (tests/test_tp_parity.py: each rank's Q scale is its
    queries', K's the gathered keys'; measured 8.3e-4)."""
    from kandinsky5_tpu_torch import training as tt
    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.parallel import SequenceParallel
    from kandinsky5_tpu_torch.parallel.ranks import (
        DataParallel,
        RankGroup,
        RankMesh,
        TensorParallel,
    )
    from kandinsky5_tpu_torch.parallel.sharding import shard_dit

    cfg, params, *_ = _setup()
    model = _torch_tp_ranks.fast_init_dit_params(
        DiTParams(**dataclasses.asdict(cfg)), device="cpu",
        dtype=torch.float32)
    sp = SequenceParallel(None, 0, 2, "gloo", "cpu")
    mesh = RankMesh(DataParallel(None, 0, 1, "gloo", "cpu"),
                    TensorParallel(None, 0, 1, "gloo", "cpu"),
                    RankGroup(None, 0, 2, "gloo", "cpu"), sp)
    local = shard_dit(model, mesh)
    assert local.sp is sp and model.sp is None and local.tp is None
    state = tt.init_train_state(local, tt.make_optimizer())
    assert state.sp is sp and state.tp is None
    assert tt.shard_train_state(state, mesh) is state
    got_a, _, _, work = sp_ranks
    single = ranks_mod.train_case(
        ranks_mod._dit(mesh._replace(sp=None), *work["dits"]["tiny"]), work)
    for r in got_a[:2]:
        train = r["train_121"]
        assert train["state_sp"] and train["sp_calls"] > 5
        np.testing.assert_allclose(train["loss"], single["loss"], rtol=1e-5)
        for k, v in single["params"].items():
            np.testing.assert_allclose(train["params"][k], v, rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    one = ranks_mod._forward(ranks_mod.int8_dit(work["dits"]["tiny"][0]),
                             work["dense48"], "flash_int8")
    dense = ranks_mod._forward(ranks_mod.int8_dit(work["dits"]["tiny"][0]),
                               work["dense48"])
    # the int8 path ran, on one device and on the ranks: 7.2e-4 from the
    # dense forward, against fp32 noise of 4e-7 before the QK norms peaked
    assert np.abs(one - dense).max() > 1e-4
    for r in got_a[:2]:
        assert np.abs(r["int8_121"] - dense).max() > 1e-4
        np.testing.assert_allclose(r["int8_121"], one, atol=5e-3)
    assert all("int8_121" not in r for r in got_a[2:])
