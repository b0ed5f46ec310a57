"""The port's tensor-parallel DiT (kandinsky5_tpu_torch/parallel/ and the tp
path of models/nn.py, models/dit.py, sampling.py and pipeline.py) and K8's
plain version, against the JAX package on the CPU.

K8: ``ops.ff.ff_plain`` against JAX ``fused_ff`` in interpret mode (bf16, at
tests/test_ff_pallas.py's tolerance: 2 % of the output's largest value; both
round the same hidden to bf16, the Pallas kernel's A&S erf is within 1.5e-7
of erf) and ``ff_supported`` against JAX's gate. The plan and the weight
slices against JAX ``plan_dit_mesh`` and ``shard_dit_params`` exactly. Two
gloo ranks on the CPU (one launch, shared by the tests that read
``ranks``) run the sharded FF, a tp = 2 DiT forward and a 2-step CFG
denoise, held against JAX ``_sharded_fused_ff``, ``dit_forward`` and
``denoise`` on a (1, 1, 2) mesh under ``sharding_ctx``: the FF in bf16 at
test_ff_pallas.py's sharded tolerance (0.5 %), the forward and denoise in
fp32 at tests/test_tp_parity.py's (rtol 2e-4, atol 2e-5). A forward whose
FF skips its all-reduce must fail that tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.models.dit import dit_forward as jax_dit_forward
from kandinsky5_tpu.models.nn import _sharded_fused_ff
from kandinsky5_tpu.ops.ff_pallas import ff_supported as jax_ff_supported
from kandinsky5_tpu.ops.ff_pallas import fused_ff as jax_fused_ff
from kandinsky5_tpu.parallel.sharding import (
    make_mesh,
    plan_dit_mesh as jax_plan_dit_mesh,
    shard_dit_params,
    sharding_ctx,
)
from kandinsky5_tpu.sampling import DenoiseSpec as JaxDenoiseSpec
from kandinsky5_tpu.sampling import denoise as jax_denoise
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
from kandinsky5_tpu_torch.ops.ff import ff_plain, ff_supported, fused_ff
from kandinsky5_tpu_torch.parallel import TensorParallel, launch
from kandinsky5_tpu_torch.parallel.sharding import (
    dit_param_specs,
    plan_dit_mesh,
    shard_dit,
    shard_dit_state_dict,
    split_dim,
    tp_width,
)

from . import _torch_tp_ranks as ranks_mod
from .test_tp_parity import _setup
from ._torch_parity import to_np

BF = jnp.bfloat16
# tests/test_tp_parity.py's DenoiseSpec: CFG pair, 2 steps, dense attention
SPEC = dict(num_steps=2, guidance_weight=5.0, scheduler_scale=5.0,
            scale_factor=(1.0, 2.0, 2.0), attn_impl="dense")
RTOL, ATOL = 2e-4, 2e-5


def _ff_inputs(seed, rows, d, ff):
    """numpy float32 values that bf16 holds exactly: x (rows, d), JAX-layout
    w1 (d, ff) and w2 (ff, d)."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, BF), np.float32)

    return (bf16(rng.standard_normal((rows, d))),
            bf16(rng.standard_normal((d, ff)) * 0.05),
            bf16(rng.standard_normal((ff, d)) * 0.05))


def _close(a, b, tol):
    """test_ff_pallas.py's check: max |a - b| under tol of max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6) < tol


@pytest.mark.parametrize("rows,d,ff,lead", [
    (1024, 256, 2304, None), (600, 256, 1024, None), (1024, 256, 1024, (2, 512))],
    ids=["aligned", "padded_rows", "leading_dims"])
def test_ff_plain_matches_jax_fused_ff(rows, d, ff, lead):
    """ff=2304 takes two 1152-wide chunks in the Pallas kernel (its fp32
    accumulator); 600 rows pad to 1024 there."""
    x, w1, w2 = _ff_inputs(rows, rows, d, ff)
    shape = lead + (d,) if lead else x.shape
    want = jax_fused_ff(jnp.asarray(x, BF).reshape(shape), jnp.asarray(w1, BF),
                        jnp.asarray(w2, BF), interpret=True)
    xt = torch.from_numpy(x).bfloat16().reshape(shape)
    w1t = torch.from_numpy(w1.T.copy()).bfloat16()
    w2t = torch.from_numpy(w2.T.copy()).bfloat16()
    got = ff_plain(xt, w1t, w2t)
    assert got.shape == tuple(want.shape) and got.dtype == torch.bfloat16
    assert _close(to_np(got), want, 0.02)
    assert torch.equal(fused_ff(xt, w1t, w2t), got)  # a CPU tensor: plain


@pytest.mark.parametrize("name", ["T2_gemm", "T3_ff", "T4_ff_tiled"])
def test_tool_plain_versions_match_jax(name):
    """T2-T4's plain versions (``tools/bench_pallas_gemm.py``): T2 against
    XLA's bf16 dot with fp32 accumulation (the Pallas ``_gemm_kernel``'s
    math), at 512 x 256 and at the kernel's shape rules' edges (1,000 rows,
    not a multiple of its 128-row tile; N = 1792 and N = 136, not a multiple
    of its 256-column tile), T3 and T4 (two 1024-wide chunks here) against
    JAX ``fused_ff`` in interpret mode, whose math they share;
    test_ff_pallas.py's 2 %."""
    from kandinsky5_tpu_torch.tools import bench_pallas_gemm as bpg

    x, w1, w2 = _ff_inputs(7, 512, 256, 2048)
    xt = torch.from_numpy(x).bfloat16()
    w1t = torch.from_numpy(w1.T.copy()).bfloat16()
    w2t = torch.from_numpy(w2.T.copy()).bfloat16()
    if name == "T2_gemm":
        xr, wr, _ = _ff_inputs(8, 1000, 256, 1792)
        for xs, wo in ((x, w1[:, :256]), (xr, wr), (xr, wr[:, :136])):
            want = jnp.dot(jnp.asarray(xs, BF), jnp.asarray(wo, BF),
                           preferred_element_type=jnp.float32).astype(BF)
            got = bpg.gemm(torch.from_numpy(xs).bfloat16(),
                           torch.from_numpy(wo.T.copy()).bfloat16())
            assert got.dtype == torch.bfloat16
            assert got.shape == tuple(want.shape)
            assert _close(to_np(got), want, 0.02)
    else:
        want = jax_fused_ff(jnp.asarray(x, BF), jnp.asarray(w1, BF),
                            jnp.asarray(w2, BF), interpret=True)
        fn = bpg.ff if name == "T3_ff" else bpg.ff_chunked
        got = fn(xt, w1t, w2t)
        assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
        assert _close(to_np(got), want, 0.02)


_GATE_CASES = {
    "aligned": ((1024, 256), (256, 1024), BF),
    "short_rows": ((128, 256), (256, 1024), BF),
    "fp32": ((1024, 256), (256, 1024), jnp.float32),
    "odd_dims": ((1024, 100), (100, 1024), BF),
    "text_rows": ((1, 256, 1792), (1792, 7168), BF),
    "visual_tp4": ((1, 47616, 1792), (1792, 7168 // 4), BF),
}


@pytest.mark.parametrize("case", sorted(_GATE_CASES))
def test_ff_supported_matches_jax(case):
    """test_ff_pallas.py:65's cases, the 256-row text blocks (declined) and
    a tp = 4 rank's share of the 5 s visual FF (taken)."""
    xs, w1s, dtype = _GATE_CASES[case]
    d, ff = w1s
    want = jax_ff_supported(jax.ShapeDtypeStruct(xs, dtype),
                            jax.ShapeDtypeStruct((d, ff), BF),
                            jax.ShapeDtypeStruct((ff, d), BF))
    tdt = torch.bfloat16 if dtype == BF else torch.float32
    got = ff_supported(torch.empty(xs, dtype=tdt, device="meta"),
                       torch.empty((ff, d), dtype=torch.bfloat16, device="meta"),
                       torch.empty((d, ff), dtype=torch.bfloat16, device="meta"))
    assert got == bool(want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_dit_mesh_matches_jax(n):
    want = dict(jax_plan_dit_mesh(n, num_heads=28).shape)
    assert plan_dit_mesh(n, num_heads=28) == (want["dp"], want["sp"],
                                              want["tp"])


def test_tp_dit_from_sp_or_dp_plan_raises():
    """The plans that put the rest of the devices on sp build rank DiTs:
    8 devices (1, 2, 4), 3 devices (1, 3, 1), 6 over dp 2 (2, 3, 1); each
    rank holds its tp index's heads and FF share and runs its visual blocks
    over its sp group. A tp group that does not divide the heads still
    raises, saying that sp is how such a device count runs."""
    from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
    from kandinsky5_tpu_torch.parallel import SequenceParallel
    from kandinsky5_tpu_torch.parallel.ranks import (
        DataParallel,
        RankGroup,
        RankMesh,
    )

    cfg28 = DiTParams(model_dim=1792, ff_dim=512, num_text_blocks=1,
                      num_visual_blocks=1, time_dim=32, in_text_dim=32,
                      in_text_dim2=16)
    assert cfg28.num_heads == 28
    with torch.device("meta"):
        full = DiffusionTransformer3D(cfg28, dtype=torch.bfloat16)
    for n, dp, want in ((8, 1, (1, 2, 4)), (3, 1, (1, 3, 1)),
                        (6, 2, (2, 3, 1))):
        plan = plan_dit_mesh(n, num_heads=28, dp=dp)
        assert plan == want and tp_width(plan) == want[2]
        _, sp, tp = plan
        for rank in range(n):
            mesh = RankMesh(
                DataParallel(None, rank // (sp * tp), dp, "gloo", "meta"),
                TensorParallel(None, rank % tp, tp, "gloo", "meta"),
                RankGroup(None, rank, n, "gloo", "meta"),
                SequenceParallel(None, (rank // tp) % sp, sp, "gloo", "meta"))
            local = shard_dit(full, mesh)
            blk = local.visual_transformer_blocks[0]
            assert blk.self_attention.to_query.weight.shape[0] == 1792 // tp
            assert blk.feed_forward.in_layer.weight.shape[0] == 512 // tp
            assert local.sp is mesh.sp and (local.tp is None) == (tp == 1)
    assert tp_width(plan_dit_mesh(4, num_heads=28)) == 4
    assert tp_width(plan_dit_mesh(4, num_heads=28, dp=2)) == 2
    assert tp_width(plan_dit_mesh(2, num_heads=28, dp=2)) == 1
    # a tiny DiT of 2 heads over a tp group of 3
    cfg = DiTParams(model_dim=128, ff_dim=256, num_text_blocks=1,
                    num_visual_blocks=1, axes_dims=(8, 4, 4), time_dim=32,
                    in_text_dim=32, in_text_dim2=16)
    model = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="sequence axis"):
        shard_dit(model, TensorParallel(None, 0, 3, "gloo", "cpu"))


def test_tensor_parallel_builds_on_the_card_or_raises(monkeypatch):
    """The backend has no default; with no device the holder is the card's
    and raises without one, never the CPU unless asked. A model on another
    device than the group's is not moved: shard_dit raises."""
    with pytest.raises(TypeError):
        TensorParallel(None, 0, 2)
    with pytest.raises(ValueError, match="backend"):
        TensorParallel(None, 0, 2, "mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TensorParallel(None, 0, 2, "gloo")
    assert TensorParallel(None, 0, 2, "gloo", "cpu").device.type == "cpu"
    cfg = DiTParams(model_dim=128, ff_dim=256, num_text_blocks=1,
                    num_visual_blocks=1, axes_dims=(8, 4, 4), time_dim=32,
                    in_text_dim=32, in_text_dim2=16)
    model = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="meta"):
        shard_dit(model, TensorParallel(None, 0, 2, "gloo", "meta"))
    # a group of one rank holds the model itself
    assert shard_dit(model, TensorParallel(None, 0, 1, "gloo", "cpu")) is model
    assert model.tp is None


def test_shard_dit_state_dict_matches_jax_shards():
    """Each rank's slice equals the JAX leaf's shard on that rank's device,
    exactly, once transposed to the torch layout and unstacked."""
    cfg, params, *_ = _setup()
    mesh = make_mesh(n_devices=2)
    assert dict(mesh.shape) == {"dp": 1, "sp": 1, "tp": 2}
    sharded = shard_dit_params(params, mesh)
    full = dit_state_dict_from_jax(jax.tree.map(np.asarray, params))
    devices = list(mesh.devices.flat)
    for rank, dev in enumerate(devices):
        local = jax.tree.map(
            lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                      if s.device == dev)), sharded)
        want = dit_state_dict_from_jax(local)
        got = shard_dit_state_dict(full, rank, 2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # every parameter of the port's DiT has a spec
    model = fast_init_dit_params(DiTParams(**dataclasses.asdict(cfg)),
                                 device="cpu", dtype=torch.float32)
    for name, _ in model.named_parameters():
        split_dim(name, dit_param_specs())


@pytest.fixture(scope="module")
def ranks():
    """One launch of two gloo CPU ranks (tests/_torch_tp_ranks.run) and the
    JAX side of each check."""
    cfg, params, noise, cond, uncond = _setup()
    ff_x, ff_w1, ff_w2 = _ff_inputs(5, 1024, 256, 1024)
    ff_case = (ff_x.reshape(2, 512, 256), ff_w1.T.copy(), ff_w2.T.copy())
    # the forward: a partly padded text mask
    fwd = dict(x=np.asarray(noise), text=np.asarray(cond["text_embeds"]),
               pooled=np.asarray(cond["pooled_embed"]),
               time=np.array([500.0], np.float32),
               mask=np.arange(8)[None] < 6)
    np_cond = {k: np.asarray(v) for k, v in cond.items()}
    np_uncond = {k: np.asarray(v) for k, v in uncond.items()}
    dit_case = (dataclasses.asdict(cfg),
                dit_state_dict_from_jax(jax.tree.map(np.asarray, params)),
                fwd, np.asarray(noise), np_cond, np_uncond, SPEC)
    got = launch(ranks_mod.run, 2, "gloo", "cpu", args=(ff_case, dit_case),
                 timeout=300)

    mesh = make_mesh(n_devices=2)
    sharded = shard_dit_params(params, mesh)
    want = {}
    want["ff"] = np.asarray(_sharded_fused_ff(
        jnp.asarray(ff_case[0], BF), jnp.asarray(ff_w1, BF),
        jnp.asarray(ff_w2, BF), mesh), np.float32)
    with sharding_ctx(mesh):
        forward = jax.jit(lambda p, x, text, pooled, t, mask: jax_dit_forward(
            p, cfg, x, text, pooled, t, text_mask=mask,
            scale_factor=(1.0, 2.0, 2.0), attn_impl="dense"))
        want["forward"] = np.asarray(forward(
            sharded, *(jnp.asarray(fwd[k]) for k in ("x", "text", "pooled",
                                                     "time", "mask"))))
        skip = jnp.zeros((SPEC["num_steps"], 2), bool)
        # the ranks' seeded run integrates rank 0's noise: a CPU generator
        # seeded with 10
        noise10 = torch.randn(noise.shape, generator=torch.Generator()
                              .manual_seed(10)).numpy()
        for key, z in (("denoise", noise), ("latents_seeded", noise10)):
            want[key] = np.asarray(jax_denoise(
                sharded, JaxDenoiseSpec(dit_params=cfg, **SPEC),
                jnp.asarray(z), cond["text_embeds"], cond["pooled_embed"],
                cond["mask"], uncond["text_embeds"], uncond["pooled_embed"],
                uncond["mask"], skip))
    return got, want, cfg


def test_tp_sharded_fused_ff_matches_jax(ranks):
    """Column-parallel W1, row-parallel W2, K8's plain version on each
    rank's share, all-reduce: JAX's shard_map with the Pallas kernel in
    interpret mode, bf16."""
    got, want, _ = ranks
    for r in got:
        assert r["ff"].shape == want["ff"].shape
        assert _close(r["ff"], want["ff"], 0.005)
    np.testing.assert_array_equal(got[0]["ff"], got[1]["ff"])


def test_tp_dit_forward_matches_jax(ranks):
    got, want, cfg = ranks
    for r in got:
        np.testing.assert_allclose(r["forward"], want["forward"], rtol=RTOL,
                                   atol=ATOL)
        # per visual block: self- and cross-attention out layers and the FF
        assert r["forward_all_reduces"] == 3 * cfg.num_visual_blocks


def test_tp_forward_without_ff_all_reduce_fails(ranks):
    """The control: each rank keeps its FF partial sum."""
    got, want, _ = ranks
    for r in got:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(r["forward_no_ff_sum"], want["forward"],
                                       rtol=RTOL, atol=ATOL)


def test_tp_denoise_matches_jax(ranks):
    got, want, _ = ranks
    for r in got:
        np.testing.assert_allclose(r["denoise"], want["denoise"], rtol=RTOL,
                                   atol=ATOL)


def test_tp_ranks_denoise_rank0_noise(ranks):
    """Rank r seeds its noise with 10 + r; both integrate rank 0's
    (broadcast): JAX's denoise of the noise a CPU generator seeded with 10
    draws."""
    got, want, _ = ranks
    np.testing.assert_array_equal(got[0]["latents_seeded"],
                                  got[1]["latents_seeded"])
    np.testing.assert_allclose(got[0]["latents_seeded"],
                               want["latents_seeded"], rtol=RTOL, atol=ATOL)


def test_tp_pipeline_rank0_decodes_tiled(ranks, monkeypatch):
    """Rank 0 decodes (tiled, the JAX package's mesh default) and returns
    the frames; rank 1 returns None. The frames are the single-device
    pipeline's tiled decode of the same seed, to a level of uint8
    rounding."""
    monkeypatch.setitem(ranks_mod.RESOLUTIONS, 512, [(64, 64)])
    got, _, _ = ranks
    assert got[1]["frames"] is None
    assert got[0]["decode_mode"] == got[1]["decode_mode"] == "tiled"
    single = ranks_mod.pipeline(decode_mode="tiled")
    want = single("a test image", time_length=0, width=64, height=64, seed=3,
                  expand_prompts=False)
    frames = got[0]["frames"]
    assert frames.shape == want.shape == (1, 1, 64, 64, 3)
    diff = np.abs(frames.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
