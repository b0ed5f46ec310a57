"""The port's data axis (dp) against the JAX package's dp mesh on the CPU:
the rank layout, the sampler's split CFG pair and extra prompts (with
MagCache, under dp x tp, and replicated where dp does not divide the
batch), the dp-split tiled decode, ZeRO-1 and the dp-placed loader; NABLA
and the pipeline against the port on one device, which other tests hold
against JAX.

Two launches of gloo CPU ranks (``tests/_torch_dp_ranks.py``, no JAX): a
(2, 1, 1) mesh for the denoises, decodes, the pipeline and ZeRO-1, and a
(2, 1, 2) mesh for the dp x tp denoise; JAX computes its side while the
ranks run. Tolerances are the JAX package's own: rtol 2e-4 / atol 2e-5 for
the fp32 denoises (tests/test_tp_parity.py), and for the ZeRO step 2e-5 /
2e-6 on the loss and 2e-4 / 2e-5 on the parameters
(tests/test_training_zero.py). The fp32 decodes take
tests/test_torch_vae_tiled.py's 2e-4 for the port's decode against JAX's:
tests/test_vae_mesh.py's 2e-5 holds JAX's mesh decode against JAX's own
sequential one, and the port's single-device tiled decode already sits
2.4e-5 from JAX's on the temporal setup (the split over ranks adds
nothing: each tile is the same computation). Each
collective has a control that must fail its bound: ranks that skip the
predictions' gather, a step without the gradients' mean over dp, two
decoded tiles swapped before the blend."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu import data as jd
from kandinsky5_tpu import training as jt
from kandinsky5_tpu.checkpoint import convert_vae_state_dict
from kandinsky5_tpu.models import vae as jax_vae
from kandinsky5_tpu.parallel.sharding import (
    make_mesh,
    shard_dit_params,
    sharding_ctx,
)
from kandinsky5_tpu.sampling import DenoiseSpec as JaxDenoiseSpec
from kandinsky5_tpu.sampling import denoise as jax_denoise
from kandinsky5_tpu_torch import data as td
from kandinsky5_tpu_torch import training as tt
from kandinsky5_tpu_torch.checkpoint import (
    _flatten,
    dit_from_state_dict,
    dit_state_dict_from_jax,
)
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
from kandinsky5_tpu_torch.models.vae import init_vae_params
from kandinsky5_tpu_torch.parallel import DataParallel, RankMesh, launch
from kandinsky5_tpu_torch.parallel.ranks import (
    RankGroup,
    TensorParallel,
    rank_grid,
)
from kandinsky5_tpu_torch.sampling import DenoiseSpec, denoise

from . import _torch_dp_ranks as ranks_mod
from . import _torch_tp_ranks
from .test_tp_parity import _setup
from .test_training_zero import _setup as _zero_setup
from ._torch_parity import both_cfgs, rand, random_dit_pair

RTOL, ATOL = 2e-4, 2e-5
DECODE_TOL = 2e-4
# tests/test_tp_parity.py's spec: 2 dense Euler steps at scale 5
SPEC = dict(num_steps=2, scheduler_scale=5.0, scale_factor=(1.0, 2.0, 2.0),
            attn_impl="dense")
NAMES = ("text_embeds", "pooled_embed", "mask")
# a MagCache schedule that skips both branches, then one, then the other
SKIP = np.array([[False, False], [True, True], [False, True], [True, False]])
TINY_D64 = dict(in_visual_dim=4, out_visual_dim=4, in_text_dim=32,
                in_text_dim2=16, time_dim=32, model_dim=128, ff_dim=256,
                num_text_blocks=1, num_visual_blocks=2,
                axes_dims=(16, 24, 24), patch_size=(1, 2, 2))


def _prompts(rng, cfg, b, n_valid=6):
    mask = np.arange(8)[None].repeat(b, 0) < n_valid
    return dict(zip(NAMES, (rand(rng, b, 8, cfg.in_text_dim),
                            rand(rng, b, cfg.in_text_dim2), mask)))


def _denoise_cases():
    """The denoises of the tiny DiT: the CFG pair (split, with the gather's
    control), two prompts without CFG (split), one prompt without CFG
    (replicated) and MagCache with the CFG pair (split)."""
    cfg, _, noise, cond, uncond = _setup()
    rng = np.random.default_rng(3)
    np_cond = {k: np.asarray(v) for k, v in cond.items()}
    np_uncond = {k: np.asarray(v) for k, v in uncond.items()}
    two = _prompts(rng, cfg, 2)
    noise2 = rand(rng, 2, *np.shape(noise)[1:])
    cases = {
        "cfg": dict(noise=np.asarray(noise), cond=np_cond, uncond=np_uncond,
                    spec=dict(SPEC, guidance_weight=5.0), control=True),
        "nocfg_two_prompts": dict(noise=noise2, cond=two, uncond=two,
                                  spec=dict(SPEC, guidance_weight=1.0)),
        "nocfg_one_prompt": dict(noise=np.asarray(noise), cond=np_cond,
                                 uncond=np_uncond,
                                 spec=dict(SPEC, guidance_weight=1.0)),
        "magcache": dict(noise=np.asarray(noise), cond=np_cond,
                         uncond=np_uncond, skip=SKIP,
                         spec=dict(SPEC, num_steps=len(SKIP),
                                   guidance_weight=5.0)),
    }
    for case in cases.values():
        case["dit"] = "tiny"
    return cases


def _jax_denoise(params, cfg, case, mesh):
    spec = JaxDenoiseSpec(dit_params=cfg, **case["spec"])
    skip = case.get("skip")
    if skip is None:
        skip = np.zeros((spec.num_steps, 2), bool)
    c, u = case["cond"], case["uncond"]
    with sharding_ctx(mesh):
        return np.asarray(jax_denoise(
            shard_dit_params(params, mesh), spec, jnp.asarray(case["noise"]),
            *(jnp.asarray(c[k]) for k in NAMES),
            *(jnp.asarray(u[k]) for k in NAMES), jnp.asarray(skip)))


def _nabla_case():
    """The tiny 10 s-style DiT (tests/test_torch_sampling.py's NABLA case):
    its CFG pair batched, NABLA on a (4, 16, 16) token grid."""
    jcfg, pcfg = both_cfgs(**TINY_D64)
    jparams, model = random_dit_pair(jcfg, pcfg, seed=11)
    rng = np.random.default_rng(12)
    case = dict(dit="nabla", noise=rand(rng, 1, 4, 32, 32, 4),
                cond=_prompts(rng, jcfg, 1), uncond=_prompts(rng, jcfg, 1, 4),
                spec=dict(num_steps=2, guidance_weight=3.5,
                          scheduler_scale=5.0, scale_factor=(1.0, 2.0, 2.0),
                          attention_type="nabla", nabla_P=0.9, nabla_wT=3,
                          nabla_wH=1, nabla_wW=1, attn_impl="auto"))
    single = denoise(model, DenoiseSpec(dit_params=pcfg, **case["spec"]),
                     torch.from_numpy(case["noise"]),
                     {k: torch.from_numpy(np.asarray(v))
                      for k, v in case["cond"].items()},
                     {k: torch.from_numpy(np.asarray(v))
                      for k, v in case["uncond"].items()}).numpy()
    state = dit_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    return (dataclasses.asdict(pcfg), state), case, single


def _zero_case():
    """tests/test_training_zero.py's setup and JAX's own t and noise."""
    cfg, params, batch = _zero_setup()
    t_key, n_key = jax.random.split(jax.random.PRNGKey(5))
    x0 = batch[0]
    t = jax.random.uniform(t_key, (x0.shape[0],), jnp.float32, 1e-4, 1.0)
    noise = jax.random.normal(n_key, x0.shape, jnp.float32)
    return cfg, params, dict(
        cfg=dataclasses.asdict(cfg),
        state=dit_state_dict_from_jax(jax.tree.map(np.asarray, params)),
        batch=[np.asarray(a) for a in batch], t=np.asarray(t),
        noise=np.asarray(noise), lr=1e-4, seed=9)


def _jax_vae():
    """The JAX package's VAE with the values of the ranks' port VAE."""
    params = init_vae_params(device="cpu", dtype=torch.float32,
                             seed=ranks_mod.VAE_SEED)
    flat = _flatten(params, "", {})
    state = {}
    for key, value in flat.items():
        # the HF layout holds each causal conv's weights under ``.conv``
        name, leaf = key.rsplit(".", 1)
        if (flat[f"{name}.weight"].ndim == 5
                and name not in ("quant_conv", "post_quant_conv")):
            key = f"{name}.conv.{leaf}"
        state[key] = value
    return convert_vae_state_dict(state, dtype=jnp.float32)


@pytest.fixture(scope="module")
def dp_ranks():
    """One launch of a (2, 1, 1) mesh, and the JAX side of its checks
    computed while the ranks run."""
    cfg, params, *_ = _setup()
    tiny = (dataclasses.asdict(cfg),
            dit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    nabla_dit, nabla_case, nabla_single = _nabla_case()
    cases = _denoise_cases()
    cases["nabla"] = nabla_case
    zcfg, zparams, zero = _zero_case()
    work = dict(dits={"tiny": tiny, "nabla": nabla_dit}, denoise=cases,
                decodes=True, pipeline=True, zero=zero)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run, 2, "gloo", "cpu",
                             args=(work,), timeout=600, dp=2)
        mesh = make_mesh(n_devices=2, dp=2)
        want = {name: _jax_denoise(params, cfg, case, mesh)
                for name, case in cases.items() if name != "nabla"}
        want["nabla"] = nabla_single
        jvae = _jax_vae()
        vmesh = make_mesh(dp=len(jax.devices()))
        for name, (_, tiling) in ranks_mod.DECODES.items():
            vae = jax_vae.HunyuanVideoVAE(jvae, dtype=jnp.float32, mesh=vmesh)
            vae._apply_tiling(*tiling)
            want[f"decode_{name}"] = np.asarray(vae.decode(
                jnp.asarray(ranks_mod.decode_latents(name)),
                opt_tiling=False))
        want["zero"] = _jax_zero(zcfg, zparams, zero)
        want["pipeline"] = _single_pipeline()
        got = future.result()
    return got, want


def _jax_zero(cfg, params, case):
    """JAX's ZeRO-1 step on tests/test_training_zero.py's (2, 1, 4) mesh,
    and the moments' elements on one device of a (2, 1, 1) mesh."""
    opt = jt.make_optimizer(lr=case["lr"])
    mesh = make_mesh(n_devices=8, dp=2)
    state = jt.shard_train_state(
        jt.init_train_state(shard_dit_params(params, mesh), opt), mesh)
    with sharding_ctx(mesh):
        out, loss = jt.train_step(state, cfg, opt,
                                  *(jnp.asarray(a) for a in case["batch"]),
                                  jax.random.PRNGKey(5), attn_impl="dense")
    mesh2 = make_mesh(n_devices=2, dp=2)
    state2 = jt.shard_train_state(jt.init_train_state(params, opt), mesh2)
    dev = mesh2.devices.flat[0]
    elements = sum(next(s.data.size for s in leaf.addressable_shards
                        if s.device == dev)
                   for leaf in jax.tree.leaves(state2.opt_state)
                   if getattr(leaf, "ndim", 0) >= 1)
    return dict(loss=float(loss),
                params=dit_state_dict_from_jax(
                    jax.tree.map(np.asarray, out.params)),
                moment_elements=elements,
                total=2 * sum(leaf.size for leaf in jax.tree.leaves(params)))


def _single_pipeline():
    """The tiny pipeline's CFG image request on one device, tiled in the
    same 3 x 3 tiles."""
    sizes = _torch_tp_ranks.RESOLUTIONS[512]
    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]
    try:
        pipe = _torch_tp_ranks.pipeline(decode_mode="tiled",
                                        vae_cls=ranks_mod.SmallTileVAE,
                                        guidance_weight=5.0)
        return pipe("a test image", time_length=0, width=64, height=64,
                    seed=3, expand_prompts=False)
    finally:
        _torch_tp_ranks.RESOLUTIONS[512] = sizes


@pytest.fixture(scope="module")
def dptp_ranks():
    """One launch of a (2, 1, 2) mesh: the CFG pair with dp x tp, against
    JAX's ``denoise`` under ``make_mesh(4, dp=2)``."""
    cfg, params, *_ = _setup()
    tiny = (dataclasses.asdict(cfg),
            dit_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    cases = {"cfg": _denoise_cases()["cfg"]}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run, 4, "gloo", "cpu",
                             args=(dict(dits={"tiny": tiny}, denoise=cases),),
                             timeout=600, dp=2)
        want = _jax_denoise(params, cfg, cases["cfg"],
                            make_mesh(n_devices=4, dp=2))
        got = future.result()
    return got, want


@pytest.mark.parametrize("n,dp", [(2, 2), (4, 2), (8, 2)])
def test_rank_layout_matches_jax_make_mesh(n, dp):
    """Rank r sits where JAX's ``make_mesh(n, dp)`` puts device r: dp index
    r // tp, tp index r % tp."""
    mesh = make_mesh(n_devices=n, dp=dp)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert ids.shape == (dp, 1, n // dp) == tuple(mesh.shape.values())
    np.testing.assert_array_equal(rank_grid(n, dp), ids)


def test_launch_places_ranks_on_the_mesh(dptp_ranks):
    got, _ = dptp_ranks
    for r, out in enumerate(got):
        assert out["shape"] == (2, 1, 2) and out["rank"] == r
        assert (out["dp_rank"], out["tp_rank"]) == (r // 2, r % 2)


@pytest.mark.parametrize("case", ["cfg", "nocfg_two_prompts",
                                  "nocfg_one_prompt", "magcache"])
def test_dp_denoise_matches_jax(dp_ranks, case):
    """The (2, 1, 1) ranks' latents, equal on both ranks, against JAX's
    denoise under ``make_mesh(2, dp=2)``. A split batch gathers once a
    step; one prompt without CFG runs replicated, with no gather."""
    got, want = dp_ranks
    np.testing.assert_array_equal(got[0]["denoise"][case]["latents"],
                                  got[1]["denoise"][case]["latents"])
    for r in got:
        np.testing.assert_allclose(r["denoise"][case]["latents"], want[case],
                                   rtol=RTOL, atol=ATOL)
        steps = len(SKIP) if case == "magcache" else SPEC["num_steps"]
        split = case != "nocfg_one_prompt"
        assert r["denoise"][case]["gathers"] == (steps if split else 0)


def test_dp_nabla_matches_single_device(dp_ranks):
    """The NABLA CFG pair split over (2, 1, 1) against the port's own
    single-device run of the same batched pair."""
    got, want = dp_ranks
    for r in got:
        np.testing.assert_allclose(r["denoise"]["nabla"]["latents"],
                                   want["nabla"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("launch_", ["dp", "dp_tp"])
def test_dp_denoise_without_gather_fails(dp_ranks, dptp_ranks, launch_):
    got, want = dp_ranks if launch_ == "dp" else dptp_ranks
    want = want["cfg"] if launch_ == "dp" else want
    for r in got:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(r["denoise"]["cfg"]["no_gather"], want,
                                       rtol=RTOL, atol=ATOL)


def test_dp_tp_denoise_matches_jax(dptp_ranks):
    """Four ranks on (2, 1, 2): each dp group computes one half of the CFG
    pair with its two tp ranks; every rank ends with the same latents,
    JAX's under ``make_mesh(4, dp=2)``."""
    got, want = dptp_ranks
    for r in got:
        np.testing.assert_array_equal(r["denoise"]["cfg"]["latents"],
                                      got[0]["denoise"]["cfg"]["latents"])
        np.testing.assert_allclose(r["denoise"]["cfg"]["latents"], want,
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(ranks_mod.DECODES))
def test_dp_tiled_decode_matches_jax_mesh(dp_ranks, name):
    """tests/test_vae_mesh.py's setups split over two ranks: rank 0's frames
    against JAX's mesh decode; each rank decoded some of the tiles; two
    tiles swapped before the blend fail the bound."""
    got, want = dp_ranks
    frames = got[0]["decodes"][name]["frames"]
    assert got[1]["decodes"][name]["frames"] is None
    assert frames.shape == want[f"decode_{name}"].shape
    np.testing.assert_allclose(frames, want[f"decode_{name}"],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert all(r["decodes"][name]["tiles"] > 0 for r in got)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got[0]["decodes"][name]["swapped"],
                                   want[f"decode_{name}"], rtol=DECODE_TOL,
                                   atol=DECODE_TOL)


def test_dp_pipeline_matches_single_device(dp_ranks):
    """A (2, 1, 1) pipeline's CFG image request: the pair split over dp,
    every rank decoding some of the 3 x 3 tiles; rank 0's frames are the
    single-device tiled pipeline's to a level of uint8 rounding."""
    got, want = dp_ranks
    p0, p1 = got[0]["pipeline"], got[1]["pipeline"]
    assert p1["frames"] is None
    assert p0["decode_mode"] == p1["decode_mode"] == "tiled"
    assert p0["decoded_tiles"] == 5 and p1["decoded_tiles"] == 4
    assert p0["dp_split"] and p0["gather_calls"] == 2
    frames = p0["frames"]
    assert frames.shape == want["pipeline"].shape == (1, 1, 64, 64, 3)
    diff = np.abs(frames.astype(int) - want["pipeline"].astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_zero1_step_matches_jax(dp_ranks):
    """One ZeRO-1 step on two dp ranks, each on its 2 rows of the batch of
    4 at JAX's t and noise: the loss and every parameter against JAX's
    sharded step; each rank holds as many moment elements as one JAX device
    of a (2, 1, 1) mesh, half of the unsharded moments."""
    got, want = dp_ranks
    w = want["zero"]
    for r in got:
        z = r["zero"]
        assert z["step"] == 1 and z["count"] == 1
        np.testing.assert_allclose(z["loss"], w["loss"], rtol=2e-5, atol=2e-6)
        assert z["params"].keys() == w["params"].keys()
        for k in w["params"]:
            np.testing.assert_allclose(z["params"][k], w["params"][k],
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        assert z["moment_elements"] == w["moment_elements"] == w["total"] // 2
        assert all(d is not None for d in z["dims"])


def test_zero1_without_all_reduce_fails(dp_ranks):
    got, want = dp_ranks
    for r in got:
        with pytest.raises(AssertionError):
            for k, v in want["zero"]["params"].items():
                np.testing.assert_allclose(r["zero"]["no_all_reduce"][k], v,
                                           rtol=2e-4, atol=2e-5)


def test_zero1_draws_the_global_batch(dp_ranks):
    """``train_step`` on the dp ranks draws the global batch's t and noise
    from its generator and takes its rows: the step is the single-process
    step from the same seed on the whole batch."""
    got, _ = dp_ranks
    _, _, case = _zero_case()
    model = DiffusionTransformer3D(DiTParams(**case["cfg"]), device="cpu",
                                   dtype=torch.float32)
    dit_from_state_dict(model, case["state"])
    opt = tt.make_optimizer(lr=case["lr"])
    _, loss = tt.train_step(tt.init_train_state(model, opt),
                            DiTParams(**case["cfg"]), opt,
                            *(torch.from_numpy(a) for a in case["batch"]),
                            torch.Generator().manual_seed(case["seed"]),
                            attn_impl="dense")
    for r in got:
        np.testing.assert_allclose(r["zero"]["drawn_loss"], loss.item(),
                                   rtol=2e-5, atol=2e-6)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(r["zero"]["drawn"][k], v.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def _mesh_place(rank, size=2):
    dp = DataParallel(None, rank, size, "gloo", "cpu")
    tp = TensorParallel(None, 0, 1, "gloo", "cpu")
    return RankMesh(dp, tp, RankGroup(None, rank, size, "gloo", "cpu"))


@pytest.mark.parametrize("epoch", [0, 1])
def test_dp_loader_matches_jax_mesh_loader(tmp_path, epoch):
    """Two dp ranks' batches, concatenated in rank order, are JAX's
    ``LatentShardLoader(mesh=make_mesh(8, dp=2))`` batches; a batch that dp
    does not divide raises."""
    rng = np.random.default_rng(4)
    paths = []
    for i, n in enumerate((7, 10)):
        paths.append(str(tmp_path / f"shard{i}.npz"))
        td.write_shard(paths[-1], rng.standard_normal((n, 2, 8, 8, 4)),
                       rng.standard_normal((n, 16, 32)),
                       rng.standard_normal((n, 8)), rng.random((n, 16)) < 0.8)
    ranks = [list(td.LatentShardLoader(paths, 4, seed=3, device="cpu",
                                       dp=_mesh_place(d).dp).epoch(epoch))
             for d in range(2)]
    theirs = list(jd.LatentShardLoader(paths, 4, seed=3,
                                       mesh=make_mesh(8, dp=2)).epoch(epoch))
    assert len(ranks[0]) == len(ranks[1]) == len(theirs) == 4
    for a, b, c in zip(*ranks, theirs):
        for k in c:
            assert a[k].shape[0] == 2
            np.testing.assert_array_equal(
                torch.cat([a[k], b[k]]).float().numpy(),
                np.asarray(c[k], np.float32))
    with pytest.raises(ValueError, match="divide"):
        td.LatentShardLoader(paths, 3, device="cpu", dp=_mesh_place(0).dp)
