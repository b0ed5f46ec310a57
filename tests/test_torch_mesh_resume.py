"""Resumable generation on a mesh (``utils/resume.py`` with ``mesh=``)
against the JAX package on the CPU: one launch of two gloo CPU ranks
(``tests/_torch_mesh_ranks.py``, no JAX) cuts the (1, 1, 2), (2, 1, 1) and
(1, 2, 1) meshes from its ranks and runs the tiny DiT of
``tests/test_tp_parity.py`` with CFG and a MagCache schedule (6 steps,
chunks of 2): the uninterrupted run, a run stopped after two chunks and its
resumption at step 4, where the uncond branch skips on the carried
residual. The resumed latents are bit-equal to the uninterrupted mesh run
and within the JAX package's fp32 denoise tolerance (rtol 2e-4 / atol
2e-5, ``tests/test_tp_parity.py``) of JAX's mesh ``denoise`` fed the
port's seeded noise; rank 0 alone writes the state, which under dp holds
the whole residual (equal to the one-device sequential-CFG run's); the
control, rank 0 saving its own rows alone, misses the latents. The ranks
also agree on an unseeded request's seed, and refuse to resume when their
fingerprints differ. JAX computes its side while the ranks run."""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.parallel.sharding import (
    make_mesh,
    shard_dit_params,
    sharding_ctx,
)
from kandinsky5_tpu.sampling import DenoiseSpec as JaxDenoiseSpec
from kandinsky5_tpu.sampling import denoise as jax_denoise
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.sampling import DenoiseSpec, skip_schedule
from kandinsky5_tpu_torch.utils import resume

from . import _torch_mesh_ranks as ranks_mod
from ._torch_serving import MAG
from .test_tp_parity import _setup

RTOL, ATOL = 2e-4, 2e-5
SPEC = dict(num_steps=6, guidance_weight=5.0, scheduler_scale=5.0,
            scale_factor=(1.0, 2.0, 2.0), attn_impl="dense")
NAMES = ("text_embeds", "pooled_embed", "mask")
JAX_MESHES = {"112": dict(n_devices=2), "211": dict(n_devices=2, dp=2),
              "121": dict(n_devices=2, sp=2)}


def _noise(shape):
    """The port's seeded noise on the CPU (``sampling.seeded_noise``)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        ranks_mod.SEED), dtype=torch.float32).numpy()


@pytest.fixture(scope="module")
def mesh_resume(tmp_path_factory):
    cfg, params, noise, cond, uncond = _setup()
    shape = tuple(np.shape(noise))
    state = dit_state_dict_from_jax(jax.tree.map(np.asarray, params))
    np_cond = {k: np.asarray(v) for k, v in cond.items()}
    np_uncond = {k: np.asarray(v) for k, v in uncond.items()}
    work = dict(cfg=dataclasses.asdict(cfg), state=state, spec=SPEC,
                mag=dataclasses.asdict(MAG), cond=np_cond, uncond=np_uncond,
                shape=shape, dir=str(tmp_path_factory.mktemp("mesh_resume")))
    pcfg = ranks_mod.whole_dit(work["cfg"], state).cfg
    skip = skip_schedule(DenoiseSpec(dit_params=pcfg, **SPEC), MAG)
    x0 = _noise(shape)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.resume_run, 2, "gloo", "cpu",
                             args=(work,), timeout=300)
        want = {}
        jspec = JaxDenoiseSpec(dit_params=cfg, **SPEC)
        for name, kw in JAX_MESHES.items():
            mesh = make_mesh(**kw)
            with sharding_ctx(mesh):
                want[name] = np.asarray(jax_denoise(
                    shard_dit_params(params, mesh), jspec, jnp.asarray(x0),
                    *(jnp.asarray(np_cond[k]) for k in NAMES),
                    *(jnp.asarray(np_uncond[k]) for k in NAMES),
                    jnp.asarray(skip)))
        # the one-device sequential-CFG run stopped where the ranks stop
        model = ranks_mod.whole_dit(work["cfg"], state)
        path = os.path.join(work["dir"], "single.npz")
        seq = DenoiseSpec(dit_params=pcfg, sequential_cfg=True, **SPEC)
        t = {k: torch.from_numpy(v.copy()) for k, v in np_cond.items()}
        u = {k: torch.from_numpy(v.copy()) for k, v in np_uncond.items()}
        resume.resumable_generate(model, seq, shape, t, u, seed=ranks_mod.SEED,
                                  checkpoint_path=path, magcache=MAG,
                                  chunk=ranks_mod.CHUNK,
                                  _stop_after_chunks=ranks_mod.STOP)
        with np.load(path) as z:
            want["single_residual"] = z["residual"]
        got = future.result()
    return got, want, skip


@pytest.mark.parametrize("name", ["112", "211"])
def test_mesh_resume_is_bit_equal_and_matches_jax(mesh_resume, name):
    """Stopped after two chunks, the run resumes at step 4 to the latents
    of the uninterrupted mesh run, bit for bit, on every rank; those match
    JAX's mesh denoise on the same noise; the state file is gone after."""
    got, want, skip = mesh_resume
    assert skip[4:].any(), "the schedule must skip after the resume"
    for r in got:
        out = r[name]
        assert out["mesh"] == {"112": (1, 1, 2), "211": (2, 1, 1)}[name]
        assert out["stopped"] is None and out["start_step"] == 4
        np.testing.assert_array_equal(out["chunked"], out["generate"])
        np.testing.assert_array_equal(out["resumed"], out["chunked"])
        np.testing.assert_array_equal(out["resumed"], got[0][name]["resumed"])
        assert out["gone"]
    np.testing.assert_allclose(got[0][name]["resumed"], want[name],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["112", "211", "121"])
def test_only_rank0_writes_the_state(mesh_resume, name):
    """Rank 0 saved after each of the two chunks, rank 1 never; one state
    file (no temporary left) at the stop, holding step 4 and the whole
    (b_eff, S, D) residual."""
    got, _, _ = mesh_resume
    assert got[0][name]["saves"] == [2, 4] and got[1][name]["saves"] == []
    for r in got:
        assert r[name]["files"] == ["state.npz"]
    saved = got[0][name]["saved"]
    assert int(saved["step"]) == 4 and saved["residual"].shape == (2, 32, 128)


def test_saved_residual_is_whole_under_dp(mesh_resume):
    """On (2, 1, 1) each rank carries one of the CFG pair's residual rows;
    the file holds both, equal to the one-device sequential-CFG run's (a dp
    rank's call is one of its calls). The control, rank 0 saving its own
    rows in every place, resumes rank 1's branch on the wrong rows and
    misses the latents."""
    got, want, _ = mesh_resume
    out = [r["211"] for r in got]
    assert all(o["carried_residual"].shape == (1, 32, 128) for o in out)
    np.testing.assert_array_equal(out[0]["saved"]["residual"],
                                  want["single_residual"])
    for o in out:
        assert not np.allclose(o["control"], want["211"], rtol=RTOL,
                               atol=ATOL)
        assert not np.array_equal(o["control"], o["resumed"])


@pytest.mark.parametrize("name", ["112", "121"])
def test_residual_is_whole_under_tp_and_sp(mesh_resume, name):
    """Under tp and sp every rank carries the whole residual, the same on
    both ranks (the sp stack's output is gathered at its exit), and the
    saved file holds it; the (1, 2, 1) resume matches JAX's sp mesh."""
    got, want, _ = mesh_resume
    a, b = (r[name]["carried_residual"] for r in got)
    assert a.shape == (2, 32, 128)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][name]["resumed"],
                                  got[0][name]["chunked"])
    np.testing.assert_allclose(got[0][name]["resumed"], want[name],
                               rtol=RTOL, atol=ATOL)


def test_ranks_with_different_fingerprints_raise(mesh_resume):
    """Ranks asked to resume different seeds all raise, before any state
    is read."""
    got, _, _ = mesh_resume
    for r in got:
        assert r["mismatch"] is not None and "fingerprints" in r["mismatch"]


def test_ranks_agree_on_an_unseeded_request(mesh_resume):
    """Each rank's numpy draw differs, yet the ranks denoise and fingerprint
    one seed: rank 0's, broadcast. The resumable request runs (a per-rank
    seed would make the fingerprints differ and raise) and rank 0 alone
    returns the frames."""
    got, _, _ = mesh_resume
    a, b = (r["seedless"] for r in got)
    assert a["seed"] == b["seed"] and a["start_step"] == b["start_step"] == 0
    assert a["frames"].shape == (1, 1, 64, 64, 3) and b["frames"] is None
