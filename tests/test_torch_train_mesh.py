"""Training on the mesh: the port's trainer on (dp, sp, tp) gloo CPU ranks
against the JAX package's on the CPU.

``tests/test_torch_training.py``'s config (a 128-wide DiT, 8 heads, one
text and two visual blocks, fp32, dense attention, batch 4 of a 2 x 8 x 8
latent: 32 visual tokens), with every parameter drawn from a seeded numpy
generator and handed to both packages, on the (1, 1, 2), (1, 2, 1), (1, 2,
2) and (2, 2, 2) meshes. One launch of 8 ranks (``tests/
_torch_train_mesh_ranks.py``, no JAX) runs the (2, 2, 2) mesh, then the
three smaller ones side by side on disjoint ranks; JAX computes its side in
the test process while they run.

* The whole gradients (``training.loss_and_gradients``: the sp-partial
  ones summed over sp, the mean over dp), the tp shares assembled, against
  JAX's ``value_and_grad`` of ``flow_matching_loss`` on one device: rtol
  1e-4, atol 1e-4 of each tensor's largest gradient
  (``tests/test_torch_training.py``'s bound).
* One ``train_step_on`` at JAX's t and noise, with the clip active (1.0:
  the norm is above it) and inactive (1e6), against JAX's ``train_step``
  under ``sharding_ctx(make_mesh(n, dp=, sp=))`` with the parameters placed
  by ``shard_dit_params`` and the moments by ``shard_train_state``. Its
  body runs under one ``jax.jit`` with the clip as a traced argument (so
  both clips share a compile); it is ``train_step``'s own code. Every
  parameter at rtol 2e-4, atol 2e-5 (``tests/test_training_zero.py``'s
  bound). Adam's first step is blind to a gradient's scale (u = g / |g|), so
  the clip shows in the moments: mu and nu, assembled from the tp shares
  and ZeRO-1 slices, at rtol 2e-4 and atol 2e-4 of each tensor's largest
  value.
* Controls that must fail those bounds: no backward all-reduce before the
  column-parallel linears, the QK norms' gradients left partial over tp,
  the K/V gather without its reduce-scatter, an exit gather whose backward
  sums over the ranks (``torch.distributed.nn``'s), and the rank-local
  clip norm with the clip active.
* Save and restore on (1, 2, 2): bit-equal to the uninterrupted run, one
  file per (dp, tp) index, written by sp rank 0 alone, holding its tp
  index's shares.
"""

import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu import training as jt
from kandinsky5_tpu.parallel.sharding import (
    make_mesh,
    shard_dit_params,
    sharding_ctx,
)
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.parallel.sharding import split_dim

from . import _torch_train_mesh_ranks as ranks_mod
from .test_torch_training import _jax_draws, _setup

KEY = jax.random.PRNGKey(5)
LR = 1e-4
# mesh name: (JAX devices, dp, sp)
JAX_MESHES = {"112": (2, 1, 1), "121": (2, 1, 2), "122": (4, 1, 2),
              "222": (8, 2, 2)}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
MOMENT_RTOL, MOMENT_ATOL = 2e-4, 2e-4


def _named(tree):
    return dit_state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _jax_side(jcfg, jparams, batch, t, noise):
    """JAX's one-device gradients and its sharded step on every mesh, both
    clips."""
    jb = [jnp.asarray(a) for a in batch]

    def loss_fn(p):
        return jt.flow_matching_loss(p, jcfg, *jb, jnp.asarray(t),
                                     jnp.asarray(noise), attn_impl="dense")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    want = {"loss": float(loss), "grads": _named(grads)}

    def step(state, clip, *b):
        opt = jt.make_optimizer(lr=LR, clip=clip)
        return jt.train_step.__wrapped__(state, jcfg, opt, *b, KEY,
                                         attn_impl="dense")

    for name, (n, dp, sp) in JAX_MESHES.items():
        mesh = make_mesh(n_devices=n, dp=dp, sp=sp)
        opt = jt.make_optimizer(lr=LR)
        state = jt.shard_train_state(
            jt.init_train_state(shard_dit_params(jparams, mesh), opt), mesh)
        with sharding_ctx(mesh):
            fn = jax.jit(step)
            for clip in ranks_mod.CLIPS:
                out, loss = fn(state, jnp.float32(clip), *jb)
                adam = out.opt_state[1][0]
                want[f"{name}_step_{clip:g}"] = {
                    "loss": float(loss), "params": _named(out.params),
                    "mu": _named(adam.mu), "nu": _named(adam.nu)}
    return want


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The launch's results by mesh and rank, JAX's side, the work."""
    jcfg, _, jparams, _, batch = _setup()
    t, noise = _jax_draws(batch[0], KEY)
    work = dict(cfg=dataclasses.asdict(jcfg),
                state=_named(jparams), batch=[np.asarray(a) for a in batch],
                t=t, noise=noise, lr=LR,
                ckpt=str(tmp_path_factory.mktemp("train_mesh")))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run, 8, "gloo", "cpu",
                             args=(work,), timeout=600, dp=2, sp=2)
        want = _jax_side(jcfg, jparams, batch, t, noise)
        got = future.result()
    by_mesh = {name: [r[name] for r in got if name in r]
               for name in ranks_mod.MESHES}
    return by_mesh, want, work


def _parts(results, job):
    """{(dp, tp): the job's result} from the ranks of sp index 0, after
    checking that every sp rank's loss and checksums equal its sp rank 0's
    (the sp ranks of a (dp, tp) index hold one state)."""
    first = {(r["index"][0], r["index"][2]): r[job] for r in results
             if r["index"][1] == 0}
    for r in results:
        d, _, tp = r["index"]
        assert r[job]["loss"] == first[d, tp]["loss"]
        assert r[job]["sums"] == first[d, tp]["sums"], (job, r["index"])
    return first


def _assemble(parts, key):
    """The whole tensors of ``key`` from the (dp, tp) parts: the ZeRO-1
    slices of a moment joined along its dim over dp, then the tp shares
    along ``split_dim``."""
    dps = 1 + max(d for d, _ in parts)
    tps = 1 + max(t for _, t in parts)
    out = {}
    for name in parts[0, 0][key]:
        shares = []
        for t in range(tps):
            pieces = [parts[d, t][key][name] for d in range(dps)]
            dim = parts[0, t]["dims"][name] if key in ("mu", "nu") else None
            shares.append(pieces[0] if dim is None
                          else np.concatenate(pieces, dim))
        dim = split_dim(name) if tps > 1 else None
        out[name] = shares[0] if dim is None else np.concatenate(shares, dim)
    return out


def _grads_close(got, want) -> bool:
    assert got.keys() == want.keys()
    return all(np.allclose(got[k], want[k], rtol=GRAD_RTOL,
                           atol=GRAD_ATOL * np.abs(want[k]).max())
               for k in want)


def _step_close(parts, want) -> bool:
    params = _assemble(parts, "params")
    assert params.keys() == want["params"].keys()
    ok = all(np.allclose(params[k], want["params"][k], rtol=STEP_RTOL,
                         atol=STEP_ATOL) for k in want["params"])
    for key in ("mu", "nu"):
        got = _assemble(parts, key)
        assert got.keys() == want[key].keys()
        ok = ok and all(np.allclose(
            got[k], want[key][k], rtol=MOMENT_RTOL,
            atol=MOMENT_ATOL * np.abs(want[key][k]).max()) for k in got)
    return ok


@pytest.mark.parametrize("mesh", ranks_mod.MESHES)
def test_mesh_gradients_match_jax(trained, mesh):
    """Every parameter's whole gradient on the mesh, the tp shares
    assembled, against JAX's one-device gradient; the loss is the global
    mean on every rank."""
    by_mesh, want, _ = trained
    results = by_mesh[mesh]
    shape = tuple(int(c) for c in mesh)
    assert len(results) == np.prod(shape)
    assert all(r["shape"] == shape for r in results)
    parts = _parts(results, "grads")
    np.testing.assert_allclose(parts[0, 0]["loss"], want["loss"], rtol=1e-4)
    got = _assemble(parts, "grads")
    assert got.keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=f"{mesh} {k}")


@pytest.mark.parametrize("clip", ranks_mod.CLIPS,
                         ids=["clip-active", "clip-inactive"])
@pytest.mark.parametrize("mesh", ranks_mod.MESHES)
def test_mesh_step_matches_jax_sharded_step(trained, mesh, clip):
    """One step on the mesh: the loss, every parameter and both moments
    against JAX's sharded ``train_step`` on the same mesh."""
    by_mesh, want, _ = trained
    w = want[f"{mesh}_step_{clip:g}"]
    parts = _parts(by_mesh[mesh], f"step_{clip:g}")
    assert all(p["step"] == 1 for p in parts.values())
    np.testing.assert_allclose(parts[0, 0]["loss"], w["loss"], rtol=1e-4)
    params = _assemble(parts, "params")
    for k, v in w["params"].items():
        np.testing.assert_allclose(params[k], v, rtol=STEP_RTOL,
                                   atol=STEP_ATOL, err_msg=f"{mesh} {k}")
    for key in ("mu", "nu"):
        got = _assemble(parts, key)
        for k, v in w[key].items():
            np.testing.assert_allclose(
                got[k], v, rtol=MOMENT_RTOL,
                atol=MOMENT_ATOL * np.abs(v).max(), err_msg=f"{key} {k}")
    if mesh == "222":  # ZeRO-1: the moments are dp slices
        assert any(d is not None for d in parts[0, 0]["dims"].values())


def test_clip_is_active_at_1(trained):
    """The gradients' global norm is above 1.0, so the clip-active step
    clips and the 1e6 one does not."""
    _, want, _ = trained
    norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                       for g in want["grads"].values()))
    assert 1.0 <= norm < 1e6, norm


@pytest.mark.parametrize("control", list(ranks_mod.CONTROLS))
def test_mesh_controls_fail(trained, control):
    """Each fault fails the bound its job is held to above, on the mesh
    where it shows (tp faults on (1, 1, 2), sp faults on (1, 2, 1))."""
    by_mesh, want, _ = trained
    mesh, kind = ranks_mod.CONTROLS[control]
    parts = {(r["index"][0], r["index"][2]): r[control]
             for r in by_mesh[mesh] if r["index"][1] == 0}
    if kind == "grads":
        assert not _grads_close(_assemble(parts, "grads"), want["grads"])
    else:
        # the same step unpatched passes (test_mesh_step_matches_jax...)
        assert _step_close(_parts(by_mesh[mesh], "step_1"),
                           want[f"{mesh}_step_1"])
        assert not _step_close(parts, want[f"{mesh}_step_1"])


def test_mesh_save_restore_resumes_bit_equal(trained):
    """On (1, 2, 2): step 2 after a save at step 1 and a restore into a
    fresh sharded state equals the uninterrupted step 2 bit for bit on
    every rank; the step's directory holds one file per tp index (dp is
    1), each written once, by its sp rank 0, holding that tp index's
    shares after step 1."""
    by_mesh, _, work = trained
    results = by_mesh[ranks_mod.RESUME_MESH]
    assert len(results) == 4
    files = sorted(os.listdir(os.path.join(work["ckpt"], "1")))
    assert files == ["train_state.tp0of2.pt", "train_state.tp1of2.pt"]
    for r in results:
        _, s, t = r["index"]
        res = r["resume"]
        assert res["bit_equal"], r["index"]
        assert res["written"] == (1 if s == 0 else 0), r["index"]
        assert os.path.basename(res["path"]) == files[t]
        saved = torch.load(res["path"], map_location="cpu",
                           weights_only=True)["model"]
        assert saved.keys() == res["at_1"].keys()
        for k, v in res["at_1"].items():
            np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)
    # the two files hold different shares of a column-parallel weight
    name = "visual_transformer_blocks.0.self_attention.to_query.weight"
    a, b = (torch.load(os.path.join(work["ckpt"], "1", f), map_location="cpu",
                       weights_only=True)["model"][name] for f in files)
    assert a.shape == (64, 128) and not torch.equal(a, b)
