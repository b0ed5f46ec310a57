"""What the ranks of ``tests/test_torch_train_mesh.py`` run: one launch of 8
gloo CPU ranks on the (2, 2, 2) mesh, from whose ranks three smaller meshes
are cut (``SUB_MESHES``, on disjoint ranks, so that they run side by side).
On each mesh a rank computes the whole gradients of the tiny DiT and one
step with the clip active and inactive, on its dp rows of the global batch
at the t and noise the test hands it; the controls and the save / restore
run where ``CONTROLS`` and ``RESUME_MESH`` say. This module imports the
port alone (no JAX); the test holds what the ranks return against the JAX
package."""

import contextlib
from unittest import mock

import numpy as np
import torch

from kandinsky5_tpu_torch import training
from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models import dit as dit_mod
from kandinsky5_tpu_torch.models import nn as nn_mod
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
from kandinsky5_tpu_torch.parallel import ranks
from kandinsky5_tpu_torch.parallel.ranks import rank_mesh
from kandinsky5_tpu_torch.parallel.sharding import shard_dit_state_dict

# name: (global ranks, dp, sp); tp = ranks / (dp sp)
SUB_MESHES = {"112": ([4, 5], 1, 1), "121": ([6, 7], 1, 2),
              "122": ([0, 1, 2, 3], 1, 2)}
MESHES = ("112", "121", "122", "222")
CLIPS = (1.0, 1e6)
# control: (mesh, what it returns)
CONTROLS = {"no_column_copy": ("112", "grads"),
            "qk_norm_partial": ("112", "grads"),
            "kv_gather_no_reduce_scatter": ("121", "grads"),
            "exit_gather_sums": ("121", "grads"),
            "rank_local_clip": ("112", "step")}
RESUME_MESH = "122"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def _model(mesh, work):
    """The rank's share of the fp32 DiT holding ``work["state"]``, running
    its collectives over the mesh's tp and sp groups."""
    cfg = DiTParams(**work["cfg"])
    model = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32,
                                   tp=mesh.tp, sp=mesh.sp)
    dit_from_state_dict(model, shard_dit_state_dict(
        work["state"], mesh.tp.rank, mesh.tp.size))
    return model


def _rows(mesh, work):
    """The rank's dp rows of the batch, t and noise."""
    n = len(work["t"]) // mesh.dp.size
    rows = slice(mesh.dp.rank * n, (mesh.dp.rank + 1) * n)
    return ([_t(a)[rows] for a in work["batch"]], _t(work["t"])[rows],
            _t(work["noise"])[rows])


def _state(mesh, work, clip=1.0, model=None):
    opt = training.make_optimizer(lr=work["lr"], clip=clip)
    model = _model(mesh, work) if model is None else model
    return opt, training.shard_train_state(
        training.init_train_state(model, opt), mesh)


def grads(mesh, work) -> dict:
    """The loss and the rank's whole gradients (tp shares), by name."""
    _, state = _state(mesh, work)
    batch, t, noise = _rows(mesh, work)
    loss, gs = training.loss_and_gradients(
        state, state.model.cfg, *batch, t, noise, attn_impl="dense")
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    return {"loss": loss.item(), "grads": _np(dict(zip(names, gs)))}


def step(mesh, work, clip: float) -> dict:
    """One ``train_step_on``: the loss, the parameters (tp shares), the
    moments (ZeRO-1 slices of them) and their ZeRO-1 dims, by name."""
    opt, state = _state(mesh, work, clip)
    batch, t, noise = _rows(mesh, work)
    state, loss = training.train_step_on(state, state.model.cfg, opt, *batch,
                                         t, noise, attn_impl="dense")
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    dims = state.opt_state.get("dims") or [None] * len(names)
    return {"loss": loss.item(), "params": _np(state.model.state_dict()),
            **{k: _np(dict(zip(names, state.opt_state[k])))
               for k in ("mu", "nu")},
            "dims": dict(zip(names, dims)), "step": state.step}


def _identity_on_activations(x, group, _real=ranks.copy_to):
    """``copy_to`` left out before the column-parallel linears: kept for
    the QK norms' weights (Parameters) alone."""
    return _real(x, group) if isinstance(x, torch.nn.Parameter) else x


def _plain_qk_weights(p, tp=None):
    return p.query_norm.weight, p.key_norm.weight


def _kv_gather_no_reduce_scatter(k, v, sp):
    return (ranks.gather_whole(k, sp, 1), ranks.gather_whole(v, sp, 1))


def _rank_local_norm(grads, sharded=None, tp=None,
                     _real=training.global_norm):
    return _real(grads)


def control(mesh, work, name: str) -> dict:
    """The job of ``CONTROLS[name]`` with its fault patched in."""
    patches = {
        "no_column_copy": [(nn_mod, "copy_to", _identity_on_activations),
                           (dit_mod, "copy_to", _identity_on_activations)],
        "qk_norm_partial": [(nn_mod, "qk_norm_weights", _plain_qk_weights),
                            (dit_mod, "qk_norm_weights", _plain_qk_weights)],
        "kv_gather_no_reduce_scatter": [
            (dit_mod, "gather_kv", _kv_gather_no_reduce_scatter)],
        # the all-gather of torch.distributed.nn: a reduce-scatter backward
        "exit_gather_sums": [(dit_mod, "gather_whole", ranks.gather_along)],
        "rank_local_clip": [(training, "global_norm", _rank_local_norm)],
    }[name]
    with contextlib.ExitStack() as stack:
        for mod, attr, fn in patches:
            stack.enter_context(mock.patch.object(mod, attr, fn))
        if CONTROLS[name][1] == "grads":
            return grads(mesh, work)
        return step(mesh, work, CLIPS[0])


def resume(mesh, work) -> dict:
    """Two ``train_step``s uninterrupted against a save after step 1, a
    restore into a fresh sharded state (its parameters zero) and step 2:
    whether the loss, every parameter and every moment are bit-equal; the
    path each rank was given, how many files the rank wrote and its shares
    after step 1 (which its (dp, tp) index's file must hold)."""
    opt, s0 = _state(mesh, work)
    batch = [_t(a) for a in work["batch"]]
    cfg = s0.model.cfg
    s1, _ = training.train_step(s0, cfg, opt, *batch,
                                torch.Generator().manual_seed(5),
                                attn_impl="dense")
    at_1 = _np(s1.model.state_dict())
    with mock.patch.object(torch, "save", wraps=torch.save) as saved:
        path = training.save_train_state(s1, work["ckpt"], s1.step)
    s2, loss = training.train_step(s1, cfg, opt, *batch,
                                   torch.Generator().manual_seed(6),
                                   attn_impl="dense")
    fresh = _model(mesh, work)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    _, like = _state(mesh, work, model=fresh)
    restored = training.load_train_state(work["ckpt"], like)
    r2, rloss = training.train_step(restored, cfg, opt, *batch,
                                    torch.Generator().manual_seed(6),
                                    attn_impl="dense")
    equal = (rloss.item() == loss.item() and restored.step == 1
             and all(torch.equal(a, b) for a, b in zip(
                 fresh.state_dict().values(), s2.model.state_dict().values()))
             and all(torch.equal(a, b) for k in ("mu", "nu")
                     for a, b in zip(r2.opt_state[k], s2.opt_state[k])))
    return {"path": path, "written": saved.call_count, "at_1": at_1,
            "bit_equal": equal, "loss": loss.item()}


def mesh_jobs(mesh, work, name: str) -> dict:
    """Everything the test asks of mesh ``name`` on this rank; the arrays
    only from the ranks of sp index 0 (every rank returns its loss and a
    checksum of each result, which the test holds equal across the sp
    ranks)."""
    jobs = {"grads": grads(mesh, work)}
    for clip in CLIPS:
        jobs[f"step_{clip:g}"] = step(mesh, work, clip)
    for ctl, (where, _) in CONTROLS.items():
        if where == name:
            jobs[ctl] = control(mesh, work, ctl)
    if name == RESUME_MESH:
        jobs["resume"] = resume(mesh, work)
    sp_index = 0 if mesh.sp is None else mesh.sp.rank
    out = {"shape": mesh.shape, "index": (mesh.dp.rank, sp_index,
                                          mesh.tp.rank)}
    for job, res in jobs.items():
        sums = {k: {n: float(np.sum(a, dtype=np.float64))
                    for n, a in v.items()}
                for k, v in res.items() if k in ("grads", "params", "mu",
                                                 "nu")}
        keep = res if sp_index == 0 or job == "resume" else {
            k: v for k, v in res.items() if not isinstance(v, dict)
            or k == "dims"}
        out[job] = dict(keep, sums=sums)
    return out


def run(mesh, work):
    """Every sub-mesh is cut first (group creation is collective), then
    the (2, 2, 2) mesh's jobs run on all ranks, then each sub-mesh's on its
    ranks."""
    torch.set_num_threads(1)
    subs = {name: rank_mesh(r, dp, sp, "gloo", "cpu")
            for name, (r, dp, sp) in SUB_MESHES.items()}
    out = {"222": mesh_jobs(mesh, work, "222")}
    for name, sub in subs.items():
        if sub is not None:
            out[name] = mesh_jobs(sub, work, name)
    return out
