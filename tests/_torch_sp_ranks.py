"""What the ranks of ``tests/test_torch_sp.py`` run, in gloo CPU rank
processes started by ``kandinsky5_tpu_torch.parallel.launch`` on a (dp, sp,
tp) mesh. This module imports the port alone (no JAX), so a rank starts
quickly; the test holds what the ranks return against the JAX package's
sp mesh (and, for NABLA and the pipeline, against the port on one
device)."""

from unittest import mock

import numpy as np
import torch

from kandinsky5_tpu_torch import training
from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models import dit as dit_mod
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    SparseParams,
    attend,
    dit_forward,
    fast_init_dit_params,
    sp_rows,
    sta_rows,
)
from kandinsky5_tpu_torch.ops.nabla import record_density
from kandinsky5_tpu_torch.parallel.ranks import rank_mesh
from kandinsky5_tpu_torch.parallel.sharding import (
    shard_dit,
    shard_dit_state_dict,
)
from kandinsky5_tpu_torch.sampling import DenoiseSpec, denoise

from . import _torch_tp_ranks

# the meshes cut from the 8 ranks of the second launch: (ranks, dp, sp)
SUB_MESHES = {"131": ([0, 1, 2], 1, 3), "231": ([0, 1, 2, 3, 4, 5], 2, 3),
              "112": ([0, 1], 1, 1)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dit(mesh, cfg_kw, state_dict):
    """The rank's share of the fp32 DiT holding ``state_dict``."""
    cfg = DiTParams(**cfg_kw)
    model = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32,
                                   tp=mesh.tp, sp=mesh.sp)
    dit_from_state_dict(model, shard_dit_state_dict(state_dict, mesh.tp.rank,
                                                    mesh.tp.size))
    return model


def _denoise(mesh, model, case, skip=None):
    spec = DenoiseSpec(dit_params=model.cfg, **case["spec"])
    cond = {k: _t(v) for k, v in case["cond"].items()}
    uncond = {k: _t(v) for k, v in case["uncond"].items()}
    return denoise(model, spec, _t(case["noise"]), cond, uncond,
                   skip=skip, dp=mesh.dp).numpy()


def _forward(model, case, attn_impl="dense"):
    args = [_t(case["fwd"][k]) for k in ("x", "text", "pooled", "time",
                                         "mask")]
    return dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0),
                       attn_impl=attn_impl).numpy()


@torch.no_grad()
def int8_dit(cfg_kw):
    """The 48-token case's DiT widened to heads of 64 (the int8-QK
    kernels' width), seeded, fp32, on one device, its self-attention
    peaked (QK-norm weights 2), so that the attention's quantization shows
    in the output."""
    model = fast_init_dit_params(
        DiTParams(**dict(cfg_kw, axes_dims=(16, 24, 24))), device="cpu",
        dtype=torch.float32, seed=2, scale=0.05)
    for blk in [*model.text_transformer_blocks,
                *model.visual_transformer_blocks]:
        att = blk.self_attention
        att.query_norm.weight.fill_(2.0)
        att.key_norm.weight.fill_(2.0)
    return model


def without_kv_gather(k, v, sp):
    """The control: each rank attends only to its own shard's keys."""
    return k, v


def rope_rows_from_0(rope, r0, r1, _real=dit_mod.rope_rows):
    """The control: every rank takes the first rows of the RoPE tables."""
    return _real(rope, 0, r1 - r0)


def sta_rows_from_0(sta, r0, r1, _real=dit_mod.sta_rows):
    """The control: every rank takes the first rows of the STA mask."""
    return _real(sta, 0, r1 - r0)


def _block(a, mesh, rows):
    """The rank's (rows, tp heads) block of a (B, L, H, D) array."""
    t = _t(a)
    r0, r1 = rows
    h = t.shape[2] // mesh.tp.size
    return t[:, r0:r1, mesh.tp.rank * h:(mesh.tp.rank + 1) * h].contiguous()


def attend_case(mesh, case, sparse: bool):
    """One self-attention's core on the rank's rows and heads, as the
    sequence-sharded stack runs it: K1's plain version (bf16), or NABLA
    with the rank's rows of the STA mask. Returns the rank's block of the
    output, its (rows, heads) and NABLA's recorded kept fraction; where the
    rows do not split over sp (NABLA: whole 64-token blocks), the call
    runs whole, as the stack then does."""
    q, k, v = case["q"], case["k"], case["v"]
    n = q.shape[1]
    sp = mesh.sp if mesh.sp is not None and mesh.sp.size > 1 else None
    tp = mesh.tp if mesh.tp.size > 1 else None
    par = None
    if sparse:
        par = SparseParams(sta=_t(case["sta"]), P=case["thr"])
    rows = sp_rows(sp, n, par)
    if rows is None:
        rows, sp = (0, n), None
    if par is not None:
        par = par._replace(sta=sta_rows(par.sta, *rows))
    dtype = torch.bfloat16 if case.get("bf16") else torch.float32
    ql, kl, vl = (_block(a, mesh, rows).to(dtype) for a in (q, k, v))
    with record_density() as kept:
        out = attend(ql, kl, vl, None, "flash", par, tp, sp)
    return {"out": out.float().numpy(), "rows": rows,
            "heads": (mesh.tp.rank, mesh.tp.size),
            "kept": [float(x) for x in kept]}


def train_case(model, cases):
    """One fp32 ``train_step_on`` of ``model`` (the tiny DiT, whole or a
    rank's share) on the 48-token latent at t 0.5 and seeded noise: the
    loss, the parameters and whether the state carries the model's sp
    group."""
    fwd = cases["dense48"]["fwd"]
    x0 = _t(fwd["x"])
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(11))
    opt = training.make_optimizer(lr=1e-4)
    state = training.init_train_state(model, opt)
    state, loss = training.train_step_on(
        state, model.cfg, opt, x0, _t(fwd["text"]), _t(fwd["pooled"]),
        _t(fwd["mask"]), torch.tensor([0.5]), noise, attn_impl="dense")
    return {"loss": loss.item(), "state_sp": state.sp is model.sp,
            "params": {k: v.numpy() for k, v in model.state_dict().items()}}


def run_a(mesh, cases):
    """Everything the test asks of the (1, 2, 2) mesh, in one launch: the
    dense denoise (with MagCache's skip schedule and the two controls), K1
    and NABLA at sp = 2, NABLA at sp = 3 on ranks 0-2, the NABLA denoise
    (with its control) and the pipeline."""
    torch.set_num_threads(1)
    out = {"shape": mesh.shape}
    dense = cases["dense"]
    model = _dit(mesh, *cases["dits"]["tiny"])
    mesh.sp.reset_stats()
    out["denoise"] = _denoise(mesh, model, dense)
    out["sp_gathers"] = mesh.sp.calls
    skip_case = cases["skip"]
    out["denoise_skip"] = _denoise(mesh, model, skip_case,
                                   skip=skip_case["skip"])
    with mock.patch.object(dit_mod, "gather_kv", without_kv_gather):
        out["no_kv_gather"] = _denoise(mesh, model, dense)
    with mock.patch.object(dit_mod, "rope_rows", rope_rows_from_0):
        out["rope_from_0"] = _denoise(mesh, model, dense)

    out["k1"] = attend_case(mesh, cases["k1"], sparse=False)
    out["nabla_sp2"] = attend_case(mesh, cases["nabla_op"], sparse=True)
    sub = rank_mesh([0, 1, 2], 1, 3, "gloo", mesh.device)
    if sub is not None:
        out["nabla_sp3"] = attend_case(sub, cases["nabla_op"], sparse=True)
    sub = rank_mesh([0, 1], 1, 2, "gloo", mesh.device)
    if sub is not None:  # int8-QK attention (K5) on a (1, 2, 1) mesh
        model = shard_dit(int8_dit(cases["dits"]["tiny"][0]), sub)
        out["int8_121"] = _forward(model, cases["dense48"], "flash_int8")
        sub.sp.reset_stats()
        out["train_121"] = train_case(_dit(sub, *cases["dits"]["tiny"]),
                                      cases)
        out["train_121"]["sp_calls"] = sub.sp.calls

    nabla = cases["nabla"]
    model = _dit(mesh, *cases["dits"]["nabla"])
    out["nabla_denoise"] = _denoise(mesh, model, nabla)
    with mock.patch.object(dit_mod, "sta_rows", sta_rows_from_0):
        out["sta_from_0"] = _denoise(mesh, model, nabla)

    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]  # for good: a rank process
    pipe = _torch_tp_ranks.pipeline(mesh)
    out["frames"] = pipe("a test image", time_length=0, width=64, height=64,
                         seed=3 + mesh.rank, expand_prompts=False)
    out["pipe_sp_gathers"] = pipe.timings.get("sp_gather_calls")
    return out


def run_b(mesh, cases):
    """The (2, 2, 2) mesh: where each rank sits, and the dense denoise; then
    meshes cut from its ranks: (1, 3, 1) and (2, 3, 1) forward and denoise
    a 48-token latent, and a (1, 1, 2) tp-alone NABLA denoise."""
    torch.set_num_threads(1)
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "groups": {k: getattr(mesh, k).ranks for k in ("dp", "sp", "tp")}}
    model = _dit(mesh, *cases["dits"]["tiny"])
    out["denoise"] = _denoise(mesh, model, cases["dense"])
    subs = {name: rank_mesh(ranks, dp, sp, "gloo", mesh.device)
            for name, (ranks, dp, sp) in SUB_MESHES.items()}
    for name in ("131", "231"):
        sub = subs[name]
        if sub is None:
            continue
        model = _dit(sub, *cases["dits"]["tiny"])
        sub.sp.reset_stats()
        out[f"forward_{name}"] = _forward(model, cases["dense48"])
        out[f"sp_gathers_{name}"] = sub.sp.calls
        out[f"denoise_{name}"] = _denoise(sub, model, cases["dense48"])
        out[f"shape_{name}"] = sub.shape
    if subs["112"] is not None:
        sub = subs["112"]
        out["nabla_tp"] = _denoise(sub, _dit(sub, *cases["dits"]["nabla"]),
                                   cases["nabla"])
    return out
