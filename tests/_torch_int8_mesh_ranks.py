"""What the ranks of ``tests/test_torch_int8_mesh.py`` run, in gloo CPU rank
processes started by ``kandinsky5_tpu_torch.parallel.launch`` on a (1, 2,
2) mesh, from which a (1, 1, 4) mesh is cut. This module imports the port
alone (no JAX), so a rank starts quickly; the test holds what the ranks
return against the JAX package's meshes and the port on one device.

The W8A8 linear's faults (:func:`row_parallel_i8`) are shared with
``chip_smoke.py``'s phase 5d."""

from unittest import mock

import numpy as np
import torch
from torch import nn

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models import nn as port_nn
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    attend,
    dit_forward,
    fast_init_dit_params,
    quantize_dit_params,
    sp_rows,
)
from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.ops.attention import attention
from kandinsky5_tpu_torch.parallel.ranks import rank_mesh
from kandinsky5_tpu_torch.parallel.sharding import (
    fast_init_dit_shard,
    shard_dit,
)

from . import _torch_tp_ranks

# the pipeline's DiT widened to 4 heads of 64, so that tp 4 splits them
PIPE_WIDE = dict(model_dim=256, ff_dim=512)
# the faults a row-parallel W8A8 linear must not resemble: each rank's own
# activation scale (no max all-reduce); a weight scale from the rank's
# slice (quantized alone); the bias added on every rank (each rank
# dequantizes its partial product and adds the bias, then the sum)
FAULTS = ("rank_sx", "slice_w_scale", "bias_on_every_rank")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _linear(w, b, dtype):
    """An ``nn.Linear`` holding the (out, in) weight ``w`` and bias ``b``."""
    layer = nn.Linear(w.shape[1], w.shape[0], device=w.device, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(torch.as_tensor(w))
        layer.bias.copy_(torch.as_tensor(b))
    return layer


def row_parallel_i8(w, b, x, tp, fault=None):
    """The row-parallel W8A8 linear on rank ``tp.rank``'s input columns of
    the whole (out, in) weight ``w`` (bias ``b``) and input ``x``, as the
    port runs it (``quantize_linear(local, tp)``, then
    ``row_parallel_linear``), or with one of :data:`FAULTS`."""
    n = w.shape[1] // tp.size
    cols = slice(tp.rank * n, (tp.rank + 1) * n)
    local = _linear(w[:, cols], b, x.dtype)
    layer = port_nn.quantize_linear(
        local, None if fault == "slice_w_scale" else tp)
    xs = x[..., cols].contiguous()
    if fault in (None, "slice_w_scale"):
        return port_nn.row_parallel_linear(layer, xs, tp)
    x8, sx = port_nn.quantize_activations(
        xs, None if fault == "rank_sx" else tp)
    s32 = port_nn._int8_product(x8.reshape(-1, n), layer.weight_i8)
    s32 = s32.reshape(*x.shape[:-1], -1)
    if fault == "rank_sx":  # partials at different scales: dequantize first
        y = tp.all_reduce(s32.float() * sx * layer.w_scale)
        return (y + layer.bias.float()).to(x.dtype)
    return tp.all_reduce(port_nn.dequantize(s32, sx, layer, torch.float32)
                         ).to(x.dtype)


def column_parallel_i8(w, b, x, tp):
    """The column-parallel W8A8 linear: the rank's rows of ``w`` and ``b``
    quantized alone (a row's scale is over its whole in axis already)."""
    n = w.shape[0] // tp.size
    rows = slice(tp.rank * n, (tp.rank + 1) * n)
    layer = port_nn.quantize_linear(_linear(w[rows], b[rows], x.dtype))
    return port_nn.linear(layer, x)


@torch.no_grad()
def linears(tp, case):
    """Each dtype's row-parallel output, its faults' and the column-parallel
    output (the rank's columns), as fp32 numpy."""
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        w, b, x = (_t(case[k]).to(dtype) for k in ("w", "b", "x"))
        for fault in (None,) + FAULTS:
            y = row_parallel_i8(w, b, x, tp, fault)
            out[f"{name}_row_{fault}"] = y.float().numpy()
        wc, bc = _t(case["wc"]).to(dtype), _t(case["bc"]).to(dtype)
        out[f"{name}_col"] = column_parallel_i8(wc, bc, x, tp).float().numpy()
    return out


def local_quantization(mesh, cfg_kw):
    """The names where ``fast_init_dit_shard(int8_linear=True)`` differs from
    slicing the whole model's ``quantize_dit_params`` (none, bit for bit),
    and how many tensors were compared."""
    cfg = DiTParams(**cfg_kw)
    local = fast_init_dit_shard(cfg, mesh, dtype=torch.float32, seed=3,
                                int8_linear=True)
    whole = quantize_dit_params(fast_init_dit_params(
        cfg, device="cpu", dtype=torch.float32, seed=3))
    sliced = shard_dit(whole, mesh).state_dict()
    got = local.state_dict()
    return {"differ": sorted(k for k in sliced
                             if k not in got or not torch.equal(got[k],
                                                                sliced[k])),
            "compared": len(sliced), "extra": sorted(set(got) - set(sliced))}


def forced_forward(mesh, model, args, records):
    """The forward with every W8A8 linear taking the JAX mesh run's own
    input to it (``records``: (x, y) numpy pairs in the port's call order;
    the rank's columns of x where the layer is row parallel, its rows of y
    where it is column parallel). Returns the output and the largest
    relative gaps: the port's own input against JAX's, and the linear's
    output on JAX's input against JAX's."""
    real = port_nn._linear_i8
    ops = iter(records)
    gaps = {"x": 0.0, "y": 0.0, "ops": 0}
    r = mesh.tp.rank

    def forced(layer, x, tp=None):
        xj, yj = (_t(a) for a in next(ops))
        if tp is not None:
            k = x.shape[-1]
            xj = xj[..., r * k:(r + 1) * k]
        else:
            n = layer.weight_i8.shape[0]
            yj = yj[..., r * n:(r + 1) * n]
        gaps["x"] = max(gaps["x"], float((x - xj).abs().max()
                                         / xj.abs().max()))
        y = real(layer, xj.contiguous(), tp)
        gaps["y"] = max(gaps["y"], float((y - yj).abs().max()
                                         / yj.abs().max()))
        gaps["ops"] += 1
        return y

    with mock.patch.object(port_nn, "_linear_i8", forced):
        y = dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0),
                        attn_impl="dense")
    gaps["left"] = sum(1 for _ in ops)
    return y.numpy(), gaps


def attention_case(mesh, case):
    """K5's plain version on the rank's rows and heads: self-attention with
    K and V gathered over sp (``attend``), and cross-attention with the
    rank's queries against whole masked keys (the short-KV rule on the
    global query length). Returns each output's block and its place."""
    q, k, v, kc, vc, m = (case[n] for n in ("q", "k", "v", "kc", "vc", "mask"))
    rows = sp_rows(mesh.sp, q.shape[1])
    h = q.shape[2] // mesh.tp.size
    heads = slice(mesh.tp.rank * h, (mesh.tp.rank + 1) * h)

    def block(a, rs=slice(*rows)):
        return _t(a)[:, rs, heads].to(torch.bfloat16).contiguous()

    out = attend(block(q), block(k), block(v), None, "flash_int8",
                 tp=mesh.tp, sp=mesh.sp)
    cross = attention(block(q), block(kc, slice(None)), block(vc, slice(None)),
                      kv_mask=_t(m), impl="flash_int8", q_len=q.shape[1])
    place = {"rows": rows, "heads": (mesh.tp.rank, mesh.tp.size)}
    return {"self": dict(place, out=out.float().numpy()),
            "cross": dict(place, out=cross.float().numpy())}


def int8_pipeline(mesh, impl):
    """The tiny pipeline's 2-step image with ``impl`` and W8A8 on ``mesh``:
    the latents it decodes (every rank) and its K5 route's calls."""
    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]  # for good: a rank process
    pipe = _torch_tp_ranks.pipeline(mesh, dit_kw=PIPE_WIDE, attn_impl=impl,
                                    int8_linear=True)
    kept = []
    real = pipe.decode_latents

    def keep(latents, mode=None):
        kept.append(latents.clone())
        return real(latents, mode)

    pipe.decode_latents = keep
    pipe("a test image", time_length=0, width=64, height=64, seed=3,
         expand_prompts=False)
    return {"latents": kept[0].numpy(), "quantized": pipe.int8_linear,
            "shape": mesh.shape}


@torch.no_grad()
def run(mesh, cases):
    """Everything the test asks of the (1, 2, 2) mesh and the (1, 1, 4)
    mesh cut from its ranks, in one launch."""
    torch.set_num_threads(1)
    mesh4 = rank_mesh(range(4), 1, 1, "gloo", mesh.device)
    out = {"shape": mesh.shape, "shape4": mesh4.shape}
    out["linears_tp2"] = linears(mesh.tp, cases["linear"])
    out["linears_tp4"] = linears(mesh4.tp, cases["linear"])
    out["rows_tp2"], out["rows_tp4"] = mesh.tp.rank, mesh4.tp.rank
    out["local_122"] = local_quantization(mesh, cases["tiny_i8"])
    out["local_114"] = local_quantization(mesh4, cases["tiny_i8"])

    cfg_kw, state_dict, fwd, records = cases["forward"]
    whole = DiffusionTransformer3D(DiTParams(**cfg_kw), device="cpu",
                                   dtype=torch.float32)
    dit_from_state_dict(whole, state_dict)
    local = shard_dit(quantize_dit_params(whole), mesh4)
    args = [_t(fwd[k]) for k in ("x", "text", "pooled", "time", "mask")]
    out["forward"] = dit_forward(local, *args, scale_factor=(1.0, 2.0, 2.0),
                                 attn_impl="dense").numpy()
    out["forced"], out["gaps"] = forced_forward(mesh4, local, args, records)

    out["attention"] = attention_case(mesh, cases["attention"])
    out["pipe_122"] = int8_pipeline(mesh, "flash_int8")
    out["pipe_114"] = int8_pipeline(mesh4, "flash_int8_pipe")
    return out
