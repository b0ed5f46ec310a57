"""The DiT's (dp, sp, tp) plan: which parameters each rank holds.

Counterpart of ``kandinsky5_tpu/parallel/sharding.py``. The reference
shards the DiT with a DTensor plan over 1, 2 or 4 GPUs (``parallelize.py``;
torchrun world size): head-sharded Q/K/V (column parallel), row-parallel
attention and FF out layers, column-parallel FF in layer, replicated
modulation, embeddings, text blocks and out layer. The JAX package's mesh
adds a data axis (dp) and a sequence axis (sp), and :func:`plan_dit_mesh`
takes for tp the largest device count that divides the heads, the rest
for sp. The port runs all three (``parallel/ranks.py`` ``RankMesh``): a
rank holds the tp share of its tp index, the same on every sp and dp rank;
sp cuts the visual tokens inside the DiT (``models/dit.py``), dp the batch
in the sampler, the tiles in the decode and the moments in the trainer.

Specs are in the port's names and torch layouts: a linear weight is (out,
in), so column parallel splits dim 0 and row parallel dim 1. A W8A8 model
(``models/dit.py`` ``quantize_dit_params``) shards as the JAX
``_adapt_quantized_specs`` places it: ``weight_i8`` as the weight, the
per-out-channel ``w_scale`` with its columns where the layer is column
parallel and whole where it is row parallel. :func:`shard_dit` slices a
model quantized whole; :func:`fast_init_dit_shard` with ``int8_linear``
quantizes the rank's slices, taking a row-parallel scale from the max over
the tp group (the same codes and scales, bit for bit).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.parallel.ranks import RankMesh, as_mesh


def plan_dit_mesh(n_devices: int, num_heads: int = 28,
                  dp: int = 1) -> Tuple[int, int, int]:
    """(dp, sp, tp) for ``n_devices``, by the JAX rule: tp is the largest
    divisor of the per-dp device count that also divides ``num_heads``
    (whole heads per device), the rest is sp. 1 -> (1, 1, 1), 2 -> (1, 1,
    2), 4 -> (1, 1, 4), 8 -> (1, 2, 4) for 28 heads."""
    if n_devices % dp:
        raise ValueError(f"dp={dp} must divide {n_devices} devices")
    per = n_devices // dp
    tp = next(t for t in range(per, 0, -1)
              if per % t == 0 and num_heads % t == 0)
    return dp, per // tp, tp


def plan_hybrid_mesh(tp: int, ranks_per_node: int,
                     nodes: int) -> Tuple[int, int, int]:
    """(dp, sp, tp) over ``nodes`` hosts of ``ranks_per_node`` ranks each, by
    the JAX factory's multi-host rule (``get_T2V_pipeline(tp=)`` with more
    than one process): ``tp`` is the width of each tp row and must divide a
    host's ranks, the host's other ranks become dp (dp_ici = ranks per node
    / tp), and dp spans the hosts: dp = nodes x dp_ici, no sp
    (``make_hybrid_mesh``; the ranks' layout is ``ranks.hybrid_rank_grid``).
    """
    if tp < 1 or ranks_per_node < 1 or nodes < 1:
        raise ValueError(f"tp={tp}, {ranks_per_node} ranks per node and "
                         f"{nodes} nodes must be positive")
    if ranks_per_node % tp:
        raise ValueError(f"tp={tp} must divide the {ranks_per_node} ranks of "
                         "a node: a tp row may not cross hosts")
    return nodes * (ranks_per_node // tp), 1, tp


def tp_width(plan: Tuple[int, int, int]) -> int:
    """The tp width of a (dp, sp, tp) plan: its tp."""
    return plan[2]


def _quantized(weight: Optional[int], **rest) -> dict:
    """A linear's split dims with its W8A8 leaves (the JAX
    ``_adapt_quantized_specs``): ``weight_i8`` as the weight; ``w_scale``
    (out,) keeps the weight's split without its in axis: split with a
    column-parallel layer's rows, whole for a row-parallel one."""
    return dict(weight=weight, weight_i8=weight,
                w_scale=0 if weight == 0 else None, **rest)


# split dim of each parameter under tp: 0 = column parallel (output rows),
# 1 = row parallel (input columns), None = replicated
_ATTN = {
    "to_query": _quantized(0, bias=0),
    "to_key": _quantized(0, bias=0),
    "to_value": _quantized(0, bias=0),
    # row parallel: each rank's product is a partial sum, all-reduced
    # before the bias is added once
    "out_layer": _quantized(1, bias=None),
    "query_norm": {"weight": None},
    "key_norm": {"weight": None},
}


def dit_param_specs() -> dict:
    """Split dim of every DiT parameter, keyed like the module tree without
    block indices (the JAX ``dit_param_specs``, whose leaves carry a
    stacked-block axis, in torch layouts)."""
    lin = {"weight": None, "bias": None}
    rep = lambda tree: {k: rep(v) if isinstance(v, dict) else None  # noqa: E731
                        for k, v in tree.items()}
    return {
        "time_embeddings": {"in_layer": dict(lin), "out_layer": dict(lin)},
        "text_embeddings": {"in_layer": dict(lin), "norm": dict(lin)},
        "pooled_text_embeddings": {"in_layer": dict(lin), "norm": dict(lin)},
        "visual_embeddings": {"in_layer": dict(lin)},
        # text blocks replicated, as the reference leaves them
        "text_transformer_blocks": {
            "text_modulation": {"out_layer": dict(lin)},
            "self_attention": rep(_ATTN),
            "feed_forward": {"in_layer": {"weight": None},
                             "out_layer": {"weight": None}},
        },
        "visual_transformer_blocks": {
            "visual_modulation": {"out_layer": dict(lin)},
            "self_attention": {k: dict(v) for k, v in _ATTN.items()},
            "cross_attention": {k: dict(v) for k, v in _ATTN.items()},
            "feed_forward": {"in_layer": _quantized(0),
                             "out_layer": _quantized(1)},
        },
        "out_layer": {"modulation": {"out_layer": dict(lin)},
                      "out_layer": dict(lin)},
    }


def split_dim(name: str, specs: Optional[dict] = None) -> Optional[int]:
    """The split dim of parameter ``name`` (a state-dict key such as
    ``visual_transformer_blocks.3.self_attention.to_query.weight``)."""
    node = dit_param_specs() if specs is None else specs
    for part in name.split("."):
        if part.isdigit():
            continue
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"{name}: not a DiT parameter")
        node = node[part]
    if isinstance(node, dict):
        raise KeyError(f"{name}: not a DiT parameter")
    return node


def shard_tensor(name: str, tensor: torch.Tensor, rank: int, tp: int,
                 specs: Optional[dict] = None) -> torch.Tensor:
    """Rank ``rank``'s slice of the full parameter ``name`` (a contiguous
    copy; the tensor itself when replicated)."""
    dim = split_dim(name, specs)
    if dim is None or tp == 1:
        return tensor
    n = tensor.shape[dim]
    if n % tp:
        raise ValueError(f"{name}: dim {dim} of {tuple(tensor.shape)} does "
                         f"not split {tp} ways")
    return tensor.narrow(dim, rank * (n // tp), n // tp).contiguous()


def shard_dit_state_dict(state_dict: Mapping, rank: int,
                         tp: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slice of a reference-named DiT state dict (from
    ``checkpoint.dit_state_dict_from_jax`` or a safetensors file; numpy or
    torch values)."""
    specs = dit_param_specs()
    return {k: shard_tensor(k, v if torch.is_tensor(v)
                            else torch.from_numpy(np.array(v)), rank, tp, specs)
            for k, v in state_dict.items()}


@torch.no_grad()
def _local_dit(cfg: DiTParams, mesh: RankMesh, dtype, named_tensors,
               quantized: bool = False):
    """The rank-local DiT of ``mesh`` on its device: its tp index's slice
    of each (name, full tensor) of ``named_tensors`` (with ``quantized``,
    those of a W8A8 model: its ``weight_i8`` and ``w_scale`` leaves),
    running its collectives over the mesh's tp and sp groups."""
    from kandinsky5_tpu_torch.models.dit import (
        DiffusionTransformer3D,
        quantize_dit_params,
    )

    tp = mesh.tp
    local = DiffusionTransformer3D(cfg, device=tp.device, dtype=dtype, tp=tp,
                                   sp=mesh.sp)
    if quantized:  # the W8A8 leaves' local shapes; every value is copied
        local = quantize_dit_params(local)
    own = {**dict(local.named_parameters()), **dict(local.named_buffers())}
    specs = dit_param_specs()
    for name, full in named_tensors:
        own[name].copy_(shard_tensor(name, full, tp.rank, tp.size, specs))
    return local


def shard_dit(model, place):
    """The rank-local DiT of ``place`` (a
    :class:`~kandinsky5_tpu_torch.parallel.RankMesh`, or a bare
    ``TensorParallel`` as a (1, 1, tp) mesh): num_heads / tp heads and
    ff_dim / tp in the visual blocks, whole text blocks, holding its tp
    index's slice of ``model``'s weights and running its collectives over
    the tp group and, with sp > 1, its visual blocks on its 1/sp of the
    tokens (``models/dit.py``). A W8A8 model (quantized whole, as the JAX
    pipeline quantizes before it shards) gives the slices of its
    ``weight_i8``, its column-parallel ``w_scale`` and a whole row-parallel
    ``w_scale``. It is built on ``model``'s device, which
    must be the rank's (it raises otherwise: a card's model is not moved to
    the CPU, nor the reverse). A tp group of one rank holds the whole
    model: ``model`` itself, or with sp > 1 a copy sharing its tensors."""
    from kandinsky5_tpu_torch.models.dit import is_quantized, with_sp

    mesh = as_mesh(place)
    tp = mesh.tp
    device = next(model.parameters()).device
    if device != tp.device:
        raise ValueError(f"the DiT is on {device} and rank {tp.rank}'s "
                         f"group on {tp.device}")
    if tp.size == 1:
        return with_sp(model, mesh.sp)
    tensors = [*model.named_parameters(), *model.named_buffers()]
    return _local_dit(model.cfg, mesh, model.dtype,
                      ((n, t.detach()) for n, t in tensors),
                      quantized=is_quantized(model))


def seeded_parameters(cfg: DiTParams, device, dtype=torch.bfloat16,
                      seed: int = 0, scale: float = 0.02
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, full tensor) of every DiT parameter, drawn one at a time in
    ``fast_init_dit_params``' order from its seeded generator on ``device``:
    the same values that function gives, without the whole model in
    memory."""
    from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D

    shapes = DiffusionTransformer3D(cfg, device="meta", dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, prm in shapes.named_parameters():
        full = torch.empty(prm.shape, device=device, dtype=dtype)
        yield name, full.uniform_(-scale, scale, generator=gen)


def fast_init_dit_shard(cfg: DiTParams, place, dtype=torch.bfloat16,
                        seed: int = 0, scale: float = 0.02,
                        int8_linear: bool = False):
    """The rank-local DiT (as :func:`shard_dit` cuts it for ``place``) of
    ``fast_init_dit_params(cfg, seed=seed, scale=scale)``, drawn one
    parameter at a time on the rank's device: the rank never holds the
    whole model. ``int8_linear`` quantizes the rank's visual projections
    to W8A8 (``quantize_dit_params`` on the rank's share, which takes a
    row-parallel layer's scale from the max over the tp group): bit-equal
    to :func:`shard_dit` of the whole model quantized."""
    from kandinsky5_tpu_torch.models.dit import quantize_dit_params

    mesh = as_mesh(place)
    local = _local_dit(cfg, mesh, dtype, seeded_parameters(
        cfg, mesh.tp.device, dtype, seed, scale))
    return quantize_dit_params(local) if int8_linear else local
