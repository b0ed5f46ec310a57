"""The tensor-parallel plan of the DiT: which parameters each rank holds.

Counterpart of ``kandinsky5_tpu/parallel/sharding.py`` on its tp axis. The
reference shards the DiT with a DTensor plan over 1, 2 or 4 GPUs
(``parallelize.py``; torchrun world size): head-sharded Q/K/V (column
parallel), row-parallel attention and FF out layers, column-parallel FF in
layer, replicated modulation, embeddings, text blocks and out layer. The
JAX package's mesh adds a sequence axis (sp) and a data axis (dp); the port
runs tp alone, and a plan that asks for sp or dp raises (ROADMAP.md, queue
1 item 1, lists what they need).

Specs are in the port's names and torch layouts: a linear weight is (out,
in), so column parallel splits dim 0 and row parallel dim 1.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.parallel.ranks import TensorParallel


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


def tp_width(plan: Tuple[int, int, int]) -> int:
    """The tp width of a (dp, sp, tp) plan; the port runs tp alone, so a
    plan with sp > 1 or dp > 1 raises."""
    dp, sp, tp = plan
    if dp != 1 or sp != 1:
        raise ValueError(
            f"plan (dp, sp, tp) = {plan}: the port runs tensor parallelism "
            "alone; sequence (sp) and data (dp) parallelism are not ported "
            "yet (ROADMAP.md, queue 1, item 7)")
    return tp


# split dim of each parameter under tp: 0 = column parallel (output rows),
# 1 = row parallel (input columns), None = replicated
_ATTN = {
    "to_query": {"weight": 0, "bias": 0},
    "to_key": {"weight": 0, "bias": 0},
    "to_value": {"weight": 0, "bias": 0},
    # row parallel: each rank's product is a partial sum, all-reduced
    # before the bias is added once
    "out_layer": {"weight": 1, "bias": None},
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
            "feed_forward": {"in_layer": {"weight": 0},
                             "out_layer": {"weight": 1}},
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
def _local_dit(cfg: DiTParams, tp: TensorParallel, dtype, named_tensors):
    """The rank-local DiT of ``tp.rank`` on ``tp.device``, filled with its
    slice of each (name, full tensor) of ``named_tensors``."""
    from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D

    tp_width(plan_dit_mesh(tp.size, cfg.num_heads))
    local = DiffusionTransformer3D(cfg, device=tp.device, dtype=dtype, tp=tp)
    own = dict(local.named_parameters())
    specs = dit_param_specs()
    for name, full in named_tensors:
        own[name].copy_(shard_tensor(name, full, tp.rank, tp.size, specs))
    return local


def shard_dit(model, tp: TensorParallel):
    """The rank-local DiT of ``tp.rank``: num_heads / tp heads and ff_dim /
    tp in the visual blocks, whole text blocks, holding its slice of
    ``model``'s weights and running its collectives over ``tp``. It is
    built on ``model``'s device, which must be ``tp.device`` (it raises
    otherwise: a card's model is not moved to the CPU, nor the reverse). A
    group of one rank holds the whole model: ``model`` itself."""
    from kandinsky5_tpu_torch.models.dit import is_quantized

    if is_quantized(model):
        raise ValueError("W8A8 under tensor parallelism is not ported yet "
                         "(ROADMAP.md, queue 1, item 7)")
    device = next(model.parameters()).device
    if device != tp.device:
        raise ValueError(f"the DiT is on {device} and rank {tp.rank}'s "
                         f"group on {tp.device}")
    if tp.size == 1:
        return model
    return _local_dit(model.cfg, tp, model.dtype,
                      ((n, p.detach()) for n, p in model.named_parameters()))


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


def fast_init_dit_shard(cfg: DiTParams, tp: TensorParallel,
                        dtype=torch.bfloat16, seed: int = 0,
                        scale: float = 0.02):
    """The rank-local DiT of ``fast_init_dit_params(cfg, seed=seed,
    scale=scale)``, drawn one parameter at a time on ``tp.device``: the rank
    never holds the whole model."""
    return _local_dit(cfg, tp, dtype,
                      seeded_parameters(cfg, tp.device, dtype, seed, scale))
