"""What the ranks of ``tests/test_torch_qwen_tp.py`` run, in gloo CPU rank
processes started by ``kandinsky5_tpu_torch.parallel.launch`` on a (1, 2,
2) mesh: the Qwen tower sharded over its four sp * tp ranks (the mesh's
``shard`` group, JAX's ``axes=("sp", "tp")``). This module imports the port
alone (no JAX).

The control (:func:`without_o_proj_sum`) is shared with ``chip_smoke.py``'s
phase 5d."""

from unittest import mock

import torch

from kandinsky5_tpu_torch.checkpoint import qwen_from_state_dict
from kandinsky5_tpu_torch.text import qwen as qwen_mod
from kandinsky5_tpu_torch.text.qwen import (
    QwenTextConfig,
    init_qwen_params_random,
    init_qwen_shard_random,
    quantize_qwen_decode_params,
    qwen_encode,
    qwen_generate,
    qwen_hidden_states,
    shard_qwen,
)


class _NoSum:
    """A group that keeps each rank's partial sum."""

    def __init__(self, group):
        self.rank, self.size = group.rank, group.size

    def all_reduce(self, x, op="sum"):
        return x


def without_o_proj_sum(model):
    """The control: the sharded ``model``'s ``o_proj`` keeps each rank's
    partial product (``down_proj`` still sums). A context manager."""
    o_projs = {id(layer.self_attn.o_proj) for layer in model.layers}
    real = qwen_mod._row

    def row(p, x, group=None):
        return real(p, x, _NoSum(group) if id(p) in o_projs else group)

    return mock.patch.object(qwen_mod, "_row", row)


def _differ(a, b):
    """Names whose tensors differ between two state dicts."""
    a, b = a.state_dict(), b.state_dict()
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


@torch.no_grad()
def run(mesh, case):
    torch.set_num_threads(1)
    group = mesh.shard
    cfg = QwenTextConfig(**case["cfg"])
    whole = qwen_from_state_dict(case["state_dict"], cfg, device="cpu",
                                 dtype=torch.float32)
    local = shard_qwen(whole, group)
    ids, amask = (torch.from_numpy(case[k]) for k in ("ids", "mask"))
    out = {"rank": group.rank, "size": group.size, "ranks": group.ranks,
           "hidden": qwen_hidden_states(local, ids, amask).numpy(),
           "weight_bytes": sum(t.numel() * t.element_size() for t in
                               local.state_dict().values())}
    emb, m = qwen_encode(local, ids, amask, crop_start=3)
    out["encode"], out["encode_mask"] = emb.numpy(), m.numpy()
    out["greedy"] = qwen_generate(local, case["prompt"], max_new_tokens=8,
                                  eos_token_ids=(0,))
    with without_o_proj_sum(local):
        out["no_o_proj_sum"] = qwen_hidden_states(local, ids, amask).numpy()

    # the int8 decode tree: quantized whole then sharded, and the share
    # quantized (row-parallel scales from the max over the group)
    local8 = shard_qwen(quantize_qwen_decode_params(whole), group)
    out["int8_differ"] = _differ(local8, quantize_qwen_decode_params(local))
    out["int8"] = qwen_generate(local8, case["prompt8"], max_new_tokens=4,
                                eos_token_ids=(0,))

    # a rank's share drawn one tensor at a time against the whole draw cut
    drawn = init_qwen_shard_random(cfg, group, dtype=torch.float32, seed=5)
    cut = shard_qwen(init_qwen_params_random(cfg, device="cpu",
                                             dtype=torch.float32, seed=5),
                     group)
    out["drawn_differ"] = _differ(drawn, cut)
    out["drawn_tensors"] = len(cut.state_dict())
    return out
