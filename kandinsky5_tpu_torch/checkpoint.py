"""Checkpoint loading and conversion for the PyTorch port (DiT and VAE).

Counterpart of the DiT and VAE halves of ``kandinsky5_tpu/checkpoint.py``.
The port's DiT carries the released checkpoint's names and torch layouts,
so a released state dict loads with ``load_state_dict`` as it is. The VAE
is a nested dict of tensors keyed like the HF checkpoint, with the causal
convs' ``.conv`` level flattened away as the JAX package does, Conv3d
weights in torch (Cout, Cin, kT, kH, kW) and Linear weights in (out, in).

``dit_state_dict_from_jax`` and ``vae_state_dict_from_jax`` run the JAX
converters in reverse: they take a JAX parameter pytree as numpy arrays and
return a reference-layout state dict (a W8A8 DiT tree included). This is
how the tests hand both packages the same weights.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from kandinsky5_tpu_torch.utils import default_device

_STACKED = ("text_transformer_blocks", "visual_transformer_blocks")
# VAE modules that are plain Conv3d in the checkpoint (no causal wrapper)
_PLAIN_CONVS = ("quant_conv", "post_quant_conv")


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def _insert(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def dit_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX DiT pytree (numpy leaves, blocks stacked on a leading axis,
    linears (in, out)) -> reference state dict (per-block keys, linears
    (out, in))."""
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in _STACKED:
            flat = _flatten(sub, "", {})
            n = next(iter(flat.values())).shape[0]
            for i in range(n):
                for path, arr in flat.items():
                    out[f"{key}.{i}.{path}"] = arr[i]
        else:
            _flatten(sub, key, out)
    for key, arr in out.items():
        if key.endswith((".weight", ".weight_i8")) and arr.ndim == 2:
            out[key] = np.ascontiguousarray(arr.T)
    return out


def vae_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX VAE pytree (convs DHWIO, linears (in, out)) -> HF-layout state
    dict (Conv3d (O, I, kT, kH, kW) under ``<name>.conv.*`` for the causal
    convs, linears (out, in))."""
    out: Dict[str, np.ndarray] = {}
    for key, arr in _flatten(tree, "", {}).items():
        name, leaf = key.rsplit(".", 1)
        conv = np.ndim(_lookup(tree, f"{name}.weight")) == 5
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif leaf == "weight" and arr.ndim == 2:
            arr = arr.T
        if conv and name.rsplit(".", 1)[-1] not in _PLAIN_CONVS:
            key = f"{name}.conv.{leaf}"
        out[key] = np.ascontiguousarray(arr)
    return out


def _lookup(tree, path: str):
    node = tree
    for p in path.split("."):
        if not isinstance(node, Mapping) or p not in node:
            return None
        node = node[p]
    return node


def vae_params_from_state_dict(state_dict: Mapping, device=None,
                               dtype=torch.bfloat16) -> dict:
    """HF HunyuanVideo VAE state dict -> the port's nested VAE params, on
    ``device`` (the CUDA card when None)."""
    device = default_device(device)
    tree: dict = {}
    for key, value in state_dict.items():
        t = torch.as_tensor(np.array(value) if not torch.is_tensor(value)
                            else value)
        for suffix in (".conv.weight", ".conv.bias"):
            if key.endswith(suffix):
                key = key[: -len(suffix)] + suffix[len(".conv"):]
                break
        _insert(tree, key, t.to(device=device, dtype=dtype))
    return tree


def dit_from_state_dict(model: torch.nn.Module, state_dict: Mapping):
    """Load a reference-layout state dict (numpy or torch values) into the
    port's DiT, each tensor cast to the dtype and device of the entry it
    fills. A W8A8 state dict (``weight_i8`` / ``w_scale`` entries, as
    ``dit_state_dict_from_jax`` gives for a JAX ``quantize_dit_params``
    tree) loads into ``quantize_dit_params(model)``, which is returned;
    the tensors it shares with ``model`` are loaded into ``model`` too."""
    from kandinsky5_tpu_torch.models.dit import is_quantized, quantize_dit_params

    if any(k.endswith(".weight_i8") for k in state_dict) and not is_quantized(model):
        model = quantize_dit_params(model)
    own = model.state_dict()
    sd = {k: torch.as_tensor(np.array(v) if not torch.is_tensor(v) else v)
          .to(device=own[k].device, dtype=own[k].dtype) if k in own else v
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True)
    return model


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors checkpoint (single file, or a directory of shards)."""
    from safetensors.torch import load_file

    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    else:
        files = [path]
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(load_file(f))
    return out
