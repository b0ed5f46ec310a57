"""Checkpoint loading and conversion for the PyTorch port.

Counterpart of ``kandinsky5_tpu/checkpoint.py`` (DiT, VAE, the Qwen text
and vision towers and CLIP).
The port's DiT carries the released checkpoint's names and torch layouts,
so a released state dict loads with ``load_state_dict`` as it is. The VAE
is a nested dict of tensors keyed like the HF checkpoint, with the causal
convs' ``.conv`` level flattened away as the JAX package does, Conv3d
weights in torch (Cout, Cin, kT, kH, kW) and Linear weights in (out, in).

``dit_state_dict_from_jax`` and ``vae_state_dict_from_jax`` run the JAX
converters in reverse: they take a JAX parameter pytree as numpy arrays and
return a reference-layout state dict (a W8A8 DiT tree included). This is
how the tests hand both packages the same weights.

The text towers carry HF's names too: ``convert_qwen_state_dict`` and
``convert_clip_state_dict`` only strip the HF prefixes and drop what the
text path never reads (the vision tower, CLIP's projection and position
ids); ``qwen_state_dict_from_jax`` and ``clip_state_dict_from_jax`` carry
the JAX pytrees (layers stacked, linears (in, out)) to those names. The
vision tower likewise: ``convert_qwen_vision_state_dict`` keeps HF's
``visual.*`` entries without the prefix, ``qwen_vision_state_dict_from_jax``
carries the JAX tree (blocks stacked, linears (in, out), the patch conv
flattened) to them.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from kandinsky5_tpu_torch.utils import default_device
from kandinsky5_tpu_torch.utils.io import load_sharded_safetensors

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


# one loader serves every checkpoint: a file, a directory of shards, or an
# HF shard index
load_state_dict_file = load_sharded_safetensors


def _unstack(tree: Mapping, prefix: str, out: dict) -> None:
    """Per-layer keys ``<prefix>.<i>.<path>`` from a pytree whose leaves
    carry the layers on a leading axis."""
    flat = _flatten(tree, "", {})
    n = next(iter(flat.values())).shape[0]
    for i in range(n):
        for path, arr in flat.items():
            out[f"{prefix}.{i}.{path}"] = arr[i]


def _transpose_linears(out: dict, keep: str) -> dict:
    """(in, out) -> (out, in) for every 2-D linear weight (dense or int8)
    whose key does not contain ``keep``."""
    for key, arr in out.items():
        if key.endswith((".weight", ".weight_q")) and arr.ndim == 2 \
                and keep not in key:
            out[key] = np.ascontiguousarray(arr.T)
    return out


def qwen_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX Qwen pytree (numpy leaves; ``layers`` stacked; linears (in, out);
    the dense tree or ``quantize_qwen_decode_params``' int8 tree) -> the
    port's state dict (``layers.<i>.*``, linears (out, in))."""
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "layers":
            _unstack(sub, "layers", out)
        else:
            _flatten(sub, key, out)
    return _transpose_linears(out, "embed_tokens")


def clip_state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """JAX CLIP text pytree -> the port's state dict (HF names without the
    ``text_model.`` prefix: ``encoder.layers.<i>.*``, linears (out, in))."""
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "layers":
            _unstack(sub, "encoder.layers", out)
        else:
            _flatten(sub, key, out)
    return _transpose_linears(out, "embedding")


def convert_qwen_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """HF Qwen2.5-VL state dict -> the port's text tower names. Both HF
    layouts (``model.language_model.*``, transformers >= 4.52, and
    ``model.*`` before) lose their prefix; the vision tower is dropped (the
    pipeline is text-only). Layouts stay as HF stores them."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if "visual" in key:
            continue
        for prefix in ("model.language_model.", "language_model.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[key] = _as_tensor(value)
    return out


def qwen_vision_state_dict_from_jax(tree: Mapping,
                                    cfg) -> Dict[str, np.ndarray]:
    """JAX Qwen vision pytree (numpy leaves; ``blocks`` stacked; linears
    (in, out); the patch conv as (embed, C * tps * ps * ps)) -> the port's
    names and torch layouts (``blocks.<i>.*``, linears (out, in), the patch
    conv (embed, C, tps, ps, ps) as ``cfg``, a ``QwenVisionConfig``, sizes
    it)."""
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "blocks":
            _unstack(sub, "blocks", out)
        else:
            _flatten(sub, key, out)
    out = _transpose_linears(out, "patch_embed")
    key = "patch_embed.proj.weight"
    out[key] = out[key].reshape(cfg.hidden_size, cfg.in_channels,
                                cfg.temporal_patch_size, cfg.patch_size,
                                cfg.patch_size)
    return out


def convert_qwen_vision_state_dict(state_dict: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """HF Qwen2.5-VL state dict -> the port's vision tower names: the
    ``visual.*`` entries (``model.visual.*`` in transformers >= 4.52) without
    the prefix, in HF's layouts; the text tower's entries are dropped."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for prefix in ("model.visual.", "visual."):
            if key.startswith(prefix):
                out[key[len(prefix):]] = _as_tensor(value)
                break
    return out


def convert_clip_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """HF CLIPTextModel (or whole CLIPModel, as the released ViT-L/14
    checkpoint is) state dict -> the port's CLIP names (no ``text_model.``
    prefix; ``text_projection``, ``position_ids`` and the vision half,
    ``vision_model.*``, ``visual_projection`` and ``logit_scale``,
    dropped)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.startswith("text_model."):
            key = key[len("text_model."):]
        if key.startswith(("text_projection", "vision_model.",
                           "visual_projection", "logit_scale")) \
                or "position_ids" in key:
            continue
        out[key] = _as_tensor(value)
    return out


def qwen_hf_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's Qwen text tower under the names of the released
    Qwen2.5-VL checkpoint (``model.*``, ``lm_head.weight``): the inverse of
    :func:`convert_qwen_state_dict` for its text half."""
    return {k if k == "lm_head.weight" else f"model.{k}": v
            for k, v in model.state_dict().items()}


def clip_hf_state_dict(model) -> Dict[str, torch.Tensor]:
    """The port's CLIP text tower under HF's names (``text_model.*``)."""
    return {f"text_model.{k}": v for k, v in model.state_dict().items()}


def vae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's nested VAE params under the diffusers checkpoint's names
    (the causal convs' weights and biases under ``<name>.conv.*``): the
    inverse of :func:`vae_params_from_state_dict`."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = v
    walk(params, "")
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        name, leaf = key.rsplit(".", 1)
        weight = flat.get(f"{name}.weight")
        if weight is not None and weight.ndim == 5 \
                and name.rsplit(".", 1)[-1] not in _PLAIN_CONVS:
            key = f"{name}.conv.{leaf}"
        out[key] = value
    return out


def _as_tensor(value) -> torch.Tensor:
    return value if torch.is_tensor(value) else torch.as_tensor(np.array(value))


def _load_module(model: torch.nn.Module, state_dict: Mapping, device,
                 dtype) -> torch.nn.Module:
    """Fill ``model`` (built on the meta device) with ``state_dict``, each
    tensor moved to ``device`` in ``dtype``."""
    sd = {k: _as_tensor(v).to(device=device, dtype=dtype)
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def qwen_from_state_dict(state_dict: Mapping, cfg=None, device=None,
                         dtype=torch.bfloat16):
    """The port's Qwen text tower from an HF (or already converted) state
    dict, on ``device`` (the CUDA card when None) in ``dtype``; ``cfg``
    None means the released 7B dims. A tied ``lm_head`` reads the
    embedding table."""
    from kandinsky5_tpu_torch.text.qwen import QwenTextConfig, QwenTextModel

    device = default_device(device)
    cfg = cfg or QwenTextConfig()
    sd = convert_qwen_state_dict(state_dict)
    if "lm_head.weight" not in sd and cfg.tie_word_embeddings:
        sd["lm_head.weight"] = sd["embed_tokens.weight"]
    with torch.device("meta"):
        model = QwenTextModel(cfg, dtype=dtype)
    return _load_module(model, sd, device, dtype)


def clip_from_state_dict(state_dict: Mapping, cfg=None, device=None,
                         dtype=torch.float32):
    """The port's CLIP text encoder from an HF (or already converted) state
    dict, on ``device`` (the CUDA card when None); ``cfg`` None means
    ViT-L/14."""
    from kandinsky5_tpu_torch.text.clip import ClipTextConfig, ClipTextModel

    device = default_device(device)
    cfg = cfg or ClipTextConfig()
    with torch.device("meta"):
        model = ClipTextModel(cfg, dtype=dtype)
    return _load_module(model, convert_clip_state_dict(state_dict), device,
                        dtype)


def vision_from_state_dict(state_dict: Mapping, cfg=None, device=None,
                           dtype=torch.bfloat16):
    """The port's Qwen2.5-VL vision tower from an HF state dict (its
    ``visual.*`` entries), on ``device`` (the CUDA card when None); ``cfg``
    None means the released 7B dims."""
    from kandinsky5_tpu_torch.text.qwen_vision import (
        QwenVisionConfig,
        QwenVisionModel,
    )

    device = default_device(device)
    cfg = cfg or QwenVisionConfig()
    with torch.device("meta"):
        model = QwenVisionModel(cfg, dtype=dtype)
    return _load_module(model, convert_qwen_vision_state_dict(state_dict),
                        device, dtype)


def load_vae_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The diffusers VAE checkpoint at ``path``: a file, or a directory
    holding ``diffusion_pytorch_model.safetensors`` (directly or under
    ``vae/``), else its safetensors shards."""
    if os.path.isdir(path):
        for cand in ("diffusion_pytorch_model.safetensors",
                     os.path.join("vae", "diffusion_pytorch_model.safetensors")):
            if os.path.exists(os.path.join(path, cand)):
                path = os.path.join(path, cand)
                break
    return load_sharded_safetensors(path)
