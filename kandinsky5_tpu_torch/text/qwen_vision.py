"""Qwen2.5-VL vision tower (ViT) in PyTorch.

Counterpart of ``kandinsky5_tpu/text/qwen_vision.py``. The T2V pipeline
feeds text only (the reference loads the whole VL model and never passes an
image), so nothing on the main path calls this tower; it completes the
model surface for image-conditioned use:

  * the 2 x 14 x 14 patch embedding as one product over the flattened
    patches (the conv's stride equals its kernel);
  * 2-D rotary embeddings over the merge-permuted (h, w) grid (theta 1e4,
    head_dim / 2 rotary channels);
  * windowed and full attention as dense attention masked by segment ids
    (each token carries its window id, or its image id in the blocks of
    ``fullatt_block_indexes``) in plain PyTorch: no TPU kernel is on this
    path, the JAX package runs it in XLA;
  * the spatial patch merger (RMSNorm -> 2 x 2 concat -> MLP) and the
    window permutation's inverse.

The modules carry HF's names (``patch_embed.proj``, ``blocks.N.attn.qkv``,
``merger.mlp.0``, ...), so a converted checkpoint
(``checkpoint.convert_qwen_vision_state_dict``) loads by name. The cast
points are the JAX package's: projections accumulate in fp32 and add their
bias in fp32, RoPE, the scores and the softmax run in fp32, probabilities
are cast to the value dtype before PV, RMSNorm casts before it multiplies
by the weight.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kandinsky5_tpu_torch.text.qwen import RMSNorm, _mm_f32, qwen_rms_norm
from kandinsky5_tpu_torch.utils import default_device

RMS_EPS = 1e-6


@dataclass(frozen=True)
class QwenVisionConfig:
    """Qwen2.5-VL-7B vision defaults (HF config.json ``vision_config``)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    out_hidden_size: int = 3584
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size ** 2)


# ---------------------------------------------------------------------------
# Host-side index tables (the grid is host data in HF too)
# ---------------------------------------------------------------------------

def rot_pos_ids(cfg: QwenVisionConfig, grid_thw: np.ndarray) -> np.ndarray:
    """(S, 2) (h, w) position ids in the spatial-merge-permuted order (HF
    ``rot_pos_emb``)."""
    sm = cfg.spatial_merge_size
    out = []
    for t, h, w in np.asarray(grid_thw):
        hp = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hp = hp.reshape(h // sm, sm, w // sm, sm).transpose(0, 2, 1, 3).ravel()
        wp = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wp = wp.reshape(h // sm, sm, w // sm, sm).transpose(0, 2, 1, 3).ravel()
        out.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))
    return np.concatenate(out, axis=0)


def window_index(cfg: QwenVisionConfig, grid_thw: np.ndarray):
    """(window_index (S/4,), cu_window_seqlens), HF ``get_window_index``:
    the index puts the 4-patch merge units in window-contiguous order, the
    boundaries delimit each window's tokens in that order."""
    sm = cfg.spatial_merge_size
    unit = sm * sm
    vit_ws = cfg.window_size // sm // cfg.patch_size
    idx_list = []
    cu = [0]
    base = 0
    for t, h, w in np.asarray(grid_thw):
        lh, lw = h // sm, w // sm
        index = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h = vit_ws - lh % vit_ws
        pad_w = vit_ws - lw % vit_ws
        nh = (lh + pad_h) // vit_ws
        nw = (lw + pad_w) // vit_ws
        padded = np.pad(index, ((0, 0), (0, pad_h), (0, pad_w)),
                        constant_values=-100)
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(
            t, nh * nw, vit_ws, vit_ws)
        seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
        flat = padded.reshape(-1)
        flat = flat[flat != -100]
        idx_list.append(flat + base)
        cu.extend((np.cumsum(seqlens) * unit + cu[-1]).tolist())
        base += t * lh * lw
    cu = np.asarray(cu, np.int64)
    # unique_consecutive: the padding's empty windows repeat a boundary
    keep = np.ones(len(cu), bool)
    keep[1:] = cu[1:] != cu[:-1]
    return np.concatenate(idx_list), cu[keep]


def _segments_from_cu(cu: np.ndarray, total: int) -> np.ndarray:
    seg = np.zeros(total, np.int32)
    for i in range(len(cu) - 1):
        seg[cu[i]:cu[i + 1]] = i
    return seg


def vision_indices(cfg: QwenVisionConfig, grid_thw: np.ndarray) -> dict:
    """Every index table of one forward: the window index and its inverse,
    the token permutation, per-token window and image segment ids and the
    (S, 2) rotary position ids, all in the window-permuted order."""
    grid_thw = np.asarray(grid_thw)
    unit = cfg.spatial_merge_size ** 2
    total = int((grid_thw[:, 0] * grid_thw[:, 1] * grid_thw[:, 2]).sum())
    widx, cu_win = window_index(cfg, grid_thw)
    lens = np.repeat(grid_thw[:, 1] * grid_thw[:, 2], grid_thw[:, 0])
    cu_full = np.concatenate([[0], np.cumsum(lens)])
    seg_full = _segments_from_cu(cu_full, total)
    seg_win = _segments_from_cu(cu_win, total)
    pos = rot_pos_ids(cfg, grid_thw)
    perm = (widx[:, None] * unit + np.arange(unit)[None]).reshape(-1)
    inv = np.argsort(widx)
    return dict(window_index=widx, inverse=inv, perm=perm,
                seg_full=seg_full[perm], seg_win=seg_win,
                pos_ids=pos[perm], total=total)


# ---------------------------------------------------------------------------
# Modules (parameter containers named like the HF checkpoint)
# ---------------------------------------------------------------------------

class PatchEmbed(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None, dtype=None):
        super().__init__()
        k = (cfg.temporal_patch_size, cfg.patch_size, cfg.patch_size)
        self.proj = nn.Conv3d(cfg.in_channels, cfg.hidden_size, k, stride=k,
                              bias=False, device=device, dtype=dtype)


class VisionAttention(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)


class VisionMLP(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, f, **kw)
        self.up_proj = nn.Linear(h, f, **kw)
        self.down_proj = nn.Linear(f, h, **kw)


class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = RMSNorm(cfg.hidden_size, **kw)
        self.norm2 = RMSNorm(cfg.hidden_size, **kw)
        self.attn = VisionAttention(cfg, **kw)
        self.mlp = VisionMLP(cfg, **kw)


class PatchMerger(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        width = cfg.hidden_size * cfg.spatial_merge_size ** 2
        self.ln_q = RMSNorm(cfg.hidden_size, **kw)
        self.mlp = nn.Sequential(nn.Linear(width, width, **kw), nn.GELU(),
                                 nn.Linear(width, cfg.out_hidden_size, **kw))


class QwenVisionModel(nn.Module):
    """The vision tower's parameters; :func:`vision_forward` runs it."""

    def __init__(self, cfg: QwenVisionConfig, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = PatchEmbed(cfg, **kw)
        self.blocks = nn.ModuleList(VisionBlock(cfg, **kw)
                                    for _ in range(cfg.depth))
        self.merger = PatchMerger(cfg, **kw)

    @property
    def device(self) -> torch.device:
        return self.patch_embed.proj.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_embed.proj.weight.dtype


@torch.no_grad()
def init_vision_params_random(cfg: QwenVisionConfig, device=None,
                              dtype=torch.bfloat16, seed: int = 0,
                              scale: float = 0.02) -> QwenVisionModel:
    """A tower drawn on ``device`` (the CUDA card when None) from one seeded
    generator: every weight and bias uniform in +-scale, norm weights 1 (the
    scheme of the text towers' random init)."""
    device = default_device(device)
    with torch.device("meta"):
        model = QwenVisionModel(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, prm in model.named_parameters():
        if "norm" in name or "ln_q" in name:
            prm.fill_(1.0)
        else:
            prm.uniform_(-scale, scale, generator=gen)
    return model


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def _lin_f32(p: nn.Linear, x):
    """x W^T + b with fp32 accumulation and the bias added in fp32."""
    return _mm_f32(x, p.weight) + p.bias.float()


def rot_tables(cfg: QwenVisionConfig, pos_ids: np.ndarray, device):
    """fp32 cos/sin (S, head_dim) of the 2-D rotary embedding."""
    dim = cfg.head_dim // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    h = pos_ids[:, 0:1].astype(np.float32) * inv[None]
    w = pos_ids[:, 1:2].astype(np.float32) * inv[None]
    emb = np.concatenate([h, w, h, w], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def vision_block(p: VisionBlock, x, cos, sin, seg, cfg: QwenVisionConfig):
    """One ViT block: RMSNorm -> segment-masked attention -> RMSNorm ->
    biased SwiGLU MLP. x (S, C); seg (S,) window or image ids."""
    h = qwen_rms_norm(x, p.norm1.weight, RMS_EPS)
    s, c = h.shape
    nh, d = cfg.num_heads, cfg.head_dim
    qkv = _lin_f32(p.attn.qkv, h).to(x.dtype).reshape(s, 3, nh, d)
    q, k, v = qkv.unbind(1)
    cs, sn = cos[:, None], sin[:, None]
    q = (q.float() * cs + _rotate_half(q.float()) * sn).to(x.dtype)
    k = (k.float() * cs + _rotate_half(k.float()) * sn).to(x.dtype)
    scores = torch.einsum("lhd,mhd->hlm", q.float(), k.float()) / math.sqrt(d)
    allowed = seg[:, None] == seg[None, :]
    scores = scores.masked_fill(~allowed[None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("hlm,mhd->lhd", probs.float(), v.float())
    out = out.reshape(s, c).to(x.dtype)
    x = x + _lin_f32(p.attn.proj, out).to(x.dtype)
    h = qwen_rms_norm(x, p.norm2.weight, RMS_EPS)
    m = (F.silu(_lin_f32(p.mlp.gate_proj, h))
         * _lin_f32(p.mlp.up_proj, h)).to(x.dtype)
    return x + _lin_f32(p.mlp.down_proj, m).to(x.dtype)


@torch.no_grad()
def vision_forward(model: QwenVisionModel, pixel_patches, grid_thw):
    """(S, C * tps * ps * ps) flattened patches (HF's ``pixel_values``) and
    the (N, 3) grid -> merged (S / 4, out_hidden_size) image embeddings in
    the model's dtype (HF ``visual(pixel_values, grid_thw)``)."""
    cfg = model.cfg
    dev = model.device
    idx = vision_indices(cfg, np.asarray(grid_thw))
    cos, sin = rot_tables(cfg, idx["pos_ids"], dev)
    seg_full = torch.from_numpy(idx["seg_full"]).to(dev)
    seg_win = torch.from_numpy(idx["seg_win"]).to(dev)
    w = model.patch_embed.proj.weight
    patches = torch.as_tensor(pixel_patches).to(dev)
    x = F.linear(patches.float(), w.reshape(w.shape[0], -1).float()).to(w.dtype)
    x = x[torch.from_numpy(idx["perm"]).to(dev)]
    full = set(cfg.fullatt_block_indexes)
    for i, blk in enumerate(model.blocks):
        x = vision_block(blk, x, cos, sin, seg_full if i in full else seg_win,
                         cfg)
    m = model.merger
    x = qwen_rms_norm(x, m.ln_q.weight, RMS_EPS)
    x = x.reshape(-1, cfg.spatial_merge_size ** 2 * cfg.hidden_size)
    x = F.gelu(_lin_f32(m.mlp[0], x), approximate="none")
    x = _lin_f32(m.mlp[2], x.to(m.mlp[2].weight.dtype))
    return x[torch.from_numpy(idx["inverse"]).to(dev)].to(w.dtype)


def vision_config_from_json(checkpoint_path) -> QwenVisionConfig:
    """The tower's config from the checkpoint's ``config.json``
    (``vision_config``), the released 7B defaults where it is absent."""
    try:
        with open(os.path.join(str(checkpoint_path), "config.json")) as f:
            vc = json.load(f).get("vision_config", {})
    except (OSError, ValueError):
        return QwenVisionConfig()
    return QwenVisionConfig(**{
        k: (tuple(v) if k == "fullatt_block_indexes" else v)
        for k, v in vc.items() if k in QwenVisionConfig.__dataclass_fields__})


def load_vision_tower(checkpoint_path: str, device=None,
                      dtype=torch.bfloat16) -> QwenVisionModel:
    """The vision tower of an HF Qwen2.5-VL checkpoint directory, on
    ``device`` (the CUDA card when None); ``model.cfg`` is read from its
    ``config.json``. The companion of ``Kandinsky5TextEmbedder.
    from_pretrained``, which loads only the text tower."""
    from kandinsky5_tpu_torch.checkpoint import vision_from_state_dict
    from kandinsky5_tpu_torch.utils.io import load_sharded_safetensors

    return vision_from_state_dict(load_sharded_safetensors(checkpoint_path),
                                  vision_config_from_json(checkpoint_path),
                                  device=device, dtype=dtype)
