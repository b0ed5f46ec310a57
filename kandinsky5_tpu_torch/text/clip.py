"""CLIP ViT-L/14 text encoder in PyTorch: the pooled conditioning vector.

Counterpart of ``kandinsky5_tpu/text/clip.py``: token and position
embeddings, 12 pre-LN blocks with quick-GELU MLPs, a final LayerNorm, and
the pooled vector read at the end-of-text token. The modules carry HF
``CLIPTextModel``'s names under ``text_model.`` (``embeddings.
token_embedding``, ``encoder.layers.N.self_attn.q_proj``,
``final_layer_norm``, ...), so a converted checkpoint
(``checkpoint.convert_clip_state_dict``) loads by name. As in the JAX
package, linears accumulate in fp32 and add their bias in fp32, LayerNorm
and quick-GELU run in fp32, and the attention scores are fp32 with masked
entries at -1e30.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from kandinsky5_tpu_torch.text.qwen import _mm_f32
from kandinsky5_tpu_torch.utils import default_device

LAYERNORM_EPS = 1e-5


@dataclass(frozen=True)
class ClipTextConfig:
    """openai/clip-vit-large-patch14 text config."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    # HF CLIPTextModel's pooling: the legacy eos_token_id == 2 (the released
    # ViT-L/14 config) pools at argmax(input_ids), since EOT is the largest
    # id and pads are EOT; other configs pool at the first eos_token_id
    eos_token_id: int = 2


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **kw)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size, **kw)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, h, **kw)
        self.v_proj = nn.Linear(h, h, **kw)
        self.out_proj = nn.Linear(h, h, **kw)


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)


class ClipEncoderLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = ClipAttention(cfg, **kw)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=LAYERNORM_EPS,
                                        **kw)
        self.mlp = ClipMLP(cfg, **kw)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=LAYERNORM_EPS,
                                        **kw)


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            ClipEncoderLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.num_hidden_layers))


class ClipTextModel(nn.Module):
    """The text encoder's parameters; :func:`clip_text_forward` runs it."""

    def __init__(self, cfg: ClipTextConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embeddings = ClipEmbeddings(cfg, **kw)
        self.encoder = ClipEncoder(cfg, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=LAYERNORM_EPS, **kw)

    @property
    def device(self) -> torch.device:
        return self.final_layer_norm.weight.device


@torch.no_grad()
def init_clip_params_random(cfg: ClipTextConfig, device=None,
                            dtype=torch.float32, seed: int = 0,
                            scale: float = 0.02) -> ClipTextModel:
    """Seeded weights on ``device`` (the CUDA card when None), as the JAX
    ``init_clip_params_random``: linear weights and embeddings uniform in
    +-scale, biases 0, LayerNorms at weight 1 and bias 0."""
    device = default_device(device)
    with torch.device("meta"):
        model = ClipTextModel(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, prm in model.named_parameters():
        if "layer_norm" in name and name.endswith("weight"):
            prm.fill_(1.0)
        elif name.endswith("bias"):
            prm.zero_()
        else:
            prm.uniform_(-scale, scale, generator=gen)
    return model


def _ln(p: nn.LayerNorm, x):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LAYERNORM_EPS)
    return (y * p.weight.float() + p.bias.float()).to(x.dtype)


def _linear(p: nn.Linear, x):
    return (_mm_f32(x, p.weight) + p.bias.float()).to(x.dtype)


def quick_gelu(x):
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def _attention(p: ClipAttention, x, mask, num_heads: int):
    b, l, c = x.shape
    d = c // num_heads
    q = _linear(p.q_proj, x).reshape(b, l, num_heads, d).transpose(1, 2)
    k = _linear(p.k_proj, x).reshape(b, l, num_heads, d).transpose(1, 2)
    v = _linear(p.v_proj, x).reshape(b, l, num_heads, d).transpose(1, 2)
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(d)
    s = s.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = (probs.float() @ v.float()).to(x.dtype)
    return _linear(p.out_proj, out.transpose(1, 2).reshape(b, l, c))


def _pool_index(cfg: ClipTextConfig, ids):
    if cfg.eos_token_id == 2:
        return ids.argmax(dim=-1)
    # the first position holding eos_token_id (0 when there is none)
    return (ids == cfg.eos_token_id).int().argmax(dim=-1)


@torch.no_grad()
def clip_text_forward(model: ClipTextModel, input_ids, attention_mask):
    """(B, L) ids and mask -> (last hidden (B, L, C), pooled (B, C))."""
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(input_ids).to(dev).long()
    valid = torch.as_tensor(attention_mask).to(dev).bool()
    b, l = ids.shape
    emb = model.embeddings
    x = F.embedding(ids, emb.token_embedding.weight)
    x = x + emb.position_embedding.weight[None, :l]
    causal = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    mask = causal[None] & valid[:, None, :]
    for layer in model.encoder.layers:
        h = _ln(layer.layer_norm1, x)
        x = x + _attention(layer.self_attn, h, mask, cfg.num_attention_heads)
        h = _ln(layer.layer_norm2, x)
        h = quick_gelu(_linear(layer.mlp.fc1, h))
        x = x + _linear(layer.mlp.fc2, h)
    x = _ln(model.final_layer_norm, x)
    pooled = x[torch.arange(b, device=dev), _pool_index(cfg, ids)]
    return x, pooled


def clip_pooled(model: ClipTextModel, input_ids, attention_mask):
    return clip_text_forward(model, input_ids, attention_mask)[1]
