"""Qwen2.5-VL text tower in PyTorch: conditioning encoder and prompt expander.

Counterpart of ``kandinsky5_tpu/text/qwen.py``. The text transformer of
Qwen2.5-VL-7B-Instruct (the vision tower is never used: prompts are text
only, so mRoPE reduces to 1-D RoPE):

  * GQA attention (28 query / 4 kv heads of 128) with rotary embeddings
    (theta 1e6), QKV biases;
  * RMSNorm (eps 1e-6), SwiGLU MLP, an untied ``lm_head``;
  * ``hidden_states[-1]`` in HF is the post-final-norm sequence, which is
    what the conditioner reads (:func:`qwen_hidden_states`);
  * greedy or sampled decoding into a preallocated KV cache for prompt
    expansion (:func:`qwen_generate`).

The modules carry HF's names (``embed_tokens``, ``layers.N.self_attn.
q_proj``, ``norm``, ``lm_head``, ...), so a converted reference state dict
(``checkpoint.convert_qwen_state_dict``) loads by name. The math copies the
JAX package's cast points: every projection accumulates in fp32 and adds
its bias in fp32 before the cast, RoPE runs in fp32, the attention scores
are fp32 with masked entries at -1e30 and the probabilities are cast to the
value dtype before PV, and RMSNorm casts before it multiplies by the
weight. No TPU kernel is on this path: all of it is plain PyTorch.

The sharded tower (the JAX ``qwen_param_specs`` / ``shard_qwen_params``,
over the sp * tp ranks of a mesh): :func:`shard_qwen` gives a rank its
1/n of every large matrix (:func:`qwen_param_specs`) and the same
functions then run it with the collectives that make them compute what
the whole tower computes: the column-parallel q/k/v outputs all-gathered
along their features before RoPE and attention (a shard may hold half a
head; attention then runs whole on every rank), the row-parallel
``o_proj`` and ``down_proj`` on the rank's columns of their input with the
fp32 partial products summed over the group (their int8 scales applied
after the sum, their biases once), the embedding looked up on the rank's
hidden columns and gathered, ``lm_head``'s logits gathered.
:func:`init_qwen_shard_random` draws a rank's share without the whole
tower, and :func:`quantize_qwen_decode_params` on a share takes a
row-parallel scale from the max over the group. The pipeline does not
shard the tower (nor does the JAX pipeline): this is a function of the
package, as there.
"""

from __future__ import annotations

import copy
import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kandinsky5_tpu_torch.utils import default_device

# <|im_end|>, <|endoftext|>
EOS_DEFAULT = (151645, 151643)


@dataclass(frozen=True)
class QwenTextConfig:
    """Qwen2.5-VL-7B-Instruct text config defaults."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False


# ---------------------------------------------------------------------------
# Modules (parameter containers named like the HF checkpoint)
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))


class QuantLinear(nn.Module):
    """An int8 projection for the decode: ``weight_q`` (out, in) int8 and a
    per-output-channel ``scale`` (out,), with the original ``bias`` (a
    Parameter, or None)."""

    def __init__(self, weight_q, scale, bias=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scale", scale)
        self.bias = bias


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_attention_heads * d, **kw)
        self.k_proj = nn.Linear(h, cfg.num_key_value_heads * d, **kw)
        self.v_proj = nn.Linear(h, cfg.num_key_value_heads * d, **kw)
        self.o_proj = nn.Linear(cfg.num_attention_heads * d, h, bias=False,
                                **kw)


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, f, **kw)
        self.up_proj = nn.Linear(h, f, **kw)
        self.down_proj = nn.Linear(f, h, **kw)


class QwenDecoderLayer(nn.Module):
    def __init__(self, cfg: QwenTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = QwenAttention(cfg, **kw)
        self.mlp = QwenMLP(cfg, **kw)
        self.input_layernorm = RMSNorm(cfg.hidden_size, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **kw)


class QwenTextModel(nn.Module):
    """The text tower's parameters; the functions below run it."""

    def __init__(self, cfg: QwenTextConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(QwenDecoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, **kw)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 **kw)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed_tokens.weight.dtype


@torch.no_grad()
def init_qwen_params_random(cfg: QwenTextConfig, device=None,
                            dtype=torch.bfloat16, seed: int = 0,
                            scale: float = 0.02) -> QwenTextModel:
    """A full-size tower drawn on ``device`` (the CUDA card when None) in
    ``dtype`` from one seeded generator: every weight and bias uniform in
    +-scale, norm weights 1 (the JAX ``init_qwen_params_random`` scheme)."""
    device = default_device(device)
    with torch.device("meta"):
        model = QwenTextModel(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, prm in model.named_parameters():
        if "norm" in name:
            prm.fill_(1.0)
        else:
            prm.uniform_(-scale, scale, generator=gen)
    return model


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def qwen_rms_norm(x, weight, eps: float):
    xf = x.float()
    scale = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * weight


def qwen_rope(positions, head_dim: int, theta: float):
    """HF llama-style rotary tables: fp32 cos/sin (B, L, head_dim) with the
    frequency vector repeated twice (rotate-half convention)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    inv = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    freqs = positions.float()[..., None] * inv[None, None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, cos, sin):
    """x (B, L, H, D); cos/sin (B, L, D); computed in fp32."""
    xf = x.float()
    return (xf * cos[:, :, None] + rotate_half(xf) * sin[:, :, None]).to(x.dtype)


def _mm_f32(x, w):
    """x (..., in) @ w (out, in)^T with fp32 accumulation and an fp32
    result: on the card one bf16 GEMM with an fp32 output, elsewhere the
    product of the fp32 values."""
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                     out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def _lin(p, x):
    """The projection ``p`` (an ``nn.Linear`` or a :class:`QuantLinear`) of
    ``x`` without its bias, fp32. The int8 branch casts the codes to the
    activation dtype for the product and scales the fp32 result per output
    channel."""
    if isinstance(p, QuantLinear):
        return _mm_f32(x, p.weight_q.to(x.dtype)) * p.scale.float()
    return _mm_f32(x, p.weight)


def _split(p) -> Optional[int]:
    """The dim a sharded tower split ``p``'s weight on (:func:`shard_qwen`
    sets it): 0 column parallel, 1 row parallel, None whole."""
    return getattr(p, "split", None)


def _out(p, x, group=None):
    """:func:`_lin`, the rank's output columns all-gathered where ``p`` is
    column parallel."""
    y = _lin(p, x)
    return y if _split(p) is None else group.all_gather(y, dim=-1)


def _lin_bias(p, x, group=None):
    y = (_lin(p, x) + p.bias).to(x.dtype)
    return y if _split(p) is None else group.all_gather(y, dim=-1)


def _row(p, x, group=None):
    """:func:`_lin` of a row-parallel ``p`` (no bias): the rank's columns of
    ``x`` (``x`` whole, or already the rank's) times its columns of the
    weight, the fp32 partial products summed over ``group``, then an int8
    layer's scale. A whole ``p``: :func:`_lin`."""
    if _split(p) is None:
        return _lin(p, x)
    w = p.weight_q if isinstance(p, QuantLinear) else p.weight
    n = w.shape[1]
    if x.shape[-1] != n:
        x = x[..., group.rank * n:(group.rank + 1) * n]
    y = group.all_reduce(_mm_f32(x, w.to(x.dtype)))
    return y * p.scale.float() if isinstance(p, QuantLinear) else y


def _attn(p: QwenAttention, x, cos, sin, cfg: QwenTextConfig, mask,
          cache=None, cache_pos: int = 0, group=None):
    """GQA attention. ``mask`` (B, Lq, Lk) bool, True where allowed. With
    ``cache`` (2, B, max_len, hkv, d) the new keys and values are written at
    ``cache_pos`` and the queries attend over the whole cache. ``group``:
    the ranks of a sharded tower."""
    b, l, _ = x.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = _lin_bias(p.q_proj, x, group).reshape(b, l, hq, d)
    k = _lin_bias(p.k_proj, x, group).reshape(b, l, hkv, d)
    v = _lin_bias(p.v_proj, x, group).reshape(b, l, hkv, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        cache[0, :, cache_pos:cache_pos + l] = k
        cache[1, :, cache_pos:cache_pos + l] = v
        k, v = cache[0], cache[1]
    rep = hq // hkv
    # query head h reads kv head h // rep (jnp.repeat along the head axis);
    # bf16 values are exact in fp32, so these fp32 products are the bf16
    # products accumulated in fp32
    qg = q.float().reshape(b, l, hkv, rep, d).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qg @ kg.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    s = s.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    vg = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = (probs.float() @ vg).to(x.dtype)  # (b, hkv, rep, l, d)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, l, hq * d)
    return _row(p.o_proj, out, group).to(x.dtype)


def _mlp(p: QwenMLP, x, group=None):
    """SwiGLU. Sharded, gate and up keep the rank's columns (down_proj
    reads just those), unless down_proj is whole."""
    if _split(p.down_proj) is None:
        g, u = _out(p.gate_proj, x, group), _out(p.up_proj, x, group)
    else:
        g, u = _lin(p.gate_proj, x), _lin(p.up_proj, x)
    h = (F.silu(g) * u).to(x.dtype)
    return _row(p.down_proj, h, group).to(x.dtype)


def _layer(p: QwenDecoderLayer, x, cos, sin, cfg, mask, cache=None,
           cache_pos: int = 0, group=None):
    h = qwen_rms_norm(x, p.input_layernorm.weight, cfg.rms_norm_eps)
    x = x + _attn(p.self_attn, h, cos, sin, cfg, mask, cache, cache_pos,
                  group)
    h = qwen_rms_norm(x, p.post_attention_layernorm.weight, cfg.rms_norm_eps)
    return x + _mlp(p.mlp, h, group)


def _group(model: QwenTextModel):
    """The ranks a sharded tower (:func:`shard_qwen`) runs over, else None."""
    return getattr(model, "shard", None)


def _embed(model: QwenTextModel, ids):
    x = F.embedding(ids, model.embed_tokens.weight)
    if _split(model.embed_tokens) is None:
        return x
    return _group(model).all_gather(x, dim=-1)


def _logits(model: QwenTextModel, x):
    """fp32 logits of the last hidden states ``x`` (gathered when
    ``lm_head`` is sharded)."""
    return _out(model.lm_head, x, _group(model))


@torch.no_grad()
def qwen_hidden_states(model: QwenTextModel, input_ids, attention_mask):
    """(B, L) ids and (B, L) bool mask -> (B, L, hidden) post-final-norm
    hidden states (HF ``output_hidden_states[-1]``)."""
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(input_ids).to(dev).long()
    valid = torch.as_tensor(attention_mask).to(dev).bool()
    b, l = ids.shape
    x = _embed(model, ids)
    positions = torch.arange(l, device=dev)[None].expand(b, l)
    cos, sin = qwen_rope(positions, cfg.head_dim, cfg.rope_theta)
    causal = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    mask = causal[None] & valid[:, None, :]
    for layer in model.layers:
        x = _layer(layer, x, cos, sin, cfg, mask, group=_group(model))
    return qwen_rms_norm(x, model.norm.weight, cfg.rms_norm_eps)


def qwen_encode(model: QwenTextModel, input_ids, attention_mask,
                crop_start: int):
    """Conditioning embeddings: ``hidden_states[-1][:, crop_start:]`` and the
    cropped mask (the reference's varlen packing, padded instead)."""
    hidden = qwen_hidden_states(model, input_ids, attention_mask)
    mask = torch.as_tensor(attention_mask).to(hidden.device).bool()
    return hidden[:, crop_start:], mask[:, crop_start:]


# ---------------------------------------------------------------------------
# int8 decode weights (prompt expansion only)
# ---------------------------------------------------------------------------

def _quantize(w, group=None):
    """Per-out-channel int8 codes and scales of ``w`` (out, in); with
    ``group`` ``w`` holds the rank's input columns and the max is taken
    over the group's (exact: the whole weight's scale)."""
    a = w.float().abs().amax(dim=1, keepdim=True)
    if group is not None:
        a = group.all_reduce(a, op="max")
    scale = a.clamp_min(1e-8) / 127.0
    wq = torch.round(w.float() / scale).clamp(-127, 127).to(torch.int8)
    return wq, scale[:, 0]


def _quant_linear(lin: nn.Linear, group=None) -> QuantLinear:
    split = _split(lin)
    wq, scale = _quantize(lin.weight, group if split == 1 else None)
    out = QuantLinear(wq, scale, lin.bias)
    if split is not None:
        out.split = split
    return out


@torch.no_grad()
def quantize_qwen_decode_params(model: QwenTextModel) -> QwenTextModel:
    """Per-output-channel symmetric int8 of every large projection (q/k/v/o,
    gate/up/down, lm_head), for the decode of prompt expansion only; the
    conditioning encoder keeps the dense weights. Norms, biases and the
    embedding table are shared with ``model``, which is left unchanged.
    The product casts the codes back to the activation dtype, so in plain
    PyTorch the weight traffic of a token does not halve. A rank's share
    (:func:`shard_qwen`) quantizes its row-parallel layers with the max
    over the group (every rank calls this together): the slices of the
    whole tower's int8 tree."""
    group = _group(model)
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.lm_head = _quant_linear(model.lm_head, group)
    layers = []
    for layer in model.layers:
        nl = copy.copy(layer)
        nl._modules = dict(layer._modules)
        for part, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                           "o_proj")),
                            ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            sub = copy.copy(getattr(layer, part))
            sub._modules = dict(getattr(layer, part)._modules)
            for n in names:
                setattr(sub, n, _quant_linear(getattr(sub, n), group))
            setattr(nl, part, sub)
        layers.append(nl)
    out.layers = nn.ModuleList(layers)
    return out


# ---------------------------------------------------------------------------
# The sharded tower
# ---------------------------------------------------------------------------

# row parallel: the input (contraction) axis splits, the partial products
# are summed over the ranks
_ROW_PARALLEL = ("o_proj", "down_proj")


def qwen_param_specs(model: QwenTextModel, n: int) -> Dict[str, Optional[int]]:
    """The split dim of every parameter and buffer of ``model`` (the whole
    tower, dense or the int8 decode tree) over ``n`` ranks, by state-dict
    name, in the port's layouts (a projection (out, in), the embedding
    (vocab, hidden)): the JAX ``qwen_param_specs``. Column parallel on the
    out axis (dim 0): q/k/v/gate/up and ``lm_head``, with their biases and
    int8 ``scale``s; ``embed_tokens`` on its hidden axis (dim 1); row
    parallel on the in axis (dim 1): ``o_proj`` and ``down_proj``, whose
    biases and scales stay whole; the norms whole (None), and any leaf whose
    split dim does not divide by ``n``."""
    specs = {}
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        parts = name.split(".")
        row = any(p in _ROW_PARALLEL for p in parts)
        dim = None
        if parts[-1] in ("weight", "weight_q") and "norm" not in name:
            dim = 1 if row or parts[0] == "embed_tokens" else 0
        elif parts[-1] in ("bias", "scale") and not row:
            dim = 0
        if dim is not None and t.shape[dim] % n:
            dim = None
        specs[name] = dim
    return specs


def _shard_tree(model: QwenTextModel, specs, group, take) -> QwenTextModel:
    """A copy of ``model``'s module tree whose tensors are ``take(name,
    tensor, dim)`` (called in ``named_parameters``' order, then the
    buffers of each module), holding the group and each projection's
    split dim."""

    def visit(mod, prefix):
        out = copy.copy(mod)
        out._parameters = {
            k: None if v is None else nn.Parameter(
                take(prefix + k, v, specs[prefix + k]), requires_grad=False)
            for k, v in mod._parameters.items()}
        out._buffers = {k: None if v is None
                        else take(prefix + k, v, specs[prefix + k])
                        for k, v in mod._buffers.items()}
        out._modules = {k: visit(v, f"{prefix}{k}.")
                        for k, v in mod._modules.items()}
        key = prefix + ("weight_q" if isinstance(mod, QuantLinear)
                        else "weight")
        if specs.get(key) is not None and "norm" not in key:
            out.split = specs[key]
        return out

    local = visit(model, "")
    local.shard = group
    return local


def _narrow(t, dim, group):
    if dim is None:
        return t
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.rank * n, n).contiguous()


@torch.no_grad()
def shard_qwen(model: QwenTextModel, group) -> QwenTextModel:
    """Rank ``group.rank``'s share of the whole tower ``model`` (dense, or
    the int8 decode tree of :func:`quantize_qwen_decode_params`) over
    ``group`` (a ``parallel.ranks.RankGroup``, such as a mesh's ``shard``
    group of its sp * tp ranks; every rank of it calls this): a
    :class:`QwenTextModel` holding the slices :func:`qwen_param_specs`
    gives (whole leaves shared with ``model``), on which
    :func:`qwen_hidden_states`, :func:`qwen_encode` and
    :func:`qwen_generate` run the group's collectives and compute what
    ``model`` computes (to the order of the fp32 sums)."""
    specs = qwen_param_specs(model, group.size)
    return _shard_tree(model, specs, group,
                       lambda name, t, dim: _narrow(t, dim, group))


@torch.no_grad()
def init_qwen_shard_random(cfg: QwenTextConfig, group, dtype=torch.bfloat16,
                           seed: int = 0, scale: float = 0.02
                           ) -> QwenTextModel:
    """Rank ``group.rank``'s share (as :func:`shard_qwen` cuts it) of
    ``init_qwen_params_random(cfg, dtype=dtype, seed=seed, scale=scale)``
    on the group's device, each tensor drawn whole in that function's order
    from its seeded generator and cut at once: the rank never holds the
    whole tower."""
    device = group.device
    with torch.device("meta"):
        shapes = QwenTextModel(cfg, dtype=dtype)
    specs = qwen_param_specs(shapes, group.size)
    gen = torch.Generator(device=device).manual_seed(seed)

    def take(name, t, dim):
        full = torch.empty(t.shape, device=device, dtype=dtype)
        if "norm" in name:
            full.fill_(1.0)
        else:
            full.uniform_(-scale, scale, generator=gen)
        return _narrow(full, dim, group)

    return _shard_tree(shapes, specs, group, take)


# ---------------------------------------------------------------------------
# Generation (prompt expansion)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _prefill(model: QwenTextModel, ids, max_len: int):
    """Run the prompt (B, L) into a fresh KV cache (n_layers, 2, B, max_len,
    hkv, d); returns the cache and the fp32 logits (B, vocab) of the last
    position."""
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(ids).to(dev).long()
    b, l = ids.shape
    x = _embed(model, ids)
    positions = torch.arange(l, device=dev)[None].expand(b, l)
    cos, sin = qwen_rope(positions, cfg.head_dim, cfg.rope_theta)
    mask = torch.zeros((1, l, max_len), dtype=torch.bool, device=dev)
    mask[0, :, :l] = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    caches = torch.zeros((cfg.num_hidden_layers, 2, b, max_len,
                          cfg.num_key_value_heads, cfg.head_dim),
                         dtype=x.dtype, device=dev)
    for layer, cache in zip(model.layers, caches):
        x = _layer(layer, x, cos, sin, cfg, mask, cache, 0, _group(model))
    x = qwen_rms_norm(x, model.norm.weight, cfg.rms_norm_eps)
    return caches, _logits(model, x[:, -1])


def _process_logits(logits, presence, *, temperature: float, top_p: float,
                    top_k: int, rep_penalty: float):
    """HF LogitsProcessor semantics: repetition penalty over every token
    seen (prompt and generated), then temperature, top-k, top-p."""
    if rep_penalty != 1.0:
        pen = torch.where(logits > 0, logits / rep_penalty,
                          logits * rep_penalty)
        logits = torch.where(presence[None], pen, logits)
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)[0][..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True)[0]
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # HF TopPLogitsWarper: drop the tokens whose cumulative probability
        # exclusive of themselves already reaches top_p (keeps at least one)
        cutoff = (~((cum - probs) >= top_p)).sum(-1, keepdim=True) - 1
        thresh = sorted_logits.gather(-1, cutoff)
        logits = logits.masked_fill(logits < thresh, -math.inf)
    return logits


def _pick_token(logits, presence, generator, *, do_sample: bool,
                temperature: float, top_p: float, top_k: int,
                rep_penalty: float):
    logits = _process_logits(logits, presence, temperature=temperature,
                             top_p=top_p, top_k=top_k, rep_penalty=rep_penalty)
    if do_sample:
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return logits.argmax(dim=-1)


@torch.no_grad()
def qwen_generate(model: QwenTextModel, input_ids, max_new_tokens: int = 256,
                  eos_token_ids: Sequence[int] = EOS_DEFAULT,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_p: float = 1.0, top_k: int = 0,
                  repetition_penalty: float = 1.0, seed: int = 0) -> np.ndarray:
    """Autoregressive decode of one prompt, greedy by default; returns the
    new token ids (an EOS ends the decode and is not returned). The first
    token comes from the prefill's logits; each next one from one step over
    the preallocated cache with the mask ``arange(max_len) <= pos``.
    Sampling draws from a ``torch.Generator`` seeded with ``seed`` on the
    model's device (its draws cannot match ``jax.random``'s)."""
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(np.asarray(input_ids)).reshape(1, -1).to(dev).long()
    prompt_len = ids.shape[1]
    max_len = prompt_len + max_new_tokens
    caches, logits = _prefill(model, ids, max_len)
    presence = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
    presence[ids[0]] = True
    gen = torch.Generator(device=dev).manual_seed(seed)
    knobs = dict(do_sample=do_sample, temperature=float(temperature),
                 top_p=float(top_p), top_k=int(top_k),
                 rep_penalty=float(repetition_penalty))
    eos = set(int(e) for e in eos_token_ids)
    positions = torch.arange(max_len, device=dev)
    cos_all, sin_all = qwen_rope(positions[None], cfg.head_dim, cfg.rope_theta)
    out = []
    token = _pick_token(logits, presence, gen, **knobs)
    pos = prompt_len
    while True:
        t = int(token[0])
        presence[t] = True
        if t in eos:
            break
        out.append(t)
        if len(out) >= max_new_tokens:
            break
        x = _embed(model, token[:, None])
        cos, sin = cos_all[:, pos:pos + 1], sin_all[:, pos:pos + 1]
        mask = (positions <= pos)[None, None]
        for layer, cache in zip(model.layers, caches):
            x = _layer(layer, x, cos, sin, cfg, mask, cache, pos,
                       _group(model))
        x = qwen_rms_norm(x, model.norm.weight, cfg.rms_norm_eps)
        token = _pick_token(_logits(model, x[:, -1]), presence, gen,
                            **knobs)
        pos += 1
    return np.asarray(out, dtype=np.int32)


def qwen_generate_greedy(model: QwenTextModel, input_ids,
                         max_new_tokens: int = 256,
                         eos_token_ids: Sequence[int] = EOS_DEFAULT
                         ) -> np.ndarray:
    """Deterministic greedy decode (:func:`qwen_generate`'s default)."""
    return qwen_generate(model, input_ids, max_new_tokens=max_new_tokens,
                         eos_token_ids=eos_token_ids)
