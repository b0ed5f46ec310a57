"""DiffusionTransformer3D — the 2B Kandinsky-5 DiT in PyTorch.

Counterpart of ``kandinsky5_tpu/models/dit.py``. The module tree carries
the released checkpoint's names (``visual_transformer_blocks.0.
self_attention.to_query.weight``, ...), so a reference safetensors file
loads with ``load_state_dict`` and no conversion. The blocks run as a
Python loop (the JAX package scans stacked blocks). The stage split
prologue / visual blocks / epilogue is kept. With :class:`SparseParams`
(the 10 s configs) the visual tokens and their RoPE tables go into fractal
order in the prologue, every visual self-attention runs NABLA
(``ops/nabla.py``, kernel K6) and the epilogue restores the order; text
blocks and cross-attention stay dense.

Tensor parallelism: a model built with ``tp=TensorParallel(...)`` (see
``parallel/sharding.py`` ``shard_dit`` and ``fast_init_dit_shard``) is one
rank's share, and :func:`dit_forward` computes what the JAX DiT computes
under a ``(1, 1, tp)`` mesh. Each visual block's self- and cross-attention
project the rank's num_heads / tp heads (Q/K/V column parallel, with their
biases; the QK RMSNorm is per head and stays local), attend over them, and
sum the row-parallel out layer over the group before adding its bias once;
the FF is the Megatron FF with K8 (``models/nn.py`` ``feed_forward``). The
residual stream, the modulations, the embeddings, RoPE, the text blocks and
the out layer are replicated: every rank computes them whole. The JAX
package shards the residual over the sequence between blocks
(``constrain_seq``), a placement that changes no arithmetic; plain
Megatron keeps it replicated, as here.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.nn import (
    Attention,
    FeedForward,
    Modulation,
    TextEmbeddings,
    TimeEmbeddings,
    VisualEmbeddings,
    apply_gate_sum,
    apply_rotary,
    apply_scale_shift_norm,
    feed_forward,
    linear,
    modulated_feed_forward,
    modulation,
    quantize_linear,
    qkv_proj,
    rms_norm,
    rope_1d,
    rope_3d,
    row_parallel_linear,
    text_embeddings,
    time_embeddings,
    unpatchify,
    visual_embeddings,
)
from kandinsky5_tpu_torch.ops.attention import INT8_IMPLS, attention
from kandinsky5_tpu_torch.ops.fractal import fractal_flatten, fractal_unflatten
from kandinsky5_tpu_torch.ops.nabla import nabla_attention
from kandinsky5_tpu_torch.utils import default_device


class SparseParams(NamedTuple):
    """NABLA parameters of one generation, faithful mode: the sliding-tile
    block mask (S/64, S/64) bool on the model's device and the top-CDF mass
    threshold P."""

    sta: torch.Tensor
    P: float


class TransformerEncoderBlock(nn.Module):
    """Text block: AdaLN self-attention + modulated FF."""

    def __init__(self, cfg: DiTParams, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.text_modulation = Modulation(cfg.time_dim, cfg.model_dim, 6, **kw)
        self.self_attention = Attention(cfg.model_dim, cfg.head_dim, **kw)
        self.feed_forward = FeedForward(cfg.model_dim, cfg.ff_dim, **kw)


class TransformerDecoderBlock(nn.Module):
    """Visual block: AdaLN self-attention + cross-attention + modulated FF;
    with ``tp > 1`` one rank's share of its attention and FF."""

    def __init__(self, cfg: DiTParams, device=None, dtype=None, tp: int = 1):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.visual_modulation = Modulation(cfg.time_dim, cfg.model_dim, 9,
                                            **kw)
        self.self_attention = Attention(cfg.model_dim, cfg.head_dim, tp=tp,
                                        **kw)
        self.cross_attention = Attention(cfg.model_dim, cfg.head_dim, tp=tp,
                                         **kw)
        self.feed_forward = FeedForward(cfg.model_dim, cfg.ff_dim // tp, **kw)


class OutLayer(nn.Module):
    def __init__(self, cfg: DiTParams, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.modulation = Modulation(cfg.time_dim, cfg.model_dim, 2, **kw)
        self.out_layer = nn.Linear(
            cfg.model_dim, math.prod(cfg.patch_size) * cfg.out_visual_dim, **kw)


class DiffusionTransformer3D(nn.Module):
    """Parameter tree of the DiT; :func:`dit_forward` runs it. With ``tp``
    (a :class:`~kandinsky5_tpu_torch.parallel.TensorParallel`) the visual
    blocks hold that rank's share and the forward runs its collectives
    over ``tp``. ``model.tp`` is the group when it spans more than one rank,
    else None: a group of one runs the single-device path, K2 included."""

    def __init__(self, cfg: DiTParams, device=None, dtype=torch.bfloat16,
                 tp=None):
        super().__init__()
        self.cfg = cfg
        n = 1 if tp is None else tp.size
        self.tp = tp if n > 1 else None
        if cfg.num_heads % n or cfg.ff_dim % n:
            raise ValueError(f"{cfg.num_heads} heads and ff_dim {cfg.ff_dim} "
                             f"do not split over {n} ranks")
        kw = dict(device=device, dtype=dtype)
        self.time_embeddings = TimeEmbeddings(cfg.model_dim, cfg.time_dim, **kw)
        self.text_embeddings = TextEmbeddings(cfg.in_text_dim, cfg.model_dim,
                                              **kw)
        self.pooled_text_embeddings = TextEmbeddings(cfg.in_text_dim2,
                                                     cfg.time_dim, **kw)
        self.visual_embeddings = VisualEmbeddings(cfg.patch_dim, cfg.model_dim,
                                                  **kw)
        self.text_transformer_blocks = nn.ModuleList(
            TransformerEncoderBlock(cfg, **kw)
            for _ in range(cfg.num_text_blocks))
        self.visual_transformer_blocks = nn.ModuleList(
            TransformerDecoderBlock(cfg, tp=n, **kw)
            for _ in range(cfg.num_visual_blocks))
        self.out_layer = OutLayer(cfg, **kw)

    @property
    def dtype(self):
        return self.visual_embeddings.in_layer.weight.dtype

    def forward(self, x, text_embed, pooled_text_embed, time, text_mask=None,
                scale_factor=(1.0, 1.0, 1.0), attn_impl="auto", sparse=None):
        return dit_forward(self, x, text_embed, pooled_text_embed, time,
                           text_mask, scale_factor, attn_impl, sparse)


def _mod_params(mod_vec, n: int):
    """Split (B, n*D) into n (B, 1, D) chunks."""
    b, nd = mod_vec.shape
    m = mod_vec.reshape(b, n, nd // n)
    return [m[:, i][:, None, :] for i in range(n)]


def _self_attention(p, x, rope, num_heads, kv_mask, attn_impl,
                    sparse: Optional[SparseParams] = None, tp=None):
    """``num_heads`` is the heads this rank holds; with ``tp`` the out layer
    is row parallel over it."""
    b, l, _ = x.shape
    q, k, v = qkv_proj(p, x, num_heads)
    if rope is not None:
        cos, sin = rope
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    if sparse is not None:
        out = nabla_attention(q, k, v, sparse.sta, thr=sparse.P)
    else:
        out = attention(q, k, v, kv_mask=kv_mask, impl=attn_impl)
    return row_parallel_linear(p.out_layer, out.reshape(b, l, -1), tp)


def _cross_attention(p, x, cond, num_heads, kv_mask, attn_impl, tp=None):
    b, l, _ = x.shape
    bc, lc, _ = cond.shape
    q = linear(p.to_query, x).reshape(b, l, num_heads, -1)
    k = linear(p.to_key, cond).reshape(bc, lc, num_heads, -1)
    v = linear(p.to_value, cond).reshape(bc, lc, num_heads, -1)
    q = rms_norm(q, p.query_norm.weight).to(x.dtype)
    k = rms_norm(k, p.key_norm.weight).to(x.dtype)
    out = attention(q, k, v, kv_mask=kv_mask, impl=attn_impl)
    return row_parallel_linear(p.out_layer, out.reshape(b, l, -1), tp)


def text_encoder_block(p, x, time_embed, rope, kv_mask, num_heads, attn_impl,
                       mesh: bool = False):
    """Text block; its weights are whole on every rank, so it runs no
    collective. ``mesh``: the model runs under tensor parallelism, where K2
    steps aside and the FF is the unfused chain, as in the JAX package
    (whose K8 gate declines the 256 text rows)."""
    mod = modulation(p.text_modulation, time_embed)
    shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = _mod_params(mod, 6)
    out = apply_scale_shift_norm(x, scale_sa, shift_sa)
    out = _self_attention(p.self_attention, out, rope, num_heads, kv_mask,
                          attn_impl)
    x = apply_gate_sum(x, out, gate_sa)
    if mesh:
        out = feed_forward(p.feed_forward,
                           apply_scale_shift_norm(x, scale_ff, shift_ff))
        return apply_gate_sum(x, out, gate_ff)
    return modulated_feed_forward(p.feed_forward, x, scale_ff, shift_ff,
                                  gate_ff)


def visual_decoder_block(p, visual, text, time_embed, rope, text_mask,
                         num_heads, attn_impl,
                         sparse: Optional[SparseParams] = None, tp=None):
    """Visual block; with ``tp`` the rank's share (``num_heads`` / tp heads
    of attention, ff_dim / tp of the FF) and its collectives."""
    heads = num_heads if tp is None else num_heads // tp.size
    mod = modulation(p.visual_modulation, time_embed)
    (shift_sa, scale_sa, gate_sa, shift_ca, scale_ca, gate_ca,
     shift_ff, scale_ff, gate_ff) = _mod_params(mod, 9)
    out = apply_scale_shift_norm(visual, scale_sa, shift_sa)
    out = _self_attention(p.self_attention, out, rope, heads, None,
                          attn_impl, sparse, tp)
    visual = apply_gate_sum(visual, out, gate_sa)
    out = apply_scale_shift_norm(visual, scale_ca, shift_ca)
    out = _cross_attention(p.cross_attention, out, text, heads, text_mask,
                           attn_impl, tp)
    visual = apply_gate_sum(visual, out, gate_ca)
    return modulated_feed_forward(p.feed_forward, visual, scale_ff, shift_ff,
                                  gate_ff, tp)


def dit_prologue(model: DiffusionTransformer3D, x, text_embed,
                 pooled_text_embed, time, text_mask,
                 scale_factor: Sequence[float], attn_impl: str = "auto",
                 to_fractal: bool = False):
    """Embeddings + text blocks + visual RoPE tables, the visual tokens and
    tables in fractal order when ``to_fractal``. Returns (visual (B, S, D),
    text (B, L, D), time_embed (B, time_dim) fp32, (cos, sin), grid)."""
    cfg = model.cfg
    b, t, h, w, _ = x.shape
    grid = (t // cfg.patch_size[0], h // cfg.patch_size[1],
            w // cfg.patch_size[2])
    text = text_embeddings(model.text_embeddings, text_embed)
    time_embed = time_embeddings(model.time_embeddings, time, cfg.model_dim)
    pooled = text_embeddings(model.pooled_text_embeddings, pooled_text_embed)
    time_embed = time_embed + pooled.float()

    visual = visual_embeddings(model.visual_embeddings, x, cfg.patch_size)
    visual = visual.reshape(b, -1, cfg.model_dim)

    dev = x.device
    text_rope = rope_1d(torch.arange(text.shape[1], device=dev), cfg.head_dim)
    mesh = model.tp is not None
    for blk in model.text_transformer_blocks:
        text = text_encoder_block(blk, text, time_embed, text_rope, text_mask,
                                  cfg.num_heads, attn_impl, mesh)
    positions = tuple(torch.arange(g, device=dev) for g in grid)
    cos, sin = rope_3d(grid, positions, cfg.axes_dims, scale_factor)
    if to_fractal:
        visual = fractal_flatten(visual, grid)
        cos = fractal_flatten(cos[None], grid)[0]
        sin = fractal_flatten(sin[None], grid)[0]
    return visual, text, time_embed, (cos, sin), grid


def dit_visual_blocks(model: DiffusionTransformer3D, visual, text, time_embed, rope,
                      text_mask, attn_impl: str = "auto",
                      sparse: Optional[SparseParams] = None):
    """The visual block stack as a Python loop."""
    tp = model.tp
    if tp is not None and (sparse is not None or attn_impl in INT8_IMPLS):
        raise ValueError(
            "NABLA and int8-QK attention under tensor parallelism are not "
            "ported yet (ROADMAP.md, queue 1, item 7)")
    for blk in model.visual_transformer_blocks:
        visual = visual_decoder_block(blk, visual, text, time_embed, rope,
                                      text_mask, model.cfg.num_heads, attn_impl,
                                      sparse, tp)
    return visual


def dit_epilogue(model: DiffusionTransformer3D, visual, time_embed, grid,
                 to_fractal: bool = False):
    """Back to row-major token order (when ``to_fractal``), AdaLN-modulated
    out layer, unpatchify."""
    cfg = model.cfg
    visual = fractal_unflatten(visual, grid, block_mask=to_fractal)
    p = model.out_layer
    shift, scale = _mod_params(modulation(p.modulation, time_embed), 2)
    visual = apply_scale_shift_norm(visual, scale, shift)
    x = linear(p.out_layer, visual)
    x = x.reshape(x.shape[0], *grid, x.shape[-1])
    return unpatchify(x, cfg.patch_size, cfg.out_visual_dim)


@torch.no_grad()
def dit_forward(model: DiffusionTransformer3D, x, text_embed,
                pooled_text_embed, time, text_mask=None,
                scale_factor: Sequence[float] = (1.0, 1.0, 1.0),
                attn_impl: str = "auto",
                sparse: Optional[SparseParams] = None):
    """(B, T, H, W, C_in) -> (B, T, H, W, out_visual_dim). ``time`` is
    (B,) already scaled by 1000; ``sparse`` selects the NABLA path."""
    to_fractal = sparse is not None
    visual, text, time_embed, rope, grid = dit_prologue(
        model, x, text_embed, pooled_text_embed, time, text_mask,
        scale_factor, attn_impl, to_fractal)
    visual = dit_visual_blocks(model, visual, text, time_embed, rope,
                               text_mask, attn_impl, sparse)
    return dit_epilogue(model, visual, time_embed, grid, to_fractal)


# ---------------------------------------------------------------------------
# Initialization (tests and smoke runs; real weights come via checkpoint.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_dit_params(cfg: DiTParams, device=None, dtype=torch.bfloat16,
                    seed: int = 0) -> DiffusionTransformer3D:
    """The JAX ``init_dit_params`` scheme: linears uniform in +-1/sqrt(in),
    zero biases, norms at one, modulation weights at ZERO (so every block
    starts as an identity). ``device=None`` means the CUDA card."""
    device = default_device(device)
    model = DiffusionTransformer3D(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            if "modulation" in name:
                mod.weight.zero_()
            else:
                k = 1.0 / math.sqrt(mod.in_features)
                w = torch.empty(mod.weight.shape, device=mod.weight.device,
                                dtype=torch.float32)
                mod.weight.copy_(w.uniform_(-k, k, generator=gen))
            if mod.bias is not None:
                mod.bias.zero_()
    return model


@torch.no_grad()
def fast_init_dit_params(cfg: DiTParams, device=None, dtype=torch.bfloat16,
                         seed: int = 0, scale: float = 0.02
                         ) -> DiffusionTransformer3D:
    """Every parameter uniform in +-scale from one seeded generator, drawn
    on ``device``, the CUDA card when None (the JAX ``fast_init_dit_params``
    scheme: modulation is not zero, so every block does work)."""
    device = default_device(device)
    model = DiffusionTransformer3D(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for prm in model.parameters():
        prm.uniform_(-scale, scale, generator=gen)
    return model


def _shallow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that shares its parameters and buffers but owns
    its table of submodules, so replacing a child leaves ``module`` as it
    was."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    return out


@torch.no_grad()
def quantize_dit_params(model: DiffusionTransformer3D) -> DiffusionTransformer3D:
    """W8A8 model of the visual blocks' projections, as the JAX
    ``quantize_dit_params``: the self- and cross-attention Q/K/V/out and
    the FF in/out layers of every visual block become
    :class:`~kandinsky5_tpu_torch.models.nn.Int8Linear`. Text blocks, norms,
    modulations and embeddings stay as they are. Returns a new model that
    shares every unquantized tensor with ``model``; ``model`` is left
    unchanged (the JAX function returns a new tree too)."""
    out = _shallow(model)
    blocks = _shallow(model.visual_transformer_blocks)
    for i, blk in enumerate(model.visual_transformer_blocks):
        nb = _shallow(blk)
        for attn in ("self_attention", "cross_attention"):
            a = _shallow(getattr(blk, attn))
            for proj in ("to_query", "to_key", "to_value", "out_layer"):
                setattr(a, proj, quantize_linear(getattr(a, proj)))
            setattr(nb, attn, a)
        ff = _shallow(blk.feed_forward)
        ff.in_layer = quantize_linear(ff.in_layer)
        ff.out_layer = quantize_linear(ff.out_layer)
        nb.feed_forward = ff
        blocks[i] = nb
    out.visual_transformer_blocks = blocks
    return out


def is_quantized(model: DiffusionTransformer3D) -> bool:
    """Whether ``model`` holds W8A8 projections (:func:`quantize_dit_params`)."""
    return any(k.endswith("weight_i8") for k, _ in model.named_buffers())
