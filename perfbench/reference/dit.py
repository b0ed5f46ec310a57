"""Plain float32 reference of one Kandinsky-5 DiT step.

Written from the published architecture (the released 2B DiT,
``kandinsky/models/dit.py`` of ai-forever/Kandinsky-5) and the port's
plain code, imports nothing of the port and takes nothing it made: the
weights come as the benchmark made them (a dict keyed by the released
checkpoint's names), the inputs as the benchmark drew them. Every product
is float32 with TF32 off (:func:`fp32_exact`), every normalisation float32.

Where the port rounds (bf16 activations, the NABLA pooled means rounded to
bf16, K1's fixed shift), this reference does not; those roundings are the
program's error that the benchmark measures.

Attention runs in blocks of query rows so that the score matrix fits: the
softmax takes one global shift, a bound on every score (max |q| max |k| /
sqrt(d)), which is exact as long as no row underflows; a row whose weights
all underflow is recomputed with its own maximum.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5
RMS_EPS = float(np.finfo(np.float32).eps)
BLOCK = 64          # NABLA block: 64 tokens, one (1, 8, 8) tile
TILE = 8
# fp32 score elements of one attention block (1 GiB: enough rows that the
# product with V, whose output is only rows x 65, still fills the card)
SCORE_CHUNK = 1 << 28


@contextlib.contextmanager
def fp32_exact():
    """Full float32 products: TF32 off for matmul and cuDNN, restored on
    exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t):
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude at 448): the control's precision."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Weights:
    """Float32 views of the benchmark's weights, cast on use. With ``lowp``
    (the control) every product's operands are rounded to float8 first."""

    def __init__(self, params: dict, lowp: bool = False):
        self.p = params
        self.lowp = lowp

    def w(self, name: str) -> torch.Tensor:
        return self.p[name].float()

    def lin(self, name: str, x):
        b = self.p.get(name + ".bias")
        w = self.w(name + ".weight")
        if self.lowp:
            x, w = fp8(x), fp8(w)
        return F.linear(x, w, None if b is None else b.float())


def layer_norm(x, weight=None, bias=None):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, weight):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) * weight


def freqs(dim: int, device) -> torch.Tensor:
    f = np.exp(-math.log(10000.0) * np.arange(dim, dtype=np.float32) / dim)
    return torch.from_numpy(f.astype(np.float32)).to(device)


def rope_1d(n: int, head_dim: int, device):
    args = torch.outer(torch.arange(n, device=device).float(),
                       freqs(head_dim // 2, device))
    return torch.cos(args), torch.sin(args)


def rope_3d(grid, axes_dims, scale_factor, device):
    t, h, w = grid
    parts = []
    for ax, (dim, n, sf) in enumerate(zip(axes_dims, grid, scale_factor)):
        args = torch.outer(torch.arange(n, device=device).float(),
                           freqs(dim // 2, device)) / sf
        shape = [1, 1, 1, args.shape[-1]]
        shape[ax] = n
        parts.append(args.reshape(shape).expand(t, h, w, args.shape[-1]))
    args = torch.cat(parts, -1).reshape(t * h * w, -1)
    return torch.cos(args), torch.sin(args)


def rotate(x, cos, sin):
    """Rotate consecutive channel pairs; x (B, L, H, D), cos/sin (L, D/2)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([c * x0 - s * x1, s * x0 + c * x1], -1).flatten(-2)


def fractal_order(grid) -> np.ndarray:
    """perm[i]: the row-major index of the token at position i when every
    run of 64 tokens is one (1, 8, 8) tile, tiles in row-major order."""
    t, h, w = grid
    idx = np.arange(t * h * w).reshape(t, h // TILE, TILE, w // TILE, TILE)
    return idx.transpose(0, 1, 3, 2, 4).reshape(-1)


def sta_blocks(grid, wt: int, wh: int, ww: int) -> np.ndarray:
    """The sliding-tile mask over tiles: tile (t, h, w) sees (t', h', w')
    iff each distance is within half its window."""
    t, h, w = grid[0], grid[1] // TILE, grid[2] // TILE
    at, ah, aw = (np.arange(n) for n in (t, h, w))
    mt = np.abs(at[:, None] - at[None]) <= wt // 2
    mh = np.abs(ah[:, None] - ah[None]) <= wh // 2
    mw = np.abs(aw[:, None] - aw[None]) <= ww // 2
    m = mt[:, None, None, :, None, None] & mh[None, :, None, None, :, None] \
        & mw[None, None, :, None, None, :]
    return m.reshape(t * h * w, t * h * w)


def _row_block(n_rows: int, n_keys: int, align: int = 1) -> int:
    r = SCORE_CHUNK // max(1, n_keys)
    return max(align, min(n_rows, r // align * align))


def _prepare(q, k, v, kv_mask, shift=None):
    """Heads first: q scaled by 1/sqrt(d) (with ``shift``, a column of
    -shift beside it and one of ones beside k, so the product is the score
    less the shift), k transposed, and v with a column of ones (the
    normaliser), zeroed at masked keys."""
    lq, h, d = q.shape
    lk = k.shape[0]
    qh = (q / math.sqrt(d)).permute(1, 0, 2)                 # (H, L, D)
    kh = k.permute(1, 0, 2)                                  # (H, Lk, D)
    if shift is not None:
        qh = torch.cat([qh, (-shift).expand(h, lq, 1)], -1)
        kh = torch.cat([kh, torch.ones_like(kh[..., :1])], -1)
    ones = torch.ones((h, lk, 1), dtype=v.dtype, device=v.device)
    vh = torch.cat([v.permute(1, 0, 2), ones], -1)           # (H, Lk, D + 1)
    if kv_mask is not None:
        vh = vh * kv_mask.to(vh.dtype)[None, :, None]
    return qh.contiguous(), kh.transpose(1, 2).contiguous(), vh.contiguous()


def attention(q, k, v, kv_mask=None, block_mask=None, lowp: bool = False):
    """Exact softmax attention in float32, one item: q (L, H, D), k, v (Lk,
    H, D); ``kv_mask`` (Lk,) bool; ``block_mask`` (H, L/64, Lk/64) bool
    (NABLA), else dense. A masked key's weight is zeroed, and the
    normaliser is the sum of the kept weights (the extra column of ones
    beside V). One head and a block of query rows at a time; the
    three passes over a block's scores (the product, the exponential, the
    product with V) are each one large call. ``lowp`` (the control) rounds
    q, k, v and the weights to float8 before the products."""
    if lowp:
        q, k, v = fp8(q), fp8(k), fp8(v)
    lq, h, d = q.shape
    lk = k.shape[0]
    shift = (q.norm(dim=-1).amax() * k.norm(dim=-1).amax()
             / math.sqrt(d)).reshape(1, 1, 1)
    qh, kt, vh = _prepare(q, k, v, kv_mask, shift)
    out = torch.empty((h, lq, d), dtype=q.dtype, device=q.device)
    least = torch.full((), math.inf, device=q.device)
    step = _row_block(lq, lk, BLOCK if block_mask is not None else 1)
    keep = None if block_mask is None else block_mask.to(q.dtype)
    for hd in range(h):
        for lo in range(0, lq, step):
            hi = min(lq, lo + step)
            p = torch.mm(qh[hd, lo:hi], kt[hd]).exp_()
            if keep is not None:
                bm = keep[hd, lo // BLOCK:hi // BLOCK]
                p.view((hi - lo) // BLOCK, BLOCK, lk // BLOCK, BLOCK).mul_(
                    bm[:, None, :, None])
            if lowp:
                p = fp8(p)
            num = torch.mm(p, vh[hd])
            den = num[:, d:]
            least = torch.minimum(least, den.amin())
            torch.div(num[:, :d], den, out=out[hd, lo:hi])
    if float(least) < 1e-30:
        # some row's weights all underflowed under the global shift
        return attention_rowmax(q, k, v, kv_mask, block_mask)
    return out.permute(1, 0, 2)


def attention_rowmax(q, k, v, kv_mask=None, block_mask=None):
    """:func:`attention` with each row shifted by its own maximum."""
    lq, h, d = q.shape
    lk = k.shape[0]
    qh, kt, vh = _prepare(q, k, v, None)
    out = torch.empty((h, lq, d), dtype=q.dtype, device=q.device)
    step = _row_block(lq, lk, BLOCK if block_mask is not None else 1)
    for hd in range(h):
        for lo in range(0, lq, step):
            hi = min(lq, lo + step)
            s = torch.mm(qh[hd, lo:hi], kt[hd])
            if block_mask is not None:
                bm = block_mask[hd, lo // BLOCK:hi // BLOCK]
                keep = bm[:, None, :, None].expand(
                    -1, BLOCK, -1, BLOCK).reshape(hi - lo, lk)
                s = s.masked_fill(~keep, -math.inf)
            if kv_mask is not None:
                s = s.masked_fill(~kv_mask[None, :], -math.inf)
            out[hd, lo:hi] = torch.softmax(s, -1) @ vh[hd, :, :d]
    return out.permute(1, 0, 2)


def nabla_mask(q, k, sta, thr: float):
    """The faithful NABLA block mask of one item: the 64-token block means
    of q and k, the softmax of their scaled products over key blocks, each
    row's smallest blocks dropped while their cumulative mass stays under
    1 - thr, ORed with the sliding-tile mask. q, k (L, H, D) in tile order;
    returns (H, L/64, Lk/64) bool."""
    lq, h, d = q.shape
    qa = q.reshape(lq // BLOCK, BLOCK, h, d).mean(1)
    ka = k.reshape(-1, BLOCK, h, d).mean(1)
    amap = torch.softmax(torch.einsum("ihd,jhd->hij", qa, ka)
                         / math.sqrt(d), -1)
    vals, inds = torch.sort(amap, dim=-1, stable=True)
    keep_sorted = torch.cumsum(vals, -1) >= (1.0 - thr)
    keep = torch.empty_like(keep_sorted).scatter_(-1, inds, keep_sorted)
    return keep | sta[None]


def patchify(x, patch):
    b, t, h, w, c = x.shape
    p0, p1, p2 = patch
    x = x.reshape(b, t // p0, p0, h // p1, p1, w // p2, p2, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, t // p0, h // p1, w // p2, p0 * p1 * p2 * c)


def unpatchify(x, patch, out_dim):
    b, t, h, w, _ = x.shape
    p0, p1, p2 = patch
    x = x.reshape(b, t, h, w, out_dim, p0, p1, p2)
    return x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(
        b, t * p0, h * p1, w * p2, out_dim)


class DiTReference:
    """One step of the DiT in float32: ``velocity`` is the model's
    prediction.

    ``dit`` holds the published ``dit_params``; ``nabla`` the attention
    block of a NABLA config (P, wT, wH, wW) or None for dense attention;
    ``lowp`` makes it the control, every product's operands in float8."""

    def __init__(self, params: dict, dit: dict,
                 scale_factor: Sequence[float], nabla: Optional[dict] = None,
                 lowp: bool = False):
        self.W = Weights(params, lowp)
        self.lowp = lowp
        self.cfg = dit
        self.scale_factor = tuple(scale_factor)
        self.nabla = nabla
        self.head_dim = sum(dit["axes_dims"])
        self.heads = dit["model_dim"] // self.head_dim
        self.kept: list = []

    # -- blocks ------------------------------------------------------------
    def _mod(self, name, te, n):
        m = self.W.lin(name, F.silu(te))
        return m.reshape(n, -1).unbind(0)

    def _qkv(self, pre, x):
        W, h = self.W, self.heads
        q = W.lin(pre + "to_query", x).reshape(x.shape[0], h, -1)
        k = W.lin(pre + "to_key", x).reshape(x.shape[0], h, -1)
        v = W.lin(pre + "to_value", x).reshape(x.shape[0], h, -1)
        return (rms_norm(q, W.w(pre + "query_norm.weight")),
                rms_norm(k, W.w(pre + "key_norm.weight")), v)

    def _ff(self, pre, x):
        return self.W.lin(pre + "out_layer",
                          F.gelu(self.W.lin(pre + "in_layer", x)))

    def _self_attention(self, pre, x, rope, kv_mask=None, sparse=None):
        q, k, v = self._qkv(pre, x)
        q, k = rotate(q, *rope), rotate(k, *rope)
        block_mask = None
        if sparse is not None:
            block_mask = nabla_mask(q, k, sparse, self.nabla["P"])
            self.kept.append(float(block_mask.float().mean()))
        out = attention(q, k, v, kv_mask, block_mask, self.lowp)
        return self.W.lin(pre + "out_layer", out.reshape(x.shape[0], -1))

    def _cross_attention(self, pre, x, text, kv_mask):
        W, h = self.W, self.heads
        q = W.lin(pre + "to_query", x).reshape(x.shape[0], h, -1)
        k = W.lin(pre + "to_key", text).reshape(text.shape[0], h, -1)
        v = W.lin(pre + "to_value", text).reshape(text.shape[0], h, -1)
        q = rms_norm(q, W.w(pre + "query_norm.weight"))
        k = rms_norm(k, W.w(pre + "key_norm.weight"))
        out = attention(q, k, v, kv_mask, lowp=self.lowp)
        return W.lin(pre + "out_layer", out.reshape(x.shape[0], -1))

    def _text_block(self, i, x, te, rope, mask):
        pre = f"text_transformer_blocks.{i}."
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = self._mod(
            pre + "text_modulation.out_layer", te, 6)
        y = layer_norm(x) * (sc_a + 1) + sh_a
        x = x + g_a * self._self_attention(pre + "self_attention.", y, rope,
                                           kv_mask=mask)
        y = layer_norm(x) * (sc_f + 1) + sh_f
        return x + g_f * self._ff(pre + "feed_forward.", y)

    def _visual_block(self, i, x, text, te, rope, mask, sparse):
        pre = f"visual_transformer_blocks.{i}."
        (sh_a, sc_a, g_a, sh_c, sc_c, g_c, sh_f, sc_f, g_f) = self._mod(
            pre + "visual_modulation.out_layer", te, 9)
        y = layer_norm(x) * (sc_a + 1) + sh_a
        x = x + g_a * self._self_attention(pre + "self_attention.", y, rope,
                                           sparse=sparse)
        y = layer_norm(x) * (sc_c + 1) + sh_c
        x = x + g_c * self._cross_attention(pre + "cross_attention.", y,
                                            text, mask)
        y = layer_norm(x) * (sc_f + 1) + sh_f
        return x + g_f * self._ff(pre + "feed_forward.", y)

    def _visual_tables(self, grid, dev):
        """The visual tokens' RoPE tables, and on the NABLA path the tile
        order (``perm``, None when dense) they are put in and the
        sliding-tile mask over tiles (``sparse``)."""
        rope = rope_3d(grid, self.cfg["axes_dims"], self.scale_factor, dev)
        if self.nabla is None:
            return rope, None, None
        perm = torch.from_numpy(fractal_order(grid)).to(dev)
        sparse = torch.from_numpy(sta_blocks(
            grid, self.nabla["wT"], self.nabla["wH"], self.nabla["wW"])).to(dev)
        return (rope[0][perm], rope[1][perm]), perm, sparse

    @torch.no_grad()
    def visual_self_attention(self, i: int, y, grid):
        """The self-attention sublayer of visual block ``i`` alone, from
        its input ``y`` (1, S, D), the modulated norm of the block's
        tokens, in the order the step holds them (tiles on the NABLA path,
        whose mask this rebuilds from its own q and k); returns (S, D)."""
        with fp32_exact():
            rope, _, sparse = self._visual_tables(tuple(grid), y.device)
            return self._self_attention(
                f"visual_transformer_blocks.{i}.self_attention.",
                y[0].float(), rope, sparse=sparse)

    # -- the step ----------------------------------------------------------
    @torch.no_grad()
    def velocity(self, x, text_embeds, pooled, mask, t: float):
        """x (1, T, H, W, C) float32; text_embeds (1, L, 3584), pooled (1,
        768), mask (1, L) bool; t the step's time in [0, 1]."""
        cfg, W = self.cfg, self.W
        with fp32_exact():
            x = x.float()
            dev = x.device
            if cfg["visual_cond"]:
                x = torch.cat([x, torch.zeros_like(x),
                               torch.zeros_like(x[..., :1])], -1)
            d = cfg["model_dim"]
            tv = torch.tensor([t * 1000.0], device=dev)
            fr = freqs(d // 2, dev)
            emb = torch.cat([torch.cos(tv[:, None] * fr),
                             torch.sin(tv[:, None] * fr)], -1)
            te = W.lin("time_embeddings.out_layer",
                       F.silu(W.lin("time_embeddings.in_layer", emb)))[0]
            text = layer_norm(W.lin("text_embeddings.in_layer",
                                    text_embeds[0].float()),
                              W.w("text_embeddings.norm.weight"),
                              W.w("text_embeddings.norm.bias"))
            pe = layer_norm(W.lin("pooled_text_embeddings.in_layer",
                                  pooled[0].float()),
                            W.w("pooled_text_embeddings.norm.weight"),
                            W.w("pooled_text_embeddings.norm.bias"))
            te = te + pe
            patch = tuple(cfg["patch_size"])
            xp = patchify(x, patch)
            grid = tuple(xp.shape[1:4])
            vis = W.lin("visual_embeddings.in_layer", xp).reshape(-1, d)
            m = mask[0].bool()
            text_rope = rope_1d(text.shape[0], self.head_dim, dev)
            for i in range(cfg["num_text_blocks"]):
                text = self._text_block(i, text, te, text_rope, m)
            rope, perm, sparse = self._visual_tables(grid, dev)
            if perm is not None:
                vis = vis[perm]
            self.kept = []
            for i in range(cfg["num_visual_blocks"]):
                vis = self._visual_block(i, vis, text, te, rope, m, sparse)
            if perm is not None:
                vis = vis[torch.argsort(perm)]
            sh, sc = self._mod("out_layer.modulation.out_layer", te, 2)
            y = layer_norm(vis) * (sc + 1) + sh
            y = W.lin("out_layer.out_layer", y)
            y = y.reshape(1, *grid, -1)
            return unpatchify(y, patch, cfg["out_visual_dim"])
