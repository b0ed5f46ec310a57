"""Streaming (state-carry) HunyuanVideo VAE decode in PyTorch.

Counterpart of ``kandinsky5_tpu/models/vae_stream.py``: the latent video
is decoded in disjoint chunks of ``chunk_lat`` latent frames (the first
chunk one frame longer), and each causal layer carries what the next
chunk needs:
  * each 3x3x3 conv carries its last two input frames, so chunk seams are
    exact for the conv path (K3 in ``time_padded`` mode after the first
    chunk);
  * the mid attention carries a rolling window of ``attn_past`` frames of
    K/V, masked by how many are filled (K4 with the key mask and frame
    ids);
  * GroupNorm pools per chunk, the same approximation as in the JAX
    package.
The conv routing is the decode's ``ConvMode`` (``models/vae.py``): with
``fuse`` (off by default here, as in the JAX package) GroupNorm + SiLU run
as K3's prologue and the carried history, already transformed, passes it
untouched (``prefix_planes``); with ``int8`` the convs the TPU kernel
admits run W8A8.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from kandinsky5_tpu_torch.models.vae import (
    FLASH_MIN_TOKENS,
    LAYERS_PER_BLOCK,
    ConvMode,
    _gn_fold,
    _proj,
    _repeat_up,
    _up_plan,
    causal_conv3d,
    conv1x1,
    gn_silu,
    group_norm,
    up_factor,
)
from kandinsky5_tpu_torch.ops.conv import (
    causal_conv3d_fused,
    conv3d_plain,
    conv_kernel_supported,
    conv_prologue,
    tpu_kernel_admits,
)
from kandinsky5_tpu_torch.ops.flash import flash_attention


def _edge_pad_front(x, frames: int):
    """x with its first frame repeated in front up to ``frames`` frames."""
    if x.shape[1] >= frames:
        return x
    return torch.cat([x[:, :1].expand(-1, frames - x.shape[1], -1, -1, -1), x],
                     dim=1)


def conv3d_stream(p, x, hist: Optional[torch.Tensor], int8: bool = False):
    """Causal conv over a chunk, carrying the (kt - 1)-frame input tail.
    ``hist`` is None on the first chunk, where the conv replicates frame 0
    itself; later chunks run over [hist, x] in ``time_padded`` mode."""
    w = p["weight"]
    kt = w.shape[2]
    if kt == 1:
        return causal_conv3d(p, x), None
    if hist is None:
        y = causal_conv3d(p, x, int8)
        xt = _edge_pad_front(x, kt - 1)
    else:
        xt = torch.cat([hist.to(x.dtype), x], dim=1)
        conv = causal_conv3d_fused if conv_kernel_supported(w) else conv3d_plain
        y = conv(xt, w, p["bias"], time_padded=True,
                 quant=int8 and tpu_kernel_admits(xt, w))
    # a copy, so the carried state does not pin the whole chunk
    return y, xt[:, xt.shape[1] - (kt - 1):].clone()


def _gn_silu_conv_stream(p_norm, p_conv, x, hist, mode: ConvMode):
    """GroupNorm -> SiLU -> streaming causal conv. With ``mode.fuse``, where
    the TPU kernel admits the conv, GroupNorm (pooled over this chunk) and
    SiLU run as K3's prologue; the carried history, which the previous
    chunk already transformed, passes untouched (``prefix_planes``), and
    the carried state is the transformed input tail, as the unfused path
    stores it (reaching into ``hist`` when the chunk is shorter than two
    frames)."""
    w = p_conv["weight"]
    kt = w.shape[2]
    if not (kt == 3 and mode.fuse and tpu_kernel_admits(x, w)):
        return conv3d_stream(p_conv, gn_silu(p_norm, x), hist, mode.int8)
    scale_c, shift_c = _gn_fold(p_norm, x)
    scale, shift = scale_c[0], shift_c[0]
    th = conv_prologue(x[:, -min(x.shape[1], kt - 1):], scale, shift)
    if hist is None:
        # replicating frame 0 commutes with the per-channel transform
        tail = _edge_pad_front(th, kt - 1)
        y = causal_conv3d_fused(x, w, p_conv["bias"], scale=scale, shift=shift,
                                act=True, quant=mode.int8)
    else:
        hist = hist.to(x.dtype)
        tail = torch.cat([hist, th], dim=1)[:, -(kt - 1):]
        y = causal_conv3d_fused(torch.cat([hist, x], dim=1), w, p_conv["bias"],
                                time_padded=True, scale=scale, shift=shift,
                                act=True, prefix_planes=kt - 1,
                                quant=mode.int8)
    return y, tail.clone()


def resnet_stream(p, x, st: Optional[dict], mode: ConvMode = ConvMode()):
    st = st or {}
    h, h1 = _gn_silu_conv_stream(p["norm1"], p["conv1"], x, st.get("conv1"),
                                 mode)
    h, h2 = _gn_silu_conv_stream(p["norm2"], p["conv2"], h, st.get("conv2"),
                                 mode)
    residual = x
    if "conv_shortcut" in p:
        residual = causal_conv3d(p["conv_shortcut"], x)
    return h + residual, {"conv1": h1, "conv2": h2}


def attention_stream(p, x, st: Optional[dict], attn_past: int):
    """Frame-causal mid attention over the chunk plus a rolling
    ``attn_past``-frame K/V window."""
    b, t, h, w, c = x.shape
    s = h * w
    dev = x.device
    y = group_norm(p["group_norm"], x)
    tokens = y.reshape(b, t * s, c)
    q = _proj(p["to_q"], tokens)
    k = _proj(p["to_k"], tokens)
    v = _proj(p["to_v"], tokens)

    P = attn_past
    if st is None:
        k_buf = torch.zeros((b, P, s, c), dtype=x.dtype, device=dev)
        v_buf = torch.zeros((b, P, s, c), dtype=x.dtype, device=dev)
        filled = 0
    else:
        k_buf, v_buf, filled = st["k"], st["v"], st["filled"]

    k_all = torch.cat([k_buf.reshape(b, P * s, c), k.to(x.dtype)], dim=1)
    v_all = torch.cat([v_buf.reshape(b, P * s, c), v.to(x.dtype)], dim=1)
    # buffer slot j holds frame id j (newest right); chunk frame i has id
    # P + i; the newest `filled` slots are valid
    slot = torch.arange(P, dtype=torch.int32, device=dev)
    chunk_ids = (P + torch.arange(t, dtype=torch.int32, device=dev)
                 ).repeat_interleave(s)
    kv_ids = torch.cat([slot.repeat_interleave(s), chunk_ids])[None].expand(
        b, (P + t) * s)
    q_ids = chunk_ids[None].expand(b, t * s)
    kv_mask = torch.cat([(slot >= P - filled).repeat_interleave(s),
                         torch.ones(t * s, dtype=torch.bool, device=dev)]
                        )[None].expand(b, (P + t) * s)

    if t * s >= FLASH_MIN_TOKENS:
        out = flash_attention(q.to(x.dtype)[:, :, None], k_all[:, :, None],
                              v_all[:, :, None], kv_mask=kv_mask, q_ids=q_ids,
                              kv_ids=kv_ids)[:, :, 0]
    else:
        scores = torch.einsum("bld,bmd->blm", q, k_all.float()) / math.sqrt(c)
        allowed = (q_ids[:, :, None] >= kv_ids[:, None, :]) & kv_mask[:, None, :]
        scores = scores.masked_fill(~allowed, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("blm,bmd->bld", probs.to(v_all.dtype).float(),
                           v_all.float())
    out = _proj(p["to_out"]["0"], out)
    out = out.reshape(b, t, h, w, c).to(x.dtype)

    frames_k = torch.cat([k_buf, k.to(x.dtype).reshape(b, t, s, c)], dim=1)
    frames_v = torch.cat([v_buf, v.to(x.dtype).reshape(b, t, s, c)], dim=1)
    new_st = {"k": frames_k[:, -P:].clone(), "v": frames_v[:, -P:].clone(),
              "filled": min(filled + t, P)}
    return out + x, new_st


def upsample_stream(p, x, factor, hist, first: bool, int8: bool = False):
    """Causal nearest upsample + conv; the spatial-only first frame applies
    to the first chunk alone."""
    ft, fh, fw = factor
    if first:
        up = _repeat_up(x[:, :1], 1, fh, fw)
        if x.shape[1] > 1:
            up = torch.cat([up, _repeat_up(x[:, 1:], ft, fh, fw)], dim=1)
    else:
        up = _repeat_up(x, ft, fh, fw)
    return conv3d_stream(p["conv"], up, hist, int8)


def decoder_stream(p, z, state: Optional[dict], first: bool,
                   attn_past: int, mode: ConvMode = ConvMode()
                   ) -> Tuple[torch.Tensor, dict]:
    """One chunk through the decoder, threading per-layer causal state."""
    st = state or {}
    ns = {}
    h, ns["conv_in"] = conv3d_stream(p["conv_in"], z, st.get("conv_in"),
                                     mode.int8)
    mid = p["mid_block"]
    mst = st.get("mid", {})
    nmid = {}
    h, nmid["r0"] = resnet_stream(mid["resnets"]["0"], h, mst.get("r0"), mode)
    h, nmid["attn"] = attention_stream(mid["attentions"]["0"], h,
                                       mst.get("attn"), attn_past)
    h, nmid["r1"] = resnet_stream(mid["resnets"]["1"], h, mst.get("r1"), mode)
    ns["mid"] = nmid
    for i, (add_s, add_t) in enumerate(_up_plan()):
        blk = p["up_blocks"][str(i)]
        bst = st.get(f"up{i}", {})
        nblk = {}
        for j in range(LAYERS_PER_BLOCK + 1):
            h, nblk[f"r{j}"] = resnet_stream(blk["resnets"][str(j)], h,
                                             bst.get(f"r{j}"), mode)
        if "upsamplers" in blk:
            h, nblk["ups"] = upsample_stream(blk["upsamplers"]["0"], h,
                                             up_factor(add_s, add_t),
                                             bst.get("ups"), first, mode.int8)
        ns[f"up{i}"] = nblk
    h = gn_silu(p["conv_norm_out"], h)
    y, ns["conv_out"] = conv3d_stream(p["conv_out"], h, st.get("conv_out"),
                                      mode.int8)
    return y, ns


def decode_chunk(params, z, state, first: bool, attn_past: int,
                 mode: ConvMode = ConvMode()):
    z = conv1x1(params["post_quant_conv"], z)
    return decoder_stream(params["decoder"], z, state, first, attn_past, mode)


@torch.no_grad()
def streaming_decode(params, z, chunk_lat: int = 3, attn_past: int = 4,
                     mode: ConvMode = ConvMode()):
    """(B, T', H', W', 16) latents -> (B, 4 (T' - 1) + 1, 8H', 8W', 3),
    decoded in disjoint chunks with carried causal state."""
    tf = z.shape[1]
    n0 = min(tf, chunk_lat + 1)
    out, state = decode_chunk(params, z[:, :n0], None, True, attn_past, mode)
    outs = [out]
    i = n0
    while i < tf:
        n = min(chunk_lat, tf - i)
        y, state = decode_chunk(params, z[:, i:i + n], state, False, attn_past,
                                mode)
        outs.append(y)
        i += n
    return torch.cat(outs, dim=1)
