"""Plain float32 reference of the streaming HunyuanVideo VAE decode and the
frames a request returns.

The HunyuanVideo causal decoder (channels (128, 256, 512, 512), 8x space,
4x time) run as the streaming decode defines it: the latent video in
disjoint chunks of ``chunk_lat`` latent frames (the first one frame
longer); each 3x3x3 conv carries its last two input frames into the next
chunk, replicate-padded in space and, on the first chunk, in time;
GroupNorm pools over the chunk; the mid attention sees the chunk's earlier
frames and a rolling window of ``attn_past`` carried frames. Every product
is float32 with TF32 off. Imports nothing of the port; the parameters are
the benchmark's, keyed as the diffusers checkpoint.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.dit import fp32_exact

GN_EPS = 1e-6
GROUPS = 32
SCALING_FACTOR = 0.476986
# fp32 bytes of one slab of a conv's input or output frames
SLAB_BYTES = 1 << 30


def _f(p, key):
    return p[key].float()


def conv(p, x, hist=None):
    """Causal conv of x (B, T, H, W, C) with replicate padding; returns
    (y, the last kt - 1 input frames to carry). Runs over slabs of output
    frames, so that no padded copy of the whole input is made."""
    w, b = _f(p, "weight"), _f(p, "bias")
    kt = w.shape[2]
    if kt == 1:
        return F.linear(x, w.reshape(w.shape[0], w.shape[1]), b), None
    pad = kt - 1
    head = torch.cat([x[:, :1]] * pad, 1) if hist is None else hist

    def frames(i0, i1):
        """Frames i0 <= i < i1 of [head, x]."""
        parts = []
        if i0 < pad:
            parts.append(head[:, i0:min(i1, pad)])
        if i1 > pad:
            parts.append(x[:, max(i0 - pad, 0):i1 - pad])
        return torch.cat(parts, 1)

    bsz, t, h, wd, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((bsz, t, h, wd, cout), dtype=x.dtype, device=x.device)
    n = max(1, SLAB_BYTES // (4 * bsz * h * wd * max(cin, cout)))
    for t0 in range(0, t, n):
        t1 = min(t, t0 + n)
        xc = F.pad(frames(t0, t1 + pad).permute(0, 4, 1, 2, 3),
                   (1, 1, 1, 1, 0, 0), mode="replicate")
        out[:, t0:t1] = F.conv3d(xc, w, b).permute(0, 2, 3, 4, 1)
    return out, frames(t, t + pad).clone()


def group_norm(p, x, silu: bool = False):
    """GroupNorm(32) over the chunk, then SiLU with ``silu``."""
    b, t, h, w, c = x.shape
    xg = x.reshape(b, -1, GROUPS, c // GROUPS)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False, keepdim=True)
    scale = torch.rsqrt(var + GN_EPS) * _f(p, "weight").reshape(
        1, 1, GROUPS, c // GROUPS)
    shift = _f(p, "bias").reshape(1, 1, GROUPS, c // GROUPS) - mean * scale
    y = torch.addcmul(shift.reshape(b, 1, c), x.reshape(b, -1, c),
                      scale.reshape(b, 1, c))
    if silu:
        F.silu(y, inplace=True)
    return y.reshape(b, t, h, w, c)


def resnet(p, x, st):
    st = st or {}
    h, h1 = conv(p["conv1"], group_norm(p["norm1"], x, True), st.get("c1"))
    h, h2 = conv(p["conv2"], group_norm(p["norm2"], h, True), st.get("c2"))
    h.add_(conv(p["conv_shortcut"], x)[0] if "conv_shortcut" in p else x)
    return h, {"c1": h1, "c2": h2}


def mid_attention(p, x, st, attn_past: int):
    """Single-head attention of each frame's voxels over the carried frames
    and the chunk's frames up to its own; returns (x + out, new state)."""
    b, t, h, w, c = x.shape
    s = h * w
    y = group_norm(p["group_norm"], x).reshape(b, t, s, c)

    def proj(name, z):
        return F.linear(z, _f(p[name], "weight"), _f(p[name], "bias"))

    q, k, v = proj("to_q", y), proj("to_k", y), proj("to_v", y)
    past_k, past_v = (st["k"], st["v"]) if st else (k[:, :0], v[:, :0])
    k_all = torch.cat([past_k, k], 1)
    v_all = torch.cat([past_v, v], 1)
    n_past = past_k.shape[1]
    out = torch.empty_like(q)
    for i in range(t):
        kk = k_all[:, :n_past + i + 1].reshape(b, -1, c)
        vv = v_all[:, :n_past + i + 1].reshape(b, -1, c)
        sc = torch.einsum("bld,bmd->blm", q[:, i], kk) / math.sqrt(c)
        out[:, i] = torch.einsum("blm,bmd->bld", torch.softmax(sc, -1), vv)
    out = F.linear(out, _f(p["to_out"]["0"], "weight"),
                   _f(p["to_out"]["0"], "bias")).reshape(b, t, h, w, c)
    return x + out, {"k": k_all[:, -attn_past:], "v": v_all[:, -attn_past:]}


def upsample(p, x, factor, hist, first: bool):
    ft, fh, fw = factor

    def rep(z, a):
        if a > 1:
            z = z.repeat_interleave(a, 1)
        if fh > 1:
            z = z.repeat_interleave(fh, 2).repeat_interleave(fw, 3)
        return z

    if first:
        up = rep(x[:, :1], 1)
        if x.shape[1] > 1:
            up = torch.cat([up, rep(x[:, 1:], ft)], 1)
    else:
        up = rep(x, ft)
    return conv(p["conv"], up, hist)


def up_plan(levels: int):
    return [(i < 3, 1 <= i and i != levels - 1) for i in range(levels)]


def decode_chunk(params, z, st, first: bool, attn_past: int):
    st = st or {}
    ns = {}
    p = params["decoder"]
    x, _ = conv(params["post_quant_conv"], z)
    h, ns["conv_in"] = conv(p["conv_in"], x, st.get("conv_in"))
    mid = p["mid_block"]
    h, ns["r0"] = resnet(mid["resnets"]["0"], h, st.get("r0"))
    h, ns["attn"] = mid_attention(mid["attentions"]["0"], h, st.get("attn"),
                                  attn_past)
    h, ns["r1"] = resnet(mid["resnets"]["1"], h, st.get("r1"))
    blocks = p["up_blocks"]
    for i, (up_s, up_t) in enumerate(up_plan(len(blocks))):
        blk = blocks[str(i)]
        for j in range(len(blk["resnets"])):
            h, ns[f"u{i}r{j}"] = resnet(blk["resnets"][str(j)], h,
                                        st.get(f"u{i}r{j}"))
        if "upsamplers" in blk:
            factor = (2 if up_t else 1, 2 if up_s else 1, 2 if up_s else 1)
            h, ns[f"u{i}up"] = upsample(blk["upsamplers"]["0"], h, factor,
                                        st.get(f"u{i}up"), first)
    h = group_norm(p["conv_norm_out"], h, True)
    y, ns["conv_out"] = conv(p["conv_out"], h, st.get("conv_out"))
    return y, ns


@torch.no_grad()
def decode_frames(params, latents, chunk_lat: int = 3, attn_past: int = 4):
    """(1, T', H', W', 16) latents as the DiT gives them -> (1, 4 (T' - 1)
    + 1, 8 H', 8 W', 3) uint8 frames: the latents over the scaling factor,
    the streaming decode, clamped to [-1, 1], mapped to [0, 255] and
    truncated, as the pipeline returns them."""
    with fp32_exact():
        z = latents.float() / SCALING_FACTOR
        tf = z.shape[1]
        n0 = min(tf, chunk_lat + 1)
        out, st = decode_chunk(params, z[:, :n0], None, True, attn_past)
        frames = [_to_uint8(out)]
        i = n0
        while i < tf:
            n = min(chunk_lat, tf - i)
            out, st = decode_chunk(params, z[:, i:i + n], st, False,
                                   attn_past)
            frames.append(_to_uint8(out))
            i += n
        return torch.cat(frames, 1)


def _to_uint8(video):
    return ((video.clamp(-1.0, 1.0) + 1.0) * 127.5).to(torch.uint8).cpu()
