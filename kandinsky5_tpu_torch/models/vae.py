"""HunyuanVideo 3D causal VAE in PyTorch: encoder and decoder.

Counterpart of ``kandinsky5_tpu/models/vae.py``.
Activations are NDHWC (B, T, H, W, C) as in the JAX package. Parameters are
a nested dict keyed like the HF checkpoint (``checkpoint.
vae_params_from_state_dict``): Conv3d weights (Cout, Cin, kT, kH, kW),
Linear weights (out, in). GroupNorm and the attention softmax run in fp32.

Two decodes, as in the JAX package: the faithful overlap-tiled decode
(``HunyuanVideoVAE.decode(mode="tiled")``, the reference's, with its
``OPT_*_TILING`` tables and linear blends) and the streaming decode
(``models/vae_stream.py``, the single-device default), which falls back to
tiled where spatial tiling would apply (above 900 px). On a mesh
(``group``: the pipeline's ranks, the JAX package's VAE mesh with dp over
every device) the tiled decode splits its equal-shaped tiles over the
ranks (:func:`decode_shared`), gathers the decoded tiles to rank 0 once and
blends them there in the original order; ragged temporal tiles decode on
their own, unpadded, as GroupNorm is not time-causal.

Routing of the 3x3x3 convs (``ConvMode``, fixed per decode from the VAE's
options): 128-512 channels go to K3 (``ops/conv.causal_conv3d_fused``), the
rest (conv_in with Cin 16, conv_out with Cout 3) to the plain conv. Where
the TPU kernel admits a conv (``ops/conv.tpu_kernel_admits``, the JAX
package's ``conv_pallas_supported``), ``fuse`` folds GroupNorm + SiLU into
K3's prologue and ``int8`` runs it W8A8; every other conv stays bf16 and
unfused, as in the JAX package. The mid attention goes to K4
(``ops/flash.flash_attention`` with segment ids) once it covers at least
2048 voxels.

The encode (``HunyuanVideoVAE.encode``, the only caller being ``data.py``'s
shard preparation) routes as the JAX package's: GroupNorm + SiLU fused into
K3's prologue wherever the TPU kernel admits the conv (W8A8 with
``int8_conv``), K3 plain for the other stride-1 convs, the mid attention on
K4 from 2048 voxels, and the stride-2 downsamplers, conv_in (Cin 3) and
conv_out (Cout 32) as plain convs (the JAX package runs them in XLA,
outside any Pallas kernel). Its tiles are the reference's, untiled below
450 px and 97 frames, spatially tiled above 900 px.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops.conv import (
    causal_conv3d_fused,
    conv3d_plain,
    conv_kernel_supported,
    tpu_kernel_admits,
)
from kandinsky5_tpu_torch.ops.flash import flash_attention
from kandinsky5_tpu_torch.utils import default_device

GROUPNORM_EPS = 1e-6
SCALING_FACTOR = 0.476986
BLOCK_OUT_CHANNELS = (128, 256, 512, 512)
LAYERS_PER_BLOCK = 2
# the mid attention takes K4 from this many voxels on
FLASH_MIN_TOKENS = 2048
DECODE_MODES = ("stream", "tiled")

# The reference's tiling tables (its vae.py:26-107): frame count -> (tile,
# stride) in sample frames, and spatial size -> (tile, stride) in pixels.
OPT_TEMPORAL_TILING = {1: (1, 1), 17: (17, 17)}
OPT_TEMPORAL_TILING.update({
    21: (13, 8), 25: (17, 8), 29: (17, 12), 33: (21, 12), 37: (21, 16),
    41: (17, 12), 45: (21, 12), 49: (17, 8), 53: (21, 16), 57: (21, 12),
    61: (13, 8), 65: (17, 12), 69: (21, 16), 73: (17, 8), 77: (17, 12),
    81: (21, 12), 85: (21, 16), 89: (17, 12), 93: (21, 12), 97: (17, 8),
    101: (21, 16), 105: (21, 12), 109: (13, 8), 113: (17, 12), 117: (21, 16),
    121: (17, 8), 125: (17, 12), 129: (21, 12), 133: (21, 16), 137: (17, 12),
    141: (21, 12), 145: (17, 8), 149: (21, 16), 153: (21, 12), 157: (13, 8),
    161: (17, 12), 165: (21, 16), 169: (17, 8), 173: (17, 12), 177: (21, 12),
    181: (21, 16), 185: (17, 12), 189: (21, 12), 193: (17, 8), 197: (21, 16),
    201: (21, 12), 205: (13, 8), 209: (17, 12), 213: (21, 16), 217: (17, 8),
    221: (17, 12), 225: (21, 12), 229: (21, 16), 233: (17, 12), 237: (21, 12),
    241: (17, 8),
})

OPT_SPATIAL_TILING = {
    160: (160, 160), 192: (192, 192), 224: (224, 224), 256: (256, 256),
    288: (288, 288), 320: (320, 320), 352: (352, 352), 384: (384, 384),
    448: (448, 448), 512: (288, 224), 576: (320, 256), 640: (352, 288),
    704: (384, 320), 768: (416, 352), 896: (480, 416), 1024: (544, 480),
    1152: (608, 544), 1280: (672, 608), 1408: (736, 672),
}


class ConvMode(NamedTuple):
    """How a decode runs the convs the TPU kernel admits: ``fuse`` folds
    GroupNorm + SiLU into K3, ``int8`` quantizes them (W8A8)."""

    fuse: bool = False
    int8: bool = False


# ---------------------------------------------------------------------------
# Primitive layers (NDHWC)
# ---------------------------------------------------------------------------

def conv1x1(p, x):
    """Pointwise conv: x (..., Cin) -> (..., Cout) in the weight dtype
    (fp32 accumulation, one rounding at the end)."""
    w = p["weight"].reshape(p["weight"].shape[0], p["weight"].shape[1])
    return F.linear(x.to(w.dtype), w, p["bias"].to(w.dtype)).to(x.dtype)


def strided_conv3d(p, x, stride: Tuple[int, int, int]):
    """Time-causal replicate-padded conv at a stride (the encoder's
    downsamplers): the fp32 products of the x.dtype values, the bias added
    in fp32, rounded once to x.dtype. Plain PyTorch: the JAX package runs
    it in XLA (``lax.conv_general_dilated``), not in its Pallas conv."""
    w = p["weight"]
    kt, kh, kw = w.shape[2:]
    xc = F.pad(x.permute(0, 4, 1, 2, 3).float(),
               (kw // 2, kw // 2, kh // 2, kh // 2, kt - 1, 0),
               mode="replicate")
    y = F.conv3d(xc, w.to(x.dtype).float(), p["bias"].float(), stride=stride)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def causal_conv3d(p, x, int8: bool = False,
                  stride: Tuple[int, int, int] = (1, 1, 1)):
    """Time-causal conv with replicate padding; W8A8 with ``int8`` where
    the TPU kernel admits the conv (stride 1 only)."""
    w = p["weight"]
    if tuple(w.shape[2:]) == (1, 1, 1):
        return conv1x1(p, x)
    if tuple(stride) != (1, 1, 1):
        return strided_conv3d(p, x, tuple(stride))
    if int8 and tpu_kernel_admits(x, w):
        return causal_conv3d_fused(x, w, p["bias"], quant=True)
    if conv_kernel_supported(w):
        return causal_conv3d_fused(x, w, p["bias"])
    return conv3d_plain(x, w, p["bias"])


def _gn_fold(p, x, groups: int = 32, eps: float = GROUPNORM_EPS):
    """GroupNorm statistics folded into one per-channel (B, C) scale and
    shift, fp32."""
    b, t, h, w, c = x.shape
    n = t * h * w
    xf = x.reshape(b, n, c).float()
    s1 = xf.sum(1)
    s2 = xf.square().sum(1)
    cg = c // groups
    g1 = s1.reshape(b, groups, cg).sum(-1, keepdim=True)
    g2 = s2.reshape(b, groups, cg).sum(-1, keepdim=True)
    cnt = float(n * cg)
    mean = g1 / cnt
    var = (g2 / cnt - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    wgt = p["weight"].float().reshape(groups, cg)
    bias = p["bias"].float().reshape(groups, cg)
    scale_c = (rstd * wgt).reshape(b, c)
    shift_c = (bias - mean * rstd * wgt).reshape(b, c)
    return scale_c, shift_c


def group_norm(p, x, groups: int = 32, eps: float = GROUPNORM_EPS):
    """GroupNorm(32) over (T, H, W, C / groups) in fp32, out in x.dtype."""
    b, t, h, w, c = x.shape
    scale_c, shift_c = _gn_fold(p, x, groups, eps)
    y = x.reshape(b, -1, c).float() * scale_c[:, None] + shift_c[:, None]
    return y.reshape(b, t, h, w, c).to(x.dtype)


def gn_silu(p, x):
    h = group_norm(p, x)
    return F.silu(h.float()).to(x.dtype)


def _gn_silu_conv(p_norm, p_conv, x, mode: ConvMode):
    """GroupNorm -> SiLU -> causal conv; with ``mode.fuse``, where the TPU
    kernel admits the conv, the folded GroupNorm and SiLU run as K3's
    prologue (one rounding of the normalized activation instead of two)."""
    if mode.fuse and tpu_kernel_admits(x, p_conv["weight"]):
        scale_c, shift_c = _gn_fold(p_norm, x)
        return causal_conv3d_fused(x, p_conv["weight"], p_conv["bias"],
                                   scale=scale_c[0], shift=shift_c[0],
                                   act=True, quant=mode.int8)
    return causal_conv3d(p_conv, gn_silu(p_norm, x), mode.int8)


def resnet_block(p, x, mode: ConvMode = ConvMode()):
    """GN -> SiLU -> conv -> GN -> SiLU -> conv + (1x1) shortcut."""
    h = _gn_silu_conv(p["norm1"], p["conv1"], x, mode)
    h = _gn_silu_conv(p["norm2"], p["conv2"], h, mode)
    residual = x
    if "conv_shortcut" in p:
        residual = causal_conv3d(p["conv_shortcut"], x)
    return h + residual


def _proj(p, tokens):
    """tokens @ W^T + b in fp32 (the mid attention's q/k/v/out)."""
    return F.linear(tokens.float(), p["weight"].float(), p["bias"].float())


def mid_attention(p, x):
    """Single-head frame-causal attention over all voxels, residual add."""
    b, t, h, w, c = x.shape
    s = h * w
    y = group_norm(p["group_norm"], x)
    tokens = y.reshape(b, t * s, c)
    q = _proj(p["to_q"], tokens)
    k = _proj(p["to_k"], tokens)
    v = _proj(p["to_v"], tokens)
    ids = torch.arange(t, device=x.device).repeat_interleave(s)[None]
    ids = ids.expand(b, t * s)
    if t * s >= FLASH_MIN_TOKENS:
        out = flash_attention(q.to(x.dtype)[:, :, None],
                              k.to(x.dtype)[:, :, None],
                              v.to(x.dtype)[:, :, None], q_ids=ids,
                              kv_ids=ids)[:, :, 0].float()
    else:
        scores = torch.einsum("bld,bmd->blm", q, k) / math.sqrt(c)
        allowed = ids[0][:, None] >= ids[0][None, :]
        scores = scores.masked_fill(~allowed[None], -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("blm,bmd->bld", probs.to(v.dtype), v)
    out = _proj(p["to_out"]["0"], out)
    return out.reshape(b, t, h, w, c).to(x.dtype) + x


def _repeat_up(x, ft: int, fh: int, fw: int):
    if ft > 1:
        x = x.repeat_interleave(ft, dim=1)
    if fh > 1:
        x = x.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
    return x


def upsample(p, x, factor: Tuple[int, int, int], int8: bool = False):
    """Nearest upsample (the first frame only spatially), then a conv."""
    ft, fh, fw = factor
    first = _repeat_up(x[:, :1], 1, fh, fw)
    if x.shape[1] > 1:
        first = torch.cat([first, _repeat_up(x[:, 1:], ft, fh, fw)], dim=1)
    return causal_conv3d(p["conv"], first, int8)


def _up_plan():
    """(add_spatial, add_time) per up block: 4x time, 8x space."""
    n = len(BLOCK_OUT_CHANNELS)
    return [(i < 3, i >= n - 3 and i != n - 1) for i in range(n)]


def up_factor(add_s: bool, add_t: bool) -> Tuple[int, int, int]:
    """A level's upsample factor, and its downsample stride in the
    encoder."""
    return (2 if add_t else 1, 2 if add_s else 1, 2 if add_s else 1)


def encoder_forward(p, x, mode: ConvMode = ConvMode(fuse=True)):
    """(B, T, H, W, 3) -> (B, T', H/8, W/8, 32) moments, untiled; T' = (T -
    1) / 4 + 1."""
    h = causal_conv3d(p["conv_in"], x, mode.int8)
    # the reference builds its down plan by the up plan's rule
    for i, (add_s, add_t) in enumerate(_up_plan()):
        blk = p["down_blocks"][str(i)]
        for j in range(LAYERS_PER_BLOCK):
            h = resnet_block(blk["resnets"][str(j)], h, mode)
        if "downsamplers" in blk:
            h = causal_conv3d(blk["downsamplers"]["0"]["conv"], h,
                              stride=up_factor(add_s, add_t))
    mid = p["mid_block"]
    h = resnet_block(mid["resnets"]["0"], h, mode)
    h = mid_attention(mid["attentions"]["0"], h)
    h = resnet_block(mid["resnets"]["1"], h, mode)
    return causal_conv3d(p["conv_out"], gn_silu(p["conv_norm_out"], h),
                         mode.int8)


def decoder_forward(p, z, mode: ConvMode = ConvMode()):
    """(B, T', H', W', 16) -> (B, T, 8H', 8W', 3), untiled."""
    h = causal_conv3d(p["conv_in"], z, mode.int8)
    mid = p["mid_block"]
    h = resnet_block(mid["resnets"]["0"], h, mode)
    h = mid_attention(mid["attentions"]["0"], h)
    h = resnet_block(mid["resnets"]["1"], h, mode)
    for i, (add_s, add_t) in enumerate(_up_plan()):
        blk = p["up_blocks"][str(i)]
        for j in range(LAYERS_PER_BLOCK + 1):
            h = resnet_block(blk["resnets"][str(j)], h, mode)
        if "upsamplers" in blk:
            h = upsample(blk["upsamplers"]["0"], h, up_factor(add_s, add_t),
                         mode.int8)
    return causal_conv3d(p["conv_out"], gn_silu(p["conv_norm_out"], h),
                         mode.int8)


def _decode_tile(params, z, mode: ConvMode):
    z = conv1x1(params["post_quant_conv"], z)
    return decoder_forward(params["decoder"], z, mode)


def _encode_tile(params, x, mode: ConvMode):
    return conv1x1(params["quant_conv"], encoder_forward(params["encoder"],
                                                         x, mode))


def posterior_sample(moments, noise=None):
    """The latents of (..., 2C) mean || logvar moments: the mean, or with
    ``noise`` (like the mean, fp32) mean + exp(0.5 clip(logvar, -30, 20))
    noise in fp32, out in the moments' dtype (the reference's
    DiagonalGaussianDistribution)."""
    mean, logvar = moments.chunk(2, dim=-1)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar.float().clamp(-30.0, 20.0))
    return (mean.float() + std * noise).to(mean.dtype)


def decoded_shape(z_shape) -> Tuple[int, ...]:
    """The (B, T, H, W, 3) shape the decoder gives a (B, T', H', W', C)
    latent: T = 4 (T' - 1) + 1, H = 8 H', W = 8 W'."""
    b, t, h, w = z_shape[:4]
    return (b, 4 * (t - 1) + 1, 8 * h, 8 * w, 3)


def decode_shared(group, tiles: Sequence[torch.Tensor], decode_one):
    """Decode equal-shaped latent ``tiles`` split over the ranks of
    ``group``: rank r decodes the contiguous block [r k, (r + 1) k) of them
    with ``decode_one``, k = ceil(n / size) (the JAX package's P("dp")
    placement of the batch padded to a multiple of dp; a padding slot is
    sent as zeros, not decoded), and the decoded tiles are gathered to group
    rank 0 once. Returns the n decoded tiles in order on rank 0, None on the
    others."""
    n = len(tiles)
    k = -(-n // group.size)
    z = tiles[0]
    block = torch.zeros((k,) + decoded_shape(z.shape), dtype=z.dtype,
                        device=z.device)
    for m, tile in enumerate(tiles[group.rank * k:(group.rank + 1) * k]):
        out = decode_one(tile)
        if out.dtype != block.dtype:
            raise TypeError(f"a tile decoded to {out.dtype}, not {z.dtype}")
        block[m] = out
    gathered = group.gather(block)
    return None if gathered is None else list(gathered[:n])


def _blend(a, b, extent: int, axis: int):
    """Linear cross-fade of the last ``extent`` slices of a into the first
    ``extent`` slices of b along ``axis``, fp32, out in b.dtype (the
    reference's blend_t/h/v)."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent == 0:
        return b
    shape = [1] * b.ndim
    shape[axis] = extent
    ramp = (torch.arange(extent, dtype=torch.float32, device=b.device)
            / extent).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent).float()
    b_head = b.narrow(axis, 0, extent).float()
    blended = (a_tail * (1 - ramp) + b_head * ramp).to(b.dtype)
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)],
                     dim=axis)


class HunyuanVideoVAE:
    """The VAE's encode and decodes. Layout (B, T, H, W, C) throughout.

    Options, fixed at construction: ``fuse_gn`` folds GroupNorm + SiLU into
    K3 (None: the JAX package's per-mode default, fused in the tiled decode
    and the encode and unfused in the streaming decode, measured there on
    the TPU);
    ``int8_conv`` runs the convs the TPU kernel admits W8A8 in the decodes
    and the encode (the JAX package's ``KANDINSKY5_TPU_INT8_CONV``);
    ``group`` (a :class:`~kandinsky5_tpu_torch.parallel.ranks.RankGroup`,
    the JAX package's ``vae.mesh``) makes each decode one rank's part of a
    decode split over the group, every rank calling it: rank 0 returns the
    frames, the others None. The tiling state (``tile_sample_*``) lives on
    the object and is set per decode from the reference's tables, as in
    the JAX package; ``decoded_tiles`` counts the tiles this rank decoded in
    the last decode (a stream decode counts none)."""

    spatial_compression = 8
    temporal_compression = 4
    scaling_factor = SCALING_FACTOR

    def __init__(self, params: dict, dtype=torch.bfloat16, fuse_gn=None,
                 int8_conv: bool = False, group=None):
        self.params = params
        self.dtype = dtype
        self.fuse_gn = fuse_gn
        self.int8_conv = int8_conv
        self.group = group
        self.decoded_tiles = 0
        self.tile_sample_min_num_frames = 16
        self.tile_sample_stride_num_frames = 12
        self.tile_sample_min_height = 256
        self.tile_sample_min_width = 256
        self.tile_sample_stride_height = 192
        self.tile_sample_stride_width = 192

    def replace(self, **options) -> "HunyuanVideoVAE":
        """A VAE over the same parameters with other options."""
        vae = copy.copy(self)
        for key, value in options.items():
            if key not in ("fuse_gn", "int8_conv", "group"):
                raise TypeError(f"unknown VAE option {key!r}")
            setattr(vae, key, value)
        return vae

    def conv_mode(self, kind: str) -> ConvMode:
        """The conv routing of a decode ("tiled" or "stream") or of the
        encode ("encode", fused by default as the tiled decode)."""
        fuse = kind != "stream" if self.fuse_gn is None else self.fuse_gn
        return ConvMode(fuse=fuse, int8=self.int8_conv)

    # -- tiling selection (reference get_enc/dec_optimal_tiling)
    def _optimal_tiling(self, num_frames, height, width):
        if math.sqrt(height * width) < 450 and num_frames <= 97:
            ft, fs = num_frames, num_frames
        else:
            ft, fs = OPT_TEMPORAL_TILING[num_frames]
        if math.sqrt(height * width) > 900:
            ht, hs = OPT_SPATIAL_TILING[height]
            wt, ws = OPT_SPATIAL_TILING[width]
        else:
            ht, hs, wt, ws = height, height, width, width
        return (ft, ht, wt), (fs, hs, ws)

    def _apply_tiling(self, tile, stride):
        ft, ht, wt = tile
        fs, hs, ws = stride
        self.tile_sample_min_num_frames = ft - 1
        self.tile_sample_stride_num_frames = fs
        self.tile_sample_min_height = ht
        self.tile_sample_min_width = wt
        self.tile_sample_stride_height = hs
        self.tile_sample_stride_width = ws

    @torch.no_grad()
    def decode(self, z, opt_tiling: bool = True, mode: str = "stream"):
        """(B, T', H', W', 16) latents -> (B, T, H, W, 3) in about [-1, 1].

        ``mode``: "tiled" is the reference's overlap-tile decode; "stream"
        decodes disjoint chunks with carried causal state
        (``models/vae_stream.py``) and falls back to tiled where spatial
        tiling would apply. Under ``group`` rank 0 returns the frames and the
        other ranks None (a stream decode runs on rank 0 alone)."""
        if mode not in DECODE_MODES:
            raise ValueError(f"decode mode must be one of {DECODE_MODES}, "
                             f"got {mode!r}")
        z = z.to(self.dtype)
        group = self.group if self.group is not None and self.group.size > 1 \
            else None
        self.decoded_tiles = 0
        tf, hl, wl = z.shape[1:4]
        if opt_tiling:
            sample_frames = 4 * (tf - 1) + 1
            self._apply_tiling(*self._optimal_tiling(sample_frames, 8 * hl,
                                                     8 * wl))
        if mode == "stream":
            sc = self.spatial_compression
            needs_spatial = (wl > self.tile_sample_stride_width // sc
                             or hl > self.tile_sample_min_height // sc)
            if not needs_spatial:
                from kandinsky5_tpu_torch.models.vae_stream import (
                    streaming_decode,
                )

                if group is not None and group.rank != 0:
                    return None
                return streaming_decode(self.params, z,
                                        mode=self.conv_mode("stream"))
        cm = self.conv_mode("tiled")
        tile_lat_f = self.tile_sample_min_num_frames // self.temporal_compression
        if tf > tile_lat_f + 1:
            return self._temporal_tiled_decode(z, cm, group)
        return self._spatial_decode(z, cm, group)

    def _decode(self, z, cm: ConvMode):
        """One tile, counted."""
        self.decoded_tiles += 1
        return _decode_tile(self.params, z, cm)

    def _spatial_decode(self, z, cm: ConvMode, group=None):
        """Under ``group`` (every rank calling) rank 0 gets the result, the
        other ranks None."""
        hl, wl = z.shape[2:4]
        tile_lat_h = self.tile_sample_min_height // self.spatial_compression
        # the reference compares the width against the STRIDE here (its
        # vae.py:854-856), a quirk kept for parity
        tile_lat_w = self.tile_sample_stride_width // self.spatial_compression
        if wl > tile_lat_w or hl > tile_lat_h:
            return self._spatial_tiled_decode(z, cm, group)
        if group is not None and group.rank != 0:
            return None
        return self._decode(z, cm)

    def _spatial_tiled_decode(self, z, cm: ConvMode, group=None):
        """Overlap tiles over H and W, blended linearly (reference
        tiled_decode); each blend chains off the already-blended
        neighbour, as the reference's in-place blend does. Under ``group``
        the tiles (all of one shape) are split over the ranks and the blend
        runs on rank 0."""
        sc = self.spatial_compression
        hl, wl = z.shape[2:4]
        t_lat_h = self.tile_sample_min_height // sc
        t_lat_w = self.tile_sample_min_width // sc
        s_lat_h = self.tile_sample_stride_height // sc
        s_lat_w = self.tile_sample_stride_width // sc
        blend_h = self.tile_sample_min_height - self.tile_sample_stride_height
        blend_w = self.tile_sample_min_width - self.tile_sample_stride_width
        i_starts = range(0, hl - t_lat_h + 1, s_lat_h)
        j_starts = range(0, wl - t_lat_w + 1, s_lat_w)
        tiles = [z[:, :, i:i + t_lat_h, j:j + t_lat_w]
                 for i in i_starts for j in j_starts]
        if group is not None and len(tiles) > 1:
            flat = decode_shared(group, tiles, lambda t: self._decode(t, cm))
        elif group is not None and group.rank != 0:
            flat = None
        else:
            flat = [self._decode(t, cm) for t in tiles]
        if flat is None:
            return None
        nw = len(j_starts)
        rows = [flat[r * nw:(r + 1) * nw] for r in range(len(i_starts))]
        result_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = _blend(rows[i - 1][j], tile, blend_h, axis=2)
                if j > 0:
                    tile = _blend(rows[i][j - 1], tile, blend_w, axis=3)
                rows[i][j] = tile
                h_lim = (self.tile_sample_min_height if i == len(rows) - 1
                         else self.tile_sample_stride_height)
                w_lim = (self.tile_sample_min_width if j == len(row) - 1
                         else self.tile_sample_stride_width)
                result_row.append(tile[:, :, :h_lim, :w_lim])
            result_rows.append(torch.cat(result_row, dim=3))
        out = torch.cat(result_rows, dim=2)
        return out[:, :, :hl * sc, :wl * sc]

    def _temporal_tiled_decode(self, z, cm: ConvMode, group=None):
        """Chunks over latent time, re-decoding one overlap frame, blended
        linearly (reference _temporal_tiled_decode). Under ``group`` the
        full-length chunks are split over the ranks (each decodes its own,
        spatially tiled where that applies) and the ragged ones decode on
        their own; the blend runs on rank 0."""
        tf = z.shape[1]
        num_sample_frames = (tf - 1) * self.temporal_compression + 1
        t_lat_f = self.tile_sample_min_num_frames // self.temporal_compression
        s_lat_f = self.tile_sample_stride_num_frames // self.temporal_compression
        blend_f = (self.tile_sample_min_num_frames
                   - self.tile_sample_stride_num_frames)
        starts = list(range(0, tf - t_lat_f + 1, s_lat_f))
        full = [i for i in starts if i + t_lat_f + 1 <= tf]
        shared = {}
        if group is not None and len(full) > 1:
            out = decode_shared(group, [z[:, i:i + t_lat_f + 1] for i in full],
                                lambda t: self._spatial_decode(t, cm))
            shared = dict(zip(full, out or [None] * len(full)))
        row = []
        for i in starts:
            if i in shared:
                decoded = shared[i]
            else:
                decoded = self._spatial_decode(z[:, i:i + t_lat_f + 1], cm,
                                               group)
            row.append(decoded)
        if group is not None and group.rank != 0:
            return None
        row = [d[:, 1:] if i > 0 else d for i, d in zip(starts, row)]
        result = []
        for i, tile in enumerate(row):
            if i > 0:
                tile = _blend(row[i - 1], tile, blend_f, axis=1)
                row[i] = tile
                t_lim = (self.tile_sample_min_num_frames if i == len(row) - 1
                         else self.tile_sample_stride_num_frames)
                result.append(tile[:, :t_lim])
            else:
                result.append(tile[:, :self.tile_sample_stride_num_frames + 1])
        return torch.cat(result, dim=1)[:, :num_sample_frames]

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    @torch.no_grad()
    def encode_moments(self, x, opt_tiling: bool = True):
        """(B, T, H, W, 3) in [-1, 1] -> (B, T', H/8, W/8, 32) mean ||
        logvar moments, tiled by the reference's tables (``opt_tiling``)
        or by the tiling state as it stands."""
        x = x.to(self.dtype)
        t, hh, ww = x.shape[1:4]
        if opt_tiling:
            self._apply_tiling(*self._optimal_tiling(t, hh, ww))
        cm = self.conv_mode("encode")
        if t > self.tile_sample_min_num_frames + 1:
            return self._temporal_tiled_encode(x, cm)
        return self._spatial_encode(x, cm)

    def encode(self, x, seed: Optional[int] = None, opt_tiling: bool = True):
        """Latents of ``x``: the posterior mean, or with ``seed`` a sample,
        its noise drawn by a ``torch.Generator`` seeded on x's device (not
        the JAX package's PRNG stream)."""
        moments = self.encode_moments(x, opt_tiling)
        if seed is None:
            return posterior_sample(moments)
        gen = torch.Generator(device=moments.device).manual_seed(seed)
        noise = torch.randn(moments[..., :moments.shape[-1] // 2].shape,
                            generator=gen, device=moments.device)
        return posterior_sample(moments, noise)

    def _spatial_encode(self, x, cm: ConvMode):
        hh, ww = x.shape[2:4]
        if ww > self.tile_sample_min_width or hh > self.tile_sample_min_height:
            return self._spatial_tiled_encode(x, cm)
        return _encode_tile(self.params, x, cm)

    def _spatial_tiled_encode(self, x, cm: ConvMode):
        """Overlap tiles over H and W, blended linearly in latent space
        (reference tiled_encode), each blend chaining off the
        already-blended neighbour."""
        sc = self.spatial_compression
        hh, ww = x.shape[2:4]
        t_lat_h = self.tile_sample_min_height // sc
        t_lat_w = self.tile_sample_min_width // sc
        s_lat_h = self.tile_sample_stride_height // sc
        s_lat_w = self.tile_sample_stride_width // sc
        blend_h, blend_w = t_lat_h - s_lat_h, t_lat_w - s_lat_w
        th, tw = self.tile_sample_min_height, self.tile_sample_min_width
        rows = [[_encode_tile(self.params, x[:, :, i:i + th, j:j + tw], cm)
                 for j in range(0, ww - tw + 1,
                                self.tile_sample_stride_width)]
                for i in range(0, hh - th + 1, self.tile_sample_stride_height)]
        result_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = _blend(rows[i - 1][j], tile, blend_h, axis=2)
                if j > 0:
                    tile = _blend(rows[i][j - 1], tile, blend_w, axis=3)
                rows[i][j] = tile
                h_lim = t_lat_h if i == len(rows) - 1 else s_lat_h
                w_lim = t_lat_w if j == len(row) - 1 else s_lat_w
                result_row.append(tile[:, :, :h_lim, :w_lim])
            result_rows.append(torch.cat(result_row, dim=3))
        return torch.cat(result_rows, dim=2)[:, :, :hh // sc, :ww // sc]

    def _temporal_tiled_encode(self, x, cm: ConvMode):
        """Chunks over sample time, one overlap frame dropped from every
        chunk but the first, blended linearly (reference
        _temporal_tiled_encode)."""
        t = x.shape[1]
        latent_f = (t - 1) // self.temporal_compression + 1
        t_lat_f = self.tile_sample_min_num_frames // self.temporal_compression
        s_lat_f = self.tile_sample_stride_num_frames // self.temporal_compression
        blend_f = t_lat_f - s_lat_f
        n = self.tile_sample_min_num_frames
        row = []
        for i in range(0, t - n + 1, self.tile_sample_stride_num_frames):
            enc = self._spatial_encode(x[:, i:i + n + 1], cm)
            row.append(enc[:, 1:] if i > 0 else enc)
        result = []
        for i, tile in enumerate(row):
            if i > 0:
                tile = _blend(row[i - 1], tile, blend_f, axis=1)
                row[i] = tile
                result.append(tile[:, :t_lat_f if i == len(row) - 1
                                   else s_lat_f])
            else:
                result.append(tile[:, :s_lat_f + 1])
        return torch.cat(result, dim=1)[:, :latent_f]


# ---------------------------------------------------------------------------
# Parameter initialization (tests and smoke runs)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, device, dtype):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.uniform_(-bound, bound, generator=gen).to(dtype)


def _conv_p(gen, k, cin, cout, device, dtype):
    return {"weight": _uniform(gen, (cout, cin, k, k, k),
                               1.0 / math.sqrt(cin * k ** 3), device, dtype),
            "bias": torch.zeros(cout, device=device, dtype=dtype)}


def _gn_p(c, device, dtype):
    return {"weight": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def _resnet_p(gen, cin, cout, device, dtype):
    p = {"norm1": _gn_p(cin, device, dtype),
         "conv1": _conv_p(gen, 3, cin, cout, device, dtype),
         "norm2": _gn_p(cout, device, dtype),
         "conv2": _conv_p(gen, 3, cout, cout, device, dtype)}
    if cin != cout:
        p["conv_shortcut"] = _conv_p(gen, 1, cin, cout, device, dtype)
    return p


def _lin_p(gen, c, device, dtype):
    return {"weight": _uniform(gen, (c, c), 1.0 / math.sqrt(c), device, dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


@torch.no_grad()
def init_vae_params(latent_channels: int = 16, device=None,
                    dtype=torch.bfloat16, seed: int = 0,
                    block_out_channels: Sequence[int] = BLOCK_OUT_CHANNELS):
    """Random parameters of both halves with the checkpoint's layout and
    the JAX ``init_vae_params`` scheme (uniform +-1/sqrt(fan_in) weights,
    zero biases, unit GroupNorms), drawn on ``device``, the CUDA card when
    None. The decoder is drawn first, so its values for a seed do not
    depend on the encoder."""
    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rev = list(reversed(block_out_channels))
    kw = dict(device=device, dtype=dtype)
    up_blocks = {}
    c_in = rev[0]
    for i, (add_s, add_t) in enumerate(_up_plan()):
        c_out = rev[i]
        blk = {"resnets": {str(j): _resnet_p(gen, c_in if j == 0 else c_out,
                                             c_out, **kw)
                           for j in range(LAYERS_PER_BLOCK + 1)}}
        if add_s or add_t:
            blk["upsamplers"] = {"0": {"conv": _conv_p(gen, 3, c_out, c_out,
                                                       **kw)}}
        up_blocks[str(i)] = blk
        c_in = c_out
    c = rev[0]

    def mid():
        return {"resnets": {"0": _resnet_p(gen, c, c, **kw),
                            "1": _resnet_p(gen, c, c, **kw)},
                "attentions": {"0": {"group_norm": _gn_p(c, **kw),
                                     "to_q": _lin_p(gen, c, **kw),
                                     "to_k": _lin_p(gen, c, **kw),
                                     "to_v": _lin_p(gen, c, **kw),
                                     "to_out": {"0": _lin_p(gen, c, **kw)}}}}

    lc = latent_channels
    decoder = {
        "conv_in": _conv_p(gen, 3, lc, c, **kw),
        "mid_block": mid(),
        "up_blocks": up_blocks,
        "conv_norm_out": _gn_p(block_out_channels[0], **kw),
        "conv_out": _conv_p(gen, 3, block_out_channels[0], 3, **kw),
    }
    post_quant_conv = _conv_p(gen, 1, lc, lc, **kw)
    down_blocks = {}
    c_in = block_out_channels[0]
    for i, (add_s, add_t) in enumerate(_up_plan()):
        c_out = block_out_channels[i]
        blk = {"resnets": {str(j): _resnet_p(gen, c_in if j == 0 else c_out,
                                             c_out, **kw)
                           for j in range(LAYERS_PER_BLOCK)}}
        if add_s or add_t:
            blk["downsamplers"] = {"0": {"conv": _conv_p(gen, 3, c_out, c_out,
                                                         **kw)}}
        down_blocks[str(i)] = blk
        c_in = c_out
    encoder = {
        "conv_in": _conv_p(gen, 3, 3, block_out_channels[0], **kw),
        "down_blocks": down_blocks,
        "mid_block": mid(),
        "conv_norm_out": _gn_p(c, **kw),
        "conv_out": _conv_p(gen, 3, c, 2 * lc, **kw),
    }
    return {"encoder": encoder, "decoder": decoder,
            "quant_conv": _conv_p(gen, 1, 2 * lc, 2 * lc, **kw),
            "post_quant_conv": post_quant_conv}
