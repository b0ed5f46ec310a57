"""3x3x3 time-causal convolution: kernel K3 beside its plain PyTorch version.

Counterpart of ``kandinsky5_tpu/ops/conv_pallas.py`` (``causal_conv3d_fused``)
in all its modes. Activations are NDHWC; the weight is torch's Conv3d layout
(Cout, Cin, 3, 3, 3). Padding is replicate: two leading frames in time (or
none with ``time_padded``, where the input already carries two history
frames) and one on each spatial side. The modes:
  * plain / ``time_padded``: fp32 accumulation, bias, output rounded once;
  * the folded-GroupNorm prologue (``scale``/``shift``, ``act``): each input
    element becomes y = x * scale[c] + shift[c] in fp32, then (``act``)
    y * sigmoid(y), rounded to x.dtype ONCE before the products (the unfused
    GroupNorm -> SiLU path rounds twice). Replicate padding commutes with a
    per-channel transform, so the padded planes are transformed too;
  * ``prefix_planes`` (with ``time_padded``): the first that many input
    planes are already transformed (the streaming decode's carried history)
    and pass through untouched;
  * ``quant`` (W8A8): the weight is int8 per output channel (plain PyTorch,
    cached per weight, as the JAX package leaves it to XLA); the activation
    (after the prologue) takes one symmetric scale per TPU halo tile, the
    partition of ``pick_tiles`` (bh = 8 rows, bw columns, 3 planes, and the
    TPU window's 2-row, 8-column halo); s8 x s8 products sum exactly in
    int32, then float(acc) * (s * ws[n]) + bias[n].
The plain version computes in fp32 at the kernel's rounding points; K3
(``csrc/conv3d.cu``) accumulates in fp32 (int32 under ``quant``) and rounds
the output to bf16. A CPU tensor goes to the plain version, a CUDA tensor to
the kernel (or raises).
"""

from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels

KERNEL_CHANNELS = (128, 256, 512)
# rows of the TPU kernel's output tile (``_auto_bh``'s default; the bh = 16
# opt-in is not ported)
QUANT_BH = 8

# ``_pick_tiles``' VMEM model (bytes and the measured allocation ratio): not
# a limit of this card, but it decides the TPU kernel's tile width, which
# defines which convs the JAX package quantizes and, under ``quant``, the
# activation scales' windows
_VMEM_BUDGET = 14_500_000
_VMEM_FUDGE = 1.45


def pick_tiles(w: int, cin: int, cout: int, quant: bool = False):
    """(bw, cb): the TPU kernel's W tile and Cout block at bh = 8 rows, or
    (0, 0) where no tile fits its budget (``conv_pallas._pick_tiles``,
    copied)."""
    bh = QUANT_BH
    for bw in (256, 192, 128, 96, 64, 48, 32):
        if w % bw:
            continue
        in_bytes = 2 * 3 * (bh + 2) * (bw + 8) * cin * 2
        fuse_tmp = 2 * (bh + 2) * (bw + 8) * cin * 4
        if quant:
            in_bytes = in_bytes * 3 // 2
        for cb in (cout, 256, 128):
            if cb > cout or cout % cb:
                continue
            w_bytes = 27 * cin * cb * (1 if quant else 2)
            out_bytes = 2 * bh * bw * cb * 2 + bh * bw * cb * 4
            est = _VMEM_FUDGE * (in_bytes + w_bytes + out_bytes) + fuse_tmp
            if est <= _VMEM_BUDGET:
                return bw, cb
    return 0, 0


def conv_kernel_supported(weight: torch.Tensor) -> bool:
    """The convs K3 serves in bf16: 3x3x3 with Cin, Cout in {128, 256, 512}
    (conv_in with Cin 16 and conv_out with Cout 3 stay plain)."""
    cout, cin = weight.shape[:2]
    return (tuple(weight.shape[2:]) == (3, 3, 3) and cin in KERNEL_CHANNELS
            and cout in KERNEL_CHANNELS)


def tpu_kernel_admits(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """The convs the JAX package sends to its Pallas kernel
    (``conv_pallas_supported`` less its backend test): batch 1, H a
    multiple of 8, the channels above and a W tile that fits. Only these
    fuse the GroupNorm prologue or quantize in the JAX package, so the
    port's ``fuse`` and ``int8`` routing follows this rule."""
    b, _, h, w, _ = x.shape
    cout, cin = weight.shape[:2]
    return (conv_kernel_supported(weight) and b == 1 and h % 8 == 0
            and pick_tiles(w, cin, cout)[0] > 0)


def quant_tile_width(w: int, cin: int, cout: int) -> int:
    """The W extent of one activation-scale window under ``quant``."""
    bw = pick_tiles(w, cin, cout, quant=True)[0]
    if bw == 0:
        raise ValueError(f"no W8A8 tile for W {w}, {cin}->{cout} channels")
    return bw


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv_prologue(x, scale, shift, act: bool = True, prefix_planes: int = 0):
    """The fused GroupNorm-fold (+ SiLU) input transform: fp32, rounded to
    x.dtype once; planes (axis 1) below ``prefix_planes`` pass through."""
    xf = x.float()
    y = xf * scale.float() + shift.float()
    if act:
        y = y * torch.sigmoid(y)
    if prefix_planes:
        y = torch.cat([xf[:, :prefix_planes], y[:, prefix_planes:]], dim=1)
    return y.to(x.dtype)


def _pad_time(x, time_padded: bool):
    """(B, T, H, W, C) with the two replicated leading frames attached."""
    if time_padded:
        return x
    return torch.cat([x[:, :1], x[:, :1], x], dim=1)


def window_scales(xt, bw: int, time_padded: bool):
    """Activation scales of the W8A8 mode: one per TPU output tile (t, hb,
    wb), from the largest |value| over that tile's input window (planes
    [t, t+3) of the time-padded input, rows [8 hb - 1, 8 hb + 9) and
    columns [wb bw - 1, wb bw + bw + 7), clamped: the TPU window reaches
    six columns past its halo). ``xt`` is the (transformed) input, (1, T_in,
    H, W, C). Returns (s, inv), each (T, H/8, W/bw) fp32: s = max(m,
    1e-8) / 127, inv = 1 / s."""
    m = _pad_time(xt, time_padded)[0].float().abs().amax(-1)  # (Tp, H, W)
    m = F.pad(m[None], (1, 7, 1, 1), mode="replicate")[0]
    m = m.unfold(2, bw + 8, bw).amax(-1)          # columns -> (Tp, H+2, nw)
    m = m.unfold(1, QUANT_BH + 2, QUANT_BH).amax(-1)  # rows -> (Tp, nh, nw)
    m = m.unfold(0, 3, 1).amax(-1)                # planes -> (T, nh, nw)
    # true divisions (a tensor divisor: torch multiplies by the reciprocal of
    # a scalar one on the card)
    s = m.clamp_min(1e-8) / torch.full_like(m, 127.0)
    return s, torch.reciprocal(s)


def quantize_conv_weight(weight):
    """(Cout, Cin, 3, 3, 3) -> (w8 (27, Cout, Cin) int8, ws (Cout,) fp32):
    ws = max(max |w| over taps and Cin, 1e-8) / 127, w8 = clip(round(w /
    ws), -127, 127), round half to even (``conv_pallas._conv_fused``)."""
    cout, cin = weight.shape[:2]
    wf = weight.float().permute(2, 3, 4, 0, 1).reshape(27, cout, cin)
    m = wf.abs().amax((0, 2)).clamp_min(1e-8)
    ws = m / torch.full_like(m, 127.0)
    w8 = torch.round(wf / ws[:, None]).clamp(-127, 127).to(torch.int8)
    return w8.contiguous(), ws


# per-weight cache of quantize_conv_weight: id(weight) -> (weak reference,
# version, w8, ws)
_QUANTIZED: dict = {}


def quantized_weight(weight):
    """:func:`quantize_conv_weight`, computed once per weight tensor (and
    again after an in-place change)."""
    key = id(weight)
    hit = _QUANTIZED.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2], hit[3]
    w8, ws = quantize_conv_weight(weight)
    ref = weakref.ref(weight, lambda _, key=key: _QUANTIZED.pop(key, None))
    _QUANTIZED[key] = (ref, weight._version, w8, ws)
    return w8, ws


def _conv_quant_plain(xt, weight, bias, time_padded: bool):
    """W8A8 over the (transformed) input: per-voxel scale of its output
    tile, s8 x s8 products summed exactly, float(acc) * (s * ws) + bias.
    Each tap's product runs in fp32 and is exact (its partial sums are
    integers below 512 * 127^2 < 2^24, and TF32 keeps 8-bit integers), the
    27 taps sum in int32. Output frames are taken a few at a time to bound
    the temporaries."""
    _, t_in, h, w, cin = xt.shape
    cout = weight.shape[0]
    bw = quant_tile_width(w, cin, cout)
    s, inv = window_scales(xt, bw, time_padded)
    t_out = s.shape[0]

    def per_voxel(a):  # (T, nh, nw) -> (T, H, W, 1)
        return a.repeat_interleave(QUANT_BH, 1).repeat_interleave(bw, 2)[..., None]

    s_vox, inv_vox = per_voxel(s), per_voxel(inv)
    w8, ws = quantized_weight(weight)
    wf = w8.float().transpose(1, 2)  # (27, Cin, Cout)
    xp = _pad_time(xt, time_padded)[0]
    xp = F.pad(xp.permute(3, 0, 1, 2)[None].float(), (1, 1, 1, 1, 0, 0),
               mode="replicate")[0].permute(1, 2, 3, 0)  # (Tp, H+2, W+2, C)
    y = torch.empty((1, t_out, h, w, cout), dtype=xt.dtype, device=xt.device)
    step = max(1, (1 << 25) // (h * w * max(cin, cout)))
    for t0 in range(0, t_out, step):
        t1 = min(t_out, t0 + step)
        acc = torch.zeros(((t1 - t0) * h * w, cout), dtype=torch.int32,
                          device=xt.device)
        for tap in range(27):
            dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3
            a = xp[t0 + dt:t1 + dt, dh:dh + h, dw:dw + w]
            q = torch.round(a * inv_vox[t0:t1]).reshape(-1, cin)
            acc += (q @ wf[tap]).to(torch.int32)
        out = acc.float() * (s_vox[t0:t1].reshape(-1, 1) * ws) + bias.float()
        y[0, t0:t1] = out.reshape(t1 - t0, h, w, cout).to(xt.dtype)
    return y


def conv3d_plain(x, weight, bias, time_padded: bool = False, scale=None,
                 shift=None, act: bool = False, prefix_planes: int = 0,
                 quant: bool = False):
    """Plain causal conv with replicate padding, in every mode of
    :func:`causal_conv3d_fused`; fp32 compute, output in x.dtype. x (B, T,
    H, W, Cin); weight (Cout, Cin, kt, kh, kw)."""
    _check_modes(x, scale, shift, time_padded, prefix_planes, quant)
    if scale is not None:
        x = conv_prologue(x, scale, shift, act, prefix_planes)
    if quant:
        return _conv_quant_plain(x, weight, bias, time_padded)
    kt, kh, kw = weight.shape[2:]
    xc = x.permute(0, 4, 1, 2, 3).float()
    tpad = 0 if time_padded else kt - 1
    xc = F.pad(xc, (kw // 2, kw // 2, kh // 2, kh // 2, tpad, 0),
               mode="replicate")
    y = F.conv3d(xc, weight.float(), bias.float())
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def _check_modes(x, scale, shift, time_padded, prefix_planes, quant):
    if (scale is None) != (shift is None):
        raise ValueError("K3: scale and shift come together")
    if prefix_planes and (scale is None or not time_padded):
        raise ValueError("K3: prefix_planes needs the prologue and time_padded")
    if quant and x.shape[0] != 1:
        raise ValueError(f"K3's W8A8 mode takes batch 1, got {x.shape[0]}")


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def quant_window_scales(x, bw: int, time_padded: bool = False, scale=None,
                        shift=None, act: bool = False, prefix_planes: int = 0):
    """The W8A8 mode's activation scales (s, inv), each (T, H/8, W/bw) fp32,
    over the prologue's output when ``scale`` is given: the window-max
    reduction of K3's body (``csrc/conv3d.cu``) for a CUDA tensor (one
    count on ``K3_quant_windows``), :func:`window_scales` for a CPU one.
    x (1, T_in, H, W, Cin)."""
    if x.device.type == "cpu":
        if scale is not None:
            x = conv_prologue(x, scale, shift, act, prefix_planes)
        return window_scales(x, bw, time_padded)
    _, t, h, w, cin = x.shape
    if x.dtype != torch.bfloat16 or h % QUANT_BH or w % bw or cin % 8:
        raise ValueError(f"K3's window scales take bf16 (1, T, 8k, bw k, C), "
                         f"got {x.shape} {x.dtype} bw {bw}")
    t_out = t - 2 if time_padded else t
    rowmax = torch.empty((t, h, w // bw), dtype=torch.float32, device=x.device)
    s = torch.empty((t_out, h // QUANT_BH, w // bw), dtype=torch.float32,
                    device=x.device)
    inv = torch.empty_like(s)
    _kernels.check_cuda("K3", x=x, scale=scale, shift=shift)
    _kernels.launch("k5_conv3d_window_scale", "K3_quant_windows",
                    x.data_ptr(), _kernels.ptr(scale), _kernels.ptr(shift),
                    rowmax.data_ptr(), s.data_ptr(), inv.data_ptr(), t, h, w,
                    cin, bw, int(time_padded), int(scale is not None),
                    int(act), prefix_planes)
    return s, inv


def causal_conv3d_fused(x, weight, bias, time_padded: bool = False,
                        scale=None, shift=None, act: bool = False,
                        prefix_planes: int = 0, quant: bool = False):
    """K3 wrapper. x (B, T, H, W, Cin) bf16 NDHWC; weight (Cout, Cin, 3, 3,
    3); bias (Cout,); scale/shift (Cin,) fp32 for the prologue. Returns (B,
    T', H, W, Cout) with T' = T - 2 when ``time_padded`` else T. Batch items
    run as separate launches. Under ``quant`` the window maxima come first
    (one launch of the reduction, its own count), then the int8 conv."""
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias, time_padded, scale, shift, act,
                            prefix_planes, quant)
    _check_modes(x, scale, shift, time_padded, prefix_planes, quant)
    b, t, h, w, cin = x.shape
    cout = weight.shape[0]
    if x.dtype != torch.bfloat16 or not conv_kernel_supported(weight) \
            or weight.shape[1] != cin:
        raise ValueError(f"K3 takes bf16 3x3x3 convs between 128-512 "
                         f"channels, got x {x.shape} {x.dtype} w {weight.shape}")
    t_out = t - 2 if time_padded else t
    if t_out < 1:
        raise ValueError(f"K3: {t} frames leave no output")
    x = x.contiguous()
    bias32 = bias.float().contiguous()
    y = torch.empty((b, t_out, h, w, cout), dtype=x.dtype, device=x.device)
    fuse = scale is not None
    sc = sh = None
    if fuse:
        sc, sh = scale.float().contiguous(), shift.float().contiguous()
        if sc.shape != (cin,) or sh.shape != (cin,):
            raise ValueError(f"K3: scale/shift must be ({cin},)")
    if quant:
        bw = quant_tile_width(w, cin, cout)
        w8, ws = quantized_weight(weight)
        s, inv = quant_window_scales(x, bw, time_padded, sc, sh, act,
                                     prefix_planes)
        _kernels.check_cuda("K3", w8=w8, ws=ws, bias=bias32)
        _kernels.launch("k5_conv3d_quant", "K3_conv3d_quant", x.data_ptr(),
                        w8.data_ptr(), ws.data_ptr(), bias32.data_ptr(),
                        _kernels.ptr(sc), _kernels.ptr(sh), s.data_ptr(),
                        inv.data_ptr(), y.data_ptr(), t_out, h, w, cin, cout,
                        bw, int(time_padded), int(fuse), int(act),
                        prefix_planes)
        return y
    w27 = weight.to(torch.bfloat16).permute(2, 3, 4, 0, 1).reshape(
        27, cout, cin).contiguous()
    _kernels.check_cuda("K3", x=x, w27=w27, bias=bias32, scale=sc, shift=sh)
    for bi in range(b):
        if fuse:
            _kernels.launch("k5_conv3d_fused", "K3_conv3d_fused",
                            x[bi].data_ptr(), w27.data_ptr(), bias32.data_ptr(),
                            sc.data_ptr(), sh.data_ptr(), y[bi].data_ptr(),
                            t_out, h, w, cin, cout, int(time_padded),
                            int(act), prefix_planes)
        else:
            _kernels.launch("k5_conv3d", "K3_conv3d", x[bi].data_ptr(),
                            w27.data_ptr(), bias32.data_ptr(), y[bi].data_ptr(),
                            t_out, h, w, cin, cout, int(time_padded))
    return y
