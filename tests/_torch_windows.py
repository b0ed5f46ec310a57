"""The instances of K3's W8A8 window maxima (``ops.conv.quant_window_scales``)
that the decodes and the encode give it, their inputs and the control that
must fail, shared by ``chip_smoke.py`` (phase 2, ``--windows``) and
``test_torch_gpu_kernels.py``. Imports no JAX."""

from __future__ import annotations

# K3's window maxima: channels, input planes, H, W, the conv's Cout (which
# sets the TPU W tile), time_padded, the prologue, prefix planes, what
WINDOW_CASES = (
    (128, 17, 512, 768, 128, False, True, 0, "a 17-frame decode tile"),
    (128, 17, 512, 768, 128, False, False, 0, "a 17-frame decode tile"),
    (128, 14, 512, 768, 128, True, True, 2, "the streaming chunk, 12 + 2 frames"),
    (256, 9, 256, 384, 256, False, False, 0, "a 17-frame decode tile"),
    (512, 5, 128, 192, 512, False, True, 0, "a 17-frame decode tile"),
    (128, 17, 256, 384, 256, False, True, 0, "the encoder's 128->256"),
    (256, 9, 128, 192, 512, False, True, 0, "the encoder's 256->512"),
)


def short_window_scales(xt, bw: int, time_padded: bool):
    """Control for K3's window maxima: ``ops.conv.window_scales`` with each
    window one column short on the right."""
    import torch
    import torch.nn.functional as F

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    m = conv_mod._pad_time(xt, time_padded)[0].float().abs().amax(-1)
    m = F.pad(m[None], (1, 6, 1, 1), mode="replicate")[0]
    m = m.unfold(2, bw + 7, bw).amax(-1)
    m = m.unfold(1, conv_mod.QUANT_BH + 2, conv_mod.QUANT_BH).amax(-1)
    m = m.unfold(0, 3, 1).amax(-1)
    s = m.clamp_min(1e-8) / torch.full_like(m, 127.0)
    return s, torch.reciprocal(s)


def window_inputs(case, g, dev):
    """One WINDOW_CASES instance: (x, kw for ``quant_window_scales``, the
    transformed input, bw, a label). The input grows along W and carries
    sparse spikes in each window's last column (every third plane, every
    sixteenth row, the channel of the largest scale), so that a window's
    extent decides some maxima; the prologue's scales spread over a factor
    of about ten between channels."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    cin, tin, hh, ww, cout, tp, fuse, prefix, what = case
    bw = conv_mod.quant_tile_width(ww, cin, cout)
    x = torch.randn((1, tin, hh, ww, cin), generator=g, device=dev)
    x = x * (1 + torch.arange(ww, device=dev)[:, None] / ww)
    # scales that differ channel by channel (log-normal), so that a channel
    # transformed with another's scale moves the maxima
    sc = torch.exp(0.7 * torch.randn((cin,), generator=g, device=dev))
    sh = 0.1 * torch.randn((cin,), generator=g, device=dev)
    last = torch.arange(bw + 6, ww - 1, bw, device=dev)
    x[:, 1::3, 5::16, last, int(sc.argmax())] = 32.0
    x = x.bfloat16()
    kw = dict(time_padded=tp)
    if fuse:
        kw.update(scale=sc, shift=sh, act=True, prefix_planes=prefix)
    xt = conv_mod.conv_prologue(x, sc, sh, True, prefix) if fuse else x
    label = (f"{cin} ch {tin - 2 if tp else tin}x{hh}x{ww} bw {bw}"
             f"{' time_padded' if tp else ''}"
             f"{f', {prefix} prefix planes' if prefix else ''}"
             f"{' with the prologue' if fuse else ' without a prologue'}"
             f" ({what})")
    return x, kw, xt, bw, label
