"""3x3x3 time-causal convolution: kernel K3 beside its plain PyTorch version.

Counterpart of ``kandinsky5_tpu/ops/conv_pallas.py`` (``causal_conv3d_fused``
in its plain and ``time_padded`` modes). Activations are NDHWC; the weight
is torch's Conv3d layout (Cout, Cin, 3, 3, 3). Padding is replicate: two
leading frames in time (or none with ``time_padded``, where the input
already carries two history frames) and one on each spatial side. The
plain version computes in fp32; K3 (``csrc/conv3d.cu``) accumulates in
fp32 and rounds the output to bf16. A CPU tensor goes to the plain
version, a CUDA tensor to the kernel (or raises).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels

KERNEL_CHANNELS = (128, 256, 512)


def conv_kernel_supported(weight: torch.Tensor) -> bool:
    """The decoder convs K3 serves: 3x3x3 with Cin, Cout in {128, 256, 512}
    (as ``conv_pallas_supported`` picks them; conv_in with Cin 16 and
    conv_out with Cout 3 stay plain)."""
    cout, cin = weight.shape[:2]
    return (tuple(weight.shape[2:]) == (3, 3, 3) and cin in KERNEL_CHANNELS
            and cout in KERNEL_CHANNELS)


def conv3d_plain(x, weight, bias, time_padded: bool = False):
    """Plain causal conv with replicate padding, fp32 compute, output in
    x.dtype. x (B, T, H, W, Cin); weight (Cout, Cin, kt, kh, kw)."""
    kt, kh, kw = weight.shape[2:]
    xc = x.permute(0, 4, 1, 2, 3).float()
    tpad = 0 if time_padded else kt - 1
    xc = F.pad(xc, (kw // 2, kw // 2, kh // 2, kh // 2, tpad, 0),
               mode="replicate")
    y = F.conv3d(xc, weight.float(), bias.float())
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def causal_conv3d_fused(x, weight, bias, time_padded: bool = False):
    """K3 wrapper. x (B, T, H, W, Cin) bf16 NDHWC; weight (Cout, Cin, 3, 3,
    3); bias (Cout,). Returns (B, T', H, W, Cout) with T' = T - 2 when
    ``time_padded`` else T. Batch items run as separate launches."""
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias, time_padded)
    b, t, h, w, cin = x.shape
    cout = weight.shape[0]
    if x.dtype != torch.bfloat16 or not conv_kernel_supported(weight) \
            or weight.shape[1] != cin:
        raise ValueError(f"K3 takes bf16 3x3x3 convs between 128-512 "
                         f"channels, got x {x.shape} {x.dtype} w {weight.shape}")
    t_out = t - 2 if time_padded else t
    if t_out < 1:
        raise ValueError(f"K3: {t} frames leave no output")
    w27 = weight.to(torch.bfloat16).permute(2, 3, 4, 0, 1).reshape(
        27, cout, cin).contiguous()
    bias32 = bias.float().contiguous()
    _kernels.check_cuda("K3", x=x, w27=w27, bias=bias32)
    y = torch.empty((b, t_out, h, w, cout), dtype=x.dtype, device=x.device)
    for bi in range(b):
        _kernels.launch("k5_conv3d", "K3_conv3d", x[bi].data_ptr(),
                        w27.data_ptr(), bias32.data_ptr(), y[bi].data_ptr(),
                        t_out, h, w, cin, cout, int(time_padded))
    return y
