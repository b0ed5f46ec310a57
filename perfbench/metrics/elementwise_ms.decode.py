"""Device milliseconds a decode of the elementwise, reduction and copy
kernels (the VAE's GroupNorms, SiLUs, upsampling repeats, padding and the
uint8 conversion), over the decodes of the window."""

from perfbench.trace import ELEMENTWISE


def read(layer):
    if layer.trace is None:
        return None
    sec = layer.trace.group_s().get(ELEMENTWISE, 0.0)
    return 1e3 * sec / layer.units if sec > 0 else None
