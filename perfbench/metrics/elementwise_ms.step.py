"""Device milliseconds a step of the elementwise, reduction and copy
kernels (the DiT's norms, casts, gates, RoPE and modulations: the last
group of the copied name table), over the steps of the window."""

from perfbench.trace import ELEMENTWISE


def read(layer):
    if layer.trace is None:
        return None
    sec = layer.trace.group_s().get(ELEMENTWISE, 0.0)
    return 1e3 * sec / layer.units if sec > 0 else None
