"""The device's idle share of the traced window in a denoise cell: one
less the union of its activities' intervals over the window."""


def read(layer):
    t = layer.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
