"""Device milliseconds a step of the NABLA mask build: the kernels under
the program's ``nabla_mask.*`` profiler ranges (``ops/nabla.py``: pooled
map and softmax, sort, cumsum and scatter, kv lists), over the steps of
the window."""


def read(layer):
    if layer.trace is None or not layer.info.get("sparse"):
        return None
    sec = layer.trace.range_s("nabla_mask.")
    return 1e3 * sec / layer.units if sec > 0 else None
