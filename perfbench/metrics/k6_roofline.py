"""K6's share of its roofline in a NABLA denoise cell: the bound of every
sparse attention in the window at the kept fraction its mask reported
(``ops/nabla.record_density``) over K6's device time. Silent unless each
launch has its mask's fraction."""

from perfbench.peaks import bound_s
from perfbench.work import attention_sparse


def read(layer):
    info = layer.info
    dit, kept = info["dit"], info["kept"]
    d = sum(dit["axes_dims"])
    h = dit["model_dim"] // d
    s = info["tokens"]
    if not kept or layer.launches.get("K6_sparse_nabla") != len(kept):
        return None
    total = sum(bound_s(*attention_sparse(1, s, s, h, d, k)) for k in kept)
    share = layer.roofline("k6_roofline", total)
    return None if share is None else 100.0 * share
