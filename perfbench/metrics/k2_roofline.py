"""K2's share of its roofline in a denoise cell: the bound of the
modulated FF of every visual block of every step (the text blocks' 256
rows run the library chain) over the device time of K2's modulation pass
and GEMMs. Silent unless K2 ran once per visual block and step."""

from perfbench.peaks import bound_s
from perfbench.work import modulated_ff


def read(layer):
    info, steps = layer.info, layer.units
    dit = info["dit"]
    n = steps * dit["num_visual_blocks"]
    if layer.launches.get("K2_ff_mod") != n:
        return None
    total = n * bound_s(*modulated_ff(info["tokens"], dit["model_dim"],
                                      dit["ff_dim"]))
    share = layer.roofline("k2_roofline", total)
    return None if share is None else 100.0 * share
