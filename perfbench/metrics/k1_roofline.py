"""K1's share of its roofline in a denoise cell: the bound of every
self-attention K1 served in the window (the visual blocks' at the cell's
tokens, the text blocks' over each request's valid text) over K1's device
time. Silent unless K1 ran once per block and step."""

from perfbench.peaks import bound_s
from perfbench.work import attention_dense


def read(layer):
    info, steps = layer.info, layer.units
    dit = info["dit"]
    d = sum(dit["axes_dims"])
    h = dit["model_dim"] // d
    s, n = info["tokens"], info["text_len"]
    blocks = dit["num_visual_blocks"] + dit["num_text_blocks"]
    if info["sparse"] or layer.launches.get("K1_flash_fixed") != steps * blocks:
        return None
    total = steps * dit["num_visual_blocks"] * bound_s(
        *attention_dense(1, s, s, s, h, d))
    total += dit["num_text_blocks"] * sum(
        bound_s(*attention_dense(1, n, v, n, h, d)) for v in info["text_valid"])
    share = layer.roofline("k1_roofline", total)
    return None if share is None else 100.0 * share
