"""The whole step's share of the card's bf16 peak: the model's matrix
products of every step of the window (self-attention at the kept fraction
its masks reported, cross-attention over the valid text) over the
window's seconds and 989 TFLOP/s."""

from perfbench.peaks import PEAK_BF16_FLOPS
from perfbench.work import dit_step_flops


def read(layer):
    info, steps = layer.info, layer.units
    dit = info["dit"]
    nb = dit["num_visual_blocks"]
    kept = info["kept"] if info["sparse"] else [1.0] * (nb * steps)
    if len(kept) != nb * steps or len(info["text_valid"]) != steps:
        return None
    flops = sum(dit_step_flops(dit, info["tokens"], info["text_len"], v,
                               kept[i * nb:(i + 1) * nb])
                for i, v in enumerate(info["text_valid"]))
    return 100.0 * flops / layer.window_s / PEAK_BF16_FLOPS
