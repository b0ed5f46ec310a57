"""The whole decode's share of the card's bf16 peak: the matrix products
of every decode of the window (every conv, the mid attention over its
visible keys and its projections) over the window's seconds and
989 TFLOP/s."""

from perfbench.peaks import PEAK_BF16_FLOPS
from perfbench.work import decode_flops


def read(layer):
    i = layer.info
    flops = layer.units * decode_flops(
        i["latent_shape"], channels=i["channels"], chunk_lat=i["chunk_lat"],
        attn_past=i["attn_past"], latent_channels=i["latent_channels"])
    return 100.0 * flops / layer.window_s / PEAK_BF16_FLOPS
