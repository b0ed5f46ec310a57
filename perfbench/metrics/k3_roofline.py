"""K3's share of its roofline in a decode cell: the bound of every
3x3x3 conv between 128-512 channels of every decode of the window (the
streaming decode's schedule, ``work.decode_schedule``) over K3's device
time. Silent unless K3 ran once per such conv."""

from perfbench.peaks import bound_s
from perfbench.work import k3_bound_and_count

_COUNTERS = ("K3_conv3d", "K3_conv3d_fused", "K3_conv3d_quant")


def read(layer):
    i = layer.info
    total, count = k3_bound_and_count(
        i["latent_shape"], bound_s, channels=i["channels"],
        chunk_lat=i["chunk_lat"], attn_past=i["attn_past"],
        latent_channels=i["latent_channels"])
    if sum(layer.launches.get(c, 0) for c in _COUNTERS) != layer.units * count:
        return None
    share = layer.roofline("k3_roofline", layer.units * total)
    return None if share is None else 100.0 * share
