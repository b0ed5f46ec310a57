"""K4's share of its roofline in a decode cell: the bound of every mid
attention of every decode of the window over its visible keys (the
carried frames and the chunk's frames up to the query's) over K4's device
time. Silent unless K4 ran once per chunk."""

from perfbench.peaks import bound_s
from perfbench.work import k4_bound_and_count


def read(layer):
    i = layer.info
    total, count = k4_bound_and_count(
        i["latent_shape"], bound_s, channels=i["channels"],
        chunk_lat=i["chunk_lat"], attn_past=i["attn_past"],
        latent_channels=i["latent_channels"])
    if layer.launches.get("K4_flash_online") != layer.units * count:
        return None
    share = layer.roofline("k4_roofline", layer.units * total)
    return None if share is None else 100.0 * share
