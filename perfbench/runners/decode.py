"""Closed-loop decoding: one latent of the configuration's latent shape a
call to ``Kandinsky5T2VPipeline.decode_latents`` (the pipeline's default
streaming decode, the scaling, the clamp and the uint8 frames on the
host), back to back. Each latent is drawn from the run's seed and its
index. The control (``int8``) switches on the program's W8A8 convs
(``int8_conv``).

The check: one decode of the window, drawn from the seed, is recomputed by
the float32 reference from the same latent; compared are the frames'
root-mean-square difference in uint8 levels over the whole video and the
worst of its frames'.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function

from perfbench.harness import Cell, reservoir, sync


class Runner:
    def __init__(self, cell: Cell):
        self.cell = cell
        self.dev = cell.device
        self.cfg = cell.cfg
        self.latent_shape = tuple(cell.cfg["latent_shape"])
        self.n = -1

    def setup(self) -> None:
        from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
        from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
        from perfbench.weights import seeded_vae_decoder

        cell, dec = self.cell, self.cfg["decode"]
        if dec["mode"] != "stream":
            raise ValueError("the decode mix runs the streaming decode")
        if cell.control not in (None, "int8"):
            raise ValueError(f"the decode has no {cell.control!r} control")
        dtype = getattr(torch, self.cfg["dtype"])
        t = time.perf_counter()
        self.params = seeded_vae_decoder(
            cell.seed_for(cell.STREAM_WEIGHTS), self.dev, dtype,
            dec["block_out_channels"], dec["latent_channels"])
        self.pipe = Kandinsky5T2VPipeline(
            None, cell.conf, vae=HunyuanVideoVAE(self.params, dtype=dtype),
            int8_conv=cell.control == "int8", device=self.dev)
        sync(self.dev)
        self.setup_parts = {"weights_s": time.perf_counter() - t}
        t = time.perf_counter()
        # warm-up through the window's own path
        self.rng = cell.rng(cell.STREAM_SAMPLE + 100)
        self.seen, self.sample, self.bad = 0, None, 0
        for _ in range(int(cell.traffic["warm_units"])):
            self.unit()
        self.setup_parts["warm_s"] = time.perf_counter() - t
        self.n = -1
        self.rng = cell.rng(cell.STREAM_SAMPLE)
        self.seen, self.sample, self.bad = 0, None, 0

    def _decode(self):
        self.n += 1
        gen = torch.Generator(device=self.dev).manual_seed(
            self.cell.seed_for(self.cell.STREAM_REQUEST, self.n))
        z = torch.randn(self.latent_shape, generator=gen,
                        dtype=torch.float32, device=self.dev)
        with record_function("bench.decode"):
            frames = self.pipe.decode_latents(z)
        return z, frames

    def trace_scope(self, trace: bool):
        return contextlib.nullcontext()

    def unit(self) -> None:
        z, frames = self._decode()
        b, t, h, w = self.latent_shape[:4]
        if frames.shape != (b, 4 * (t - 1) + 1, 8 * h, 8 * w, 3) \
                or frames.dtype.name != "uint8":
            self.bad += 1
        self.seen += 1
        if reservoir(self.rng, self.seen):
            self.sample = {"decode": self.n, "z": z, "frames": frames}

    def failed(self) -> int:
        return self.bad

    def info(self) -> dict:
        dec = self.cfg["decode"]
        return {"latent_shape": list(self.latent_shape),
                "channels": dec["block_out_channels"],
                "chunk_lat": dec["chunk_lat"], "attn_past": dec["attn_past"],
                "latent_channels": dec["latent_channels"]}

    def release(self) -> None:
        self.pipe = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from perfbench.reference.vae import decode_frames

        dec = self.cfg["decode"]
        ref = decode_frames(self.params, self.sample["z"], dec["chunk_lat"],
                            dec["attn_past"])
        self.ref_frames = ref
        return compare(torch.from_numpy(self.sample["frames"]), ref)


def compare(frames, ref) -> dict:
    """The numbers compared: the root-mean-square difference in uint8
    levels over the whole video, and the worst over its frames."""
    if frames.shape != ref.shape:
        return {"frames_rmse": float("inf"), "worst_frame_rmse": float("inf")}
    sq = (frames.double() - ref.double()).square()
    return {"frames_rmse": float(sq.mean().sqrt()),
            "worst_frame_rmse": float(sq.mean((0, 2, 3, 4)).sqrt().max())}
