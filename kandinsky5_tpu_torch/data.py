"""Training data: precomputed-latent shards and a prefetching loader.

Counterpart of ``kandinsky5_tpu/data.py``. Training reads PRECOMPUTED
tensors, VAE latents and the frozen text towers' outputs, because running
the 7B text tower and the VAE inside the step would dominate it:

  * :func:`write_shard` packs one ``.npz`` shard of {latents, text_embeds,
    pooled_embed, text_mask}, in the JAX package's format (fp16 arrays, a
    bool mask), so a shard written by either package loads in the other;
  * :func:`precompute_shard` builds a shard from raw clips and captions
    with a pipeline's own VAE encode and text towers (one-time preparation);
  * :class:`LatentShardLoader` yields shuffled, seeded batches, staged by a
    background thread onto a device while the caller's step runs. Its
    shuffles are the JAX loader's (``np.random.RandomState((seed, epoch))``,
    the same carry across shards), so both yield the same batches in the
    same order. Given a rank's data-parallel group (``dp=``, the JAX
    loader's ``mesh=`` with its batches on ``P("dp")``), each rank gets
    its rows [d n, (d + 1) n) of every global batch, n = batch / dp, on
    its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from kandinsky5_tpu_torch.utils import default_device

_KEYS = ("latents", "text_embeds", "pooled_embed", "text_mask")


def _np(a, dtype) -> np.ndarray:
    """A numpy array of ``dtype`` from an array, a tensor (any device) or a
    list of either."""
    if isinstance(a, (list, tuple)):
        return np.stack([_np(x, dtype) for x in a])
    if torch.is_tensor(a):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype)


def write_shard(path: str, latents, text_embeds, pooled_embed,
                text_mask) -> None:
    """latents (N, T, H, W, C), text_embeds (N, L, D), pooled_embed (N, P)
    stored fp16; text_mask (N, L) bool. Numpy arrays, tensors or lists of
    either."""
    n = len(latents)
    if any(len(a) != n for a in (text_embeds, pooled_embed, text_mask)):
        raise ValueError("a shard's four arrays need the same length")
    np.savez(path, latents=_np(latents, np.float16),
             text_embeds=_np(text_embeds, np.float16),
             pooled_embed=_np(pooled_embed, np.float16),
             text_mask=_np(text_mask, bool))


def precompute_shard(path: str, pipeline, videos, captions,
                     text_len: int = 256) -> None:
    """Encode raw clips and captions into a training shard with the
    pipeline's VAE (posterior mean, times its scaling factor) and text
    towers ("video" template), on the pipeline's device (its offloaded
    stages staged in turn). videos: (N, T, H, W, 3) uint8 or float in [0,
    255]; captions: N strings. Text embeddings are padded (mask False) or
    cut to ``text_len``."""
    lat, te, pe, ms = [], [], [], []
    vae = pipeline.vae
    for vid, cap in zip(videos, captions):
        x = torch.as_tensor(np.asarray(vid, np.float32) / 127.5 - 1.0)[None]
        with pipeline._staged("vae"):
            z = vae.encode(x.to(pipeline.device)) * vae.scaling_factor
        with pipeline._staged("text"):
            cond = pipeline.text_embedder.encode([cap], "video")
        emb = _np(cond.text_embeds[0], np.float16)
        mask = _np(cond.mask[0], bool)
        if emb.shape[0] < text_len:
            pad = text_len - emb.shape[0]
            emb = np.pad(emb, ((0, pad), (0, 0)))
            mask = np.pad(mask, (0, pad))
        lat.append(_np(z[0], np.float16))
        te.append(emb[:text_len])
        pe.append(_np(cond.pooled_embed[0], np.float16))
        ms.append(mask[:text_len])
    write_shard(path, lat, te, pe, ms)


class LatentShardLoader:
    """Shuffled, prefetching batch iterator over ``.npz`` latent shards.

    One background thread assembles the next batch and moves it to
    ``device`` (the CUDA card when None) while the caller's step runs.
    Batches hold ``dtype`` tensors (bf16 by default) and a bool
    ``text_mask``. Several hosts each pass ``host_shard=(index, count)`` to
    read disjoint subsets of the shards. With ``dp`` (a
    :class:`~kandinsky5_tpu_torch.parallel.DataParallel` group, whose every
    rank passes the same shards and seed) each batch holds this rank's
    contiguous block of the global batch's rows, on the group's device
    unless ``device`` is given; a batch that dp does not divide raises."""

    def __init__(self, shard_paths: Sequence[str], batch_size: int,
                 seed: int = 0, prefetch: int = 2, host_shard=None,
                 drop_remainder: bool = True, dtype=torch.bfloat16,
                 device=None, dp=None):
        paths = sorted(shard_paths)
        if host_shard is not None:
            idx, count = host_shard
            paths = paths[idx::count]
        if not paths:
            raise ValueError("no shards to load")
        self.paths = paths
        self.batch_size = batch_size
        self.seed = seed
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.dtype = dtype
        self.dp = dp if dp is not None and dp.size > 1 else None
        if self.dp is not None and batch_size % self.dp.size:
            raise ValueError(f"dp={self.dp.size} does not divide the batch "
                             f"of {batch_size}")
        self.device = default_device(device if device is not None or dp is None
                                     else dp.device)

    def _iter_host_batches(self, epoch: int):
        rng = np.random.RandomState((self.seed, epoch))
        order = rng.permutation(len(self.paths))
        carry = None
        for pi in order:
            with np.load(self.paths[pi]) as z:
                data = {k: z[k] for k in _KEYS}
            perm = rng.permutation(len(data["latents"]))
            data = {k: v[perm] for k, v in data.items()}
            if carry is not None:
                data = {k: np.concatenate([carry[k], data[k]]) for k in _KEYS}
            n = len(data["latents"])
            nb = n // self.batch_size
            for b in range(nb):
                sl = slice(b * self.batch_size, (b + 1) * self.batch_size)
                yield {k: v[sl] for k, v in data.items()}
            rem = n - nb * self.batch_size
            carry = {k: v[n - rem:] for k, v in data.items()} if rem else None
        if carry is not None and not self.drop_remainder:
            yield carry

    def _place(self, batch) -> dict:
        if self.dp is not None:
            rows = len(batch["latents"])
            if rows % self.dp.size:
                raise ValueError(f"dp={self.dp.size} does not divide a batch "
                                 f"of {rows} rows")
            n = rows // self.dp.size
            batch = {k: v[self.dp.rank * n:(self.dp.rank + 1) * n]
                     for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    device=self.device,
                    dtype=torch.bool if k == "text_mask" else self.dtype)
                for k, v in batch.items()}

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        """Yield one epoch's batches on the loader's device, prefetched. An
        exception in the producer (a corrupt shard, device memory) re-raises
        here; abandoning the generator stops the producer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def producer():
            try:
                for hb in self._iter_host_batches(epoch):
                    item = self._place(hb)
                    while not abandoned.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if abandoned.is_set():
                        return
                q.put(stop)
            except BaseException as e:  # noqa: BLE001  surfaced to the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()
            while not q.empty():  # drop staged batches
                q.get_nowait()
            thread.join(timeout=5.0)

    def __iter__(self):
        return self.epoch(0)
