"""Rank processes of a tensor-parallel group: :class:`TensorParallel` and
:func:`launch`.

The JAX package runs one controller over a device mesh and keeps the mesh
in a module global (``parallel/sharding.py`` ``_ACTIVE_MESH``). PyTorch runs
one process per rank, as the reference does under torchrun; here each rank
gets a :class:`TensorParallel` holder, which the caller passes to the model
or pipeline it builds. No module global holds it.

The backend is the caller's explicit choice and nothing switches it:
``"nccl"`` for one GPU per rank, ``"gloo"`` for ranks that share one card
(NCCL refuses two ranks on one GPU; gloo stages CUDA tensors through the
host) or run on the CPU.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from kandinsky5_tpu_torch.utils import default_device

BACKENDS = ("nccl", "gloo")


class TensorParallel:
    """One rank's place in a tensor-parallel group of ``size`` ranks:
    the process group, the rank, the backend (``"nccl"`` or ``"gloo"``, no
    default) and the rank's device: the card unless ``device="cpu"`` is
    given (with no card and no device it raises). It counts its
    all-reduces (``calls``, ``bytes``) and the host seconds they took
    (``seconds``). With gloo on a CUDA tensor the card is
    synchronized before and after the timed call: gloo's copy to the host
    waits for the stream anyway, and so the time is the collective's and
    not that of the work queued before it."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.group, self.rank, self.size = group, rank, size
        self.backend = backend
        device = default_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0

    def _sync(self, x) -> None:
        if x.is_cuda and self.backend == "gloo":
            torch.cuda.synchronize(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the group in place (in its own dtype) and return
        it."""
        self._sync(x)
        t = time.perf_counter()
        dist.all_reduce(x, group=self.group)
        self._sync(x)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (in place)."""
        dist.broadcast(x, src=src, group=self.group)
        return x

    def __repr__(self) -> str:
        return (f"TensorParallel(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


def rank_device(device: str, rank: int, world: int, backend: str):
    """The device of ``rank``: the CPU, or for ``"cuda"`` card ``rank %
    device_count``. NCCL needs a card per rank; sharing one takes gloo."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device")
    if backend == "nccl" and n < world:
        raise ValueError(f"nccl needs one GPU per rank: {world} ranks, {n} "
                         "GPUs; ranks that share a card take backend='gloo'")
    return torch.device("cuda", rank % n)


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               store_path: str, results, args) -> None:
    try:
        dev = rank_device(device, rank, world, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            tp = TensorParallel(dist.group.WORLD, rank, world, backend, dev)
            out = fn(tp, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable[..., Any], world: int, backend: str, device: str,
           args: Sequence = (), timeout: Optional[float] = 3600.0) -> List[Any]:
    """Run ``fn(tp, *args)`` in ``world`` rank processes and return their
    results in rank order.

    ``fn`` is a module-level function (the ranks are started with the
    ``spawn`` method and import it); what it returns is pickled, so it
    should hold CPU tensors or plain values. Each call rendezvouses through
    a ``FileStore`` in a fresh temporary directory, so concurrent launches
    never share a port or a file. ``device`` is ``"cpu"`` or ``"cuda"``
    (rank r on card r mod the card count). A rank that raises or dies, or a
    run past ``timeout`` seconds, ends every rank and raises here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="k5_tp_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device,
                                   os.path.join(tmp, "store"), results,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        done = {}
        try:
            while len(done) < world:
                # a rank's result is in the queue before its process exits,
                # so one that exited with nothing left to read has died
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} exited without a "
                                           "result") from None
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(f"ranks did not finish in {timeout}"
                                           " s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                done[rank] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    return [done[r] for r in range(world)]
