"""Rank processes of a (dp, sp, tp) mesh: :class:`TensorParallel`,
:class:`SequenceParallel`, :class:`DataParallel`, the rank's place
:class:`RankMesh`, and :func:`launch`.

The JAX package runs one controller over a device mesh and keeps the mesh
in a module global (``parallel/sharding.py`` ``_ACTIVE_MESH``). PyTorch runs
one process per rank, as the reference does under torchrun; here each rank
gets a :class:`RankMesh` holding its tensor-parallel, sequence-parallel
and data-parallel groups, which the caller passes to the model, sampler or
pipeline it builds. No module global holds it.

The layout is the device order of JAX's ``make_mesh``: the ranks reshaped
to (dp, sp, tp), so rank r has dp index r // (sp tp), sp index (r // tp) %
sp and tp index r % tp (:func:`rank_grid`). The tp groups are contiguous
ranks (with NCCL they stay inside a node); an sp group holds the ranks of
one (dp, tp) index, at stride tp; a dp group those of one (sp, tp) index.

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
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from kandinsky5_tpu_torch.utils import default_device

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class RankGroup:
    """One rank's place in a group of ``size`` ranks: the process group
    (None for a group of one), the rank within it, the backend (``"nccl"``
    or ``"gloo"``, no default), the rank's device (the card unless
    ``device="cpu"`` is given; with no card and no device it raises) and
    the global ranks of the members in group order (``ranks``; 0 to size -
    1 when None). It counts its all-reduces and gathers (``calls``,
    ``bytes``, and the bytes by dtype, ``dtype_bytes``) and the host seconds
    they took (``seconds``); broadcasts are not counted. Under gloo a CUDA tensor is synchronized before and after
    the timed call, so the time is the collective's and not that of the
    work queued before it, and a gather stages it through the host, as
    gloo's own all-reduce does."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 device=None, ranks: Optional[Sequence[int]] = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.group, self.rank, self.size = group, rank, size
        self.ranks = list(range(size)) if ranks is None else list(ranks)
        if len(self.ranks) != size:
            raise ValueError(f"{len(self.ranks)} global ranks for a group "
                             f"of {size}")
        self.backend = backend
        device = default_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.dtype_bytes = {}

    def _sync(self, x) -> None:
        if x.is_cuda and self.backend == "gloo":
            torch.cuda.synchronize(x.device)

    def _count(self, t0: float, x: torch.Tensor, parts: int = 1) -> None:
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        n = x.numel() * x.element_size() * parts
        self.bytes += n
        key = str(x.dtype).replace("torch.", "")
        self.dtype_bytes[key] = self.dtype_bytes.get(key, 0) + n

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the backend moves it: a CUDA tensor goes through the
        host under gloo."""
        x = x.contiguous()
        return x.cpu() if x.is_cuda and self.backend == "gloo" else x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the group in place, in its own dtype (int32
        included, on gloo and NCCL), and return it: ``op`` "sum" or "max"
        (exact in any dtype, so a max over the ranks' shares is the whole
        tensor's)."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {tuple(_OPS)}, got {op!r}")
        self._sync(x)
        t = time.perf_counter()
        dist.all_reduce(x, op=_OPS[op], group=self.group)
        self._sync(x)
        self._count(t, x)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (all of one shape), concatenated along ``dim``
        in group order, on every rank, on ``x``'s device."""
        self._sync(x)
        t = time.perf_counter()
        src = self._staged(x)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim).to(x.device)
        self._sync(out)
        self._count(t, src, self.size)
        return out

    def gather(self, x: torch.Tensor, dst: int = 0) -> Optional[torch.Tensor]:
        """Every rank's ``x`` (all of one shape), concatenated along dim 0
        in group order, on group rank ``dst`` (on its ``x``'s device); None
        on the others."""
        self._sync(x)
        t = time.perf_counter()
        src = self._staged(x)
        parts = ([torch.empty_like(src) for _ in range(self.size)]
                 if self.rank == dst else None)
        dist.gather(src, parts, dst=self.ranks[dst], group=self.group)
        out = None if parts is None else torch.cat(parts).to(x.device)
        self._count(t, src, self.size)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` on every rank (in place)."""
        dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


class TensorParallel(RankGroup):
    """A tensor-parallel group: the ranks that hold one model's shares and
    all-reduce its row-parallel products (``models/nn.py``)."""


class SequenceParallel(RankGroup):
    """A sequence-parallel group: the ranks of one (dp, tp) index, each
    holding a contiguous 1/sp of the visual tokens through the DiT's visual
    blocks; they all-gather each self-attention's K and V along the
    sequence (``all_gather(x, dim=1)``) and the blocks' output once at the
    stack's exit (``models/dit.py``)."""


class DataParallel(RankGroup):
    """A data-parallel group: the ranks of one (sp, tp) index, each
    computing its block of the batch; the sampler all-gathers their
    predictions, the trainer all-reduces their gradients (ZeRO-1: each keeps
    a slice of the moments)."""


class RankMesh(NamedTuple):
    """One rank's place on the (dp, sp, tp) mesh: its data-parallel group,
    its tensor-parallel group, the group of every rank (``world``: the
    tiled decode splits its tiles over it, the noise is rank 0's of it),
    its sequence-parallel group (``sp``; None is a group of one, so that a
    (dp, 1, tp) place is ``RankMesh(dp, tp, world)``) and the group of the
    sp * tp ranks of its dp index (``shard``, in (sp, tp) order: the JAX
    package's ``axes=("sp", "tp")``, over which the Qwen tower shards,
    ``text/qwen.py`` ``shard_qwen``; :func:`rank_mesh` and :func:`as_mesh`
    cut it). A group of one rank has no process group."""

    dp: DataParallel
    tp: TensorParallel
    world: RankGroup
    sp: Optional[SequenceParallel] = None
    shard: Optional[RankGroup] = None

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def shape(self):
        """(dp, sp, tp), as JAX's ``mesh.shape``."""
        return (self.dp.size, 1 if self.sp is None else self.sp.size,
                self.tp.size)


def as_mesh(place) -> RankMesh:
    """The :class:`RankMesh` of ``place``: itself, or for a bare
    :class:`TensorParallel` the (1, 1, tp) mesh of its group."""
    if isinstance(place, RankMesh):
        return place
    if not isinstance(place, TensorParallel):
        raise TypeError("a rank's place is a RankMesh or a TensorParallel "
                        f"group, got {type(place).__name__}")
    one = DataParallel(None, 0, 1, place.backend, place.device,
                       ranks=[place.ranks[place.rank]])
    world = RankGroup(place.group, place.rank, place.size, place.backend,
                      place.device, ranks=place.ranks)
    return RankMesh(one, place, world, None, world)


def rank_grid(world: int, dp: int = 1, sp: int = 1) -> np.ndarray:
    """The ranks of a ``world``-rank launch laid out as the (dp, sp, tp)
    mesh: JAX's ``make_mesh(world, dp, sp=sp)`` device order, tp = world /
    (dp sp)."""
    if dp < 1 or sp < 1 or world % (dp * sp):
        raise ValueError(f"dp={dp} x sp={sp} must divide {world} ranks")
    return np.arange(world).reshape(dp, sp, world // (dp * sp))


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


def _group(ranks: List[int], backend: str):
    """The process group of global ``ranks``, created on every rank
    (``new_group`` is collective): None for one rank, the default group
    for every rank in rank order."""
    if len(ranks) == 1:
        return None
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks, backend=backend)


def rank_mesh(ranks: Sequence[int], dp: int, sp: int, backend: str,
              device) -> Optional[RankMesh]:
    """This process's :class:`RankMesh`, on ``device``, on the (dp, sp, tp)
    mesh of the
    global ``ranks`` laid out as :func:`rank_grid` lays out its indices
    (``launch`` gives each rank the mesh of every rank; a caller may cut
    a smaller mesh from some of them). Every rank of the default group
    calls it, in the same order, since creating a group is collective; a
    rank outside ``ranks`` gets None. A group's ranks run along its axis,
    the other two indices fixed; the groups are created tp, then sp, then
    dp, then the sp * tp groups of each dp index (``RankMesh.shard``), then
    the mesh's world."""
    ranks = list(ranks)
    grid = np.asarray(ranks)[rank_grid(len(ranks), dp, sp)]
    me = dist.get_rank()
    mine = {}
    for kind, axis in (("tp", 2), ("sp", 1), ("dp", 0)):
        for members in np.moveaxis(grid, axis, -1).reshape(
                -1, grid.shape[axis]).tolist():
            pg = _group(members, backend)
            if me in members:
                mine[kind] = (members, pg)
    for members in grid.reshape(dp, -1).tolist():
        pg = _group(members, backend)
        if me in members:
            mine["shard"] = (members, pg)
    world = _group(ranks, backend)
    if me not in ranks:
        return None
    dev = torch.device(device)

    def group(cls, kind):
        members, pg = mine[kind]
        return cls(pg, members.index(me), len(members), backend, dev,
                   ranks=members)

    return RankMesh(group(DataParallel, "dp"), group(TensorParallel, "tp"),
                    RankGroup(world, ranks.index(me), len(ranks), backend,
                              dev, ranks=ranks),
                    group(SequenceParallel, "sp"), group(RankGroup, "shard"))


def _rank_main(call_path: str, rank: int, world: int, dp: int, sp: int,
               backend: str, device: str, store_path: str, results) -> None:
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, rank, world, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            mesh = rank_mesh(range(world), dp, sp, backend, dev)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable[..., Any], world: int, backend: str, device: str,
           args: Sequence = (), timeout: Optional[float] = 3600.0,
           dp: int = 1, sp: int = 1) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` rank processes, ``mesh`` each
    rank's :class:`RankMesh` on the (dp, sp, world / (dp sp)) mesh, and
    return their results in rank order.

    ``fn`` is a module-level function (the ranks are started with the
    ``spawn`` method and import it); what it returns is pickled, so it
    should hold CPU tensors or plain values. Each call rendezvouses through
    a ``FileStore`` in a fresh temporary directory, so concurrent launches
    never share a port or a file; ``fn`` and ``args`` reach the ranks
    through a file there, so that they start together (through the
    spawn pipe the parent would wait on each rank in turn to import what
    unpickling them needs). ``device`` is ``"cpu"`` or ``"cuda"``
    (rank r on card r mod the card count). A rank that raises or dies, or a
    run past ``timeout`` seconds, ends every rank and raises here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    rank_grid(world, dp, sp)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="k5_ranks_") as tmp:
        results = ctx.Queue()
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main,
                             args=(call_path, r, world, dp, sp, backend,
                                   device, os.path.join(tmp, "store"),
                                   results))
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
