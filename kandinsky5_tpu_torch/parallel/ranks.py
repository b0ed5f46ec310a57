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

Over several hosts (:func:`launch` with ``nodes``) the layout is that of
JAX's ``make_hybrid_mesh`` (:func:`hybrid_rank_grid`): dp spans the hosts,
each tp row lies inside one host, and each rank's mesh carries its host's
group (``RankMesh.node``). The node's index and the master's address are
arguments: nothing is read from the environment.

The backend is the caller's explicit choice and nothing switches it:
``"nccl"`` for one GPU per rank, ``"gloo"`` for ranks that share one card
(NCCL refuses two ranks on one GPU; gloo stages CUDA tensors through the
host) or run on the CPU.

Collectives that autograd sees. ``RankGroup.all_reduce`` and
``all_gather`` work in place or on detached values, so the trainer's
backward goes through five functions instead, each bound to a group
(the JAX package gets the same transposes from GSPMD and ``shard_map``):

==================== ==================== =============================
function              forward              backward
==================== ==================== =============================
:func:`copy_to`       identity             all-reduce sum
:func:`reduce_from`   all-reduce sum       identity
:func:`gather_along`  all-gather on dim    reduce-scatter sum on dim
:func:`gather_whole`  all-gather on dim    the rank's own slice
:func:`split_along`   the rank's slice     all-gather on dim
==================== ==================== =============================

They serve one rule. Outside the DiT's visual block stack every tensor
is replicated: each rank of a (dp index's) sp x tp group computes it
whole, and its gradient on each rank is whole too, since the loss is
computed whole on every rank. Inside the stack a rank holds its sp rows
and its tp heads (``models/dit.py``):

* tp: an activation is replicated over tp and enters each column-parallel
  linear (Q/K/V, the cross-attention's cond, the FF's in layer) through
  :func:`copy_to`, whose backward sums the rank's heads' share of its
  gradient over tp; a replicated weight applied to the rank's heads alone
  (the QK RMSNorms) enters the same way. A row-parallel product is partial
  and :func:`reduce_from` sums it (its gradient is whole on every rank).
* sp: the stack's input enters through :func:`split_along`; the text and
  the time embedding, used whole by every rank's rows, through
  :func:`copy_to` over sp; K and V through :func:`gather_along`, whose
  reduce-scatter sums every rank's queries' gradient into each rank's
  keys; the stack's output leaves through :func:`gather_whole`, whose
  consumer (the out layer, the loss) is replicated, so each rank keeps its
  rows' gradient and nothing is summed (``torch.distributed.nn``'s
  all-gather sums there: sp times the gradient).
* what stays partial: the visual blocks' parameters see only the rank's
  rows, so their gradients are partial over sp; ``training.py`` sums them
  over sp, then averages every gradient over dp.

Each calls the group's counted, host-staged collectives, so ``calls``,
``bytes`` and ``seconds`` count the backward's too. No group (None) is
the identity, and so is a group of one under autograd. Where no gradient
is needed (``torch.no_grad()``, or an input that does not require one)
each calls exactly what inference called before they existed: the group's
in-place ``all_reduce`` (the only method a group needs there), its
``all_gather``, a view of the slice.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

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
    1 when None). It counts its all-reduces, gathers and reduce-scatters
    (``calls``, ``bytes``, and the bytes by dtype, ``dtype_bytes``) and the
    host seconds they took (``seconds``), and each kind's calls and seconds
    apart (``kinds``: "all_reduce", "all_gather", "gather",
    "reduce_scatter"); broadcasts are not counted. Under gloo a CUDA tensor is synchronized before and after
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
        self.dtype_bytes, self.kinds = {}, {}

    def _sync(self, x) -> None:
        if x.is_cuda and self.backend == "gloo":
            torch.cuda.synchronize(x.device)

    def _count(self, kind: str, t0: float, x: torch.Tensor,
               parts: int = 1) -> None:
        dt = time.perf_counter() - t0
        self.seconds += dt
        self.calls += 1
        calls, seconds = self.kinds.get(kind, (0, 0.0))
        self.kinds[kind] = (calls + 1, seconds + dt)
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
        self._count("all_reduce", t, x)
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
        self._count("all_gather", t, src, self.size)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of every rank's ``x`` (all of one shape), cut into
        ``size`` equal parts along ``dim``: this rank's part, on ``x``'s
        device (the transpose of :meth:`all_gather`)."""
        self._sync(x)
        t = time.perf_counter()
        src = self._staged(x)
        parts = [p.contiguous() for p in src.chunk(self.size, dim)]
        out = torch.empty_like(parts[self.rank])
        dist.reduce_scatter(out, parts, group=self.group)
        out = out.to(x.device)
        self._sync(out)
        self._count("reduce_scatter", t, src)
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
        self._count("gather", t, src, self.size)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Group rank ``src``'s ``x`` on every rank (in place)."""
        if self.size > 1:
            dist.broadcast(x, src=self.ranks[src], group=self.group)
        return x

    @property
    def wire(self) -> torch.device:
        """Where small host values (a seed, a flag, a message) travel: the
        rank's card under NCCL, which moves only CUDA tensors, else the
        CPU."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Group rank ``src``'s ``obj`` (any picklable value) on every rank;
        the others' ``obj`` is ignored."""
        if self.size == 1:
            return obj
        if self.rank == src:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8).to(self.wire)
            n = torch.tensor([data.numel()], dtype=torch.int64,
                             device=self.wire)
        else:
            n = torch.zeros(1, dtype=torch.int64, device=self.wire)
        self.broadcast(n, src)
        if self.rank != src:
            data = torch.empty(int(n.item()), dtype=torch.uint8,
                               device=self.wire)
        self.broadcast(data, src)
        return obj if self.rank == src else pickle.loads(
            data.cpu().numpy().tobytes())

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")


class TensorParallel(RankGroup):
    """A tensor-parallel group: the ranks that hold one model's shares and
    sum its row-parallel products (``models/nn.py``, :func:`reduce_from`);
    under autograd the column-parallel inputs and the QK norms' weights
    enter through :func:`copy_to`, and the trainer sums the squares of the
    shares' gradients over it for the global clip norm."""


class SequenceParallel(RankGroup):
    """A sequence-parallel group: the ranks of one (dp, tp) index, each
    holding a contiguous 1/sp of the visual tokens through the DiT's visual
    blocks (:func:`split_along`); they all-gather each self-attention's K
    and V along the sequence (:func:`gather_along`, a reduce-scatter in the
    backward) and the blocks' output once at the stack's exit
    (:func:`gather_whole`; ``models/dit.py``). The trainer sums the visual
    blocks' gradients over it."""


class DataParallel(RankGroup):
    """A data-parallel group: the ranks of one (sp, tp) index, each
    computing its block of the batch; the sampler all-gathers their
    predictions, the trainer all-reduces their gradients as their mean
    (ZeRO-1: each keeps a slice of the moments and all-gathers the updated
    parameters)."""


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _contiguous_copy(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(_contiguous_copy(g)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(_contiguous_copy(x))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, transpose):
        ctx.group, ctx.dim, ctx.transpose = group, dim, transpose
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.transpose:
            g = ctx.group.reduce_scatter(g, ctx.dim)
        else:
            g = _own_slice(g, ctx.group, ctx.dim)
        return g, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _contiguous_copy(_own_slice(x, group, dim))

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``, entering work that each rank does
    on its own share: the identity, whose backward sums the gradient over
    the group."""
    if group is None or not _needs_grad(x) or group.size == 1:
        return x
    return _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group`` (in place where no
    gradient is needed); the gradient passes to each rank's part as it
    is."""
    if group is None:
        return x
    if not _needs_grad(x):
        return group.all_reduce(x)
    return x if group.size == 1 else _Reduce.apply(x, group)


def gather_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` for a consumer that
    each rank runs on its own share (K and V for the rank's queries): the
    backward reduce-scatters the gradient, summing every rank's share of
    it into the rank's slice."""
    if group is None:
        return x
    if not _needs_grad(x):
        return group.all_gather(x, dim)
    return x if group.size == 1 else _Gather.apply(x, group, dim, True)


def gather_whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` for a consumer that
    every rank runs whole (the stack's output, the loss): the backward
    keeps the rank's slice of the gradient, which is already whole."""
    if group is None:
        return x
    if not _needs_grad(x):
        return group.all_gather(x, dim)
    return x if group.size == 1 else _Gather.apply(x, group, dim, False)


def split_along(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The rank's contiguous 1/size of a replicated ``x`` along ``dim`` (a
    view where no gradient is needed): the backward all-gathers the
    ranks' gradients, each whole for its slice."""
    if group is None:
        return x
    if not _needs_grad(x):
        return _own_slice(x, group, dim)
    return x if group.size == 1 else _Split.apply(x, group, dim)


class RankMesh(NamedTuple):
    """One rank's place on the (dp, sp, tp) mesh: its data-parallel group,
    its tensor-parallel group, the group of every rank (``world``: the
    tiled decode splits its tiles over it, the noise is rank 0's of it),
    its sequence-parallel group (``sp``; None is a group of one, so that a
    (dp, 1, tp) place is ``RankMesh(dp, tp, world)``), the group of the
    sp * tp ranks of its dp index (``shard``, in (sp, tp) order: the JAX
    package's ``axes=("sp", "tp")``, over which the Qwen tower shards,
    ``text/qwen.py`` ``shard_qwen``; :func:`rank_mesh` and :func:`as_mesh`
    cut it), the group of the mesh's ranks on its host (``node``; None
    when the whole mesh is on one host: the world) and the index of its
    host (``host``). A group of one rank has no process group."""

    dp: DataParallel
    tp: TensorParallel
    world: RankGroup
    sp: Optional[SequenceParallel] = None
    shard: Optional[RankGroup] = None
    node: Optional[RankGroup] = None
    host: int = 0

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

    @property
    def local(self) -> RankGroup:
        """The mesh's ranks on this rank's host (the world on one host):
        what the JAX package's ``jax.local_devices()`` are to a process."""
        return self.world if self.node is None else self.node


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


def hybrid_rank_grid(tp: int, dp_ici: int, host_of: Sequence[int]
                     ) -> np.ndarray:
    """The ranks laid out as JAX's ``make_hybrid_mesh(tp, dp_ici)`` lays out
    its devices, ``host_of[r]`` the host of global rank r: the ranks grouped
    by host, the hosts in ascending order, each host's group (its ranks in
    ascending order) reshaped to (dp_ici, tp), the groups stacked to (hosts
    x dp_ici, tp). Every tp row lies inside one host, so only dp crosses
    hosts. Raises where JAX asserts: uneven ranks per host, or dp_ici x tp
    unlike the ranks per host."""
    hosts = {}
    for r, h in enumerate(host_of):
        hosts.setdefault(int(h), []).append(r)
    groups = [hosts[h] for h in sorted(hosts)]
    per = len(groups[0])
    if any(len(g) != per for g in groups):
        raise ValueError("uneven ranks per host: "
                         f"{[len(g) for g in groups]}")
    if dp_ici < 1 or tp < 1 or per != dp_ici * tp:
        raise ValueError(f"dp_ici*tp = {dp_ici * tp} != {per} ranks per "
                         "host")
    return np.array([np.reshape(g, (dp_ici, tp)) for g in groups]).reshape(
        len(groups) * dp_ici, tp)


def rank_device(device: str, rank: int, world: int, backend: str):
    """The device of ``rank`` among the ``world`` ranks of its host: the
    CPU, or for ``"cuda"`` card ``rank % device_count``. NCCL needs a card
    per rank; sharing one takes gloo."""
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
              device, hosts: Optional[Sequence[int]] = None
              ) -> Optional[RankMesh]:
    """This process's :class:`RankMesh`, on ``device``, on the (dp, sp, tp)
    mesh of the
    global ``ranks`` laid out as :func:`rank_grid` lays out its indices
    (``launch`` gives each rank the mesh of every rank; a caller may cut
    a smaller mesh from some of them). Every rank of the default group
    calls it, in the same order, since creating a group is collective; a
    rank outside ``ranks`` gets None. A group's ranks run along its axis,
    the other two indices fixed; the groups are created tp, then sp, then
    dp, then the sp * tp groups of each dp index (``RankMesh.shard``), then
    the mesh's world, then (with ``hosts``) each host's ranks.

    ``hosts`` gives the host of each of ``ranks`` (in their order); each
    rank's mesh then carries its host's ranks in the order of ``ranks``
    (``RankMesh.node``; None on one host). That the tp rows stay inside a
    host is ``launch``'s check (``_ranks_per_node``)."""
    ranks = list(ranks)
    grid = np.asarray(ranks)[rank_grid(len(ranks), dp, sp)]
    host_of = None
    if hosts is not None:
        if len(hosts) != len(ranks):
            raise ValueError(f"{len(hosts)} hosts for {len(ranks)} ranks")
        host_of = dict(zip(ranks, (int(h) for h in hosts)))
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
    node = None
    if host_of is not None and len(set(host_of.values())) > 1:
        for h in sorted(set(host_of.values())):
            members = [r for r in ranks if host_of[r] == h]
            pg = _group(members, backend)
            if me in members:
                node = RankGroup(pg, members.index(me), len(members),
                                 backend, torch.device(device),
                                 ranks=members)
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
                    group(SequenceParallel, "sp"), group(RankGroup, "shard"),
                    node, 0 if host_of is None else host_of[me])


def _rank_main(call_path: str, rank: int, local: int, per_node: int,
               world: int, dp: int, sp: int, nodes: int, backend: str,
               device: str, store: Tuple, timeout: Optional[float],
               results) -> None:
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, local, per_node, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        wait = datetime.timedelta(seconds=timeout or 1800.0)
        if store[0] == "tcp":
            # global rank 0 hosts the store; the others connect to it
            kv = dist.TCPStore(store[1], store[2], world, is_master=rank == 0,
                               timeout=wait)
        else:
            kv = dist.FileStore(store[1], world)
        dist.init_process_group(backend, store=kv, rank=rank,
                                world_size=world)
        try:
            if nodes > 1:
                # the node's ranks are contiguous, so JAX's hybrid order is
                # the ranks' own; it is built as make_hybrid_mesh builds it
                hosts = [r // per_node for r in range(world)]
                grid = hybrid_rank_grid(world // dp, per_node * dp // world,
                                        hosts).reshape(-1).tolist()
                mesh = rank_mesh(grid, dp, 1, backend, dev,
                                 hosts=[hosts[r] for r in grid])
            else:
                mesh = rank_mesh(range(world), dp, sp, backend, dev)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def _ranks_per_node(world: int, dp: int, sp: int, nodes: int) -> int:
    """The ranks on each of ``nodes`` hosts of a ``world``-rank launch on the
    (dp, sp, world / (dp sp)) mesh; raises unless each tp row fits inside a
    host (the hybrid layout has no sp: ``sp`` must be 1 over more than one
    host)."""
    if nodes < 1 or world % nodes:
        raise ValueError(f"{nodes} nodes must divide {world} ranks")
    per = world // nodes
    rank_grid(world, dp, sp)
    if nodes == 1:
        return per
    if sp != 1:
        raise ValueError("over several hosts the mesh is JAX's hybrid (dp, "
                         f"tp) layout: sp must be 1, got {sp}")
    tp = world // dp
    if per % tp:
        raise ValueError(f"tp={tp} must divide the {per} ranks of a node: a "
                         "tp row may not cross hosts")
    return per


def launch(fn: Callable[..., Any], world: int, backend: str, device: str,
           args: Sequence = (), timeout: Optional[float] = 3600.0,
           dp: int = 1, sp: int = 1, nodes: int = 1, node_rank: int = 0,
           master: Optional[Tuple[str, int]] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` rank processes, ``mesh`` each
    rank's :class:`RankMesh` on the (dp, sp, world / (dp sp)) mesh, and
    return their results in rank order.

    ``fn`` is a module-level function (the ranks are started with the
    ``spawn`` method and import it); what it returns is pickled, so it
    should hold CPU tensors or plain values. On one node each call
    rendezvouses through a ``FileStore`` in a fresh temporary directory, so
    concurrent launches never share a port or a file; ``fn`` and ``args``
    reach the ranks through a file there, so that they start together
    (through the spawn pipe the parent would wait on each rank in turn to
    import what unpickling them needs). ``device`` is ``"cpu"`` or
    ``"cuda"`` (a node's local rank r on card r mod the card count). A rank
    that raises or dies, or a run past ``timeout`` seconds (None: no
    limit), ends every rank and raises here. An interrupt (SIGINT) is
    passed on to the ranks once, and the launch waits for them to end; a
    second one ends them.

    Over ``nodes`` hosts each host calls ``launch`` with the same
    ``world``, ``dp``, ``fn`` and ``args``, its own ``node_rank`` and the
    ``master`` (address, port) of a ``TCPStore``, which global rank 0 (on
    node 0) serves. A call starts its node's ranks only: global rank =
    node_rank x (world / nodes) + local index, and returns their results.
    The mesh is JAX's ``make_hybrid_mesh(tp, dp_ici)`` (:func:`
    hybrid_rank_grid`): tp = world / dp must divide the ranks of a node
    (else it raises before any rank starts), dp_ici = ranks per node / tp,
    sp = 1."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    per = _ranks_per_node(world, dp, sp, nodes)
    if not 0 <= node_rank < nodes:
        raise ValueError(f"node_rank {node_rank} outside {nodes} nodes")
    if nodes > 1 and master is None:
        raise ValueError("a launch over several nodes needs the master's "
                         "(address, port)")
    ranks = range(node_rank * per, (node_rank + 1) * per)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="k5_ranks_") as tmp:
        results = ctx.Queue()
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        store = (("tcp", master[0], int(master[1])) if master is not None
                 else ("file", os.path.join(tmp, "store")))
        procs = {r: ctx.Process(target=_rank_main,
                                args=(call_path, r, r - ranks[0], per, world,
                                      dp, sp, nodes, backend, device, store,
                                      timeout, results))
                 for r in ranks}
        for p in procs.values():
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        done, interrupted = {}, False
        try:
            while len(done) < len(procs):
                # a rank's result is in the queue before its process exits,
                # so one that exited with nothing left to read has died
                dead = [r for r, p in procs.items()
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
                except KeyboardInterrupt:
                    if interrupted:
                        raise
                    interrupted = True
                    for p in procs.values():
                        if p.is_alive():
                            os.kill(p.pid, signal.SIGINT)
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                done[rank] = pickle.loads(payload)
            for p in procs.values():
                p.join(timeout=60)
        finally:
            for p in procs.values():
                if p.is_alive():
                    p.terminate()
                p.join()
    return [done[r] for r in ranks]
