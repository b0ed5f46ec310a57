"""NABLA block-sparse attention: the sliding-tile mask, the adaptive
top-CDF block mask, its kv lists, and the attention that runs under it.

Counterpart of ``kandinsky5_tpu/ops/nabla.py`` in its faithful mode only:
the top-CDF set is found by sorting each row of the block-pooled
attention map, every 64-token query block has its own row (``q_rows=1``)
and no density cap applies. The JAX package's TPU deviations (threshold
bisection, 8-row banks, the count cap, the shared mask) are not ported;
:func:`nabla_attention` raises on them. The mask is plain PyTorch (XLA
lowered it on the TPU); the attention runs kernel K6 (``ops/sparse.py``).
Tokens are in fractal order (``ops/fractal.py``): block i is tile i of
the row-major (T, H/8, W/8) tile grid.

On a mesh (the JAX package's ``_sparse_attention_sharded``) a rank holds
its tp heads and, under sequence parallelism, its rows: q is its
(B, S / sp, H / tp, D) shard and k, v the all-gathered (B, S, H / tp, D).
Its rows of the mask come from its q against the whole k (the pooled map
is a per-row softmax over every key block, so they equal the whole mask's
rows), ORed with its rows of the STA mask; K6 then runs its rows' kv lists
over the whole K/V.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from kandinsky5_tpu_torch.ops.sparse import BLOCK, sparse_attention


@functools.lru_cache(maxsize=16)
def sta_mask(T: int, H: int, W: int, wT: int = 11, wH: int = 3,
             wW: int = 3) -> np.ndarray:
    """(T*H*W, T*H*W) bool sliding-tile mask: tile (t, h, w) attends tile
    (t', h', w') iff |t-t'| <= wT//2, |h-h'| <= wH//2, |w-w'| <= wW//2."""
    t, h, w = np.arange(T), np.arange(H), np.arange(W)
    mt = np.abs(t[:, None] - t[None, :]) <= wT // 2
    mh = np.abs(h[:, None] - h[None, :]) <= wH // 2
    mw = np.abs(w[:, None] - w[None, :]) <= wW // 2
    m = (mt[:, None, None, :, None, None]
         & mh[None, :, None, None, :, None]
         & mw[None, None, :, None, None, :])
    return m.reshape(T * H * W, T * H * W)


def _attention_map(q, k):
    """Block-pooled softmax map (B, H, S/64, Sk/64) fp32: q and k averaged
    over each 64-token block (the mean rounded to q's dtype, as the JAX
    package's ``mean`` returns it), softmax(qa ka^T / sqrt(d))."""
    b, s, h, d = q.shape
    qa = q.reshape(b, s // BLOCK, BLOCK, h, d).float().mean(2).to(q.dtype).float()
    ka = k.reshape(b, -1, BLOCK, h, d).float().mean(2).to(k.dtype).float()
    amap = torch.einsum("bihd,bjhd->bhij", qa, ka)
    return torch.softmax(amap / math.sqrt(d), dim=-1)


def _topcdf_sort(amap, thr: float):
    """Keep each row's blocks outside the ascending-sorted prefix whose
    cumulative mass is below 1 - thr."""
    with record_function("nabla_mask.sort"):
        vals, inds = torch.sort(amap, dim=-1, stable=True)
    with record_function("nabla_mask.cumsum"):
        keep_sorted = torch.cumsum(vals, dim=-1) >= (1.0 - thr)
        return torch.empty_like(keep_sorted).scatter_(-1, inds, keep_sorted)


def _check_faithful(q_rows: int, max_density: Optional[float], method: str):
    if q_rows != 1 or method != "sort" or (
            max_density is not None and max_density < 1.0):
        raise ValueError(
            "the port runs NABLA in its faithful mode only (q_rows=1, "
            f"method='sort', no density cap); got q_rows={q_rows}, "
            f"method={method!r}, max_density={max_density}")


def nabla_block_mask(q, k, sta, thr: float = 0.9, method: str = "sort",
                     q_rows: int = 1, max_density: Optional[float] = None):
    """Adaptive block mask (B, H, S/64, Sk/64) bool: the top-CDF blocks of
    the pooled attention map OR the STA mask ``sta`` (S/64, Sk/64).
    q, k (B, S, H, D) in fractal order."""
    _check_faithful(q_rows, max_density, method)
    with record_function("nabla_mask.map"):
        amap = _attention_map(q, k)
    return _topcdf_sort(amap, thr) | sta.to(amap.device)[None, None]


def block_mask_to_kv_lists(mask):
    """Compact a (..., rows, s1) bool mask into kv lists: kv_inds (...,
    rows, s1) int32 with each row's active columns first, then the
    inactive ones, both ascending (a stable sort on "inactive"), and kv_nb
    (..., rows) int32 counts of the active ones."""
    with record_function("nabla_mask.lists"):
        nb = mask.sum(dim=-1, dtype=torch.int32)
        inds = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
        return inds.to(torch.int32), nb


def masked_block_attention(q, k, v, mask, scale: Optional[float] = None):
    """Dense attention under the block mask expanded to tokens, fp32
    scores and softmax, weights cast to v's dtype for PV. O(S^2): tests
    and small shapes only. mask (B, H, S/64, Sk/64) bool."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    sc = sc.reshape(b, h, s // BLOCK, BLOCK, sk // BLOCK, BLOCK)
    sc = sc.masked_fill(~mask[:, :, :, None, :, None], -1e30)
    p = torch.softmax(sc.reshape(b, h, s, sk), dim=-1)
    out = torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class NablaMask(NamedTuple):
    """One built adaptive mask and its kv lists (K6's input)."""

    mask: torch.Tensor     # (B, H, S/64, Sk/64) bool
    kv_inds: torch.Tensor  # (B, H, S/64, Sk/64) int32
    kv_nb: torch.Tensor    # (B, H, S/64) int32


_DENSITY_RECORDS: list = []


@contextlib.contextmanager
def record_density():
    """Collect the kept fraction of every mask built inside the block, as
    device scalars (no host sync until they are read)."""
    kept: list = []
    _DENSITY_RECORDS.append(kept)
    try:
        yield kept
    finally:
        _DENSITY_RECORDS.remove(kept)


def nabla_build_mask(q, k, sta, thr: float = 0.9,
                     groups: Sequence = ()) -> NablaMask:
    """The faithful adaptive mask of q, k and its kv lists. Inside
    :func:`record_density` the kept fraction of the whole mask is recorded:
    with ``groups`` (the rank groups over which the mask is cut: tp's
    heads, sp's rows; None or one-rank entries skipped) the kept and total
    block counts are summed over them first."""
    mask = nabla_block_mask(q, k, sta, thr=thr)
    kv_inds, kv_nb = block_mask_to_kv_lists(mask)
    if _DENSITY_RECORDS:
        counts = torch.stack([kv_nb.sum().double(),
                              kv_nb.new_tensor(mask.numel()).double()])
        for group in groups:
            if group is not None and group.size > 1:
                counts = group.all_reduce(counts)
        for kept in _DENSITY_RECORDS:
            kept.append(counts[0] / counts[1])
    return NablaMask(mask, kv_inds, kv_nb)


def nabla_attention(q, k, v, sta, thr: float = 0.9, q_rows: int = 1,
                    max_density: Optional[float] = None,
                    method: str = "sort", groups: Sequence = ()):
    """Full NABLA path: the adaptive mask of this call's q, k, then K6
    (its plain version for CPU tensors). q (B, S, H, D) and k, v (B, Sk, H,
    D) in fractal order, sta (S/64, Sk/64) bool: on a mesh a rank's query
    rows against the whole K/V, with its rows of the STA mask. ``groups``
    as :func:`nabla_build_mask` takes them. Raises on a non-faithful
    setting."""
    _check_faithful(q_rows, max_density, method)
    m = nabla_build_mask(q, k, sta, thr=thr, groups=groups)
    return sparse_attention(q, k, v, m.kv_inds, m.kv_nb)
