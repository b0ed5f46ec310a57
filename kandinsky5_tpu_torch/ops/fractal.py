"""Fractal token order: every run of 64 visual tokens is one (1, 8, 8)
spatial tile of the latent grid, which is what the NABLA block mask
assumes.

Counterpart of ``kandinsky5_tpu/ops/fractal.py``. The order is a fixed
permutation of the token axis, computed once per grid on the host and
applied with ``index_select`` on the tensor's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PIXEL = 8  # tile side in latent tokens


@functools.lru_cache(maxsize=64)
def fractal_permutation(grid: Tuple[int, int, int]) -> np.ndarray:
    """perm[i] = row-major (T, H, W) index of the token at fractal
    position i: tiles outer, the 8x8 pixels of a tile inner."""
    t, h, w = grid
    if h % PIXEL or w % PIXEL:
        raise ValueError(f"latent grid {grid} not divisible by {PIXEL}-tile")
    idx = np.arange(t * h * w, dtype=np.int32).reshape(
        t, h // PIXEL, PIXEL, w // PIXEL, PIXEL)
    return idx.transpose(0, 1, 3, 2, 4).reshape(-1)


@functools.lru_cache(maxsize=64)
def fractal_inverse_permutation(grid: Tuple[int, int, int]) -> np.ndarray:
    return np.argsort(fractal_permutation(grid)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _index(grid: Tuple[int, int, int], inverse: bool,
           device: torch.device) -> torch.Tensor:
    perm = (fractal_inverse_permutation if inverse else fractal_permutation)(grid)
    return torch.from_numpy(perm.astype(np.int64)).to(device)


def fractal_flatten(x: torch.Tensor, grid: Tuple[int, int, int],
                    block_mask: bool = True) -> torch.Tensor:
    """x (B, S, ...) with S = T*H*W row-major -> fractal order (identity
    when ``block_mask`` is False)."""
    if not block_mask:
        return x
    return x.index_select(1, _index(tuple(grid), False, x.device))


def fractal_unflatten(x: torch.Tensor, grid: Tuple[int, int, int],
                      block_mask: bool = True) -> torch.Tensor:
    """The inverse of :func:`fractal_flatten`."""
    if not block_mask:
        return x
    return x.index_select(1, _index(tuple(grid), True, x.device))
