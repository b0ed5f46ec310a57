"""Model offloading: host-memory staging between the pipeline's stages.

Counterpart of ``kandinsky5_tpu/utils/offload.py`` (the reference's
``--offload``): an offloaded module lives in host memory and is moved to the
card only for the stage that needs it (text encode -> denoise -> decode),
so one card need not hold the 7B text tower, the 2B DiT and the VAE at
once. The move is in place: an ``nn.Module`` goes through ``.to()`` and a
nested dict of tensors (the VAE's parameters) has its leaves replaced, so
every holder of the object sees where it is.
"""

from __future__ import annotations

import contextlib
import gc

import torch
from torch import nn


def _move(obj, device):
    if isinstance(obj, nn.Module):
        obj.to(device)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            if torch.is_tensor(v):
                obj[k] = v.to(device)
            else:
                _move(v, device)
    else:
        raise TypeError(f"cannot stage a {type(obj).__name__}")


class ParamStore:
    """Keeps ``params`` (a module or a nested dict of tensors) in host
    memory; :meth:`stage` moves them to ``device`` until :meth:`unstage`."""

    def __init__(self, params, device):
        self._params = params
        self.device = torch.device(device)
        self.staged = False
        _move(params, "cpu")

    def stage(self):
        if not self.staged:
            _move(self._params, self.device)
            self.staged = True
        return self._params

    def unstage(self) -> None:
        """Back to host memory, and the card's cache freed."""
        if self.staged:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _move(self._params, "cpu")
            self.staged = False
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


@contextlib.contextmanager
def staged(store: ParamStore):
    """``with staged(store) as params:`` the store's params on its device
    for the block, back in host memory after it."""
    try:
        yield store.stage()
    finally:
        store.unstage()
