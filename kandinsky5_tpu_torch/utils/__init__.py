"""Small helpers shared by the port's modules."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` when given, else the
    CUDA card. Without a CUDA device it raises, so a caller who wants the
    CPU plain versions says so (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the "
                           "CPU (the kernels' plain versions)")
    return torch.device("cuda")
