"""Stage timing and device traces.

Counterpart of ``kandinsky5_tpu/utils/trace.py``:

  * :class:`StageTimer` sums wall seconds per named stage (text encode,
    denoise, decode, io). Given a CUDA device it synchronizes the device at
    each stage boundary, so a stage's seconds include the kernels it
    queued. The pipeline's ``timings`` are its stages.
  * :func:`profiled` traces a block with ``torch.profiler`` (host and, where
    there is one, the CUDA device) and writes a Chrome trace into the
    directory it is given; with no directory it does nothing. The CLI's
    ``--trace_dir`` traces its request with it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import torch


class StageTimer:
    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.stages: "OrderedDict[str, float]" = OrderedDict()

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def report(self) -> Dict[str, float]:
        return dict(self.stages)

    def __str__(self) -> str:
        total = sum(self.stages.values())
        parts = [f"{k}: {v:.2f}s" for k, v in self.stages.items()]
        return f"[{' | '.join(parts)} | total: {total:.2f}s]"


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiled(trace_dir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` and write
    ``trace_dir/trace.json`` (Chrome trace format); yields the profiler, or
    None when ``trace_dir`` is None and nothing is traced."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
