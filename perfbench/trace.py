"""Reduction of a ``torch.profiler`` trace of the measured window to device
seconds by kernel, by group and under named ranges, the device's busy time
and the idle gaps with what the host was doing in them.

``GROUPS``, ``busy_and_span`` and the device-time readers are copied from
the port's ``tools/profile_step.py`` (where later changes to the tool
cannot move them); the gap naming is the benchmark's own.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

# kernel-name substrings -> group (first match wins)
GROUPS = [
    ("K6 sparse_nabla", ("sparse_nabla_kernel",)),
    # K7 is flash_int8_kernel<MODE 0, MASK, LAG true>; K5 the rest
    ("K7 flash_int8_pipe", ("flash_int8_kernel<0, false, true>",
                            "flash_int8_kernel<0, true, true>")),
    ("K5 flash_int8", ("flash_int8_kernel",)),
    ("K1 flash_fixed", ("flash_fixed_kernel",)),
    ("K2 modulated FF (modulation pass, up, down)",
     ("ff_modulate_kernel", "ff_epi<0>", "ff_epi<1>")),
    ("K8 plain FF (up, down; T4's down)",
     ("ff_epi<2>", "ff_epi<3>", "ff_epi<4>")),
    ("K3 conv3d W8A8", ("conv3d_kernel<false, true>",
                        "conv3d_kernel<true, true>")),
    ("K3 conv3d fused GroupNorm + SiLU", ("conv3d_kernel<true, false>",)),
    ("K3 W8A8 window scales", ("window_rowmax_kernel", "window_scale_kernel")),
    ("K3 conv3d", ("conv3d_kernel",)),
    ("K4 flash_online", ("flash_online_kernel",)),
    ("int8 GEMM (torch._int_mm of the W8A8 linears)",
     ("imma", "s8s8", "_s8_", "i8i8", "int8")),
    ("library GEMM/conv (projections, 1x1, conv_in/out, dense cross)",
     ("gemm", "nvjet", "xmma", "cutlass", "sm90", "sm80", "fprop", "cublas")),
    ("sort / scan (NABLA mask: row sort, cumsum, kv-list sort; K4's tables)",
     ("sort", "scan")),
    ("elementwise / reduce / copy (norms, casts, gates, RoPE)",
     ("elementwise", "reduce", "copy", "pad", "cat", "index", "softmax",
      "memcpy", "memset", "fill", "scatter")),
]
ELEMENTWISE = GROUPS[-1][0]
# profiler rows that are host-side API calls or markers, not kernels
_NOT_KERNELS = ("Command Buffer Full", "cuLaunch", "cuda", "aten::",
                "nabla_mask.", "k4_plan", "pack_int8", "int8_linear",
                "bench.")


def _annotation(event) -> bool:
    """Whether a profiler row is a range's annotation on the device's
    stream (``gpu_user_annotation``) rather than a kernel or a copy."""
    return bool(getattr(event, "is_user_annotation", False))


def group_of(kernel: str) -> str:
    """The group of :data:`GROUPS` a kernel's profiler name falls under
    (its first match), else "other"."""
    key = kernel.lower()
    return next((g for g, pats in GROUPS if any(p in key for p in pats)),
                "other")


def busy_and_span(intervals) -> dict:
    """Device occupancy of one trace from its activities' (start, end)
    intervals: ``span`` from the first start to the last end, ``busy`` the
    length of the intervals' union, ``gaps`` the (start, end) of every hole
    in the union."""
    spans = sorted(intervals)
    if not spans:
        return {"span": 0.0, "busy": 0.0, "gaps": []}
    first, last = spans[0][0], max(e for _, e in spans)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return {"span": last - first, "busy": busy, "gaps": gaps}


class Trace:
    """The device side of one profiled window (times in seconds)."""

    def __init__(self, prof, window: str = "bench.window"):
        self.kernels: Dict[str, float] = {}
        self.ranges: Dict[str, float] = {}
        for e in prof.key_averages():
            sec = (getattr(e, "device_time_total", 0.0) or 0.0) / 1e6
            if sec <= 0:
                continue
            if e.key.startswith(_NOT_KERNELS):
                # a range has two rows: the host's, whose device time is
                # the sum of the kernels launched under it, and its
                # annotation on the device's stream, whose device time is
                # its span; only the host's is counted
                if e.device_type.name == "CPU":
                    self.ranges[e.key] = self.ranges.get(e.key, 0.0) + sec
            elif e.device_type.name == "CUDA" and not _annotation(e):
                self.kernels[e.key] = self.kernels.get(e.key, 0.0) + sec
        dev, host, span = [], [], None
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if t <= s:
                continue
            if e.device_type.name == "CUDA":
                if not (e.key.startswith(_NOT_KERNELS) or _annotation(e)):
                    dev.append((s, t))
            elif e.key == window:
                span = (s, t)
            else:
                host.append((s, t, e.key))
        if span is None:
            raise RuntimeError(f"the trace holds no {window!r} range")
        w0, w1 = span
        dev = [(max(s, w0), min(t, w1)) for s, t in dev if t > w0 and s < w1]
        self.window_s = (w1 - w0) / 1e6
        occ = busy_and_span(dev)
        self.busy_s = occ["busy"] / 1e6
        self.gaps = occ["gaps"]
        # the window's idle head and tail are gaps too
        if dev:
            first = min(s for s, _ in dev)
            last = max(t for _, t in dev)
            if first > w0:
                self.gaps.append((w0, first))
            if w1 > last:
                self.gaps.append((last, w1))
        else:
            self.gaps.append((w0, w1))
        self._host = sorted(host)

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(sec for k, sec in self.kernels.items()
                   if any(p in k for p in patterns))

    def range_s(self, prefix: str) -> float:
        """Device seconds of the kernels launched under the profiler ranges
        whose name starts with ``prefix``."""
        return sum(sec for k, sec in self.ranges.items()
                   if k.startswith(prefix))

    def group_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, sec in self.kernels.items():
            g = group_of(k)
            out[g] = out.get(g, 0.0) + sec
        return out

    def host_at(self, t_us: float) -> str:
        """The innermost host event (range, op or runtime call) running at
        ``t_us``, else "host idle"."""
        i = bisect.bisect_right(self._host, (t_us, float("inf"), ""))
        best = None
        for s, e, key in reversed(self._host[max(0, i - 4096):i]):
            if e >= t_us and (best is None or e - s < best[1] - best[0]):
                best = (s, e, key)
        return best[2] if best else "host idle"

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device groups that took most time and the ``n``
        longest idle gaps, each named by what the host was doing at its
        middle."""
        ops = sorted(self.group_s().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]
        named: List[Tuple[str, float]] = [
            [self.host_at((s + e) / 2), (e - s) / 1e6] for s, e in gaps]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
