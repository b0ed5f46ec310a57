"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W)
and the least time the card could take for a piece of work.

Copied from the port's smoke script (``chip_smoke.py`` ``bound_ms``), so
that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, int8_ops: float = 0.0) -> float:
    """The larger of the operations' time (bf16 over the bf16 tensor-core
    peak plus int8 over the int8 peak) and the bytes' time over the memory
    rate, in seconds."""
    t_ops = flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS
    return max(t_ops, nbytes / PEAK_BYTES)
