"""The profiling tool's occupancy arithmetic
(kandinsky5_tpu_torch/tools/profile_step.py): busy time, span and idle
share from one trace's device intervals. Exact on small integer cases."""

import math

import pytest

from types import SimpleNamespace

from kandinsky5_tpu_torch.tools.profile_step import busy_and_span, device_times


@pytest.mark.parametrize("intervals,span,busy,summed", [
    ([(0, 10)], 10, 10, 10),
    ([(0, 10), (10, 30)], 30, 30, 30),
    ([(5, 10), (0, 2), (20, 25)], 25, 12, 12),
    ([(0, 10), (4, 8), (6, 14)], 14, 14, 22),
    ([(0, 4), (2, 6), (10, 12)], 12, 8, 10),
])
def test_busy_and_span(intervals, span, busy, summed):
    occ = busy_and_span(intervals)
    assert (occ["span"], occ["busy"], occ["summed"]) == (span, busy, summed)
    assert occ["idle"] == pytest.approx(1 - busy / span)
    assert 0.0 <= occ["idle"] < 1.0


def test_busy_and_span_empty_trace():
    occ = busy_and_span([])
    assert occ["busy"] == 0.0 and math.isnan(occ["idle"])


def test_device_times_skips_ranges_and_host_rows():
    """A record_function range's row carries its kernels' device time
    again; it must not count as a kernel (it once inflated the kernel
    total above the traced span)."""
    def row(key, ms, n=1):
        return SimpleNamespace(key=key, device_time_total=ms * 1e3, count=n,
                               device_type=SimpleNamespace(name="CUDA"))

    prof = SimpleNamespace(key_averages=lambda: [
        row("flash_int8_kernel<0>", 70.0), row("pack_int8", 5.0),
        row("int8_linear", 30.0, 8), row("nabla_mask.sort", 2.0),
        row("aten::mm", 9.0), row("void elementwise_kernel", 3.0, 4)])
    assert device_times(prof) == {"flash_int8_kernel<0>": (70.0, 1),
                                  "void elementwise_kernel": (3.0, 4)}
