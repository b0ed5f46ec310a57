"""The profiling tool's occupancy arithmetic
(kandinsky5_tpu_torch/tools/profile_step.py): busy time, span and idle
share from one trace's device intervals. Exact on small integer cases."""

import math

import pytest

from kandinsky5_tpu_torch.tools.profile_step import busy_and_span


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
