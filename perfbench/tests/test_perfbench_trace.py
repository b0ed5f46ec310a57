"""The reduction of a profile to kernel, range and busy seconds, on a made-up
profile shaped as ``torch.profiler`` gives it on the card."""

from types import SimpleNamespace

import pytest

from perfbench.trace import Trace


def _row(key, device, us, annotation=False, start=0.0, end=0.0):
    return SimpleNamespace(
        key=key, device_type=SimpleNamespace(name=device),
        device_time_total=us, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start, end=end))


class _Profile:
    """A range ``nabla_mask.sort`` launching two kernels (60 and 40 us)
    with a 40 us hole between them, inside the window: key_averages() has
    the range's host row (the kernels' sum) and its annotation on the
    device's stream (its span), as the card's profiles do; a second
    annotation of a range the reduction has no name for spans idle time."""

    def key_averages(self):
        return [
            _row("nabla_mask.sort", "CPU", 100.0, True),
            _row("nabla_mask.sort", "CUDA", 140.0, True),
            _row("other_range", "CUDA", 200.0, True),
            _row("radix_sort_kernel", "CUDA", 60.0),
            _row("scan_kernel", "CUDA", 40.0),
            _row("aten::sort", "CPU", 100.0),
        ]

    def events(self):
        return [
            _row("bench.window", "CPU", 0.0, True, 0.0, 1000.0),
            _row("nabla_mask.sort", "CPU", 0.0, True, 50.0, 120.0),
            _row("nabla_mask.sort", "CUDA", 0.0, True, 100.0, 240.0),
            _row("other_range", "CUDA", 0.0, True, 300.0, 500.0),
            _row("radix_sort_kernel", "CUDA", 0.0, False, 100.0, 160.0),
            _row("scan_kernel", "CUDA", 0.0, False, 200.0, 240.0),
        ]


def test_range_counts_its_kernels_once():
    tr = Trace(_Profile())
    assert tr.range_s("nabla_mask.") == pytest.approx(100e-6)
    assert set(tr.kernels) == {"radix_sort_kernel", "scan_kernel"}
    assert tr.kernel_s(["sort", "scan"]) == pytest.approx(100e-6)


def test_annotations_are_not_device_work():
    tr = Trace(_Profile())
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(100e-6)
    assert sum(e - s for s, e in tr.gaps) == pytest.approx(900.0)
