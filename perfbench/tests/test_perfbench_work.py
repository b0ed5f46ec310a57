"""The operation and byte counts against hand counts, and the streaming
decode's schedule."""

import pytest

import perfbench_tiny  # noqa: F401  (puts the checkout on the path)

from perfbench.peaks import bound_s
from perfbench.work import (
    attention_dense,
    attention_sparse,
    chunks,
    decode_schedule,
    dit_step_flops,
    k3_bound_and_count,
    k4_bound_and_count,
    modulated_ff,
)


def test_kernel_bounds_match_the_records():
    """K1 at (1, 47616, 28, 64) 16.433 ms, K2 at (1, 47616, 1792) x 7168
    2.474 ms, K6 at 90 % kept of (1, 93696, 28, 64) 57.265 ms (PERF.md,
    the kernel table): all bound by the operations."""
    assert bound_s(*attention_dense(1, 47616, 47616, 47616, 28, 64)) * 1e3 \
        == pytest.approx(16.433, abs=5e-4)
    assert bound_s(*modulated_ff(47616, 1792, 7168)) * 1e3 \
        == pytest.approx(2.474, abs=5e-4)
    assert bound_s(*attention_sparse(1, 93696, 93696, 28, 64, 0.9)) * 1e3 \
        == pytest.approx(57.265, abs=5e-4)


def test_hand_counts():
    # 4 L^2 H d: QK^T and PV, a multiply and an add each
    assert attention_dense(1, 8, 8, 8, 2, 4).flops == 4 * 8 * 8 * 2 * 4
    assert attention_dense(1, 8, 8, 8, 2, 4).nbytes == 2 * 2 * 4 * 4 * 8
    assert modulated_ff(10, 4, 16).flops == 4 * 10 * 4 * 16
    assert attention_sparse(1, 128, 128, 1, 64, 0.5).flops \
        == 0.5 * 4 * 128 * 128 * 64


def test_dit_step_flops_is_the_sum_of_its_parts():
    dit = {"model_dim": 1792, "ff_dim": 7168, "time_dim": 512,
           "patch_size": [1, 2, 2], "in_visual_dim": 16,
           "out_visual_dim": 16, "visual_cond": True, "in_text_dim": 3584,
           "in_text_dim2": 768, "num_text_blocks": 2, "num_visual_blocks": 32}
    dense = dit_step_flops(dit, 47616, 256, 256, [1.0] * 32)
    # attention of the visual blocks at 47,616 tokens: 520 TFLOP
    attn = 32 * 4 * 47616 ** 2 * 1792
    assert 650e12 < dense < 670e12
    half = dit_step_flops(dit, 47616, 256, 256, [0.5] * 32)
    assert dense - half == pytest.approx(attn / 2, rel=1e-12)


def test_decode_schedule():
    """31 latent frames: chunks of 4, 3, ..., 121 frames out; 310 convs on
    the conv kernel and 10 mid attentions a decode."""
    assert chunks(31, 3) == [4] + [3] * 9
    ops = list(decode_schedule((1, 31, 64, 96, 16)))
    out = [op for op in ops if getattr(op, "cout", 0) == 3]
    assert sum(op.t_out for op in out) == 121
    assert all((op.h, op.w) == (512, 768) for op in out)
    assert k3_bound_and_count((1, 31, 64, 96, 16), bound_s)[1] == 310
    assert k4_bound_and_count((1, 31, 64, 96, 16), bound_s)[1] == 10
