"""The profiling tool's occupancy arithmetic
(kandinsky5_tpu_torch/tools/profile_step.py): busy time, span and idle
share from one trace's device intervals. Exact on small integer cases."""

import math

import pytest

from types import SimpleNamespace

from kandinsky5_tpu_torch.tools.profile_step import (
    busy_and_span,
    device_times,
    group_of,
)


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


@pytest.mark.parametrize("kernel,group", [
    ("void (anonymous namespace)::flash_fixed_kernel<false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, unsigned char const*, float const*, "
     "__nv_bfloat16*, int, int, int)", "K1 flash_fixed"),
    ("void (anonymous namespace)::flash_fixed_kernel<true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, unsigned char const*, float const*, "
     "__nv_bfloat16*, int, int, int)", "K1 flash_fixed"),
    ("void (anonymous namespace)::conv3d_kernel<false, false>(CUtensorMap_st, "
     "(anonymous namespace)::ConvArgs)", "K3 conv3d"),
    ("void (anonymous namespace)::conv3d_kernel<true, false>(CUtensorMap_st, "
     "(anonymous namespace)::ConvArgs)", "K3 conv3d fused GroupNorm + SiLU"),
    ("void (anonymous namespace)::conv3d_kernel<false, true>(CUtensorMap_st, "
     "(anonymous namespace)::ConvArgs)", "K3 conv3d W8A8"),
    ("void (anonymous namespace)::conv3d_kernel<true, true>(CUtensorMap_st, "
     "(anonymous namespace)::ConvArgs)", "K3 conv3d W8A8"),
    ("void (anonymous namespace)::window_rowmax_kernel<true>(__nv_bfloat16 "
     "const*, float const*, float const*, float*, int, int, int, int, int, "
     "int)", "K3 W8A8 window scales"),
    ("(anonymous namespace)::flash_online_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, int const*, int const*, int const*, "
     "int const*, __nv_bfloat16*, int, int, int, int)", "K4 flash_online"),
    ("(anonymous namespace)::sparse_nabla_kernel(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, int const*, int const*, int const*, "
     "float const*, __nv_bfloat16*, int, int, int, int)", "K6 sparse_nabla"),
    ("void (anonymous namespace)::flash_int8_kernel<0>(signed char const*)",
     "K5 flash_int8"),
    ("void (anonymous namespace)::flash_int8_kernel<0, false, false>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "unsigned char const*, float const*, __nv_bfloat16*, int, int, int)",
     "K5 flash_int8"),
    ("void (anonymous namespace)::flash_int8_kernel<0, true, false>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "unsigned char const*, float const*, __nv_bfloat16*, int, int, int)",
     "K5 flash_int8"),
    ("void (anonymous namespace)::flash_int8_kernel<0, false, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "unsigned char const*, float const*, __nv_bfloat16*, int, int, int)",
     "K7 flash_int8_pipe"),
    ("void (anonymous namespace)::flash_int8_kernel<0, true, true>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "unsigned char const*, float const*, __nv_bfloat16*, int, int, int)",
     "K7 flash_int8_pipe"),
    ("(anonymous namespace)::ff_modulate_kernel(__nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int)",
     "K2 modulated FF (modulation pass, up, down)"),
    ("void k5::sm90::gemm_kernel<__nv_bfloat16, k5::sm90::Schedule<1, 4, 0, "
     "1, false>, (anonymous namespace)::ff_epi<0>>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::ff_epi<0>)",
     "K2 modulated FF (modulation pass, up, down)"),
    ("void k5::sm90::gemm_kernel<__nv_bfloat16, k5::sm90::Schedule<1, 4, 0, "
     "1, false>, (anonymous namespace)::ff_epi<1>>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::ff_epi<1>)",
     "K2 modulated FF (modulation pass, up, down)"),
    ("void k5::sm90::gemm_kernel<__nv_bfloat16, k5::sm90::Schedule<1, 4, 0, "
     "1, false>, (anonymous namespace)::ff_epi<2>>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::ff_epi<2>)",
     "K8 plain FF (up, down; T4's down)"),
    ("void k5::sm90::gemm_kernel<__nv_bfloat16, k5::sm90::Schedule<1, 4, 0, "
     "1, false>, (anonymous namespace)::ff_epi<3>>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::ff_epi<3>)",
     "K8 plain FF (up, down; T4's down)"),
    ("void k5::sm90::gemm_kernel<__nv_bfloat16, k5::sm90::Schedule<1, 4, 0, "
     "1, false>, (anonymous namespace)::ff_epi<4>>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::ff_epi<4>)",
     "K8 plain FF (up, down; T4's down)"),
    ("void at::native::elementwise_kernel<128, 2>()",
     "elementwise / reduce / copy (norms, casts, gates, RoPE)"),
    ("some_unlisted_kernel", "other"),
])
def test_group_of_files_kernels(kernel, group):
    """K1's wgmma kernel (both mask instances) is filed under K1's row,
    the int8 kernel's K5 and K7 instances (lag 0 and 1, each with and
    without a mask) under K5's and K7's,
    K3's wgmma kernel under its three groups by mode (plain, prologue, W8A8,
    beside the window scales), K4's and K6's wgmma kernels under theirs,
    and the FF's modulation pass and GEMM epilogues under K2 (modes 0, 1)
    or K8 (2-4; "gemm" in the name must not send them to the library
    group), not under another kernel's or a library group."""
    assert group_of(kernel) == group
