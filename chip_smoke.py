#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kandinsky5_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py [--seconds 1|5|10] [--out DIR]
    python3 chip_smoke.py --tp-seeds 6,7,8   # phase 5's tp forwards and
                                             # controls at other seeds only
    python3 chip_smoke.py --k1               # phase 2's K1 cases only
    python3 chip_smoke.py --k3               # phase 2's K3 cases only
    python3 chip_smoke.py --ff               # phase 2's K2, K8, T2-T4 cases
    python3 chip_smoke.py --gemm             # phase 2's T1, T2, K8, T3, T4
                                             # cases only
    python3 chip_smoke.py --k4 [--k6]        # phase 2's K4 (K6) cases only
    python3 chip_smoke.py --int8             # phase 2's K5, K7 and T5 cases
                                             # only

Phases, each of which must pass (any failure exits nonzero):
  1. build   — compile the hand-written kernels (csrc/*.cu, one nvcc per
               source in parallel, sm_90a) and print ptxas' register /
               shared-memory / spill report and its warnings of serialized
               wgmma;
  2. kernels — K1-K7 against their plain PyTorch versions on the card, in
               bf16, at the shapes the 5 s and 10 s paths give them (K2 at
               47,616, 10,752, 93,696, 1,536 and 256 rows and a batch of two
               whose row tiles straddle the items, with controls, each
               with its TFLOP/s, share of bound and the bf16 library
               chain's time, and its modulation pass alone within one bf16
               ulp; K1
               also at the tp = 2 and 4 ranks' shares of the 5 s shape's
               heads and on a ragged, batched, masked case, each with its
               achieved TFLOP/s and computed exp2 floor in the log; every
               decoder conv class for K3, plain and time_padded; K3's
               GroupNorm-fold + SiLU prologue at 128, 256 and 512 channels
               and with carried prefix planes; K3's W8A8 mode plain and with
               the prologue over several TPU W tiles, with a control that
               one scale for the whole tensor fails, and its window-max
               reduction; K3 on ragged tiles (H, W not multiples of its
               8 x 16 tile, one output frame, every plane carried, a batch
               of two), each with a control that must fail; every K3 case
               with its TFLOP/s (TOP/s), share of bound and cuDNN's time; K4
               at the smoke's headline chunk, the 1 s stream decode's two
               chunks and a tiled decode's tile, each with its TFLOP/s,
               share of bound, K/V rate through L2 and SDPA's time; K6 at
               the 10 s shape under four masks: STA only, ~15 %, ~35 % and
               ~90 % kept, beside flex_attention; K5 and K7 at K1's four main-path
               shapes on one shared pack_int8 call, K7 bit-equal to K5,
               K5's error against K1 printed as the quantization error), the
               tools kernels T5 (its four modes at the 5 s shape) and T1 (int8
               exact, bf16, at 8192^3, the DiT's projection shapes and two
               ragged shapes, with a control: the last k step left out), K8
               at each tensor-parallel rank's share of the 5 s FF (tp 1, 2,
               4) and the tools kernels T2-T4 at their tool's shapes (T2
               also ragged), each GEMM with its share of bound and its
               factor against its library call,
               with max-abs and relative-L2 errors against stated
               tolerances, CUDA-event times of kernel, plain version and
               (where one PyTorch call computes the same function) that
               call, and each case's bound (bytes, or bf16 and int8
               operations over the card's peak rates);
  3. reference — a cut-depth, full-width DiT (dense; NABLA on a
               (1,4,64,96) latent; int8, i.e. flash_int8 attention and W8A8
               projections, on a (1,2,48,64) latent, launching K5 4 times)
               and the full-width VAE decode on a small input (streaming,
               its first chunk large enough for K4; and tiled over 2
               temporal x 2 x 2 spatial tiles, fused, in bf16 and with int8
               convs), on the card (kernels) against the same weights in
               fp32 on the CPU (plain versions);
  4. pipeline — ``Kandinsky5T2VPipeline`` with the full 2B DiT (uniform
               +-0.02 weights from a seed), the full VAE decoder and a
               seeded stand-in text embedder, 16 steps per request. The 5 s
               path (config_5s_distil.yaml) answers a 512x768 image and a
               video of ``--seconds`` 1 or 5 (1 s = 25 frames by default);
               every kernel of it must launch. The 10 s path
               (config_10s_distil.yaml, NABLA) answers a 2 s video (49
               frames, 19,968 tokens), or the 241-frame shape with
               ``--seconds 10``; it must launch K6 exactly 32 x 16 times and
               K1 exactly 2 x 16 times (the text blocks). The 5 s int8
               path answers two videos of the 5 s path's length with the
               bf16 video's prompt and seed: (a) attn_impl "flash_int8",
               K5 exactly (2 + 32) x 16 launches and K1 none; (b)
               "flash_int8_pipe" with W8A8 projections, K7 544, K5, K1 and
               K2 none (the W8A8 visual FFs and the 256-row text FFs run
               the chain, as in the JAX package); each frame PSNR against
               the bf16 video is printed (random weights: not gated). Then
               the decodes: the 5 s path video's latents tiled (2 temporal
               tiles at 1 s), with int8 convs streamed and tiled (PSNR
               against the bf16 decode of the same mode, not gated), a
               17-frame 1024x1024 decode (2 x 2 spatial tiles) and, with
               ``--seconds 10``, the 241-frame latents tiled with their PSNR
               against the streaming decode; each with exact K3 (by mode)
               and K4 launch counts. Each path's launch counts are reset
               just before it and read just after;
  5. tensor parallelism — ranks sharing the one card over gloo (CUDA
               tensors staged through the host; the kernels are built
               before any rank starts): one DiT forward at full width and
               depth at the 5 s shape (47,616 tokens, seeded +-0.02
               weights, each rank drawing its share one parameter at a
               time) on one device, then as tp = 2 and tp = 4, each rank
               held against it (TP_BOUND, relative L2) with exact launch
               counts (K8 32, K1 34, K2 0); two controls must fail the
               bound (each rank keeps its FF partial sum; the out layers'
               bias added on every rank). Then the tp = 2 pipeline answers
               the 5 s path's image and video requests with 16 steps, rank 0
               decoding tiled and writing; s/step, the all-reduce share
               (gloo through the host, 2 ranks on one card, not a
               multi-GPU number) and the video's PSNR against phase 4's
               tiled decode of the same request. A failed rank fails the
               run.
The last two stdout lines are the kernels' JSON summary, then
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import zlib

ROUTE_SOURCES = {
    "K1_flash_fixed": ("kandinsky5_tpu_torch/csrc/flash_fixed.cu",
                       "kandinsky5_tpu/ops/flash_pallas.py:157 _kernel_fixed"),
    "K2_ff_mod": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
                  "kandinsky5_tpu/ops/ff_pallas.py:69 _ff_mod_kernel"),
    "K3_conv3d": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                  "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel"),
    "K3_conv3d_fused": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                        "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                        "(fuse/act, prefix :163-182)"),
    "K3_conv3d_quant": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                        "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                        "(quant :183-230)"),
    "K3_quant_windows": ("kandinsky5_tpu_torch/csrc/conv3d.cu",
                         "kandinsky5_tpu/ops/conv_pallas.py:126 _kernel "
                         "(quant scale :183-198)"),
    "K4_flash_online": ("kandinsky5_tpu_torch/csrc/flash_online.cu",
                        "kandinsky5_tpu/ops/flash_pallas.py:477 _kernel_online"),
    "K5_flash_int8": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                      "kandinsky5_tpu/ops/flash_pallas.py:267 _kernel_fixed_i8"),
    "K6_sparse_nabla": ("kandinsky5_tpu_torch/csrc/sparse_nabla.cu",
                        "kandinsky5_tpu/ops/sparse_pallas.py:67 _kernel"),
    "K7_flash_int8_pipe": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                           "kandinsky5_tpu/ops/flash_pallas.py:390 "
                           "_kernel_fixed_i8_pipe"),
    "T1_gemm_i8": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                   "tools/bench_int8mm.py:22 _mm_kernel"),
    "T1_gemm_bf16": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                     "tools/bench_int8mm.py:22 _mm_kernel"),
    "K8_ff": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
              "kandinsky5_tpu/ops/ff_pallas.py:49 _ff_kernel"),
    "T2_gemm": ("kandinsky5_tpu_torch/csrc/gemm_i8.cu",
                "tools/bench_pallas_gemm.py:43 _gemm_kernel"),
    "T3_ff": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
              "tools/bench_pallas_gemm.py:88 _ff_kernel"),
    "T4_ff_tiled": ("kandinsky5_tpu_torch/csrc/ff_mod.cu",
                    "tools/bench_pallas_gemm.py:128 _ff_tiled_kernel"),
    "T5_i8_decomp": ("kandinsky5_tpu_torch/csrc/flash_int8.cu",
                     "tools/bench_i8_decomp.py:37 _kernel"),
}
# the tools kernels run in phase 2 only: no path of the system launches them
TOOLS = ("T1_gemm_i8", "T1_gemm_bf16", "T2_gemm", "T3_ff", "T4_ff_tiled",
         "T5_i8_decomp")
# bf16 kernel vs plain on the card: both round the same quantities to bf16
# but sum in different orders, so an output may move by a bf16 ulp (2^-8
# relative); bounds are a few ulps at the outputs' scale. The attention
# checks carry a control: uniform weights over the allowed keys (q = 0 in
# the plain version) must fail the same bound, or the inputs are too weak
# to tell a right kernel from one that ignores its scores.
# K5/K7 and their plain version share the packed inputs and differ only in
# exp2's last bits and the order of sums, so K1's bounds hold. T1's int8
# instance must equal the exact product. T5's outputs are garbage of any
# scale: its max-abs bound is relative to the plain output's largest value.
# K3's W8A8 mode and its plain version take the same codes (the prologue and
# the scales are the same fp32 operations on the card), sum them exactly and
# dequantize alike: equal, but for codes flipped where a transformed value
# lies within an ulp of a rounding (``_flips_only``); the window scales must
# equal their plain version exactly.
TOL = {"K1_flash_fixed": (3e-2, 1e-2), "K2_ff_mod": (6e-2, 1e-2),
       "K2_modulate": (0.0, 0.0),
       "K3_conv3d": (6e-2, 1e-2), "K3_conv3d_fused": (6e-2, 1e-2),
       "K3_conv3d_quant": (0.0, 0.0), "K3_quant_windows": (0.0, 0.0),
       "K4_flash_online": (3e-2, 1e-2),
       "K5_flash_int8": (3e-2, 1e-2), "K6_sparse_nabla": (3e-2, 1e-2),
       "K7_flash_int8_pipe": (3e-2, 1e-2), "K8_ff": (6e-2, 1e-2),
       "T1_gemm_i8": (0.0, 0.0), "T1_gemm_bf16": (6e-2, 1e-2),
       "T2_gemm": (6e-2, 1e-2), "T3_ff": (6e-2, 1e-2),
       "T4_ff_tiled": (6e-2, 1e-2), "T5_i8_decomp": (1e-2, 1e-2)}
# published dense peaks of one H100 SXM (700 W): bf16 and int8 tensor cores
# and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
CONF5 = "config_5s_distil.yaml"
CONF10 = "config_10s_distil.yaml"
# the case of each kernel that its JSON entry reports (K3_conv3d: the last
# decoder class, 128->128 12x512x768 time_padded, before the ragged cases)
HEADLINE = {"K1_flash_fixed": 0, "K2_ff_mod": 0, "K3_conv3d": 15,
            "K3_conv3d_fused": 0, "K3_conv3d_quant": 1, "K3_quant_windows": 0,
            "K4_flash_online": 0, "K5_flash_int8": 0, "K6_sparse_nabla": 1,
            "K7_flash_int8_pipe": 0, "K8_ff": 1, "T1_gemm_i8": 0,
            "T1_gemm_bf16": 0, "T2_gemm": 0, "T3_ff": 0, "T4_ff_tiled": 0,
            "T5_i8_decomp": 0}
# the prompt of the 5 s path's bf16 video and of both int8 videos
VIDEO_PROMPT = "a smoke-test video"


class Failure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _errors(out, ref):
    import torch

    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        return float("inf"), float("inf")
    return ((o - r).abs().max().item(),
            ((o - r).norm() / r.norm().clamp_min(1e-30)).item())


def bound_ms(flops: float, nbytes: float, int8_ops: float = 0.0):
    """The least time the card could take: the larger of the operations
    (bf16 ones over the bf16 tensor-core peak plus int8 ones over the int8
    peak) and the bytes over the memory rate."""
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _compare(name, shape, kernel_fn, plain_fn, results, work, reps=5,
             control_fn=None, library_fn=None, info=None, yardstick_fn=None,
             check=None, control_label=None,
             yardstick_label="bf16 SDPA: not the same function",
             check_label="flips only"):
    """Check ``kernel_fn`` against ``plain_fn`` and time both (and
    ``library_fn``, one PyTorch call computing the same function, if
    given; ``yardstick_fn``, a call that computes a different function,
    is timed and labelled ``yardstick_label``). ``work`` = (bf16 flops,
    bytes[, int8 ops]) of the call for its bound. ``check(out, ref)`` ->
    bool replaces the tolerance test (the control must fail it too;
    ``check_label`` names it in the log)."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    torch.cuda.synchronize()
    max_abs, rel = _errors(out, ref)
    atol, rtol = TOL[name]
    if check is not None:
        ok = check(out, ref)
    elif name in ("T1_gemm_i8", "K3_quant_windows"):
        ok = bool(torch.equal(out, ref))
    else:
        if name == "T5_i8_decomp":
            info = dict(info or {}, scale=ref.float().abs().max().item())
            atol *= info["scale"]
        ok = max_abs <= atol and rel <= rtol
    note = ""
    if control_fn is not None:
        control = control_fn()
        c_abs, c_rel = _errors(control, ref)
        if check is not None:
            control_fails = not check(out, control)
            label = control_label or "one scale for the whole tensor"
        else:
            control_fails = not (c_abs <= atol and c_rel <= rtol)
            label = control_label or "uniform weights"
        note = (f" control ({label}): max_abs {c_abs:.3e} rel_l2 "
                f"{c_rel:.3e} {'fails the bound' if control_fails else 'PASSES'}")
        del control
        ok = ok and control_fails
    del out, ref
    ms = _time_ms(kernel_fn, reps)
    plain_ms = _time_ms(plain_fn, 1)
    lib_ms = yard_ms = None
    if library_fn is not None:
        library_fn()
        lib_ms = _time_ms(library_fn, reps)
    if yardstick_fn is not None:
        yardstick_fn()
        yard_ms = _time_ms(yardstick_fn, reps)
    b_ms, b_by = bound_ms(*work)
    lib_note = "" if lib_ms is None else f" library {lib_ms:.3f} ms"
    if yard_ms is not None:
        lib_note += f" yardstick {yard_ms:.3f} ms ({yardstick_label})"
    tol_note = (check_label if check is not None else "exact"
                if name in ("T1_gemm_i8", "K3_quant_windows")
                else f"tol {atol:.3g}")
    log(f"  {name} {shape}: max_abs {max_abs:.3e} ({tol_note}) rel_l2 "
        f"{rel:.3e} (tol {rtol}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
        f"{lib_note} bound {b_ms:.3f} ms ({b_by}){note} "
        f"{'ok' if ok else 'FAIL'}")
    results.setdefault(name, []).append(dict(
        shape=shape, max_abs=max_abs, rel=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, yardstick_ms=yard_ms,
        yardstick=yardstick_label if yard_ms is not None else None, ok=ok,
        **(info or {})))
    torch.cuda.empty_cache()


def _sdpa(q, k, v, attn_mask=None):
    """scaled_dot_product_attention on (B, L, H, D) inputs, transposed to
    its (B, H, L, D) layout before the timed call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=attn_mask)


def _max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def _clock_under(fn, seconds: float = 2.0) -> str:
    """Run ``fn`` back to back for about ``seconds`` while ``nvidia-smi``
    samples the SM clock and the power draw every 100 ms; their medians."""
    import subprocess

    import torch

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.strip()][2:]  # the first samples precede the load
    if not rows:
        return "clock not sampled"
    mid = len(rows) // 2
    clk = sorted(r[0] for r in rows)[mid]
    watts = sorted(r[1] for r in rows)[mid]
    return f"SM clock {clk:.0f} MHz, {watts:.1f} W (medians of {len(rows)} samples)"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _seeded(dev):
    """Phase 2's generator and its maker of bf16 rows of unit RMS."""
    import torch

    g = torch.Generator(device=dev).manual_seed(1234)

    def normed(shape):
        x = torch.randn(shape, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    return g, normed


def phase_k1(dev, g, normed, results):
    """K1 at visual self-attention's 5 s, 1 s and image sizes (47,616,
    10,752 and 1,536 tokens), text self-attention (256 tokens, 77 valid),
    the 5 s shape at the tp = 2 and 4 ranks' shares of the heads, and a
    ragged, batched case (Lq 1000, Lk 700, a valid length per batch). The
    log gives, beside the tensor-core bound, the achieved rate and an exp2
    floor that is computed, not measured: one exp2 per (query, valid key)
    at an assumed 16 per clock per SM (the special-function units' rate on
    sm_90) at the card's highest SM clock; and the SM clock and power under
    a steady run of the first case."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_fixed, flash_fixed_plain

    exp2_rate = 16 * torch.cuda.get_device_properties(dev).multi_processor_count \
        * _max_sm_clock_hz()
    for b, lq, lk, h, valid in ((1, 47616, 47616, 28, None),
                                (1, 10752, 10752, 28, None),
                                (1, 1536, 1536, 28, None),
                                (1, 256, 256, 28, (77,)),
                                (1, 47616, 47616, 14, None),
                                (1, 47616, 47616, 7, None),
                                (2, 1000, 700, 3, (466, 140))):
        q, k = normed((b, lq, h, 64)), normed((b, lk, h, 64))
        v = torch.randn((b, lk, h, 64), generator=g, device=dev).bfloat16()
        mask = None
        if valid is not None:
            mask = torch.arange(lk, device=dev)[None] \
                < torch.tensor(valid, device=dev)[:, None]
        n_keys = lk * b if valid is None else sum(valid)
        shape = (f"({b},{lq},{h},64)" if lq == lk else
                 f"({b},{lq}/{lk},{h},64)") + (" mask" if valid else "")
        _compare("K1_flash_fixed", shape,
                 lambda: flash_fixed(q, k, v, mask),
                 lambda: flash_fixed_plain(q, k, v, mask), results,
                 work=(4.0 * lq * n_keys * h * 64,
                       _nbytes(q, k, v, q, mask)),
                 reps=3 if lq > 10000 else 20,
                 control_fn=lambda: flash_fixed_plain(q * 0, k, v, mask),
                 library_fn=_sdpa(q, k, v, None if mask is None
                                  else mask[:, None, None, :]))
        r = results["K1_flash_fixed"][-1]
        r["tflops"] = 4.0 * lq * n_keys * h * 64 / r["ms"] / 1e9
        exp2_floor = lq * n_keys * h / exp2_rate * 1e3
        log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of the tensor-core bound); exp2 floor {exp2_floor:.3f} ms "
            f"at the highest SM clock ({100 * exp2_floor / r['ms']:.1f} %); "
            f"{r['ms'] / r['library_ms']:.2f}x SDPA")
        if len(results["K1_flash_fixed"]) == 1:
            log("    under a steady run of K1: "
                + _clock_under(lambda: flash_fixed(q, k, v, mask)))
        del q, k, v


def k4_tiles_read(lq, lk, mask, q_ids, kv_ids) -> int:
    """The 32-key K/V tiles K4's blocks read in one call (B = H = 1), from
    the wrapper's own tables: a block reads its live tiles, less the fully
    masked ones where it may skip them."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import online_plan

    _, plan, nxt = online_plan(1, lq, lk, mask, q_ids, kv_ids,
                               q_ids.device)
    n_live, skip = plan[0, :, 0].long(), plan[0, :, 1].bool()
    if nxt is None:
        return int(n_live.sum())
    nt = nxt.shape[1] - 1
    valid = nxt[0, :nt] == torch.arange(nt, device=nxt.device)
    before = torch.cat([valid.new_zeros(1, dtype=torch.long),
                        valid.long().cumsum(0)])
    return int(torch.where(skip, before[n_live], n_live).sum())


def phase_k4(dev, g, results):
    """K4 at the VAE mid block's shapes (one head of 512, 64x96 latent
    frames of 6,144 tokens): the smoke's headline chunk (4 frames against
    4 carried + 4, 2 of the 4 carried slots valid), the 1 s stream
    decode's two chunks (4 frames with nothing carried yet; 3 frames after
    a full buffer), and a tiled decode's tile (5 frames, q = kv, no mask).
    Each logs its TFLOP/s over the allowed (query, key) pairs, its share
    of the tensor-core bound and SDPA's time in the same run (SDPA with
    the same boolean mask: the same function but for the weights' bf16
    rounding and a row with no allowed key). Unit q and k give scores of
    standard deviation 1 (spread over several units across the keys), so
    the weights are far from uniform."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_online, flash_online_plain

    s = 6144
    for t, past, filled in ((4, 4, 2), (4, 4, 0), (3, 4, 4), (5, 0, 0)):
        q = torch.randn((1, t * s, 1, 512), generator=g, device=dev).bfloat16()
        k = torch.randn((1, (past + t) * s, 1, 512), generator=g,
                        device=dev).bfloat16()
        v = torch.randn((1, (past + t) * s, 1, 512), generator=g,
                        device=dev).bfloat16()
        slot = torch.arange(past, device=dev)
        kv_ids = torch.cat([slot.repeat_interleave(s), (past + torch.arange(
            t, device=dev)).repeat_interleave(s)])[None]
        q_ids = kv_ids[:, past * s:]
        mask = None
        if past:
            mask = torch.cat([(slot >= past - filled).repeat_interleave(s),
                              torch.ones(t * s, dtype=torch.bool,
                                         device=dev)])[None]
        # the (query, key) pairs the ids and the mask allow: the work K4
        # does and the library call's boolean mask
        allowed = q_ids[0, :, None] >= kv_ids[0, None, :]
        if mask is not None:
            allowed &= mask[0, None, :]
        pairs = int(allowed.sum())
        label = (f"q {t * s} kv {(past + t) * s} d 512"
                 + (f", {filled} of {past} carried valid" if past
                    else ", tiled tile (q = kv)"))
        _compare("K4_flash_online", label,
                 lambda: flash_online(q, k, v, mask, q_ids, kv_ids),
                 lambda: flash_online_plain(q, k, v, mask, q_ids, kv_ids),
                 results,
                 work=(4.0 * pairs * 512,
                       _nbytes(q, k, v, q, mask, q_ids, kv_ids)),
                 control_fn=lambda: flash_online_plain(q * 0, k, v, mask,
                                                       q_ids, kv_ids),
                 library_fn=_sdpa(q, k, v, allowed[None, None]))
        r = results["K4_flash_online"][-1]
        r["tflops"] = 4.0 * pairs * 512 / r["ms"] / 1e9
        r["kv_gb"] = k4_tiles_read(q.shape[1], k.shape[1], mask, q_ids,
                                   kv_ids) * 2 * 32 * 1024 / 1e9
        log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of the tensor-core bound); {r['ms'] / r['library_ms']:.2f}x "
            f"SDPA; K/V tiles read {r['kv_gb']:.2f} GB, "
            f"{r['kv_gb'] / r['ms']:.2f} TB/s through L2")
        if len(results["K4_flash_online"]) == 1:
            log("    under a steady run of K4: " + _clock_under(
                lambda: flash_online(q, k, v, mask, q_ids, kv_ids)))
        del q, k, v, allowed
    torch.cuda.empty_cache()


def _rate(results, name, ops: float, against: str = "the bf16 chain"):
    """Log the last case's rate (TFLOP/s, or TOP/s for int8), its share of
    the bound and its time against ``against``, the library call or
    yardstick timed beside it (the bf16 chain for K8, K2 and T3-T4;
    ``_int_mm`` or bf16 ``matmul`` for T1 and T2)."""
    r = results[name][-1]
    r["tflops"] = ops / r["ms"] / 1e9
    r["bound_share"] = r["bound_ms"] / r["ms"]
    lib = r["library_ms"] or r["yardstick_ms"]
    r["factor"] = r["ms"] / lib
    unit = "TOP/s" if name == "T1_gemm_i8" else "TFLOP/s"
    log(f"    {r['tflops']:.1f} {unit} ({100 * r['bound_share']:.1f} % of the "
        f"bound); {against} {lib:.3f} ms, kernel {r['factor']:.2f}x")


def _k2_chain(x, sc, sh, w1, w2, gt):
    """K2's yardstick, timed only: the bf16 library chain F.layer_norm ->
    modulation -> matmul -> GELU -> matmul -> gated residual (no single
    PyTorch call computes K2)."""
    import torch
    import torch.nn.functional as F

    d = x.shape[-1]
    s1, s0, g1 = ((v[:, None] + a).bfloat16() for v, a in ((sc, 1.0),
                                                           (sh, 0.0),
                                                           (gt, 0.0)))
    w1t, w2t = w1.t(), w2.t()
    return lambda: x + g1 * torch.matmul(F.gelu(torch.matmul(
        F.layer_norm(x, (d,), eps=1e-5) * s1 + s0, w1t)), w2t)


def _within_ulp(out, ref) -> bool:
    """Every bf16 output within one bf16 ulp of the plain one, or 2^-20
    where the shift cancels the normed term to near zero."""
    import torch

    _, e = torch.frexp(ref.float())
    bound = torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                        e - 8).clamp_min(2.0 ** -20)
    return bool(((out.float() - ref.float()).abs() <= bound).all())


def phase_k2(dev, g, results):
    """K2 at the visual blocks' 5 s, 10 s and 1 s shapes (47,616, 93,696
    and 10,752 rows), the image (1,536) and the text blocks (256), and a
    batch of two whose L (1,000) is not a multiple of the 128-row tile, so
    a tile holds rows of both items. Controls: the FF term left out (out =
    x), and at B = 2 the items' gates swapped; each must fail the bound.
    Each case logs its TFLOP/s, share of bound and the bf16 chain's time;
    then the modulation pass alone on 47,616 rows in two items, each output
    within one bf16 ulp of the plain version's (its control: the other
    item's scale)."""
    import torch

    from kandinsky5_tpu_torch.ops.ff import (
        ff_mod_plain,
        fused_ff_modulated,
        modulate,
        modulate_plain,
    )

    d, ff = 1792, 7168
    w1 = (torch.randn((ff, d), generator=g, device=dev) / math.sqrt(d)).bfloat16()
    w2 = (torch.randn((d, ff), generator=g, device=dev) / math.sqrt(ff)).bfloat16()
    for b, l in ((1, 47616), (1, 10752), (1, 256), (1, 1536), (2, 1000),
                 (1, 93696)):
        sc, sh, gt = (torch.randn((b, d), generator=g, device=dev) * 0.1
                      for _ in range(3))
        x = torch.randn((b, l, d), generator=g, device=dev).bfloat16()
        if b == 2:
            control, label = (lambda: ff_mod_plain(x, sc, sh, w1, w2,
                                                   gt.flip(0)),
                              "the two items' gates swapped")
        else:
            control, label = (lambda: x, "the FF term left out (out = x)")
        flops = 4.0 * b * l * d * ff
        _compare("K2_ff_mod", f"({b},{l},{d})x{ff}",
                 lambda: fused_ff_modulated(x, sc, sh, w1, w2, gt),
                 lambda: ff_mod_plain(x, sc, sh, w1, w2, gt), results,
                 work=(flops, _nbytes(x, x, w1, w2, sc, sh, gt)),
                 control_fn=control, control_label=label,
                 yardstick_fn=_k2_chain(x, sc, sh, w1, w2, gt),
                 yardstick_label="the bf16 chain LN -> modulation -> matmul "
                 "-> GELU -> matmul -> gate: no single call")
        _rate(results, "K2_ff_mod", flops)
        del x
    del w1, w2
    x = torch.randn((2, 23808, d), generator=g, device=dev).bfloat16()
    sc, sh = (torch.randn((2, d), generator=g, device=dev) * 0.1
              for _ in range(2))
    _compare("K2_modulate", f"(2,23808,{d})",
             lambda: modulate(x, sc, sh), lambda: modulate_plain(x, sc, sh),
             results, work=(0.0, _nbytes(x, x, sc, sh)), check=_within_ulp,
             check_label="one bf16 ulp",
             control_fn=lambda: modulate_plain(x, sc.flip(0), sh),
             control_label="the other item's scale")
    del x
    torch.cuda.empty_cache()


def phase_kernels(dev, results):
    g, normed = _seeded(dev)
    phase_k1(dev, g, normed, results)
    phase_k2(dev, g, results)
    phase_k3(dev, g, results)
    phase_k4(dev, g, results)
    phase_k6(dev, g, normed, results)
    phase_int8(dev, g, normed, results)
    phase_gemm(dev, g, results)
    bad = [(n, r["shape"]) for n, rs in results.items() for r in rs if not r["ok"]]
    if bad:
        raise Failure(f"kernels outside tolerance: {bad}")


def _cudnn_conv(x, wt, bias, time_padded: bool):
    """cuDNN's conv3d on ``x`` padded beforehand (replicate), channels-last
    like K3's input: the library call timed beside K3."""
    import torch
    import torch.nn.functional as F

    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1, 0 if time_padded else 2, 0),
               mode="replicate")
    xp = xp.contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv3d(xp, wt, bias)


def _k3_rate(results, name, macs: float, int8: bool = False):
    """Log the last K3 case's rate, its share of the bound and its time
    against cuDNN's conv3d in the same run (bf16 cuDNN beside W8A8: not the
    same function)."""
    r = results[name][-1]
    r["tflops"] = 2.0 * macs / r["ms"] / 1e9
    lib = r["library_ms"] or r["yardstick_ms"]
    log(f"    {r['tflops']:.1f} {'TOP/s' if int8 else 'TFLOP/s'} "
        f"({100 * r['bound_ms'] / r['ms']:.1f} % of the bound); cuDNN"
        f"{' bf16' if int8 else ''} {lib:.3f} ms, kernel {r['ms'] / lib:.2f}x")


def _k3_zero_padded(x, wt, bias, time_padded: bool, rows_cols: bool = True):
    """Control for K3's edges: the plain conv with zeros where the kernel
    replicates (the edge rows and columns, or the two leading frames)."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3).float()
    if rows_cols:
        xc = F.pad(xc, (0, 0, 0, 0, 0 if time_padded else 2, 0), mode="replicate")
        y = F.conv3d(xc, wt.float(), bias.float(), padding=(0, 1, 1))
    else:
        xc = F.pad(xc, (1, 1, 1, 1, 0, 0), mode="replicate")
        y = F.conv3d(xc, wt.float(), bias.float(), padding=(0 if time_padded else 2, 0, 0))
        y = y[:, :, :x.shape[1] - (2 if time_padded else 0)]
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def phase_k3(dev, g, results):
    """K3 (``csrc/conv3d.cu``) at every decoder conv class (vae.py:336-385)
    at the streaming decode's chunk lengths, unpadded and ``time_padded``;
    its other modes (:func:`phase_k3_modes`); and ragged cases that the
    kernel's 8 x 16 output tile must mask, each with a control that must
    fail the bound: H and W that are not multiples of the tile (control:
    zeros in place of the replicated edges), one output frame (control:
    zeros in place of the two replicated leading frames), the prologue with
    every input plane carried (control: every plane transformed) and a
    batch of two (control: the items swapped). The library call is cuDNN's
    conv3d on an input padded (and transformed) beforehand."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    def weights(cin, cout):
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        return wt, torch.randn((cout,), generator=g, device=dev).bfloat16()

    classes = [(512, 512, 64, 96, 4), (512, 512, 128, 192, 7),
               (512, 512, 256, 384, 13), (512, 256, 256, 384, 13),
               (256, 256, 256, 384, 13), (256, 256, 512, 768, 12),
               (256, 128, 512, 768, 12), (128, 128, 512, 768, 12)]
    for cin, cout, hh, ww, t in classes:
        wt, bias = weights(cin, cout)
        for padded in (False, True):
            tin = t + 2 if padded else t
            x = torch.randn((1, tin, hh, ww, cin), generator=g,
                            device=dev).bfloat16()
            macs = 27.0 * t * hh * ww * cin * cout
            _compare("K3_conv3d",
                     f"{cin}->{cout} {t}x{hh}x{ww}"
                     f"{' time_padded' if padded else ''}",
                     lambda: conv_mod.causal_conv3d_fused(x, wt, bias, padded),
                     lambda: conv_mod.conv3d_plain(x, wt, bias, padded), results,
                     work=(2.0 * macs, _nbytes(x, wt, bias) + 2 * t * hh * ww * cout),
                     reps=2, library_fn=_cudnn_conv(x, wt, bias, padded))
            _k3_rate(results, "K3_conv3d", macs)
            del x

    phase_k3_modes(dev, g, results)

    def ragged(name, b, cin, cout, t, hh, ww, padded, control, label,
               prefix=None):
        """One ragged case; with ``prefix``, the prologue (SiLU) with that
        many carried planes."""
        wt, bias = weights(cin, cout)
        x = torch.randn((b, t, hh, ww, cin), generator=g, device=dev).bfloat16()
        t_out = t - 2 if padded else t
        macs = 27.0 * b * t_out * hh * ww * cin * cout
        kw, xt = {}, x
        if prefix is not None:
            kw = dict(scale=1 + 0.2 * torch.randn((cin,), generator=g, device=dev),
                      shift=0.1 * torch.randn((cin,), generator=g, device=dev),
                      act=True, prefix_planes=prefix)
            xt = conv_mod.conv_prologue(x, kw["scale"], kw["shift"], True, prefix)
        _compare(name, f"{b}x {cin}->{cout} {t_out}x{hh}x{ww}"
                 f"{' time_padded' if padded else ''} ragged ({label})",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, padded, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, padded, **kw), results,
                 work=(2.0 * macs, _nbytes(x, wt, bias) + 2 * b * t_out * hh * ww * cout),
                 reps=3, control_fn=lambda: control(x, wt, bias, kw),
                 control_label=label, library_fn=_cudnn_conv(xt, wt, bias, padded))
        _k3_rate(results, name, macs)
        del x, xt

    ragged("K3_conv3d", 1, 256, 256, 4, 61, 93, False,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, False),
           "zeros at the h and w edges")
    ragged("K3_conv3d", 1, 128, 128, 5, 125, 187, True,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, True),
           "zeros at the h and w edges")
    ragged("K3_conv3d", 1, 512, 512, 1, 64, 96, False,
           lambda x, wt, b, kw: _k3_zero_padded(x, wt, b, False, rows_cols=False),
           "zeros as the two leading frames")
    ragged("K3_conv3d_fused", 1, 128, 128, 3, 128, 192, True,
           lambda x, wt, b, kw: conv_mod.conv3d_plain(
               x, wt, b, True, **dict(kw, prefix_planes=0)),
           "every plane transformed", prefix=3)
    ragged("K3_conv3d", 2, 256, 256, 5, 64, 96, True,
           lambda x, wt, b, kw: conv_mod.conv3d_plain(x, wt, b, True).flip(0),
           "the batch items swapped")


def _flips_only(x, wt, flips: int = 8):
    """The check of K3's W8A8 mode against its plain version (see TOL):
    equal outputs except for at most ``flips`` flipped codes, each moving
    the outputs of its 3x3x3 neighbourhood (27 voxels x Cout) by at most
    one step, s * max|w| <= max|x| / 127 * max|w|; ``x`` is the conv's
    transformed input."""
    step = float(x.float().abs().max()) / 127.0 * float(wt.float().abs().max())

    def check(out, ref):
        d = (out.float() - ref.float()).abs()
        return (int((d > 0).sum()) <= flips * 27 * out.shape[-1]
                and float(d.max()) <= 2 * step)
    return check


def phase_k3_modes(dev, g, results):
    """K3's other modes at the decoder's classes for a 17-frame 512x768
    tile (latents 5 x 64 x 96): the GroupNorm-fold + SiLU prologue at
    128->128 (17x512x768), 256->256 (9x256x384) and 512->512 (5x128x192),
    and with two prefix planes at the streaming chunk's shape (128->128, 12
    + 2 frames, time_padded); W8A8 plain at 256->256 (9x256x384, four W
    tiles of 96) and with the prologue at 128->128 (17x512x768, four W
    tiles of 192), the latter with a control that one scale for the whole
    tensor fails; the window-max reduction alone at that shape. The
    library call is cuDNN's conv3d on an input transformed and padded
    beforehand; no PyTorch call is an int8 conv3d or a window max, so bf16
    cuDNN is timed beside W8A8 as a yardstick, and so is K3's bf16 instance
    on the same inputs."""
    import torch

    from kandinsky5_tpu_torch.ops import conv as conv_mod

    def inputs(cin, cout, t, hh, ww):
        x = torch.randn((1, t, hh, ww, cin), generator=g, device=dev).bfloat16()
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
        sc = 1 + 0.2 * torch.randn((cin,), generator=g, device=dev)
        sh = 0.1 * torch.randn((cin,), generator=g, device=dev)
        return x, wt, bias, sc, sh

    def cudnn(x, wt, bias, tp, sc, sh, prefix=0):
        xt = conv_mod.conv_prologue(x, sc, sh, True, prefix)
        return _cudnn_conv(xt, wt, bias, tp)

    for cin, cout, t, hh, ww, tp in ((128, 128, 17, 512, 768, False),
                                     (256, 256, 9, 256, 384, False),
                                     (512, 512, 5, 128, 192, False),
                                     (128, 128, 14, 512, 768, True)):
        x, wt, bias, sc, sh = inputs(cin, cout, t, hh, ww)
        kw = dict(time_padded=tp, scale=sc, shift=sh, act=True,
                  prefix_planes=2 if tp else 0)
        t_out = t - 2 if tp else t
        _compare("K3_conv3d_fused",
                 f"{cin}->{cout} {t_out}x{hh}x{ww}"
                 f"{' time_padded prefix 2' if tp else ''}",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, **kw), results,
                 work=(2.0 * 27 * t_out * hh * ww * cin * cout,
                       _nbytes(x, wt, bias, sc, sh) + 2 * t_out * hh * ww * cout),
                 reps=2, library_fn=cudnn(x, wt, bias, tp, sc, sh, kw["prefix_planes"]))
        _k3_rate(results, "K3_conv3d_fused", 27.0 * t_out * hh * ww * cin * cout)
        del x

    real_scales = conv_mod.window_scales

    def one_scale(*args):
        s, _ = real_scales(*args)
        top = s.max()
        return torch.full_like(s, top), torch.full_like(s, 1.0) / top

    for cin, cout, t, hh, ww, fuse in ((256, 256, 9, 256, 384, False),
                                       (128, 128, 17, 512, 768, True)):
        x, wt, bias, sc, sh = inputs(cin, cout, t, hh, ww)
        # windows of different scales: the magnitude grows along W
        x = (x.float() * (1 + torch.arange(ww, device=dev)[:, None] / ww)).bfloat16()
        kw = dict(quant=True)
        if fuse:
            kw.update(scale=sc, shift=sh, act=True)
        xt = conv_mod.conv_prologue(x, sc, sh) if fuse else x
        bw = conv_mod.quant_tile_width(ww, cin, cout)
        w8, _ = conv_mod.quantized_weight(wt)

        def control():
            conv_mod.window_scales = one_scale
            try:
                return conv_mod.conv3d_plain(x, wt, bias, **kw)
            finally:
                conv_mod.window_scales = real_scales

        ops = 2.0 * 27 * t * hh * ww * cin * cout
        _compare("K3_conv3d_quant",
                 f"{cin}->{cout} {t}x{hh}x{ww} bw {bw}"
                 f"{' with the prologue' if fuse else ''}",
                 lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **kw),
                 lambda: conv_mod.conv3d_plain(x, wt, bias, **kw), results,
                 work=(0.0, _nbytes(x, w8, bias) + 2 * t * hh * ww * cout, ops),
                 reps=2, check=_flips_only(xt, wt),
                 control_fn=control if fuse else None,
                 info=dict(windows=t * (hh // 8) * (ww // bw)),
                 yardstick_fn=_cudnn_conv(xt, wt, bias, False),
                 yardstick_label="bf16 cuDNN conv3d: not the same function")
        _k3_rate(results, "K3_conv3d_quant", ops / 2, int8=True)
        bf16 = {k: v for k, v in kw.items() if k != "quant"}
        r = results["K3_conv3d_quant"][-1]
        r["bf16_k3_ms"] = _time_ms(
            lambda: conv_mod.causal_conv3d_fused(x, wt, bias, **bf16), 2)
        log(f"    K3's bf16 instance on the same inputs {r['bf16_k3_ms']:.3f} ms: "
            f"W8A8 {r['ms'] / r['bf16_k3_ms']:.2f}x")
        if fuse:
            _compare("K3_quant_windows", f"{cin} ch {t}x{hh}x{ww} bw {bw} "
                     "with the prologue",
                     lambda: torch.stack(conv_mod.quant_window_scales(
                         x, bw, False, sc, sh, True)),
                     lambda: torch.stack(conv_mod.window_scales(xt, bw, False)),
                     results, work=(0.0, _nbytes(x, sc, sh)
                                    + 8 * t * (hh // 8) * (ww // bw)), reps=5)
        del x, xt


def _flex_attention(q, k, v, mask):
    """torch's flex_attention (the reference's NABLA route), compiled once,
    as a timed yardstick: ``make(inds, nb)`` gives a call over the blocks
    listed there, passed as full blocks; the mask_mod (which the compiled
    kernel skips on full blocks) reads the block mask from ``mask``, which
    the caller refills in place. Returns (make, None), or (None, reason)
    where flex_attention does not run here."""
    import torch

    try:
        from torch.nn.attention.flex_attention import BlockMask, flex_attention

        def mask_mod(b, h, q_idx, kv_idx):
            return mask[b, h, q_idx // 64, kv_idx // 64]

        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        fn = torch.compile(flex_attention, dynamic=False)
        opts = {"BLOCK_M": 64, "BLOCK_N": 64}

        def make(inds, nb):
            bm = BlockMask.from_kv_blocks(torch.zeros_like(nb), inds, nb, inds,
                                          BLOCK_SIZE=64, mask_mod=mask_mod)
            return lambda: fn(qt, kt, vt, block_mask=bm, kernel_options=opts)

        nb = torch.ones(mask.shape[:3], dtype=torch.int32, device=q.device)
        inds = torch.arange(mask.shape[3], dtype=torch.int32, device=q.device)
        make(inds.expand(*mask.shape).contiguous(), nb)()
        torch.cuda.synchronize()
    except Exception as e:  # a yardstick only: the port never calls it
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return make, None


def phase_k6(dev, g, normed, results):
    """K6 at the 10 s shape (1, 93,696, 28, 64) under four masks of the
    (61, 4, 6) tile grid: STA only, STA plus seeded random blocks to ~15 %,
    ~35 % and ~90 % kept (the density the 10 s request keeps with random
    weights). Beside it K1 at the same shape, dense (where sparsity stops
    paying), and flex_attention as the library call; each case logs its
    TFLOP/s and share of the tensor-core bound."""
    import torch

    from kandinsky5_tpu_torch.ops.flash import flash_fixed
    from kandinsky5_tpu_torch.ops.nabla import block_mask_to_kv_lists, sta_mask
    from kandinsky5_tpu_torch.ops.sparse import (
        sparse_attention,
        sparse_attention_plain,
    )

    s, h = 93696, 28
    q, k = normed((1, s, h, 64)), normed((1, s, h, 64))
    v = torch.randn((1, s, h, 64), generator=g, device=dev).bfloat16()
    k1_ms = _time_ms(lambda: flash_fixed(q, k, v), 2)
    k1_bound = bound_ms(4.0 * s * s * h * 64, _nbytes(q, k, v, q))
    log(f"  K1_flash_fixed (1,{s},{h},64) dense, for reference: {k1_ms:.3f} ms "
        f"bound {k1_bound[0]:.3f} ms ({k1_bound[1]})")
    sta = torch.from_numpy(sta_mask(61, 4, 6)).to(dev)
    s1 = sta.shape[0]
    mask = torch.zeros((1, h, s1, s1), dtype=torch.bool, device=dev)
    t = time.perf_counter()
    make_flex, why = _flex_attention(q, k, v, mask)
    if make_flex is None:
        log(f"  flex_attention does not run here ({why}): library_ms null")
    else:
        log(f"  flex_attention compiled in {time.perf_counter() - t:.1f} s")
    for label, target in (("STA", None), ("STA+random", 0.15),
                          ("STA+random", 0.35), ("STA+random", 0.90)):
        mask.copy_(sta.expand(1, h, s1, s1))
        if target is not None:
            p = (target - float(sta.float().mean())) / (1 - float(sta.float().mean()))
            mask |= torch.rand((1, h, s1, s1), generator=g, device=dev) < p
        inds, nb = block_mask_to_kv_lists(mask)
        density = float(mask.float().mean())
        listed = int(nb.sum())
        flex = None
        if make_flex is not None:
            flex = make_flex(inds, nb)
            e_abs, e_rel = _errors(flex().transpose(1, 2),
                                   sparse_attention_plain(q, k, v, inds, nb))
            log(f"  flex_attention against K6's plain version: max_abs "
                f"{e_abs:.3e} rel_l2 {e_rel:.3e} (exact softmax vs fixed shift)")
        _compare("K6_sparse_nabla",
                 f"(1,{s},{h},64) {label} {100 * density:.2f}% kept",
                 lambda: sparse_attention(q, k, v, inds, nb),
                 lambda: sparse_attention_plain(q, k, v, inds, nb), results,
                 work=(4.0 * 64 * 64 * 64 * listed,
                       _nbytes(q, k, v, q, nb) + 4 * listed),
                 reps=3,
                 control_fn=lambda: sparse_attention_plain(q * 0, k, v, inds, nb),
                 library_fn=flex,
                 info=dict(density=density, k1_dense_ms=k1_ms,
                           k1_dense_bound_ms=k1_bound[0]))
        r = results["K6_sparse_nabla"][-1]
        r["tflops"] = 4.0 * 64 ** 3 * listed / r["ms"] / 1e9
        lib = ("" if r["library_ms"] is None
               else f"; {r['ms'] / r['library_ms']:.2f}x flex_attention")
        log(f"    {r['tflops']:.1f} TFLOP/s ({100 * r['bound_ms'] / r['ms']:.1f} "
            f"% of the tensor-core bound){lib}")
        del inds, nb, flex
    del q, k, v, mask
    torch.cuda.empty_cache()


# Opcodes the int8 attention kernels must not hold: the int-to-float
# conversion (I2F) shares the special-function units' rate with exp2, so
# the kernels convert by an integer add and an FADD; a generic load (LD)
# where the dequant coefficients should be read from shared memory by LDS
SASS_BANNED = ("I2F", "LD")


def sass_banned(lib: str, kernel: str) -> dict:
    """For every instance of ``kernel`` in the built library, keyed by its
    template arguments ("MODE,MASK,LAG" for flash_int8_kernel), the static
    count of each of SASS_BANNED in its code, from ``cuobjdump -sass``."""
    import re
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(kernel + r"I(\w+?)EEv", line)
            cur = None if m is None else counts.setdefault(
                ",".join(re.findall(r"L\w(\d+)E", m.group(1))),
                dict.fromkeys(SASS_BANNED, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if cur is not None and m is not None and m.group(1) in cur:
            cur[m.group(1)] += 1
    return counts


def phase_int8(dev, g, normed, results):
    """K5 and K7 at K1's four main-path shapes, on one pack_int8 call
    shared with their plain version (the sides differ only in exp2's last
    bits and sum order), K7 held bit-equal to K5 and K5 against K1 (the quantization
    error on this card); T5's four modes at the 5 s shape. The log gives,
    beside the tensor-core bound, the achieved rate and K1's computed exp2
    floor (one exp2 per query and valid key at 16 a clock per SM at the
    highest SM clock), and phase 2 fails if an instance's SASS holds an
    opcode of SASS_BANNED."""
    import torch

    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops.flash import (
        flash_fixed,
        flash_int8_packed,
        flash_int8_plain,
        pack_int8,
    )
    from kandinsky5_tpu_torch.tools.bench_i8_decomp import (
        MODES,
        i8_decomp,
        i8_decomp_plain,
    )
    sass = sass_banned(_kernels.build(), "flash_int8_kernel")
    log(f"  SASS of flash_int8_kernel's {len(sass)} instances, "
        f"{'/'.join(SASS_BANNED)}: {sass}")
    if len(sass) != 8 or any(any(n.values()) for n in sass.values()):
        raise Failure("flash_int8_kernel: expected 8 instances free of "
                      f"{SASS_BANNED} in the SASS, got {sass}")
    exp2_rate = 16 * torch.cuda.get_device_properties(dev).multi_processor_count \
        * _max_sm_clock_hz()
    for lq, masked in ((47616, False), (10752, False), (1536, False),
                       (256, True)):
        q, k = normed((1, lq, 28, 64)), normed((1, lq, 28, 64))
        v = torch.randn((1, lq, 28, 64), generator=g, device=dev).bfloat16()
        mask = (torch.arange(lq, device=dev) < 77)[None] if masked else None
        n_keys = 77 if masked else lq
        q8, k8, coeff, shift = pack_int8(q, k)
        pairs = 2.0 * lq * n_keys * 28 * 64
        work = (pairs, _nbytes(q8, k8, v, coeff, mask, q), pairs)
        shape = f"(1,{lq},28,64){' mask' if masked else ''}"
        sdpa = _sdpa(q, k, v, None if mask is None else mask[:, None, None, :])
        outs = {}
        for name, pipe in (("K5_flash_int8", False), ("K7_flash_int8_pipe", True)):
            def kernel(pipe=pipe):
                return flash_int8_packed(q8, k8, v, coeff, shift, mask, pipe)

            outs[name] = kernel()
            _compare(name, shape, kernel,
                     lambda: flash_int8_plain(q8, k8, v, coeff, shift, mask),
                     results, work, reps=3 if lq > 10000 else 20,
                     control_fn=lambda: flash_int8_plain(q8 * 0, k8, v, coeff,
                                                         shift, mask),
                     yardstick_fn=sdpa)
            r = results[name][-1]
            r["tflops"] = 2 * pairs / r["ms"] / 1e9
            floor = lq * n_keys * 28 / exp2_rate * 1e3
            log(f"    {r['tflops']:.1f} TOP/s-equivalent "
                f"({100 * r['bound_ms'] / r['ms']:.1f} % of the tensor-core "
                f"bound); exp2 floor {floor:.3f} ms at the highest SM clock "
                f"({100 * floor / r['ms']:.1f} %); "
                f"{r['ms'] / r['yardstick_ms']:.2f}x the SDPA yardstick")
            if lq == 47616 and not pipe:
                log("    under a steady run of K5: " + _clock_under(kernel))
        torch.cuda.synchronize()
        same = bool(torch.equal(outs["K5_flash_int8"], outs["K7_flash_int8_pipe"]))
        k7_vs_k5 = (outs["K5_flash_int8"].float()
                    - outs["K7_flash_int8_pipe"].float()).abs().max().item()
        e_abs, e_rel = _errors(outs["K5_flash_int8"], flash_fixed(q, k, v, mask))
        log(f"  K7 against K5 {shape}: max_abs {k7_vs_k5:.3e} "
            f"({'bit-equal' if same else 'DIFFERENT'}); K5 against K1 (the "
            f"int8 quantization error on this card): max_abs {e_abs:.3e} "
            f"rel_l2 {e_rel:.3e}")
        results["K7_flash_int8_pipe"][-1]["ok"] &= same
        results["K7_flash_int8_pipe"][-1]["max_abs_vs_k5"] = k7_vs_k5
        results["K5_flash_int8"][-1]["rel_l2_vs_k1"] = e_rel
        del q, k, v, q8, k8, coeff, outs

    q, k = normed((1, 47616, 28, 64)), normed((1, 47616, 28, 64))
    v = torch.randn((1, 47616, 28, 64), generator=g, device=dev).bfloat16()
    q8, k8, coeff, shift = pack_int8(q, k)
    pairs = 2.0 * 47616 * 47616 * 28 * 64
    for mode in MODES:
        _compare("T5_i8_decomp", f"(1,47616,28,64) {mode}",
                 lambda: i8_decomp(q8, k8, v, coeff, shift, mode),
                 lambda: i8_decomp_plain(q8, k8, v, coeff, shift, mode),
                 results,
                 work=(0.0 if mode == "qk_only" else pairs,
                       _nbytes(q8, k8, v, coeff, q), pairs),
                 reps=3, info=dict(mode=mode))
    t = {r["mode"]: r["ms"] for r in results["T5_i8_decomp"]}
    log(f"  T5 at (1,47616,28,64): exp2 {t['full'] - t['no_exp2']:.3f} ms, "
        f"dequant {t['no_exp2'] - t['raw_pv']:.3f} ms, PV "
        f"{t['raw_pv'] - t['qk_only']:.3f} ms, QK + loads {t['qk_only']:.3f} ms")
    del q, k, v, q8, k8, coeff
    torch.cuda.empty_cache()


# T1's ragged cases beside SHAPES (M, K, N): rows not a multiple of the
# 128-row tile, and N not a multiple of the 256-column tile
T1_RAGGED = ((1000, 1792, 1792), (1000, 320, 136))


def phase_gemm(dev, g, results):
    """T1 in both types at the JAX tool's 8192^3 and the DiT's three
    projection shapes, then ragged (T1_RAGGED), beside ``torch._int_mm`` or
    bf16 ``matmul``, each with a control: the plain product with the last
    128-byte k step left out (128 int8 or 64 bf16 of K), which must fail
    the check (the int8 instance must equal the exact product); then K8 at
    each tp share and T2-T4 (``phase_ff_tools``, T2 also ragged). Each case
    logs its rate, share of bound and factor against its library call."""
    import torch

    from kandinsky5_tpu_torch.tools.bench_int8mm import (
        SHAPES,
        gemm,
        gemm_plain,
        library_call,
        operands,
    )

    for m, kk, n in SHAPES + T1_RAGGED:
        for name, dtype in (("T1_gemm_i8", torch.int8),
                            ("T1_gemm_bf16", torch.bfloat16)):
            a, b = operands(m, kk, n, dtype, g, dev)
            ops = 2.0 * m * n * kk
            work = (0.0 if dtype == torch.int8 else ops,
                    _nbytes(a, b) + 4 * m * n,
                    ops if dtype == torch.int8 else 0.0)
            step = 128 // a.element_size()
            _compare(name, f"({m},{kk},{n})", lambda: gemm(a, b),
                     lambda: gemm_plain(a, b), results, work=work,
                     reps=5, library_fn=library_call(a, b),
                     control_fn=lambda: gemm_plain(a[:, :-step], b[:, :-step]),
                     control_label="the last 128-byte k step left out")
            _rate(results, name, ops, "_int_mm" if dtype == torch.int8
                  else "bf16 matmul")
            del a, b
    torch.cuda.empty_cache()
    phase_ff_tools(dev, g, results)


def phase_ff_tools(dev, g, results):
    """K8 at each tensor-parallel rank's share of the 5 s visual FF, (47616,
    1792) x (1792, 7168 / tp) x (7168 / tp, 1792) for tp 1, 2 and 4, and the
    tools T2 (47616, 1792) x (1792, 1792), T3 and T4 at (47616, 1792) x
    7168; the library call of each FF is matmul -> GELU -> matmul in bf16
    (its hidden is rounded before the GELU too), T2's bf16 matmul. K8's
    control drops the last 128 hidden units (one column tile of the up
    product) from the plain version: a kernel that lost a tile of its
    reduction must fail the bound."""
    import torch

    from kandinsky5_tpu_torch.ops.ff import ff_plain, fused_ff
    from kandinsky5_tpu_torch.tools import bench_pallas_gemm as bpg

    x, wo, w1, w2 = bpg.operands(g, dev)
    rows, d = x.shape
    for tp in (1, 2, 4):
        f = bpg.FF // tp
        w1s, w2s = w1[:f].contiguous(), w2[:, :f].contiguous()
        _compare("K8_ff", f"({rows},{d})x({d},{f})x({f},{d}) tp {tp}",
                 lambda: fused_ff(x, w1s, w2s), lambda: ff_plain(x, w1s, w2s),
                 results, work=(4.0 * rows * d * f,
                                _nbytes(x, w1s, w2s) + 2 * rows * d),
                 library_fn=bpg.ff_library(x, w1s, w2s), info=dict(tp=tp),
                 control_fn=lambda: ff_plain(x, w1s[:-128], w2s[:, :-128]),
                 control_label="the last 128 of the ff sum dropped")
        _rate(results, "K8_ff", 4.0 * rows * d * f)
        del w1s, w2s
    for name, kernel, plain, library, flops, control in bpg.cases(x, wo, w1,
                                                                  w2):
        weights = (wo,) if name == "T2_gemm" else (w1, w2)
        work = (flops, _nbytes(x, *weights) + 2 * rows * d)
        _compare(name, f"({rows},{d})x{bpg.FF if name != 'T2_gemm' else d}",
                 kernel, plain, results, work=work,
                 library_fn=library, control_fn=control,
                 control_label="one tile of the reduction left out")
        _rate(results, name, flops,
              "bf16 matmul" if name == "T2_gemm" else "the bf16 chain")
    # T2 ragged: 1,000 rows, and N = 136 (not a multiple of the column tile)
    for xr, wr in ((x[:1000], wo), (x[:1000], wo[:136])):
        m, n = xr.shape[0], wr.shape[0]
        _compare("T2_gemm", f"({m},{d})x{n}", lambda: bpg.gemm(xr, wr),
                 lambda: bpg.gemm_plain(xr, wr), results,
                 work=(2.0 * m * n * d, _nbytes(xr, wr) + 2 * m * n),
                 library_fn=bpg.gemm_library(xr, wr),
                 control_fn=lambda: bpg.gemm_plain(xr[:, :-64], wr[:, :-64]),
                 control_label="the last 128-byte k step left out")
        _rate(results, "T2_gemm", 2.0 * m * n * d, "bf16 matmul")
    del x, wo, w1, w2
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: small-input reference of the path (card kernels vs CPU plain)
# ---------------------------------------------------------------------------

class SeededEmbedder:
    """Stand-in for the Qwen2.5-VL + CLIP embedder: (B, 256, 3584) text
    embeddings with a partial mask and (B, 768) pooled, from a generator
    seeded by the prompt."""

    def __init__(self, length=256, text_dim=3584, pooled_dim=768):
        self.length, self.text_dim, self.pooled_dim = length, text_dim, pooled_dim

    def encode(self, texts, type_of_content="video"):
        import torch

        from kandinsky5_tpu_torch.pipeline import TextEmbeddings

        embeds, pooled, masks = [], [], []
        for text in texts:
            seed = zlib.crc32(f"{type_of_content}:{text}".encode())
            g = torch.Generator().manual_seed(seed)
            embeds.append(torch.randn(self.length, self.text_dim, generator=g))
            pooled.append(torch.randn(self.pooled_dim, generator=g))
            n_valid = 40 + seed % 180
            masks.append(torch.arange(self.length) < n_valid)
        return TextEmbeddings(torch.stack(embeds), torch.stack(pooled),
                              torch.stack(masks))

    def expand_prompt(self, prompt):
        return prompt


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _density(kept) -> float:
    """Mean kept fraction of the masks ``nabla.record_density`` saw."""
    import torch

    return float(torch.stack(kept).float().mean()) if kept else float("nan")


def phase_reference(dev, conf):
    """DiT (full width, 2 text + 2 visual blocks) and the VAE decoder on a
    small input: bf16 kernels on the card vs the same bf16 weights in fp32
    through the plain versions on the CPU. The DiT runs dense on a (2, 32,
    48) latent and NABLA on a (4, 64, 96) one (a (4, 4, 6) tile grid of 96
    blocks, STA alone keeps 27.8 %). The VAE latent (1, 5, 16, 32)
    decodes in a 4-frame chunk of 4 * 512 = 2048 tokens, the size at which
    mid attention goes to K4, then a 1-frame chunk that carries the K/V
    buffer. The int8 DiT (W8A8 and flash_int8, the same int8 weights on
    both sides) runs a (2, 48, 64) latent. bf16 activations through a few
    blocks keep about 2-3 significant digits, so the bound is a relative L2
    error of 5e-2; a wrong layout or index gives errors near 1."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import (
        SparseParams,
        dit_forward,
        fast_init_dit_params,
        quantize_dit_params,
    )
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.models.vae_stream import streaming_decode
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops.nabla import record_density, sta_mask

    cfg = dataclasses.replace(conf.model.dit_params, num_text_blocks=2,
                              num_visual_blocks=2)
    dit = fast_init_dit_params(cfg, device=dev, dtype=torch.bfloat16, seed=7)
    dit_cpu = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    dit_cpu.load_state_dict({k: v.float().cpu() for k, v in dit.state_dict().items()})
    emb = SeededEmbedder().encode(["reference"], "video")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 2, 32, 48, 33), generator=g)
    args = (emb.text_embeds, emb.pooled_embed, torch.tensor([500.0]), emb.mask)
    _kernels.reset_launches()
    out = dit_forward(dit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                      scale_factor=(1.0, 2.0, 2.0))
    launched = dict(_kernels.LAUNCHES)
    ref = dit_forward(dit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0))
    e_dit = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, (1,2,32,48): rel_l2 {e_dit:.3e} "
        f"(tol 5e-2), kernel launches {launched}")

    x = torch.randn((1, 4, 64, 96, 33), generator=g)
    sta = torch.from_numpy(sta_mask(4, 4, 6))
    _kernels.reset_launches()
    with record_density() as kept:
        out = dit_forward(dit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                          scale_factor=(1.0, 2.0, 2.0),
                          sparse=SparseParams(sta.to(dev), 0.9))
        launched_n = dict(_kernels.LAUNCHES)
    with record_density() as kept_cpu:
        ref = dit_forward(dit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0),
                          sparse=SparseParams(sta, 0.9))
    e_nabla = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, NABLA (1,4,64,96): rel_l2 "
        f"{e_nabla:.3e} (tol 5e-2); mask density card {_density(kept):.4f} "
        f"cpu {_density(kept_cpu):.4f} (STA alone {float(sta.float().mean()):.4f});"
        f" kernel launches {launched_n}")

    # the int8 DiT: flash_int8 attention and W8A8 projections on 1,536
    # visual tokens, where the text cross-attention is short-KV (dense), so
    # K5 runs the 2 text and 2 visual self-attentions
    qdit, qdit_cpu = quantize_dit_params(dit), quantize_dit_params(dit_cpu)
    x = torch.randn((1, 2, 48, 64, 33), generator=torch.Generator().manual_seed(9))
    _kernels.reset_launches()
    out = dit_forward(qdit, x.to(dev).bfloat16(), *[a.to(dev) for a in args],
                      scale_factor=(1.0, 2.0, 2.0), attn_impl="flash_int8")
    launched_i = dict(_kernels.LAUNCHES)
    ref = dit_forward(qdit_cpu, x, *args, scale_factor=(1.0, 2.0, 2.0),
                      attn_impl="flash_int8")
    e_int8 = _rel(out, ref)
    log(f"  DiT 2+2 blocks, full width, int8 (flash_int8 + W8A8) (1,2,48,64): "
        f"rel_l2 {e_int8:.3e} (tol 5e-2), kernel launches {launched_i}")
    del dit, dit_cpu, qdit, qdit_cpu

    vp = init_vae_params(device=dev, dtype=torch.bfloat16, seed=3)

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float().cpu()

    z = torch.randn((1, 5, 16, 32, 16), generator=g)
    _kernels.reset_launches()
    out_v = streaming_decode(vp, z.to(dev).bfloat16())
    launched_v = dict(_kernels.LAUNCHES)
    ref_v = streaming_decode(to_cpu(vp), z)
    e_vae = _rel(out_v, ref_v)
    log(f"  VAE stream decode (1,5,16,32,16) -> {tuple(out_v.shape)}: rel_l2 "
        f"{e_vae:.3e} (tol 5e-2), kernel launches {launched_v}")
    # the same decode through the VAE with GroupNorm + SiLU folded into K3
    # (fuse_gn): its second chunk's convs carry two prefix planes; in fp32
    # the fused and unfused streams agree to 2e-4, so the CPU reference is
    # the unfused one
    _kernels.reset_launches()
    out_f = HunyuanVideoVAE(vp, fuse_gn=True).decode(z.to(dev).bfloat16(),
                                                     mode="stream")
    launched_f = dict(_kernels.LAUNCHES)
    e_fused = _rel(out_f, ref_v)
    log(f"  VAE stream decode, fuse_gn=True, (1,5,16,32,16): rel_l2 "
        f"{e_fused:.3e} (tol 5e-2), kernel launches {launched_f}")
    tiled = phase_tiled_reference(dev, vp, to_cpu(vp), g)
    if not (e_dit < 5e-2 and e_nabla < 5e-2 and e_int8 < 5e-2
            and e_vae < 5e-2 and e_fused < 5e-2):
        raise Failure(f"path disagrees with its CPU reference: DiT {e_dit}, "
                      f"NABLA DiT {e_nabla}, int8 DiT {e_int8}, VAE {e_vae}, "
                      f"fused stream VAE {e_fused}")
    if min(launched["K1_flash_fixed"], launched["K2_ff_mod"],
           launched_v["K3_conv3d"], launched_v["K4_flash_online"],
           launched_f["K3_conv3d_fused"]) == 0:
        raise Failure("the reference run missed a kernel: DiT "
                      f"{launched}, VAE {launched_v}, fused VAE {launched_f}")
    if launched_n["K6_sparse_nabla"] != 2:
        raise Failure(f"the NABLA DiT launched K6 {launched_n} times, not 2")
    if launched_i["K5_flash_int8"] != 4 or launched_i["K1_flash_fixed"] != 0:
        raise Failure(f"the int8 DiT launched {launched_i}: K5 must launch 4 "
                      "times and K1 never")
    return {"dit_rel_l2": e_dit, "nabla_dit_rel_l2": e_nabla,
            "int8_dit_rel_l2": e_int8, "vae_rel_l2": e_vae,
            "vae_fused_stream_rel_l2": e_fused, **tiled}


# the tiled reference: tiles of 3 latent frames (9 px frames, stride 4) and
# 8 x 16 latents (64 x 128 px, strides 32 and 64 px) over a (3, 12, 24)
# latent: 2 temporal x 2 x 2 spatial tiles, blends on every axis
TILED_REF = ((1, 3, 12, 24, 16), (9, 64, 128), (4, 32, 64))


def phase_tiled_reference(dev, vp, vp_cpu, g):
    """The tiled decode at tile settings that force two temporal and 2 x 2
    spatial tiles (``TILED_REF``; every level but the first, 16 px wide, is
    one the TPU kernel admits, so the fused and W8A8 modes run there).

    bf16 (GroupNorm folded into K3, the tiled default): the card against
    the same weights in fp32 through the plain versions on the CPU, rel_l2
    5e-2 as the stream decode.

    int8 convs: held conv by conv. Every K3 call of the card's decode is
    compared, on its own input, with its plain version on the card: W8A8
    calls equal up to a few flipped codes (``_flips_only``, as in phase 2),
    the others within K3's tolerance. Two controls must fail that check:
    the same decode with one scale for the whole tensor in every W8A8 call
    (each window-max result replaced by its largest scale), and with the
    quantization off (the bf16 kernel held against the W8A8 plain version).
    No whole-decode bound: rounding flips compound through GroupNorm's
    statistics, so the int8 decode does not stay near any reference that
    computes in another order. On an H100 a one-ulp change at 0.1 % of the
    latents moved the card's own int8 decode 1.1e-1 (rel_l2) from itself,
    further than the bf16 decode lies from it (8.6e-2); both readings are
    logged."""
    import torch

    from kandinsky5_tpu_torch.models import vae as vae_mod
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.ops import conv as conv_mod

    shape, tile, stride = TILED_REF
    z = torch.randn(shape, generator=g)
    zd = z.to(dev).bfloat16()

    def vae(params, **kw):
        v = HunyuanVideoVAE(params, **kw)
        v._apply_tiling(tile, stride)
        return v

    _kernels.reset_launches()
    out_bf16 = vae(vp).decode(zd, opt_tiling=False, mode="tiled")
    launched = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    ref = vae(vp_cpu, dtype=torch.float32).decode(z, opt_tiling=False,
                                                  mode="tiled")
    e_bf16 = _rel(out_bf16, ref)
    ok_bf16 = e_bf16 < 5e-2 and launched.get("K3_conv3d_fused", 0) > 0
    log(f"  VAE tiled decode bf16 {shape} tiles {tile} stride {stride} -> "
        f"{tuple(out_bf16.shape)}: rel_l2 {e_bf16:.3e} (tol 5e-2), kernel "
        f"launches {launched}")

    real_conv, real_scales = vae_mod.causal_conv3d_fused, \
        conv_mod.quant_window_scales
    atol, rtol = TOL["K3_conv3d_fused"]

    def one_scale(*args):
        s, _ = real_scales(*args)
        top = s.max()
        return torch.full_like(s, top), torch.full_like(s, 1.0) / top

    def held(run, quant_off=False):
        """``run()`` with every K3 call of the VAE held against its plain
        version on the same input; returns (run's result, [(W8A8?, rel_l2,
        within the check?)])."""
        calls = []

        def conv(x, w, b, *args, **kw):
            quant = kw.get("quant", False)
            y = real_conv(x, w, b, *args, **dict(kw, quant=quant and not
                                                  quant_off))
            want = conv_mod.conv3d_plain(x, w, b, *args, **kw)
            max_abs, rel = _errors(y, want)
            if quant:
                xt = x if kw.get("scale") is None else conv_mod.conv_prologue(
                    x, kw["scale"], kw["shift"], kw.get("act", False))
                ok = _flips_only(xt, w)(y, want)
            else:
                ok = max_abs <= atol and rel <= rtol
            calls.append((quant, rel, ok))
            return y

        vae_mod.causal_conv3d_fused = conv
        try:
            return run(), calls
        finally:
            vae_mod.causal_conv3d_fused = real_conv
            conv_mod.quant_window_scales = real_scales

    v8 = vae(vp, int8_conv=True)
    _kernels.reset_launches()
    out_i8, calls = held(lambda: v8.decode(zd, opt_tiling=False, mode="tiled"))
    launched_i8 = {k: n for k, n in _kernels.LAUNCHES.items() if n}

    def one_scale_run():
        conv_mod.quant_window_scales = one_scale
        return v8.decode(zd, opt_tiling=False, mode="tiled")

    _, calls_one = held(one_scale_run)
    _, calls_off = held(lambda: v8.decode(zd, opt_tiling=False, mode="tiled"),
                        quant_off=True)

    def summary(cs):
        q = [(rel, ok) for quant, rel, ok in cs if quant]
        return (len(q), sum(not ok for _, ok in q), max(r for r, _ in q),
                all(ok for _, _, ok in cs))

    n_q, bad, worst, ok_i8 = summary(calls)
    _, bad_one, worst_one, ok_one = summary(calls_one)
    _, bad_off, worst_off, ok_off = summary(calls_off)
    ok_i8 = ok_i8 and all(launched_i8.get(k) for k in ("K3_conv3d_quant",
                                                        "K3_quant_windows"))
    # the readings that rule out a whole-decode bound
    gp = torch.Generator().manual_seed(17)
    nudge = torch.rand(shape, generator=gp) < 1e-3
    zp = torch.where(nudge.to(dev), (zd.float() * (1 + 2 ** -7)).bfloat16(), zd)
    out_p = v8.decode(zp, opt_tiling=False, mode="tiled")
    e_nudge, e_vs_bf16 = _rel(out_p, out_i8), _rel(out_bf16, out_i8)
    log(f"  VAE tiled decode int8, conv by conv on the card: {len(calls)} K3 "
        f"calls, {n_q} W8A8, {bad} outside the check (flips only), worst "
        f"W8A8 rel_l2 {worst:.3e}; kernel launches {launched_i8}")
    log(f"  controls that must fail it: one scale for the whole tensor "
        f"{bad_one} of {n_q} W8A8 calls outside, worst rel_l2 "
        f"{worst_one:.3e} {'fails' if not ok_one else 'PASSES'}; "
        f"quantization off {bad_off} of {n_q} outside, worst rel_l2 "
        f"{worst_off:.3e} {'fails' if not ok_off else 'PASSES'}")
    log(f"  int8 decode against itself from latents nudged one bf16 ulp at "
        f"0.1 % of entries: rel_l2 {e_nudge:.3e}; against the bf16 decode: "
        f"{e_vs_bf16:.3e} (recorded, not gated)")
    if not (ok_bf16 and ok_i8) or ok_one or ok_off:
        raise Failure(
            f"tiled decode: bf16 rel_l2 {e_bf16} launches {launched}; int8 "
            f"{bad} of {n_q} W8A8 calls outside the check, launches "
            f"{launched_i8}; controls pass: one scale {ok_one}, "
            f"quantization off {ok_off}")
    return {"vae_tiled_bf16_rel_l2": e_bf16, "vae_tiled_int8_w8a8_calls": n_q,
            "vae_tiled_int8_worst_rel_l2": worst,
            "vae_tiled_int8_one_scale_worst_rel_l2": worst_one,
            "vae_tiled_int8_quant_off_worst_rel_l2": worst_off,
            "vae_tiled_int8_nudged_rel_l2": e_nudge,
            "vae_tiled_int8_vs_bf16_rel_l2": e_vs_bf16}


# ---------------------------------------------------------------------------
# phase 4: the pipeline at full width
# ---------------------------------------------------------------------------

def _answer(pipe, requests, out_dir):
    """Run each (name, prompt, seconds, frame shape, file) request through
    ``pipe`` and check what comes out; returns one report per request and
    the frames by request name."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.ops.nabla import record_density

    report, videos = [], {}
    for name, prompt, tl, shape, fname in requests:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with record_density() as kept:
            frames = pipe(prompt, time_length=tl, width=768,
                          height=512, seed=42, expand_prompts=False,
                          save_path=os.path.join(out_dir, fname))
        wall = time.perf_counter() - t
        tm = dict(pipe.timings)
        peak = torch.cuda.max_memory_allocated()
        steps = tm["steps"]
        saved = tm["saved"][0]
        if not os.path.isfile(saved) or os.path.getsize(saved) == 0:
            raise Failure(f"{name}: nothing written at {saved}")
        density = _density(kept)
        log(f"  {name}: frames {frames.shape} {frames.dtype}; denoise "
            f"{tm['denoise_s']:.3f} s ({tm['denoise_s'] / steps:.4f} s/step, "
            f"{steps} steps, cfg {tm['cfg']}); decode {tm['decode_s']:.3f} s; "
            f"wall {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB; "
            + (f"{len(kept)} NABLA masks, mean density {density:.4f}; "
               if kept else "")
            + f"wrote {saved} ({os.path.getsize(saved)} bytes)")
        if frames.shape != shape or frames.dtype != np.uint8:
            raise Failure(f"{name}: frames {frames.shape} {frames.dtype}, "
                          f"expected {shape} uint8")
        if not tm["latents_finite"]:
            raise Failure(f"{name}: non-finite latents")
        if float(frames.std()) == 0.0:
            raise Failure(f"{name}: constant frames")
        report.append(dict(request=name, s_per_step=tm["denoise_s"] / steps,
                           denoise_s=tm["denoise_s"], decode_s=tm["decode_s"],
                           peak_gib=peak / 2**30,
                           nabla_density=density if kept else None))
        videos[name] = frames
    return report, videos


def _video(tag, seconds, prompt=None):
    frames = 4 * (seconds * 24 // 4) + 1
    name = f"{tag} video {seconds}s"
    return (name, prompt or f"a smoke-test {name}", seconds,
            (1, frames, 512, 768, 3), f"{tag}_video_{seconds}s.mp4")


def psnr(a, b) -> float:
    """PSNR in dB of uint8 frames ``a`` against ``b``."""
    import numpy as np

    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def phase_pipeline(dev, conf5, conf10, seconds5: int, seconds10: int,
                   out_dir: str):
    """The 5 s path (image + video) and the 10 s path (one video), each
    with the launch counts reset just before it and read just after, then
    the decodes; returns the launches by path, the report and the 5 s
    path video's tiled frames."""
    import torch

    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    if conf10.model.dit_params != conf5.model.dit_params:
        raise Failure("the 5 s and 10 s configs name different DiTs")
    t0 = time.perf_counter()
    dit = fast_init_dit_params(conf5.model.dit_params, device=dev,
                               dtype=torch.bfloat16, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"  built: DiT {n_params} params, VAE decoder; "
        f"{time.perf_counter() - t0:.1f} s")
    os.makedirs(out_dir, exist_ok=True)

    log(f"  5 s path ({os.path.basename(CONF5)}: {conf5.model.num_steps} "
        f"steps, guidance {conf5.model.guidance_weight}, dense attention)")
    pipe5 = Kandinsky5T2VPipeline(dit, conf5, SeededEmbedder(), vae)
    latents = _keep_latents(pipe5, "5s")
    _kernels.reset_launches()
    bf16_video = _video("5s-path", seconds5, VIDEO_PROMPT)
    report, videos = _answer(
        pipe5, [("image", "a smoke-test image", 0, (1, 1, 512, 768, 3),
                 "image.png"), bf16_video], out_dir)
    launches5 = dict(_kernels.LAUNCHES)
    log(f"  kernel launches on the 5 s path: {launches5}")
    missing = [k for k in ("K1_flash_fixed", "K2_ff_mod", "K3_conv3d",
                           "K4_flash_online") if launches5[k] == 0]
    if missing:
        raise Failure(f"the 5 s path never launched {missing}")

    m10 = conf10.model
    log(f"  10 s path ({os.path.basename(CONF10)}: {m10.num_steps} steps, "
        f"guidance {m10.guidance_weight}, attention {m10.attention.type} "
        f"P {m10.attention.P} window ({m10.attention.wT}, {m10.attention.wH},"
        f" {m10.attention.wW}))")
    pipe10 = Kandinsky5T2VPipeline(dit, conf10, SeededEmbedder(), vae)
    _keep_latents(pipe10, "10s", latents)
    _kernels.reset_launches()
    video10 = _video("10s-path", seconds10)
    rep10, videos10 = _answer(pipe10, [video10], out_dir)
    report += rep10
    launches10 = dict(_kernels.LAUNCHES)
    log(f"  kernel launches on the 10 s path: {launches10}")
    cfg = m10.dit_params
    want = {"K6_sparse_nabla": cfg.num_visual_blocks * m10.num_steps,
            "K1_flash_fixed": cfg.num_text_blocks * m10.num_steps}
    wrong = {k: (launches10[k], n) for k, n in want.items()
             if launches10[k] != n}
    missing = [k for k in ("K2_ff_mod", "K3_conv3d", "K4_flash_online")
               if launches10[k] == 0]
    if wrong or missing:
        raise Failure(f"the 10 s path launched (got, want) {wrong}, never "
                      f"launched {missing}")

    m5, cfg5 = conf5.model, conf5.model.dit_params
    n_attn = (cfg5.num_text_blocks + cfg5.num_visual_blocks) * m5.num_steps
    log(f"  5 s int8 path ({os.path.basename(CONF5)}, the bf16 video's "
        f"prompt and seed): (a) flash_int8, (b) flash_int8_pipe + W8A8")
    launches = {"5s": launches5, "10s": launches10}
    for tag, kw, want in (
            ("a", dict(attn_impl="flash_int8"),
             {"K5_flash_int8": n_attn, "K1_flash_fixed": 0,
              "K7_flash_int8_pipe": 0}),
            ("b", dict(attn_impl="flash_int8_pipe", int8_linear=True),
             {"K7_flash_int8_pipe": n_attn, "K5_flash_int8": 0,
              "K1_flash_fixed": 0, "K2_ff_mod": 0})):
        pipe = Kandinsky5T2VPipeline(dit, conf5, SeededEmbedder(), vae, **kw)
        _kernels.reset_launches()
        rep, vids = _answer(pipe, [_video(f"5s-int8-{tag}", seconds5,
                                          VIDEO_PROMPT)], out_dir)
        got = dict(_kernels.LAUNCHES)
        log(f"  kernel launches on the 5 s int8 path ({tag}): {got}")
        db = psnr(next(iter(vids.values())), videos[bf16_video[0]])
        rep[0]["psnr_vs_bf16_db"] = db
        log(f"  5s-int8-{tag}: frame PSNR against the bf16 video {db:.2f} dB "
            "(random weights: recorded, not gated)")
        report += rep
        launches[f"5s-int8-{tag}"] = got
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        missing = [k for k in ("K3_conv3d", "K4_flash_online") if got[k] == 0]
        if wrong or missing:
            raise Failure(f"the 5 s int8 path ({tag}) launched (got, want) "
                          f"{wrong}, never launched {missing}")
        del pipe, vids
    torch.cuda.empty_cache()
    log("  decodes of the requests' latents: tiled, int8 convs (stream and "
        "tiled), 1024 x 1024")
    rep, dec_launches, tiled = phase_decodes(
        dev, conf5, vae, latents, videos[bf16_video[0]],
        videos10[video10[0]] if seconds10 == 10 else None)
    return {**launches, **dec_launches}, report + rep, tiled


def _keep_latents(pipe, key, store=None):
    """Make ``pipe`` keep the latents of its last decode in ``store[key]``
    (the video request's, as it comes last)."""
    store = {} if store is None else store
    real = pipe.decode_latents

    def decode_latents(lat, mode=None):
        store[key] = lat
        return real(lat, mode)

    pipe.decode_latents = decode_latents
    return store


def expected_decode_launches(vae, shape, mode: str, int8: bool) -> dict:
    """K3's launches by mode and K4's in one ``vae.decode(z, mode=mode)``
    of latents ``shape``, counted from the decoder's structure: the tiles
    (or streaming chunks) the reference's tables give, and per tile each
    3x3x3 conv of 128-512 channels (14 resnets of two GroupNorm convs and
    three upsampler convs) routed by the TPU kernel's admission rule; K4
    once per tile or chunk of at least 2048 latent voxels."""
    import torch

    from kandinsky5_tpu_torch.models.vae import (
        BLOCK_OUT_CHANNELS,
        FLASH_MIN_TOKENS,
        LAYERS_PER_BLOCK,
        _up_plan,
    )
    from kandinsky5_tpu_torch.ops.conv import tpu_kernel_admits

    _, tf, hl, wl, _ = shape
    (ft, ht, wt), (fs, hs, ws) = vae._optimal_tiling(4 * (tf - 1) + 1,
                                                     8 * hl, 8 * wl)
    stream = mode == "stream" and not (wl > ws // 8 or hl > ht // 8)
    fuse = (not stream) if vae.fuse_gn is None else vae.fuse_gn
    if stream:
        n0 = min(tf, 4)
        frames = [n0] + [min(3, tf - i) for i in range(n0, tf, 3)]
        tiles = [(hl, wl)]
    else:
        t_lat = (ft - 1) // 4
        frames = ([len(range(tf)[i:i + t_lat + 1])
                   for i in range(0, tf - t_lat + 1, fs // 4)]
                  if tf > t_lat + 1 else [tf])
        if wl > ws // 8 or hl > ht // 8:
            tiles = [(ht // 8, wt // 8)] * (
                len(range(0, hl - ht // 8 + 1, hs // 8))
                * len(range(0, wl - wt // 8 + 1, ws // 8)))
        else:
            tiles = [(hl, wl)]
    per_tile = dict.fromkeys(("K3_conv3d", "K3_conv3d_fused",
                              "K3_conv3d_quant", "K3_quant_windows"), 0)

    def conv(cin, cout, h, w, gn):
        admitted = tpu_kernel_admits(
            torch.empty((1, 1, h, w, cin), device="meta"),
            torch.empty((cout, cin, 3, 3, 3), device="meta"))
        if int8 and admitted:
            per_tile["K3_conv3d_quant"] += 1
            per_tile["K3_quant_windows"] += 1
        elif gn and fuse and admitted:
            per_tile["K3_conv3d_fused"] += 1
        else:
            per_tile["K3_conv3d"] += 1

    def count(h, w):
        for k in per_tile:
            per_tile[k] = 0
        rev = list(reversed(BLOCK_OUT_CHANNELS))
        for _ in range(2 * 2):  # the mid block's two resnets
            conv(rev[0], rev[0], h, w, True)
        c_in = rev[0]
        for i, (add_s, _) in enumerate(_up_plan()):
            for j in range(LAYERS_PER_BLOCK + 1):
                conv(c_in if j == 0 else rev[i], rev[i], h, w, True)
                conv(rev[i], rev[i], h, w, True)
            c_in = rev[i]
            if add_s:
                h, w = 2 * h, 2 * w
                conv(rev[i], rev[i], h, w, False)
        return dict(per_tile)

    total = dict.fromkeys(list(per_tile) + ["K4_flash_online"], 0)
    for h, w in tiles:
        n = count(h, w)
        for t in frames:
            for k, v in n.items():
                total[k] += v
            total["K4_flash_online"] += t * h * w >= FLASH_MIN_TOKENS
    return total


def phase_decodes(dev, conf5, vae, latents, frames5, frames10):
    """The decodes beside the streaming default, each with its launch
    counts reset just before and held against ``expected_decode_launches``
    just after: the 5 s path video's latents (1 s, or 5 s with ``--seconds
    5``) decoded tiled, then with int8 convs streamed and tiled (frame PSNR
    against the bf16 decode of the same mode, recorded, not gated); a
    17-frame 1024 x 1024 decode through the pipeline's default decode,
    which tiles it 2 x 2 (``OPT_SPATIAL_TILING[1024]``); with ``--seconds
    10`` the 241-frame video's latents tiled, and its PSNR against the
    streaming decode the request made."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    pipe = Kandinsky5T2VPipeline(None, conf5, None, vae)
    pipe_i8 = Kandinsky5T2VPipeline(None, conf5, None, vae, int8_conv=True)
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn((1, 5, 128, 128, 16), generator=g, device=dev).bfloat16()
    cases = [("tiled", pipe, latents["5s"], "tiled", frames5, "stream bf16"),
             ("int8-stream", pipe_i8, latents["5s"], "stream", frames5,
              "stream bf16"),
             ("int8-tiled", pipe_i8, latents["5s"], "tiled", "tiled",
              "tiled bf16"),
             ("1024x1024", pipe, big, None, None, None)]
    if frames10 is not None:
        cases.append(("10s-tiled", pipe, latents["10s"], "tiled", frames10,
                      "stream bf16"))
    report, launches, decoded = [], {}, {}
    for name, p, lat, mode, against, against_name in cases:
        want = expected_decode_launches(p.vae, tuple(lat.shape),
                                        mode or p.decode_mode, p.int8_conv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t = time.perf_counter()
        frames = p.decode_latents(lat, mode)
        wall = time.perf_counter() - t
        got = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        decoded[name] = frames
        tf, hl, wl = lat.shape[1:4]
        shape = (1, 4 * (tf - 1) + 1, 8 * hl, 8 * wl, 3)
        line = dict(request=f"decode {name}", decode_s=wall, peak_gib=peak,
                    frames=list(frames.shape))
        if isinstance(against, str):
            against = decoded[against]
        if against is not None:
            line["psnr_db"] = psnr(frames, against)
            line["psnr_against"] = against_name
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        log(f"  decode {name} {tuple(lat.shape)} -> {frames.shape}: "
            f"{wall:.3f} s, peak {peak:.2f} GiB, launches "
            f"{ {k: got[k] for k in want} }"
            + (f", PSNR against the {against_name} decode "
               f"{line['psnr_db']:.2f} dB" if against is not None else ""))
        if wrong or frames.shape != shape or frames.dtype != np.uint8 \
                or float(frames.std()) == 0.0:
            raise Failure(f"decode {name}: launches (got, want) {wrong}, "
                          f"frames {frames.shape} {frames.dtype}")
        launches[f"decode-{name}"] = got
        report.append(line)
    return report, launches, decoded["tiled"]


# ---------------------------------------------------------------------------
# phase 5: the tensor-parallel DiT, its ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

# seed of the tp forward's weights and inputs
TP_SEED = 5
TP_WORLDS = (2, 4)
# a tp forward against the tp = 1 forward on the same card, relative L2: the
# two sum the row-parallel products in another order and round each rank's
# partial sum to bf16, which 34 bf16 blocks carry to the output. Over seeds
# 5-8 (``--tp-seeds``, H100 80GB HBM3, 700 W) the sound runs read 4.26e-3 to
# 4.51e-3 and the weakest control (bias on every rank, tp 2) 1.555e-2 to
# 1.653e-2; the bound sits near their geometric mean, about 1.8x from each
TP_BOUND = 8e-3
# the controls a sound tp forward must not resemble: each rank keeps its FF
# partial sum; each rank adds the out layers' bias before the all-reduce
TP_CONTROLS = ("no_ff_all_reduce", "bias_on_every_rank")


def tp_inputs(cfg, device, seed: int = TP_SEED):
    """Seeded inputs of one DiT forward at the 5 s shape: a (1, 31, 64, 96,
    33) latent (47,616 visual tokens after 1 x 2 x 2 patches), 256 text
    tokens of which 200 are valid, a pooled embedding and t = 0.5."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, 31, 64, 96, cfg.visual_embed_dim, generator=g)
    text = torch.randn(1, 256, cfg.in_text_dim, generator=g)
    pooled = torch.randn(1, cfg.in_text_dim2, generator=g)
    mask = torch.arange(256)[None] < 200
    return (x.to(device, torch.bfloat16), text.to(device, torch.bfloat16),
            pooled.to(device, torch.bfloat16),
            torch.tensor([500.0], device=device), mask.to(device))


class _NoSum:
    """A group whose all-reduce leaves each rank's partial sum as it is."""

    def all_reduce(self, x):
        return x


def _tp_forward_rank(tp, cfg_kw, controls, seed):
    """One rank of a tp forward: its share of the DiT seeded with ``seed``
    (weights and inputs), built one parameter at a time; the sound forward,
    then each control. Returns per run the output (the controls' on rank 0
    only), the wall and all-reduce seconds and the launch counts, reset
    just before the forward."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.models import dit as dit_mod
    from kandinsky5_tpu_torch.models import nn as nn_mod
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DiTParams(**cfg_kw)
    t = time.perf_counter()
    model = fast_init_dit_shard(cfg, tp, seed=seed)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t,
           "params": sum(p.numel() for p in model.parameters())}
    args = tp_inputs(cfg, tp.device, seed)
    real_ff = nn_mod.feed_forward

    def ff_without_sum(p, x, tp=None):
        return real_ff(p, x, None if tp is None else _NoSum())

    def bias_on_every_rank(layer, x, tp=None):
        if tp is None:
            return nn_mod.linear(layer, x)
        return tp.all_reduce(F.linear(x, layer.weight, layer.bias))

    patches = {"sound": (),
               "no_ff_all_reduce": ((nn_mod, "feed_forward", ff_without_sum),),
               "bias_on_every_rank": ((dit_mod, "row_parallel_linear",
                                       bias_on_every_rank),)}
    for name in ("sound",) + tuple(controls):
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in patches[name]:
                stack.enter_context(mock.patch.object(mod, attr, fn))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tp.reset_stats()
            _kernels.reset_launches()
            t = time.perf_counter()
            y = dit_mod.dit_forward(model, *args, scale_factor=(1.0, 2.0, 2.0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(_kernels.LAUNCHES)
        out[name] = dict(
            y=y.float().cpu() if name == "sound" or tp.rank == 0 else None,
            wall_s=wall, all_reduce_s=tp.seconds,
            all_reduce_calls=tp.calls, all_reduce_bytes=tp.bytes,
            launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del y
    return out


def _tp_request_rank(tp, seconds, out_dir):
    """One rank of the tp = 2 pipeline answering the 5 s path's image and
    video requests (prompts, seed, weights and VAE as phase 4's); rank 0
    decodes (tiled) and writes."""
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel.sharding import fast_init_dit_shard
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = load_config(os.path.join(CONFIG_DIR, CONF5))
    dit = fast_init_dit_shard(conf.model.dit_params, tp, seed=0)
    vae = None
    if tp.rank == 0:
        vae = HunyuanVideoVAE(init_vae_params(device=tp.device,
                                              dtype=torch.bfloat16, seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, SeededEmbedder(), vae, tp=tp)
    requests = [("tp2 image", "a smoke-test image", 0, (1, 1, 512, 768, 3),
                 "tp2_image.png"), _video("tp2", seconds, VIDEO_PROMPT)]
    report, frames = [], None
    _kernels.reset_launches()
    for name, prompt, tl, shape, fname in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        frames = pipe(prompt, time_length=tl, width=768, height=512, seed=42,
                      expand_prompts=False,
                      save_path=os.path.join(out_dir, fname))
        wall = time.perf_counter() - t
        tm = dict(pipe.timings)
        line = dict(request=name, rank=tp.rank, wall_s=wall,
                    s_per_step=tm["denoise_s"] / tm["steps"],
                    denoise_s=tm["denoise_s"], steps=tm["steps"],
                    all_reduce_s=tm["all_reduce_s"],
                    all_reduce_calls=tm["all_reduce_calls"],
                    all_reduce_bytes=tm["all_reduce_bytes"],
                    latents_finite=tm["latents_finite"])
        if tp.rank == 0:
            saved = tm["saved"][0]
            line.update(decode_s=tm["decode_s"], saved=saved,
                        saved_bytes=os.path.getsize(saved),
                        frames=list(frames.shape),
                        frames_ok=bool(frames.shape == shape
                                       and frames.dtype == np.uint8
                                       and float(frames.std()) > 0.0))
        elif frames is not None:
            raise Failure(f"rank {tp.rank} returned frames")
        report.append(line)
    return dict(report=report, launches=dict(_kernels.LAUNCHES),
                video=frames)


def tp_forwards(dev, cfg, seed: int = TP_SEED):
    """One DiT forward at full width and depth at the 5 s shape on one
    device, then as tp = 2 and tp = 4 ranks sharing the card over gloo, each
    held against it with TP_BOUND and with the controls, which must fail
    it; launch counts per rank exact. Weights and inputs seeded with
    ``seed``. Returns the launches, the report and what failed."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import dit_forward, fast_init_dit_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.parallel import launch

    n_text, n_vis = cfg.num_text_blocks, cfg.num_visual_blocks
    dit = fast_init_dit_params(cfg, device=dev, seed=seed)
    args = tp_inputs(cfg, dev, seed)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t = time.perf_counter()
    ref = dit_forward(dit, *args, scale_factor=(1.0, 2.0, 2.0))
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t
    got1 = dict(_kernels.LAUNCHES)
    ref = ref.float().cpu()
    del dit, args
    torch.cuda.empty_cache()
    log(f"  tp 1 (seed {seed}): forward {wall1:.3f} s, output {tuple(ref.shape)}, launches "
        f"K1 {got1['K1_flash_fixed']} K2 {got1['K2_ff_mod']} K8 "
        f"{got1['K8_ff']}")
    # K2 takes the visual blocks only: the 256-row text blocks run the
    # chain, as the JAX package's gate declines them
    want1 = {"K1_flash_fixed": n_text + n_vis, "K2_ff_mod": n_vis,
             "K8_ff": 0}
    wrong = {k: (got1[k], n) for k, n in want1.items() if got1[k] != n}
    if wrong or not bool(torch.isfinite(ref).all()):
        raise Failure(f"tp 1 forward: launches (got, want) {wrong}")

    launches, report, failed = {}, [], []
    want = {"K8_ff": n_vis, "K1_flash_fixed": n_text + n_vis, "K2_ff_mod": 0}
    for world in TP_WORLDS:
        t = time.perf_counter()
        res = launch(_tp_forward_rank, world, "gloo", "cuda",
                     args=(dataclasses.asdict(cfg), TP_CONTROLS, seed),
                     timeout=900)
        total = time.perf_counter() - t
        line = dict(request=f"tp{world} forward", seed=seed, launch_s=total,
                    wall_s=[r["sound"]["wall_s"] for r in res],
                    all_reduce_s=[r["sound"]["all_reduce_s"] for r in res],
                    build_s=[r["build_s"] for r in res],
                    peak_gib=[r["sound"]["peak_gib"] for r in res],
                    params_per_rank=res[0]["params"])
        bad = []
        for rank, r in enumerate(res):
            s = r["sound"]
            rel, max_abs = _rel(s["y"], ref), (s["y"] - ref).abs().max().item()
            line.setdefault("rel_l2", []).append(rel)
            wrong = {k: (s["launches"][k], n) for k, n in want.items()
                     if s["launches"][k] != n}
            log(f"  tp {world} rank {rank}: forward {s['wall_s']:.3f} s, "
                f"all-reduce {s['all_reduce_s']:.3f} s in "
                f"{s['all_reduce_calls']} calls ({s['all_reduce_bytes'] / 2**30:.2f}"
                f" GiB; gloo through the host, {world} ranks on one card), "
                f"build {r['build_s']:.1f} s, {r['params']} params, peak "
                f"{s['peak_gib']:.2f} GiB; against tp 1: rel_l2 {rel:.3e} "
                f"max_abs {max_abs:.3e} (bound {TP_BOUND}); launches K8 "
                f"{s['launches']['K8_ff']} K1 {s['launches']['K1_flash_fixed']}"
                f" K2 {s['launches']['K2_ff_mod']}")
            if (wrong or rel > TP_BOUND or s["all_reduce_calls"] != 3 * n_vis
                    or not torch.equal(s["y"], res[0]["sound"]["y"])):
                bad.append(f"rank {rank}: rel_l2 {rel:.3e}, launches (got, "
                           f"want) {wrong}, {s['all_reduce_calls']} "
                           "all-reduces, or unlike rank 0")
        for name in TP_CONTROLS:
            c = res[0][name]
            rel = _rel(c["y"], ref)
            line[f"{name}_rel_l2"] = rel
            fails = rel > TP_BOUND
            log(f"  tp {world} control ({name}): rel_l2 {rel:.3e} "
                f"{'fails the bound' if fails else 'PASSES'}")
            if not fails:
                bad.append(f"control {name} passes the bound")
        launches[f"tp{world}-forward"] = {
            k: sum(r["sound"]["launches"][k] for r in res) for k in got1}
        report.append(line)
        del res
        if bad:
            failed.append(f"tp {world} forward (seed {seed}): "
                          f"{'; '.join(bad)}")
    return launches, report, failed


def phase_tp(dev, conf5, seconds5: int, tiled_frames, out_dir: str):
    """(a) :func:`tp_forwards` at TP_SEED. (b) The tp = 2 pipeline answers
    the 5 s path's image and video requests; the video's frames against
    phase 4's tiled decode of the same request (PSNR)."""
    from kandinsky5_tpu_torch.parallel import launch

    launches, report, failed = tp_forwards(dev, conf5.model.dit_params)
    if failed:
        raise Failure("; ".join(failed))
    n_text = conf5.model.dit_params.num_text_blocks
    n_vis = conf5.model.dit_params.num_visual_blocks
    log(f"  tp 2 pipeline ({os.path.basename(CONF5)}, {conf5.model.num_steps}"
        " steps): the image and the video requests, rank 0 decodes tiled")
    res = launch(_tp_request_rank, 2, "gloo", "cuda",
                 args=(seconds5, out_dir), timeout=900)
    steps = conf5.model.num_steps
    want = {"K8_ff": 2 * n_vis * steps,
            "K1_flash_fixed": 2 * (n_text + n_vis) * steps, "K2_ff_mod": 0}
    bad = []
    for rank, r in enumerate(res):
        got = r["launches"]
        wrong = {k: (got[k], n) for k, n in want.items() if got[k] != n}
        decoded = got["K3_conv3d"] + got["K3_conv3d_fused"]
        if wrong or (decoded > 0) != (rank == 0):
            bad.append(f"rank {rank}: launches (got, want) {wrong}, K3 "
                       f"{decoded}")
        for line in r["report"]:
            share = line["all_reduce_s"] / line["denoise_s"]
            line["all_reduce_share"] = share
            log(f"  {line['request']} rank {rank}: {line['s_per_step']:.4f} "
                f"s/step ({line['steps']} steps), all-reduce "
                f"{line['all_reduce_s']:.3f} s in {line['all_reduce_calls']} "
                f"calls = {share:.3f} of the denoise (gloo through the host, "
                "2 ranks on one card)"
                + (f"; decode (tiled) {line['decode_s']:.3f} s, frames "
                   f"{line['frames']}, wrote {line['saved']} "
                   f"({line['saved_bytes']} bytes)" if rank == 0 else ""))
            if not line["latents_finite"] or (rank == 0
                                               and not line["frames_ok"]):
                bad.append(f"{line['request']} rank {rank}: bad output")
            report.append(line)
    db = psnr(res[0]["video"], tiled_frames)
    res[0]["report"][-1]["psnr_vs_tp1_tiled_db"] = db
    log(f"  tp 2 video: frame PSNR against the tp 1 request's tiled decode "
        f"{db:.2f} dB")
    launches["tp2-requests"] = {
        k: sum(r["launches"][k] for r in res) for k in res[0]["launches"]}
    if bad:
        raise Failure("tp 2 requests: " + "; ".join(bad))
    return launches, report


def tp_seed_study(dev, seeds) -> int:
    """Phase 5's tp forwards and controls for each seed; prints one JSON
    line of readings. 0 when every seed's sound runs pass TP_BOUND and
    every control fails it."""
    from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
    from kandinsky5_tpu_torch.tools import gpu_line

    cfg = load_config(os.path.join(CONFIG_DIR, CONF5)).model.dit_params
    rows, failed = [], []
    for seed in seeds:
        t = time.perf_counter()
        _, report, bad = tp_forwards(dev, cfg, seed)
        failed += bad
        for line in report:
            rows.append({k: line[k] for k in (
                "request", "seed", "rel_l2", "no_ff_all_reduce_rel_l2",
                "bias_on_every_rank_rel_l2", "wall_s", "all_reduce_s")})
        log(f"  seed {seed}: {time.perf_counter() - t:.1f} s")
    log(gpu_line())
    log(json.dumps({"tp_bound": TP_BOUND, "tp_seeds": rows,
                    "failed": failed}))
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=1, choices=(1, 5, 10),
                    help="1 or 5: the 5 s path's video length (the 10 s path "
                    "answers 2 s); 10: the 10 s path answers 10 s (the 5 s "
                    "path 1 s)")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the written image and videos")
    ap.add_argument("--tp-seeds", default=None,
                    help="comma-separated seeds: build, then run only phase "
                    "5's tp forwards and controls with each seed's weights "
                    "and inputs, and print their readings (a study of "
                    "TP_BOUND; no smoke result)")
    ap.add_argument("--k1", action="store_true",
                    help="build, then run only phase 2's K1 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--k4", action="store_true",
                    help="build, then run only phase 2's K4 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--k6", action="store_true",
                    help="build, then run only phase 2's K6 cases and print "
                    "their readings (no smoke result)")
    ap.add_argument("--ff", action="store_true",
                    help="build, then run only phase 2's K2 (with its "
                    "modulation pass), K8 and T2-T4 cases and print their "
                    "readings (no smoke result)")
    ap.add_argument("--gemm", action="store_true",
                    help="build, then run only phase 2's T1, T2, K8, T3 and "
                    "T4 cases and print their readings (no smoke result)")
    ap.add_argument("--int8", action="store_true",
                    help="build, then run only phase 2's K5, K7 and T5 cases "
                    "and print their readings (no smoke result)")
    ap.add_argument("--k3", action="store_true",
                    help="build, then run only phase 2's K3 cases (classes, "
                    "modes, ragged cases) and print their readings (no smoke "
                    "result)")
    args = ap.parse_args()
    seconds5 = 1 if args.seconds == 10 else args.seconds
    seconds10 = 10 if args.seconds == 10 else 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
        from kandinsky5_tpu_torch.ops import _kernels
        from kandinsky5_tpu_torch.tools import gpu_line
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    try:
        log("phase 1: build")
        _kernels.build(force=True)
        info = _kernels.BUILD_INFO
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "Performance Loss" in line:
                log("  " + line.strip())
        log(f"  build {info['seconds']:.1f} s")
        _kernels.library()
        if args.tp_seeds:
            return tp_seed_study(dev, [int(v) for v in args.tp_seeds.split(",")])
        if args.k1:
            results = {}
            phase_k1(dev, *_seeded(dev), results)
            log(gpu_line())
            log(json.dumps({"K1_flash_fixed": results["K1_flash_fixed"]}))
            return 0 if all(r["ok"] for r in results["K1_flash_fixed"]) else 1
        if args.int8:
            results = {}
            phase_int8(dev, *_seeded(dev), results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.k3:
            results = {}
            phase_k3(dev, _seeded(dev)[0], results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.ff:
            results = {}
            g = _seeded(dev)[0]
            phase_k2(dev, g, results)
            phase_ff_tools(dev, g, results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.gemm:
            results = {}
            phase_gemm(dev, _seeded(dev)[0], results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1
        if args.k4 or args.k6:
            results = {}
            g, normed = _seeded(dev)
            if args.k4:
                phase_k4(dev, g, results)
            if args.k6:
                phase_k6(dev, g, normed, results)
            log(gpu_line())
            log(json.dumps(results))
            return 0 if all(r["ok"] for rs in results.values() for r in rs) else 1

        log("phase 2: kernels vs plain versions (bf16, main-path shapes)")
        t = time.perf_counter()
        results = {}
        phase_kernels(dev, results)
        log(f"  phase 2 {time.perf_counter() - t:.1f} s")

        conf5 = load_config(os.path.join(CONFIG_DIR, CONF5))
        conf10 = load_config(os.path.join(CONFIG_DIR, CONF10))
        log("phase 3: small-input reference (card kernels vs CPU plain, fp32)")
        t = time.perf_counter()
        phase_reference(dev, conf5)
        log(f"  phase 3 {time.perf_counter() - t:.1f} s")

        log("phase 4: pipeline at full width")
        t = time.perf_counter()
        launches, report, tiled = phase_pipeline(dev, conf5, conf10, seconds5,
                                                 seconds10, args.out)
        log(f"  phase 4 {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()

        log("phase 5: tensor parallelism, 2 and 4 ranks sharing the card "
            "(gloo)")
        t = time.perf_counter()
        tp_launches, tp_report = phase_tp(dev, conf5, seconds5, tiled,
                                          args.out)
        launches.update(tp_launches)
        report += tp_report
        log(f"  phase 5 {time.perf_counter() - t:.1f} s")
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_all:.1f} s")

    kernels = []
    for name, (source, replaces) in ROUTE_SOURCES.items():
        rs = results[name]
        h = rs[HEADLINE[name]]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(n[name] for n in launches.values()),
                 "launches_by_path": {p: n[name] for p, n in launches.items()},
                 "on_path": name not in TOOLS,
                 "max_abs_err": max(r["max_abs"] for r in rs),
                 "ms": h["ms"], "plain_ms": h["plain_ms"],
                 "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                 "library_ms": h["library_ms"], "shape": h["shape"]}
        if name == "T5_i8_decomp":
            # garbage outputs of any scale: the error relative to each
            # mode's largest plain output
            entry["max_abs_err"] = max(r["max_abs"] / r["scale"] for r in rs)
            entry["max_abs_err_is"] = "relative to the largest plain output"
        if h["yardstick_ms"] is not None:
            entry["yardstick_ms"] = h["yardstick_ms"]
            entry["yardstick"] = h["yardstick"]
        if name == "K6_sparse_nabla":
            entry["cases"] = [{k: r[k] for k in (
                "shape", "density", "ms", "plain_ms", "bound_ms",
                "library_ms", "k1_dense_ms", "tflops")} for r in rs]
        elif len(rs) > 1:
            entry["cases"] = [{k: r[k] for k in (
                "shape", "max_abs", "rel", "ms", "plain_ms", "bound_ms",
                "library_ms", "yardstick_ms") + tuple(
                    x for x in ("rel_l2_vs_k1", "max_abs_vs_k5", "tflops",
                                "bound_share", "factor", "bf16_k3_ms")
                    if x in r)}
                for r in rs]
        kernels.append(entry)
    log(gpu_line())
    log(json.dumps({"kernels": kernels, "requests": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
