"""Where the time goes on the card: one DiT forward and one VAE decode, at
full width with random weights: the 5 s distil path (dense attention) for
``--seconds 1|5``, the 10 s NABLA path (``config_10s_distil.yaml``: 93,696
tokens, 241 frames) for ``--seconds 10``.

    python -m kandinsky5_tpu_torch.tools.profile_step [--seconds 1|5|10]
        [--attn auto|flash_int8|flash_int8_pipe] [--int8-linear]
        [--dit-only | --decode-only] [--decode stream|tiled] [--int8-conv]
        [--fuse-gn auto|on|off]

``--attn`` picks the DiT's attention (K1, K5 or K7 for self-attention) and
``--int8-linear`` makes its visual projections W8A8; ``--dit-only`` skips
the decode and ``--decode-only`` the DiT forward. ``--decode`` picks the streaming decode (the default) or the
reference's overlap-tiled one (GroupNorm folded into K3), ``--int8-conv``
runs the decoder's convs W8A8, and ``--fuse-gn`` sets the VAE's ``fuse_gn``
(auto: fused in the tiled decode, unfused in the streaming one; on or off
in both). For each of the two it prints the unprofiled wall time (host
clock around a synchronized call, the minimum of a few repeats), the device
time that ``torch.profiler`` records per kernel, grouped into the port's
kernels K1-K7, int8 and other library GEMMs/convs and elementwise passes,
and the device's idle share. It also prints the device time under the
``record_function`` ranges of the port: each stage of the NABLA mask build
(``nabla_mask.*`` in ``ops/nabla.py``: pooled map and softmax, sort, cumsum
and scatter, kv lists), the int8-QK pre-pass (``pack_int8``) and the W8A8
linears (``int8_linear``: activation quantization, ``torch._int_mm``,
dequant), whose kernels the groups above also count; and on the NABLA path
the masks' mean kept fraction. The idle
share comes from the profiled call's own trace: the time between the
first device activity's start and the last one's end, less the union of
the activities' intervals, over that span. The profiler adds host time per
launch, so the share is an upper bound for the unprofiled call. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from kandinsky5_tpu_torch.config import CONFIG_DIR, load_config
from kandinsky5_tpu_torch.models.dit import (
    dit_forward,
    fast_init_dit_params,
    quantize_dit_params,
)
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.ops.nabla import record_density
from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
from kandinsky5_tpu_torch.sampling import _build_sparse, token_grid
from kandinsky5_tpu_torch.tools import gpu_line

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
# profiler ranges (record_function name prefix -> what they hold) whose
# device time is printed apart
RANGES = {"nabla_mask.": "NABLA mask build",
          "k4_plan": "K4's work tables (ops/flash.online_plan)",
          "pack_int8": "int8-QK pre-pass",
          "int8_linear": "W8A8 linears (quantize x, torch._int_mm, dequant)"}
# profiler rows that are host-side API calls, markers or the ranges above
# (a range's row carries the device time of the kernels inside it, which
# their own rows already count), not kernels
_NOT_KERNELS = ("Command Buffer Full", "cuLaunch", "cuda", "aten::") \
    + tuple(RANGES)


def group_of(kernel: str) -> str:
    """The group of :data:`GROUPS` a kernel's profiler name falls under
    (its first match), else "other"."""
    key = kernel.lower()
    return next((g for g, pats in GROUPS if any(p in key for p in pats)),
                "other")


def busy_and_span(intervals) -> dict:
    """Device occupancy of one trace from its activities' (start, end)
    intervals (any unit): ``span`` from the first start to the last end,
    ``busy`` the length of the intervals' union, ``summed`` their plain sum
    (above ``busy`` only where activities overlapped) and the idle share
    ``1 - busy / span``."""
    spans = sorted(intervals)
    if not spans:
        return {"span": 0.0, "busy": 0.0, "summed": 0.0, "idle": float("nan")}
    first, last = spans[0][0], max(e for _, e in spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = last - first
    return {"span": span, "busy": busy,
            "summed": sum(e - s for s, e in spans),
            "idle": 1 - busy / span if span > 0 else float("nan")}


def device_intervals(prof) -> list:
    """(start, end) in microseconds of every device activity in a finished
    profile: kernels, copies and fills."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type.name == "CUDA"
            and not e.key.startswith(_NOT_KERNELS)
            and e.time_range.end > e.time_range.start]


def device_times(prof) -> dict:
    """{kernel name: (device ms, calls)} from a finished profile."""
    rows = {}
    for e in prof.key_averages():
        ms = (getattr(e, "device_time_total", 0.0) or 0.0) / 1e3
        if ms <= 0 or e.device_type.name != "CUDA" \
                or e.key.startswith(_NOT_KERNELS):
            continue
        rows[e.key] = (ms, e.count)
    return rows


def range_times(prof, prefix: str) -> dict:
    """{range name: (device ms of the kernels launched inside, calls)} for
    the record_function ranges whose name starts with ``prefix``."""
    rows = {}
    for e in prof.key_averages():
        ms = (getattr(e, "device_time_total", 0.0) or 0.0) / 1e3
        if e.key.startswith(prefix):
            rows[e.key] = (ms, e.count)
    return rows


def measure(label: str, fn, reps: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    fn()  # first call: kernel build and allocator warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_times(prof)
    total = sum(ms for ms, _ in rows.values())
    occ = busy_and_span(device_intervals(prof))
    print(f"== {label}: unprofiled wall {wall:.1f} ms (min of "
          f"{', '.join(f'{w:.1f}' for w in walls)}); device kernel time "
          f"{total:.1f} ms over {len(rows)} kernels; profiled trace: span "
          f"{occ['span'] / 1e3:.1f} ms, busy {occ['busy'] / 1e3:.1f} ms, "
          f"idle share {occ['idle']:.4f}", flush=True)
    if occ["summed"] > occ["span"]:
        print(f"   warning: device activities overlapped (their sum, "
              f"{occ['summed'] / 1e3:.1f} ms, exceeds the span)", flush=True)
    grouped: dict = {}
    for key, (ms, n) in rows.items():
        acc = grouped.setdefault(group_of(key), [0.0, 0])
        acc[0] += ms
        acc[1] += n
    for name, (ms, n) in sorted(grouped.items(), key=lambda kv: -kv[1][0]):
        print(f"   {ms:10.1f} ms {100 * ms / total:5.1f}%  x{n:<6d} {name}")
    for key, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"     top: {ms:9.1f} ms x{n:<5d} {key[:100]}")
    for prefix, label in RANGES.items():
        ranges = range_times(prof, prefix)
        if not ranges:
            continue
        in_ranges = sum(ms for ms, _ in ranges.values())
        print(f"   {label} (device time under the {prefix}* ranges, counted "
              f"in the groups above): {in_ranges:.1f} ms, "
              f"{100 * in_ranges / total:.1f}% of the kernel time")
        for key, (ms, n) in sorted(ranges.items()):
            print(f"     {ms:10.1f} ms x{n:<5d} {key}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=5, choices=(1, 5, 10))
    ap.add_argument("--attn", default="auto",
                    choices=("auto", "flash_int8", "flash_int8_pipe"))
    ap.add_argument("--int8-linear", action="store_true")
    ap.add_argument("--dit-only", action="store_true")
    ap.add_argument("--decode-only", action="store_true",
                    help="skip the DiT forward: profile the decode alone")
    ap.add_argument("--decode", default="stream", choices=("stream", "tiled"))
    ap.add_argument("--int8-conv", action="store_true")
    ap.add_argument("--fuse-gn", default="auto", choices=("auto", "on", "off"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(gpu_line())

    name = "config_10s_distil.yaml" if args.seconds == 10 \
        else "config_5s_distil.yaml"
    conf = load_config(os.path.join(CONFIG_DIR, name))
    cfg = conf.model.dit_params
    t_lat = args.seconds * 24 // 4 + 1
    h_lat, w_lat = 512 // 8, 768 // 8
    latent = (1, t_lat, h_lat, w_lat, cfg.visual_embed_dim)
    tokens = math.prod(token_grid(cfg, latent))
    # the sampler's own spec and sparse parameters for this config
    spec = Kandinsky5T2VPipeline(None, conf)._spec(conf.model.num_steps,
                                                   1.0, 5.0)
    sparse = _build_sparse(spec, token_grid(cfg, latent), dev)
    g = torch.Generator(device=dev).manual_seed(0)

    if args.decode_only:
        decode(args, t_lat, h_lat, w_lat, g, dev)
        return
    dit = fast_init_dit_params(cfg, device=dev, seed=0)
    if args.int8_linear:
        dit = quantize_dit_params(dit)
    # conditioning at the text towers' widths, a partly padded mask
    text = torch.randn((1, 256, cfg.in_text_dim), generator=g, device=dev)
    pooled = torch.randn((1, cfg.in_text_dim2), generator=g, device=dev)
    mask = (torch.arange(256, device=dev) < 100)[None]
    x = torch.randn(latent, generator=g, device=dev).bfloat16()
    step = torch.tensor([500.0], device=dev)
    with record_density() as kept:
        measure(f"one {args.seconds} s DiT forward ({tokens} tokens, "
                f"{spec.attention_type} attention, attn_impl {args.attn}"
                f"{', W8A8 projections' if args.int8_linear else ''}, {name})",
                lambda: dit_forward(dit, x, text, pooled, step, mask,
                                    scale_factor=conf.metrics.scale_factor,
                                    attn_impl=args.attn, sparse=sparse),
                reps=2)
    if kept:
        print(f"   NABLA masks: {len(kept)} built, mean kept fraction "
              f"{float(torch.stack(kept).mean()):.4f}")
    del dit
    torch.cuda.empty_cache()
    if args.dit_only:
        print(gpu_line())
        return
    decode(args, t_lat, h_lat, w_lat, g, dev)


def decode(args, t_lat: int, h_lat: int, w_lat: int, g, dev) -> None:
    """Profile one VAE decode of seeded latents (the DiT released)."""
    fuse_gn = {"auto": None, "on": True, "off": False}[args.fuse_gn]
    vae = HunyuanVideoVAE(init_vae_params(device=dev, seed=1),
                          fuse_gn=fuse_gn, int8_conv=args.int8_conv)
    z = torch.randn((1, t_lat, h_lat, w_lat, 16), generator=g,
                    device=dev).bfloat16()
    torch.cuda.reset_peak_memory_stats()
    measure(f"{args.seconds} s {args.decode} decode ({t_lat} latent -> "
            f"{4 * (t_lat - 1) + 1} frames"
            f"{', int8 convs' if args.int8_conv else ''}, fuse_gn "
            f"{args.fuse_gn})",
            lambda: vae.decode(z, mode=args.decode), reps=1)
    print(f"   decode peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    print(gpu_line())


if __name__ == "__main__":
    main()
