#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kandinsky5_tpu_torch``) on one CUDA GPU.

    python3 chip_smoke.py [--seconds 1|5] [--out DIR]

Phases, each of which must pass (any failure exits nonzero):
  1. build   — compile the hand-written kernels (csrc/*.cu, nvcc sm_90a)
               and print ptxas' register / shared-memory / spill report;
  2. kernels — K1-K4 against their plain PyTorch versions on the card, in
               bf16, at the shapes the 5 s distil path gives them (every
               decoder conv class for K3, both K3 modes), with max-abs and
               relative-L2 errors against stated tolerances and CUDA-event
               times of kernel and plain version;
  3. reference — a cut-depth, full-width DiT and the full-width VAE decode
               on a small input (its first chunk large enough for K4), on
               the card (kernels) against the same weights in fp32 on the
               CPU (plain versions);
  4. pipeline — ``Kandinsky5T2VPipeline`` built from config_5s_distil.yaml
               with the full 2B DiT (uniform +-0.02 weights from a seed),
               the full VAE decoder and a seeded stand-in text embedder
               answers two requests: one 512x768 image and one video of
               ``--seconds`` (1 s = 25 frames by default), 16 steps each.
               Every kernel launch counter must be > 0 after them.
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
    "K4_flash_online": ("kandinsky5_tpu_torch/csrc/flash_online.cu",
                        "kandinsky5_tpu/ops/flash_pallas.py:477 _kernel_online"),
}
# bf16 kernel vs plain on the card: both round the same quantities to bf16
# but sum in different orders, so an output may move by a bf16 ulp (2^-8
# relative); bounds are a few ulps at the outputs' scale. The attention
# checks carry a control: uniform weights over the allowed keys (q = 0 in
# the plain version) must fail the same bound, or the inputs are too weak
# to tell a right kernel from one that ignores its scores.
TOL = {"K1_flash_fixed": (3e-2, 1e-2), "K2_ff_mod": (6e-2, 1e-2),
       "K3_conv3d": (6e-2, 1e-2), "K4_flash_online": (3e-2, 1e-2)}


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


def _compare(name, shape, kernel_fn, plain_fn, results, reps=5,
             control_fn=None):
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    torch.cuda.synchronize()
    max_abs, rel = _errors(out, ref)
    atol, rtol = TOL[name]
    ok = max_abs <= atol and rel <= rtol
    note = ""
    if control_fn is not None:
        c_abs, c_rel = _errors(control_fn(), ref)
        control_fails = not (c_abs <= atol and c_rel <= rtol)
        note = (f" control (uniform weights): max_abs {c_abs:.3e} rel_l2 "
                f"{c_rel:.3e} {'fails the bound' if control_fails else 'PASSES'}")
        ok = ok and control_fails
    del out, ref
    ms = _time_ms(kernel_fn, reps)
    plain_ms = _time_ms(plain_fn, 1)
    log(f"  {name} {shape}: max_abs {max_abs:.3e} (tol {atol}) rel_l2 "
        f"{rel:.3e} (tol {rtol}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
        f"{note} {'ok' if ok else 'FAIL'}")
    results.setdefault(name, []).append(dict(shape=shape, max_abs=max_abs,
                                              rel=rel, ms=ms,
                                              plain_ms=plain_ms, ok=ok))
    torch.cuda.empty_cache()


def phase_kernels(dev, results):
    import torch

    from kandinsky5_tpu_torch.ops.conv import causal_conv3d_fused, conv3d_plain
    from kandinsky5_tpu_torch.ops.ff import ff_mod_plain, fused_ff_modulated
    from kandinsky5_tpu_torch.ops.flash import (
        flash_fixed,
        flash_fixed_plain,
        flash_online,
        flash_online_plain,
    )

    g = torch.Generator(device=dev).manual_seed(1234)

    def normed(shape):
        x = torch.randn(shape, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    # K1: visual self-attention at 5 s, 1 s and image size (47,616, 10,752
    # and 1,536 tokens), text self-attention (256 tokens, partly padded)
    for lq, masked in ((47616, False), (10752, False), (1536, False),
                       (256, True)):
        q, k = normed((1, lq, 28, 64)), normed((1, lq, 28, 64))
        v = torch.randn((1, lq, 28, 64), generator=g, device=dev).bfloat16()
        mask = (torch.arange(lq, device=dev) < 77)[None] if masked else None
        _compare("K1_flash_fixed", f"(1,{lq},28,64){' mask' if masked else ''}",
                 lambda: flash_fixed(q, k, v, mask),
                 lambda: flash_fixed_plain(q, k, v, mask), results,
                 reps=3 if lq > 10000 else 20,
                 control_fn=lambda: flash_fixed_plain(q * 0, k, v, mask))
        del q, k, v

    # K2: the visual blocks' modulated FF at 5 s and 1 s, the text blocks'
    d, ff = 1792, 7168
    sc, sh, gt = (torch.randn((1, d), generator=g, device=dev) * 0.1
                  for _ in range(3))
    w1 = (torch.randn((ff, d), generator=g, device=dev) / math.sqrt(d)).bfloat16()
    w2 = (torch.randn((d, ff), generator=g, device=dev) / math.sqrt(ff)).bfloat16()
    for rows in (47616, 10752, 256):
        x = torch.randn((1, rows, d), generator=g, device=dev).bfloat16()
        _compare("K2_ff_mod", f"(1,{rows},{d})x{ff}",
                 lambda: fused_ff_modulated(x, sc, sh, w1, w2, gt),
                 lambda: ff_mod_plain(x, sc, sh, w1, w2, gt), results)
        del x
    del w1, w2

    # K3: every decoder conv class (vae.py:336-385) at the streaming
    # decode's chunk lengths, in both modes
    classes = [(512, 512, 64, 96, 4), (512, 512, 128, 192, 7),
               (512, 512, 256, 384, 13), (512, 256, 256, 384, 13),
               (256, 256, 256, 384, 13), (256, 256, 512, 768, 12),
               (256, 128, 512, 768, 12), (128, 128, 512, 768, 12)]
    for cin, cout, hh, ww, t in classes:
        wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
              / math.sqrt(27 * cin)).bfloat16()
        bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
        for padded in (False, True):
            tin = t + 2 if padded else t
            x = torch.randn((1, tin, hh, ww, cin), generator=g,
                            device=dev).bfloat16()
            _compare("K3_conv3d",
                     f"{cin}->{cout} {t}x{hh}x{ww}"
                     f"{' time_padded' if padded else ''}",
                     lambda: causal_conv3d_fused(x, wt, bias, padded),
                     lambda: conv3d_plain(x, wt, bias, padded), results,
                     reps=2)
            del x

    # K4: the streaming mid attention's first full chunk: 4 frames of
    # 64x96 latents against 4 carried + 4 chunk frames, ids and buffer mask.
    # Unit q and k give scores of standard deviation 1 (spread over several
    # units across the 49,152 keys), so the weights are far from uniform.
    s, past, t = 6144, 4, 4
    q = torch.randn((1, t * s, 1, 512), generator=g, device=dev).bfloat16()
    k = torch.randn((1, (past + t) * s, 1, 512), generator=g, device=dev).bfloat16()
    v = torch.randn((1, (past + t) * s, 1, 512), generator=g, device=dev).bfloat16()
    slot = torch.arange(past, device=dev)
    kv_ids = torch.cat([slot.repeat_interleave(s),
                        (past + torch.arange(t, device=dev)).repeat_interleave(s)])[None]
    q_ids = kv_ids[:, past * s:]
    mask = torch.cat([(slot >= 2).repeat_interleave(s),
                      torch.ones(t * s, dtype=torch.bool, device=dev)])[None]
    _compare("K4_flash_online", f"q {t * s} kv {(past + t) * s} d 512",
             lambda: flash_online(q, k, v, mask, q_ids, kv_ids),
             lambda: flash_online_plain(q, k, v, mask, q_ids, kv_ids), results,
             control_fn=lambda: flash_online_plain(q * 0, k, v, mask, q_ids,
                                                   kv_ids))
    bad = [(n, r["shape"]) for n, rs in results.items() for r in rs if not r["ok"]]
    if bad:
        raise Failure(f"kernels outside tolerance: {bad}")


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


def phase_reference(dev, conf):
    """DiT (full width, 2 text + 2 visual blocks) and the VAE decoder on a
    small input: bf16 kernels on the card vs the same bf16 weights in fp32
    through the plain versions on the CPU. The VAE latent (1, 5, 16, 32)
    decodes in a 4-frame chunk of 4 * 512 = 2048 tokens, the size at which
    mid attention goes to K4, then a 1-frame chunk that carries the K/V
    buffer. bf16 activations through a few blocks keep about 2-3
    significant digits, so the bound is a relative L2 error of 5e-2; a
    wrong layout or index gives errors near 1."""
    import dataclasses

    import torch

    from kandinsky5_tpu_torch.models.dit import dit_forward, fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import init_vae_params
    from kandinsky5_tpu_torch.models.vae_stream import streaming_decode
    from kandinsky5_tpu_torch.ops import _kernels

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
    del dit, dit_cpu

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
    if not (e_dit < 5e-2 and e_vae < 5e-2):
        raise Failure(f"path disagrees with its CPU reference: DiT {e_dit}, "
                      f"VAE {e_vae}")
    if min(launched["K1_flash_fixed"], launched["K2_ff_mod"],
           launched_v["K3_conv3d"], launched_v["K4_flash_online"]) == 0:
        raise Failure("the reference run missed a kernel: DiT "
                      f"{launched}, VAE {launched_v}")
    return {"dit_rel_l2": e_dit, "vae_rel_l2": e_vae}


# ---------------------------------------------------------------------------
# phase 4: the pipeline at full width
# ---------------------------------------------------------------------------

def phase_pipeline(dev, conf, seconds: int, out_dir: str):
    import numpy as np
    import torch

    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.ops import _kernels
    from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

    t0 = time.perf_counter()
    dit = fast_init_dit_params(conf.model.dit_params, device=dev,
                               dtype=torch.bfloat16, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(device=dev, dtype=torch.bfloat16,
                                          seed=1))
    pipe = Kandinsky5T2VPipeline(dit, conf, SeededEmbedder(), vae)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in dit.parameters())
    log(f"  built: DiT {n_params} params, VAE decoder; "
        f"{time.perf_counter() - t0:.1f} s")

    os.makedirs(out_dir, exist_ok=True)
    requests = [("image", 0, (1, 1, 512, 768, 3), "image.png"),
                (f"video {seconds}s", seconds,
                 (1, 4 * (seconds * 24 // 4) + 1, 512, 768, 3),
                 f"video_{seconds}s.mp4")]
    _kernels.reset_launches()
    report = []
    for name, tl, shape, fname in requests:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        frames = pipe(f"a smoke-test {name}", time_length=tl, width=768,
                      height=512, seed=42, expand_prompts=False,
                      save_path=os.path.join(out_dir, fname))
        wall = time.perf_counter() - t
        tm = dict(pipe.timings)
        peak = torch.cuda.max_memory_allocated()
        steps = tm["steps"]
        saved = tm["saved"][0]
        if not os.path.isfile(saved) or os.path.getsize(saved) == 0:
            raise Failure(f"{name}: nothing written at {saved}")
        log(f"  {name}: frames {frames.shape} {frames.dtype}; denoise "
            f"{tm['denoise_s']:.3f} s ({tm['denoise_s'] / steps:.4f} s/step, "
            f"{steps} steps, cfg {tm['cfg']}); decode {tm['decode_s']:.3f} s; "
            f"wall {wall:.3f} s; peak memory {peak / 2**30:.2f} GiB; "
            f"wrote {saved} ({os.path.getsize(saved)} bytes)")
        if frames.shape != shape or frames.dtype != np.uint8:
            raise Failure(f"{name}: frames {frames.shape} {frames.dtype}, "
                          f"expected {shape} uint8")
        if not tm["latents_finite"]:
            raise Failure(f"{name}: non-finite latents")
        if float(frames.std()) == 0.0:
            raise Failure(f"{name}: constant frames")
        report.append(dict(request=name, s_per_step=tm["denoise_s"] / steps,
                           denoise_s=tm["denoise_s"], decode_s=tm["decode_s"],
                           peak_gib=peak / 2**30))
    launches = dict(_kernels.LAUNCHES)
    log(f"  kernel launches over the two requests: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise Failure(f"main path never launched {missing}")
    return launches, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=int, default=1, choices=(1, 5),
                    help="length of the video request")
    ap.add_argument("--out", default="smoke_out",
                    help="directory for the written image and video")
    args = ap.parse_args()

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
                    or "spill" in line:
                log("  " + line.strip())
        log(f"  build {info['seconds']:.1f} s")
        _kernels.library()

        log("phase 2: kernels vs plain versions (bf16, main-path shapes)")
        results = {}
        phase_kernels(dev, results)

        conf = load_config(os.path.join(CONFIG_DIR, "config_5s_distil.yaml"))
        log("phase 3: small-input reference (card kernels vs CPU plain, fp32)")
        phase_reference(dev, conf)

        log(f"phase 4: pipeline at full width ({conf.model.num_steps} steps,"
            f" guidance {conf.model.guidance_weight})")
        launches, report = phase_pipeline(dev, conf, args.seconds, args.out)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_all:.1f} s")

    headline = {"K1_flash_fixed": 0, "K2_ff_mod": 0, "K3_conv3d": -1,
                "K4_flash_online": 0}
    kernels = []
    for name, (source, replaces) in ROUTE_SOURCES.items():
        rs = results[name]
        h = rs[headline[name]]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs"] for r in rs),
                        "ms": h["ms"], "plain_ms": h["plain_ms"],
                        "shape": h["shape"]})
    log(gpu_line())
    log(json.dumps({"kernels": kernels, "requests": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
