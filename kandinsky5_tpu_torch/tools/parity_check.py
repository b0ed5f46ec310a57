"""The parity gate's consumer: run the port on a reference dump and read
how close it comes.

The dump (``--make-reference-dump`` of the JAX package's
``tools/parity_check.py``, run where the PyTorch reference and the weights
are) holds the reference's initial ``noise``, its final pre-VAE
``latents``, its decoded uint8 ``frames``, its text conditioning
(``cond_*`` and ``uncond_*``: ``text_embeds``, ``pooled_embed``) and the
``prompt`` and ``negative``. This tool encodes that prompt and negative
with the port's own towers (Qwen2.5-VL and CLIP), integrates the port from
that noise on that conditioning at the pipeline's default scheduler scale,
through the faithful paths (bf16 attention, K1; the tiled decode, as the
reference decodes), and reports the latents' distance and the frame PSNR
against the gate's 35 dB target. The dump's embeddings triage the towers:
their max error is printed beside the gate. Then, where the pipeline's own
defaults differ (its attention or its decode mode), the same reading of
the shipped path, as a second number that is not the gate.

    python -m kandinsky5_tpu_torch.tools.parity_check \\
        --config kandinsky5_tpu_torch/configs/config_5s_distil.yaml \\
        --reference-dump ref_dump.npz

It runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from kandinsky5_tpu_torch.utils.metrics import latent_stats, psnr

#: the gate's target: decoded-frame PSNR against the reference, in dB
TARGET_DB = 35.0

#: The gate's VAE decode mode: the reference decodes tiled; the streaming
#: decode is the pipeline's faster default, read as a second number.
GATE_DECODE_MODE = "tiled"


def faithful_spec(spec):
    """The gate's sampling spec: the bf16 attention kernel (K1), whatever
    the pipeline's default. The reference computes attention in bf16; the
    int8 options' cost is the second reading."""
    return dataclasses.replace(spec, attn_impl="auto")


def _batched(a, ndim: int) -> np.ndarray:
    """A writable copy of ``a`` with a batch axis of one added when it has
    ``ndim - 1`` axes."""
    a = np.array(a)
    return a[None] if a.ndim == ndim - 1 else a


def _encode(pipe, text: str, kind: str) -> dict:
    with pipe._staged("text"):
        return pipe._encode([text], kind)


def text_triage(c: dict, dump: dict, key: str) -> Optional[float]:
    """Max abs error of the towers' conditioning ``c`` (padded, masked)
    against the dump's ``<key>_text_embeds`` (the reference packs a
    prompt's valid tokens); inf when the counts of valid tokens differ,
    None when the dump has no embeddings."""
    if f"{key}_text_embeds" not in dump:
        return None
    ref = np.asarray(dump[f"{key}_text_embeds"], np.float32)
    ref = ref.reshape(-1, ref.shape[-1])
    ours = c["text_embeds"][0][c["mask"][0]].float().cpu().numpy()
    if ours.shape != ref.shape:
        return float("inf")
    return float(np.abs(ours - ref).max())


def run_ours(conf_path, dump: dict, prompt: str = "", pipe=None,
             magcache=None, device=None, log=print) -> dict:
    """Run the port against ``dump`` and read the gate. ``pipe`` may be
    given; by default it is built from the configuration's checkpoints as
    ``get_T2V_pipeline`` builds it. The conditioning comes from the
    pipeline's own towers, so the gate holds them too; the dump's
    embeddings only triage them (``text_err``: the towers' max abs error
    per branch). The timestep grid is the pipeline's default scheduler
    scale, at which the reference's pipeline makes the dump. ``magcache``
    (a ``MagCacheConfig``) runs the sampler on its schedule, for a dump
    taken with the reference's MagCache. Returns the readings: ``psnr_db``
    (the gate), ``latent_stats``, ``latents`` and ``frames`` of the
    faithful run, ``text_err`` and ``fast_psnr_db`` (None when the
    pipeline's defaults are the faithful paths)."""
    from kandinsky5_tpu_torch.pipeline import SCHEDULER_SCALE
    from kandinsky5_tpu_torch.sampling import generate_latents

    if pipe is None:
        from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline

        pipe = get_T2V_pipeline(conf_path=conf_path, device=device)
    dev = pipe.device
    prompt = str(dump.get("prompt", prompt))
    negative = str(dump.get("negative", ""))
    noise = torch.from_numpy(_batched(dump["noise"], 5)).float().to(dev)
    # one latent frame is an image request, as the reference templates it
    kind = "image" if noise.shape[1] == 1 else "video"
    cond, uncond = (_encode(pipe, t, kind) for t in (prompt, negative))
    text_err = {k: text_triage(c, dump, k)
                for k, c in (("cond", cond), ("uncond", uncond))}
    for k, err in text_err.items():
        if err is not None:
            log(f"{k} text_embeds max err vs reference: {err:.3e}")

    m = pipe.conf.model
    spec_fast = pipe._spec(m.num_steps, m.guidance_weight, SCHEDULER_SCALE)
    spec = faithful_spec(spec_fast)
    ref_lat = _batched(dump["latents"], 5)
    ref_frames = np.asarray(dump["frames"])

    def sample(s):
        with pipe._staged("dit"):
            return generate_latents(pipe.dit, s, tuple(noise.shape), cond,
                                    uncond, noise=noise, magcache=magcache)

    latents = sample(spec)
    stats = latent_stats(latents, ref_lat)
    log(f"latents (faithful, {spec.attn_impl}): {stats}")
    frames = pipe.decode_latents(latents, mode=GATE_DECODE_MODE)
    score = psnr(frames.reshape(ref_frames.shape), ref_frames)
    log(f"decoded-frame PSNR [faithful: {spec.attn_impl} attention + "
        f"{GATE_DECODE_MODE} decode]: {score:.2f} dB (target > {TARGET_DB:g})")

    fast_score = None
    if (spec_fast.attn_impl != spec.attn_impl
            or pipe.decode_mode != GATE_DECODE_MODE):
        latents_f = (latents if spec_fast == spec else sample(spec_fast))
        frames_f = pipe.decode_latents(latents_f)
        fast_score = psnr(frames_f.reshape(ref_frames.shape), ref_frames)
        log(f"decoded-frame PSNR [shipped: {spec_fast.attn_impl} attention "
            f"+ {pipe.decode_mode} decode]: {fast_score:.2f} dB (second "
            "reading: the cost of the defaults, not the gate)")
    return {"psnr_db": score, "latent_stats": stats, "latents": latents,
            "frames": frames, "text_err": text_err,
            "fast_psnr_db": fast_score, "passes": score > TARGET_DB}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--reference-dump", required=True)
    p.add_argument("--prompt", default="A dog in red hat")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dump = dict(np.load(args.reference_dump, allow_pickle=True))
    out = run_ours(args.config, dump, args.prompt, device=args.device)
    return 0 if out["passes"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
