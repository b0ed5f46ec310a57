"""Resumable generation: the Euler integration in chunks, with the sampler's
state on disk after each.

Counterpart of ``kandinsky5_tpu/utils/resume.py``. After every chunk of
:func:`~kandinsky5_tpu_torch.sampling.denoise_span` the whole state (the
latents, MagCache's residual and the step reached) is written to one
``.npz``, first to a temporary file that is then renamed over the old one,
so a process killed mid-write leaves the previous state whole. A rerun with
the same path resumes at the saved step; a fingerprint of the spec, the
shape, the seed, the MagCache schedule and the conditioning's bytes keeps a
run from resuming another's state.

The chunks do not change the numbers: ``denoise_span`` carries the latents
and the residual across them exactly, so the chunked trajectory is
bit-identical to one :func:`~kandinsky5_tpu_torch.sampling.generate_latents`
call with the same seed.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from kandinsky5_tpu_torch.config import MagCacheConfig
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    denoise_span,
    seeded_noise,
    skip_schedule,
    timestep_grid,
    zero_residual,
)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _fingerprint(spec: DenoiseSpec, shape, seed: int, cond: dict,
                 uncond: Optional[dict] = None, skip=None) -> str:
    """Who a state file belongs to: the spec, the latent shape, the seed,
    the MagCache schedule and every byte of the conditioning."""
    h = hashlib.sha256()
    h.update(repr(spec).encode())
    h.update(repr(tuple(shape)).encode())
    h.update(str(seed).encode())
    h.update(b"none" if skip is None else np.asarray(skip).tobytes())
    for d in (cond, uncond or {}):
        for k in sorted(d):
            t = torch.as_tensor(d[k])
            h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
            h.update(_tensor_bytes(t))
    return h.hexdigest()[:32]


def save_state(path: str, step: int, x: torch.Tensor,
               residual: Optional[torch.Tensor], fingerprint: str) -> None:
    """Write the sampler's state to ``path`` atomically (a temporary file,
    then a rename). The residual is stored in fp32, which holds a bf16 one
    exactly."""
    tmp = path + ".tmp.npz"
    arrays = dict(step=np.int64(step),
                  x=x.detach().float().cpu().numpy(),
                  fingerprint=np.frombuffer(fingerprint.encode(), np.uint8))
    if residual is not None:
        arrays["residual"] = residual.detach().float().cpu().numpy()
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, fingerprint: str):
    """(step, x, residual or None) as numpy arrays, or None when the file is
    absent, another run's, or torn."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if z["fingerprint"].tobytes().decode() != fingerprint:
                return None
            residual = z["residual"] if "residual" in z.files else None
            return int(z["step"]), z["x"], residual
    except Exception:  # noqa: BLE001  (a torn write from a hard kill)
        return None


def resumable_generate(
    model,
    spec: DenoiseSpec,
    shape,
    cond: dict,
    uncond: dict,
    seed: int,
    checkpoint_path: str,
    magcache: Optional[MagCacheConfig] = None,
    chunk: int = 4,
    progress: bool = False,
    report: Optional[dict] = None,
    _stop_after_chunks: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """:func:`~kandinsky5_tpu_torch.sampling.generate_latents` in chunks of
    ``chunk`` steps, the state saved at ``checkpoint_path`` after each and
    removed at the end. Returns the final latents, or None when
    ``_stop_after_chunks`` (a hook that stands in for a preemption) stopped
    the run early; the state file then holds what a rerun resumes from.
    ``report``, when given, receives ``start_step``: the step the run began
    at (0, or where a saved state left off)."""
    if model.tp is not None or model.sp is not None:
        raise ValueError("resumable generation on a mesh is not ported yet "
                         "(ROADMAP.md, queue 1, item 7d)")
    skip = skip_schedule(spec, magcache)
    fp = _fingerprint(spec, shape, seed, cond, uncond, skip)
    ts = timestep_grid(spec.num_steps, spec.scheduler_scale)
    dts = np.diff(ts)
    device = next(model.parameters()).device

    state = load_state(checkpoint_path, fp)
    if state is None:
        step = 0
        x = seeded_noise(model, shape, seed)
        residual = (None if skip is None
                    else zero_residual(model, spec, shape))
    else:
        step, x_np, res_np = state
        x = torch.from_numpy(x_np).to(device)
        residual = (None if res_np is None else
                    torch.from_numpy(res_np).to(device, model.dtype))
        if progress:
            print(f"resuming denoise at step {step}/{spec.num_steps}",
                  flush=True)
    if report is not None:
        report["start_step"] = step

    chunks_done = 0
    while step < spec.num_steps:
        k = min(chunk, spec.num_steps - step)
        x, residual = denoise_span(
            model, spec, x, ts[step:step + k], dts[step:step + k], cond,
            uncond, skip=None if skip is None else skip[step:step + k],
            residual=residual)
        step += k
        save_state(checkpoint_path, step, x, residual, fp)
        if progress:
            print(f"denoise step {step}/{spec.num_steps}", flush=True)
        chunks_done += 1
        if _stop_after_chunks is not None and chunks_done >= _stop_after_chunks:
            return None
    try:
        os.remove(checkpoint_path)
    except OSError:
        pass
    return x
