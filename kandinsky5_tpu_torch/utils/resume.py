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

On a mesh (``mesh=``, every rank calling) the ranks first compare their
fingerprints (they must agree, else every rank raises); world rank 0 alone
reads and writes the file and broadcasts what it read (found or not, the
step, the latents, the residual) over the world, so every rank resumes
from one state or starts at step 0 together, on rank 0's noise as
``generate_latents`` does. Under dp each rank carries only its rows of
MagCache's residual: the file holds the whole residual, gathered over dp
before each save, and each dp rank takes its rows back on resume. Under
tp and sp every rank holds the whole latents and residual.
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
    local_residual,
    seeded_noise,
    skip_schedule,
    timestep_grid,
    whole_residual,
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


def _agree(world, fingerprint: str) -> None:
    """Raise on every rank of ``world`` unless all hold ``fingerprint``."""
    mine = torch.frombuffer(bytearray(fingerprint.encode()),
                            dtype=torch.uint8).to(world.wire)
    every = world.all_gather(mine).cpu().reshape(world.size, -1)
    if not bool((every == every[0]).all()):
        raise ValueError("the ranks resume different requests: their "
                         "fingerprints (spec, shape, seed, MagCache "
                         "schedule, conditioning) differ")


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
    mesh=None,
    _stop_after_chunks: Optional[int] = None,
) -> Optional[torch.Tensor]:
    """:func:`~kandinsky5_tpu_torch.sampling.generate_latents` in chunks of
    ``chunk`` steps, the state saved at ``checkpoint_path`` after each and
    removed at the end. Returns the final latents, or None when
    ``_stop_after_chunks`` (a hook that stands in for a preemption) stopped
    the run early; the state file then holds what a rerun resumes from.
    ``report``, when given, receives ``start_step``: the step the run began
    at (0, or where a saved state left off). ``mesh`` is the rank's
    :class:`~kandinsky5_tpu_torch.parallel.RankMesh` when the model is
    sharded (see the module's docstring); every rank of it calls this with
    the same request."""
    if mesh is None and (model.tp is not None or model.sp is not None):
        raise ValueError("a sharded model resumes on its mesh: pass mesh=")
    world = mesh.world if mesh is not None and mesh.size > 1 else None
    dp = None if mesh is None else mesh.dp
    lead = world is None or world.rank == 0
    skip = skip_schedule(spec, magcache)
    fp = _fingerprint(spec, shape, seed, cond, uncond, skip)
    ts = timestep_grid(spec.num_steps, spec.scheduler_scale)
    dts = np.diff(ts)
    device = next(model.parameters()).device
    if world is not None:
        _agree(world, fp)

    state = load_state(checkpoint_path, fp) if lead else None
    if world is not None:
        state = world.broadcast_object(state)
    if state is None:
        step = 0
        x = seeded_noise(model, shape, seed)
        if world is not None:
            x = world.broadcast(x)
        residual = (None if skip is None
                    else zero_residual(model, spec, shape, dp))
    else:
        step, x, res = state
        x = torch.as_tensor(x).to(device)
        residual = (None if res is None else local_residual(
            torch.as_tensor(res).to(device, model.dtype), spec, shape[0],
            dp))
        if progress and lead:
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
            residual=residual, dp=dp)
        step += k
        whole = whole_residual(residual, spec, shape[0], dp)
        if lead:
            save_state(checkpoint_path, step, x, whole, fp)
            if progress:
                print(f"denoise step {step}/{spec.num_steps}", flush=True)
        chunks_done += 1
        if _stop_after_chunks is not None and chunks_done >= _stop_after_chunks:
            return None
    if lead:
        try:
            os.remove(checkpoint_path)
        except OSError:
            pass
    return x
