"""What the ranks of ``tests/test_torch_mesh_resume.py``,
``tests/test_torch_mesh_serve.py`` and ``tests/test_torch_hybrid.py`` run,
in gloo CPU rank processes started by ``kandinsky5_tpu_torch.parallel.
launch``: resumable generation on (1, 1, 2), (2, 1, 1) and (1, 2, 1)
meshes, the server with rank 0 as the front end, and the two-host hybrid
launch. This module imports the port alone (no JAX), so a rank starts
quickly; the tests hold what the ranks return against the JAX package."""

import json
import os
import time
import urllib.request
from unittest import mock

import numpy as np
import torch

from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.config import DiTParams, MagCacheConfig
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
from kandinsky5_tpu_torch.parallel.ranks import rank_mesh
from kandinsky5_tpu_torch.parallel.sharding import shard_dit
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    denoise_span,
    generate_latents,
    skip_schedule,
    timestep_grid,
    zero_residual,
)
from kandinsky5_tpu_torch.utils import resume

from . import _torch_dp_ranks

# the meshes the resume ranks cut from their launch of two: (dp, sp)
MESHES = {"112": (1, 1), "211": (2, 1), "121": (1, 2)}
# the resumable runs' chunk and the chunks before the stop: resume at step 4
# of 6, where the uncond branch's MagCache schedule skips on the residual
# of step 3
CHUNK, STOP = 2, 2
SEED = 7


def _t(a):
    return torch.from_numpy(np.array(a))


def whole_dit(cfg_kw, state_dict):
    """The whole fp32 DiT holding ``state_dict``, on the CPU."""
    model = DiffusionTransformer3D(DiTParams(**cfg_kw), device="cpu",
                                   dtype=torch.float32)
    return dit_from_state_dict(model, {k: _t(v)
                                       for k, v in state_dict.items()})


def rank0_rows_only(residual, spec, batch, dp=None):
    """The control for the dp gather before a save: this rank's rows put in
    every dp rank's place (saved by rank 0: its rows alone)."""
    if dp is None or dp.size == 1:
        return residual
    return torch.cat([residual] * dp.size)


def _resume_case(m, model, work, path):
    """The uninterrupted chunked run, the run stopped after STOP chunks and
    its resumption, on the mesh ``m``."""
    spec = DenoiseSpec(dit_params=model.cfg, **work["spec"])
    mag = MagCacheConfig(**work["mag"])
    cond = {k: _t(v) for k, v in work["cond"].items()}
    uncond = {k: _t(v) for k, v in work["uncond"].items()}
    shape = tuple(work["shape"])
    kw = dict(seed=SEED, magcache=mag, chunk=CHUNK, mesh=m)
    out = {"mesh": m.shape,
           "generate": generate_latents(model, spec, shape, cond, uncond,
                                        seed=SEED, magcache=mag,
                                        dp=m.dp).numpy(),
           "chunked": resume.resumable_generate(
               model, spec, shape, cond, uncond,
               checkpoint_path=path + ".whole.npz", **kw).numpy()}
    saves = []
    real = resume.save_state
    with mock.patch.object(resume, "save_state",
                           lambda *a, **k: (saves.append(a[1]),
                                            real(*a, **k))[1]):
        stopped = resume.resumable_generate(
            model, spec, shape, cond, uncond, checkpoint_path=path,
            _stop_after_chunks=STOP, **kw)
    out["stopped"] = stopped
    out["saves"] = saves
    m.world.all_reduce(torch.zeros(1))  # rank 0's file is whole from here
    out["files"] = sorted(os.listdir(os.path.dirname(path)))
    if m.rank == 0:
        with np.load(path) as z:
            out["saved"] = {k: z[k] for k in ("step", "x", "residual")}
    report = {}
    out["resumed"] = resume.resumable_generate(
        model, spec, shape, cond, uncond, checkpoint_path=path,
        report=report, **kw).numpy()
    out["start_step"] = report["start_step"]
    m.world.all_reduce(torch.zeros(1))  # rank 0 has removed the file
    out["gone"] = not os.path.exists(path)
    # the residual each rank carries after two steps from step 0
    ts = timestep_grid(spec.num_steps, spec.scheduler_scale)
    skip = skip_schedule(spec, mag)
    _, res = denoise_span(model, spec, resume.seeded_noise(model, shape, SEED),
                          ts[:2], np.diff(ts)[:2], cond, uncond, skip=skip[:2],
                          residual=zero_residual(model, spec, shape, m.dp),
                          dp=m.dp)
    out["carried_residual"] = res.numpy()
    if m.dp.size > 1:
        control = path + ".control.npz"
        with mock.patch.object(resume, "whole_residual", rank0_rows_only):
            resume.resumable_generate(
                model, spec, shape, cond, uncond, checkpoint_path=control,
                _stop_after_chunks=STOP, **kw)
        out["control"] = resume.resumable_generate(
            model, spec, shape, cond, uncond, checkpoint_path=control,
            **kw).numpy()
    return out


def resume_run(mesh, work):
    """Every resume case of ``work`` (a dict) on this rank: each mesh of
    MESHES cut from the launch's two ranks, a fingerprint that differs
    between the ranks, and an unseeded resumable pipeline request made with
    a different numpy draw on each rank."""
    torch.set_num_threads(2)
    full = whole_dit(work["cfg"], work["state"])
    meshes = {name: rank_mesh(range(2), dp, sp, "gloo", "cpu")
              for name, (dp, sp) in MESHES.items()}
    out = {"rank": mesh.rank}
    for name, m in meshes.items():
        d = os.path.join(work["dir"], name)
        if m.rank == 0:
            os.makedirs(d, exist_ok=True)
        m.world.all_reduce(torch.zeros(1))
        out[name] = _resume_case(m, shard_dit(full, m), work,
                                 os.path.join(d, "state.npz"))
    # the ranks resume different seeds: every rank raises
    m = meshes["112"]
    model = shard_dit(full, m)
    spec = DenoiseSpec(dit_params=model.cfg, **work["spec"])
    try:
        resume.resumable_generate(
            model, spec, tuple(work["shape"]),
            {k: _t(v) for k, v in work["cond"].items()},
            {k: _t(v) for k, v in work["uncond"].items()}, seed=SEED + m.rank,
            checkpoint_path=os.path.join(work["dir"], "seeds.npz"), mesh=m)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    out["seedless"] = seedless_request(mesh, work["dir"])
    return out


def seedless_request(mesh, directory):
    """The tiny MagCache pipeline's unseeded image request, resumable, on
    the mesh, each rank's numpy draw seeded differently: the seed it used
    and rank 0's frames."""
    from kandinsky5_tpu_torch.pipeline import RESOLUTIONS

    from ._torch_serving import tiny_mag_pipeline

    RESOLUTIONS[512] = [(64, 64)]  # for good: a rank process
    pipe = tiny_mag_pipeline(tp=mesh)
    np.random.seed(1000 + mesh.rank)
    frames = pipe("a cat", time_length=0, width=64, height=64, seed=None,
                  expand_prompts=False,
                  checkpoint_path=os.path.join(directory, "seedless.npz"))
    return {"seed": pipe.timings["seed"], "frames": frames,
            "start_step": pipe.timings["start_step"]}


def _http(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read()
    return body if path.startswith("/result/") else json.loads(body)


def _wait(port, job, timeout=240.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = _http(port, f"/status/{job}")
        if st["state"] in ("done", "error"):
            return st
        time.sleep(0.05)
    raise TimeoutError(job)


# the served requests: two unseeded ones within the window, a seeded one
# (resumed from a state the ranks left), one at an unsupported size and a
# later one
IMAGE = dict(time_length=0, width=64, height=64)
SEEDED = dict(IMAGE, prompt="a seeded cube", seed=5)


def serve_run(mesh, directory):
    """The server on the (1, 1, 2) mesh over the tiny MagCache pipeline:
    rank 0 serves HTTP (its main thread the client), rank 1 follows. Before
    the server starts, both ranks leave the seeded request's state after
    one chunk (4 of 6 steps) where the server looks for it; after the stop,
    both make the seeded request directly."""
    from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE, RESOLUTIONS
    from kandinsky5_tpu_torch.serve import GenerationServer, Job, follow

    from ._torch_serving import MAG, tiny_mag_pipeline

    torch.set_num_threads(2)
    RESOLUTIONS[512] = [(64, 64)]  # for good: a rank process
    pipe = tiny_mag_pipeline(tp=mesh)
    ckpt_dir = os.path.join(directory, "states")
    key = Job("", SEEDED["prompt"], seed=SEEDED["seed"],
              **IMAGE).request_key()
    spec = pipe._spec(6, 5.0, 10.0)
    # the server's calls expand the prompt
    cond = pipe._encode([pipe.expand_prompt(SEEDED["prompt"])], "image")
    uncond = pipe._encode([DEFAULT_NEGATIVE], "image")
    if mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    mesh.world.all_reduce(torch.zeros(1))
    resume.resumable_generate(pipe.dit, spec, (1, 1, 8, 8, 16), cond, uncond,
                              seed=SEEDED["seed"],
                              checkpoint_path=os.path.join(ckpt_dir,
                                                           key + ".npz"),
                              magcache=MAG, mesh=mesh, _stop_after_chunks=1)
    out = {"rank": mesh.rank}
    if mesh.rank != 0:
        out["records"] = follow(pipe)
    else:
        srv = GenerationServer(pipe, out_dir=os.path.join(directory, "out"),
                               batch_window_s=0.5, checkpoint_dir=ckpt_dir)
        port = srv.start(host="127.0.0.1", port=0).server_address[1]
        try:
            pair = [_http(port, "/generate", dict(IMAGE, prompt=p))["job_id"]
                    for p in ("a red cube", "a blue cube")]
            st = {j: _wait(port, j) for j in pair}
            out["after_pair"] = _http(port, "/metrics")
            jobs = {"seeded": _http(port, "/generate", SEEDED)["job_id"]}
            st[jobs["seeded"]] = _wait(port, jobs["seeded"])
            jobs["bad"] = _http(port, "/generate", dict(
                IMAGE, width=1024, prompt="too wide"))["job_id"]
            st[jobs["bad"]] = _wait(port, jobs["bad"])
            jobs["later"] = _http(port, "/generate", dict(
                IMAGE, prompt="a later cube"))["job_id"]
            st[jobs["later"]] = _wait(port, jobs["later"])
            out["healthz"] = _http(port, "/healthz")
            out["metrics"] = _http(port, "/metrics")
            out["png"] = _http(port, f"/result/{jobs['seeded']}")
        finally:
            srv.stop()
            srv.join()
        out["status"] = {name: st[j] for name, j in
                         dict(jobs, pair_a=pair[0], pair_b=pair[1]).items()}
        out["files"] = sorted(os.listdir(ckpt_dir))
    out["direct"] = pipe(SEEDED["prompt"], seed=SEEDED["seed"],
                         **{k: IMAGE[k] for k in IMAGE})
    return out


def hybrid_run(mesh, work):
    """One rank of the two-host launch on the hybrid (2, 1, 2) mesh: its
    place, the tiny CFG denoise split over dp x tp, the pipeline's image
    with its tiles decoded inside each host."""
    torch.set_num_threads(2)
    out = {"rank": mesh.rank, "host": mesh.host, "shape": mesh.shape,
           "tp_ranks": mesh.tp.ranks, "dp_ranks": mesh.dp.ranks,
           "local_ranks": mesh.local.ranks}
    model = _torch_dp_ranks._dit(mesh, *work["dit"])
    out["denoise"] = _torch_dp_ranks._denoise(mesh, model, work["case"])
    out["pipeline"] = _torch_dp_ranks._pipeline(mesh)
    return out
