"""What the ranks of ``tests/test_torch_dp.py`` run, in gloo CPU rank
processes started by ``kandinsky5_tpu_torch.parallel.launch`` on a (dp, 1,
tp) mesh. This module imports the port alone (no JAX), so a rank starts
quickly; the test holds what the ranks return against the JAX package's dp
mesh (and, for NABLA and the pipeline, against the port on one device)."""

from unittest import mock

import numpy as np
import torch

from kandinsky5_tpu_torch import training
from kandinsky5_tpu_torch.checkpoint import dit_from_state_dict
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models import vae as vae_mod
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.parallel import DataParallel
from kandinsky5_tpu_torch.parallel.sharding import shard_dit_state_dict
from kandinsky5_tpu_torch.sampling import DenoiseSpec, denoise

from . import _torch_tp_ranks

# the VAE both sides decode with: the port's init_vae_params at this seed
# (the test hands the same values to the JAX package)
VAE_SEED = 0
# tests/test_vae_mesh.py's two setups: latent shape, tiling (tile, stride)
DECODES = {"temporal": ((1, 9, 8, 8, 16), ((9, 64, 64), (4, 32, 32))),
           "spatial": ((1, 2, 16, 16, 16), ((5, 64, 64), (5, 32, 32)))}


def decode_latents(name: str) -> np.ndarray:
    """The seeded latents of setup ``name`` of ``DECODES``."""
    shape = DECODES[name][0]
    return np.random.default_rng(len(name)).standard_normal(shape).astype(
        np.float32)


class SmallTileVAE(HunyuanVideoVAE):
    """The VAE with 32 x 32 spatial tiles at a 16 px stride, so that the
    pipeline's 64 x 64 image decodes as 3 x 3 equal tiles."""

    def _optimal_tiling(self, num_frames, height, width):
        return (1, 32, 32), (1, 16, 16)


def without_gather(self, x):
    """The control for the sampler's gather: each rank holds its own
    predictions in its slot and zeros, never filled, in its peers'."""
    parts = [torch.zeros_like(x) for _ in range(self.size)]
    parts[self.rank] = x
    return torch.cat(parts)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _dit(mesh, cfg_kw, state_dict):
    """The rank's share of the fp32 DiT holding ``state_dict``."""
    cfg = DiTParams(**cfg_kw)
    model = DiffusionTransformer3D(cfg, device="cpu", dtype=torch.float32,
                                   tp=mesh.tp)
    dit_from_state_dict(model, shard_dit_state_dict(state_dict, mesh.tp.rank,
                                                    mesh.tp.size))
    return model


def _denoise(mesh, model, case):
    spec = DenoiseSpec(dit_params=model.cfg, **case["spec"])
    cond = {k: _t(v) for k, v in case["cond"].items()}
    uncond = {k: _t(v) for k, v in case["uncond"].items()}
    skip = case.get("skip")
    mesh.dp.reset_stats()
    out = {"latents": denoise(model, spec, _t(case["noise"]), cond, uncond,
                              skip=skip, dp=mesh.dp).numpy(),
           "gathers": mesh.dp.calls}
    if case.get("control"):
        with mock.patch.object(DataParallel, "all_gather", without_gather):
            out["no_gather"] = denoise(model, spec, _t(case["noise"]), cond,
                                       uncond, skip=skip, dp=mesh.dp).numpy()
    return out


def _decodes(mesh):
    """Each of ``DECODES`` split over the world, seeded latents; then the
    same decode with two decoded tiles swapped before the blend (replayed
    from the first decode, the control)."""
    vae = HunyuanVideoVAE(init_vae_params(device="cpu", dtype=torch.float32,
                                          seed=VAE_SEED),
                          dtype=torch.float32, group=mesh.world)
    real = vae_mod.decode_shared
    out = {}
    for name, (_, tiling) in DECODES.items():
        z = torch.from_numpy(decode_latents(name))
        cache = []

        def recording(group, tiles, decode_one):
            cache.append(real(group, tiles, decode_one))
            return cache[-1]

        replay = iter(cache)

        def swapped(group, tiles, decode_one):
            got = next(replay)
            return None if got is None else [got[1], got[0]] + got[2:]

        vae._apply_tiling(*tiling)
        with mock.patch.object(vae_mod, "decode_shared", recording):
            frames = vae.decode(z, opt_tiling=False, mode="tiled")
        tiles = vae.decoded_tiles
        with mock.patch.object(vae_mod, "decode_shared", swapped):
            control = vae.decode(z, opt_tiling=False, mode="tiled")
        out[name] = {"frames": None if frames is None else frames.numpy(),
                     "swapped": None if control is None else control.numpy(),
                     "tiles": tiles}
    return out


def _pipeline(mesh):
    """The tiny pipeline's CFG image request on the mesh (the 64 x 64 image
    in 3 x 3 tiles)."""
    _torch_tp_ranks.RESOLUTIONS[512] = [(64, 64)]  # for good: a rank process
    pipe = _torch_tp_ranks.pipeline(mesh, vae_cls=SmallTileVAE,
                                    guidance_weight=5.0)
    frames = pipe("a test image", time_length=0, width=64, height=64,
                  seed=3 + mesh.rank, expand_prompts=False)
    keep = ("decoded_tiles", "dp_split", "gather_calls", "decode_s")
    return {"frames": frames, "decode_mode": pipe.decode_mode,
            **{k: pipe.timings[k] for k in keep}}


def _zero(mesh, case):
    """One ZeRO-1 step on the rank's rows of the global batch at the given
    t and noise; the same without the gradients' mean over dp (the
    control); then a step that draws its own t and noise from a seeded
    generator."""
    cfg = DiTParams(**case["cfg"])
    d, n = mesh.dp.rank, len(case["t"]) // mesh.dp.size
    rows = slice(d * n, (d + 1) * n)
    batch = [_t(a)[rows] for a in case["batch"]]
    opt = training.make_optimizer(lr=case["lr"])
    out = {}

    def step(fn, *extra):
        model = _dit(mesh, case["cfg"], case["state"])
        state = training.shard_train_state(
            training.init_train_state(model, opt), mesh)
        state, loss = fn(state, cfg, opt, *batch, *extra, attn_impl="dense")
        params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        return state, loss.item(), params

    state, out["loss"], out["params"] = step(
        training.train_step_on, _t(case["t"])[rows], _t(case["noise"])[rows])
    out["dims"] = state.opt_state["dims"]
    out["moment_elements"] = sum(m.numel() for key in ("mu", "nu")
                                 for m in state.opt_state[key])
    out["step"], out["count"] = state.step, state.opt_state["count"]
    with mock.patch.object(training, "mean_over_dp", lambda dp, xs: None):
        _, out["no_all_reduce_loss"], out["no_all_reduce"] = step(
            training.train_step_on, _t(case["t"])[rows],
            _t(case["noise"])[rows])
    _, out["drawn_loss"], out["drawn"] = step(
        training.train_step, torch.Generator().manual_seed(case["seed"]))
    return out


def run(mesh, work):
    """Every job of ``work`` (a dict) that the test asks of this launch."""
    torch.set_num_threads(2)
    out = {"shape": mesh.shape, "rank": mesh.rank, "dp_rank": mesh.dp.rank,
           "tp_rank": mesh.tp.rank}
    dits = {name: _dit(mesh, *dit) for name, dit in work["dits"].items()}
    out["denoise"] = {name: _denoise(mesh, dits[case["dit"]], case)
                      for name, case in work["denoise"].items()}
    if work.get("decodes"):
        out["decodes"] = _decodes(mesh)
    if work.get("pipeline"):
        out["pipeline"] = _pipeline(mesh)
    if "zero" in work:
        out["zero"] = _zero(mesh, work["zero"])
    return out
