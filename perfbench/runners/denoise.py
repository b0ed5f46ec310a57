"""Closed-loop denoising: whole requests of the configuration's Euler steps,
back to back, one step a call to ``sampling.denoise_span``, synchronised
after each.

Each request draws, from the run's seed and its index, its noise at the
configuration's latent shape and its text conditioning: Qwen hidden states
(1, 256, 3584) with a valid length drawn from the mix's range, a CLIP
pooled vector (1, 768). The step runs on the ``DenoiseSpec`` that the
pipeline builds for the configuration.

The check: one step of the window, drawn from the seed (each step equally
likely), is recomputed by the float32 reference from the same input latent
(the program's state at that step) and conditioning. Compared are the
update x_out - x_in against dt times the reference velocity, its relative
L2 error over the whole latent and the worst of its latent frames', and the
output of that step's first visual self-attention sublayer against the
reference's sublayer on the same input (``attn0_rel_l2``): the program's
input and output there are held from the timed step by a wrapper around
``models.dit._self_attention`` that only keeps references.

The controls: ``int8`` switches on the program's int8 path (W8A8 visual
projections and int8-QK attention, K5); ``fp8`` puts the reference in
float8 in the program's place on the sampled step, for the update and the
sublayer alike.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import Cell, reservoir, sync


class Runner:
    # the traffic file's keys this runner reads besides the common ones
    TRAFFIC_KEYS = ("text_valid_tokens",)

    def __init__(self, cell: Cell):
        self.cell = cell
        self.dev = cell.device
        self.cfg = cell.cfg
        self.conf = cell.conf
        self.latent_shape = tuple(cell.cfg["latent_shape"])

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from kandinsky5_tpu_torch import sampling
        from kandinsky5_tpu_torch.ops.nabla import record_density
        from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline
        from perfbench.weights import seeded_dit

        cell, conf = self.cell, self.conf
        dtype = getattr(torch, self.cfg["dtype"])
        t = time.perf_counter()
        model, self.params = seeded_dit(conf.model.dit_params,
                                        cell.seed_for(cell.STREAM_WEIGHTS),
                                        self.dev, dtype)
        int8 = cell.control == "int8"
        pipe = Kandinsky5T2VPipeline(
            model, conf, attn_impl="flash_int8" if int8 else "auto",
            int8_linear=int8)
        self.model = pipe.dit
        self.tap = SublayerTap(self.model.visual_transformer_blocks[0]
                               .self_attention)
        m = conf.model
        self.spec = pipe._spec(m.num_steps, m.guidance_weight,
                               self.cfg["scheduler_scale"])
        ts = sampling.timestep_grid(m.num_steps, self.cfg["scheduler_scale"])
        self.times, self.dts = ts[:-1], np.diff(ts)
        self.request = -1
        self.step = m.num_steps
        sync(self.dev)
        self.setup_parts = {"weights_s": time.perf_counter() - t}
        t = time.perf_counter()

        # warm-up through the window's own path, so that no kernel (not
        # even the finiteness check's or the density counter's) first
        # loads inside the window
        self.rng = cell.rng(cell.STREAM_SAMPLE + 100)
        self.seen, self.sample, self.finite, self.text_valid = 0, None, [], []
        with record_density():
            for _ in range(int(cell.traffic["warm_units"])):
                self.unit()
        self.failed()
        self.setup_parts["warm_s"] = time.perf_counter() - t
        self.request, self.step = -1, m.num_steps
        self.rng = cell.rng(cell.STREAM_SAMPLE)
        self.seen, self.sample, self.finite, self.text_valid = 0, None, [], []

    def _new_request(self) -> None:
        cell, tcfg = self.cell, self.cfg["text"]
        self.request += 1
        self.step = 0
        gen = torch.Generator(device=self.dev).manual_seed(
            cell.seed_for(cell.STREAM_REQUEST, self.request))
        lo, hi = cell.traffic["text_valid_tokens"]
        valid = int(np.random.default_rng(cell.seed_for(
            cell.STREAM_TEXT, self.request)).integers(lo, hi + 1))
        n = tcfg["qwen_tokens"]
        self.x = torch.randn(self.latent_shape, generator=gen,
                             dtype=torch.float32, device=self.dev)
        self.cond = {
            "text_embeds": torch.randn((1, n, tcfg["qwen_dim"]),
                                       generator=gen, device=self.dev,
                                       dtype=self.model.dtype),
            "pooled_embed": torch.randn((1, tcfg["clip_dim"]), generator=gen,
                                        device=self.dev),
            "mask": (torch.arange(n, device=self.dev) < valid)[None],
        }
        self.valid = valid

    def _step(self):
        """One Euler step of the current request (a new request after the
        last step of the previous one); returns (x_in, x_out, t, dt)."""
        from kandinsky5_tpu_torch import sampling

        if self.step == len(self.times):
            self._new_request()
        i = self.step
        x_in = self.x
        with record_function("bench.step"):
            x_out, _ = sampling.denoise_span(
                self.model, self.spec, x_in, self.times[i:i + 1],
                self.dts[i:i + 1], self.cond, self.cond)
        with record_function("bench.sync"):
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        self.x = x_out
        self.step += 1
        return x_in, x_out, float(self.times[i]), float(self.dts[i])

    # -- the window ----------------------------------------------------------
    def trace_scope(self, trace: bool):
        """In a traced run, the kept fraction of every NABLA mask built (the
        program's own counter; its few reductions run only there)."""
        if not trace:
            return contextlib.nullcontext([])
        from kandinsky5_tpu_torch.ops.nabla import record_density

        @contextlib.contextmanager
        def scope():
            with record_density() as kept:
                self.kept = kept
                yield kept
        return scope()

    def unit(self) -> None:
        # the draw comes before the step, so that only the kept step's
        # sublayer is held
        take = reservoir(self.rng, self.seen + 1)
        if take:
            self.sample = None
            self.tap.arm()
        x_in, x_out, t, dt = self._step()
        self.finite.append(torch.isfinite(x_out).all())
        self.text_valid.append(self.valid)
        self.seen += 1
        if take:
            self.sample = {"request": self.request, "step": self.step - 1,
                           "x_in": x_in, "x_out": x_out, "t": t, "dt": dt,
                           "cond": self.cond, "attn0": self.tap.take()}

    def failed(self) -> int:
        return sum(1 for f in self.finite if not bool(f))

    def info(self) -> dict:
        dit = self.cfg["published"]["model"]["dit_params"]
        return {"dit": dit, "tokens": int(np.prod(self._grid())),
                "text_len": self.cfg["text"]["qwen_tokens"],
                "text_valid": list(self.text_valid),
                "kept": [float(k) for k in getattr(self, "kept", [])],
                "sparse": self.spec.attention_type == "nabla"}

    def release(self) -> None:
        """Drop the program's state and unwrap its sublayer; the weights
        and the sample stay."""
        self.tap.close()
        self.model = self.x = self.cond = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def _reference(self, lowp: bool):
        from perfbench.reference.dit import DiTReference

        att = self.cfg["published"]["model"]["attention"]
        nabla = ({k: att[k] for k in ("P", "wT", "wH", "wW")}
                 if att.get("type") == "nabla" else None)
        return DiTReference(self.params,
                            self.cfg["published"]["model"]["dit_params"],
                            self.cfg["published"]["metrics"]["scale_factor"],
                            nabla, lowp=lowp)

    def _grid(self):
        patch = self.cfg["published"]["model"]["dit_params"]["patch_size"]
        return [n // p for n, p in zip(self.latent_shape[1:4], patch)]

    def _outputs(self, ref):
        """A reference's update (None with :attr:`sublayer_only`) and first
        visual self-attention output on the sampled step, from the
        program's input latent and the program's input of that sublayer."""
        s, c = self.sample, self.sample["cond"]
        a = ref.visual_self_attention(0, s["attn0"][0], self._grid())
        if self.sublayer_only:
            return None, a
        v = ref.velocity(s["x_in"], c["text_embeds"], c["pooled_embed"],
                         c["mask"], s["t"])
        return s["dt"] * v, a

    # calibrate.py's cheaper readings: the sublayer alone, without the
    # whole step's reference (never in the benchmark's runs)
    sublayer_only = False

    def check(self) -> dict:
        d_ref, a_ref = self._outputs(self._reference(False))
        self.d_ref = None if d_ref is None else d_ref.double()
        self.a_ref = a_ref.double()
        if self.cell.control == "fp8":
            return self.fp8_readings()
        s = self.sample
        return self._readings(s["x_out"] - s["x_in"], s["attn0"][1][0])

    def fp8_readings(self) -> dict:
        """The reference in float8 put in the program's place on the
        sampled step (after :meth:`check`): its numbers against the float32
        reference's."""
        return self._readings(*self._outputs(self._reference(True)))

    def _readings(self, d_prog, a_prog) -> dict:
        out = {} if self.d_ref is None else compare(d_prog, self.d_ref)
        out["attn0_rel_l2"] = rel_l2(a_prog, self.a_ref)
        return out


class SublayerTap:
    """Wraps ``models.dit._self_attention`` so that the call on one
    sublayer (``target``, a block's parameters) after :meth:`arm` keeps its
    input and output; every other call passes straight through. The
    wrapper computes nothing: the program's tensors are only referenced."""

    def __init__(self, target):
        from kandinsky5_tpu_torch.models import dit

        self.target, self.armed, self.held = target, False, None
        self._mod, self._orig = dit, dit._self_attention
        orig = self._orig

        def self_attention(p, x, *args, **kwargs):
            out = orig(p, x, *args, **kwargs)
            if self.armed and p is self.target:
                self.held, self.armed = (x, out), False
            return out

        dit._self_attention = self_attention

    def arm(self) -> None:
        self.held, self.armed = None, True

    def take(self):
        if self.held is None:
            raise RuntimeError("the step never ran the tapped sublayer")
        held, self.held = self.held, None
        return held

    def close(self) -> None:
        self._mod._self_attention = self._orig


def rel_l2(a, b) -> float:
    """|a - b| / |b| over every element."""
    return float((a.double() - b).norm() / b.norm())


def compare(d_prog, d_ref) -> dict:
    """The numbers compared: the relative L2 error of an update over the
    whole latent, and the worst over its latent frames."""
    err = d_prog.double() - d_ref
    per_frame = (err.square().sum((0, 2, 3, 4)).sqrt()
                 / d_ref.square().sum((0, 2, 3, 4)).sqrt())
    return {"update_rel_l2": float(err.norm() / d_ref.norm()),
            "worst_frame_rel_l2": float(per_frame.max())}
