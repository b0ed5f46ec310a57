"""The port's half of the parity gate (kandinsky5_tpu_torch/tools/
parity_check.py) on dumps this test writes with the JAX package, in the
layout of the reference's ``--make-reference-dump``: noise from a numpy
seed; the text conditioning from the JAX towers (a prompt's valid tokens
only, with its ``cu_seqlens``); ``latents`` from the JAX package's
``generate_latents(noise=)`` at the pipeline's default scheduler scale; and
``frames`` from its tiled decode. Both packages load the same tiny fp32
checkpoints (``test_torch_entry``'s). The consumer encodes with the port's
towers and must read more than 35 dB. Controls: frames of another noise,
and latents conditioned on another prompt, must read less. The JAX
package's consumer integrates at scheduler scale 5.0 whatever the dump's
scale, a fault of that tool (ROADMAP section 3), shown here against the
same dumps. And the gate's decode mode and faithful spec."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.pipeline import get_T2V_pipeline as jax_get_pipeline
from kandinsky5_tpu.sampling import generate_latents as jax_generate
from kandinsky5_tpu_torch.pipeline import (
    DEFAULT_NEGATIVE,
    SCHEDULER_SCALE,
    get_T2V_pipeline,
)
from kandinsky5_tpu_torch.sampling import DenoiseSpec
from kandinsky5_tpu_torch.tools import parity_check

from ._torch_parity import both_cfgs, rand
from .test_torch_entry import DIT_KW, PROMPT, ckpt  # noqa: F401 (fixture)

TOL = 2e-4  # ROADMAP's fp32 tolerance
SHAPES = {"image": (1, 8, 8, 16), "video": (2, 8, 8, 16)}
OTHER_PROMPT = "a red car drives along a coastal road at sunset"


def _jax_consumer():
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "parity_check.py")
    spec = importlib.util.spec_from_file_location("k5_parity_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gate(ckpt):  # noqa: F811
    """The port's and the JAX package's pipelines on the same files, and a
    function that writes a dump with the JAX one."""
    _, conf_path, _ = ckpt
    pipe = get_T2V_pipeline(conf_path=conf_path, device="cpu",
                            dtype=torch.float32)
    jpipe = jax_get_pipeline(conf_path=conf_path, dtype=jnp.float32)
    m = pipe.conf.model

    def write_dump(noise, frames_noise=None, cond_prompt=PROMPT,
                   scale=SCHEDULER_SCALE):
        kind = "image" if noise.shape[0] == 1 else "video"
        enc = {k: jpipe.text_embedder.encode([t], kind)
               for k, t in (("cond", cond_prompt),
                            ("uncond", DEFAULT_NEGATIVE))}
        conds = [{"text_embeds": e.text_embeds,
                  "pooled_embed": e.pooled_embed, "mask": e.mask}
                 for e in enc.values()]
        spec = dataclasses.replace(
            jpipe._spec(m.num_steps, m.guidance_weight, scale),
            attn_impl="auto")

        def sample(z):
            return jax_generate(jpipe.dit_params, spec, (1,) + z.shape,
                                *conds, seed=0, noise=jnp.asarray(z[None]))

        latents = sample(noise)
        frames = jpipe.decode_latents(
            latents if frames_noise is None else sample(frames_noise),
            mode="tiled")
        dump = {"noise": noise, "latents": np.asarray(latents)[0],
                "frames": np.asarray(frames), "prompt": np.asarray(PROMPT),
                "negative": np.asarray(DEFAULT_NEGATIVE),
                "seed": np.asarray(0)}
        for k, e in enc.items():
            valid = np.asarray(e.mask)[0]
            dump[f"{k}_text_embeds"] = np.asarray(e.text_embeds)[0][valid]
            dump[f"{k}_pooled_embed"] = np.asarray(e.pooled_embed)
            dump[f"{k}_cu_seqlens"] = np.array([0, valid.sum()], np.int32)
        return dump

    return pipe, jpipe, write_dump


@pytest.mark.parametrize("kind", ["image", "video"])
def test_consumer_reads_the_gate(gate, kind):
    pipe, _, write_dump = gate
    noise = rand(np.random.default_rng(5), *SHAPES[kind])
    dump = write_dump(noise)
    lines = []
    out = parity_check.run_ours(None, dump, pipe=pipe, log=lines.append)
    assert out["psnr_db"] > parity_check.TARGET_DB and out["passes"]
    # the port's towers against the JAX towers' packed embeddings
    assert set(out["text_err"]) == {"cond", "uncond"}
    assert max(out["text_err"].values()) < TOL
    assert out["latent_stats"]["max_abs"] < TOL
    assert out["frames"].shape == dump["frames"].shape
    # the pipeline's own decode is the stream one: a second reading
    assert out["fast_psnr_db"] is not None
    assert any("target > 35" in s for s in lines)
    assert any("cond text_embeds max err" in s for s in lines)


def test_consumer_fails_frames_of_another_noise(gate):
    """Control: the dump's frames come from another seed's noise."""
    pipe, _, write_dump = gate
    noise = rand(np.random.default_rng(5), *SHAPES["image"])
    other = rand(np.random.default_rng(6), *SHAPES["image"])
    out = parity_check.run_ours(None, write_dump(noise, frames_noise=other),
                                pipe=pipe, log=lambda s: None)
    assert out["psnr_db"] < parity_check.TARGET_DB and not out["passes"]


def test_consumer_fails_another_conditioning(gate):
    """Control: the dump's latents are conditioned on another prompt than
    the one it names, as a text tower that encodes wrongly would condition
    them; the gate, which encodes with the port's towers, fails, and the
    triage reads the towers' error."""
    pipe, _, write_dump = gate
    noise = rand(np.random.default_rng(5), *SHAPES["video"])
    dump = write_dump(noise, cond_prompt=OTHER_PROMPT)
    out = parity_check.run_ours(None, dump, pipe=pipe, log=lambda s: None)
    assert out["psnr_db"] < parity_check.TARGET_DB and not out["passes"]
    assert out["text_err"]["cond"] > 100 * TOL
    assert out["text_err"]["uncond"] < TOL


@pytest.mark.parametrize("scale", [5.0, SCHEDULER_SCALE])
def test_jax_consumer_integrates_at_scale_5(gate, scale):
    """The JAX package's ``run_ours`` integrates at scheduler scale 5.0,
    while the pipelines' default, at which the reference makes its dump,
    is 10.0: on a dump at 5.0 it reads the gate as the port does, on a dump
    at the default it fails where the port passes."""
    pipe, jpipe, write_dump = gate
    noise = rand(np.random.default_rng(5), *SHAPES["video"])
    dump = write_dump(noise, scale=scale)
    jax_db = _jax_consumer().run_ours(None, dump, PROMPT, pipe=jpipe)
    if scale == SCHEDULER_SCALE:
        ours = parity_check.run_ours(None, dump, pipe=pipe,
                                     log=lambda s: None)
        assert ours["passes"] and jax_db < parity_check.TARGET_DB
    else:
        assert jax_db > parity_check.TARGET_DB


def test_gate_decode_mode_is_tiled():
    assert parity_check.GATE_DECODE_MODE == "tiled"


def test_faithful_spec_pins_bf16_attention():
    _, pcfg = both_cfgs(**DIT_KW)
    fast = DenoiseSpec(dit_params=pcfg, num_steps=7, guidance_weight=3.5,
                       scheduler_scale=5.0, scale_factor=(1.0, 2.0, 2.0),
                       attention_type="nabla", attn_impl="flash_int8",
                       sequential_cfg=True)
    faithful = parity_check.faithful_spec(fast)
    assert faithful.attn_impl == "auto"
    assert faithful == DenoiseSpec(**{**fast.__dict__, "attn_impl": "auto"})
