"""Resumable generation in the port (kandinsky5_tpu_torch/utils/resume.py),
the three cases of tests/test_resume.py: the chunked run equals one
uninterrupted run bit for bit, with MagCache on (the chunks carry the
latents and the residual exactly); an interrupted run resumes from its file
to the same latents; a state written under another fingerprint is not
resumed. Then ``checkpoint_path=`` through the port's pipeline."""

import os

import numpy as np
import pytest
import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
from kandinsky5_tpu_torch.pipeline import DEFAULT_NEGATIVE, RESOLUTIONS
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    generate_latents,
    skip_schedule,
)
from kandinsky5_tpu_torch.utils.resume import (
    _fingerprint,
    load_state,
    resumable_generate,
)

from ._torch_serving import MAG, tiny_mag_pipeline

CFG = DiTParams(in_visual_dim=4, out_visual_dim=4, in_text_dim=32,
                in_text_dim2=16, time_dim=32, patch_size=(1, 2, 2),
                model_dim=128, ff_dim=256, num_text_blocks=1,
                num_visual_blocks=2, axes_dims=(8, 4, 4), visual_cond=False)
SHAPE = (1, 2, 8, 8, 4)


def _setup():
    model = fast_init_dit_params(CFG, device="cpu", dtype=torch.float32,
                                 seed=0, scale=0.05)
    spec = DenoiseSpec(dit_params=CFG, num_steps=6, guidance_weight=5.0,
                       scheduler_scale=5.0, scale_factor=(1.0, 2.0, 2.0),
                       attn_impl="dense")
    g = torch.Generator().manual_seed(0)
    L = 8

    def cond():
        return dict(text_embeds=torch.randn(1, L, CFG.in_text_dim, generator=g),
                    pooled_embed=torch.randn(1, CFG.in_text_dim2, generator=g),
                    mask=torch.ones(1, L, dtype=torch.bool))

    return model, spec, cond(), cond()


def test_chunked_matches_one_run(tmp_path):
    model, spec, cond, uncond = _setup()
    base = generate_latents(model, spec, SHAPE, cond, uncond, seed=7,
                            magcache=MAG)
    path = str(tmp_path / "gen.npz")
    report = {}
    out = resumable_generate(model, spec, SHAPE, cond, uncond, seed=7,
                             checkpoint_path=path, magcache=MAG, chunk=2,
                             report=report)
    assert report["start_step"] == 0
    assert torch.equal(out, base)
    assert not os.path.exists(path)  # removed at the end
    # the control: MagCache off gives other latents
    off = generate_latents(model, spec, SHAPE, cond, uncond, seed=7)
    assert not torch.equal(off, base)


def test_interrupted_run_resumes(tmp_path):
    model, spec, cond, uncond = _setup()
    base = generate_latents(model, spec, SHAPE, cond, uncond, seed=3,
                            magcache=MAG)
    path = str(tmp_path / "gen.npz")
    # a preemption after one chunk (2 of 6 steps)
    out = resumable_generate(model, spec, SHAPE, cond, uncond, seed=3,
                             checkpoint_path=path, magcache=MAG, chunk=2,
                             _stop_after_chunks=1)
    assert out is None
    fp = _fingerprint(spec, SHAPE, 3, cond, uncond, skip_schedule(spec, MAG))
    st = load_state(path, fp)
    assert st is not None and st[0] == 2 and st[2] is not None
    report = {}
    out = resumable_generate(model, spec, SHAPE, cond, uncond, seed=3,
                             checkpoint_path=path, magcache=MAG, chunk=2,
                             report=report)
    assert report["start_step"] == 2
    assert torch.equal(out, base)


def test_fingerprint_mismatch_restarts(tmp_path):
    model, spec, cond, uncond = _setup()
    path = str(tmp_path / "gen.npz")
    resumable_generate(model, spec, SHAPE, cond, uncond, seed=3,
                       checkpoint_path=path, chunk=2, _stop_after_chunks=1)
    assert load_state(path, _fingerprint(spec, SHAPE, 3, cond, uncond)) \
        is not None
    # another seed, another conditioning or MagCache on: not this state
    other = dict(cond, text_embeds=cond["text_embeds"] + 1e-3)
    for fp in (_fingerprint(spec, SHAPE, 4, cond, uncond),
               _fingerprint(spec, SHAPE, 3, other, uncond),
               _fingerprint(spec, SHAPE, 3, cond, uncond,
                            np.ones((6, 2), bool))):
        assert load_state(path, fp) is None
    report = {}
    out = resumable_generate(model, spec, SHAPE, cond, uncond, seed=4,
                             checkpoint_path=path, chunk=2, report=report)
    assert report["start_step"] == 0
    assert torch.equal(out, generate_latents(model, spec, SHAPE, cond, uncond,
                                             seed=4))


@pytest.fixture
def mag_pipe(monkeypatch):
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    return tiny_mag_pipeline()


def test_pipeline_checkpoint_path_resumes(mag_pipe, tmp_path):
    """``checkpoint_path=`` on the pipeline: a fresh run starts at step 0
    and gives the frames of a call without it; a state left by a run
    stopped after one chunk (4 of 6 steps) is resumed at step 4 to the same
    frames, and the file is gone afterwards."""
    kw = dict(time_length=0, width=64, height=64, seed=11,
              expand_prompts=False)
    want = mag_pipe("a cat", **kw)
    assert mag_pipe.timings["magcache"]
    path = str(tmp_path / "job.npz")
    got = mag_pipe("a cat", checkpoint_path=path, **kw)
    assert mag_pipe.timings["start_step"] == 0
    np.testing.assert_array_equal(got, want)
    assert not os.path.exists(path)

    spec = mag_pipe._spec(6, 5.0, 10.0)
    cond = mag_pipe._encode(["a cat"], "image")
    uncond = mag_pipe._encode([DEFAULT_NEGATIVE], "image")
    assert resumable_generate(mag_pipe.dit, spec, (1, 1, 8, 8, 16), cond,
                              uncond, seed=11, checkpoint_path=path,
                              magcache=MAG, _stop_after_chunks=1) is None
    got = mag_pipe("a cat", checkpoint_path=path, **kw)
    assert mag_pipe.timings["start_step"] == 4
    np.testing.assert_array_equal(got, want)
    assert not os.path.exists(path)
    with pytest.raises(ValueError, match="not both"):
        mag_pipe("a cat", checkpoint_path=path, noise=torch.zeros(1), **kw)
