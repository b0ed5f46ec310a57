"""A run with its timed path broken underneath: the harness's check has to
come out not correct, once for each fault the cells can have. (A batch of
one has no half to leave out and one chip no exchange to skip.)"""

import pytest

from perfbench_tiny import run, tiny_config, tiny_decode_config


@pytest.fixture
def broken(monkeypatch):
    """``broken(fault)`` replaces the program's step or decode, underneath
    the harness, by a broken one: ``unchanged`` returns each step's state
    unchanged, ``altered`` leaves the last latent frame of each step's
    output unupdated, or repeats the second-last frame of each decode's as
    its last. monkeypatch restores the program after the test."""
    from kandinsky5_tpu_torch import pipeline, sampling

    step = sampling.denoise_span
    decode = pipeline.Kandinsky5T2VPipeline.decode_latents

    def broken_step(model, spec, noise, *a, **kw):
        x, res = step(model, spec, noise, *a, **kw)
        if fault_of[0] == "unchanged":
            return noise.clone(), res
        x = x.clone()
        x[:, -1] = noise[:, -1]
        return x, res

    def broken_decode(self, latents, mode=None):
        frames = decode(self, latents, mode).copy()
        frames[:, -1] = frames[:, -2]
        return frames

    fault_of = [None]

    def apply(fault):
        fault_of[0] = fault
        monkeypatch.setattr(sampling, "denoise_span", broken_step)
        monkeypatch.setattr(pipeline.Kandinsky5T2VPipeline, "decode_latents",
                            broken_decode)
    return apply


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell,config", [
    ("k5_t2v_5s_distil.denoise", "k5_t2v_5s_distil"),
    ("k5_t2v_10s_distil.denoise", "k5_t2v_10s_distil"),
])
def test_denoise_fault_is_not_correct(broken, cell, config, fault):
    assert run(cell, tiny_config(config))["correct"]
    broken(fault)
    r = run(cell, tiny_config(config))
    assert not r["correct"]


def test_decode_fault_is_not_correct(broken):
    cfg = tiny_decode_config()
    assert run("k5_t2v_5s_distil.decode", cfg)["correct"]
    broken("altered")
    assert not run("k5_t2v_5s_distil.decode", cfg)["correct"]
