"""The port's ``utils/metrics.py`` against the JAX package's on seeded
arrays (numpy and torch inputs), and ``utils/trace.py``: StageTimer's
accounting and ``profiled`` writing a trace."""

import json
import os
import time

import numpy as np
import pytest
import torch

from kandinsky5_tpu.utils.metrics import latent_stats as jax_latent_stats
from kandinsky5_tpu.utils.metrics import psnr as jax_psnr
from kandinsky5_tpu_torch.utils.metrics import latent_stats, psnr
from kandinsky5_tpu_torch.utils.trace import TRACE_FILE, StageTimer, profiled


@pytest.mark.parametrize("noise", [0.0, 0.5, 3.0, 40.0])
def test_psnr_matches_jax(noise):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (2, 3, 16, 16, 3)).astype(np.uint8)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 255).astype(np.uint8)
    want = jax_psnr(a, b)
    for x, y in ((a, b), (torch.from_numpy(a), torch.from_numpy(b))):
        got = psnr(x, y)
        assert got == want or abs(got - want) < 1e-12
    assert (want == float("inf")) == (noise == 0.0)


def test_latent_stats_match_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    b = a + 0.01 * rng.standard_normal(a.shape).astype(np.float32)
    want = jax_latent_stats(a, b)
    got = latent_stats(torch.from_numpy(a), b)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
    same = latent_stats(a, a)
    assert same["max_abs"] == 0.0 and abs(same["cosine"] - 1.0) < 1e-9


def test_stage_timer_accounting():
    t = StageTimer(device="cpu")
    with t.stage("text"):
        time.sleep(0.02)
    with t.stage("denoise"):
        time.sleep(0.01)
    with t.stage("text"):
        time.sleep(0.02)
    with pytest.raises(RuntimeError):
        with t.stage("decode"):
            raise RuntimeError("a failing stage is still counted")
    r = t.report()
    assert list(r) == ["text", "denoise", "decode"]
    assert r["text"] >= 0.04 and 0.01 <= r["denoise"] < r["text"]
    assert str(t).startswith("[text: ") and "| total: " in str(t)


def test_profiled_writes_a_trace(tmp_path):
    with profiled(None) as prof:
        assert prof is None
    with profiled(str(tmp_path / "tr")) as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(str(tmp_path / "tr"), TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
