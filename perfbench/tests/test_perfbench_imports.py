"""The benchmark measures the port alone: nothing it imports is JAX or the
JAX package, compared by whole top-level name; the references import
nothing of the port either; without a card a run prints no result."""

import os
import subprocess
import sys

import perfbench_tiny

from perfbench import harness

ROOT = perfbench_tiny.ROOT


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_imports_no_jax():
    """Everything a run imports (the harness, both runners, every metric
    reader, the references and the port's modules they load)."""
    code = ("import glob, os\n"
            "from perfbench import harness, calibrate, weights, work\n"
            "from perfbench.runners import denoise, decode\n"
            "from perfbench.reference import dit, vae\n"
            "import kandinsky5_tpu_torch.pipeline, kandinsky5_tpu_torch.sampling\n"
            "for f in glob.glob('perfbench/metrics/*.py'):\n"
            "    harness.metric_reader(os.path.basename(f)[:-3])\n")
    mods = _modules_after(code)
    assert not mods & set(harness.FORBIDDEN)
    assert "kandinsky5_tpu_torch" in mods


def test_reference_imports_nothing_of_the_port():
    mods = _modules_after("from perfbench.reference import dit, vae")
    assert "kandinsky5_tpu_torch" not in mods
    assert not mods & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kandinsky5_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kandinsky5_tpu.fake", sys)
    assert harness.forbidden_modules() == ["kandinsky5_tpu"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "k5_t2v_5s_distil.denoise", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
