"""One short run of each cell on the card, through the benchmark's command
(``pytest -m gpu perfbench/tests``); skips where there is no card."""

import json
import os
import subprocess
import sys

import pytest

import perfbench_tiny

from perfbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=perfbench_tiny.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
