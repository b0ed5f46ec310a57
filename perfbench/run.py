"""Run one cell of the benchmark once, on the machine it is started on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result line holds the cell's end-to-end metrics
(``BENCHMARK.json`` ``end_to_end``), with ``--trace 1`` its per-layer
metrics, read from a ``torch.profiler`` trace of the window. The last line
of standard output is the result, one JSON object; the numbers the check
compared, each with its limit, are the last lines of standard error and
the last key of the result. Without a CUDA card, or with fewer cards than
the cell asks for, it exits with code 1 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches inside the checkout, at fixed paths, and no JAX behind a
    library's back."""
    cache = os.path.join(_ROOT, ".perfbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    # the checkout's root in place of this script's folder, so that the
    # benchmark's modules are imported as ``perfbench.*`` and shadow nothing
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench import harness

    chips = harness.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", t0=T0,
                                  chips=chips)
    except harness.NotMeasurable as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 4
    for key, c in result["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
