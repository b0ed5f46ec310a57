"""Read the numbers a cell's check compares, for the program and for its
controls, on many seeds in one process: the readings the cell's limits are
set from (``perfbench/limits/<cell>.json``).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 4 [--runs program,int8,fp8]

Each seed is one run of the cell (``harness.run_cell``: set-up, a window of
``--seconds``, the check) for each of ``--runs``: ``program`` as the
benchmark runs it, ``int8`` on the program's int8 path (W8A8 and int8-QK
attention in the DiT, W8A8 convs in the decode), ``fp8`` the reference in
float8 put in the program's place (a denoise cell). With ``program`` in the
list, ``fp8`` takes the program run's sampled step and float32 reference
rather than a run of its own. ``--sublayer-only`` reads a denoise cell's
``attn0_rel_l2`` alone, without the whole step's reference. Every line's
``correct`` is that run's own verdict, by ``harness.judge`` against the
cell's limits. One JSON line a run; the benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--runs", default="program")
    ap.add_argument("--sublayer-only", action="store_true",
                    help="a denoise cell: read only attn0_rel_l2, without "
                    "the whole step's reference")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != os.path.dirname(
                       os.path.abspath(__file__))]
    sys.path.insert(0, _ROOT)
    from perfbench import harness

    runs = args.runs.split(",")
    limits = harness.limits_file(args.workload)
    if args.sublayer_only:
        from perfbench.runners import denoise

        denoise.Runner.sublayer_only = True
        limits = {"attn0_rel_l2": limits["attn0_rel_l2"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        for run in runs:
            if run == "fp8" and "program" in runs:
                continue
            t0 = time.perf_counter()
            keep: list = []
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 "cuda", t0=t0,
                                 control=None if run == "program" else run,
                                 limits=limits, keep=keep)
            _print(args.workload, seed, run, r["correct"], r["attempted"],
                   r["checks"], r["metrics"], r["check_s"],
                   time.perf_counter() - t0)
            if run == "program" and "fp8" in runs:
                t0 = time.perf_counter()
                checks, ok = harness.judge(keep[0].fp8_readings(), limits)
                _print(args.workload, seed, "fp8", ok, r["attempted"], checks,
                       {}, time.perf_counter() - t0, None)
    return 0


def _print(workload, seed, run, correct, attempted, checks, metrics,
           check_s, run_s) -> None:
    print(json.dumps({
        "workload": workload, "seed": seed, "run": run, "correct": correct,
        "attempted": attempted,
        "readings": {k: c["value"] for k, c in checks.items()},
        "metrics": {k: m["value"] for k, m in metrics.items()},
        "check_s": check_s, "run_s": run_s}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
