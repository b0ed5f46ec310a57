"""The benchmark's run of one cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file found by its name from ``BENCHMARK.json``:

    perfbench/configs/<config>.json     sizes, source, what was assumed
    perfbench/traffic/<mix>.json        the mix's parameters; its "runner"
                                        names the general runner in
                                        perfbench/runners/<runner>.py
    perfbench/metrics/<metric>.py       the reader of one per-layer metric
    perfbench/metrics/<metric>.kernels/ kernel-name patterns, one a line
    perfbench/limits/<cell>.json        each compared number's limit

A run measures ``kandinsky5_tpu_torch`` alone; nothing here imports the
JAX package, and the run ends without a result if anything did.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import sys
import time
from typing import Dict, List, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kandinsky5_tpu")


class NotMeasurable(RuntimeError):
    """The run cannot give a result: a module of the JAX stack was
    loaded."""


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(MANIFEST)


def workload(name: str, man: Optional[dict] = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str, man: Optional[dict] = None) -> dict:
    man = man or manifest()
    for c in man["configs"]:
        if c["name"] == name:
            return read_json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str) -> dict:
    return read_json(os.path.join(BENCH, "traffic", f"{name}.json"))


# the keys every traffic file may hold; a runner adds its own (TRAFFIC_KEYS)
TRAFFIC_KEYS = ("runner", "rate_metric", "why", "warm_units")


def check_traffic(name: str, traffic: dict, runner_cls) -> None:
    """Refuse a traffic file with a key that its runner does not read, so
    that a setting no code honours cannot pass for one."""
    known = set(TRAFFIC_KEYS) | set(getattr(runner_cls, "TRAFFIC_KEYS", ()))
    unread = sorted(set(traffic) - known)
    if unread:
        raise ValueError(f"traffic {name!r}: its runner "
                         f"{traffic['runner']!r} reads no {unread}")


def limits_file(cell: str) -> dict:
    return read_json(os.path.join(BENCH, "limits", f"{cell}.json"))


def _load(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner_module(name: str):
    return importlib.import_module(f"perfbench.runners.{name}")


def metric_reader(name: str):
    """The ``read(layer)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    return _load(path, "perfbench_metric_" + name.replace(".", "_")).read


def kernel_patterns(name: str) -> List[str]:
    """The kernel-name substrings of a metric: every line of every file in
    ``metrics/<name>.kernels/`` (blank lines and ``#`` comments skipped)."""
    folder = os.path.join(BENCH, "metrics", f"{name}.kernels")
    out = []
    for fname in sorted(os.listdir(folder)):
        with open(os.path.join(folder, fname)) as f:
            out += [ln.strip() for ln in f
                    if ln.strip() and not ln.lstrip().startswith("#")]
    return out


def forbidden_modules() -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (the part before the first dot)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def seed_for(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of a run (the weights, request r, the
    sample), from the run's seed and the stream's keys."""
    ss = np.random.SeedSequence([seed % (1 << 64)] + [int(k) for k in keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Cell:
    """What a runner is given: the cell's configuration and traffic files,
    the port's configuration object, the seed, the device and the control
    the run makes, if any: ``"int8"`` switches on the program's own int8
    path, ``"fp8"`` puts the reference in float8 in the program's place
    (a runner that has no such control refuses it)."""

    STREAM_WEIGHTS, STREAM_REQUEST, STREAM_SAMPLE, STREAM_TEXT = 1, 2, 3, 4

    def __init__(self, name: str, seed: int, device, cfg: dict,
                 traffic: dict, control: Optional[str] = None):
        from kandinsky5_tpu_torch.config import config_from_dict

        self.name = name
        self.seed = seed
        self.device = device
        self.cfg = cfg
        self.traffic = traffic
        self.control = control
        self.conf = config_from_dict(cfg["published"])

    def seed_for(self, *keys: int) -> int:
        return seed_for(self.seed, *keys)

    def rng(self, *keys: int) -> random.Random:
        return random.Random(self.seed_for(*keys))


def reservoir(rng: random.Random, seen: int) -> bool:
    """Whether the ``seen``-th unit (from 1) replaces the kept sample: each
    unit of the window ends up kept with probability 1 / units."""
    return rng.randrange(seen) == 0


def sync(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: Optional[float] = None, control: Optional[str] = None,
             cfg: Optional[dict] = None, limits: Optional[dict] = None,
             chips: int = 1, keep: Optional[list] = None) -> dict:
    """One run of cell ``name``: set-up, ``seconds`` of closed-loop load, the
    check and the result line's object. ``cfg`` and ``limits`` replace the
    cell's files (the tests' small sizes); ``keep``, a list, receives the
    runner after its check (its sample and the reference's answer)."""
    import torch
    from torch.profiler import record_function

    from kandinsky5_tpu_torch.ops import _kernels

    t0 = time.perf_counter() if t0 is None else t0
    man = manifest()
    wl = workload(name, man)
    cfg = cfg or config_file(wl["config"], man)
    traffic = traffic_file(wl["traffic"])
    limits = limits or limits_file(name)
    device = torch.device(device)
    runner_cls = runner_module(traffic["runner"]).Runner
    check_traffic(wl["traffic"], traffic, runner_cls)
    cell = Cell(name, seed, device, cfg, traffic, control)
    runner = runner_cls(cell)
    parts = {"start_s": time.perf_counter() - t0}
    if device.type == "cuda":
        t = time.perf_counter()
        torch.cuda.init()
        torch.empty(1, device=device)
        sync(device)
        parts["context_s"] = time.perf_counter() - t
        t = time.perf_counter()
        _kernels.library()
        parts["kernels_s"] = time.perf_counter() - t
    with torch.no_grad():
        runner.setup()
        sync(device)
        parts.update(runner.setup_parts)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        launches0 = dict(_kernels.LAUNCHES)
        prof = None
        with runner.trace_scope(trace):
            if trace:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            try:
                units = 0
                with record_function("bench.window"):
                    start = time.perf_counter()
                    deadline = start + seconds
                    while True:
                        runner.unit()
                        units += 1
                        if time.perf_counter() >= deadline:
                            break
                    window_s = time.perf_counter() - start
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
        launches = {k: v - launches0.get(k, 0)
                    for k, v in _kernels.LAUNCHES.items()}
        peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
                else 0)
        found = forbidden_modules()
        if found:
            raise NotMeasurable("modules of the JAX stack were loaded: "
                                + ", ".join(found))
        failed = runner.failed()
        runner.release()
        t_check = time.perf_counter()
        readings = runner.check()
        check_s = time.perf_counter() - t_check
    if keep is not None:
        keep.append(runner)
    checks, correct = judge(readings, limits)
    correct = correct and failed == 0
    result = {"correct": correct, "attempted": units, "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        from perfbench.trace import Trace

        tr = Trace(prof) if device.type == "cuda" else None
        layer = Layer(cell, runner.info(), tr, launches, units, window_s)
        result["metrics"] = per_layer_metrics(name, man, layer)
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
    else:
        values = {"setup_s": setup_s,
                  traffic["rate_metric"]: window_s / units,
                  "peak_gib": peak / 2 ** 30}
        result["metrics"] = end_to_end_metrics(name, man, values)
    result["device"] = dev
    result["setup_parts"] = parts
    result["check_s"] = check_s
    result["checks"] = checks
    return result


def judge(readings: Dict[str, float], limits: dict):
    """({name: {"value", "limit"}}, whether every reading is within its
    limit). A reading with no limit, or one that is not a number, fails."""
    checks, ok = {}, True
    for key, value in readings.items():
        if key not in limits:
            raise KeyError(f"no limit for the compared number {key!r}")
        lim = limits[key]["limit"]
        checks[key] = {"value": value, "limit": lim}
        ok = ok and math.isfinite(value) and value <= lim
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"limits with no reading: {sorted(missing)}")
    return checks, ok


def _for_cell(entry: dict, name: str) -> bool:
    return "workloads" not in entry or name in entry["workloads"]


def end_to_end_metrics(name: str, man: dict, values: dict) -> dict:
    out = {}
    for m in man["end_to_end"]:
        if _for_cell(m, name):
            if m["name"] not in values:
                raise KeyError(f"{name} reports no {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer_metrics(name: str, man: dict, layer: "Layer") -> dict:
    out = {}
    for m in man["per_layer"]:
        if _for_cell(m, name):
            value = metric_reader(m["name"])(layer)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Layer:
    """What a per-layer reader reads: the traced window (``trace``, None
    off the card), the runner's account of the work (``info``), the
    program's launch counts over the window, the units done and the
    window's seconds."""

    def __init__(self, cell: Cell, info: dict, trace, launches: dict,
                 units: int, window_s: float):
        self.cell = cell
        self.info = info
        self.trace = trace
        self.launches = launches
        self.units = units
        self.window_s = window_s

    def kernel_s(self, metric: str) -> Optional[float]:
        """Device seconds of the kernels a metric's name files list, None
        with no trace or no such kernel in it."""
        if self.trace is None:
            return None
        sec = self.trace.kernel_s(kernel_patterns(metric))
        return sec if sec > 0 else None

    def roofline(self, metric: str, bound_s: float) -> Optional[float]:
        """The layer's summed bound over its kernels' device seconds."""
        sec = self.kernel_s(metric)
        if sec is None or bound_s <= 0:
            return None
        return bound_s / sec
