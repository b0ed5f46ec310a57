"""BENCHMARK.json against the benchmark's rules, and every file the
harness reads for a configuration, traffic mix, metric, kernel-name list or
cell found by its name."""

import json
import os
import re

import pytest

import perfbench_tiny

from perfbench import harness

ROOT = perfbench_tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_shape_and_names():
    man = _man()
    assert set(man) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= man["run_seconds"] <= 51
    for key, kind in (("configs", "config"), ("workloads", "workload")):
        for e in man[key]:
            assert set(e) == KEYS[kind], e
            assert NAME.match(e["name"]) and TEXT.match(e["why"])
    for kind in ("end_to_end", "per_layer"):
        for m in man[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in man[k]]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    man = _man()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = e2e[m["moves"]].get("workloads")
            assert reports is None or cell in reports


def test_every_cell_reports_enough():
    man = _man()
    cells = [w["name"] for w in man["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in man["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in m["workloads"] for m in man["per_layer"])
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) \
        == len(cells)
    assert all(w["chips"] in (1, 4) for w in man["workloads"])


def test_full_check_fits_its_time():
    """2 + 14 runs a cell at run_seconds + 60 s, 180 s a cell to compile
    and 1,200 s spare fit 43,200 s with the full 24 cells."""
    rs = _man()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_files_found_by_name():
    man = _man()
    for c in man["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = harness.config_file(c["name"], man)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in man["workloads"]:
        traffic = harness.traffic_file(w["traffic"])
        harness.check_traffic(w["traffic"], traffic,
                              harness.runner_module(traffic["runner"]).Runner)
        limits = harness.limits_file(w["name"])
        assert all(v["limit"] > 0 for v in limits.values())
    for m in man["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert harness.kernel_patterns(m["name"])
            assert m["unit"] == "%"


def test_traffic_with_an_unread_key_is_refused():
    """A setting that no code reads (here a batch size the runner does not
    honour) stops the run instead of passing for one."""
    traffic = dict(harness.traffic_file("denoise"), batch=2)
    runner = harness.runner_module("denoise").Runner
    with pytest.raises(ValueError, match="batch"):
        harness.check_traffic("denoise", traffic, runner)


def test_command_stays_in_paths():
    man = _man()
    assert man["command"][0] == "python3"
    for word in man["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in man["paths"])
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.endswith("_torch")


def test_reader_is_silent_without_a_trace():
    """A reader that finds nothing to read returns nothing."""
    man = _man()
    cell = harness.Cell.__new__(harness.Cell)
    info = {"dit": harness.config_file("k5_t2v_5s_distil")["published"]
            ["model"]["dit_params"], "tokens": 47616, "text_len": 256,
            "text_valid": [100], "kept": [], "sparse": False,
            "latent_shape": [1, 31, 64, 96, 16],
            "channels": [128, 256, 512, 512], "chunk_lat": 3,
            "attn_past": 4, "latent_channels": 16}
    layer = harness.Layer(cell, info, None, {}, 1, 2.0)
    for m in man["per_layer"]:
        if not m["name"].startswith("mfu"):
            assert harness.metric_reader(m["name"])(layer) is None
