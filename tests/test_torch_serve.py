"""The port's serving daemon (kandinsky5_tpu_torch/serve.py): the five cases
of tests/test_serve.py on a fake pipeline, then the server over a tiny real
port pipeline on the CPU, whose seeded request writes the frames of the
same request made through the pipeline directly. Every server binds port 0
on 127.0.0.1, so parallel test workers never collide."""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kandinsky5_tpu_torch.pipeline import RESOLUTIONS
from kandinsky5_tpu_torch.serve import GenerationServer, Job

from ._torch_serving import tiny_mag_pipeline
from .test_torch_pipeline import REPO


class FakePipeline:
    """Records batches; writes a marker file per save path."""

    def __init__(self, delay=0.0, fail_on=None):
        self.calls = []
        self.delay = delay
        self.fail_on = fail_on or set()

    def __call__(self, prompts, save_path=None, **kw):
        time.sleep(self.delay)
        self.calls.append(list(prompts))
        for p, path in zip(prompts, save_path):
            if p in self.fail_on:
                raise RuntimeError(f"bad prompt: {p}")
            with open(path, "wb") as f:
                f.write(b"\x00fakevideo:" + p.encode())


def _req(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        body = r.read()
    try:
        return json.loads(body)
    except ValueError:
        return body


def _wait_done(port, job_id, timeout=60):
    t0 = time.time()
    while time.time() - t0 < timeout:
        st = _req(port, f"/status/{job_id}")
        if st["state"] in ("done", "error"):
            return st
        time.sleep(0.05)
    raise TimeoutError(job_id)


@pytest.fixture
def server(tmp_path):
    pipe = FakePipeline(delay=0.3)
    srv = GenerationServer(pipe, out_dir=str(tmp_path), batch_window_s=0.2,
                           max_batch=4)
    http = srv.start(host="127.0.0.1", port=0)
    port = http.server_address[1]
    yield srv, pipe, port
    srv.stop()


def test_submit_status_result(server):
    srv, pipe, port = server
    r = _req(port, "/generate", {"prompt": "a cat", "time_length": 5})
    st = _wait_done(port, r["job_id"])
    assert st["state"] == "done" and st["generation_s"] >= 0.3
    data = _req(port, f"/result/{r['job_id']}")
    assert data.startswith(b"\x00fakevideo:a cat")
    health = _req(port, "/healthz")
    assert health["ok"] and health["devices"] >= 0


def test_compatible_jobs_batch_together(server):
    srv, pipe, port = server
    ids = [_req(port, "/generate", {"prompt": f"p{i}"})["job_id"]
           for i in range(3)]
    for j in ids:
        _wait_done(port, j)
    # the first job opens a batch; the others arrive within the window
    assert any(len(c) > 1 for c in pipe.calls), pipe.calls
    m = _req(port, "/metrics")
    assert m["jobs_done"] == 3 and m["batched_jobs"] >= 2


def test_seeded_jobs_never_batch(server):
    srv, pipe, port = server
    ids = [_req(port, "/generate", {"prompt": f"s{i}", "seed": 1})["job_id"]
           for i in range(3)]
    for j in ids:
        _wait_done(port, j)
    assert all(len(c) == 1 for c in pipe.calls), pipe.calls


def test_mismatched_shapes_do_not_batch(server):
    srv, pipe, port = server
    a = _req(port, "/generate", {"prompt": "a", "width": 768,
                                 "height": 512})["job_id"]
    b = _req(port, "/generate", {"prompt": "b", "width": 512,
                                 "height": 768})["job_id"]
    _wait_done(port, a)
    _wait_done(port, b)
    assert all(len(c) == 1 for c in pipe.calls), pipe.calls


def test_error_isolated_and_reported(server):
    srv, pipe, port = server
    pipe.fail_on = {"boom"}
    bad = _req(port, "/generate", {"prompt": "boom"})["job_id"]
    st = _wait_done(port, bad)
    assert st["state"] == "error" and "bad prompt" in st["error"]
    with pytest.raises(urllib.error.HTTPError):
        _req(port, f"/result/{bad}")
    # the server still serves the jobs after it
    ok = _req(port, "/generate", {"prompt": "fine"})["job_id"]
    assert _wait_done(port, ok)["state"] == "done"
    assert _req(port, "/metrics")["jobs_failed"] == 1


def test_job_keys():
    """A seeded job's batch key is its own; the request key ignores the
    submission (job id, times) and names the request."""
    a = Job("a", "p", seed=1)
    b = Job("b", "p", seed=1)
    assert a.batch_key() != b.batch_key()
    assert a.request_key() == b.request_key()
    assert Job("c", "p").batch_key() == Job("d", "q").batch_key()
    assert Job("c", "p").request_key() != Job("d", "q").request_key()


def test_server_over_the_port_pipeline(tmp_path, monkeypatch):
    """The server over a tiny real pipeline on the CPU: a seeded image
    request's PNG holds the frames of the same request made directly; a
    request at an unsupported size ends in ``error`` and the server still
    answers."""
    from PIL import Image

    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    pipe = tiny_mag_pipeline()
    srv = GenerationServer(pipe, out_dir=str(tmp_path), batch_window_s=0.1)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    try:
        job = _req(port, "/generate", {"prompt": "a red cube",
                                       "time_length": 0, "width": 64,
                                       "height": 64, "seed": 5})["job_id"]
        bad = _req(port, "/generate", {"prompt": "too wide",
                                       "time_length": 0, "width": 1024,
                                       "height": 64, "seed": 5})["job_id"]
        st = _wait_done(port, job, timeout=300)
        assert st["state"] == "done", st
        st_bad = _wait_done(port, bad, timeout=300)
        assert st_bad["state"] == "error" and "height, width" in st_bad["error"]
        assert _req(port, "/healthz")["device"] == "cpu"
        png = _req(port, f"/result/{job}")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        srv.stop()
    served = np.asarray(Image.open(srv.jobs[job].result_path))
    want = pipe("a red cube", time_length=0, width=64, height=64, seed=5)
    np.testing.assert_array_equal(served, want[0, 0])


def test_main_refuses_tp():
    res = subprocess.run(
        [sys.executable, "-m", "kandinsky5_tpu_torch.serve", "--config",
         "x.yaml", "--tp", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and "queue 1, item 7" in res.stderr
