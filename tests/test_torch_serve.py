"""The port's serving daemon (kandinsky5_tpu_torch/serve.py): the five cases
of tests/test_serve.py on a fake pipeline, then the server over a tiny real
port pipeline on the CPU, whose seeded request writes the frames of the
same request made through the pipeline directly. Every server binds port 0
on 127.0.0.1, so parallel test workers never collide."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
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
    """A tp plan whose rows would cross hosts is refused before anything is
    built: tp 4 over two hosts of 2 ranks each."""
    res = subprocess.run(
        [sys.executable, "-m", "kandinsky5_tpu_torch.serve", "--config",
         "x.yaml", "--tp", "4", "--device", "cpu", "--nnodes", "2",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0 and "may not cross hosts" in res.stderr


# a tiny released-layout model for ``python -m kandinsky5_tpu_torch.serve``
RELEASED_DIT = dict(in_visual_dim=16, out_visual_dim=16, in_text_dim=64,
                    in_text_dim2=32, time_dim=32, patch_size=[1, 2, 2],
                    model_dim=128, ff_dim=256, num_text_blocks=1,
                    num_visual_blocks=2, axes_dims=[16, 24, 24],
                    visual_cond=True)


def _released_checkpoints(root):
    """Tiny models in the released layouts under ``root``
    (``tests/_torch_released.py``) and a YAML naming them; its path."""
    import torch
    import yaml

    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
    from kandinsky5_tpu_torch.text.clip import (
        ClipTextConfig,
        init_clip_params_random,
    )
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder
    from kandinsky5_tpu_torch.text.qwen import (
        QwenTextConfig,
        init_qwen_params_random,
    )

    from ._torch_released import write_released_layout

    conf = {"model": {
        "checkpoint_path": "@dit@",
        "vae": {"checkpoint_path": "@vae@", "name": "hunyuan"},
        "text_embedder": {
            "qwen": {"checkpoint_path": "@qwen@", "emb_size": 64,
                     "max_length": 16},
            "clip": {"checkpoint_path": "@clip@", "emb_size": 32,
                     "max_length": 20}},
        "dit_params": RELEASED_DIT,
        "attention": {"type": "flash", "causal": False, "local": False,
                      "glob": False, "window": 3},
        "num_steps": 2, "guidance_weight": 3.0},
        "metrics": {"scale_factor": [1.0, 2.0, 2.0], "resolution": 512}}
    from kandinsky5_tpu_torch.config import load_config

    dit = fast_init_dit_params(DiTParams(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in RELEASED_DIT.items()}), device="cpu",
        dtype=torch.bfloat16, seed=0)
    vae = HunyuanVideoVAE(init_vae_params(
        device="cpu", dtype=torch.bfloat16, seed=1,
        block_out_channels=(32, 32, 64, 64)), dtype=torch.bfloat16)
    qwen = init_qwen_params_random(QwenTextConfig(
        vocab_size=151680, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16), device="cpu", dtype=torch.bfloat16, seed=2)
    clip = init_clip_params_random(ClipTextConfig(
        vocab_size=49408, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, eos_token_id=49407),
        device="cpu", dtype=torch.float32, seed=3)
    template = os.path.join(root, "template.yaml")
    with open(template, "w") as f:
        yaml.safe_dump(conf, f)
    towers = Kandinsky5TextEmbedder(load_config(template).model.text_embedder,
                                    qwen, clip)
    paths = write_released_layout(root, dit, vae, towers)
    with open(template) as f:
        text = f.read()
    for key, path in paths.items():
        text = text.replace(f"@{key}@", path)
    conf_path = os.path.join(root, "tiny.yaml")
    with open(conf_path, "w") as f:
        f.write(text)
    return conf_path


def test_main_serves_tp(tmp_path):
    """``python -m kandinsky5_tpu_torch.serve --tp 2 --device cpu`` on tiny
    released-layout checkpoints: two gloo ranks on the (1, 1, 2) mesh, rank
    0 the front end; it answers an image request over HTTP with a PNG and,
    on SIGINT, stops both ranks and exits 0."""
    conf_path = _released_checkpoints(str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kandinsky5_tpu_torch.serve", "--config",
         conf_path, "--tp", "2", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--out-dir", str(tmp_path / "out")], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(x)
                                              for x in proc.stdout],
                              daemon=True)
    reader.start()
    try:
        port, seen, t0 = None, [], time.time()
        while port is None and time.time() - t0 < 240:
            try:
                seen.append(lines.get(timeout=1.0))
            except queue.Empty:
                assert proc.poll() is None, proc.stderr.read()[-3000:]
                continue
            if seen[-1].startswith("serving on 127.0.0.1:"):
                port = int(seen[-1].split(":")[1].split()[0])
        assert port is not None and "2 ranks" in seen[-1], seen
        assert _req(port, "/healthz")["devices"] == 2
        job = _req(port, "/generate", {"prompt": "a red cube",
                                       "time_length": 0, "width": 512,
                                       "height": 512, "seed": 3})["job_id"]
        assert _wait_done(port, job, timeout=240)["state"] == "done"
        assert _req(port, f"/result/{job}")[:8] == b"\x89PNG\r\n\x1a\n"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()[-3000:]
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    assert any(x.startswith("stopped: this node's ranks answered [1, 1]")
               for x in rest), rest
