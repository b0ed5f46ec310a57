"""Serving daemon for text-to-video generation on one GPU.

Counterpart of ``kandinsky5_tpu/serve.py``, stdlib only (``http.server``
and ``threading``):

  * one worker thread owns the pipeline and the card; HTTP threads only
    enqueue and read job records;
  * micro-batching: requests that arrive within ``batch_window_s`` and
    agree on length, size and steps denoise as one batched call (an
    explicitly seeded request always runs alone, so its seed reproduces
    it);
  * one failing batch marks its jobs ``error`` and the server goes on;
  * ``checkpoint_dir`` makes a one-job batch's denoise resumable
    (``checkpoint_path`` of the pipeline, keyed by the request), so a
    restarted server resumes a killed job's denoise when it is submitted
    again;
  * the newest ``MAX_TERMINAL_JOBS`` finished records are kept; older ones
    go with their result files.

API:
  POST /generate {"prompt": str, "time_length": int, "width": int,
                  "height": int, "seed": int?, "num_steps": int?}
      -> {"job_id": str}
  GET  /status/<job_id>   -> {"state": queued|running|done|error, ...}
  GET  /result/<job_id>   -> the video or image bytes (404 until done)
  GET  /healthz           -> {"ok": true, "devices": N, "device": str}
  GET  /metrics           -> {"jobs_done": N, "jobs_failed": N, ...}

Run it on the card (or with ``--device cpu``)::

    python -m kandinsky5_tpu_torch.serve \\
        --config kandinsky5_tpu_torch/configs/config_5s_sft.yaml --magcache
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

CONTENT_TYPES = {".mp4": "video/mp4", ".png": "image/png",
                 ".y4m": "video/x-yuv4mpeg"}


@dataclass
class Job:
    job_id: str
    prompt: str
    time_length: int = 5
    width: int = 768
    height: int = 512
    seed: Optional[int] = None
    num_steps: Optional[int] = None
    state: str = "queued"
    error: str = ""
    result_path: str = ""
    enqueued_at: float = field(default_factory=time.time)
    started_at: float = 0.0
    finished_at: float = 0.0

    def public(self) -> dict:
        d = {"job_id": self.job_id, "state": self.state,
             "queued_s": round((self.started_at or time.time())
                               - self.enqueued_at, 3)}
        if self.state == "done":
            d["generation_s"] = round(self.finished_at - self.started_at, 3)
        if self.error:
            d["error"] = self.error
        return d

    def batch_key(self):
        """Jobs with equal keys may denoise as one batch. A seeded job's key
        is its own: a batch draws its noise for all its rows at once, so a
        seed reproduces a request only when it runs alone."""
        if self.seed is not None:
            return ("seeded", self.job_id)
        return (self.time_length, self.width, self.height, self.num_steps)

    def request_key(self) -> str:
        """The identity of the request (not of the submission): it names
        the resumable state file, so the same request submitted again after
        a restart finds its half-finished state."""
        payload = (self.prompt, self.time_length, self.width, self.height,
                   self.seed, self.num_steps)
        return hashlib.sha1(repr(payload).encode()).hexdigest()[:16]

    def suffix(self) -> str:
        return ".png" if self.time_length == 0 else ".mp4"


class GenerationServer:
    """Owns the pipeline, the job queue and the worker thread."""

    MAX_TERMINAL_JOBS = 1000

    def __init__(self, pipeline, out_dir: str = "./serve_out",
                 batch_window_s: float = 0.25, max_batch: int = 4,
                 checkpoint_dir: Optional[str] = None):
        self.pipeline = pipeline
        self.out_dir = out_dir
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.checkpoint_dir = checkpoint_dir
        os.makedirs(out_dir, exist_ok=True)
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self.jobs: dict[str, Job] = {}
        self.q: "queue.Queue[Optional[Job]]" = queue.Queue()
        self.metrics = {"jobs_done": 0, "jobs_failed": 0, "batches": 0,
                        "batched_jobs": 0}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)

    def submit(self, payload: dict) -> Job:
        job = Job(
            job_id=uuid.uuid4().hex[:12],
            prompt=str(payload["prompt"]),
            time_length=int(payload.get("time_length", 5)),
            width=int(payload.get("width", 768)),
            height=int(payload.get("height", 512)),
            seed=(int(payload["seed"]) if "seed" in payload else None),
            num_steps=(int(payload["num_steps"])
                       if "num_steps" in payload else None),
        )
        with self._lock:
            self.jobs[job.job_id] = job
        self.q.put(job)
        return job

    def _take_batch(self) -> list:
        """One job, plus the compatible jobs that arrive within the window;
        empty when the server is stopping."""
        job = self.q.get()
        if job is None:
            return []
        batch = [job]
        deadline = time.time() + self.batch_window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.time()
            if timeout <= 0:
                break
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is not None and nxt.batch_key() == job.batch_key():
                batch.append(nxt)
            else:
                self.q.put(nxt)  # another shape (or the stop): next batch
                break
        return batch

    def _generate(self, batch: list) -> list:
        """Run one batch through the pipeline; returns the files written."""
        lead = batch[0]
        paths = [os.path.join(self.out_dir, j.job_id + j.suffix())
                 for j in batch]
        ckpt = (os.path.join(self.checkpoint_dir, f"{lead.request_key()}.npz")
                if self.checkpoint_dir and len(batch) == 1 else None)
        self.pipeline(
            [j.prompt for j in batch],
            time_length=lead.time_length,
            width=lead.width, height=lead.height,
            seed=lead.seed, num_steps=lead.num_steps,
            save_path=paths, progress=False,
            **({"checkpoint_path": ckpt} if ckpt else {}),
        )
        # the pipeline reports where it wrote (a video may come out as .y4m)
        timings = getattr(self.pipeline, "timings", None) or {}
        return list(timings.get("saved") or paths)

    def _run(self):
        device = getattr(self.pipeline, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            # the worker is a new thread: name its card explicitly
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            for j in batch:
                j.state = "running"
                j.started_at = time.time()
            try:
                written = self._generate(batch)
                for j, p in zip(batch, written):
                    j.result_path = p
                    j.state = "done"
                    j.finished_at = time.time()
                with self._lock:
                    self.metrics["jobs_done"] += len(batch)
                    self.metrics["batches"] += 1
                    if len(batch) > 1:
                        self.metrics["batched_jobs"] += len(batch)
                self._evict_old_jobs()
            except Exception as e:  # noqa: BLE001  one bad job != dead server
                for j in batch:
                    j.state = "error"
                    j.error = f"{type(e).__name__}: {e}"[:500]
                    j.finished_at = time.time()
                with self._lock:
                    self.metrics["jobs_failed"] += len(batch)

    def _evict_old_jobs(self):
        """Keep only the newest ``MAX_TERMINAL_JOBS`` finished records, and
        delete the result files of the ones dropped."""
        with self._lock:
            done = [j for j in self.jobs.values()
                    if j.state in ("done", "error")]
            if len(done) <= self.MAX_TERMINAL_JOBS:
                return
            done.sort(key=lambda j: j.finished_at)
            for j in done[:-self.MAX_TERMINAL_JOBS]:
                self.jobs.pop(j.job_id, None)
                if j.result_path:
                    try:
                        os.remove(j.result_path)
                    except OSError:
                        pass

    def start(self, host: str = "0.0.0.0", port: int = 8700):
        """Start the worker and the HTTP server (``port`` 0: any free
        port, ``server.server_address`` says which); returns the server."""
        self._worker.start()
        server = ThreadingHTTPServer((host, port), self._make_handler())
        self._http = server
        self._http_thread = threading.Thread(target=server.serve_forever,
                                             daemon=True)
        self._http_thread.start()
        return server

    def stop(self):
        """Stop taking requests and let the worker end after its batch. The
        worker is not joined: wait for the jobs first."""
        self._stop.set()
        self.q.put(None)
        if hasattr(self, "_http"):
            self._http.shutdown()
            self._http.server_close()

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/generate":
                    return self._json(404, {"error": "unknown endpoint"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    if "prompt" not in payload:
                        return self._json(400, {"error": "prompt required"})
                    job = outer.submit(payload)
                    return self._json(200, {"job_id": job.job_id})
                except Exception as e:  # noqa: BLE001
                    return self._json(400, {"error": str(e)[:200]})

            def do_GET(self):
                if self.path == "/healthz":
                    device = getattr(outer.pipeline, "device", None)
                    return self._json(200, {
                        "ok": True, "devices": torch.cuda.device_count(),
                        "device": None if device is None else str(device)})
                if self.path == "/metrics":
                    with outer._lock:
                        m = dict(outer.metrics)
                    m["queued"] = outer.q.qsize()
                    return self._json(200, m)
                if self.path.startswith("/status/"):
                    job = outer.jobs.get(self.path.split("/", 2)[2])
                    if job is None:
                        return self._json(404, {"error": "unknown job"})
                    return self._json(200, job.public())
                if self.path.startswith("/result/"):
                    job = outer.jobs.get(self.path.split("/", 2)[2])
                    if job is None or job.state != "done":
                        return self._json(404, {"error": "not ready"})
                    try:
                        with open(job.result_path, "rb") as f:
                            data = f.read()
                    except OSError:
                        # eviction may have deleted the file between the
                        # unlocked record fetch and this read
                        return self._json(404, {"error": "result evicted"})
                    ext = os.path.splitext(job.result_path)[1]
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPES.get(
                        ext, "application/octet-stream"))
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return None
                return self._json(404, {"error": "unknown endpoint"})

        return Handler


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Kandinsky-5 serving daemon (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--magcache", action="store_true")
    ap.add_argument("--offload", action="store_true")
    ap.add_argument("--out-dir", default="./serve_out")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="make each single-job denoise resumable")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tp is not None and args.tp > 1:
        raise SystemExit("serving under tensor parallelism is not ported yet "
                         "(ROADMAP.md, queue 1, item 7d)")

    from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline

    pipe = get_T2V_pipeline(conf_path=args.config, magcache=args.magcache,
                            offload=args.offload, device=args.device)
    srv = GenerationServer(pipe, out_dir=args.out_dir,
                           max_batch=args.max_batch,
                           checkpoint_dir=args.checkpoint_dir)
    http = srv.start(host=args.host, port=args.port)
    print(f"serving on {args.host}:{http.server_address[1]} "
          f"({pipe.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
