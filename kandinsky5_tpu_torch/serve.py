"""Serving daemon for text-to-video generation, on one GPU or a mesh.

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

On a mesh (``--tp N``: N ranks, one process each, where the JAX server runs
one controller) world rank 0 is the front end: it alone owns the HTTP
server, the queue, the batch window, the job records, the result files and
``/metrics``. The other ranks :func:`follow`: they receive each batch from
rank 0 over the world group (the prompts, size, seed, steps and state path)
and make the same pipeline call. Every rank runs the request's checks
(``check_request``) before the call's first collective, so a bad request
raises on every rank or on none, and the ranks all-reduce a failure flag
before rank 0 marks the jobs ``done`` or ``error``. A failure inside the
call (a rank that died, a fault past the checks) is not caught: rank 0's
server stops and the launch ends with the error. Collectives run only on
rank 0's worker thread and on the followers' main threads; an idle worker
sends a heartbeat every ``HEARTBEAT_S`` seconds, so a follower never
reaches its collective timeout while it waits and a dead one shows.

API:
  POST /generate {"prompt": str, "time_length": int, "width": int,
                  "height": int, "seed": int?, "num_steps": int?}
      -> {"job_id": str}
  GET  /status/<job_id>   -> {"state": queued|running|done|error, ...}
  GET  /result/<job_id>   -> the video or image bytes (404 until done)
  GET  /healthz           -> {"ok": true, "devices": N, "device": str}
                             (N: the mesh's ranks, or the visible cards)
  GET  /metrics           -> {"jobs_done": N, "jobs_failed": N, ...}

Run it on the card (or with ``--device cpu``)::

    python -m kandinsky5_tpu_torch.serve \\
        --config kandinsky5_tpu_torch/configs/config_5s_sft.yaml --magcache

and over N ranks with ``--tp N`` (the JAX factory's mesh for N devices);
over several hosts each host runs the command with ``--nnodes H
--node-rank h --master-addr A --master-port P``, ``--tp`` then being the
width of a tp row inside each host.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import signal
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

CONTENT_TYPES = {".mp4": "video/mp4", ".png": "image/png",
                 ".y4m": "video/x-yuv4mpeg"}
#: seconds an idle mesh worker waits before it sends the followers a
#: heartbeat
HEARTBEAT_S = 60.0


class RankFailure(RuntimeError):
    """A pipeline call on a mesh failed past its checks: a peer may sit in
    a collective that this rank will not join, so the server must stop."""


def _mesh_batch(pipeline, msg: dict, save_path=None) -> dict:
    """One batch on this rank of the pipeline's mesh (rank 0 and the
    followers alike): the checks, the call, then the failure flag
    all-reduced over the world. Returns the call's timings; raises the
    checks' ValueError on every rank where any rank's checks failed, and
    :class:`RankFailure` where the call itself raised."""
    world = pipeline.mesh.world
    kw = msg["kw"]
    try:
        pipeline.check_request(kw["time_length"], kw["width"], kw["height"],
                               kw["num_steps"],
                               checkpoint_path=kw.get("checkpoint_path"))
        error = None
    except ValueError as e:
        error = e
    if error is None:
        try:
            pipeline(msg["prompts"], save_path=save_path, progress=False,
                     **kw)
        except Exception as e:
            raise RankFailure(f"rank {world.rank}: the pipeline call "
                              f"failed: {type(e).__name__}: {e}") from e
    flag = torch.tensor([int(error is not None)], dtype=torch.int32,
                        device=world.wire)
    try:
        world.all_reduce(flag, op="max")
    except Exception as e:
        raise RankFailure(f"rank {world.rank}: the outcome was not agreed: "
                          f"{type(e).__name__}: {e}") from e
    if int(flag.item()):
        raise error or ValueError("the request failed its checks on "
                                  "another rank")
    return dict(pipeline.timings)


def follow(pipeline) -> list:
    """The loop of a mesh rank other than 0: take each message rank 0's
    server broadcasts over the world and answer it with the same pipeline
    call, until the stop message. Returns one record a batch (``ok``, the
    ``error`` or the call's ``timings``)."""
    world = pipeline.mesh.world
    if world.rank == 0:
        raise ValueError("world rank 0 runs the server; the other ranks "
                         "follow it")
    records = []
    while True:
        msg = world.broadcast_object(None, src=0)
        if msg["op"] == "stop":
            return records
        if msg["op"] != "batch":
            continue  # a heartbeat
        try:
            records.append({"ok": True,
                            "timings": _mesh_batch(pipeline, msg)})
        except ValueError as e:  # the checks'; a RankFailure ends the rank
            records.append({"ok": False, "error": f"{type(e).__name__}: {e}"})


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
    # the pipeline's timings of the job's batch
    timings: dict = field(default_factory=dict)

    def public(self) -> dict:
        d = {"job_id": self.job_id, "state": self.state,
             "queued_s": round((self.started_at or time.time())
                               - self.enqueued_at, 3)}
        if self.state == "done":
            d["generation_s"] = round(self.finished_at - self.started_at, 3)
            if "start_step" in self.timings:
                d["start_step"] = self.timings["start_step"]
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
    """Owns the pipeline, the job queue and the worker thread. On a mesh
    (the pipeline's ``mesh``) it runs on world rank 0 while the other ranks
    :func:`follow`."""

    MAX_TERMINAL_JOBS = 1000

    def __init__(self, pipeline, out_dir: str = "./serve_out",
                 batch_window_s: float = 0.25, max_batch: int = 4,
                 checkpoint_dir: Optional[str] = None):
        mesh = getattr(pipeline, "mesh", None)
        if mesh is not None and mesh.rank != 0:
            raise ValueError("world rank 0 runs the server; the other ranks "
                             "follow it (serve.follow)")
        self.world = mesh.world if mesh is not None else None
        self.fatal: Optional[BaseException] = None
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
        empty when the server is stopping (or, on a mesh, after
        ``HEARTBEAT_S`` idle seconds, once a heartbeat has gone out)."""
        try:
            job = self.q.get(timeout=None if self.world is None
                             else HEARTBEAT_S)
        except queue.Empty:
            self.world.broadcast_object({"op": "idle"})
            return []
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
        kw = dict(time_length=lead.time_length, width=lead.width,
                  height=lead.height, seed=lead.seed,
                  num_steps=lead.num_steps,
                  **({"checkpoint_path": ckpt} if ckpt else {}))
        prompts = [j.prompt for j in batch]
        if self.world is not None:
            msg = {"op": "batch", "prompts": prompts, "kw": kw}
            try:
                self.world.broadcast_object(msg)
            except Exception as e:
                raise RankFailure(f"the batch did not reach the ranks: "
                                  f"{type(e).__name__}: {e}") from e
            _mesh_batch(self.pipeline, msg, save_path=paths)
        else:
            self.pipeline(prompts, save_path=paths, progress=False, **kw)
        # the pipeline reports where it wrote (a video may come out as .y4m)
        timings = getattr(self.pipeline, "timings", None) or {}
        for j in batch:
            j.timings = dict(timings)
        return list(timings.get("saved") or paths)

    def _run(self):
        device = getattr(self.pipeline, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            # the worker is a new thread: name its card explicitly
            torch.cuda.set_device(device)
        try:
            while not self._stop.is_set():
                self._serve_one()
            if self.world is not None:
                self.world.broadcast_object({"op": "stop"})
        except Exception as e:  # noqa: BLE001  re-raised by join()
            # a rank failed (or a collective did): a peer may sit in a
            # collective, so stop taking requests and let the rank's main
            # thread end the launch (``join``)
            self.fatal = e
            self.stop()

    def _serve_one(self):
        batch = self._take_batch()
        if batch:
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
            except RankFailure:
                for j in batch:
                    j.state = "error"
                    j.error = "a rank failed; the server stopped"
                raise
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
        """Stop taking requests and let the worker end after its batch (on a
        mesh it then tells the followers to stop). The worker is not
        joined: wait for the jobs first, or :meth:`join`."""
        self._stop.set()
        self.q.put(None)
        if hasattr(self, "_http"):
            self._http.shutdown()
            self._http.server_close()

    def join(self, timeout: Optional[float] = None):
        """Wait for the worker to end; raise what ended it, where a rank
        failed (:class:`RankFailure`)."""
        self._worker.join(timeout)
        if self.fatal is not None:
            raise self.fatal

    def wait(self, interrupted: threading.Event, poll: float = 0.2):
        """Serve until ``interrupted`` is set (then stop and join) or the
        worker ends on a rank's failure (then raise it)."""
        while not interrupted.is_set() and self._worker.is_alive():
            interrupted.wait(poll)
        self.stop()
        self.join()

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
                        "ok": True, "devices": (
                            torch.cuda.device_count() if outer.world is None
                            else outer.world.size),
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


def _build(args, mesh=None):
    from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline

    return get_T2V_pipeline(conf_path=args.config, magcache=args.magcache,
                            offload=args.offload, tp=mesh,
                            device=args.device)


def serve_rank(mesh, args):
    """One rank of ``--tp N``: builds the pipeline as the rank at ``mesh``;
    world rank 0 serves HTTP until interrupted (SIGINT), the others
    :func:`follow`. Returns the batches the rank answered. Module-level,
    so that ``parallel.launch``'s ranks can import it."""
    pipe = _build(args, mesh)
    if mesh.rank != 0:
        # rank 0 stops the followers once it has stopped
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        return len(follow(pipe))
    interrupted = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: interrupted.set())
    srv = GenerationServer(pipe, out_dir=args.out_dir,
                           max_batch=args.max_batch,
                           checkpoint_dir=args.checkpoint_dir)
    http = srv.start(host=args.host, port=args.port)
    print(f"serving on {args.host}:{http.server_address[1]} ({pipe.device}, "
          f"{mesh.size} ranks on the (dp, sp, tp) = {mesh.shape} mesh)",
          flush=True)
    srv.wait(interrupted)
    with srv._lock:
        return srv.metrics["batches"]


def main(argv=None):
    import argparse

    from kandinsky5_tpu_torch.cli import add_node_args, launch_plan

    ap = argparse.ArgumentParser(
        description="Kandinsky-5 serving daemon (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--tp", type=int, default=None,
                    help="device count: that many rank processes on the "
                    "mesh the JAX factory plans for them; over several "
                    "nodes, the width of each node's tp rows")
    ap.add_argument("--magcache", action="store_true")
    ap.add_argument("--offload", action="store_true")
    ap.add_argument("--out-dir", default="./serve_out")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="make each single-job denoise resumable")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    add_node_args(ap)
    args = ap.parse_args(argv)
    plan = launch_plan(args)
    if plan is not None:
        from kandinsky5_tpu_torch.parallel import launch

        answered = launch(serve_rank, plan.pop("world"), plan.pop("backend"),
                          plan.pop("device"), args=(args,), timeout=None,
                          **plan)
        print(f"stopped: this node's ranks answered {answered} batches",
              flush=True)
        return answered

    pipe = _build(args)
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
    return None


if __name__ == "__main__":
    main()
