"""Warm-runtime HTTP serving of MotionClone generation jobs.

Port of ``motionclone_tpu/serve.py``, standard library only, with the same
API, statuses, bodies and counters.  One ``MotionCloneRuntime`` (weights
loaded on the card, kernels built) stays resident in the server process,
and generation requests queue onto it: a worker thread drains a FIFO queue
onto the card, one job (or one batch of jobs) at a time, and the HTTP layer
stays responsive.

API (JSON over HTTP):

  POST /generate  body = one JSONL-example object
                  (``video_path``, ``new_prompt``, optional ``seed``,
                  ``condition_image_paths``, ``image_index``,
                  ``controlnet_scale`` — the reference's example schema,
                  configs/t2v_camera.jsonl)            -> 202 {job_id, ...}
  GET  /jobs/<id>                                      -> job record
  GET  /jobs                                           -> all job records
  GET  /health                                         -> liveness + queue depth
  GET  /metrics                                        -> Prometheus text format

A full queue answers 503, a malformed body 400; finished job records are
kept in a bounded ring while the counters only grow.  Run it with
``python3 -m motionclone_tpu_torch.serve`` (``cli.serve_main``).

Threads: a job runs on the worker thread, or, under a job timeout, on a
detached thread of its own.  The runtime passes the work's device to every
kernel launch and sets grad mode itself where a pass needs it (PyTorch's
grad mode and current CUDA device are per thread), so a job run by the
server gives the latents of the same example run on the main thread.  A
job that outlives its timeout is failed and the queue keeps draining, but
its thread cannot be killed: it keeps using the card until its call
returns, and its result is then discarded.

Under a multi-device layout (``--frame-shard``; one process per rank under
torchrun) rank 0 serves HTTP and :class:`LockstepJobs` sends each job it
runs to the other ranks of the video, which run the same ``run_example``
with it; a job that fails, fails on every rank and the queue keeps
draining; when the server stops, a last message ends the other ranks'
loop.  A job that outlives its timeout still holds the ranks: the next job
waits for it before it is sent.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from motionclone_tpu_torch.config import Example

# job lifecycle: queued -> running -> done | failed
_TERMINAL = ("done", "failed")


@dataclass
class Job:
    job_id: str
    example: Dict[str, Any]
    status: str = "queued"
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    output_path: Optional[str] = None
    error: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        d = {
            "job_id": self.job_id,
            "example": self.example,
            "status": self.status,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "output_path": self.output_path,
            "error": self.error,
        }
        if self.started_at and self.finished_at:
            d["seconds"] = self.finished_at - self.started_at
        return d


class JobStore:
    """Thread-safe job registry + FIFO work queue with a bounded depth.

    Terminal (done/failed) job records are retained in a bounded ring — a
    long-running server does not grow without bound and ``/jobs`` stays
    small — while the Prometheus counters are monotonic and survive
    eviction.
    """

    def __init__(self, max_queue: int = 64, max_terminal: int = 1024):
        self._lock = threading.Lock()
        self._jobs: Dict[str, Job] = {}
        self._order: list = []
        self._max_terminal = max_terminal
        # monotonic counters (eviction-safe)
        self._submitted_total = 0
        self._done_total = 0
        self._failed_total = 0
        self._seconds_sum = 0.0
        self._seconds_count = 0
        self.work: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=max_queue)
        self.shutting_down = threading.Event()

    def submit(self, example: Dict[str, Any]) -> Job:
        job = Job(job_id=uuid.uuid4().hex[:12], example=example)
        # register before enqueueing — the worker may dequeue immediately and
        # must find the record; a full queue unregisters (no phantom records)
        with self._lock:
            self._jobs[job.job_id] = job
            self._order.append(job.job_id)
            self._submitted_total += 1
        try:
            self.work.put_nowait(job.job_id)
        except queue.Full:
            with self._lock:
                del self._jobs[job.job_id]
                self._order.remove(job.job_id)
                self._submitted_total -= 1
            raise
        return job

    def finish(self, job: Job, *, error: Optional[str] = None) -> None:
        """Transition a running job to its terminal state atomically.

        finished_at is assigned *before* the status flip and both happen
        under the lock, so any observer that sees a terminal status sees a
        complete record (to_json's ``seconds`` key included).  Idempotent:
        a job already terminal stays as-is — the worker's timeout path may
        fail a job whose detached runner thread later completes, and that
        late result must not resurrect or double-count it.
        """
        with self._lock:
            if job.status in _TERMINAL:
                return
            job.finished_at = time.time()
            if error is None:
                job.status = "done"
                self._done_total += 1
            else:
                job.status = "failed"
                job.error = error
                self._failed_total += 1
            if job.started_at:
                self._seconds_sum += job.finished_at - job.started_at
                self._seconds_count += 1
            self._evict_locked()

    def _evict_locked(self) -> None:
        terminal = [j for j in self._order if self._jobs[j].status in _TERMINAL]
        for job_id in terminal[: max(0, len(terminal) - self._max_terminal)]:
            del self._jobs[job_id]
            self._order.remove(job_id)

    def get(self, job_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(job_id)

    def get_json(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            job = self._jobs.get(job_id)
            return None if job is None else job.to_json()

    def all(self) -> list:
        with self._lock:
            return [self._jobs[j].to_json() for j in self._order]

    def queue_depth(self) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values() if j.status == "queued")

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            jobs = list(self._jobs.values())
            return {
                "jobs_total": self._submitted_total,
                "jobs_done": self._done_total,
                "jobs_failed": self._failed_total,
                "jobs_queued": sum(1 for j in jobs if j.status == "queued"),
                "jobs_running": sum(1 for j in jobs if j.status == "running"),
                "generate_seconds_sum": self._seconds_sum,
                "generate_seconds_count": self._seconds_count,
            }


def _run_with_timeout(fn, timeout: Optional[float]):
    """Run ``fn()`` and return its result, raising TimeoutError after
    ``timeout`` seconds.

    A Python thread cannot be killed, so the call runs on a detached daemon
    thread and the worker abandons it on timeout: the queue keeps draining
    and the HTTP layer stays live, while the abandoned thread keeps using
    the card until its call returns.  Its eventual result is discarded by
    JobStore.finish's terminal-state guard.
    """
    if timeout is None:
        return fn()
    box: Dict[str, Any] = {}

    def _call():
        try:
            box["result"] = fn()
        except Exception as e:  # delivered to the waiter below
            box["error"] = e

    t = threading.Thread(target=_call, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"job exceeded {timeout:.0f}s timeout")
    if "error" in box:
        raise box["error"]
    return box["result"]


def _worker_loop(
    store: JobStore,
    run_job: Callable[[Dict[str, Any]], str],
    run_jobs_batch: Optional[Callable[[list], list]] = None,
    batch_max: int = 1,
    job_timeout: Optional[float] = None,
) -> None:
    """Drain the FIFO onto the card, one job or batch at a time; never dies
    on job errors.

    With ``run_jobs_batch`` and ``batch_max > 1`` the worker opportunistically
    drains up to ``batch_max`` queued jobs per pass and runs them together —
    the throughput mode, where the batch maps onto the sweep path
    (pipeline.sweep.run_sweep) so one sampling pass generates several
    queued videos.  A lone job still takes the single-job path.

    ``job_timeout`` bounds each job (or batch) end-to-end: on expiry the
    job(s) fail with a TimeoutError record and the worker moves on.
    """
    while True:
        if store.shutting_down.is_set():
            return
        job_id = store.work.get()
        if job_id is None:  # shutdown sentinel
            store.work.task_done()
            return
        ids = [job_id]
        if run_jobs_batch is not None:
            while len(ids) < batch_max:
                try:
                    extra = store.work.get_nowait()
                except queue.Empty:
                    break
                if extra is None:  # keep the shutdown sentinel effective
                    store.work.put(extra)
                    break
                ids.append(extra)
        jobs = [store.get(i) for i in ids]
        with store._lock:
            for job in jobs:
                job.status = "running"
                job.started_at = time.time()
        try:
            if len(jobs) > 1:
                paths = _run_with_timeout(
                    lambda: run_jobs_batch([j.example for j in jobs]),
                    job_timeout,
                )
                if len(paths) != len(jobs):
                    raise RuntimeError(
                        f"batch runner returned {len(paths)} paths for "
                        f"{len(jobs)} jobs"
                    )
                for job, path in zip(jobs, paths):
                    job.output_path = path
                    store.finish(job)
            else:
                jobs[0].output_path = _run_with_timeout(
                    lambda: run_job(jobs[0].example), job_timeout
                )
                store.finish(jobs[0])
        except Exception as e:  # job-scoped: the server must survive bad jobs
            for job in jobs:
                if job.status == "running":
                    store.finish(job, error=f"{type(e).__name__}: {e}")
        finally:
            for _ in jobs:
                store.work.task_done()


class LockstepJobs:
    """Rank 0's jobs, run in lockstep by every rank of a video's group
    (``parallel/frames.FrameGroup``, whose rank 0 serves HTTP).  The job
    dicts travel over a gloo group of their own whose collectives wait as
    long as the server stays idle (``IDLE_LIMIT_S``).  Every rank calls
    the constructor at the same point (it makes a process group)."""

    IDLE_LIMIT_S = 30 * 24 * 3600.0

    def __init__(self, video):
        import torch.distributed as dist

        self._dist = dist
        self.ranks = list(video.ranks)
        self.group = dist.new_group(self.ranks, backend="gloo",
                                    timeout=timedelta(seconds=self.IDLE_LIMIT_S))
        self._lock = threading.Lock()  # one job on the ranks at a time

    def _broadcast(self, message=None):
        box = [message]
        self._dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]

    def leading(self, run_job: Callable[[Dict[str, Any]], str]):
        """``run_job`` on rank 0: each job goes to the other ranks first."""
        def run(example: Dict[str, Any]) -> str:
            with self._lock:
                self._broadcast(("job", example))
                return run_job(example)
        return run

    def follow(self, run_job: Callable[[Dict[str, Any]], str]) -> None:
        """The other ranks: run each job rank 0 sends until it stops; a
        failed job is reported here and fails on rank 0 as well."""
        while True:
            message = self._broadcast()
            if message is None:
                return
            try:
                run_job(message[1])
            except Exception:  # job-scoped, as on rank 0
                traceback.print_exc()

    def stop(self) -> None:
        """Rank 0, after the server stopped: end the other ranks' loop."""
        with self._lock:
            self._broadcast(None)


def _validate_example(payload: Any) -> Dict[str, Any]:
    if not isinstance(payload, dict):
        raise ValueError("request body must be a JSON object")
    unknown = set(payload) - {
        "video_path",
        "new_prompt",
        "seed",
        "condition_image_paths",
        "image_index",
        "controlnet_scale",
    }
    if unknown:
        raise ValueError(f"unknown example fields: {sorted(unknown)}")
    for key in ("video_path", "new_prompt"):
        if not isinstance(payload.get(key), str) or not payload[key]:
            raise ValueError(f"missing/invalid required field: {key}")
    # explicit type checks: tuple() would silently split a bare string path
    # into per-character entries, and tuple(int) raises TypeError
    if "condition_image_paths" in payload:
        v = payload["condition_image_paths"]
        if not isinstance(v, list) or not all(isinstance(p, str) for p in v):
            raise ValueError("condition_image_paths must be a list of strings")
    if "image_index" in payload:
        v = payload["image_index"]
        if not isinstance(v, list) or not all(isinstance(i, int) for i in v):
            raise ValueError("image_index must be a list of integers")
    if "seed" in payload and not isinstance(payload["seed"], int):
        raise ValueError("seed must be an integer")
    if "controlnet_scale" in payload and not isinstance(
        payload["controlnet_scale"], (int, float)
    ):
        raise ValueError("controlnet_scale must be a number")
    # round-trips through the reference JSONL schema (config.Example);
    # any residual malformation surfaces as a 400, not a dropped connection
    try:
        Example.from_json(payload)
    except (ValueError, TypeError, KeyError) as e:
        raise ValueError(f"malformed example: {type(e).__name__}: {e}")
    return payload


class MotionCloneServer:
    """HTTP front + single worker thread around a ``run_job`` callable.

    ``run_job(example_dict) -> output_path`` is typically a closure over
    ``MotionCloneRuntime.run_example`` (see ``cli.serve_main``); tests inject
    a fake to exercise the serving machinery without checkpoints.
    """

    def __init__(
        self,
        run_job: Callable[[Dict[str, Any]], str],
        *,
        run_jobs_batch: Optional[Callable[[list], list]] = None,
        batch_max: int = 1,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 64,
        job_timeout: Optional[float] = None,
    ):
        self.store = JobStore(max_queue=max_queue)
        self.started_at = time.time()
        self._worker = threading.Thread(
            target=_worker_loop,
            args=(self.store, run_job, run_jobs_batch, batch_max, job_timeout),
            daemon=True,
        )
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        """Start worker + HTTP threads and return (non-blocking)."""
        self._worker.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._http_thread.start()

    def serve_forever(self) -> None:
        self._worker.start()
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._worker.is_alive():
            # never block on a full queue: set the flag the worker checks
            # between jobs, then best-effort insert the wake-up sentinel
            self.store.shutting_down.set()
            try:
                self.store.work.put_nowait(None)
            except queue.Full:
                pass
            self._worker.join(timeout=10)

    # ---- endpoint bodies (handler delegates here) ----

    def handle_generate(self, payload: Any) -> tuple:
        try:
            example = _validate_example(payload)
        except ValueError as e:
            return 400, {"error": str(e)}
        try:
            job = self.store.submit(example)
        except queue.Full:
            return 503, {"error": "queue full", "queue_depth": self.store.queue_depth()}
        return 202, {
            "job_id": job.job_id,
            "status": job.status,
            "queue_position": self.store.queue_depth() - 1,
        }

    def handle_health(self) -> tuple:
        return 200, {
            "status": "ok",
            "uptime_seconds": time.time() - self.started_at,
            "queue_depth": self.store.queue_depth(),
            "worker_alive": self._worker.is_alive(),
        }

    def handle_metrics(self) -> str:
        c = self.store.counters()
        lines = [
            "# HELP motionclone_jobs_total Jobs submitted since start.",
            "# TYPE motionclone_jobs_total counter",
            f"motionclone_jobs_total {c['jobs_total']}",
            "# TYPE motionclone_jobs_done counter",
            f"motionclone_jobs_done {c['jobs_done']}",
            "# TYPE motionclone_jobs_failed counter",
            f"motionclone_jobs_failed {c['jobs_failed']}",
            "# TYPE motionclone_jobs_queued gauge",
            f"motionclone_jobs_queued {c['jobs_queued']}",
            "# TYPE motionclone_jobs_running gauge",
            f"motionclone_jobs_running {c['jobs_running']}",
            "# HELP motionclone_generate_seconds End-to-end seconds per finished job.",
            "# TYPE motionclone_generate_seconds summary",
            f"motionclone_generate_seconds_sum {c['generate_seconds_sum']:.6f}",
            f"motionclone_generate_seconds_count {c['generate_seconds_count']}",
            "# TYPE motionclone_uptime_seconds gauge",
            f"motionclone_uptime_seconds {time.time() - self.started_at:.3f}",
        ]
        return "\n".join(lines) + "\n"


def _make_handler(server: MotionCloneServer):
    class Handler(BaseHTTPRequestHandler):
        # quiet by default; production logging goes through the job records
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send_json(self, code: int, obj: Any) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str, ctype: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                code, obj = server.handle_health()
                return self._send_json(code, obj)
            if self.path == "/metrics":
                return self._send_text(
                    200, server.handle_metrics(), "text/plain; version=0.0.4"
                )
            if self.path == "/jobs":
                return self._send_json(200, {"jobs": server.store.all()})
            if self.path.startswith("/jobs/"):
                rec = server.store.get_json(self.path[len("/jobs/"):])
                if rec is None:
                    return self._send_json(404, {"error": "unknown job"})
                return self._send_json(200, rec)
            return self._send_json(404, {"error": f"no such route: {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
                return self._send_json(404, {"error": f"no such route: {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"null")
            except (ValueError, json.JSONDecodeError) as e:
                return self._send_json(400, {"error": f"bad JSON body: {e}"})
            code, obj = server.handle_generate(payload)
            return self._send_json(code, obj)

    return Handler


if __name__ == "__main__":
    from motionclone_tpu_torch.cli import serve_main

    serve_main()
