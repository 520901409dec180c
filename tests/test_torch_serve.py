"""The port's job server against the JAX package's.

Each scripted exchange runs twice, once against ``motionclone_tpu.serve``
and once against ``motionclone_tpu_torch.serve``, both driven by the same
stub ``run_job`` / ``run_jobs_batch`` (events order every step, so each
run is deterministic), and the two transcripts (method, path, status,
JSON body or metrics text) must be equal once job ids and times are
replaced by tokens.  The exchanges: submission order with a failing job
isolated; a batch drain and a lone job on the single path; a job timeout
with the queue still draining; the 503 backpressure; validation errors and
unknown routes; ``/health`` and ``/metrics`` with counters that only grow;
bounded retention; shutdown on a full queue.

End to end: ``cli.serve_main`` on the synthetic model directory of
tests/test_torch_runtime.py (``--device cpu --float32 --batch-max 2``, on
127.0.0.1, port 0, in a thread): three POSTed jobs, the first alone on the
single path and the other two drained as one batch (the sweep), each run
by the server's job threads, end as mp4s whose latents equal the same
examples' ``run_example`` on the main thread (the lone job bit for bit,
the batched ones within tests/test_torch_sweep.py's SERIAL_TOL)."""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from motionclone_tpu import serve as jserve
from motionclone_tpu_torch import serve as tserve
from motionclone_tpu_torch.cli import serve_main
from motionclone_tpu_torch.config import Example, load_inference_config
from motionclone_tpu_torch.io.video import write_video
from motionclone_tpu_torch.pipeline import runner
from motionclone_tpu_torch.pipeline import sweep as tsweep
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_runtime import ARGS, SD, model_dir  # noqa: F401
from test_torch_sweep import SERIAL_TOL

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PACKAGES = {"jax": jserve, "port": tserve}
TIME_KEYS = {"submitted_at", "started_at", "finished_at", "seconds", "uptime_seconds"}
TIMED_METRICS = ("motionclone_uptime_seconds", "motionclone_generate_seconds_sum")


class Client:
    """HTTP to one server, every exchange recorded with job ids and times
    replaced by tokens."""

    def __init__(self, port: int):
        self.port, self.ids, self.transcript = port, {}, []

    def token(self, job_id: str) -> str:
        return self.ids.setdefault(job_id, f"job{len(self.ids)}")

    def norm(self, obj):
        if isinstance(obj, dict):
            return {k: (None if v is None else "<t>") if k in TIME_KEYS
                    else self.token(v) if k == "job_id" else self.norm(v)
                    for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.norm(x) for x in obj]
        return obj

    def call(self, path: str, payload=None, raw: bytes = None, method: str = None):
        url = f"http://127.0.0.1:{self.port}{path}"
        data = raw if raw is not None else (None if payload is None
                                            else json.dumps(payload).encode())
        req = urllib.request.Request(url, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                code, text, ctype = r.status, r.read().decode(), r.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            code, text, ctype = e.code, e.read().decode(), e.headers["Content-Type"]
        if ctype == "application/json":
            body = self.norm(json.loads(text))
        else:  # the metrics: times masked
            body = [re.sub(r" \S+$", " <t>", ln) if ln.startswith(TIMED_METRICS) else ln
                    for ln in text.splitlines()]
        shown = re.sub(r"/jobs/(\w+)", lambda m: "/jobs/" + self.ids.get(m.group(1), "?"),
                       path)
        self.transcript.append((method or ("POST" if data is not None else "GET"), shown,
                                code, body))
        return code, (json.loads(text) if ctype == "application/json" else text)

    def post(self, prompt: str, **extra):
        code, body = self.call("/generate", {"video_path": "v.mp4", "new_prompt": prompt,
                                             **extra})
        return body.get("job_id")

    def wait(self, job_id: str, *statuses, timeout: float = 10.0, record: bool = True) -> dict:
        """Poll until the job reaches one of ``statuses``; only the last
        poll is recorded, and none with ``record=False``."""
        deadline = time.time() + timeout
        while True:
            mark = len(self.transcript)
            _, rec = self.call(f"/jobs/{job_id}")
            if rec["status"] in statuses:
                if not record:
                    del self.transcript[mark:]
                return rec
            del self.transcript[mark:]
            if time.time() > deadline:
                raise AssertionError(f"job {job_id} never reached {statuses}: {rec}")
            time.sleep(0.01)


def _stub(gates=None):
    """run_job / run_jobs_batch stubs: "boom" fails, a prompt with a gate
    waits for it, every call is recorded; the output is "<prompt>.mp4"."""
    gates, calls = gates or {}, []

    def run_job(example):
        calls.append(example["new_prompt"])
        if example["new_prompt"] in gates:
            gates[example["new_prompt"]].wait(timeout=30)
        if example["new_prompt"] == "boom":
            raise RuntimeError("synthetic job failure")
        return f"{example['new_prompt']}.mp4"

    def run_jobs_batch(examples):
        calls.append([e["new_prompt"] for e in examples])
        return [f"{e['new_prompt']}.mp4" for e in examples]

    return run_job, run_jobs_batch, calls


def _exchange(mod, script, make):
    """Run ``script(client, server, ctx)`` against ``mod``'s server built
    from ``make() -> (server kwargs, ctx)``; returns the transcript and
    what the script returned."""
    kwargs, ctx = make()
    srv = mod.MotionCloneServer(port=0, **kwargs)
    srv.start()
    try:
        client = Client(srv.port)
        extra = script(client, srv, ctx)
    finally:
        srv.shutdown()
    return client.transcript, extra


def _both(script, make):
    """The exchange against both packages; their transcripts must be
    equal.  Returns the port's (transcript, script's result) and the
    JAX's result."""
    out = {name: _exchange(mod, script, make) for name, mod in PACKAGES.items()}
    assert out["port"][0] == out["jax"][0]
    return out["port"][0], out["port"][1], out["jax"][1]


def test_submission_order_and_failure_isolation():
    def script(c, srv, ctx):
        gates, calls = ctx
        # "one" holds the worker until the other two are queued behind it,
        # so both servers answer the same queue positions
        ids = [c.post("one")]
        c.wait(ids[0], "running", record=False)
        ids += [c.post(p) for p in ("boom", "two")]
        gates["one"].set()
        c.wait(ids[0], "done")
        c.wait(ids[1], "failed")
        c.wait(ids[2], "done")
        c.call("/jobs")
        return calls

    def make():
        gates = {"one": threading.Event()}
        run_job, _, calls = _stub(gates)
        return dict(run_job=run_job, max_queue=4), (gates, calls)

    transcript, calls, jax_calls = _both(script, make)
    statuses = [body["status"] for _, path, _, body in transcript if path.startswith("/jobs/")]
    assert statuses == ["done", "failed", "done"]
    assert [j["status"] for j in transcript[-1][3]["jobs"]] == ["done", "failed", "done"]
    assert "synthetic job failure" in transcript[-1][3]["jobs"][1]["error"]
    assert calls == jax_calls == ["one", "boom", "two"]


def test_batch_drain_and_lone_job_on_the_single_path():
    def script(c, srv, ctx):
        gates, calls = ctx
        first = c.post("first")
        c.wait(first, "running")
        pair = [c.post("second"), c.post("third")]  # queued behind "first"
        gates["first"].set()
        for job in [first] + pair:
            c.wait(job, "done")
        lone = c.post("fourth")
        c.wait(lone, "done")
        c.call("/metrics")
        return calls

    def make():
        gates = {"first": threading.Event()}
        run_job, run_jobs_batch, calls = _stub(gates)
        return (dict(run_job=run_job, run_jobs_batch=run_jobs_batch, batch_max=2),
                (gates, calls))

    _, calls, jax_calls = _both(script, make)
    assert calls == jax_calls == ["first", ["second", "third"], "fourth"]


def test_job_timeout_and_the_queue_draining_on():
    def script(c, srv, gates):
        wedged = c.post("wedged")
        # "next" is posted once the worker has taken "wedged" off the queue
        # (running, or already failed at the 0.3 s timeout), so both servers
        # answer the same queue position
        c.wait(wedged, "running", "failed", record=False)
        after = c.post("next")
        c.wait(wedged, "failed")
        c.wait(after, "done")
        gates["wedged"].set()  # the abandoned thread ends late: no resurrection
        time.sleep(0.2)
        c.call(f"/jobs/{wedged}")
        c.call("/metrics")

    def make():
        gates = {"wedged": threading.Event()}
        return dict(run_job=_stub(gates)[0], max_queue=8, job_timeout=0.3), gates

    transcript, _, _ = _both(script, make)
    failed = [body for _, path, _, body in transcript if path == "/jobs/job0"]
    assert all(b["status"] == "failed" and "timeout" in b["error"] for b in failed)
    assert failed[-1]["output_path"] is None
    assert "motionclone_jobs_failed 1" in transcript[-1][3]
    assert "motionclone_jobs_done 1" in transcript[-1][3]


def test_full_queue_answers_503():
    def script(c, srv, gates):
        first = c.post("first")
        c.wait(first, "running")
        codes = [c.call("/generate", {"video_path": "v.mp4", "new_prompt": p})[0]
                 for p in ("b", "c", "d")]
        c.call("/jobs")
        gates["first"].set()
        return codes

    def make():
        gates = {"first": threading.Event()}
        return dict(run_job=_stub(gates)[0], max_queue=2), gates

    transcript, codes, jax_codes = _both(script, make)
    assert codes == jax_codes == [202, 202, 503]
    assert transcript[-2][3] == {"error": "queue full", "queue_depth": 2}
    assert len(transcript[-1][3]["jobs"]) == 3  # no phantom record of the 503


def test_validation_errors_and_unknown_routes():
    base = {"video_path": "v.mp4", "new_prompt": "x"}
    bodies = [{"new_prompt": "x"}, {**base, "nope": 1}, [1, 2], {**base, "image_index": 5},
              {**base, "condition_image_paths": "a.png"}, {**base, "seed": "7"},
              {**base, "controlnet_scale": "big"}, {"video_path": "", "new_prompt": "x"}]

    def script(c, srv, _):
        for body in bodies:
            c.call("/generate", body)
        c.call("/generate", raw=b"{not json")
        c.call("/jobs/deadbeef")
        c.call("/nope")
        c.call("/nope", {"a": 1})
        c.call("/jobs")

    transcript, _, _ = _both(script, lambda: (dict(run_job=_stub()[0]), None))
    assert [t[2] for t in transcript] == [400] * 9 + [404, 404, 404, 200]
    assert transcript[-1][3] == {"jobs": []}


def test_health_and_metrics_counters_only_grow():
    def script(c, srv, _):
        c.call("/health")
        c.call("/metrics")
        for p in ("m1", "boom", "m2"):
            c.wait(c.post(p), "done", "failed")
            c.call("/metrics")
        c.call("/health")

    transcript, _, _ = _both(script, lambda: (dict(run_job=_stub()[0]), None))
    health = [body for _, path, _, body in transcript if path == "/health"]
    assert all(h["status"] == "ok" and h["worker_alive"] for h in health)
    series = {}
    for _, path, _, body in transcript:
        if path == "/metrics":
            for line in body:
                if line.startswith(("motionclone_jobs_total", "motionclone_jobs_done",
                                    "motionclone_jobs_failed")):
                    name, value = line.split()
                    series.setdefault(name, []).append(int(value))
    assert series["motionclone_jobs_total"] == [0, 1, 2, 3]
    assert series["motionclone_jobs_done"] == [0, 1, 1, 2]
    assert series["motionclone_jobs_failed"] == [0, 0, 1, 1]


def test_retention_is_bounded_and_counters_monotonic():
    out = {}
    for name, mod in PACKAGES.items():
        store = mod.JobStore(max_queue=16, max_terminal=3)
        ids = [store.submit({"video_path": "v", "new_prompt": str(i)}).job_id
               for i in range(8)]
        worker = threading.Thread(target=mod._worker_loop,
                                  args=(store, lambda ex: "out.mp4"), daemon=True)
        worker.start()
        store.work.join()
        store.shutting_down.set()
        store.work.put_nowait(None)
        worker.join(timeout=5)
        assert not worker.is_alive()
        assert [r["job_id"] for r in store.all()] == ids[-3:]
        client = Client(0)
        for i in ids:
            client.token(i)
        counters = store.counters()
        out[name] = (client.norm(store.all()), counters["jobs_total"], counters["jobs_done"],
                     store.get(ids[0]))
    assert out["port"] == out["jax"]
    assert out["port"][1:] == (8, 8, None)


def test_shutdown_returns_on_a_full_queue():
    out = {}
    for name, mod in PACKAGES.items():
        release = threading.Event()
        srv = mod.MotionCloneServer(lambda ex, r=release: (r.wait(10), "out.mp4")[1], port=0,
                                    max_queue=1)
        srv.start()
        c = Client(srv.port)
        c.wait(c.post("a"), "running")
        codes = [c.call("/generate", {"video_path": "v", "new_prompt": p})[0]
                 for p in ("b", "c")]
        full = srv.store.work.full()
        t0 = time.time()
        release.set()
        srv.shutdown()
        out[name] = (codes, full, srv._worker.is_alive())
        assert time.time() - t0 < 15
    assert out["port"] == out["jax"] == ([202, 503], True, False)


# ---------------------------------------------------------------------------
# end to end: cli.serve_main on the synthetic model directory
# ---------------------------------------------------------------------------


def test_serve_main_runs_jobs_on_its_threads_as_run_example(model_dir, monkeypatch):  # noqa: F811
    monkeypatch.chdir(model_dir)
    r = np.random.default_rng(12)
    jobs = [("sa.mp4", "a cat running", 42), ("sb.mp4", "a dog", 7), ("sc.mp4", "a car", 3)]
    for video, _, _ in jobs:
        write_video(video, r.integers(0, 255, size=(6, 64, 64, 3), dtype=np.uint8), fps=8)
    written, gate = {}, threading.Event()
    write = runner.MotionCloneRuntime.write_latents
    run_example = runner.MotionCloneRuntime.run_example

    def write_spy(self, path, latents):
        written[path] = (latents.clone(), threading.current_thread())
        return write(self, path, latents)

    def gated(self, example, **kwargs):  # the lone job waits for the pair to queue
        gate.wait(timeout=60)
        return run_example(self, example, **kwargs)

    batches, sweep = [], tsweep.run_sweep
    monkeypatch.setattr(tsweep, "run_sweep", lambda rt, examples, **kw: (
        batches.append([e.new_prompt for e in examples]), sweep(rt, examples, **kw))[1])
    monkeypatch.setattr(runner.MotionCloneRuntime, "write_latents", write_spy)
    monkeypatch.setattr(runner.MotionCloneRuntime, "run_example", gated)
    argv = list(ARGS)
    argv[argv.index("out")] = "served"
    servers = []
    main = threading.Thread(target=serve_main, kwargs=dict(
        argv=argv + ["--batch-max", "2", "--port", "0"], ready=servers.append))
    main.start()
    try:
        deadline = time.time() + 120
        while not servers and main.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        c = Client(servers[0].port)
        ids = [c.post(jobs[0][1], video_path=jobs[0][0], seed=jobs[0][2])]
        c.wait(ids[0], "running")
        ids += [c.post(p, video_path=v, seed=s) for v, p, s in jobs[1:]]
        gate.set()
        recs = [c.wait(i, "done", "failed", timeout=120) for i in ids]
        health, metrics = c.call("/health")[1], c.call("/metrics")[1]
    finally:
        gate.set()
        if servers:
            servers[0].shutdown()
        main.join(timeout=30)
    assert not main.is_alive() and not servers[0]._worker.is_alive()
    assert [rec["status"] for rec in recs] == ["done"] * 3, recs
    assert batches == [["a dog", "a car"]]  # the pair as one batch, the first alone
    assert health["queue_depth"] == 0 and "motionclone_jobs_done 3" in metrics
    assert all(t is not threading.main_thread() for _, t in written.values())

    # the same examples through run_example on the main thread
    monkeypatch.setattr(runner.MotionCloneRuntime, "run_example", run_example)
    rt = runner.MotionCloneRuntime(SD, load_inference_config(
        "inference.yaml", width=64, height=64, video_length=4), device="cpu",
        dtype=torch.float32)
    for i, (video, prompt, seed) in enumerate(jobs):
        path = rt.run_example(Example(video, prompt, seed), motion_rep_dir="main_reps",
                              output_dir="main_out", verbose=False)
        served = os.path.join("served", os.path.basename(path))
        assert recs[i]["output_path"] == served
        got, want = written[served][0], written[path][0]
        if i == 0:  # the lone job: run_example on a job thread
            assert torch.equal(got, want)
        else:  # the pair: one batch through the sweep
            torch.testing.assert_close(got, want, **SERIAL_TOL)
