"""One run of one cell of the port's benchmark.

The cell (``BENCHMARK.json``'s workload) names a configuration file
(``configs/``), a traffic mix (``traffic/<mix>.json``) and has its limits
(``limits/<cell>.json``, which it must have); the configuration names its
model family (``families/<name>.py``), and the per-layer metrics are
readers found by name (``metrics/<metric>.py``).  Everything that depends
on the model's architecture is the family's: this module names no
network.  A run:

1. set-up (``setup_s``), in stages timed apart (``Laps``): the imports and
   the card, the kernel library, the seeded weights on the device, the
   family's build of the program at the configuration's type and
   attention path, the inputs of the jobs the window may run, and the
   family's warm-up of the cell's own shapes;
2. the window: jobs back to back, always in a closed loop of one client;
   the first always runs, another starts only if the elapsed time plus
   the longest job so far fits in ``seconds`` and fewer than the traffic's
   ``max_jobs`` ran.  A job is the family's ``run_job``.  The window is
   never traced: its step times and its length are what the end-to-end
   metrics, and the per-layer step times and ``mfu``, read;
3. with ``trace``, one more job under the profiler, whose trace gives the
   per-layer metrics that need device times (rooflines, idle share);
4. the peak memory is read, the program is freed, and the family's plain
   reference judges one job of the window drawn from the seed
   (``check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch

from bench_h100 import check, families, inputs, weights
from bench_h100.reference.precision import fp8_round, to_fp8
from bench_h100.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_DOMAIN = 102  # the seed's stream that picks the checked job and steps


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: str = ROOT

    @property
    def family(self):
        """The configuration's family module (``families/__init__.py``)."""
        return families.load(self.config.get("family", families.DEFAULT), self.root)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def read(*parts):
        with open(os.path.join(root, *parts)) as fh:
            return json.load(fh)

    mine = lambda m: name in m.get("workloads", [name])
    here = os.path.join(root, "bench_h100")
    limits_path = os.path.join(here, "limits", f"{name}.json")
    if not os.path.exists(limits_path):
        raise SystemExit(f"workload {name!r} has no limits file {limits_path}")
    traffic = read(here, "traffic", f"{w['traffic']}.json")
    if set(traffic["loop"]) != {"max_jobs"}:
        raise SystemExit(f"traffic {w['traffic']!r}: the loop is always closed with one "
                         f"client and takes only max_jobs, not {sorted(traffic['loop'])}")
    cell = Cell(name, read(conf["file"]), traffic, read(limits_path)["limits"],
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], root)
    cell.family  # a missing or incomplete family module is refused before a run
    return cell


# ---------------------------------------------------------------------------
# the program's steps
# ---------------------------------------------------------------------------


class StateRecorder:
    """The program's sampling state before chosen steps of a job, and the
    guidance gradient of chosen guided steps, taken from the inputs of the
    family's ``denoiser`` (a forward pre-hook: its first call of each new
    timestep starts a step, its first B rows are the latents; the input of
    the conditional pass, which autograd differentiates, gets a hook that
    keeps the gradient the step computes for it).  The family's
    ``run_job`` arms it around sampling."""

    def __init__(self, denoiser, steps, grad_steps, batch: int):
        self.steps, self.grad_steps, self.batch = set(steps), set(grad_steps), batch
        self.armed = False
        self.handle = denoiser.register_forward_pre_hook(self._hook)

    def arm(self) -> None:
        self.armed, self.states, self.grads, self.index, self.last_t = True, {}, {}, -1, None

    def disarm(self) -> None:
        self.armed = False

    def _keep_grad(self, index):
        def keep(grad):
            self.grads[index] = grad.detach().clone()
        return keep

    def _hook(self, _module, args):
        if not self.armed:
            return
        t = int(args[1])
        if t != self.last_t:
            self.index, self.last_t = self.index + 1, t
            if self.index in self.steps:
                self.states[self.index] = args[0][:self.batch].detach().clone()
        elif args[0].requires_grad and self.index in self.grad_steps:
            args[0].register_hook(self._keep_grad(self.index))

    def close(self) -> None:
        self.handle.remove()


def mark(device):
    """A point in the device's work: a CUDA event on a card, else the host's clock."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def closed_loop(job: Callable[[int], object], seconds: float, max_jobs: int,
                sync: Callable[[], None], clock: Callable[[], float] = time.perf_counter):
    """Jobs back to back, one client: the first always runs; another
    starts only if the elapsed time plus the longest job so far fits in
    ``seconds`` (and fewer than ``max_jobs`` ran).  Both ends of the
    window are read after ``sync``.  -> (results, window seconds, each
    job's seconds)."""
    results, durations = [], []
    sync()
    t0 = clock()
    while True:
        ts = clock()
        results.append(job(len(results)))
        sync()
        te = clock()
        durations.append(te - ts)
        if te - t0 + max(durations) > seconds or len(results) == max_jobs:
            return results, te - t0, durations


def _stats(ms: List[float]):
    return [sum(ms) / len(ms), min(ms), max(ms)] if ms else None


@dataclasses.dataclass
class RunData:
    """What the per-layer metric readers read."""

    step_ms: Dict[str, List[float]]
    window_s: float
    jobs: int
    job_flops: Callable[[], float]
    trace: object = None


def load_reader(name: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<name>.py``, or else of
    ``metrics/<quantity>.py`` for a name ``<quantity>.<suffix>``: the
    suffix (``sweep``, ``clip``) names the cells whose end-to-end metric
    the quantity moves, and one reader serves every suffix."""
    path = os.path.join(root, "bench_h100", "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "bench_h100", "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_h100.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pick(traffic: Mapping, seed: int, jobs: int):
    """(the checked job, the checked steps) drawn from the seed: the first
    step of each phase, and the rest of the traffic's count in each phase
    drawn from its other steps."""
    rng = np.random.default_rng([seed, CHECK_DOMAIN])
    s = traffic["schedule"]
    g, n = s["guidance_steps"], s["inference_steps"]
    c = traffic["check"]
    steps = sorted(int(i) for i in np.concatenate([
        [0], 1 + rng.choice(g - 1, c["guided_steps"] - 1, replace=False),
        [g], g + 1 + rng.choice(n - g - 1, c["vanilla_steps"] - 1, replace=False)]))
    return int(rng.integers(0, jobs)), steps


def reference_numbers(cell: Cell, seed: int, inp: inputs.JobInputs, record: Mapping,
                      steps, device, control: bool = False):
    """(the numbers of the program's ``record`` of a job against the plain
    reference (f32, TF32 off), with ``control`` the numbers of the
    reference computed in fp8 in the program's place (else None), and the
    guidance's share of the checked guided steps)."""
    fam, config, traffic = cell.family, cell.config, cell.traffic
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tensors = weights.make(fam.networks(config), seed, device)
        nets = fam.networks(config, device)
        for key, m in nets.items():
            weights.load(m, {k: v.float() for k, v in tensors[key].items()})
        del tensors
        ref = fam.reference(nets, config, traffic, device, inp, record, steps)
        ref["guided_steps"] = traffic["schedule"]["guidance_steps"]
        numbers = check.readings(check.program_record(record, steps), ref, fam.readings)
        share = check.guidance_share(ref)
        if not control:
            return numbers, None, share
        for m in nets.values():
            to_fp8(m)
        got = fam.reference(nets, config, traffic, device, inp, record, steps, store=fp8_round)
        return numbers, check.readings(got, ref, fam.readings), share
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def video_ok(frames: torch.Tensor, traffic: Mapping) -> List[bool]:
    v = traffic["video"]
    shape = (v["frames"], v["height"], v["width"], 3)
    return [tuple(x.shape) == shape and x.dtype == torch.uint8 and int(x.max()) > int(x.min())
            for x in frames]


class Laps:
    """The seconds of each stage of the set-up, each read once the device
    has finished the stage's work; ``before`` are (stage, end) pairs of
    the process's stages before the run."""

    def __init__(self, started: float, device, before=()):
        self.t, self.device, self.seconds = started, device, {}
        for stage, end in before:
            self.seconds[stage], self.t = end - self.t, end

    def __call__(self, stage: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[stage], self.t = now - self.t, now


def traced_job(family, pipe, inp: inputs.JobInputs, traffic: Mapping, device):
    """One job under the profiler, after the measured window (whose step
    times the profiler's host work would stretch): the trace's summary."""
    tracer = Tracer(True, family.kernels())
    tracer.patch()
    prof = tracer.profiler()
    try:
        with prof, tracer.span("window"):
            family.run_job(pipe, inp, traffic, tracer)
            sync(device)
    finally:
        tracer.unpatch()
    return tracer.reduce(prof)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        control: bool = False, before=()) -> Dict[str, object]:
    """One run; returns the result line's fields and the checks.  With
    ``control`` also the fp8 control's numbers (``control.py``).  The
    set-up runs from ``started``; ``before`` are (stage, end) pairs of the
    process's stages before this call."""
    device = torch.device(device)
    laps = Laps(started, device, before)
    laps("imports")
    fam, config, traffic = cell.family, cell.config, cell.traffic
    b = traffic["batch"]
    max_jobs = traffic["loop"]["max_jobs"]
    if device.type == "cuda":
        from motionclone_tpu_torch.ops.build import build_info, load_library

        load_library()
        laps("library")
    tensors = weights.make(fam.networks(config), seed, device)
    laps("weights")
    pipe = fam.build_program(config, traffic, tensors, device, laps)
    del tensors
    laps("program")
    jobs_in = [inputs.make_job(traffic, fam, config, seed, k, device) for k in range(max_jobs)]
    laps("inputs")
    fam.warm_up(pipe, inputs.make_job(traffic, fam, config, seed, -1, device), traffic)
    laps("warm_up")
    setup_s = laps.t - started

    _, steps = pick(traffic, seed, 1)
    g = traffic["schedule"]["guidance_steps"]
    recorder = StateRecorder(fam.denoiser(pipe), {0} | set(steps) | {i + 1 for i in steps},
                             [i for i in steps if i < g], b)
    untraced = Tracer(False)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        results, window_s, jobs_s = closed_loop(
            lambda k: fam.run_job(pipe, jobs_in[k], traffic, untraced, recorder),
            seconds, max_jobs, lambda: sync(device))
    finally:
        recorder.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = traced_job(fam, pipe, jobs_in[0], traffic, device) if trace else None

    step_ms: Dict[str, List[float]] = {"guided": [], "vanilla": []}
    for r in results:
        marks = r.pop("marks")
        for (_, a), (kind, z) in zip(marks, marks[1:]):
            step_ms[kind].append(_ms(a, z))
    ok = [flag for r in results for flag in video_ok(r["frames"], traffic)]
    k, steps = pick(traffic, seed, len(results))
    keep = results[k]
    del pipe, results
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, control_numbers, share = reference_numbers(cell, seed, jobs_in[k], keep, steps,
                                                        device, control)

    jobs = len(ok) // b
    diagnostics = {"setup_stages_s": laps.seconds, "jobs_s": jobs_s,
                   "guided_ms": _stats(step_ms["guided"]),
                   "vanilla_ms": _stats(step_ms["vanilla"]), "guidance_share": share}
    if device.type == "cuda":
        diagnostics["library"] = {"cached": build_info.get("cached"),
                                  "build_s": build_info.get("seconds")}
    out = {"correct": check.verdict(numbers, cell.limits) and all(ok),
           "attempted": len(ok), "failed": ok.count(False),
           "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
           "checks": check.lines(numbers, cell.limits), "checked_job": k, "steps": steps,
           "reference_s": time.perf_counter() - t_ref, "diagnostics": diagnostics}
    if control:
        out["control"] = control_numbers
    if not trace:
        # by the quantity's name; ``video_s.<suffix>`` is video_s in the suffix's cells
        e2e = {"video_s": window_s / len(ok), "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                          for m in cell.end_to_end}
        return out
    data = RunData(step_ms, window_s, jobs, lambda: fam.job_flops(config, traffic)["job"],
                   summary)
    metrics = {}
    for m in cell.per_layer:
        value = load_reader(m["name"], cell.root)(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    out["busy_s"], out["traced_window_s"] = summary.busy_s, summary.window_s
    out["breakdown"] = {"device_ops": [[n, s] for n, s in summary.device_ops],
                        "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    return out
