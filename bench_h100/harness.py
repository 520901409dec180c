"""One run of one cell of the port's benchmark.

The cell (``BENCHMARK.json``'s workload) names a configuration file
(``configs/``), a traffic mix (``traffic/<mix>.json``) and has its limits
(``limits/<cell>.json``, which it must have); the per-layer metrics are
readers found by name (``metrics/<metric>.py``).  A run:

1. set-up (``setup_s``), in stages timed apart (``Laps``): the imports and
   the card, the kernel library, the seeded weights on the device, the
   program's ``MotionClonePipeline`` at the configuration's type and
   attention path, the inputs of the jobs the window may run, and a
   warm-up of the cell's own shapes (text, encode, the conditions, one
   extraction, one guided and one vanilla step, one decode);
2. the window: jobs back to back, always in a closed loop of one client;
   the first always runs, another starts only if the elapsed time plus
   the longest job so far fits in ``seconds`` and fewer than the traffic's
   ``max_jobs`` ran.  A job runs the sweep's batch in its order
   (``pipeline/sweep.py``'s ``_run_batch``): CLIP on 2B+1 rows, the VAE
   encode, the i2v conditions, extraction, guided sampling at the full
   schedule, and each example's decode to uint8 copied to the host.  The
   window is never traced: its step times and its length are what the
   end-to-end metrics, and the per-layer step times and ``mfu``, read;
3. with ``trace``, one more job under the profiler, whose trace gives the
   per-layer metrics that need device times (rooflines, idle share);
4. the peak memory is read, the program is freed, and the plain reference
   judges one job of the window drawn from the seed (``check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from bench_h100 import check, inputs, weights
from bench_h100.reference import job as ref_job
from bench_h100.reference import nets as ref_nets
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
    return Cell(name, read(conf["file"]), traffic, read(limits_path)["limits"],
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], root)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------


def _tuples(d: Mapping) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_program(config: Mapping, traffic: Mapping, tensors: Mapping, device,
                  lap: Callable[[str], None] = lambda stage: None):
    """The program's pipeline for the configuration, its weights ``tensors``
    (``lap`` marks the end of the program's imports and of its modules)."""
    from motionclone_tpu_torch.config import (InferenceConfig, MotionModuleConfig,
                                              NoiseScheduleConfig, UNet3DConfig)
    from motionclone_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
    from motionclone_tpu_torch.models.sparse_controlnet import (SparseControlNetConfig,
                                                                SparseControlNetModel)
    from motionclone_tpu_torch.models.unet3d import UNet3DConditionModel
    from motionclone_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from motionclone_tpu_torch.pipeline.motionclone import MotionClonePipeline

    lap("program_imports")
    dtype = getattr(torch, config["dtype"])

    def make(cls, cfg, key):
        with torch.device("meta"), ref_nets.initialisers_off():
            m = cls(cfg)
        m = m.to(dtype).to_empty(device=device)
        weights.load(m, tensors[key])
        return m

    unet_cfg = UNet3DConfig(**dict(_tuples(config["unet"]),
                                   motion_module=MotionModuleConfig(
                                       **_tuples(config["unet"]["motion_module"]))))
    cn = None
    if config.get("controlnet"):
        c = config["controlnet"]
        cn_cfg = SparseControlNetConfig(**dict(_tuples(c), motion_module=MotionModuleConfig(
            **_tuples(c["motion_module"]))))
        cn = make(SparseControlNetModel, cn_cfg, "controlnet")
    s, v = traffic["schedule"], traffic["video"]
    infer = InferenceConfig(
        cfg_scale=s["cfg_scale"], inference_steps=s["inference_steps"],
        guidance_fraction=s["guidance_fraction"], guidance_steps=s["guidance_steps"],
        warm_up_steps=s["warm_up_steps"], cool_up_steps=s["cool_up_steps"],
        motion_guidance_weight=s["motion_guidance_weight"],
        motion_guidance_blocks=tuple(s["motion_guidance_blocks"]),
        add_noise_step=s["add_noise_step"], width=v["width"], height=v["height"],
        video_length=v["frames"])
    unet = make(UNet3DConditionModel, unet_cfg, "unet")
    vae = make(AutoencoderKL, VAEConfig(**_tuples(config["vae"])), "vae")
    text = make(CLIPTextModel, CLIPTextConfig(**config["text_encoder"]), "text_encoder")
    lap("program_modules")
    return MotionClonePipeline(
        unet_cfg, NoiseScheduleConfig(**config["noise_schedule"]), infer, unet, vae=vae,
        text_encoder=text, device=device, dtype=dtype, attention_impl=config["attention_impl"],
        controlnet=cn)


class StateRecorder:
    """The program's sampling state before chosen steps of a job, and the
    guidance gradient of chosen guided steps, taken from the UNet's inputs
    (a forward pre-hook: the first UNet call of each new timestep starts a
    step, its first B rows are the latents; the input of the conditional
    pass, which autograd differentiates, gets a hook that keeps the
    gradient the step computes for it)."""

    def __init__(self, unet, steps, grad_steps, batch: int):
        self.steps, self.grad_steps, self.batch = set(steps), set(grad_steps), batch
        self.armed = False
        self.handle = unet.register_forward_pre_hook(self._hook)

    def arm(self) -> None:
        self.armed, self.states, self.grads, self.index, self.last_t = True, {}, {}, -1, None

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


def _mark(device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_job(pipe, inp: inputs.JobInputs, traffic: Mapping, tracer: Tracer,
            recorder: Optional[StateRecorder] = None) -> Dict[str, object]:
    """One job through the program; returns its outputs and step marks."""
    from motionclone_tpu_torch.models.sparse_controlnet import scatter_condition
    from motionclone_tpu_torch.utils import rng

    b, f = traffic["batch"], traffic["video"]["frames"]
    g = traffic["schedule"]["guidance_steps"]
    cond = traffic.get("condition")
    with tracer.span("text"):
        emb = pipe.encode_text(inp.ids)
    with tracer.span("encode"):
        latents = pipe.encode_video(inp.clips, inp.seeds)
    cn_extract = cn_sample = cond_latents = None
    if cond is not None:
        idx = list(cond["image_index"])
        scale = torch.tensor([cond["scale"]] * b, dtype=pipe.dtype).reshape(-1, 1, 1, 1, 1)

        def batched(frames):  # the sweep's _batched_condition of per-example scatters
            pairs = [scatter_condition(frames[e:e + 1].to(pipe.dtype), idx, f) for e in range(b)]
            return (torch.cat([c for c, _ in pairs]), torch.cat([m for _, m in pairs]), scale)

        with tracer.span("condition"):
            cn_extract = batched(latents[:, idx])
    with tracer.span("extract"):
        rep = pipe.extract_motion_representation(latents, emb[2 * b:].repeat(b, 1, 1),
                                                 seed=inp.seeds, cn_cond=cn_extract)
    if cond is not None:
        with tracer.span("condition"):
            cond_latents = pipe.encode_video(inp.clips[:, idx], inp.seeds,
                                             rng.CN_IMAGE_POSTERIOR)
            cn_sample = batched(cond_latents)
    marks = [("start", _mark(pipe.device))]

    def on_step(i, guided):
        marks.append(("guided" if guided else "vanilla", _mark(pipe.device)))
        tracer.switch(None if i + 1 >= len(pipe.fns.timesteps)
                      else "guided_step" if i + 1 < g else "vanilla_step")

    if recorder is not None:
        recorder.arm()
    tracer.switch("guided_step" if g > 0 else "vanilla_step")
    final = pipe.sample_latents(emb[b:2 * b], emb[:b], rep, seed=inp.seeds, on_step=on_step,
                                cn_cond=cn_sample)
    tracer.switch(None)
    if recorder is not None:
        recorder.armed = False
    videos = []
    with tracer.span("decode"):
        for e in range(b):
            video = pipe.decode_latents(final[e:e + 1])
            video01 = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
            videos.append(torch.round(video01 * 255.0).to(torch.uint8).cpu())
    return dict(text=emb, latents=latents, condition=cond_latents, rep=rep, final=final,
                frames=torch.stack(videos), marks=marks,
                states=dict(recorder.states) if recorder is not None else {},
                grads=dict(recorder.grads) if recorder is not None else {})


def warm_up(pipe, inp: inputs.JobInputs, traffic: Mapping) -> None:
    """The cell's shapes once: a job's stages with one guided and one
    vanilla step in place of the schedule."""
    fns = pipe.fns
    t, tp = (int(x) for x in fns.timesteps[:2])
    g = traffic["schedule"]["guidance_steps"]
    # the guided step's timesteps, then the vanilla phase's first
    tv, tpv = int(fns.timesteps[g]), int(fns.timesteps[g + 1])

    class Short:  # the job's stages, sampling replaced by one step of each kind
        def __getattr__(self, name):
            return getattr(pipe, name)

        def sample_latents(self, uncond, cond, rep, seed, on_step=None, cn_cond=None):
            lat = pipe.initial_latents(seed)
            cn = pipe._cn_cond(cn_cond)
            lat, _ = fns.guided_step(lat, t, tp, 1.0, uncond.to(pipe.dtype),
                                     cond.to(pipe.dtype), rep, cn)
            return fns.vanilla_step(lat, tv, tpv, uncond.to(pipe.dtype), cond.to(pipe.dtype), cn)

    run_job(Short(), inp, traffic, Tracer(False))
    _sync(pipe.device)


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
    ``metrics/<quantity>.py`` for a name ``<quantity>.<family>``: the
    family (``sweep``, ``clip``) names the cells whose end-to-end metric
    the quantity moves, and one reader serves every family."""
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
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tensors = weights.make(cell.config, seed, device)
        nets = ref_nets.build(cell.config, device)
        for key, m in nets.items():
            weights.load(m, {k: v.float() for k, v in tensors[key].items()})
        del tensors
        args = (inp.ids, inp.clips, inp.seeds, record, steps)
        ref = ref_job.Reference(nets, cell.config, cell.traffic, device).run(*args)
        ref["guided_steps"] = cell.traffic["schedule"]["guidance_steps"]
        numbers = check.readings(check.program_record(record, steps), ref)
        share = check.guidance_share(ref)
        if not control:
            return numbers, None, share
        for m in nets.values():
            to_fp8(m)
        got = ref_job.Reference(nets, cell.config, cell.traffic, device,
                                store=fp8_round).run(*args)
        return numbers, check.readings(got, ref), share
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
        _sync(self.device)
        now = time.perf_counter()
        self.seconds[stage], self.t = now - self.t, now


def traced_job(pipe, inp: inputs.JobInputs, traffic: Mapping, device):
    """One job under the profiler, after the measured window (whose step
    times the profiler's host work would stretch): the trace's summary."""
    tracer = Tracer(True)
    tracer.patch()
    prof = tracer.profiler()
    try:
        with prof, tracer.span("window"):
            run_job(pipe, inp, traffic, tracer)
            _sync(device)
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
    traffic = cell.traffic
    b = traffic["batch"]
    vocab = cell.config["text_encoder"]["vocab_size"]
    max_jobs = traffic["loop"]["max_jobs"]
    if device.type == "cuda":
        from motionclone_tpu_torch.ops.build import build_info, load_library

        load_library()
        laps("library")
    tensors = weights.make(cell.config, seed, device)
    laps("weights")
    pipe = build_program(cell.config, traffic, tensors, device, laps)
    del tensors
    laps("program")
    jobs_in = [inputs.make_job(traffic, vocab, seed, k, device) for k in range(max_jobs)]
    laps("inputs")
    warm_up(pipe, inputs.make_job(traffic, vocab, seed, -1, device), traffic)
    laps("warm_up")
    setup_s = laps.t - started

    _, steps = pick(traffic, seed, 1)
    g = traffic["schedule"]["guidance_steps"]
    recorder = StateRecorder(pipe.unet, {0} | set(steps) | {i + 1 for i in steps},
                             [i for i in steps if i < g], b)
    untraced = Tracer(False)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        results, window_s, jobs_s = closed_loop(
            lambda k: run_job(pipe, jobs_in[k], traffic, untraced, recorder),
            seconds, max_jobs, lambda: _sync(device))
    finally:
        recorder.close()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    summary = traced_job(pipe, jobs_in[0], traffic, device) if trace else None

    step_ms: Dict[str, List[float]] = {"guided": [], "vanilla": []}
    for r in results:
        marks = r.pop("marks")
        for (_, a), (kind, z) in zip(marks, marks[1:]):
            step_ms[kind].append(_ms(a, z))
    ok = [flag for r in results for flag in video_ok(r["frames"], traffic)]
    k, steps = pick(traffic, seed, len(results))
    record = results[k]
    keep = {key: record[key] for key in ("text", "latents", "condition", "rep", "final",
                                         "states", "grads", "frames")}
    del pipe, results, record
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
        # by the quantity's name; ``video_s.<family>`` is video_s in a family's cells
        e2e = {"video_s": window_s / len(ok), "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                          for m in cell.end_to_end}
        return out
    from bench_h100.work.flops import job_flops

    data = RunData(step_ms, window_s, jobs, lambda: job_flops(cell.config, traffic)["job"],
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
