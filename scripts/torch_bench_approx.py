"""Seconds per video of the PyTorch port under the opt-in approx caches.

Port of scripts/bench_approx.py: t2v_camera at 512x512x16 frames (100
steps, 50 guided) at SD1.5 + AnimateDiff v3 width with seeded random bf16
weights, built as scripts/torch_approx_quality.py builds it: one build
with every cache on, whose refresh intervals and weights ``sample``
overrides per point, so every point runs the same modules.  A first run
of the first point warms the kernels up and is not reported.  Per point,
one JSON line on standard output: the seconds of sampling and decode on
fresh latents (``value``), and the median milliseconds of the full and
the skip steps of each phase (the time between CUDA events recorded after
each step on a card; wall clock on the CPU).  It is a script, not a
benchmark: it writes nothing but its lines.

    python3 scripts/torch_bench_approx.py [--device DEV] [KU:KG[:w[:KS[:ws]]] ...]

The default points are 3:1 5:1 3:2 5:2; 1:1 is the exact path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_approx_quality as aq  # noqa: E402

WORKLOAD = "t2v_camera"


def median(ms: list):
    return float(np.median(ms)) if ms else None


def timed_point(b: dict, point: tuple) -> dict:
    """One run of ``point`` on fresh latents: its seconds, and each step's
    milliseconds sorted by phase and by full or skip step."""
    dev = b["latents"].device
    lat = aq.fresh_latents(b)
    marks = []

    def on_step(i, guided):
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    aq.sync(dev)
    t0 = time.perf_counter()
    start = None
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    aq.run(b, point, lat, on_step=on_step)
    aq.sync(dev)
    seconds = time.perf_counter() - t0
    if dev.type == "cuda":
        ms = [a.elapsed_time(e) for a, e in zip([start] + marks[:-1], marks)]
    else:
        ms = list(np.diff([t0] + marks) * 1e3)
    ku, kg, _, ks, _ = point
    sched = b["pipe"].fns.schedule(chunk_steps=b["chunk_steps"], uncond_refresh=ku,
                                   guidance_refresh=kg, step_refresh=ks)
    g = b["infer"].guidance_steps
    split = {f"{phase}_{kind}_ms_median": median([m for i, m in enumerate(ms)
                                                  if (i < g) == guided
                                                  and bool(sched.full[i]) == full])
             for phase, guided in (("guided", True), ("vanilla", False))
             for kind, full in (("full", True), ("skip", False))}
    return dict(seconds=seconds, **split)


def main(argv=None) -> int:
    from motionclone_tpu_torch.pipeline.motionclone import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("points", nargs="*", help="KU:KG[:w[:KS[:ws]]] (default 3:1 5:1 3:2 5:2)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    points = [aq.parse_point(a) for a in args.points] or [
        (3, 1, 0.0, 1, 0.0), (5, 1, 0.0, 1, 0.0), (3, 2, 0.0, 1, 0.0), (5, 2, 0.0, 1, 0.0)]
    dev = resolve_device(args.device)
    where = aq.card(dev)
    aq.log(f"device {dev} ({where}); (K_uncond, K_guidance) sweep {points}")
    t0 = time.perf_counter()
    b = aq.build(WORKLOAD, dev)
    aq.run(b, points[0])
    aq.sync(dev)
    aq.log(f"build and first run: {time.perf_counter() - t0:.1f} s")
    for point in points:
        ku, kg, w, ks, ws = point
        rec = timed_point(b, point)
        aq.log(f"approx K_u={ku} K_g={kg} w={w} K_s={ks} w_s={ws}: "
               f"{rec['seconds']:.2f} s per video")
        print(json.dumps({
            "metric": (f"sec_per_video_{WORKLOAD}_{aq.SIDE}x{aq.SIDE}x{aq.FRAMES}f_approx_"
                       f"uncond{ku}_guidance{kg}{aq.point_tag(w, ks, ws)}"),
            "value": rec.pop("seconds"), "unit": "s", **rec, "card": where}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
