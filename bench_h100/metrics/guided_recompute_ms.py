"""guided_recompute_ms: the mean device time a guided step spends running
again the segments of its differentiated pass whose activations it did not
keep (the program's ``unet_guided_recompute`` spans, inside its
``unet_guided_bwd``), over the window's guided steps that recomputed any,
from the program's step record (``work/record.py``).  Nothing where the
program records no such span (a configuration without recompute, or a
program without the span)."""

from bench_h100.work.record import window_steps


def read(run):
    per_step = []
    for step in window_steps(run, guided_only=True) or ():
        ms = [r.device_ms for c in step.children if c.name == "unet_guided_bwd"
              for r in c.children if r.name == "unet_guided_recompute"]
        if ms and None not in ms:
            per_step.append(sum(ms))
    return sum(per_step) / len(per_step) if per_step else None
