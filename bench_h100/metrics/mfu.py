"""mfu: the model FLOPs of the window's finished jobs (the model family's
``job_flops``, counted over the plain reference at the cell's shapes) over
the window's seconds times the card's dense bf16 peak (``work/bounds.py``)."""

from bench_h100.work.bounds import PEAK_BF16_FLOPS


def read(run):
    if run.jobs == 0:
        return None
    return 100.0 * run.jobs * run.job_flops() / (run.window_s * PEAK_BF16_FLOPS)
