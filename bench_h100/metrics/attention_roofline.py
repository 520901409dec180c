"""attention_roofline: the attention kernels' share of their roofline:
as fused_roofline, over every call of kernels 1-4 (flash and temporal
attention, forward and backward, square and rectangular)."""

from bench_h100.work.bounds import bound_s


def read(run):
    calls = [c for c in run.trace.calls if c.layer == "attention" and c.device_s > 0]
    if not calls:
        return None
    return 100.0 * sum(bound_s(c.flops, c.nbytes) for c in calls) / sum(c.device_s for c in calls)
