"""fused_roofline: the fused modules' share of their roofline: over
every call of kernels 5-8 in the traced window, the sum of each call's
least time by the roofline (``work/bounds.py``, from the call's shapes)
over the sum of the device time of the kernels it launched."""

from bench_h100.work.bounds import bound_s


def read(run):
    calls = [c for c in run.trace.calls if c.layer == "fused" and c.device_s > 0]
    if not calls:
        return None
    return 100.0 * sum(bound_s(c.flops, c.nbytes) for c in calls) / sum(c.device_s for c in calls)
