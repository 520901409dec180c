"""flash_roofline: kernels 1 and 2 alone (flash attention's forward and
backward, ``flash_fwd`` and ``flash_bwd``): over their calls in the traced
job, the sum of each call's least time by the roofline
(``work/bounds.py``, from the call's shapes) over the sum of the device
time of the kernels it launched.  The fused block's inner flash is kernel
5's or 6's and is not among them."""

from bench_h100.work.bounds import bound_s

FLASH = ("flash_fwd", "flash_bwd")


def read(run):
    calls = [c for c in run.trace.calls if c.name in FLASH and c.device_s > 0]
    if not calls:
        return None
    return 100.0 * sum(bound_s(c.flops, c.nbytes) for c in calls) / sum(c.device_s for c in calls)
