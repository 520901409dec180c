"""guided_plain_ms: the mean device time of a guided step's unconditional
pass (the program's ``unet_plain`` span) over the window's guided steps
that ran it, from the program's step record (``work/record.py``)."""

from bench_h100.work.record import mean_pass_ms


def read(run):
    return mean_pass_ms(run, "unet_plain")
