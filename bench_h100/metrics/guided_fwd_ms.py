"""guided_fwd_ms: the mean device time of a guided step's conditional
forward under autograd, from the leaf latents to the guidance loss (the
program's ``unet_guided_fwd`` span) over the window's guided steps that
ran it, from the program's step record (``work/record.py``)."""

from bench_h100.work.record import mean_pass_ms


def read(run):
    return mean_pass_ms(run, "unet_guided_fwd")
