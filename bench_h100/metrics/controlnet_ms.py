"""controlnet_ms: the mean device time of the controlnet's passes a step
(the program's ``controlnet`` spans: the batch-2 pass on the CFG pair)
over every step of the window that ran it, guided and vanilla, from the
program's step record (``work/record.py``).  None where no controlnet
ran."""

from bench_h100.work.record import mean_pass_ms


def read(run):
    return mean_pass_ms(run, "controlnet", guided_only=False)
