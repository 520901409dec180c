"""guided_step_ms: the mean device time of a guided step over the window:
the sum of every guided step's time over their count.  Each step's end
is a CUDA event recorded in the sampling loop's ``on_step`` hook, read
after one synchronisation per job."""


def read(run):
    ms = run.step_ms.get("guided", [])
    return sum(ms) / len(ms) if ms else None
