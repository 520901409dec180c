"""guided_issue_ms: the mean time the host takes to issue a guided step
(the program's ``step`` span on the host's clock, from the step's entry to
its return) over the window's guided steps, from the program's step
record (``work/record.py``).  Near the step's device time the host paces
the step (or blocks on a full launch queue); well under it the device
does.  None where the record holds no device time (on the CPU)."""

from bench_h100.work.record import mean_issue_ms


def read(run):
    return mean_issue_ms(run)
