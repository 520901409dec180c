"""The program's step record (``motionclone_tpu_torch/utils/trace.py``)
as the span readers see it: the steps of the measured window's jobs.

A window's job samples once, so its steps are one run of the record.  The
window's jobs are the last ``run.jobs`` runs that no profiler recorded:
in a ``--trace 1`` run the one traced job after the window is profiled,
and the warm-up samples nothing (it calls the step functions).  Where the
record holds fewer such runs than the window's jobs (a window longer than
the record's ring), a reader reads nothing rather than part of the
window."""


def window_steps(run, guided_only: bool):
    """The steps of the window's jobs (the guided ones only, with
    ``guided_only``), or None: where the program has no record, the record
    does not hold the whole window, or its steps hold no device time (on
    the CPU)."""
    try:
        from motionclone_tpu_torch.utils import trace
    except ImportError:  # a program without the step record
        return None
    runs = [r for r in trace.runs() if not r.profiled]
    if run.jobs < 1 or len(runs) < run.jobs:
        return None
    steps = [s for r in runs[-run.jobs:] for s in r.steps
             if s.attrs["guided"] or not guided_only]
    if not steps or any(s.device_ms is None for s in steps):
        return None
    return steps


def mean_pass_ms(run, name: str, guided_only: bool = True):
    """The mean device ms a step of the window's spans named ``name``,
    over the steps that ran one (None as for :func:`window_steps`, or
    where no step ran one)."""
    steps = window_steps(run, guided_only)
    per_step = [[c.device_ms for c in s.children if c.name == name] for s in steps or ()]
    per_step = [ms for ms in per_step if ms]
    if not per_step:
        return None
    return sum(map(sum, per_step)) / len(per_step)


def mean_issue_ms(run):
    """The mean host ms to issue a guided step of the window (its ``step``
    span on the host's clock)."""
    steps = window_steps(run, guided_only=True)
    return None if steps is None else sum(s.host_ns for s in steps) / len(steps) / 1e6
