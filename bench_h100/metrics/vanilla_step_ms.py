"""vanilla_step_ms: the mean device time of a vanilla step over the
window, from the same CUDA events as guided_step_ms."""


def read(run):
    ms = run.step_ms.get("vanilla", [])
    return sum(ms) / len(ms) if ms else None
