"""The readers of the program's step record (``metrics/guided_plain_ms.py``,
``guided_fwd_ms``, ``guided_bwd_ms``, ``controlnet_ms``,
``guided_issue_ms``, through ``work/record.py``), fed a synthetic record:
the mean over the window's jobs (the last runs no profiler recorded), a
profiled run and an older run ignored, None without device times, without
the record, or with fewer runs than the window's jobs."""

import sys
from types import SimpleNamespace

import pytest

from bench_h100 import harness

MS = 1_000_000  # ns


def _span(name, device_ms, children=(), host_ms=0.0, **attrs):
    return SimpleNamespace(name=name, device_ms=device_ms, host_ns=int(host_ms * MS),
                           attrs=attrs, children=list(children))


def _guided(plain, fwd, bwd, cn, issue, device=300.0):
    passes = [_span("controlnet", cn), _span("unet_plain", plain),
              _span("unet_guided_fwd", fwd), _span("unet_guided_bwd", bwd)]
    return _span("step", device, passes, host_ms=issue, guided=True, full=True)


def _vanilla(plain, cn):
    return _span("step", 150.0, [_span("controlnet", cn), _span("unet_plain", plain)],
                 host_ms=5.0, guided=False, full=True)


def _record(device=True):
    """A run before the window, two runs of the window and a profiled one,
    the other two with other numbers (without ``device``, no device time,
    as on the CPU)."""
    skip = _span("step", 1.0, host_ms=1.0, guided=True, full=False)  # a skip step: no pass
    window = [
        SimpleNamespace(profiled=False, steps=[_guided(100, 120, 150, 40, 300),
                                               _guided(110, 130, 160, 42, 310),
                                               _vanilla(200, 38)]),
        SimpleNamespace(profiled=False, steps=[_guided(90, 140, 170, 44, 290), skip]),
    ]
    traced = SimpleNamespace(profiled=True, steps=[_guided(999, 999, 999, 999, 999),
                                                   _vanilla(999, 999)])
    older = SimpleNamespace(profiled=False, steps=[_guided(999, 999, 999, 999, 999)])
    runs = [older] + window + [traced]
    if not device:
        for r in runs:
            for s in r.steps:
                s.device_ms = None
                for c in s.children:
                    c.device_ms = None
    return runs


WANT = {"guided_plain_ms": 100.0, "guided_fwd_ms": 130.0, "guided_bwd_ms": 160.0,
        "controlnet_ms": 41.0, "guided_issue_ms": (300 + 310 + 290 + 1) / 4}
NAMES = [f"{q}.{fam}" for q in WANT for fam in ("sweep", "clip")
         if (q, fam) != ("controlnet_ms", "sweep")]


def _with_record(monkeypatch, runs):
    from motionclone_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "runs", lambda: runs)


WINDOW = SimpleNamespace(jobs=2)  # the RunData of a window of two jobs


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_takes_the_mean_over_the_unprofiled_runs(name, monkeypatch):
    _with_record(monkeypatch, _record())
    got = harness.load_reader(name)(WINDOW)
    assert got == pytest.approx(WANT[name.split(".")[0]])


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_finds_nothing_without_device_times_or_runs(name, monkeypatch):
    _with_record(monkeypatch, _record(device=False))
    assert harness.load_reader(name)(WINDOW) is None
    _with_record(monkeypatch, [])
    assert harness.load_reader(name)(WINDOW) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_reads_nothing_of_a_window_the_record_does_not_hold(name, monkeypatch):
    # four jobs in the window, three unprofiled runs in the record: the
    # ring dropped the first job, and part of the window is not the window
    _with_record(monkeypatch, _record())
    assert harness.load_reader(name)(SimpleNamespace(jobs=4)) is None
    assert harness.load_reader(name)(SimpleNamespace(jobs=0)) is None


def test_the_ring_holds_each_cells_window_and_its_traced_job():
    import json
    import os

    from motionclone_tpu_torch.utils import trace

    root = os.path.join(harness.ROOT, "bench_h100", "traffic")
    for name in os.listdir(root):
        with open(os.path.join(root, name)) as fh:
            assert json.load(fh)["loop"]["max_jobs"] + 1 <= trace.RING, name


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_finds_nothing_in_a_program_without_the_record(name, monkeypatch):
    import motionclone_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "motionclone_tpu_torch.utils.trace", None)
    assert harness.load_reader(name)(WINDOW) is None


def test_every_reader_is_in_the_benchmark():
    import json
    import os

    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        per_layer = {m["name"]: m for m in json.load(fh)["per_layer"]}
    for name in NAMES:
        fam = name.split(".")[1]
        m = per_layer[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "program_span", f"video_s.{fam}",
            ["t2v_camera.b2" if fam == "sweep" else "i2v_rgb.b1"])
