"""The traced run's spans, its record of kernel calls, and the reduction of
the profiler's events to what the per-layer metrics read.

Spans are ``torch.profiler.record_function`` ranges named
``bench_h100/<span>`` around the harness's calls into the program (text,
encode, condition, extract, guided_step, vanilla_step, decode, and the
whole ``window``, which in a traced run is the one job run under the
profiler after the measured window).  During that job each entry point of the
program's kernels (``work/bounds.KERNELS`` and the model family's
``kernels()``) is wrapped: the wrapper records the call's operations and
bytes from its arguments' shapes and runs it inside a range
``bench_h100.op/<n>``, so the device time of the kernels it launches can
be found.  Nothing is wrapped, and no range is opened, in the measured
window.

The reduction reads the profiler's raw events once (no chrome trace is
written): the union of the device's busy intervals inside the window
(kernels, copies and sets; the ranges' own annotations on the device's
timeline are not work), each wrapped call's device time (the busy time
inside its range's annotation on the device's timeline), the device
operations that took most time, and the longest idle gaps, each named by
the span open on the host at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch.autograd import DeviceType

from bench_h100.work import bounds

SPAN = "bench_h100/"
OP = "bench_h100.op/"
TOP = 10


@dataclasses.dataclass
class Call:
    name: str       # the entry point
    layer: str      # its table entry's layer: "fused", "attention" or a family's
    flops: float
    nbytes: float
    device_s: float = 0.0


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    calls: List[Call]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class Tracer:
    """Spans and kernel-call records of one run; inert unless ``enabled``.
    ``kernels``: a family's entries beside ``bounds.KERNELS``, none of
    which may replace a common one."""

    def __init__(self, enabled: bool, kernels: Mapping = {}):
        clash = set(kernels) & set(bounds.KERNELS)
        if clash:
            raise ValueError(f"a family's kernel entries replace common ones: {sorted(clash)}")
        self.enabled = enabled
        self.kernels: Dict = {**bounds.KERNELS, **kernels}
        self.calls: List[Call] = []
        self._patched = []
        self._open = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN + name)

    def switch(self, name: Optional[str]) -> None:
        """Close the open step span and open ``name`` (None: none)."""
        if not self.enabled:
            return
        if self._open is not None:
            self._open.__exit__(None, None, None)
        self._open = None
        if name is not None:
            self._open = torch.profiler.record_function(SPAN + name)
            self._open.__enter__()

    def patch(self) -> None:
        """Wrap the program's kernel entry points that exist."""
        for (mod_name, fn_name), (layer, count) in self.kernels.items():
            try:
                mod = importlib.import_module(f"motionclone_tpu_torch.ops.{mod_name}")
            except ImportError:
                continue
            orig = getattr(mod, fn_name, None)
            if orig is None:
                continue
            setattr(mod, fn_name, self._wrap(orig, fn_name, layer, count))
            self._patched.append((mod, fn_name, orig))

    def _wrap(self, orig, name, layer, count):
        calls = self.calls

        def wrapper(*args, **kwargs):
            flops, nbytes = count(*args, **kwargs)
            with torch.profiler.record_function(f"{OP}{len(calls)}"):
                calls.append(Call(name, layer, flops, nbytes))
                return orig(*args, **kwargs)

        # the entry points count their launches on their module-level name
        wrapper.launches = getattr(orig, "launches", 0)
        return wrapper

    def unpatch(self) -> None:
        for mod, fn_name, orig in self._patched:
            if hasattr(orig, "launches"):
                orig.launches = getattr(getattr(mod, fn_name), "launches", orig.launches)
            setattr(mod, fn_name, orig)
        self._patched = []

    def profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def reduce(self, prof) -> Summary:
        return reduce_events(prof.profiler.kineto_results.events(), self.calls)


def _activity(ev) -> str:
    """The event's activity type where the profiler gives one."""
    try:
        return str(ev.activity_type()).lower()
    except AttributeError:
        return ""


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(events, calls: List[Call]) -> Summary:
    """Device time per call, busy time, top device ops and idle gaps from
    the profiler's raw (Kineto) events."""
    window = None
    spans: List[Tuple[int, int, str]] = []
    kernels: List[Tuple[int, int, str]] = []
    gpu_ops: List[Tuple[int, int, int]] = []  # a call's range on the device's timeline
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(OP):
                gpu_ops.append((ev.start_ns(), ev.end_ns(), int(name[len(OP):])))
            elif not name.startswith(SPAN) and "annotation" not in _activity(ev):
                kernels.append((ev.start_ns(), ev.end_ns(), name))
        elif name == SPAN + "window":
            window = (ev.start_ns(), ev.end_ns())
        elif name.startswith(SPAN):
            spans.append((ev.start_ns(), ev.end_ns(), name[len(SPAN):]))
    if window is None:
        raise RuntimeError("the trace holds no bench_h100/window span")
    w0, w1 = window
    busy_iv, by_name = [], defaultdict(float)
    for s, e, name in kernels:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            busy_iv.append((s, e))
            by_name[name] += (e - s) / 1e9
    busy = _union(busy_iv)
    # a call's device time: the busy time inside its range on the device's
    # timeline (one stream: the kernels there are the ones it launched)
    b_starts = [s for s, _ in busy]
    for s, e, idx in gpu_ops:
        if idx >= len(calls):
            continue
        i = max(0, bisect.bisect_right(b_starts, s) - 1)
        while i < len(busy) and busy[i][0] < e:
            calls[idx].device_s += max(0, min(e, busy[i][1]) - max(s, busy[i][0])) / 1e9
            i += 1
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans.sort()
    span_starts = [s for s, _, _ in spans]

    def label(t: int) -> str:
        # the innermost (latest-starting) span that is open at t
        i = bisect.bisect_right(span_starts, t) - 1
        while i >= 0:
            s, e, name = spans[i]
            if s <= t <= e:
                return name
            i -= 1
        return "outside any span"

    gaps.sort(key=lambda g: g[0] - g[1])
    return Summary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        calls=calls,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=[(label((s + e) // 2), (e - s) / 1e9) for s, e in gaps[:TOP]],
    )
