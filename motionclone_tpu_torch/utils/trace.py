"""Spans inside the port, and the record of its sampling runs.

``span(name, **attrs)`` is a context manager around one stretch of a
sampling run: the run itself (``sample``), a step, a pass of a step.  A
run is a ``sample`` span and every span inside it; ``span("sample",
device=...)`` opens it on the device that samples.  Each span of a run
notes its name, its attributes, the spans closed inside it (``children``)
and its host start and end in ``time.time_ns()`` (unix-epoch nanoseconds,
the clock ``torch.profiler`` stamps its events with).  On a card it also
records a pair of timing events on the current stream of the run's device
(not the process's current device: a rank may sample on a card that is
not current), taken from a pool that is reused across runs: its
``device_ms`` is the time between the stream reaching the first and the
second, read lazily, once the device has finished them.  That time holds
whatever the device waited for the host inside the span, so a step's
passes add up to the step.  On the CPU ``device_ms`` is None.  A span
opened outside a run records nothing.

While a ``torch.profiler`` records (its own flag, checked once a span),
each span, in a run or not, also opens a range ``motionclone/<name>`` on
the profiler's host timeline, so the trace carries the program's spans on
its own clock.  No range is opened otherwise.  The range is a plain host
range (torch's ``RecordFunctionFast``, the trace's ``cpu_op`` category),
not a ``record_function`` user annotation, which the profiler would also
copy onto the device's timeline: a reader of that timeline that cannot
tell an annotation from a kernel would count every span as busy device
time.

The record (:func:`runs`) keeps the last ``RING`` runs.  A run holds
``profiled`` (whether a profiler recorded during it), its closed ``spans``
and its ``steps``: the spans named ``step``, whose attributes give
``index``, ``guided`` and ``full`` (false for a skip step of the approx
caches), whose ``host_ns`` is the host's issue time of the step and whose
``children`` are its passes.  The record holds no tensor.

A span opened with ``backward=True`` (a pass's ``torch.autograd.grad``)
hosts the spans of the backward's own work: a span opened on a thread with
no open span of its own while it is open (autograd's device thread, where
the backward of a CUDA pass runs) is its child.  :func:`annotate` adds
attributes to the innermost open span of a name (a guided step's count of
recomputed segments).

``set_enabled(False)`` makes every span one shared no-op and stops all
recording (recording is on by default).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast as _Range

PREFIX = "motionclone/"
RING = 8

_enabled = True
_NOOP = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
_runs: Deque["Run"] = deque()
_pools: Dict[int, List[torch.cuda.Event]] = {}  # a device's index -> its free events
_backward_host: List["_Open"] = []  # the open span whose backward runs, if any


class Span:
    """One closed span of a run."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "children", "_events", "_ms")

    def __init__(self, name: str, attrs: Dict, start_ns: int):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = start_ns
        self.children: List[Span] = []
        self._events = None  # (start, end, the pool they go back to)
        self._ms: Optional[float] = None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def device_ms(self) -> Optional[float]:
        """The device's milliseconds from the span's start to its end (None
        on the CPU); read once the device has reached the end."""
        if self._events is not None:
            start, end, _ = self._events
            self._ms = start.elapsed_time(end)
            _release([self])
        return self._ms


class Run:
    """The spans of one ``sample`` span and everything inside it."""

    __slots__ = ("stream", "pool", "profiled", "spans", "steps")

    def __init__(self, device: Optional[torch.device]):
        cuda = device is not None and torch.device(device).type == "cuda"
        # the stream the run's work goes to, looked up once (a lookup a span
        # would cost as much as recording an event)
        self.stream = torch.cuda.current_stream(device) if cuda else None
        self.pool = _pools.setdefault(self.stream.device_index, []) if cuda else None
        self.profiled = False
        self.spans: List[Span] = []
        self.steps: List[Span] = []


def _release(spans) -> None:
    # the spans' unread events back to their pool
    for s in spans:
        if s._events is not None:
            start, end, pool = s._events
            pool += (start, end)
            s._events = None


def _event(pool: List[torch.cuda.Event]) -> torch.cuda.Event:
    try:
        return pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _keep(run: Run) -> None:
    with _lock:
        if len(_runs) == RING:
            _release(_runs.popleft().spans)
        _runs.append(run)


class _Open:
    """An open span: ``span``'s context manager."""

    __slots__ = ("name", "attrs", "device", "backward", "parent", "run", "span", "range")

    def __init__(self, name: str, device, attrs: Dict, backward: bool = False):
        self.name, self.device, self.attrs, self.backward = name, device, attrs, backward

    def __enter__(self) -> Optional[Span]:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else (_backward_host[-1] if _backward_host else None)
        if self.parent is not None:
            self.run = self.parent.run
        elif self.name == "sample":
            self.run = Run(self.device)
            _keep(self.run)
        else:
            self.run = None
        self.range = self.span = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = _Range(PREFIX + self.name)
            self.range.__enter__()
            if self.run is not None:
                self.run.profiled = True
        if self.run is None:
            return None
        rec = self.span = Span(self.name, self.attrs, time.time_ns())
        run = self.run
        if run.stream is not None:
            rec._events = (_event(run.pool), _event(run.pool), run.pool)
            rec._events[0].record(run.stream)
        stack.append(self)
        if self.backward:
            _backward_host.append(self)
        return rec

    def __exit__(self, *exc) -> bool:
        rec, run = self.span, self.run
        if rec is not None:
            if rec._events is not None:
                rec._events[1].record(run.stream)
            rec.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if rec is None:
            return False
        if self.backward:
            _backward_host.pop()
        _local.stack.pop()
        run.spans.append(rec)
        if rec.name == "step":
            run.steps.append(rec)
        if self.parent is not None:
            self.parent.span.children.append(rec)
        return False


def span(name: str, device: Optional[torch.device] = None, backward: bool = False, **attrs):
    """A context manager that records the stretch it encloses as ``name``
    (see the module's docstring); ``device``, for a ``sample`` span, is the
    device the run samples on; ``backward``: the span hosts the spans of a
    backward it runs.  Yields the :class:`Span`, or None outside a run or
    while recording is off."""
    return _Open(name, device, attrs, backward) if _enabled else _NOOP


def annotate(name: str, **attrs) -> None:
    """Add ``attrs`` to the innermost span named ``name`` open on this
    thread, where it is recorded (in a run, with recording on)."""
    for op in reversed(getattr(_local, "stack", None) or ()):
        if op.name == name:
            op.span.attrs.update(attrs)
            return


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def runs() -> List[Run]:
    """The kept runs, oldest first."""
    with _lock:
        return list(_runs)


def last_run() -> Optional[Run]:
    with _lock:
        return _runs[-1] if _runs else None
