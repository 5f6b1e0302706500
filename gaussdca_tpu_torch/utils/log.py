"""Structured per-family records, and the program's spans.

The reference computes Meff and resolved auto-theta but never surfaces
them. Every batch run emits one structured record per family with the
debugging handles for golden mismatches: M, N, q, drop counts, resolved
theta, Meff, and wall times per host-visible stage.

``RunLog`` is also the program's span recorder. A span is a named
interval of the host's work: its name, its parent (the span open around
it in the same recorder), its start and end on ``time.perf_counter`` and
its attributes (shapes, bytes). The module's ``span`` records into the
RunLog bound to the calling thread (``RunLog.bound``), and ``count``
adds to its counters; ``RunLog.stage`` is a span of that RunLog whose
wall also goes into ``timings_s``, traced or not.

Spans are recorded while tracing is on: while a ``torch.profiler``
records (``--profile-dir``, or a profiler around the caller), or inside
``tracing()``. Each span then also opens a ``record_function`` range
named ``gdca.<name>``, so it lies on the profiler's clock, and a span
given a CUDA device records an event on that device's current stream at
each end. The stream time between the two (``device_s``) is read when
the record is emitted, after the ranking's copy to the host has waited
for the stream: no span synchronizes. A record that holds spans gains
``spans`` (``[name, parent index or None, t0, t1, attrs]``) and
``counters``. With tracing off a span costs one flag test and records
nothing, and the records are what they are without spans.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, TextIO

import torch
from torch.autograd import profiler as _profiler

PREFIX = "gdca."

_bound = threading.local()   # .stack: the RunLogs bound to this thread
_forced = 0                  # open tracing() blocks


def tracing_on() -> bool:
    """Whether spans are recorded now."""
    return bool(_forced or _profiler._is_profiler_enabled)


@contextmanager
def tracing():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def dtype_name(dtype) -> str:
    """"float32" for torch.float32 (the attribute form of a dtype)."""
    return str(dtype).replace("torch.", "")


class _Null:
    """The span of untraced code: enters, takes attributes, does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_NULL = _Null()


class _Wall:
    """An untraced stage: its wall time, into ``timings``."""

    __slots__ = ("timings", "name", "t0")

    def __init__(self, timings: Dict[str, float], name: str):
        self.timings, self.name = timings, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return _NULL

    def __exit__(self, *exc) -> None:
        self.timings[self.name] = round(time.perf_counter() - self.t0, 4)


class _Span:
    """One traced span (see the module docstring)."""

    __slots__ = ("log", "name", "attrs", "dev", "wall", "idx", "rf", "ev0",
                 "t0", "t1")

    def __init__(self, log: Optional["RunLog"], name: str,
                 attrs: Dict[str, Any], dev=None,
                 wall: Optional[Dict[str, float]] = None):
        self.log, self.name, self.attrs, self.wall = log, name, attrs, wall
        cuda = dev is not None and log is not None and \
            torch.device(dev).type == "cuda"
        self.dev = torch.device(dev) if cuda else None
        self.ev0 = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        if self.dev is not None:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(torch.cuda.current_stream(self.dev))
        self.t0 = time.perf_counter()
        if self.log is not None:
            self.log._open(self)
        return self

    def __exit__(self, *exc) -> None:
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.dev))
        self.t1 = time.perf_counter()
        if self.wall is not None:
            self.wall[self.name] = round(self.t1 - self.t0, 4)
        if self.log is not None:
            self.log._close(self, ev1)
        self.rf.__exit__(*exc)


def current() -> Optional["RunLog"]:
    """The RunLog bound to this thread, if any."""
    stack = getattr(_bound, "stack", None)
    return stack[-1] if stack else None


def span(name: str, dev=None, **attrs):
    """A span in the RunLog bound to this thread (with none bound, only
    the profiler's range); ``dev``: the device whose stream time the span
    measures. A context manager whose value takes more attributes
    (``.set``)."""
    if not tracing_on():
        return _NULL
    return _Span(current(), name, attrs, dev)


def count(**values) -> None:
    """Add to the counters of the RunLog bound to this thread (traced
    only)."""
    if not tracing_on():
        return
    log = current()
    if log is not None:
        log.count(**values)


class RunLog:
    """Collects stage timings, metadata and spans; emits one JSON line."""

    def __init__(self, name: str, stream: Optional[TextIO] = None,
                 enabled: bool = True):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.fields: Dict[str, Any] = {"family": name}
        self.timings: Dict[str, float] = {}
        self.spans: List[list] = []
        self.counters: Dict[str, float] = {}
        self._stack: List[int] = []
        self._events: List[tuple] = []
        self._t0 = time.perf_counter()

    def stage(self, stage_name: str, dev=None, **attrs):
        """A span whose wall also goes into ``timings_s``, traced or
        not."""
        if not tracing_on():
            return _Wall(self.timings, stage_name)
        return _Span(self, stage_name, attrs, dev, wall=self.timings)

    def _open(self, sp: _Span) -> None:
        sp.idx = len(self.spans)
        self.spans.append([sp.name, self._stack[-1] if self._stack else None,
                           sp.t0, None, sp.attrs])
        self._stack.append(sp.idx)

    def _close(self, sp: _Span, ev1) -> None:
        self.spans[sp.idx][3] = sp.t1
        if sp.idx in self._stack:
            del self._stack[self._stack.index(sp.idx):]
        if ev1 is not None:
            self._events.append((sp.idx, sp.ev0, ev1))

    def count(self, **values) -> None:
        for k, v in values.items():
            self.counters[k] = self.counters.get(k, 0) + v

    @contextmanager
    def bound(self):
        """Bind this RunLog to the calling thread for the block: the
        module's ``span`` and ``count`` record into it."""
        stack = getattr(_bound, "stack", None)
        if stack is None:
            stack = _bound.stack = []
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()

    def absorb(self, other: "RunLog", **attrs) -> None:
        """Take ``other``'s spans (as roots where they were, each given
        ``attrs``) and add its counters: the spans another thread
        recorded for this family."""
        base = len(self.spans)
        for name, parent, t0, t1, a in other.spans:
            self.spans.append([name, None if parent is None else
                               parent + base, t0, t1, {**a, **attrs}])
        self._events += [(i + base, e0, e1) for i, e0, e1 in other._events]
        self.count(**other.counters)

    def traced(self) -> Dict[str, Any]:
        """``spans`` and ``counters``, the device times read from the
        events whose stream has passed them (none waited for); empty when
        nothing was traced."""
        if not (self.spans or self.counters):
            return {}
        for idx, ev0, ev1 in self._events:
            if ev1.query():
                self.spans[idx][4]["device_s"] = ev0.elapsed_time(ev1) / 1e3
        self._events = []
        return {"spans": self.spans, "counters": self.counters}

    def set(self, **kwargs) -> None:
        self.fields.update(kwargs)

    def emit(self) -> Dict[str, Any]:
        rec = dict(self.fields)
        rec["timings_s"] = self.timings
        rec["total_s"] = round(time.perf_counter() - self._t0, 4)
        rec.update(self.traced())
        if self.enabled:
            print(json.dumps(rec), file=self.stream, flush=True)
        return rec
