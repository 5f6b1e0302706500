"""The program's own spans, read from its records and put on the trace's
clock.

While a profiler records, the port's batch command writes each family's
spans into the family's record (``spans``: ``[name, parent index, t0,
t1, attrs]``, t0 and t1 on ``time.perf_counter``), and the spans outside
any family into the batch's closing record. A span that another thread
recorded (the prefetched parse) carries ``thread`` in its attributes.

Each call's records are put on the trace's clock by the harness's
``portbench.call`` range around that call: the range begins before
``Call.t0`` and ends after ``Call.t1``, so the offset from the host clock
to the trace's lies between ``range start - t0`` and ``range end - t1``.
Where the harness also wrapped ``api.gdca_from_msa`` (its ``pipeline``
range, one a family, inside the program's ``pipeline`` span), each such
range bounds the offset from the other side: it begins after the span's
t0 and ends before its t1. The midpoint of the interval that all bounds
leave is taken, and its half-width kept as the alignment's uncertainty.

- A device operation (kernel, memcpy, memset) belongs to the innermost
  main-thread span open at its launch, the runtime call with the same
  correlation id (``Trace.launch_ts``).
- The window's idle intervals (``Trace.busy_intervals``' complement) are
  intersected with the spans.

A program that records no spans, or a run without a trace, gives an empty
``Program``, and every reader of it returns None.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Span:
    name: str
    t0: float           # seconds on the trace's clock
    t1: float
    attrs: Dict
    main: bool          # recorded on the batch command's thread


@dataclasses.dataclass
class Family:
    """A family completed in the window: its record's spans."""

    spans: List[Span]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def _spans(rec: Dict, offset: float) -> List[Span]:
    return [Span(name, t0 + offset, t1 + offset, attrs or {},
                 "thread" not in (attrs or {}))
            for name, _, t0, t1, attrs in rec.get("spans", [])
            if t0 is not None and t1 is not None]


def _innermost(spans: Sequence[Span], points: Sequence[float]
               ) -> List[Optional[Span]]:
    """The innermost of ``spans`` (which nest, as one thread's do) open
    at each point."""
    order = sorted(spans, key=lambda s: (s.t0, -s.t1))
    out: List[Optional[Span]] = [None] * len(points)
    stack: List[Span] = []
    k = 0
    for idx in sorted(range(len(points)), key=points.__getitem__):
        t = points[idx]
        while k < len(order) and order[k].t0 <= t:
            while stack and stack[-1].t1 < order[k].t0:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and stack[-1].t1 < t:
            stack.pop()
        out[idx] = stack[-1] if stack else None
    return out


def _overlap(intervals: Sequence[Tuple[float, float]], a: float,
             b: float, starts: Sequence[float]) -> float:
    """Seconds of the sorted, disjoint ``intervals`` inside [a, b]."""
    total = 0.0
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    while k < len(intervals) and intervals[k][0] < b:
        lo, hi = max(intervals[k][0], a), min(intervals[k][1], b)
        if hi > lo:
            total += hi - lo
        k += 1
    return total


def _bounds(records: List[Dict], r0: float, r1: float, call,
            wrapped: List[Tuple]) -> Tuple[float, float]:
    """The interval of the offset (s) that the call's range and, where
    they pair one to one with the records' ``pipeline`` spans, the
    harness's ``pipeline`` ranges inside it leave."""
    lo, hi = r0 / 1e6 - call.t0, r1 / 1e6 - call.t1
    stamps = sorted((t0, t1) for rec in records
                    for name, _, t0, t1, attrs in rec.get("spans", [])
                    if name == "pipeline" and "thread" not in (attrs or {}))
    inside = [(a, b) for a, b, _ in wrapped if r0 <= a and b <= r1]
    if not stamps or len(stamps) != len(inside):
        return lo, hi
    pairs = list(zip(stamps, inside))
    lo2 = max([lo] + [b / 1e6 - t1 for (_, t1), (_, b) in pairs])
    hi2 = min([hi] + [a / 1e6 - t0 for (t0, _), (a, _) in pairs])
    return (lo2, hi2) if lo2 <= hi2 else (lo, hi)


class Program:
    """The spans of a run's calls on its trace's clock."""

    def __init__(self, run):
        self.spans: List[Span] = []          # every span of every call
        self.families: List[Family] = []     # completed in the window
        self.half_widths: List[float] = []   # the alignment's, per call
        self.trace = tr = run.trace
        self._main: List[Span] = []
        self._idle: Optional[List[Tuple[float, float]]] = None
        self._launches: Optional[List[Tuple[float, Dict]]] = None
        if tr is None or tr.window is None:
            return
        ranges = [r for r in tr.ranges if r[2] == "call"]
        if len(ranges) != len(run.calls):
            return
        wrapped = [r for r in tr.ranges if r[2] == "pipeline"]
        for call, (r0, r1, _) in zip(run.calls, ranges):
            records = [rec for _, rec in call.records()]
            lo, hi = _bounds(records, r0, r1, call, wrapped)
            offset = (lo + hi) / 2
            traced = False
            for rec in records:
                spans = _spans(rec, offset)
                traced = traced or bool(spans)
                self.spans += spans
                if "family" in rec and "output" in rec and \
                        "emit_error" not in rec:
                    self.families.append(Family(spans))
            if traced:
                self.half_widths.append((hi - lo) / 2)
        if not self.spans:
            self.families = []
        self._main = [s for s in self.spans if s.main]

    # --- the device's side ------------------------------------------------

    def idle(self) -> List[Tuple[float, float]]:
        """The window's idle intervals (s on the trace's clock)."""
        if self._idle is None:
            tr = self.trace
            edges = [tr.window[0]]
            for a, b in tr.busy_intervals():
                edges += [a, b]
            edges.append(tr.window[1])
            self._idle = [(edges[k] / 1e6, edges[k + 1] / 1e6)
                          for k in range(0, len(edges) - 1, 2)
                          if edges[k + 1] > edges[k]]
        return self._idle

    def launches(self) -> List[Tuple[float, Dict]]:
        """(launch time s, event) of every device operation with a known
        launch, by launch time."""
        if self._launches is None:
            tr = self.trace
            self._launches = sorted(
                ((tr.launch_ts[e["args"]["correlation"]] / 1e6, e)
                 for e in tr.device
                 if e.get("args", {}).get("correlation") in tr.launch_ts),
                key=lambda p: p[0])
        return self._launches

    # --- what the readers read --------------------------------------------

    def family_launches(self) -> List[int]:
        """Device operations launched inside each completed family's
        ``family`` span."""
        if not self.families:
            return []
        times = [t for t, _ in self.launches()]
        out = []
        for fam in self.families:
            spans = fam.named("family")
            if spans:
                out.append(sum(bisect.bisect_right(times, s.t1) -
                               bisect.bisect_left(times, s.t0)
                               for s in spans))
        return out

    def family_seconds(self, name: str) -> List[float]:
        """Each completed family's host seconds in its ``name`` spans
        (families without one left out)."""
        return [sum(s.t1 - s.t0 for s in fam.named(name))
                for fam in self.families if fam.named(name)]

    def family_idle(self, name: str) -> List[float]:
        """Each completed family's device-idle seconds inside its ``name``
        spans (families without one left out)."""
        if not self.families:
            return []
        idle = self.idle()
        starts = [a for a, _ in idle]
        return [sum(_overlap(idle, s.t0, s.t1, starts)
                    for s in fam.named(name))
                for fam in self.families if fam.named(name)]

    def device_s_by_span(self) -> Dict[str, float]:
        """Device seconds of the operations launched inside each span name
        (the innermost main-thread span at the launch)."""
        launches = self.launches()
        owners = _innermost(self._main, [t for t, _ in launches])
        out: Dict[str, float] = defaultdict(float)
        for (_, e), span in zip(launches, owners):
            out[span.name if span else "none"] += e["dur"] / 1e6
        return dict(out)

    def idle_by_span(self) -> Dict[str, float]:
        """The window's idle seconds by the innermost main-thread span open
        at each moment of them ("none": outside every span)."""
        points = sorted({t for s in self._main for t in (s.t0, s.t1)})
        mids = [(a + b) / 2 for a, b in zip(points, points[1:])]
        owners = _innermost(self._main, mids)
        out: Dict[str, float] = defaultdict(float)
        idle = self.idle()
        starts = [a for a, _ in idle]
        covered = 0.0
        for (a, b), span in zip(zip(points, points[1:]), owners):
            if span is not None:
                sec = _overlap(idle, a, b, starts)
                out[span.name] += sec
                covered += sec
        out["none"] = sum(b - a for a, b in idle) - covered
        return dict(out)


def program(run) -> Program:
    """The run's ``Program``, made once and kept on the run."""
    prog = getattr(run, "_program_spans", None)
    if prog is None:
        prog = Program(run)
        run._program_spans = prog
    return prog


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
