"""Reduction of a ``torch.profiler`` Chrome trace to what the metrics read.

- Device intervals: every kernel, memcpy and memset on the card.
- Host ranges: the ``record_function`` ranges the harness opens, named
  ``portbench.<layer>`` (``window`` around the measured window, ``call``
  around each batch call, and one for each wrapped function).
- A kernel belongs to the innermost range open on the host when it was
  launched (its launch is the runtime call with the same correlation id).
- An idle gap on the device is named by the innermost range open on the
  host at its middle: what the host was doing while the card waited.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[Dict]):
        complete = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in complete if e.get("cat") in DEVICE_CATS]
        self.ranges = sorted(
            ((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
             for e in complete if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)),
            key=lambda r: (r[0], -r[1]))
        self.launch_ts = {e["args"]["correlation"]: e["ts"]
                          for e in complete if e.get("cat") in LAUNCH_CATS
                          and "correlation" in e.get("args", {})}
        win = [r for r in self.ranges if r[2] == "window"]
        self.window = (win[0][0], win[-1][1]) if win else None
        self._layer_s: Optional[Dict[str, float]] = None

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as fh:
            return cls(json.load(fh).get("traceEvents", []))

    def innermost(self, points: List[float]) -> List[Optional[str]]:
        """The innermost host range around each time point (ranges nest,
        as ``record_function`` ranges on one thread do)."""
        out: List[Optional[str]] = [None] * len(points)
        stack: List[Tuple[float, str]] = []   # (end, name), innermost last
        k = 0
        for idx in sorted(range(len(points)), key=points.__getitem__):
            t = points[idx]
            while k < len(self.ranges) and self.ranges[k][0] <= t:
                r0, r1, name = self.ranges[k]
                while stack and stack[-1][0] < r0:
                    stack.pop()
                stack.append((r1, name))
                k += 1
            while stack and stack[-1][0] < t:
                stack.pop()
            out[idx] = stack[-1][1] if stack else None
        return out

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window (us)."""
        if self.window is None:
            return []
        w0, w1 = self.window
        spans = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                       for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def window_s(self) -> Optional[float]:
        return None if self.window is None else \
            (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def layer_device_s(self) -> Dict[str, float]:
        """Device seconds of the kernels launched inside each host range
        (the innermost one)."""
        if self._layer_s is not None:
            return self._layer_s
        timed = [e for e in self.device
                 if e.get("args", {}).get("correlation") in self.launch_ts]
        owners = self.innermost(
            [self.launch_ts[e["args"]["correlation"]] for e in timed])
        out: Dict[str, float] = defaultdict(float)
        for e, name in zip(timed, owners):
            if name is not None:
                out[name] += e["dur"] / 1e6
        self._layer_s = dict(out)
        return self._layer_s

    def top_device_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for e in self.device:
            by[e["name"]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda t: -t[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle device seconds in the window, summed by what the host was
        doing at the middle of each gap, largest first."""
        if self.window is None:
            return []
        edges = [self.window[0]]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.window[1])
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        names = self.innermost([(a + b) / 2 for a, b in gaps])
        by: Dict[str, float] = defaultdict(float)
        for (a, b), name in zip(gaps, names):
            by[f"host in {name or 'nothing'}"] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda t: -t[1])[:n]]
