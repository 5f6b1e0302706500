"""Structured per-stage logging.

The reference computes Meff and resolved auto-theta but never surfaces
them. Every batch run emits one structured record per family with the
debugging handles for golden mismatches: M, N, q, drop counts, resolved
theta, Meff, and wall times per host-visible stage.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional, TextIO


class RunLog:
    """Collects stage timings + metadata; emits one JSON line."""

    def __init__(self, name: str, stream: Optional[TextIO] = None,
                 enabled: bool = True):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled
        self.fields: Dict[str, Any] = {"family": name}
        self.timings: Dict[str, float] = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def stage(self, stage_name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[stage_name] = round(time.perf_counter() - t0, 4)

    def set(self, **kwargs) -> None:
        self.fields.update(kwargs)

    def emit(self) -> Dict[str, Any]:
        rec = dict(self.fields)
        rec["timings_s"] = self.timings
        rec["total_s"] = round(time.perf_counter() - self._t0, 4)
        if self.enabled:
            print(json.dumps(rec), file=self.stream, flush=True)
        return rec
