"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the port's batch front end, ``gaussdca_tpu_torch.cli.
main``, in this process, as a closed loop: each call is one batch over
the cell's pool of gzipped FASTA files, and calls follow one another
until ``seconds`` have passed (the window ends with the call that is
running then). Every family writes its ranking into a directory of its
call. The harness installs the stderr of each call and stamps each
per-family JSON record as it arrives: the CLI prints it after the
family's file is written, so the stamp is the family's completion.

With ``trace`` the window runs under ``torch.profiler`` and the harness
wraps a few functions of the program by name, each in a
``record_function`` range (``WRAPPED``); without it nothing is wrapped.
The layers' ranges feed the per-layer metrics; ``pipeline`` and ``emit``
only name the host's work in the breakdown's idle gaps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench import check, spec, traffic
from portbench.reference import reference_scores
from portbench.trace import PREFIX, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussdca_tpu")


class Stamped(io.TextIOBase):
    """A text stream that keeps each line with the time it completed."""

    def __init__(self):
        self.lines: List[Tuple[float, str]] = []
        self._part = ""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        now = time.perf_counter()
        self._part += s
        *done, self._part = self._part.split("\n")
        self.lines.extend((now, line) for line in done)
        return len(s)


@dataclasses.dataclass
class Call:
    t0: float
    t1: float
    rc: int
    lines: List[Tuple[float, str]]

    def records(self) -> List[Tuple[float, Dict]]:
        out = []
        for t, line in self.lines:
            if line.startswith("{"):
                try:
                    out.append((t, json.loads(line)))
                except ValueError:
                    pass
        return out

    def completions(self) -> List[Tuple[float, Dict]]:
        """Records that end a family: its ranking written (computed or
        from the cache), or its error."""
        return [(t, r) for t, r in self.records() if "family" in r and
                ("output" in r or "error_type" in r or "emit_error" in r)]


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    setup_s: float
    window_s: float
    calls: List[Call]
    peak_bytes: int
    spans: Dict[str, List[Dict]]
    trace: Optional[Trace]

    def families(self) -> List[Dict]:
        """Each family completed in the window: its record and its wall,
        from the previous completion in its call (or the call's start)."""
        out = []
        for call in self.calls:
            prev = call.t0
            for t, rec in call.completions():
                if "output" in rec and "emit_error" not in rec:
                    out.append({"wall_s": t - prev, "record": rec})
                prev = t
        return out


def cli_argv(cell: spec.Cell, paths: List[str], out_dir: str,
             device: str, work: str) -> List[str]:
    """The batch command's arguments: the configuration's settings (and
    its ``mesh``, a "DP,TP" shape, where it gives one) and the mix's
    options (``prefetch``, ``top_k``, and ``cache``: an artifact cache
    under ``work`` that the warm-up batch fills)."""
    s = cell.config["settings"]
    opts = cell.traffic.get("cli", {})
    argv = [*paths, "-o", out_dir, "--score", s["score"],
            "--pseudocount", repr(s["pseudocount"]),
            "--theta", str(s["theta"]),
            "--max-gap-fraction", repr(s["max_gap_fraction"]),
            "--min-separation", str(s["min_separation"]),
            "--dtype", s["dtype"], "--device", device]
    if s.get("remove_dups"):
        argv.append("--remove-dups")
    if not opts.get("prefetch", True):
        argv.append("--no-prefetch")
    if opts.get("top_k") is not None:
        argv += ["--top-k", str(opts["top_k"])]
    if opts.get("cache"):
        argv += ["--cache-dir", os.path.join(work, "cache")]
    if s.get("mesh"):
        argv += ["--mesh", str(s["mesh"])]
    return argv


def batch_call(argv: List[str]) -> Call:
    from gaussdca_tpu_torch import cli

    stream = Stamped()
    with contextlib.redirect_stderr(stream):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        t1 = time.perf_counter()
    return Call(t0, t1, rc, stream.lines)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# (module, attribute, range, shapes of a call from its arguments)
WRAPPED = (
    ("gaussdca_tpu_torch.api", "gdca_from_msa", "pipeline", None),
    ("gaussdca_tpu_torch.stats.reweight", "compute_weights_streaming",
     "reweight", lambda Z, theta, q, **k: {"M": Z.shape[0], "N": Z.shape[1],
                                           "q": q}),
    ("gaussdca_tpu_torch.api", "weighted_frequencies", "frequencies",
     lambda Z, W, q, **k: {"M": Z.shape[0], "N": Z.shape[1], "q": q,
                           "dtype": _dtype_name(k.get("dtype", W.dtype))}),
    ("gaussdca_tpu_torch.api", "spd_inverse", "solve",
     lambda C, *a, **k: {"Ns": C.shape[0], "dtype": _dtype_name(C.dtype)}),
    ("gaussdca_tpu_torch.api", "di_score", "di",
     lambda mJ, C, q: {"N": mJ.shape[0] // (q - 1), "q": q,
                       "dtype": _dtype_name(mJ.dtype)}),
    ("gaussdca_tpu_torch.api", "compute_ranking", "rank", None),
    ("gaussdca_tpu_torch.cli", "format_rank", "emit", None),
)


def wrap_program(spans: Dict[str, List[Dict]]) -> Callable[[], None]:
    """Wrap the ``WRAPPED`` functions; each call appends its host seconds
    and shapes to ``spans[range]``. Returns the function that unwraps."""
    import importlib

    saved = []
    for mod_name, attr, name, shapes in WRAPPED:
        module = importlib.import_module(mod_name)
        fn = getattr(module, attr)

        def wrapped(*a, _fn=fn, _name=name, _shapes=shapes, **k):
            with torch.profiler.record_function(PREFIX + _name):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                host_s = time.perf_counter() - t0
            span = {"host_s": host_s}
            if _shapes is not None:
                span.update(_shapes(*a, **k))
            spans.setdefault(_name, []).append(span)
            return out

        saved.append((module, attr, fn))
        setattr(module, attr, wrapped)

    def unwrap() -> None:
        for module, attr, fn in saved:
            setattr(module, attr, fn)

    return unwrap


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _peak_bytes(cards: int) -> int:
    """The allocator's peak on the fullest of the first ``cards`` cards."""
    return max(torch.cuda.max_memory_allocated(d) for d in range(cards))


def references(cell: spec.Cell, pool: List[traffic.Family], device: str,
               precision: str = "float64") -> List:
    return [reference_scores(f.path, cell.config["settings"], device=device,
                             precision=precision)[0] for f in pool]


def output_paths(out_dir: str, pool: List[traffic.Family]) -> List[str]:
    """Where the batch command writes each family's ranking: its file's
    name without ".fasta.gz", then ".rank.txt"."""
    return [os.path.join(out_dir, os.path.basename(f.path)[:-len(".fasta.gz")]
                         + ".rank.txt") for f in pool]


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench_dir: str = spec.HERE
             ) -> Tuple[Dict, List[str]]:
    """One run; returns (the result object, the check lines for stderr).
    ``t_start`` is the process's start on the ``time.perf_counter``
    clock."""
    cell = spec.load_cell(root, name, bench_dir)
    cuda = device.startswith("cuda")
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        pool = traffic.make_pool(cell.traffic, seed,
                                 os.path.join(work, "pool"))
        paths = [f.path for f in pool]
        # warm every shape of the pool once (the first call also loads or
        # builds the kernels and the native parser)
        shapes: Dict[Tuple[int, int], str] = {}
        for f in pool:
            shapes.setdefault((f.M, f.N), f.path)
        warm = batch_call(cli_argv(cell, list(shapes.values()),
                                   os.path.join(work, "warm"), device, work))
        if warm.rc != 0:
            sys.stderr.write("portbench: the warm-up batch failed:\n" +
                             "\n".join(line for _, line in warm.lines[-20:])
                             + "\n")
        _sync(device)

        spans: Dict[str, List[Dict]] = {}
        unwrap = wrap_program(spans) if trace else (lambda: None)
        profiler = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.__enter__()
        setup_peak = _peak_bytes(cell.chips) if cuda else 0
        if cuda:
            for d in range(cell.chips):
                torch.cuda.reset_peak_memory_stats(d)
        span = (lambda n: torch.profiler.record_function(PREFIX + n)) \
            if trace else (lambda n: contextlib.nullcontext())
        calls: List[Call] = []
        t_w0 = time.perf_counter()
        with span("window"):
            while True:
                out_dir = os.path.join(work, f"c{len(calls)}")
                with span("call"):
                    calls.append(batch_call(cli_argv(cell, paths, out_dir,
                                                     device, work)))
                if time.perf_counter() - t_w0 >= seconds:
                    break
            _sync(device)
        t_w1 = time.perf_counter()
        window_peak = _peak_bytes(cell.chips) if cuda else 0
        tr = None
        if profiler is not None:
            profiler.__exit__(None, None, None)
            trace_path = os.path.join(work, "trace.json")
            profiler.export_chrome_trace(trace_path)
            del profiler
            tr = Trace.load(trace_path)
        unwrap()

        run = Run(cell=cell, setup_s=t_w0 - t_start, window_s=t_w1 - t_w0,
                  calls=calls, peak_bytes=window_peak, spans=spans, trace=tr)
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = spec.reader(m["name"], bench_dir)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        done = len(run.families())
        attempted = len(calls) * len(pool)
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name() if cuda else "cpu",
               "count": cell.chips,
               "memory_peak_bytes": max(setup_peak, window_peak)}
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s()
        breakdown = None if tr is None else {
            "device_ops": tr.top_device_ops(),
            "idle_gaps": tr.idle_by_host()}
        del tr, run
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        refs = references(cell, pool, device)
        outputs, per_output = [], []
        for k in range(len(calls)):
            outputs += output_paths(os.path.join(work, f"c{k}"), pool)
            per_output += refs
        checks = check.judge(outputs, per_output,
                             int(cell.config["settings"]["min_separation"]),
                             cell.limits, cell.traffic.get("cli", {})
                             .get("top_k"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = {"correct": check.passed(checks) and done == attempted
              and warm.rc == 0,
              "attempted": attempted, "failed": attempted - done,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # the card and its power limit: the rooflines take the peaks at 700 W
    result["power"] = power_limit() if cuda else None
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines
