"""PyTorch port: the program's spans (``utils.log``) on the CPU.

The records' span trees under a profiler, the ``gdca.*`` ranges of the
exported trace and their clock, the prefetched parse's family, the mesh's
``collective`` spans (in a pod, the exchange alone), and the untraced
path: no range opened, the record as it was. Tiny families, one CPU
device.
"""

import contextlib
import gzip
import inspect
import io
import json
import os
import pickle
import statistics

import numpy as np
import pytest
import torch

import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from gaussdca_tpu_torch import api, cli
from gaussdca_tpu_torch.core import runtime
from gaussdca_tpu_torch.parallel import mesh as meshlib
from gaussdca_tpu_torch.parallel import sharded
from gaussdca_tpu_torch.solve import cholesky
from gaussdca_tpu_torch.utils import log

CPU = ["--device", "cpu", "--dtype", "float64"]
# the record of a computed family with tracing off (test_torch_cli.py)
RECORD_KEYS = {"family", "M", "N", "q", "dropped_gaps", "dropped_dups",
               "theta", "meff", "pairs", "score", "output", "cached",
               "tflop", "tflop_per_s", "timings_s", "total_s", "device",
               "parser"}
PIPELINE = ["upload", "reweight", "frequencies", "covariance", "solve",
            "score", "apc", "wait", "rank"]


@pytest.fixture
def small(golden_dir):
    return os.path.join(golden_dir, "small.fasta.gz")


def write_family(path, M, N, seed):
    """A gzipped FASTA alignment of M random sequences of N columns."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY-"))
    with gzip.open(path, "wt") as fh:
        for m in range(M):
            fh.write(f">s{m}\n{''.join(rng.choice(letters, N))}\n")
    return str(path)


def run_cli(argv, ctx=None):
    """cli.main under ``ctx``: (exit code, the JSON records on stderr)."""
    err = io.StringIO()
    with ctx or contextlib.nullcontext(), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, [json.loads(line) for line in err.getvalue().splitlines()
                if line.startswith("{")]


def tree(rec):
    """{name: [child names in order]} of a record's spans, root "" ."""
    spans = rec["spans"]
    out = {}
    for name, parent, t0, t1, attrs in spans:
        assert t0 <= t1
        key = "" if parent is None else spans[parent][0]
        out.setdefault(key, []).append(name)
    return out


def cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_record_spans_under_an_outer_profiler(small, tmp_path):
    other = write_family(tmp_path / "b.fasta.gz", 40, 12, 1)
    argv = [small, other, "-o", str(tmp_path / "o"), "--score", "DI",
            "--pseudocount", "0.2", "--remove-dups", "--cache-dir",
            str(tmp_path / "c"), *CPU]
    with cpu_profiler() as prof:
        rc, recs = run_cli(argv)
    assert rc == 0
    fams, batch = recs[:-1], recs[-1]
    assert len(fams) == 2
    for rec in fams:
        t = tree(rec)
        assert t[""] == ["family", "parse"]
        assert t["family"] == ["ingest", "pipeline", "emit"]
        assert t["pipeline"] == PIPELINE
        spans = {s[0]: s for s in rec["spans"]}
        assert spans["parse"][4]["thread"] == "prefetch"
        assert spans["reweight"][4] == {"M": rec["M"], "N": rec["N"],
                                        "q": rec["q"]}
        assert spans["frequencies"][4]["dtype"] == "float64"
        Ns = rec["N"] * (rec["q"] - 1)
        assert spans["solve"][4] == {"Ns": Ns, "dtype": "float64",
                                     "blocks": -(-Ns // cholesky.BLOCK),
                                     "refine": 0}
        assert spans["score"][4]["score"] == "DI"
        assert spans["rank"][4]["pairs"] == rec["pairs"]
        assert spans["rank"][4]["sorted_on"] == "cpu"
        # the stage walls are the spans' own
        for st in ("ingest", "pipeline", "emit"):
            s = spans[st]
            assert rec["timings_s"][st] == round(s[3] - s[2], 4)
        assert rec["counters"] == {}
        assert "device_s" not in spans["reweight"][4]   # a CPU stream
    assert tree(batch) == {"": ["batch"]}
    assert batch["counters"] == {}


def test_trace_ranges_match_the_records_on_one_offset(small, tmp_path):
    trace = tmp_path / "trace.json"
    with cpu_profiler() as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        rc, recs = run_cli([small, small, "-o", str(tmp_path / "o"), *CPU])
    assert rc == 0
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(log.PREFIX)]
    main = {e["tid"] for e in ranges if e["name"] == "gdca.batch"}
    assert len(main) == 1
    ranges = sorted((e for e in ranges if e["tid"] in main),
                    key=lambda e: (e["ts"], -e["dur"]))
    spans = sorted((s for r in recs for s in r["spans"]
                    if "thread" not in s[4]), key=lambda s: (s[2], -s[3]))
    assert [e["name"] for e in ranges] == [log.PREFIX + s[0] for s in spans]
    assert {"gdca.family", "gdca.reweight", "gdca.rank",
            "gdca.emit"} <= {e["name"] for e in ranges}
    # each range opens before its span's t0 and closes after its t1 (a
    # thread switch between the two only widens that range), so one
    # offset puts every span inside its range: the largest start
    # difference is at most the smallest end difference
    lo = max(e["ts"] / 1e6 - s[2] for e, s in zip(ranges, spans))
    hi = min((e["ts"] + e["dur"]) / 1e6 - s[3] for e, s in zip(ranges, spans))
    assert lo <= hi + 1e-3
    assert abs(lo - statistics.median(
        e["ts"] / 1e6 - s[2] for e, s in zip(ranges, spans))) < 1e-3


def test_profile_dir_trace_carries_the_ranges(small, tmp_path):
    rc, recs = run_cli([small, "-o", str(tmp_path / "o"), "--profile-dir",
                        str(tmp_path / "p"), *CPU])
    assert rc == 0
    events = json.loads((tmp_path / "p" / "trace.json").read_text())[
        "traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {log.PREFIX + n for n in
            ["batch", "family", "ingest", "pipeline", "emit", *PIPELINE]
            } <= names
    # while the batch's own profiler records, the records carry spans
    assert [s[0] for s in recs[0]["spans"]][:2] == ["family", "ingest"]
    assert not log.tracing_on()


@pytest.mark.parametrize("prefetch", [True, False])
def test_parse_lands_in_its_family(tmp_path, prefetch):
    paths = [write_family(tmp_path / "a.fasta.gz", 40, 12, 1),
             write_family(tmp_path / "b.fasta.gz", 30, 17, 2),
             write_family(tmp_path / "c.fasta.gz", 50, 9, 3)]
    argv = [*paths, "-o", str(tmp_path / "o"), *CPU]
    if not prefetch:
        argv.append("--no-prefetch")
    rc, recs = run_cli(argv, log.tracing())
    assert rc == 0
    for rec in recs[:-1]:
        parses = [s for s in rec["spans"] if s[0] == "parse"]
        assert len(parses) == 1
        name, parent, _, _, attrs = parses[0]
        assert (attrs["M"], attrs["N"]) == (rec["M"], rec["N"])
        assert attrs["parser"] == rec["parser"]
        assert attrs["bytes"] == os.path.getsize(
            tmp_path / (rec["family"] + ".fasta.gz"))
        if prefetch:
            assert parent is None and attrs["thread"] == "prefetch"
        else:
            assert rec["spans"][parent][0] == "ingest"
            assert "thread" not in attrs


def test_mesh_run_has_the_stages_and_collectives(small, tmp_path):
    rc, recs = run_cli([small, "-o", str(tmp_path / "o"), "--mesh", "2,2",
                        *CPU], log.tracing())
    assert rc == 0
    rec, = [r for r in recs if "family" in r]
    assert tree(rec)["pipeline"] == PIPELINE
    rank = [s for s in rec["spans"] if s[0] == "rank"]
    assert [s[4]["sorted_on"] for s in rank] == ["cpu"]
    coll = [s for s in rec["spans"] if s[0] == "collective"]
    assert coll
    ops = {s[4]["op"] for s in coll}
    assert {"all_gather", "psum"} <= ops
    for name, parent, _, _, attrs in coll:
        assert attrs["bytes"] > 0
        assert rec["spans"][parent][0] in PIPELINE
    assert rec["counters"]["collective_bytes"] == sum(
        s[4]["bytes"] for s in coll)
    assert rec["counters"]["collective_s"] == pytest.approx(sum(
        s[3] - s[2] for s in coll))
    assert set(rec["counters"]) == {"collective_s", "collective_bytes"}


@pytest.mark.parametrize("mesh", [None, "2,2"])
def test_solve_span_counts_blocks_and_newton_steps(small, tmp_path, mesh):
    """The ``solve`` span of the one-device solve (alone, or the mesh's
    replicated solve below ``solve_min_dim``) carries its block steps and
    its Newton steps: the small family's Ns = 1060 takes two blocks of
    1024, and no step."""
    argv = [small, "-o", str(tmp_path / "o"), *CPU]
    if mesh:
        argv += ["--mesh", mesh]
    rc, recs = run_cli(argv, log.tracing())
    assert rc == 0
    rec, = [r for r in recs if "family" in r]
    solve, = [s for s in rec["spans"] if s[0] == "solve"]
    assert solve[4]["Ns"] == 1060 > cholesky.BLOCK
    assert solve[4]["blocks"] == 2
    assert solve[4]["refine"] == 0


def test_untraced_opens_no_range_and_keeps_the_record(small, tmp_path,
                                                      monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    rc, recs = run_cli([small, "-o", str(tmp_path / "o"), "--mesh", "2,2",
                        "--cache-dir", str(tmp_path / "c"), *CPU])
    assert rc == 0
    assert calls == []
    assert recs[0] == {"mesh": {"data": 2, "model": 2}}
    assert set(recs[1]) == RECORD_KEYS
    assert set(recs[1]["timings_s"]) == {"ingest", "pipeline", "emit"}
    assert set(recs[2]) == {"batch", "errors", "total_s"}
    with log.tracing():
        with log.span("x"):
            pass
    assert calls == [("gdca.x",)]


def test_pipelines_take_no_stage_hook():
    assert "mark" not in inspect.signature(api.scores_pipeline).parameters
    assert "mark" not in inspect.signature(
        sharded.sharded_scores).parameters
    assert not hasattr(runtime, "no_mark")


def test_untraced_span_is_a_flag_test():
    assert not log.tracing_on()
    rec = log.RunLog("f", enabled=False)
    with rec.bound():
        sp = log.span("x", torch.device("cpu"), a=1)
        with sp as inner:
            inner.set(b=2)
        log.count(n=1)
        with rec.stage("ingest") as st:
            st.set(c=3)
    assert sp is log.span("y")
    assert rec.spans == [] and rec.counters == {}
    assert set(rec.timings) == {"ingest"}
    assert "spans" not in rec.emit()


def test_tracing_records_nested_spans_and_counters():
    rec = log.RunLog("f", enabled=False)
    with log.tracing(), rec.bound():
        assert log.tracing_on()
        with rec.stage("pipeline", n=1):
            with log.span("reweight", M=3) as sp:
                sp.set(done=True)
                log.count(n=5)
            log.count(n=2)
        with log.span("rank"):
            pass
    assert not log.tracing_on()
    out = rec.emit()
    assert [s[:2] for s in out["spans"]] == [["pipeline", None],
                                            ["reweight", 0], ["rank", None]]
    assert out["spans"][1][4] == {"M": 3, "done": True}
    assert out["counters"] == {"n": 7}
    assert out["timings_s"]["pipeline"] == round(
        out["spans"][0][3] - out["spans"][0][2], 4)


def test_absorb_renumbers_the_other_threads_spans():
    a, b = log.RunLog("a", enabled=False), log.RunLog("a", enabled=False)
    with log.tracing():
        with a.bound(), log.span("family"), log.span("ingest"):
            pass
        with b.bound(), log.span("parse"), log.span("read"):
            log.count(n=2)
        a.absorb(b, thread="prefetch")
    assert [s[:2] for s in a.spans] == [["family", None], ["ingest", 0],
                                       ["parse", None], ["read", 2]]
    assert all(s[4] == {"thread": "prefetch"} for s in a.spans[2:])
    assert a.counters == {"n": 2}


def test_spans_without_a_bound_log_record_nothing():
    assert log.current() is None
    with log.tracing():
        with log.span("parse") as sp:
            sp.set(M=1)
        log.count(n=1)


def test_pod_collective_spans_hold_only_the_exchange(monkeypatch):
    """In a pod (here two processes faked: each ``torch.distributed`` call
    answered in place) every collective span holds one exchange, and the
    staging copies to and from the host stay outside it."""
    rec = log.RunLog("f", enabled=False)

    def inside():
        return bool(rec._stack) and \
            rec.spans[rec._stack[-1]][0] == "collective"

    calls = []

    def fake(name, fill):
        def call(*a, **k):
            assert inside(), name
            calls.append(rec.spans[rec._stack[-1]][4]["op"])
            fill(*a)
        return call

    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    for name, fill in (
            ("all_reduce", lambda buf: None), ("reduce", lambda buf: None),
            ("broadcast", lambda buf: None),
            ("broadcast_object_list", lambda box: None),
            ("all_gather", lambda outs, t: [o.copy_(t) for o in outs]),
            ("all_to_all_single", lambda out, *a: out.zero_())):
        monkeypatch.setattr(dist, name, fake(name, fill))
    copies = {True: 0, False: 0}   # Tensor.to calls, inside a span or not

    class Copies(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.to:
                copies[inside()] += 1
            return func(*args, **(kwargs or {}))

    cpu = torch.device("cpu")
    mesh = meshlib.Mesh([cpu, cpu], (2, 2), rank=0, world=2)
    x = torch.ones(3, 4)
    with log.tracing(), rec.bound(), Copies():
        meshlib.psum([x, x], cpu, mesh)
        meshlib.all_gather([x, x], cpu, mesh)
        meshlib.broadcast(x, 0, mesh, x.shape, x.dtype)
        meshlib.broadcast(None, 3, mesh, x.shape, x.dtype)
        meshlib.reduce(x, 0, mesh)
        meshlib.all_to_all([[x] * 4, [x] * 4], mesh)
        meshlib.broadcast_object(mesh, "ok")
    assert copies[False] > 0 and copies[True] == 0
    assert calls == ["psum", "all_gather", "all_gather", "broadcast",
                     "broadcast", "reduce", "all_gather", "all_to_all",
                     "broadcast_object"]
    assert [s[0] for s in rec.spans] == ["collective"] * len(calls)
    assert [s[4]["bytes"] for s in rec.spans] == [
        48, 8, 96, 48, 0, 48, 128, 384, len(pickle.dumps("ok"))]
    assert rec.counters["collective_bytes"] == sum(
        s[4]["bytes"] for s in rec.spans)
    assert rec.counters["collective_s"] == pytest.approx(sum(
        s[3] - s[2] for s in rec.spans))
