"""The program's spans on the trace's clock (``program_spans``) and the five
readers of them, on a canned trace and canned records: the alignment
interval, the attribution of launches, the idle intersection."""

import json

import pytest

from conftest import ROOT
from portbench import spec
from portbench.harness import Call, Run
from portbench.program_spans import Program, program

# host clock (s): the call ran [50.0011, 50.0089]; its range on the trace
# is [1000, 9000] us, so the offset lies in [-50.0001, -49.9999]: -50 s,
# give or take 100 us; the harness's pipeline range [3010, 5990] us lies
# inside the pipeline span and narrows that to 10 us. Spans on the host
# clock, then on the trace's (us):
# batch [1500, 8500] > family [2000, 8000] > ingest [2000, 3000],
# pipeline [3000, 6000] > reweight [3500, 4500], rank [5500, 6000];
# emit [6000, 8000]; the parse [1500, 2500] on the prefetch thread.
FAMILY_SPANS = [
    ["family", None, 50.002, 50.008, {}],
    ["ingest", 0, 50.002, 50.003, {}],
    ["parse", None, 50.0015, 50.0025, {"M": 10, "thread": "prefetch"}],
    ["pipeline", 0, 50.003, 50.006, {}],
    ["reweight", 3, 50.0035, 50.0045, {"M": 10, "N": 20, "q": 21}],
    ["rank", 3, 50.0055, 50.006, {"pairs": 120}],
    ["emit", 0, 50.006, 50.008, {}],
]
BATCH_SPANS = [["batch", None, 50.0015, 50.0085, {"families": 1}]]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


# device: C launched before the batch span, A in reweight, B in pipeline,
# a copy in emit; busy [1300, 1400], [3700, 4400], [4900, 5800],
# [7100, 7200] of the window [0, 10000]
EVENTS = [
    _x("user_annotation", "portbench.window", 0, 10000),
    _x("user_annotation", "portbench.call", 1000, 8000),
    _x("user_annotation", "portbench.pipeline", 3010, 2980),
    _x("cuda_runtime", "cudaLaunchKernel", 1200, 5, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 3600, 5, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 4800, 5, correlation=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 7000, 5, correlation=4),
    _x("kernel", "C", 1300, 100, correlation=1),
    _x("kernel", "A", 3700, 700, correlation=2),
    _x("kernel", "B", 4900, 900, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH", 7100, 100, correlation=4),
]


def _run(spans=True, trace=True, events=EVENTS):
    from portbench.trace import Trace

    fam = {"family": "f0", "M": 10, "N": 20, "output": "f0.rank.txt",
           "timings_s": {"ingest": 0.001, "pipeline": 0.003, "emit": 0.002}}
    batch = {"batch": 1, "errors": 0}
    if spans:
        fam.update(spans=FAMILY_SPANS, counters={})
        batch.update(spans=BATCH_SPANS, counters={})
    call = Call(50.0011, 50.0089, 0, [(50.0081, json.dumps(fam)),
                                      (50.0088, json.dumps(batch))])
    return Run(cell=spec.load_cell(ROOT, "frob-mid"), setup_s=1.0,
               window_s=0.01, calls=[call], peak_bytes=0, spans={},
               trace=Trace(events) if trace else None)


def read(name, run):
    return spec.reader(name)(run)


def test_alignment_interval():
    prog = Program(_run())
    assert prog.half_widths == pytest.approx([10e-6])
    by = {s.name: s for s in prog.spans}
    assert by["family"].t0 == pytest.approx(2000e-6, abs=1e-9)
    assert by["batch"].t1 == pytest.approx(8500e-6, abs=1e-9)
    assert not by["parse"].main and by["rank"].main
    assert len(prog.families) == 1


@pytest.mark.parametrize("pipeline", [
    [], [(3010, 2980), (6100, 10)], [(2000, 5000)]],
    ids=["no_wrapper", "two_wrappers_one_span", "wrapper_outside_span"])
def test_alignment_falls_back_to_the_call_range(pipeline):
    events = [e for e in EVENTS if e["name"] != "portbench.pipeline"] + [
        _x("user_annotation", "portbench.pipeline", a, d)
        for a, d in pipeline]
    prog = Program(_run(events=events))
    assert prog.half_widths == pytest.approx([100e-6])
    by = {s.name: s for s in prog.spans}
    assert by["family"].t0 == pytest.approx(2000e-6, abs=1e-9)


def test_launches_belong_to_the_innermost_main_span():
    prog = Program(_run())
    assert prog.device_s_by_span() == pytest.approx(
        {"none": 100e-6, "reweight": 700e-6, "pipeline": 900e-6,
         "emit": 100e-6})
    assert prog.family_launches() == [3]


def test_idle_intersected_with_spans():
    prog = Program(_run())
    assert prog.idle() == pytest.approx(
        [(0, 1300e-6), (1400e-6, 3700e-6), (4400e-6, 4900e-6),
         (5800e-6, 7100e-6), (7200e-6, 10000e-6)])
    split = prog.idle_by_span()
    assert split == pytest.approx(
        {"none": 2900e-6, "batch": 1000e-6, "ingest": 1000e-6,
         "pipeline": 900e-6, "reweight": 300e-6, "rank": 200e-6,
         "emit": 1900e-6}, abs=1e-9)
    assert sum(split.values()) == pytest.approx(8200e-6)
    assert prog.family_idle("emit") == pytest.approx([1900e-6])


def test_the_five_readers():
    run = _run()
    assert read("device.launches", run) == 3
    assert read("ingest.parse_s", run) == pytest.approx(1e-3)
    assert read("ingest.idle_s", run) == pytest.approx(1e-3)
    assert read("rank.idle_s", run) == pytest.approx(200e-6)
    assert read("cli.emit_idle_s", run) == pytest.approx(1900e-6)
    assert program(run) is program(run)


@pytest.mark.parametrize("spans,trace", [(False, True), (True, False)],
                         ids=["program_without_spans", "untraced"])
def test_nothing_to_read(spans, trace):
    run = _run(spans, trace)
    for name in ("device.launches", "ingest.parse_s", "ingest.idle_s",
                 "rank.idle_s", "cli.emit_idle_s"):
        assert read(name, run) is None


def test_a_call_without_its_range_reads_nothing():
    run = _run()
    run.calls.append(run.calls[0])     # two calls, one range
    assert Program(run).spans == []
    assert read("rank.idle_s", run) is None
