"""Each metric reader on a canned record stream and a canned trace, and
the roofline counts pinned at the main path's shapes."""

import json

import pytest

from conftest import ROOT
from portbench import roofline, spec
from portbench.harness import Call, Run, Stamped
from portbench.trace import Trace


def _rec(name, ingest, emit):
    return json.dumps({"family": name, "M": 10, "N": 20, "q": 21,
                       "timings_s": {"ingest": ingest, "pipeline": 1.0,
                                     "emit": emit}, "output": name})


def _call(t0, stamps, t1):
    lines = [(t, _rec(f"f{k}", 0.01 * (k + 1), 0.1 * (k + 1)))
             for k, t in enumerate(stamps)]
    lines.insert(1, (stamps[0], "a warning, not a record"))
    lines.append((t1, json.dumps({"batch": len(stamps), "errors": 0})))
    return Call(t0, t1, 0, lines)


# window [0, 1000] us; the host ranges nest: call > pipeline > reweight,
# and rank; two kernels (launched in reweight and in pipeline) and a copy
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
     "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
     "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.pipeline",
     "ts": 100, "dur": 500},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.reweight",
     "ts": 100, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.rank",
     "ts": 600, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "other range",
     "ts": 0, "dur": 1000},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 150, "dur": 5, "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 400, "dur": 5, "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "row_stats_kernel", "ts": 160,
     "dur": 50, "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 410, "dur": 100,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 900,
     "dur": 10},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
]


def _run(trace=None, spans=None):
    cell = spec.load_cell(ROOT, "frob-mid")
    calls = [_call(0.0, [1.0, 1.5, 2.5], 2.6),
             _call(2.6, [3.6, 3.8, 4.6], 4.7)]
    return Run(cell=cell, setup_s=12.5, window_s=4.7, calls=calls,
               peak_bytes=3 * 2 ** 30, spans=spans or {}, trace=trace)


def read(name, run):
    return spec.reader(name)(run)


def test_stamped_stream_stamps_whole_lines():
    s = Stamped()
    s.write('{"a": 1')
    s.write("}\nsecond")
    s.write("\n")
    assert [line for _, line in s.lines] == ['{"a": 1}', "second"]


def test_end_to_end_readers():
    run = _run()
    walls = [f["wall_s"] for f in run.families()]
    assert walls == pytest.approx([1.0, 0.5, 1.0, 1.0, 0.2, 0.8])
    assert read("family_s", run) == pytest.approx(4.7 / 6)
    assert read("peak_mem_gib", run) == pytest.approx(3.0)
    assert read("setup_s", run) == 12.5


def test_record_readers():
    run = _run()
    assert read("cli.emit_s", run) == pytest.approx(0.2)
    assert read("ingest.wait_s", run) == pytest.approx(0.02)
    assert read("rank.host_s", run) is None
    run.spans = {"rank": [{"host_s": 0.5}, {"host_s": 0.7}]}
    assert read("rank.host_s", run) == pytest.approx(0.6)


def test_trace_reduction():
    tr = Trace(EVENTS)
    assert tr.window_s() == pytest.approx(1000e-6)
    assert tr.busy_s() == pytest.approx(160e-6)
    assert tr.layer_device_s() == pytest.approx(
        {"reweight": 50e-6, "pipeline": 100e-6})
    assert tr.top_device_ops()[0] == ["gemm", pytest.approx(100e-6)]
    idle = dict(tr.idle_by_host())
    assert idle == pytest.approx({"host in call": (160 + 390 + 90) * 1e-6,
                                  "host in pipeline": 200e-6})


def test_trace_readers():
    tr = Trace(EVENTS)
    shapes = {"reweight": [{"M": 32768, "N": 384, "q": 21}]}
    run = _run(tr, shapes)
    assert read("device.idle_pct", run) == pytest.approx(84.0)
    want = 100 * (32768 ** 2 * 384 * 21 / roofline.INT8_OPS_S) / 50e-6
    assert read("reweight_roofline", run) == pytest.approx(want)
    # no calls of a layer, or no kernel time: nothing to read
    assert read("solve_roofline", run) is None
    assert read("frequencies_roofline", _run(tr, {"frequencies": [
        {"M": 10, "N": 10, "q": 21}]})) is None
    assert read("di_roofline", _run()) is None
    assert read("device.idle_pct", _run()) is None


def test_roofline_counts_pinned():
    ops, rate, _ = roofline.work("reweight", {"M": 32768, "N": 384, "q": 21})
    assert ops == 8658654068736 and rate == 1979e12       # 8.66e12
    assert roofline.least_seconds(
        "reweight", {"M": 32768, "N": 384, "q": 21}) == pytest.approx(
        4.375e-3, rel=1e-3)
    ops, rate, _ = roofline.work("frequencies",
                                 {"M": 32768, "N": 384, "q": 21})
    assert ops == 32768 * 7680 * 7681 and rate == 67e12    # 1.93e12
    ops, _, nbytes = roofline.work("solve", {"Ns": 20000})
    assert ops == 8e12 and nbytes == 2 * 4 * 20000 ** 2
    ops, _, nbytes = roofline.work("di", {"N": 1000, "q": 21})
    assert ops == pytest.approx(1.79181e10, rel=1e-5)     # 1.79e10
    assert nbytes == 4 * (499500 * 400 + 1000 * 400 + 1000 ** 2)
    assert roofline.di_pair_flops(20) == pytest.approx(35866.667, rel=1e-6)
