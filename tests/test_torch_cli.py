"""PyTorch port: the batch command line (``gaussdca_tpu_torch.cli``) held
against the JAX package's (``gaussdca_tpu.cli``) on the CPU.

Outputs, records, the artifact cache, the retry policy, stems, merging,
the refusals (exit 2) and the operation counts of ``utils/flops.py``.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gaussdca_tpu import cli as jcli
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch import cli
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.ops import _build
from gaussdca_tpu_torch.score import di
from gaussdca_tpu_torch.utils import flops

CPU = ["--device", "cpu", "--dtype", "float64"]
JAX_KEYS = {"family", "M", "N", "q", "dropped_gaps", "dropped_dups", "theta",
            "meff", "pairs", "score", "output", "cached", "tflop",
            "tflop_per_s", "timings_s", "total_s"}


@pytest.fixture
def small(golden_dir):
    return os.path.join(golden_dir, "small.fasta.gz")


def read_rank(path):
    out = {}
    for line in open(path):
        t = line.split()
        assert len(t) == 3
        out[(int(t[0]), int(t[1]))] = float(t[2])
    return out


def records(err: str):
    return [json.loads(line) for line in err.strip().splitlines()]


def assert_close(got, want, rel=1e-6):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rel), k


@pytest.mark.parametrize("args,golden", [
    ([], "small.FNRout.txt"),
    (["--score", "DI", "--pseudocount", "0.2", "--remove-dups"],
     "small.DIRout.txt"),
])
def test_outputs_match_jax_cli_and_golden(small, golden_dir, tmp_path, args,
                                          golden):
    assert cli.main([small, "-o", str(tmp_path / "t"), "--quiet", *CPU,
                     *args]) == 0
    assert jcli.main([small, "-o", str(tmp_path / "j"), "--quiet",
                      "--dtype", "float64", "--compile-cache", "none",
                      *args]) == 0
    got = read_rank(tmp_path / "t" / "small.rank.txt")
    assert_close(got, read_rank(tmp_path / "j" / "small.rank.txt"))
    assert_close(got, read_rank(os.path.join(golden_dir, golden)))


def test_record_fields_match_jax(small, tmp_path, capsys):
    assert cli.main([small, "-o", str(tmp_path / "t"), *CPU]) == 0
    rec, batch = records(capsys.readouterr().err)
    jcli.main([small, "-o", str(tmp_path / "j"), "--dtype", "float64",
               "--compile-cache", "none"])
    jrec = records(capsys.readouterr().err)[0]
    assert set(rec) == JAX_KEYS | {"device", "parser"}
    assert set(jrec) == JAX_KEYS
    for k in ("family", "M", "N", "q", "dropped_gaps", "dropped_dups",
              "pairs", "score", "cached"):
        assert rec[k] == jrec[k], k
    assert rec["theta"] == pytest.approx(jrec["theta"], abs=1e-6)
    assert rec["meff"] == pytest.approx(jrec["meff"], abs=1e-4)
    assert (rec["M"], rec["N"], rec["q"], rec["pairs"]) == (106, 53, 21, 1176)
    assert rec["device"] == "cpu" and rec["parser"] == "native"
    assert set(rec["timings_s"]) == {"ingest", "pipeline", "emit"}
    fl = flops.pipeline_flops(106, 53, 21, dtype=torch.float64)
    assert rec["tflop"] == round(fl["total"] / 1e12, 4)
    assert batch == {"batch": 1, "errors": 0, "total_s": batch["total_s"]}


def test_top_k_is_the_head_of_the_ranking(small, tmp_path):
    cli.main([small, "-o", str(tmp_path / "all"), "--quiet", *CPU])
    cli.main([small, "-o", str(tmp_path / "top"), "--quiet", "--top-k", "25",
              *CPU])
    full = (tmp_path / "all" / "small.rank.txt").read_text().splitlines()
    head = (tmp_path / "top" / "small.rank.txt").read_text().splitlines()
    assert head == full[:25]


def test_cache_hit(small, tmp_path, capsys):
    cache, out = str(tmp_path / "cache"), str(tmp_path / "out")
    cli.main([small, "-o", out, "--cache-dir", cache, *CPU])
    first = records(capsys.readouterr().err)[0]
    text = (tmp_path / "out" / "small.rank.txt").read_bytes()
    (tmp_path / "out" / "small.rank.txt").unlink()
    cli.main([small, "-o", out, "--cache-dir", cache, *CPU])
    second = records(capsys.readouterr().err)[0]
    assert first["cached"] is False and second["cached"] is True
    assert "pipeline" not in second["timings_s"]
    assert (tmp_path / "out" / "small.rank.txt").read_bytes() == text
    # the JAX CLI's compile flags change nothing, not even the key
    cli.main([small, "-o", out, "--cache-dir", cache, "--m-bucket", "0",
              "--n-bucket", "0", "--compile-cache", "none", "--warm-compile",
              *CPU])
    assert records(capsys.readouterr().err)[0]["cached"] is True
    # different settings: a miss
    cli.main([small, "-o", out, "--cache-dir", cache, "--min-separation", "4",
              *CPU])
    third = records(capsys.readouterr().err)[0]
    assert third["cached"] is False and third["pairs"] == 1225


def test_no_effect_flags_and_no_prefetch_give_the_same_text(small, tmp_path):
    cli.main([small, small, "-o", str(tmp_path / "a"), "--quiet", *CPU])
    cli.main([small, small, "-o", str(tmp_path / "b"), "--quiet",
              "--no-prefetch", "--m-bucket", "0", "--n-bucket", "64",
              "--compile-cache", "none", "--warm-compile", *CPU])
    for name in ("small.rank.txt", "small.2.rank.txt"):
        assert (tmp_path / "a" / name).read_bytes() \
            == (tmp_path / "b" / name).read_bytes()


def test_batch_with_error(small, tmp_path, capsys):
    rc = cli.main([small, str(tmp_path / "missing.fa"), "-o", str(tmp_path),
                   *CPU])
    assert rc == 1
    recs = records(capsys.readouterr().err)
    assert any(r.get("error_type") == "ValueError" for r in recs)
    assert recs[-1]["batch"] == 2 and recs[-1]["errors"] == 1
    assert (tmp_path / "small.rank.txt").exists()


@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
])
def test_transient_runtime_error_is_retried_once(small, tmp_path, capsys,
                                                 monkeypatch, error):
    real = tapi.gdca_from_msa
    calls = {"n": 0, "empty_cache": 0}

    def flaky(msa, cfg, top_k=None, mesh=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise error
        return real(msa, cfg, top_k=top_k, mesh=mesh)

    def empty_cache():
        calls["empty_cache"] += 1

    monkeypatch.setattr(tapi, "gdca_from_msa", flaky)
    monkeypatch.setattr(torch.cuda, "empty_cache", empty_cache)
    rc = cli.main([small, small, "-o", str(tmp_path), *CPU])
    assert rc == 0
    assert calls["n"] == 3   # family 1: attempt + retry; family 2: one
    assert calls["empty_cache"] == isinstance(
        error, torch.cuda.OutOfMemoryError)
    assert (tmp_path / "small.rank.txt").exists()
    assert (tmp_path / "small.2.rank.txt").exists()
    recs = records(capsys.readouterr().err)
    assert any(r.get("retry") for r in recs) and recs[-1]["errors"] == 0


def test_deterministic_error_not_retried(small, tmp_path, capsys,
                                         monkeypatch):
    calls = {"n": 0}

    def broken(msa, cfg, top_k=None, mesh=None):
        calls["n"] += 1
        raise TypeError("bad config wiring")

    monkeypatch.setattr(tapi, "gdca_from_msa", broken)
    assert cli.main([small, small, "-o", str(tmp_path), *CPU]) == 1
    assert calls["n"] == 2
    recs = records(capsys.readouterr().err)
    assert not any(r.get("retry") for r in recs)
    assert recs[-1]["errors"] == 2


def test_persistent_runtime_error_skips_the_family(small, tmp_path, capsys,
                                                   monkeypatch):
    real = tapi.gdca_from_msa
    calls = {"n": 0}

    def broken_then_ok(msa, cfg, top_k=None, mesh=None):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(msa, cfg, top_k=top_k, mesh=mesh)

    monkeypatch.setattr(tapi, "gdca_from_msa", broken_then_ok)
    assert cli.main([small, small, "-o", str(tmp_path), *CPU]) == 1
    assert not (tmp_path / "small.rank.txt").exists()
    assert (tmp_path / "small.2.rank.txt").exists()
    recs = records(capsys.readouterr().err)
    err = [r for r in recs if "error_type" in r]
    assert err and err[0]["error_type"] == "RuntimeError"
    assert recs[-1] == {"batch": 2, "errors": 1,
                        "total_s": recs[-1]["total_s"]}


def test_merge_output(small, tmp_path):
    merged = tmp_path / "new_subdir" / "merged.txt"
    rc = cli.main([small, small, "-o", str(tmp_path), "--top-k", "5",
                   "--quiet", "--merge-output", str(merged), "--theta",
                   "0.2", *CPU])
    assert rc == 0
    want = [f"{stem} {line}" for stem in ("small", "small.2")
            for line in (tmp_path / f"{stem}.rank.txt").read_text()
            .splitlines()]
    assert merged.read_text().splitlines() == want and len(want) == 10


@pytest.mark.parametrize("paths", [
    ["a/fam.fasta", "b/fam.fasta", "c/other.fa", "d/fam.fasta.gz"],
    ["x.afa", "x.fna", "x", "y/x.fasta.gz", "x.fa.gz", "weird.name.gz"],
    ["one.fasta"],
])
def test_stems_match_jax(paths):
    assert [cli._stem(p) for p in paths] == [jcli._stem(p) for p in paths]
    stems = cli._output_stems(paths)
    assert stems == jcli._output_stems(paths)
    assert len(set(stems)) == len(stems)


@pytest.mark.parametrize("fn,arg", [
    ("_parse_theta", "auto"), ("_parse_theta", "0.25"),
    ("_parse_theta", "1"), ("_parse_theta", "abc"),
    ("_parse_mesh", None), ("_parse_mesh", "auto"), ("_parse_mesh", "4,2"),
    ("_parse_mesh", "4x2"), ("_parse_mesh", "1X1"), ("_parse_mesh", "4"),
    ("_parse_mesh", "a,b"), ("_parse_mesh", "1,2,3"),
])
def test_argument_parsers_match_jax(fn, arg):
    def run(f):
        try:
            return ("ok", f(arg))
        except SystemExit as e:
            return ("exit", str(e))

    assert run(getattr(cli, fn)) == run(getattr(jcli, fn))


class _OddError(Exception):
    pass


@pytest.mark.parametrize("error", [
    RuntimeError("boom"), torch.cuda.OutOfMemoryError("CUDA out of memory"),
    _OddError("DEADLINE_EXCEEDED: tunnel"), ValueError("q too big"),
    OSError("no such file"), TypeError("bad arg"), AssertionError("shape"),
    KeyError("k"), NotImplementedError("op"), RecursionError("deep"),
])
def test_retry_policy_matches_jax(error):
    assert cli._retryable(error) == jcli._retryable(error)


def _key(path, **kw):
    mesh_desc = kw.pop("mesh_desc", "")
    top_k = kw.pop("top_k", None)
    return cli._cache_key(str(path), GDCAConfig(**kw), top_k, mesh_desc)


def test_cache_key_tracks_settings_device_mesh_and_sources(tmp_path,
                                                          monkeypatch):
    p = tmp_path / "x.fasta"
    p.write_text(">a\nACDEF\n")
    base = _key(p, device="cpu")
    assert base == _key(p, device="cpu")
    variants = [dict(device="cpu", dtype="float64"), dict(device="cuda"),
                dict(device="cpu", mesh_desc="mesh:data2xmodel1"),
                dict(device="cpu", top_k=10), dict(device="cpu", theta=0.2),
                dict(device="cpu", pseudocount=0.5),
                dict(device="cpu", score="DI"),
                dict(device="cpu", remove_dups=True),
                dict(device="cpu", min_separation=4),
                dict(device="cpu", max_gap_fraction=0.8)]
    keys = {_key(p, **kw) for kw in variants}
    assert base not in keys and len(keys) == len(variants)
    # a kernel source edit changes the key, the parser's source does not
    csrc, orig = tmp_path / "csrc", _build.CSRC_DIR
    shutil.copytree(orig, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert _key(p, device="cpu") == base
    with open(csrc / "fasta_native.cpp", "a") as fh:
        fh.write("// edited\n")
    assert _key(p, device="cpu") == base
    with open(csrc / "row_stats.cu", "a") as fh:
        fh.write("// edited\n")
    edited = _key(p, device="cpu")
    assert edited != base
    with open(csrc / "onehot_wgmma.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _key(p, device="cpu") not in (base, edited)
    # and so do the DI step constants
    monkeypatch.setattr(_build, "CSRC_DIR", orig)
    monkeypatch.setattr(di, "BM_NS_ITERS", di.BM_NS_ITERS + 1)
    assert _key(p, device="cpu") != base


@pytest.mark.parametrize("args,text", [
    (["--fallback"], "--device cpu"),
    (["--distributed", "--mesh", "3,1", "--device", "cpu"],
     "do not split evenly over the 2 processes"),
    (["--device", "cuda"], "--device cpu"),
    ([], "--device cpu"),
])
def test_refusals_exit_2_before_computing(small, tmp_path, capsys,
                                         monkeypatch, args, text):
    def never(*a, **k):
        raise AssertionError("nothing may run")

    monkeypatch.setattr(tapi, "gdca_from_msa", never)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # a pod of two processes (no group is joined: the shape is refused
    # before any collective)
    monkeypatch.setattr(cli.meshlib, "init_distributed",
                        lambda force, device: (0, 2))
    out = tmp_path / "out"
    assert cli.main([small, "-o", str(out), *args]) == 2
    assert text in capsys.readouterr().err
    assert not out.exists()


def test_cpu_mesh_equals_one_device(small, tmp_path, monkeypatch):
    """--mesh 2,1 --device cpu: the pair set of the one-device run and its
    scores within 1e-10 (f64), read from the results before emission."""
    real = tapi.gdca_from_msa
    seen = []

    def spy(msa, cfg, top_k=None, mesh=None):
        r = real(msa, cfg, top_k=top_k, mesh=mesh)
        seen.append((mesh, {(i, j): x for i, j, x in r.ranking}))
        return r

    monkeypatch.setattr(tapi, "gdca_from_msa", spy)
    for sub, extra in (("one", []), ("mesh", ["--mesh", "2,1"])):
        assert cli.main([small, "-o", str(tmp_path / sub), "--quiet",
                         "--score", "DI", *CPU, *extra]) == 0
    (m0, one), (m1, mesh) = seen
    assert m0 is None and m1.shape == {"data": 2, "model": 1}
    assert set(one) == set(mesh)
    assert max(abs(one[k] - mesh[k]) for k in one) <= 1e-10
    assert set(read_rank(tmp_path / "mesh" / "small.rank.txt")) == set(one)


def test_cpu_mesh_auto_is_refused(small, tmp_path):
    assert cli.main([small, "-o", str(tmp_path), "--mesh", "auto",
                     "--device", "cpu"]) == 2


def test_profile_dir_writes_a_trace(small, tmp_path):
    prof = tmp_path / "prof"
    assert cli.main([small, "-o", str(tmp_path), "--quiet", "--profile-dir",
                     str(prof), "--device", "cpu"]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_module_help_runs():
    proc = subprocess.run([sys.executable, "-m", "gaussdca_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "no effect" in proc.stdout


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [181, 182])   # P = 16290 and 16471
def test_di_flops_follow_the_step_rule(dtype, N):
    """The DI count takes its steps from score.di.ns_iters, either side of
    16384 pairs, in f32 and f64 (and a mesh by its pairs a shard)."""
    P = N * (N - 1) // 2
    fl = flops.pipeline_flops(1000, N, 21, score="DI", dtype=dtype)
    assert fl["score"] == P * flops.di_pair_flops(20, di.ns_iters(dtype, P))
    want = {torch.float64: 40}.get(dtype, 28 if P < 16384 else 14)
    assert di.ns_iters(dtype, P) == want
    sh = flops.pipeline_flops(1000, N, 21, score="DI", dtype=dtype, shards=4)
    assert sh["score"] == P * flops.di_pair_flops(
        20, di.ns_iters(dtype, -(-P // 4)))


def test_flops_by_stage():
    M, N, q = 1000, 100, 21
    Ns = N * (q - 1)
    one = flops.pipeline_flops(M, N, q, auto_theta=False)
    assert one["reweight"] == M * M * N * q
    assert one["frequencies"] == 2.0 * M * Ns * Ns
    # the Cholesky factorization and the inverse from it, no Newton step
    assert one["solve"] == Ns ** 3
    assert one["total"] == sum(v for k, v in one.items() if k != "total")
    auto = flops.pipeline_flops(M, N, q)
    assert auto["reweight"] - one["reweight"] == 3.0 * M * N * q
    assert flops.pipeline_flops(M, N, q, dtype=torch.float64)["solve"] \
        == Ns ** 3
    mesh = flops.pipeline_flops(M, N, q, shards=4, auto_theta=False)
    assert mesh["reweight"] == 2 * one["reweight"]
    # the mesh's replicated and storage-sharded solves alike
    assert mesh["solve"] == Ns ** 3
    # kernel B's bound in chip_smoke.py: 3.38e11 at N=1000, s=20, 14 steps
    assert 499500 * flops.di_pair_flops(20, 14) == pytest.approx(3.383e11,
                                                                 rel=1e-3)


def test_package_ships_every_source_and_the_console_script():
    """An installed package builds from its own csrc/: every kernel source,
    shared header and the parser's source are package data."""
    import fnmatch
    import tomllib

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "pyproject.toml"), "rb") as fh:
        project = tomllib.load(fh)
    globs = project["tool"]["setuptools"]["package-data"][
        "gaussdca_tpu_torch"]
    sources = os.listdir(_build.CSRC_DIR)
    assert {f.rsplit(".", 1)[1] for f in sources} == {"cu", "cuh", "cpp"}
    for f in sources:
        assert any(fnmatch.fnmatch("csrc/" + f, g) for g in globs), f
    assert project["project"]["scripts"]["gaussdca-tpu-torch"] \
        == "gaussdca_tpu_torch.cli:main"
