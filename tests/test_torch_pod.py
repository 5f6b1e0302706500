"""PyTorch port: the pod (``--distributed --mesh``) across two processes.

Two real processes, launched by ``parallel.podspawn`` with torchrun's
environment, join a gloo group on the CPU and run one sharded program
over a mesh whose shards they split. Held against the one-process mesh
of the same shape (the same program with plain collectives), the JAX
package's mesh runs on the 8 virtual CPU devices of ``tests/conftest.py``
and the golden files: the collectives, the storage-sharded solve, the
pod command line (golden ranking, process 0 the only writer, the agreed
cache on a rerun, the writer-setup abort) and the storage-sharded DI
pod; then ``run_family``'s pod contract in this process.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu import gdca as jgdca
from gaussdca_tpu.parallel import mesh as jmesh
from gaussdca_tpu.score.rank import format_rank as jformat_rank
from gaussdca_tpu.solve import distributed as jdist
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch import cli
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.parallel import mesh as tmesh
from gaussdca_tpu_torch.parallel.podspawn import spawn_pod
from gaussdca_tpu_torch.score.rank import format_rank
from gaussdca_tpu_torch.solve import distributed as tdist

CPU = torch.device("cpu")
ONE = tmesh.Mesh([CPU] * 4, (2, 2))        # the one-process 2 x 2 mesh
ONE8 = tmesh.Mesh([CPU] * 8, (4, 2))
# intra-op threads a child: the children compute on the CPU beside the
# other test workers
THREADS = 2


def _ok(outs):
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
    return outs


def _rank_text(text):
    return {(int(i), int(j)): float(x)
            for i, j, x in (line.split() for line in text.splitlines())}


def _assert_rankings(got, want, rtol):
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=rtol,
                               atol=1e-12)


# --- 1. the collectives -------------------------------------------------

# run by the children and, through exec, by this module (the children do
# not import this file, which imports JAX)
_HELPERS = r"""
import numpy as np
import torch
from gaussdca_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


def _shard_data(d, size):
    # what global shard d holds in the collectives check
    rng = np.random.default_rng(100 + d)
    return dict(
        gather=torch.as_tensor(rng.standard_normal((d + 1, 3))),
        sum=torch.as_tensor(rng.standard_normal(5)),
        bcast=torch.as_tensor(rng.standard_normal((2, 4))),
        a2a=[torch.full(((d + e) % 3, 2), 10.0 * d + e, dtype=torch.float64)
             for e in range(size)],
        slabs=[torch.as_tensor(rng.standard_normal((e + 1, 2)))
               for e in range(size)])


def _not_spd():
    raise ArithmeticError("not positive definite")


def _collectives(mesh):
    # every collective over this process's shards of mesh
    data = [_shard_data(d, mesh.size) for d in mesh.shards]
    first = mesh.shards.start
    out = {"gather": tmesh.all_gather([x["gather"] for x in data], CPU,
                                      mesh),
           "sum": tmesh.psum([x["sum"] for x in data], CPU, mesh)}
    for src in range(mesh.size):
        out[f"bcast{src}"] = tmesh.broadcast(
            data[src - first]["bcast"] if mesh.is_local(src) else None,
            src, mesh, (2, 4), torch.float64).clone()
    recv = tmesh.all_to_all([x["a2a"] for x in data], mesh)
    for i, d in enumerate(mesh.shards):
        for src, piece in enumerate(recv[i]):
            out[f"a2a{src}to{d}"] = piece
    # this process's partial sums of one slab per global shard
    partial = [sum(x["slabs"][e] for x in data) for e in range(mesh.size)]
    for d, slab in zip(mesh.shards, tmesh.reduce_scatter(partial, mesh)):
        out[f"rs{d}"] = slab
    out["first"] = tmesh.on_first(
        mesh, lambda: torch.arange(6.0, dtype=torch.float64) * 7,
        (6,), torch.float64)
    out["object"] = torch.as_tensor(tmesh.broadcast_object(
        mesh, [mesh.rank + 5, 3] if mesh.rank == 0 else None))
    try:
        tmesh.on_first(mesh, _not_spd, (2,), torch.float64)
    except ArithmeticError:
        out["arith"] = torch.ones(1)
    return out


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, max(n // 4, 16)))
    return A @ A.T / A.shape[1] + 0.5 * np.eye(n)
"""
_h = {}
exec(_HELPERS, _h)

_COLLECTIVES_CHILD = _HELPERS + r"""
assert tmesh.init_distributed(force=True, device="cpu") == (rank, 2)
m = tmesh.make_pod_mesh((2, 2), "cpu")
assert (m.rank, m.world, list(m.shards), m.flat) == (
    rank, 2, [2 * rank, 2 * rank + 1], [CPU] * 2)
out = _collectives(m)
np.savez(argv[0] + f"/p{rank}.npz", **{k: v.numpy() for k, v in out.items()})
"""


def test_collectives_across_processes_equal_one_process(tmp_path):
    """2 processes x 2 shards against the one-process 4-shard mesh: the
    gathers (of unequal lengths), the broadcasts and the all-to-all
    exactly; the psum and the reduce-scatter within 1e-12 relative (the
    processes' partial sums add in another order); a failure on process
    0 raised on both."""
    _ok(spawn_pod(_COLLECTIVES_CHILD, timeout=240, threads=THREADS,
                  args_per_proc=lambda i: [str(tmp_path)]))
    got = [dict(np.load(tmp_path / f"p{r}.npz")) for r in range(2)]
    want = {k: v.numpy() for k, v in _h["_collectives"](ONE).items()}
    for k, v in want.items():
        if k.startswith("rs"):
            np.testing.assert_allclose(got[int(k[2:]) // 2][k], v,
                                       rtol=1e-12)
            continue
        if k.startswith("a2a"):
            np.testing.assert_array_equal(
                got[int(k.split("to")[1]) // 2][k], v)
            continue
        for g in got:
            if k == "sum":
                np.testing.assert_allclose(g[k], v, rtol=1e-12)
            elif k == "object":
                np.testing.assert_array_equal(g[k], [5, 3])
            else:
                np.testing.assert_array_equal(g[k], v)
    # the reduce-scatter sums the two processes' partials
    slabs = [_h["_shard_data"](d, 4)["slabs"] for d in range(4)]
    for d in range(4):
        np.testing.assert_allclose(got[d // 2][f"rs{d}"],
                                   sum(s[d] for s in slabs).numpy(),
                                   rtol=1e-12)
    assert all("arith" in g for g in got) and "arith" in want


# --- 2. the storage-sharded solve ----------------------------------------

_SOLVE_CHILD = _HELPERS + r"""
from gaussdca_tpu_torch.solve import distributed as tdist
tmesh.init_distributed(force=True, device="cpu")
m = tmesh.make_pod_mesh((2, 2), "cpu")
C = torch.as_tensor(_spd(43, 7))
out = {}
for refine in (0, 1):
    X = tdist.spd_inverse_dist(tdist.to_slabs(C, m, 8), m, block=8,
                               refine_iters=refine)
    out[f"r{refine}"] = tdist.from_slabs(X, 43, CPU, m)
np.savez(argv[0] + f"/p{rank}.npz", **{k: v.numpy() for k, v in out.items()})
"""


def test_spd_inverse_dist_across_processes(tmp_path):
    """n = 43, block 8 (an identity tail): the pod's inverse equals the
    one-process 4-shard inverse within 1e-12 and JAX's on a 4-device
    mesh within 1e-10 (f64), on both processes; with one Newton step too
    (within 1e-12 of the one-process step)."""
    _ok(spawn_pod(_SOLVE_CHILD, timeout=240, threads=THREADS,
                  args_per_proc=lambda i: [str(tmp_path)]))
    C = _h["_spd"](43, 7)
    one = {r: tdist.from_slabs(tdist.spd_inverse_dist(
        tdist.to_slabs(torch.as_tensor(C), ONE, 8), ONE, block=8,
        refine_iters=r), 43, CPU).numpy() for r in (0, 1)}
    m = jmesh.make_mesh(4, shape=(2, 2))
    want = np.asarray(jax.jit(
        lambda c: jdist.spd_inverse_dist(c, mesh=m, block=8))(
            jnp.asarray(C)))
    for r in range(2):
        got = dict(np.load(tmp_path / f"p{r}.npz"))
        for k in (0, 1):
            np.testing.assert_allclose(got[f"r{k}"], one[k], rtol=1e-12,
                                       atol=1e-12 * np.abs(one[k]).max())
        np.testing.assert_allclose(got["r0"], want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        np.testing.assert_array_equal(got["r0"], got["r0"].T)


# --- 3, 4. the pod command line ----------------------------------------

_CLI_CHILD = r"""
import json
out_dir, cache, *inputs = argv
from gaussdca_tpu_torch.cli import main
rc = main(inputs + ["-o", out_dir, "--cache-dir", cache, "--device", "cpu",
                    "--dtype", "float64", "--distributed", "--mesh", "4,2"])
print(json.dumps({"rc": rc}))
"""


def _pod_cli(tmp_path, out_dirs, inputs, cache="cache"):
    return _ok(spawn_pod(
        _CLI_CHILD, timeout=300, threads=THREADS, args_per_proc=lambda i: [
            str(out_dirs[i]), str(tmp_path / cache), *inputs]))


def _records(err):
    return [json.loads(line) for line in err.splitlines()
            if line.startswith("{")]


def test_pod_cli_golden_and_cached_rerun(tmp_path, golden_dir):
    """--mesh 4,2 over two processes, f64: the small frob ranking equals
    the golden file (rtol 1e-6), the text of the port's one-process 4 x 2
    mesh run and JAX's 8-device mesh run (rtol 1e-9); process 0 alone
    writes; a rerun is served from the cache on process 0's broadcast
    decision."""
    small = os.path.join(golden_dir, "small.fasta.gz")
    out_dirs = [tmp_path / f"out{i}" for i in range(2)]
    outs = _pod_cli(tmp_path, out_dirs, [small])
    for i, (_, out, err) in enumerate(outs):
        assert json.loads(out.splitlines()[-1]) == {"rc": 0}
        head = _records(err)[0]
        assert head == {"process": i, "of": 2, "pod_mesh": True,
                        "families": 1, "device": "cpu", "backend": "gloo"}
    fams = [r for r in _records(outs[0][2]) if r.get("family") == "small"]
    assert len(fams) == 1 and fams[0]["cached"] is False
    assert not [r for r in _records(outs[1][2]) if "family" in r]
    assert not out_dirs[1].exists()
    text = (out_dirs[0] / "small.rank.txt").read_text()
    got = _rank_text(text)
    gold = _rank_text(open(os.path.join(golden_dir,
                                        "small.FNRout.txt")).read())
    _assert_rankings(got, gold, 1e-6)
    # the same emitted text as the one-process mesh run, and JAX's within
    # 1e-9 once both are printed
    one = tapi.gdca(small, dtype=torch.float64, device="cpu", mesh=ONE8)
    assert text == format_rank(one.ranking)
    ref = jgdca(small, mesh="auto", dtype="float64")
    _assert_rankings(got, _rank_text(jformat_rank(ref.ranking)), 1e-9)

    outs = _pod_cli(tmp_path, out_dirs, [small])
    fams = [r for r in _records(outs[0][2]) if r.get("family") == "small"]
    assert len(fams) == 1 and fams[0]["cached"] is True
    assert (out_dirs[0] / "small.rank.txt").read_text() == text
    assert not out_dirs[1].exists()


def test_pod_cli_writer_setup_abort(tmp_path, golden_dir):
    """Process 0 cannot create its output directory (a file is in the
    way): both processes print the setup's pod_abort and return 2 before
    computing."""
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    outs = _pod_cli(tmp_path, [blocked, tmp_path / "out1"],
                    [os.path.join(golden_dir, "small.fasta.gz")])
    for _, out, err in outs:
        assert json.loads(out.splitlines()[-1]) == {"rc": 2}
        abort = [r for r in _records(err) if r.get("pod_abort")]
        assert len(abort) == 1 and abort[0]["setup"] is True
        assert "NotADirectoryError" in abort[0]["error"] or \
            "FileExistsError" in abort[0]["error"]
        assert not [r for r in _records(err) if "family" in r]
    assert not (tmp_path / "cache").exists()


# --- 5. the storage-sharded DI pod ----------------------------------------

def _deep_family(path, q=21, N=205, M=48, seed=77):
    """Correlated rows (mutated prototypes), as the JAX pod DI test's."""
    rng = np.random.default_rng(seed)
    letters = "ACDEFGHIKLMNPQRSTVWY-"
    base = rng.integers(0, q, size=(6, N))
    rows = base[rng.integers(0, 6, size=M)]
    mut = rng.random((M, N)) < 0.3
    rows = np.where(mut, rng.integers(0, q, size=(M, N)), rows)
    path.write_text("".join(
        f">s{m}\n{''.join(letters[c] for c in rows[m])}\n"
        for m in range(M)))
    return str(path)


_API_CHILD = r"""
import json
import torch
from gaussdca_tpu_torch import gdca
from gaussdca_tpu_torch.parallel import mesh as tmesh
deep, small = argv
tmesh.init_distributed(force=True, device="cpu")
runs = {"deep": gdca(deep, score="DI", dtype=torch.float64, device="cpu",
                     mesh=(4, 2)),
        "small": gdca(small, score="DI", pseudocount=0.2, remove_dups=True,
                      dtype=torch.float64, device="cpu", mesh=(4, 2))}
print(json.dumps({k: [list(p) for p in r.ranking] for k, r in runs.items()}))
"""


def test_storage_sharded_di_pod(tmp_path, golden_dir):
    """gdca(..., mesh=(4, 2)) in a joined group of two processes, f64:
    q = 21, N = 205, M = 48 takes the storage-sharded solve (Ns = 4100 >=
    solve_min_dim) and the slab-local DI, and equals the port's
    one-process 4 x 2 mesh run and JAX's 8-device mesh run (rtol 1e-9);
    the small DI golden (Ns = 1060) takes the replicated solve and the
    split pair batch, and equals its golden file (rtol 1e-6)."""
    deep = _deep_family(tmp_path / "deepfam.fasta")
    small = os.path.join(golden_dir, "small.fasta.gz")
    assert 205 * 20 >= GDCAConfig().solve_min_dim
    outs = _ok(spawn_pod(_API_CHILD, timeout=420, threads=THREADS,
                         args_per_proc=lambda i: [deep, small]))
    got = [{k: {(i, j): x for i, j, x in v} for k, v in
            json.loads(out.splitlines()[-1]).items()} for _, out, _ in outs]
    assert got[0] == got[1]
    one = tapi.gdca(deep, score="DI", dtype=torch.float64, device="cpu",
                    mesh=ONE8)
    _assert_rankings(got[0]["deep"], {(i, j): x for i, j, x in one.ranking},
                     1e-9)
    ref = jgdca(deep, score="DI", dtype="float64", mesh="auto")
    _assert_rankings(got[0]["deep"], {(i, j): x for i, j, x in ref.ranking},
                     1e-9)
    gold = _rank_text(open(os.path.join(golden_dir,
                                        "small.DIRout.txt")).read())
    _assert_rankings(got[0]["small"], gold, 1e-6)


# --- 6. run_family's pod contract, in this process ---------------------------

def test_run_family_pod_contract(tmp_path, golden_dir):
    """emit=False writes nothing; emit_errors_fatal=False records a
    writer's I/O failure and returns None (fatal: raises); cache_only
    serves the artifact and never computes, and records (or raises) a
    missing one."""
    small = os.path.join(golden_dir, "small.fasta.gz")
    cfg = GDCAConfig(dtype="float64", device="cpu")
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    assert cli.run_family(small, cfg, str(blocked), None, None, quiet=True,
                          emit=False) is None
    assert cli.run_family(small, cfg, str(blocked), None, None, quiet=True,
                          emit_errors_fatal=False) is None
    with pytest.raises(OSError):
        cli.run_family(small, cfg, str(blocked), None, None, quiet=True)

    out, cache = tmp_path / "out", tmp_path / "cache"
    path = cli.run_family(small, cfg, str(out), None, str(cache), quiet=True)
    text = open(path).read()
    os.remove(path)

    def never(*a, **k):
        raise AssertionError("an agreed cache hit must not compute")

    real = tapi.gdca_from_msa
    tapi.gdca_from_msa = never
    try:
        assert cli.run_family(small, cfg, str(out), None, str(cache),
                              quiet=True, cache_only=True) == path
        assert open(path).read() == text
        for f in os.listdir(cache):
            os.remove(cache / f)
        assert cli.run_family(small, cfg, str(out), None, str(cache),
                              quiet=True, cache_only=True,
                              emit_errors_fatal=False) is None
        with pytest.raises(RuntimeError, match="artifact missing"):
            cli.run_family(small, cfg, str(out), None, str(cache),
                           quiet=True, cache_only=True)
    finally:
        tapi.gdca_from_msa = real


# --- 7. the pod mesh's layout, backend rule and cache key --------------------

def test_pod_mesh_layout_and_backend_rule():
    """Global shard d lives on process d // n_local; "auto" is one shard a
    process; a shape the world size does not divide is refused; the
    backend is NCCL only when every process has a card of its own; a
    pod's artifacts are keyed apart from a one-process mesh's."""
    m = tmesh.make_pod_mesh((4, 2), "cpu", rank=1, world=2)
    assert (m.size, m.n_local, list(m.shards), m.home) == (8, 4, [4, 5, 6, 7],
                                                           CPU)
    assert [m.owner(d) for d in range(8)] == [0] * 4 + [1] * 4
    assert [m.is_local(d) for d in (3, 4)] == [False, True]
    auto = tmesh.make_pod_mesh(None, "cpu", rank=2, world=4)
    assert (auto.shape, list(auto.shards)) == ({"data": 1, "model": 4}, [2])
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.make_pod_mesh((3, 1), "cpu", rank=0, world=2)
    with pytest.raises(ValueError, match="device count"):
        tmesh.Mesh([CPU] * 3, (2, 2), rank=0, world=2)
    assert tmesh.choose_backend(["cpu", "cpu"]) == "gloo"
    assert tmesh.choose_backend(["h/GPU-a", "h/GPU-a"]) == "gloo"
    assert tmesh.choose_backend(["h/GPU-a", "h/GPU-b"]) == "nccl"
    assert tmesh.choose_backend(["h/GPU-a", "cpu"]) == "gloo"
    one = tmesh.Mesh([CPU] * 8, (4, 2))
    assert cli._mesh_desc(m) != cli._mesh_desc(one)
    assert cli._mesh_desc(one) == "mesh:data4xmodel2"
