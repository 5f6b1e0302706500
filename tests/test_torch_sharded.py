"""PyTorch port: the mesh path vs the JAX package's sharded pipeline.

The port's ``run_sharded`` on a 4x2 CPU mesh (eight shards on one device)
must equal JAX's ``run_sharded`` on ``make_mesh(8, shape=(4, 2))`` over
eight virtual CPU devices (tests/conftest.py) in f64: frob and DI, theta
auto and fixed, with M a multiple of the shard count and not (token-0 pad
rows masked by ``m_true``), with the replicated solve and with the
storage-sharded solve plus slab-local DI. ``gdca_from_msa(mesh=...)``
equals the single-device run, and the small DI golden file passes through
a mesh.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.api import resolve_mesh as jresolve_mesh
from gaussdca_tpu.parallel import mesh as jmesh
from gaussdca_tpu.parallel.sharded import run_sharded as jrun_sharded
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.interop import msa_from_arrays
from gaussdca_tpu_torch.ops import _build, di_kernel, distance
from gaussdca_tpu_torch.parallel import mesh as tmesh
from gaussdca_tpu_torch.parallel import sharded as tsharded
from gaussdca_tpu_torch.score.rank import format_rank

CPU = torch.device("cpu")
MESH8 = tmesh.Mesh([CPU] * 8, (4, 2))
MESH4 = tmesh.Mesh([CPU] * 4, (2, 2))


def _toy(M, N=12, q=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, q + 1, size=(M, N)).astype(np.int8)


@pytest.mark.parametrize("solve_min_dim", [4096, 50],
                         ids=["replicated", "storage"])
@pytest.mark.parametrize("M", [64, 61])
@pytest.mark.parametrize("theta", ["auto", 0.2])
@pytest.mark.parametrize("score", ["frob", "DI"])
def test_run_sharded_matches_jax(score, theta, M, solve_min_dim):
    """Ns = 84: solve_min_dim 50 takes the storage-sharded solve (11-row
    slabs, block 16 clamped to 11) and, for DI, the slab-local pairs."""
    Z = _toy(M, seed=M)
    kw = dict(q=8, score=score, solve_min_dim=solve_min_dim,
              solve_block=16)
    S1, th1, me1 = jrun_sharded(jmesh.make_mesh(8, shape=(4, 2)), Z, 0.5,
                                theta, dtype=jnp.float64, **kw)
    S0, th0, me0 = tsharded.run_sharded(MESH8, Z, 0.5, theta,
                                        dtype=torch.float64, **kw)
    assert float(th0) == pytest.approx(float(th1), rel=1e-12)
    assert float(me0) == pytest.approx(float(me1), rel=1e-12)
    np.testing.assert_allclose(S0.numpy(), np.asarray(S1), rtol=1e-9,
                               atol=1e-12)


def test_pad_rows_need_the_m_true_mask():
    """Without ``m_true`` the three token-0 pad rows of M = 61 on eight
    shards keep weight 1 and Meff moves by 3: the mask is load-bearing."""
    Z = tsharded.pad_rows(torch.as_tensor(_toy(61, seed=61)).view(
        torch.uint8), 8)
    cfg = GDCAConfig(pseudocount=0.5, theta=0.2, dtype=torch.float64,
                     device="cpu")
    _, _, masked = tsharded.sharded_scores(MESH8, Z, cfg, 8, m_true=61)
    _, _, unmasked = tsharded.sharded_scores(MESH8, Z, cfg, 8)
    assert float(unmasked) == pytest.approx(float(masked) + 3, rel=1e-12)


def _msa(M=45, N=14, q=7, seed=4):
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.uint8)
    Z[1:10] = Z[0]
    return msa_from_arrays(Z, q, [f"s{i}" for i in range(M)])


@pytest.mark.parametrize("score,solve_min_dim", [("frob", 4096),
                                                 ("DI", 4096),
                                                 ("DI", 10)])
def test_gdca_from_msa_mesh_equals_single_device(score, solve_min_dim):
    cfg = GDCAConfig(score=score, pseudocount=0.5, min_separation=2,
                     dtype=torch.float64, device="cpu",
                     solve_min_dim=solve_min_dim, solve_block=8)
    r0 = tapi.gdca_from_msa(_msa(), cfg)
    r1 = tapi.gdca_from_msa(_msa(), cfg, mesh=MESH4)
    assert (r1.M, r1.N, r1.q) == (r0.M, r0.N, r0.q)
    assert r1.theta == pytest.approx(r0.theta, rel=1e-12)
    assert r1.meff == pytest.approx(r0.meff, rel=1e-12)
    g0 = {(i, j): x for i, j, x in r0.ranking}
    g1 = {(i, j): x for i, j, x in r1.ranking}
    assert set(g0) == set(g1)
    keys = sorted(g0)
    np.testing.assert_allclose([g1[k] for k in keys], [g0[k] for k in keys],
                               rtol=1e-10, atol=1e-13)


def test_small_di_golden_through_mesh(golden_dir):
    r = tapi.gdca(os.path.join(golden_dir, "small.fasta.gz"),
                  pseudocount=0.2, score="DI", remove_dups=True,
                  dtype=torch.float64, device="cpu", mesh=MESH4)
    got = {}
    for line in format_rank(r.ranking).splitlines():
        i, j, x = line.split()
        got[(int(i), int(j))] = float(x)
    want = {}
    for line in open(os.path.join(golden_dir, "small.DIRout.txt")):
        i, j, x = line.split()
        want[(int(i), int(j))] = float(x)
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-6,
                               atol=1e-12)


def test_mesh_run_on_cpu_takes_plain_versions(monkeypatch):
    """A CPU mesh builds nothing and launches no kernel: it reaches the
    plain versions of the rect row statistics and the DI core."""
    def no_compiler(*args, **kwargs):
        raise AssertionError("a CPU run must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_compiler)
    calls = []
    for mod, name in ((distance, "row_stats_rect_torch"),
                      (di_kernel, "di_pairs_torch")):
        def spy(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    counters = (distance.row_stats.launches,
                distance.row_stats_rect.launches,
                di_kernel.di_pairs.launches)
    cfg = GDCAConfig(score="DI", pseudocount=0.5, dtype=torch.float64,
                     device="cpu", solve_min_dim=10, solve_block=8)
    tapi.gdca_from_msa(_msa(), cfg, mesh=MESH4)
    assert calls.count("row_stats_rect_torch") == 4
    assert calls.count("di_pairs_torch") >= 1
    assert counters == (distance.row_stats.launches,
                        distance.row_stats_rect.launches,
                        di_kernel.di_pairs.launches) == (0, 0, 0)


def test_di_pairs_row0_slab_equals_full_matrix():
    rng = np.random.default_rng(2)
    N, s = 9, 4
    A = rng.standard_normal((N * s, N * s)) * 0.3
    mJ = torch.as_tensor(A + A.T)
    B = rng.standard_normal((N, s, s))
    Ls = torch.linalg.cholesky(torch.as_tensor(
        B @ B.transpose(0, 2, 1) / s + np.eye(s)))
    iu = torch.tensor([3, 4, 5, 5, 3])
    ju = torch.tensor([0, 8, 2, 6, 4])
    full = di_kernel.di_pairs(mJ, Ls, iu, ju)
    slab = di_kernel.di_pairs(mJ[3 * s:6 * s], Ls, iu, ju, row0=3)
    assert torch.equal(full, slab)
    with pytest.raises(ValueError, match="out of range"):
        di_kernel.di_pairs(mJ[3 * s:6 * s], Ls, iu - 1, ju, row0=3)
    with pytest.raises(ValueError, match="row0"):
        di_kernel.di_pairs(mJ[3 * s:6 * s], Ls, iu, ju, row0=7)


def test_pair_assignment_covers_each_pair_once():
    N, ndev = 23, 8
    nloc, assign = tsharded._pair_assignment(N, ndev)
    seen = []
    for d, (a, o, i, j) in enumerate(assign):
        assert ((a >= d * nloc) & (a < (d + 1) * nloc)).all()
        assert (np.minimum(a, o) == i).all() and (np.maximum(a, o) == j).all()
        seen += list(zip(i, j))
    assert sorted(seen) == list(zip(*np.triu_indices(N, k=1)))


def test_mesh_forms_and_errors_match_jax():
    """The same (dp, tp) factoring and error texts as the JAX mesh."""
    for n in (1, 2, 3, 4, 6, 8, 12, 16):
        assert tmesh._factor2(n) == jmesh._factor2(n)
    jdevs = list(jmesh.make_mesh(8).devices.reshape(-1))
    for kw in (dict(n_devices=16), dict(shape=(3, 2))):
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(devices=jdevs, **kw)
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(devices=[CPU] * 8, **kw)
        assert str(got.value) == str(want.value)
    m = tmesh.make_mesh(devices=[CPU] * 8)
    assert m.shape == {"data": 2, "model": 4} == dict(
        jmesh.make_mesh(8).shape)
    assert tapi.resolve_mesh(m) is m
    with pytest.raises(ValueError) as want:
        jresolve_mesh("everything")
    with pytest.raises(ValueError) as got:
        tapi.resolve_mesh("everything")
    assert str(got.value) == str(want.value).replace(
        "jax.sharding.Mesh", "gaussdca_tpu_torch.parallel.mesh.Mesh")


def test_mesh_pins_the_index_of_a_bare_cuda_device(monkeypatch):
    """Tensors report "cuda:0", never "cuda": a mesh of "cuda" devices
    takes the current card's index, so slabs match their shards."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = tmesh.Mesh(["cuda", torch.device("cuda", 0)], (2, 1))
    assert m.flat == [torch.device("cuda", 0)] * 2
    assert m.distinct == [torch.device("cuda", 0)]


def test_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """"auto" and a shape take CUDA cards only: none here, so they raise;
    a CPU mesh under the default device="cuda" raises too."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        tapi.resolve_mesh("auto")
    with pytest.raises(ValueError, match="requested 4 devices, only 0"):
        tapi.resolve_mesh((2, 2))
    with pytest.raises(ValueError, match="device"):
        tapi.gdca_from_msa(_msa(), GDCAConfig(), mesh=MESH4)
    with pytest.raises(ValueError, match="multiple"):
        tsharded.sharded_scores(MESH4, torch.zeros((7, 5), dtype=torch.uint8),
                                GDCAConfig(device="cpu"), 4)


def test_collectives_return_fresh_tensors():
    parts = [torch.full((3,), float(d)) for d in range(4)]
    total = tmesh.psum(parts, CPU)
    assert torch.equal(total, torch.full((3,), 6.0))
    total += 1
    assert torch.equal(parts[0], torch.zeros(3))
    assert torch.equal(tmesh.all_gather(parts, CPU),
                       torch.repeat_interleave(torch.arange(4.0), 3))
