"""PyTorch port: the DI Newton-Schulz step rule and the q=31 fixtures.

- ``ns_iters`` follows the JAX package: 40 steps in f64 (JAX's monitored
  ``sqrtm_spd`` loop is capped at 40), 28 in f32 below 16384 pairs (its
  fixed-step small-batch path), else 14 (its batch-minor core); a mesh
  judges by its pairs a shard, ceil(P / shards), as JAX's sharded DI;
- in f64, ``di_score`` and both mesh DI bodies equal JAX's
  ``_di_tail_gemm(..., sqrtm_spd)`` on pairs with cond(G) from 10 to 1e6
  (14 steps leave errors of order 0.1 to 10 there);
- the port reproduces the self-generated q=31 fixtures
  (``tests/data/synth_q31.*``), built as ``tests/test_golden.py`` builds
  them: rel 5e-7 in f64 (the fixture's printed precision); max abs error
  within 5e-5 (frob) and 1e-4 (DI) in f32, about 3x the 1.4e-5 and
  3.2e-5 measured on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.score import di as jdi
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.interop import msa_from_arrays
from gaussdca_tpu_torch.parallel import sharded as tsharded
from gaussdca_tpu_torch.parallel.mesh import Mesh
from gaussdca_tpu_torch.score import di as tdi

CPU = torch.device("cpu")


def test_ns_iters_follows_jax():
    assert tdi.ns_iters(torch.float64, 10) == 40
    assert tdi.ns_iters(torch.float64, 10 ** 6) == 40
    assert tdi.ns_iters(torch.float32, jdi._BM_MIN_PAIRS - 1) == \
        jdi.FALLBACK_NS_ITERS == 28
    assert tdi.ns_iters(torch.float32, jdi._BM_MIN_PAIRS) == \
        jdi.BM_NS_ITERS == 14
    assert tdi.BM_MIN_PAIRS == jdi._BM_MIN_PAIRS


def _spy(monkeypatch, module, calls):
    """Replace ``module.di_pairs`` by a recorder of its step count."""
    def spy(mJ, Ls, iu, ju, iters, **kw):
        calls.append(iters)
        return torch.zeros(iu.numel(), dtype=mJ.dtype)
    monkeypatch.setattr(module, "di_pairs", spy)


@pytest.mark.parametrize("dtype,N,steps", [
    (torch.float32, 181, 28),    # P = 16290 < 16384
    (torch.float32, 182, 14),    # P = 16471
    (torch.float64, 182, 40),
])
def test_di_score_step_count(monkeypatch, dtype, N, steps):
    calls = []
    _spy(monkeypatch, tdi, calls)
    eye = torch.eye(N, dtype=dtype)
    tdi.di_score(eye, eye, 2)
    assert calls == [steps]


@pytest.mark.parametrize("dtype,shards,steps", [
    (torch.float32, 1, 14),      # 16471 pairs on one shard
    (torch.float32, 4, 28),      # ceil(16471 / 4) = 4118 a shard
    (torch.float64, 4, 40),
])
def test_mesh_di_step_count(monkeypatch, dtype, shards, steps):
    N = 182
    mesh = Mesh([CPU] * shards, (shards, 1))
    calls = []
    _spy(monkeypatch, tsharded.di_kernel, calls)
    mJ = torch.eye(N, dtype=dtype)
    Ls = torch.ones((N, 1, 1), dtype=dtype)
    nloc = -(-N // shards)
    tsharded._di_replicated(mesh, [mJ] * shards, [Ls] * shards, N)
    tsharded._di_local(mesh, [mJ[d * nloc:(d + 1) * nloc]
                              for d in range(shards)], [Ls] * shards, N)
    assert calls and set(calls) == {steps}


def _ill_conditioned(N=6, s=4, seed=0):
    """(mJ [N s, N s] symmetric, C = I): pair p's block J_ij has singular
    values up to sigma_p, so cond(G) = (1 + 4 sigma_max^2) / (1 + 4
    sigma_min^2) runs from 10 to 1e6 over the pairs (L_i = I)."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(N, k=1)
    conds = np.logspace(1, 6, iu.size)
    J = np.zeros((N, s, N, s))
    for i in range(N):
        J[i, :, i, :] = np.eye(s)
    for (i, j), cond in zip(zip(iu, ju), conds):
        smax = np.sqrt((cond - 1) / 4)
        sig = np.concatenate([[smax, 0.0], rng.uniform(0, smax, s - 2)])
        U, _ = np.linalg.qr(rng.standard_normal((s, s)))
        V, _ = np.linalg.qr(rng.standard_normal((s, s)))
        J[i, :, j, :] = U @ np.diag(sig) @ V.T
        J[j, :, i, :] = J[i, :, j, :].T
    return J.reshape(N * s, N * s), np.eye(N * s), iu, ju


def test_f64_di_converges_as_jax_monitored_loop():
    mJ, C, iu, ju = _ill_conditioned()
    N, s = 6, 4
    J4 = mJ.reshape(N, s, N, s)
    eye = np.broadcast_to(np.eye(s), (iu.size, s, s))
    want = np.asarray(jdi._di_tail_gemm(
        jnp.asarray(J4[iu, :, ju, :]), jnp.asarray(eye), jnp.asarray(eye),
        jdi.sqrtm_spd))
    assert want.max() > 3.0          # cond(G) = 1e6 reached
    mJt = torch.as_tensor(mJ)
    S = tdi.di_score(mJt, torch.as_tensor(C), s + 1).numpy()
    np.testing.assert_allclose(S[iu, ju], want, rtol=1e-9, atol=1e-10)
    # the two mesh DI bodies, on 4 shards of the CPU
    mesh = Mesh([CPU] * 4, (2, 2))
    Ls = tdi.site_cholesky(torch.as_tensor(C), s + 1).contiguous()
    nloc = -(-N // 4)
    for S in (tsharded._di_replicated(mesh, [mJt] * 4, [Ls] * 4, N),
              tsharded._di_local(mesh, [mJt[d * nloc * s:(d + 1) * nloc * s]
                                        for d in range(4)], [Ls] * 4, N)):
        np.testing.assert_allclose(S.numpy()[iu, ju], want, rtol=1e-9,
                                   atol=1e-10)


def _synth_q31_tokens():
    """The q=31 alignment behind tests/data/synth_q31.*, built as
    ``tests/test_golden.py::_synth_q31_msa`` builds it: a 20-founder star
    phylogeny, 4 children each, 15% mutations."""
    rng = np.random.default_rng(31)
    N, q = 24, 31
    founders = rng.integers(1, q + 1, size=(20, N), dtype=np.uint8)
    rows = []
    for f in founders:
        for _ in range(4):
            child = f.copy()
            mut = rng.random(N) < 0.15
            child[mut] = rng.integers(1, q + 1, size=mut.sum())
            rows.append(child)
    Z = np.stack(rows)
    Z[0, 0] = q
    return Z


@pytest.mark.parametrize("dtype,tol", [(torch.float64, None),
                                       (torch.float32, {"frob": 5e-5,
                                                        "DI": 1e-4})])
@pytest.mark.parametrize("score,pc,fixture", [
    ("frob", 0.8, "synth_q31.FNRout.txt"),
    ("DI", 0.2, "synth_q31.DIRout.txt"),
])
def test_synthetic_q31_golden(golden_dir, dtype, tol, score, pc, fixture):
    Z = _synth_q31_tokens()
    msa = msa_from_arrays(Z, int(Z.max()), [f"s{i}" for i in range(len(Z))])
    assert msa.q == 31
    res = tapi.gdca_from_msa(msa, GDCAConfig(
        score=score, pseudocount=pc, min_separation=2, dtype=dtype,
        device="cpu"))
    want = {}
    for line in open(os.path.join(golden_dir, fixture)):
        t = line.split()
        want[(int(t[0]), int(t[1]))] = float(t[2])
    got = {(i, j): x for i, j, x in res.ranking}
    assert set(got) == set(want)
    if tol is None:
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=5e-7, abs=1e-9)
    else:
        assert max(abs(got[k] - v) for k, v in want.items()) <= tol[score]
