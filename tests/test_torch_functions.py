"""PyTorch port: the JAX package's small public functions, each held
against its JAX counterpart on the same seeded-numpy input (CPU).

- ``score.rank.top_k_ranking``: equal to JAX's on scores without ties
  (and to the head of ``compute_ranking``), the same (i, j, score)
  multiset with ties, and JAX's behaviour for ``k`` beyond the pair count
  and ``min_separation > N``;
- ``io.fasta.tokens_from_sequences``: the same tokens, headers and q;
- ``stats.reweight.match_counts``, ``mean_fraction_identity`` and
  ``auto_theta``: the counts and theta exactly equal to JAX's, and theta
  exactly equal to the closed form's, in f64;
- ``solve.cholesky.newton_refine`` within 1e-12 of JAX's in f64;
  the blocked in-place inverse (``_spd_inverse_blocked``) at a block of
  8, over one block, ragged blocks and several, exactly symmetric,
  row-major and within its dtype's rounding envelope of inv(C); and
  ``spd_inverse`` in f32 on the small golden family's covariance no less
  accurate than the solve it replaced (LAPACK's / cuSOLVER's Cholesky
  inverse plus one Newton step).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.io import fasta as jfasta
from gaussdca_tpu.score import rank as jrank
from gaussdca_tpu.solve import cholesky as jchol
from gaussdca_tpu.stats import reweight as jrw
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.score import rank
from gaussdca_tpu_torch.solve import cholesky
from gaussdca_tpu_torch.stats import frequencies, pseudocount, reweight


# --- score/rank.py::top_k_ranking -------------------------------------------

@pytest.mark.parametrize("N,m,k", [(30, 5, 40), (12, 3, 1000), (20, 1, 190),
                                   (25, 4, 1), (8, 9, 5), (8, 8, 3),
                                   (7, 6, 5), (16, 2, 0)])
def test_top_k_ranking_matches_jax(N, m, k):
    """No ties: the same list as JAX's and as the full ranking's head;
    k beyond the pair count gives every pair, min_separation >= N none."""
    rng = np.random.default_rng(N * 100 + m * 10 + k)
    S = rng.random((N, N))
    got = rank.top_k_ranking(S, m, k)
    assert got == jrank.top_k_ranking(S, m, k)
    npairs = max(0, N - m) * max(0, N - m + 1) // 2
    assert len(got) == min(k, npairs)
    assert got == rank.compute_ranking(S, m)[:len(got)]


@pytest.mark.parametrize("k", [1, 7, 20, 66])
def test_top_k_ranking_with_ties_matches_jax(k):
    """Scores on a coarse grid, so every k cuts through a run of ties:
    the same (i, j, score) multiset as JAX's, in descending score."""
    rng = np.random.default_rng(k)
    S = rng.integers(0, 4, size=(14, 14)).astype(np.float64)
    got = rank.top_k_ranking(S, 3, k)
    want = jrank.top_k_ranking(S, 3, k)
    assert sorted(got) == sorted(want)
    assert [x for *_, x in got] == [x for *_, x in want]
    assert all(a[2] >= b[2] for a, b in zip(got, got[1:]))


# --- io/fasta.py::tokens_from_sequences -------------------------------------

@pytest.mark.parametrize("letters", ["ACDEFGHIKLMNPQRSTVWY-",
                                     "ACDEFGHIKLMNPQRSTVWY-BJOUXZ.a",
                                     "ACDE"])
def test_tokens_from_sequences_matches_jax(letters):
    rng = np.random.default_rng(len(letters))
    seqs = ["".join(rng.choice(list(letters), size=23)) for _ in range(9)]
    got = fasta.tokens_from_sequences(seqs)
    want = jfasta.tokens_from_sequences(seqs)
    assert got.tokens.dtype == want.tokens.dtype
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.headers == want.headers
    assert got.q == want.q and got.M == 9 and got.N == 23


# --- stats/reweight.py: the pairwise auto-theta -----------------------------

def _pairwise_thetas(Z, q):
    """(port pairwise theta at q, port closed form at q, the port's counts)
    for tokens Z."""
    Zt = torch.as_tensor(Z)
    D = reweight.match_counts(Zt, q)
    return (reweight.auto_theta(D, Z.shape[1]),
            reweight.auto_theta_closed_form(Zt, q), D)


def test_pairwise_auto_theta_on_the_small_golden(golden_dir):
    """The small golden alignment (q = 21): the port's pairwise theta,
    its closed form and JAX's pairwise theta are one f64 number; the
    counts are JAX's."""
    msa = fasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9)
    Z = msa.tokens
    th_pair, th_closed, D = _pairwise_thetas(Z, msa.q)
    Dj = jrw.match_counts(jnp.asarray(Z))
    np.testing.assert_array_equal(D.numpy(), np.asarray(Dj))
    th_jax = float(jrw.auto_theta(Dj, Z.shape[1]))
    assert th_pair.dtype == torch.float64
    assert float(th_pair) == float(th_closed) == th_jax
    mfi = reweight.mean_fraction_identity(D, Z.shape[1])
    assert float(mfi) == float(jrw.mean_fraction_identity(Dj, Z.shape[1]))


def test_pairwise_auto_theta_with_tokens_above_q():
    """Tokens 0..31 (0 matches nothing): at q = 21 the pairwise counts
    leave tokens above 21 out, as the closed form does (the same theta);
    at q = 31 the counts, theta and mean identity are JAX's pairwise
    ones, which count every token above 0, and the closed form's."""
    rng = np.random.default_rng(31)
    Z = rng.integers(0, 32, size=(90, 37), dtype=np.uint8)
    Z[:30] = Z[rng.integers(0, 30, size=30)]     # some identical rows
    th21, closed21, D21 = _pairwise_thetas(Z, 21)
    assert float(th21) == float(closed21)
    th31, closed31, D31 = _pairwise_thetas(Z, 31)
    Dj = jrw.match_counts(jnp.asarray(Z))
    np.testing.assert_array_equal(D31.numpy(), np.asarray(Dj))
    assert (D21 <= D31).all() and (D21 < D31).any()
    assert float(th31) == float(closed31) == float(jrw.auto_theta(Dj, 37))
    assert float(reweight.mean_fraction_identity(D31, 37)) == float(
        jrw.mean_fraction_identity(Dj, 37))


# --- solve/cholesky.py::newton_refine and spd_inverse -----------------------

def _spd(n, seed, cond=1e4):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    C = (Q * np.geomspace(1.0, 1.0 / cond, n)) @ Q.T
    return (C + C.T) / 2


@pytest.mark.parametrize("iters", [0, 1, 2, 3])
def test_newton_refine_matches_jax(iters):
    """f64, from an f32 inverse: within 1e-12 (relative to the largest
    entry) of JAX's ``newton_refine``, symmetric, and the residual no
    larger than before."""
    C = _spd(60, 5)
    X0 = np.linalg.inv(C.astype(np.float32)).astype(np.float64)
    got = cholesky.newton_refine(torch.as_tensor(C), torch.as_tensor(X0),
                                 iters).numpy()
    want = np.asarray(jchol.newton_refine(jnp.asarray(C), jnp.asarray(X0),
                                          iters))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    if iters:
        np.testing.assert_array_equal(got, got.T)
    res = [np.abs(np.eye(60) - C @ X).max() for X in (X0, got)]
    assert res[1] <= res[0]


def _parent_spd_inverse(C, refine_iters=None):
    # spd_inverse as it was before the blocked in-place inverse: LAPACK's
    # (cuSOLVER's) Cholesky inverse, one Newton step in f32
    L, info = torch.linalg.cholesky_ex(C)
    assert int(info) == 0
    X = torch.cholesky_inverse(L)
    if refine_iters is None:
        refine_iters = 1 if C.dtype == torch.float32 else 0
    for _ in range(refine_iters):
        R = -(C @ X)
        R.diagonal().add_(1.0)
        X = X + X @ R
    S = (X + X.T) * 0.5
    return S if S.is_contiguous() else S.T.contiguous()


def _rel_err(X, ref):
    return float((X.double() - ref).abs().max() / ref.abs().max())


BLOCK = 8


@pytest.mark.parametrize("cond", [1e2, 1e5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, BLOCK - 1, BLOCK, BLOCK + 1,
                               3 * BLOCK + 5])
def test_spd_inverse_blocked_within_the_rounding_envelope(n, dtype, cond):
    """One block (n <= 8), a ragged second block and four blocks: inv(C)
    exactly symmetric, row-major, and within u cond(C) of the f64
    inverse of the same C (u the dtype's unit roundoff; the bound of a
    backward-stable Cholesky inverse, which it meets with >= 3x room
    over 60 seeds)."""
    C = torch.as_tensor(_spd(n, 7 + n, cond=cond), dtype=dtype)
    X = cholesky._spd_inverse_blocked(C, BLOCK)
    assert X.dtype == dtype and X.shape == (n, n)
    assert X.is_contiguous() and torch.equal(X, X.T)
    C64 = C.double()
    ref = torch.linalg.inv(C64)
    u = torch.finfo(dtype).eps / 2
    assert _rel_err(X, ref) <= u * float(torch.linalg.cond(C64))


def _small_covariance(golden_dir, pc, dtype):
    msa = fasta.remove_duplicate_sequences(fasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9))
    Z = torch.as_tensor(msa.tokens)
    W, _, _ = reweight.compute_weights_streaming(Z, "auto", msa.q,
                                                 dtype=dtype)
    Pi, Pij, _ = frequencies.weighted_frequencies(Z, W, msa.q, dtype=dtype)
    return pseudocount.compute_C(*pseudocount.add_pseudocount(
        Pi, Pij, pc, msa.q))


@pytest.mark.parametrize("pc", [0.2, 0.8])
def test_spd_inverse_f32_no_worse_than_the_solve_it_replaced(golden_dir,
                                                             pc):
    """f32, the small golden family's covariance (Ns = 1060, two blocks;
    DI's pseudocount and the default): ``spd_inverse`` is no further from
    inv(C64), the inverse of the f64 covariance, nor from inv(C32), the
    f64 inverse of the f32 covariance, than the solve it replaced, the
    Cholesky inverse with one Newton step."""
    C32 = _small_covariance(golden_dir, pc, torch.float32)
    assert C32.shape[0] > cholesky.BLOCK
    X = cholesky.spd_inverse(C32)
    old = _parent_spd_inverse(C32, 1)
    for ref in (torch.linalg.inv(_small_covariance(golden_dir, pc,
                                                   torch.float64)),
                torch.linalg.inv(C32.double())):
        assert _rel_err(X, ref) <= _rel_err(old, ref)


@pytest.mark.parametrize("n,block,pivot", [(3 * BLOCK + 5, BLOCK, 20),
                                           (3 * BLOCK + 5, BLOCK, 28),
                                           (1100, cholesky.BLOCK, 1050)])
def test_spd_inverse_raises_on_a_pivot_in_a_later_block(n, block, pivot):
    """A C whose failing pivot lies in a later block (the last row of the
    ragged last block too) raises the package's error."""
    C = torch.as_tensor(_spd(n, 3, cond=1e2))
    C[pivot, pivot] = -1.0
    with pytest.raises(ArithmeticError, match="positive definite"):
        cholesky._spd_inverse_blocked(C, block)
