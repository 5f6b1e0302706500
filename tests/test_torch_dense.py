"""PyTorch port: the dense reweighting path and the last three distance
kernels' plain versions against the JAX package.

- ``match_counts`` (kernel D's plain version on a CPU tensor) against the
  TPU kernel ``match_counts_pallas`` in interpret mode, the jnp
  ``reweight.match_counts`` and the XLA ``match_counts_mxu``, exactly;
- ``row_stats_asym_torch`` (kernel E's covering) against
  ``row_stats_asym_pallas`` in interpret mode, exactly, at the JAX
  kernel's own (tile, k) and at every tiny T the port's covering allows;
- ``row_stats_sym_e8`` (kernel F's plain version on the same planes)
  against ``row_stats_sym_e8_pallas`` in interpret mode, exactly;
- ``compute_weights`` against the JAX ``compute_weights`` in f64 (W, Meff,
  theta at rtol 1e-12), with and without token-0 rows and columns, and
  equal to ``compute_weights_streaming``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.io import fasta as jfasta
from gaussdca_tpu.ops import distance as jdist
from gaussdca_tpu.stats import reweight as jrw
from gaussdca_tpu_torch.ops import distance as tdist
from gaussdca_tpu_torch.stats import reweight as trw

F64 = torch.float64


def _tokens(M, N, q, seed, pad_rows=0):
    """Seeded alignment with near-duplicate families (so neighbour counts
    exceed 1), state q present, and ``pad_rows`` all-token-0 rows."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.uint8)
    for f in range(0, M - 8, 16):
        mut = rng.random((7, N)) < 0.1
        Z[f + 1:f + 8] = np.where(mut, rng.integers(1, q + 1, (7, N)), Z[f])
    Z[0, 0] = q
    if pad_rows:
        Z[rng.choice(np.arange(1, M), pad_rows, replace=False)] = 0
    return Z


def _dense(Z):
    return ((Z[:, None, :] == Z[None, :, :]) & (Z[:, None, :] > 0)).sum(-1)


def _thresh(Z, frac):
    return float(np.float32(np.floor(frac * Z.shape[1])))


# --- kernel D ---------------------------------------------------------------

@pytest.mark.parametrize("M,N,q,pad", [
    (100, 53, 21, 3),     # ragged M, token-0 rows
    (130, 40, 29, 0),     # two 128-row tiles
    (64, 24, 31, 2),
    (33, 19, 21, 0),
])
def test_match_counts_matches_pallas_interpret(M, N, q, pad):
    Z = _tokens(M, N, q, seed=M + N, pad_rows=pad)
    got = tdist.match_counts(torch.as_tensor(Z))
    assert got.dtype == torch.int32 and got.shape == (M, M)
    want = np.asarray(jdist.match_counts_pallas(
        jnp.asarray(Z.astype(np.int8)), q, tile_m=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrw.match_counts(jnp.asarray(Z))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdist.match_counts_mxu(jnp.asarray(Z), q)))


def test_match_counts_chunking_is_invisible():
    Z = torch.as_tensor(_tokens(70, 20, 21, seed=3, pad_rows=2))
    assert torch.equal(tdist.match_counts_torch(Z),
                       tdist.match_counts_torch(Z, row_chunk=16))


# --- kernel E ---------------------------------------------------------------

@pytest.mark.parametrize("q", [21, 29])
@pytest.mark.parametrize("tile,k,M", [
    (128, 2, 256),    # the JAX kernel's own plan (it takes its square kernel)
    (16, 3, 200),     # T = 15 odd, JAX's grouped covering
    (16, 2, 250),     # T = 16 even: the d = T / 2 tie
])
def test_row_stats_asym_plain_matches_pallas_interpret(q, tile, k, M):
    N = 37
    Z = _tokens(M, N, q, seed=q * M + k, pad_rows=4)
    for frac in (0.2, 0.6):
        t = _thresh(Z, frac)
        got = tdist.row_stats_asym_torch(torch.as_tensor(Z), t, k,
                                         tile=tile)
        want = jdist.row_stats_asym_pallas(
            jnp.asarray(Z.astype(np.int8)), jnp.float32(t), q, tile_b=tile,
            k=k, interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # the wrapper (its own plan: 128-row tiles, k = 2) gives the same
        for g, w in zip(tdist.row_stats_asym(torch.as_tensor(Z), t), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M,k,tile", [
    (10, 2, 4),       # T = 4
    (5, 2, 64),       # T = 2: the window wraps (JAX would fall back)
    (129, 3, 16),     # T = 9 odd, ragged
    (256, 4, 8),      # T = 32 even
    (300, 3, 8),      # T = 39
    (64, 2, 64),      # T = 2, one full tile
])
def test_row_stats_asym_covering_is_exact(M, k, tile):
    """Every unordered tile pair once, for any T (the offset is not
    wrapped, so no T needs the square kernel)."""
    N, q = 21, 9
    Z = _tokens(M, N, q, seed=M * k + tile, pad_rows=min(3, M - 1))
    D = _dense(Z)
    for t in (0.0, 4.0, float(N)):
        rs, below = tdist.row_stats_asym_torch(torch.as_tensor(Z), t, k,
                                               tile=tile)
        np.testing.assert_array_equal(rs.numpy(), D.sum(1))
        np.testing.assert_array_equal(below.numpy(), ((N - D) < t).sum(1))


def test_plan_asym():
    """k = 2 (two resident 128-row tiles, one consumer warpgroup each) at
    the main width (N = 384) and up to N = 512, k = 1 (no plan: kernel A)
    above it; a plan holds exactly when the resident words (row stride 4
    mod 32 words) and the ring of B stages fit a block's shared memory."""
    assert tdist.plan_asym(384) == 2
    assert tdist.plan_asym(53) == 2
    assert tdist.plan_asym(512) == 2
    assert tdist.plan_asym(513) == 1
    assert tdist.plan_asym(1000) == 1
    for N in (1, 53, 200, 384, 400, 512, 513, 640, 700, 1000, 4000):
        k = tdist.plan_asym(N)
        W = tdist.pack_tokens(torch.zeros((1, N), dtype=torch.uint8)).shape[1]
        S = tdist._asym_stride(W)
        assert S % 32 == 4 and W <= S < W + 32
        need = (2 * 128 * S * 4 + tdist._ASYM_STAGES * tdist._ASYM_STAGE_BYTES
                + tdist._ASYM_SMEM_FIXED)
        assert k in (1, 2) and (k == 2) == (need <= tdist._SMEM_PER_BLOCK)


def test_row_stats_asym_without_a_plan_takes_row_stats(monkeypatch):
    calls = []
    real = tdist.row_stats

    def spy(*a, **kw):
        calls.append("row_stats")
        return real(*a, **kw)

    monkeypatch.setattr(tdist, "row_stats", spy)
    Z = torch.as_tensor(_tokens(40, 1000, 21, seed=1))
    got = tdist.row_stats_asym(Z, 200.0)
    assert calls == ["row_stats"]
    for g, w in zip(got, real(Z, 200.0)):
        assert torch.equal(g, w)


# --- kernel F ---------------------------------------------------------------

@pytest.mark.parametrize("q", [21, 29])
@pytest.mark.parametrize("M,N", [(200, 37), (77, 19)])
def test_row_stats_e8_plain_matches_pallas_interpret(q, M, N):
    Z = _tokens(M, N, q, seed=M + q, pad_rows=3)
    for frac in (0.0, 0.3):
        t = _thresh(Z, frac)
        got = tdist.row_stats_sym_e8(torch.as_tensor(Z), t, q)
        want = jdist.row_stats_sym_e8_pallas(
            jnp.asarray(Z.astype(np.int8)), jnp.float32(t), q, tile_m=128,
            interpret=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("N,q", [(19, 21), (11, 29), (3, 31)])
def test_one_hot_planes_layout(N, q):
    """Position-major planes as the JAX kernel builds them, K padded to a
    multiple of 64 with zeros, token 0 an all-zero segment."""
    Z = _tokens(30, N, q, seed=N, pad_rows=2)
    E8 = tdist.one_hot_planes(torch.as_tensor(Z), q)
    K = N * q
    assert E8.dtype == torch.int8 and E8.shape == (30, -(-K // 64) * 64)
    want = (Z.astype(np.int32)[:, :, None] == np.arange(1, q + 1)).astype(
        np.int8).reshape(30, K)
    np.testing.assert_array_equal(E8[:, :K].numpy(), want)
    assert not E8[:, K:].any()
    np.testing.assert_array_equal(
        (E8.float() @ E8.float().T).numpy(), _dense(Z))


# --- the dense weight path --------------------------------------------------

def _golden_tokens(golden_dir, name):
    msa = jfasta.read_fasta_alignment(
        os.path.join(golden_dir, name), 0.9, use_native=False)
    return msa.tokens, msa.q


@pytest.mark.parametrize("name", ["small.fasta.gz", "large.fasta.gz"])
@pytest.mark.parametrize("theta", [0.2, "auto"])
@pytest.mark.parametrize("pad", [(0, 0), (22, 11)])
def test_compute_weights_matches_jax(golden_dir, name, theta, pad):
    """W, Meff and theta of the dense path in f64, on the alignment as it
    is and with token-0 rows and columns appended (rows that match
    nothing, columns that shift every hamming distance)."""
    Z, q = _golden_tokens(golden_dir, name)
    Z = np.pad(Z, ((0, pad[0]), (0, pad[1])))
    W0, Meff0, th0 = jrw.compute_weights(jnp.asarray(Z), theta,
                                         dtype=jnp.float64, q=q)
    W1, Meff1, th1 = trw.compute_weights(torch.as_tensor(Z), theta,
                                         dtype=F64, q=q)
    np.testing.assert_allclose(W1.numpy(), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)
    # the streaming path gives the same weights
    W2, Meff2, th2 = trw.compute_weights_streaming(
        torch.as_tensor(Z), theta, q, dtype=F64)
    assert torch.equal(W1, W2) and float(Meff1) == float(Meff2)
    assert float(th1) == float(th2)


def test_pairwise_auto_theta_matches_jax_and_closed_form(golden_dir):
    """The JAX package's pairwise auto-theta over the port's count matrix
    equals the port's closed form, which the dense path resolves theta
    with."""
    Z, q = _golden_tokens(golden_dir, "small.fasta.gz")
    N = Z.shape[1]
    D = tdist.match_counts(torch.as_tensor(Z)).numpy()
    pairwise = jrw.auto_theta(jnp.asarray(D), N)
    np.testing.assert_allclose(
        float(pairwise),
        float(jrw.auto_theta(jrw.match_counts(jnp.asarray(Z)), N)),
        rtol=1e-13)
    np.testing.assert_allclose(
        float(trw.auto_theta_closed_form(torch.as_tensor(Z), q)),
        float(pairwise), rtol=1e-13)


@pytest.mark.parametrize("theta", [0.0, 0.3, 1.0])
def test_weights_from_matches_matches_jax(theta):
    Z = _tokens(90, 26, 21, seed=8, pad_rows=2)
    D = _dense(Z).astype(np.int32)
    W0, Meff0 = jrw.weights_from_matches(jnp.asarray(D), 26, theta,
                                         jnp.float64)
    W1, Meff1 = trw.weights_from_matches(torch.as_tensor(D), 26, theta,
                                         F64, row_chunk=32)
    np.testing.assert_array_equal(W1.numpy(), np.asarray(W0))
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-13)


@pytest.mark.parametrize("q", [9, 21])
@pytest.mark.parametrize("M,N", [(130, 40), (77, 19)])
def test_match_counts_tokens_above_q_match_nothing(q, M, N):
    """``match_counts(Z, q)`` equals the TPU kernel run in interpret mode
    with the same q, on tokens 1..31: a token above q matches nothing.
    The default q = 31 counts every token."""
    Z = _tokens(M, N, 31, seed=M + q, pad_rows=3)
    got = tdist.match_counts(torch.as_tensor(Z), q)
    want = np.asarray(jdist.match_counts_pallas(
        jnp.asarray(Z.astype(np.int8)), q, tile_m=128, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tdist.match_counts(torch.as_tensor(Z)).numpy() >= want).all()
    assert int(tdist.match_counts(torch.as_tensor(Z)).sum()) > int(want.sum())


@pytest.mark.parametrize("theta", [0.2, "auto"])
def test_compute_weights_counts_states_up_to_q(theta):
    """The dense ``compute_weights(..., q=q)`` hands q to its default
    ``match_counts``: on tokens 1..31, W, Meff and theta equal the JAX
    dense weights on the TPU kernel (interpret mode) with the same q."""
    q = 9
    Z = _tokens(90, 23, 31, seed=5, pad_rows=2)
    W0, Meff0, th0 = jrw.compute_weights(
        jnp.asarray(Z.astype(np.int8)), theta, dtype=jnp.float64, q=q,
        match_counts_fn=lambda z: jdist.match_counts_pallas(
            z, q, tile_m=128, interpret=True))
    W1, Meff1, th1 = trw.compute_weights(torch.as_tensor(Z), theta,
                                         dtype=F64, q=q)
    np.testing.assert_allclose(W1.numpy(), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)
