"""PyTorch port: reweighting, frequencies, covariance and solve vs JAX (f64).

Each stage gets the same inputs as its JAX counterpart: W, Meff and theta
against ``compute_weights_streaming`` (driven by the jnp row-stats twin),
Pi, Pij and C against ``weighted_frequencies`` / ``add_pseudocount`` /
``compute_C`` (one-shot and chunked), mJ against ``spd_inverse``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.io import fasta as jfasta
from gaussdca_tpu.ops.distance import row_stats_rect_jnp
from gaussdca_tpu.solve.cholesky import spd_inverse as j_spd_inverse
from gaussdca_tpu.stats import frequencies as jfreq
from gaussdca_tpu.stats import pseudocount as jpc
from gaussdca_tpu.stats import reweight as jrw
from gaussdca_tpu_torch.solve.cholesky import spd_inverse
from gaussdca_tpu_torch.stats import frequencies as tfreq
from gaussdca_tpu_torch.stats import pseudocount as tpc
from gaussdca_tpu_torch.stats import reweight as trw

F64 = torch.float64


def _jax_row_stats(Z, t, q):
    return row_stats_rect_jnp(Z, Z, t, q)


def _small_tokens(golden_dir):
    msa = jfasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9, use_native=False)
    return msa.tokens, msa.q


def _synthetic_tokens(seed=2, M=150, N=30, q=21):
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.uint8)
    Z[1:40] = np.where(rng.random((39, N)) < 0.15,
                       rng.integers(1, q + 1, (39, N)), Z[0])
    return Z, q


@pytest.mark.parametrize("source", ["small", "synthetic"])
@pytest.mark.parametrize("theta", [0.0, 0.2, "auto"])
def test_weights_match_jax(golden_dir, source, theta):
    Z, q = (_small_tokens(golden_dir) if source == "small"
            else _synthetic_tokens())
    W0, Meff0, th0 = jrw.compute_weights_streaming(
        jnp.asarray(Z), theta, q, _jax_row_stats, dtype=jnp.float64)
    W1, Meff1, th1 = trw.compute_weights_streaming(
        torch.as_tensor(Z), theta, q, dtype=F64)
    np.testing.assert_allclose(W1.numpy(), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


@pytest.mark.parametrize("q", [2, 21, 31])
def test_total_matches_closed_form_exact(q):
    rng = np.random.default_rng(q)
    Z = rng.integers(0, q + 1, size=(57, 13), dtype=np.uint8)
    want = float(jrw.total_matches_closed_form(jnp.asarray(Z), q))
    assert trw.total_matches_closed_form(torch.as_tensor(Z), q) == want


def test_frequency_chunk_rule():
    # the rule of gaussdca_tpu.api (one shot up to 1 GiB of one-hot)
    assert tfreq.frequency_chunk(5000, 200, 21, torch.float32) == 0
    assert tfreq.frequency_chunk(100000, 200, 21, torch.float32) == 67108
    assert tfreq.frequency_chunk(10 ** 6, 2000, 21, torch.float64) == 3355
    assert tfreq.frequency_chunk(10 ** 6, 20000, 21, torch.float64) == 335
    assert tfreq.frequency_chunk(10 ** 6, 200000, 21, torch.float64) == 256


@pytest.mark.parametrize("m_chunk", [0, 32])
def test_frequencies_and_covariance_match_jax(golden_dir, m_chunk):
    Z, q = _small_tokens(golden_dir)
    rng = np.random.default_rng(0)
    W = rng.uniform(0.2, 1.0, size=Z.shape[0])
    pc = 0.8
    Pi0, Pij0, Meff0 = jfreq.weighted_frequencies(
        jnp.asarray(Z), jnp.asarray(W), q, dtype=jnp.float64, m_chunk=m_chunk)
    Pi0, Pij0 = jpc.add_pseudocount(Pi0, Pij0, pc, q)
    C0 = jpc.compute_C(Pi0, Pij0)

    Pi1, Pij1, Meff1 = tfreq.weighted_frequencies(
        torch.as_tensor(Z), torch.as_tensor(W), q, dtype=F64,
        m_chunk=m_chunk)
    Pi1, Pij1 = tpc.add_pseudocount(Pi1, Pij1, pc, q)
    C1 = tpc.compute_C(Pi1, Pij1)

    tol = dict(rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(Pi1.numpy(), np.asarray(Pi0), **tol)
    np.testing.assert_allclose(Pij1.numpy(), np.asarray(Pij0), **tol)
    np.testing.assert_allclose(C1.numpy(), np.asarray(C0), **tol)


def test_spd_inverse_matches_jax(golden_dir):
    Z, q = _small_tokens(golden_dir)
    W = np.ones(Z.shape[0])
    Pi, Pij, _ = tfreq.weighted_frequencies(
        torch.as_tensor(Z), torch.as_tensor(W), q, dtype=F64)
    C = tpc.compute_C(*tpc.add_pseudocount(Pi, Pij, 0.2, q))
    want = np.asarray(j_spd_inverse(jnp.asarray(C.numpy())))
    got = spd_inverse(C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_spd_inverse_is_row_major(dtype):
    """The inverse comes back row-major and exactly symmetric, so a row
    slab of it (the DI kernel's and the mesh's input) is a view."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((60, 60))
    C = torch.as_tensor(A @ A.T / 60 + 0.5 * np.eye(60), dtype=dtype)
    X = spd_inverse(C)
    assert X.is_contiguous() and X[20:40].is_contiguous()
    assert torch.equal(X, X.T)
    want = torch.cholesky_inverse(torch.linalg.cholesky(C.double()))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(X.double().numpy(), want.numpy(), rtol=0,
                               atol=tol * float(want.abs().max()))


def test_spd_inverse_f32_newton_step():
    """f32: Cholesky inverse plus one Newton step leaves a residual near
    the f32 floor on a moderately conditioned SPD matrix."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((200, 200))
    C = torch.as_tensor(A @ A.T / 200 + 0.05 * np.eye(200), dtype=torch.float32)
    X = spd_inverse(C)
    assert X.dtype == torch.float32
    R = torch.eye(200, dtype=F64) - C.double() @ X.double()
    assert float(R.abs().max()) < 1e-4


def test_spd_inverse_raises_on_indefinite():
    C = torch.eye(4, dtype=F64)
    C[3, 3] = -1.0
    with pytest.raises(ArithmeticError, match="positive definite"):
        spd_inverse(C)
