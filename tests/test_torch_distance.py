"""PyTorch port: all-pairs row statistics vs the JAX package (exact).

The port's ``row_stats`` (on a CPU tensor, its plain version) must equal
the TPU kernel ``row_stats_sym_pallas`` run in interpret mode and the
dense ``reweight.match_counts`` reduction exactly: the statistics are
integer counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.ops import distance as jdist
from gaussdca_tpu.stats import reweight as jrw
from gaussdca_tpu_torch.ops import distance as tdist
from gaussdca_tpu_torch.stats import reweight as trw


def _tokens(M, N, q, seed, pad_rows=0):
    """Seeded alignment with near-duplicate families (so neighbour counts
    exceed 1) and ``pad_rows`` all-token-0 rows."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.uint8)
    for f in range(0, M - 8, 16):
        mut = rng.random((7, N)) < 0.1
        Z[f + 1:f + 8] = np.where(mut, rng.integers(1, q + 1, (7, N)), Z[f])
    if pad_rows:
        Z[rng.choice(M, pad_rows, replace=False)] = 0
    return Z


def _threshold(Z, q, theta):
    N = Z.shape[1]
    if theta == "auto":
        theta = float(trw.auto_theta_closed_form(torch.as_tensor(Z), q))
    return float(np.float32(np.floor(theta * N)))


@pytest.mark.parametrize("M,N,q,pad,theta", [
    (130, 53, 21, 0, 0.2),      # M not a multiple of the 128-row tile
    (150, 40, 21, 6, "auto"),   # token-0 padding rows
    (100, 30, 2, 0, 0.2),
    (140, 24, 31, 3, 0.0),
    (129, 33, 31, 0, "auto"),
    (90, 61, 21, 2, 0.2),
])
def test_row_stats_matches_jax(M, N, q, pad, theta):
    Z = _tokens(M, N, q, seed=M * 7 + N, pad_rows=pad)
    thresh = _threshold(Z, q, theta)
    rs, below = tdist.row_stats(torch.as_tensor(Z), thresh)

    rs_p, below_p = jdist.row_stats_sym_pallas(
        jnp.asarray(Z.astype(np.int8)), jnp.float32(thresh), q,
        tile_m=128, interpret=True)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_p))
    np.testing.assert_array_equal(below.numpy(), np.asarray(below_p))

    D = np.asarray(jrw.match_counts(jnp.asarray(Z)))
    np.testing.assert_array_equal(rs.numpy(), D.sum(1).astype(np.float32))
    np.testing.assert_array_equal(
        below.numpy(), ((N - D) < thresh).sum(1).astype(np.float32))
    if pad:
        padded = Z.max(axis=1) == 0
        assert (rs.numpy()[padded] == 0).all()
        assert (below.numpy()[padded] == 0).all()


def test_row_stats_chunking_is_invisible():
    """The plain version's row chunks must not change any count."""
    Z = torch.as_tensor(_tokens(70, 20, 21, seed=3, pad_rows=2))
    whole = tdist.row_stats_torch(Z, 6.0)
    chunked = tdist.row_stats_torch(Z, 6.0, row_chunk=16)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_row_stats_accepts_int8_tokens():
    Z = _tokens(40, 12, 21, seed=5)
    a = tdist.row_stats(torch.as_tensor(Z), 3.0)
    b = tdist.row_stats(torch.as_tensor(Z.astype(np.int8)), 3.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="token matrix"):
        tdist.row_stats(torch.as_tensor(Z.astype(np.int32)), 3.0)
