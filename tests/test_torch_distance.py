"""PyTorch port: all-pairs row statistics vs the JAX package (exact).

The port's ``row_stats`` (on a CPU tensor, its plain version) must equal
the TPU kernel ``row_stats_sym_pallas`` run in interpret mode and the
dense ``reweight.match_counts`` reduction exactly: the statistics are
integer counts. The CUDA kernel's fragment construction (a bytewise
compare of packed token words per state, then an int8 product) is
emulated in numpy and held against both.
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
    rs, below = tdist.row_stats(torch.as_tensor(Z), thresh, q)

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


def _equal80(w, cc):
    """Kernel A's fragment byte test: 0x80 in each byte of w equal to that
    byte of cc (every byte below 0x80), else 0."""
    return ~((w ^ cc) + np.uint32(0x7F7F7F7F)) & np.uint32(0x80808080)


def test_fragment_byte_test_is_exact():
    """Every pair of bytes below 0x80, in every byte position of a word,
    next to bytes that differ and bytes that agree."""
    a, b = np.meshgrid(np.arange(128, dtype=np.uint32),
                       np.arange(128, dtype=np.uint32))
    a, b = a.ravel(), b.ravel()
    rng = np.random.default_rng(0)
    for pos in range(4):
        other = rng.integers(0, 128, size=(a.size, 4), dtype=np.uint32)
        wa = other.copy()
        wb = other.copy()
        wb[:, (pos + 1) % 4] = rng.integers(0, 128, a.size, dtype=np.uint32)
        wa[:, pos], wb[:, pos] = a, b
        pack = lambda x: (x[:, 0] | x[:, 1] << 8 | x[:, 2] << 16
                          | x[:, 3] << 24).astype(np.uint32)
        got = _equal80(pack(wa), pack(wb))
        for k in range(4):
            byte = (got >> np.uint32(8 * k)) & np.uint32(0xFF)
            np.testing.assert_array_equal(
                byte, np.where(wa[:, k] == wb[:, k], 0x80, 0))


def _row_stats_by_fragments(Z, thresh, q):
    """Kernel A's arithmetic in numpy: tokens above q zeroed and packed
    (``pack_tokens``), then for each 32-column chunk (8 words) and state
    c = 1..q the fragments ``_equal80(word, c * 0x01010101)`` read as s8
    bytes, multiplied in int64 ((-128)^2 = 2^14 a match) and summed."""
    Zt = torch.as_tensor(Z)
    words = tdist.pack_tokens(torch.where(Zt <= q, Zt, 0)).numpy().view(
        np.uint32)
    M, W = words.shape
    assert W % 8 == 0
    acc = np.zeros((M, M), np.int64)
    for w0 in range(0, W, 8):
        chunk = words[:, w0:w0 + 8]
        for c in range(1, q + 1):
            frag = _equal80(chunk, np.uint32(0x01010101 * c))
            E = frag.view(np.int8).reshape(M, 32).astype(np.int64)
            acc += E @ E.T
    assert (acc % (1 << 14) == 0).all()
    D = acc >> 14
    N = Z.shape[1]
    return (D.sum(1).astype(np.float32),
            ((N - D).astype(np.float32) < np.float32(thresh)).sum(1)
            .astype(np.float32))


@pytest.mark.parametrize("M,N,q,theta", [
    (70, 45, 9, 0.2),         # N not a multiple of 32
    (66, 61, 21, "auto"),
    (50, 96, 31, 0.0),
    (41, 20, 21, 0.3),
])
def test_row_stats_fragment_emulation(M, N, q, theta):
    """The fragment construction gives the plain version's and the JAX
    twin's rowsum and below exactly, with token-0 rows, token-0 columns
    and tokens above q (which match nothing)."""
    Z = _tokens(M, N, q, seed=M + N + q, pad_rows=3)
    Z[:, 0] = 0
    Z[5, 3:7] = 31 if q < 31 else 0      # above q for q < 31
    Z[6, 3:7] = Z[5, 3:7]
    thresh = _threshold(Z, q, theta)
    rs, below = _row_stats_by_fragments(Z, thresh, q)
    t_rs, t_below = tdist.row_stats_torch(torch.as_tensor(Z), thresh, q)
    np.testing.assert_array_equal(rs, t_rs.numpy())
    np.testing.assert_array_equal(below, t_below.numpy())
    Zq = np.where(Z <= q, Z, 0).astype(np.int8)
    j_rs, j_below = jdist.row_stats_rect_jnp(
        jnp.asarray(Zq), jnp.asarray(Zq), jnp.float32(thresh), q)
    np.testing.assert_array_equal(rs, np.asarray(j_rs))
    np.testing.assert_array_equal(below, np.asarray(j_below))


@pytest.mark.parametrize("q", [9, 21])
def test_row_stats_tokens_above_q_match_nothing(q):
    """``row_stats(Z, t, q)`` on the CPU equals the TPU kernel run in
    interpret mode with the same q, where tokens above q occur; with
    q = 31 (every state) it counts them."""
    Z = _tokens(100, 37, 31, seed=q, pad_rows=2)
    thresh = _threshold(Z, 31, 0.25)
    rs, below = tdist.row_stats(torch.as_tensor(Z), thresh, q)
    rs_p, below_p = jdist.row_stats_sym_pallas(
        jnp.asarray(Z.astype(np.int8)), jnp.float32(thresh), q,
        tile_m=128, interpret=True)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_p))
    np.testing.assert_array_equal(below.numpy(), np.asarray(below_p))
    every = tdist.row_stats(torch.as_tensor(Z), thresh, 31)
    assert float(every[0].sum()) > float(rs.sum())
    with pytest.raises(ValueError, match="q must be"):
        tdist.row_stats(torch.as_tensor(Z), thresh, 32)


@pytest.mark.parametrize("theta", [0.0, 0.2, 0.35])
def test_streaming_weights_count_states_up_to_q(theta):
    """``compute_weights_streaming`` hands its own q to the default
    ``row_stats``: with tokens above q in the alignment, W, Meff and theta
    equal the JAX function's on the TPU kernel (interpret mode) with the
    same q. (A fixed theta: the auto-theta closed form takes tokens up to
    q only.)"""
    q = 9
    Z = _tokens(120, 29, 31, seed=7, pad_rows=2)

    def jax_rows(Zj, t, qj):
        return jdist.row_stats_sym_pallas(Zj, t, qj, tile_m=128,
                                          interpret=True)

    W0, Meff0, th0 = jrw.compute_weights_streaming(
        jnp.asarray(Z.astype(np.int8)), theta, q, jax_rows,
        dtype=jnp.float64)
    W1, Meff1, th1 = trw.compute_weights_streaming(
        torch.as_tensor(Z), theta, q, dtype=torch.float64)
    np.testing.assert_allclose(W1.numpy(), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


@pytest.mark.parametrize("fn", ["row_stats", "row_stats_asym",
                                "row_stats_full", "row_stats_sym_e8"])
def test_every_row_stats_fn_gets_q(fn):
    """Every distance kernel passed as ``row_stats_fn`` is called as
    ``fn(Z, thresh, q)``, the JAX contract: on an alignment of q = 29
    states, W, Meff and theta equal the JAX function's on the TPU kernel
    (interpret mode) with the same q, states 22..29 included."""
    q = 29
    Z = _tokens(110, 26, q, seed=29, pad_rows=2)

    def jax_rows(Zj, t, qj):
        return jdist.row_stats_sym_pallas(Zj, t, qj, tile_m=128,
                                          interpret=True)

    W0, Meff0, th0 = jrw.compute_weights_streaming(
        jnp.asarray(Z.astype(np.int8)), "auto", q, jax_rows,
        dtype=jnp.float64)
    W1, Meff1, th1 = trw.compute_weights_streaming(
        torch.as_tensor(Z), "auto", q, dtype=torch.float64,
        row_stats_fn=getattr(tdist, fn))
    np.testing.assert_allclose(W1.numpy(), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)
