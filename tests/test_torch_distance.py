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


def _counts_by_fragments(ZA, ZB, q):
    """The tensor-core tile's arithmetic (``onehot_wgmma.cuh``) in numpy:
    tokens packed with those above q zeroed (``pack_tokens(Z, q)``), then
    for each 32-column chunk (8 words) and state c = 1..q the fragments
    ``_equal80(word, c * 0x01010101)`` of A's and B's rows read as s8
    bytes, multiplied in int64 ((-128)^2 = 2^14 a match) and summed;
    returns the [Ma, Mb] match counts."""
    wa, wb = (tdist.pack_tokens(torch.as_tensor(Z), q).numpy().view(
        np.uint32) for Z in (ZA, ZB))
    W = wa.shape[1]
    assert W % 8 == 0 and wb.shape[1] == W
    acc = np.zeros((wa.shape[0], wb.shape[0]), np.int64)
    for w0 in range(0, W, 8):
        for c in range(1, q + 1):
            ea, eb = (_equal80(w[:, w0:w0 + 8], np.uint32(0x01010101 * c))
                      .view(np.int8).reshape(-1, 32).astype(np.int64)
                      for w in (wa, wb))
            acc += ea @ eb.T
    assert (acc % (1 << 14) == 0).all()
    return acc >> 14


def _row_stats_by_fragments(Z, thresh, q):
    """Kernel A's arithmetic in numpy: ``_counts_by_fragments(Z, Z, q)``,
    then the row sums and the strict f32 neighbour test."""
    D = _counts_by_fragments(Z, Z, q)
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


def _epilogue_layout():
    """(r, c) [256, 64]: the tile row and column of accumulator i of
    thread t in ``count_tile``'s layout: d[4 j + e] is row 16 warp + g +
    8 (e / 2), column 8 j + 2 q4 + (e % 2)."""
    t, i = np.meshgrid(np.arange(256), np.arange(64), indexing="ij")
    warp, g, q4 = t // 32, (t % 32) // 4, t % 4
    j, e = i // 4, i % 4
    return 16 * warp + g + 8 * (e // 2), 8 * j + 2 * q4 + e % 2


def test_epilogue_layout_covers_the_tile_once():
    r, c = _epilogue_layout()
    hits = np.zeros((128, 128), np.int64)
    np.add.at(hits, (r, c), 1)
    assert (hits == 1).all()


def _tile_of(Z, t0, M):
    """Rows t0 .. t0 + 127 of Z, rows past M read as token 0."""
    out = np.zeros((128, Z.shape[1]), Z.dtype)
    out[:max(0, min(128, M - t0))] = Z[t0:t0 + 128]
    return out


@pytest.mark.parametrize("Ma,Mb,N,q", [
    (45, 300, 37, 9),      # one A tile, ragged B tiles
    (130, 70, 61, 21),     # Mb < 128: the B tile is mostly padding
    (257, 129, 20, 31),
])
def test_rect_fragment_emulation(Ma, Mb, N, q):
    """Kernel C's arithmetic in numpy on different A and B with tokens
    1..31: its flat grid (tile t -> A tile t % Ta, B tile t / Ta), the
    fragment product of each tile, columns past Mb masked, row sums over
    the layout of ``count_tile``; equal to the plain version and to the
    JAX kernel in interpret mode with the same q."""
    ZA = _tokens(Ma, N, 31, seed=Ma + q, pad_rows=2)
    ZB = _tokens(Mb, N, 31, seed=Mb + q, pad_rows=3)
    thresh = _threshold(ZB, 31, 0.3)
    r, c = _epilogue_layout()
    Ta, Tb = -(-Ma // 128), -(-Mb // 128)
    rs = np.zeros(Ma, np.int64)
    below = np.zeros(Ma, np.int64)
    for t in range(Ta * Tb):
        a0, b0 = (t % Ta) * 128, (t // Ta) * 128
        D = _counts_by_fragments(_tile_of(ZA, a0, Ma), _tile_of(ZB, b0, Mb),
                                 q)[r, c]
        ok = (b0 + c < Mb) & (a0 + r < Ma)
        np.add.at(rs, (a0 + r)[ok], D[ok])
        np.add.at(below, (a0 + r)[ok],
                  (np.float32(N) - D[ok].astype(np.float32)
                   < np.float32(thresh)))
    t_rs, t_below = tdist.row_stats_rect_torch(
        torch.as_tensor(ZA), torch.as_tensor(ZB), thresh, q=q)
    np.testing.assert_array_equal(rs.astype(np.float32), t_rs.numpy())
    np.testing.assert_array_equal(below.astype(np.float32),
                                  t_below.numpy())
    j_rs, j_below = jdist.row_stats_rect_pallas(
        jnp.asarray(ZA.astype(np.int8)), jnp.asarray(ZB.astype(np.int8)),
        jnp.float32(thresh), q, tile_m=128, interpret=True)
    np.testing.assert_array_equal(t_rs.numpy(), np.asarray(j_rs))
    np.testing.assert_array_equal(t_below.numpy(), np.asarray(j_below))


def _triangle_tile(t):
    """Kernel A's and D's tile t of the upper triangle (column-major),
    computed as the kernel does: a float estimate, then integer fixes."""
    tj = int((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while (tj + 1) * (tj + 2) // 2 <= t:
        tj += 1
    while tj * (tj + 1) // 2 > t:
        tj -= 1
    return t - tj * (tj + 1) // 2, tj


@pytest.mark.parametrize("M", [1, 127, 128, 129, 300])
def test_match_counts_triangle_cover(M):
    """Kernel D's cover in numpy: the blocks of the upper triangle of
    128-row tiles, each writing its fragment-product tile at (a0 + r, b0 +
    c) and, off the diagonal, transposed at (b0 + c, a0 + r), rows and
    columns past M masked on both writes. Every entry is written exactly
    once and equals ``match_counts_torch`` (tokens 1..31, q = 21)."""
    N, q = 40, 21
    Z = _tokens(M, N, 31, seed=M, pad_rows=min(3, M - 1))
    r, c = _epilogue_layout()
    T = -(-M // 128)
    out = np.full((M, M), -1, np.int64)
    writes = np.zeros((M, M), np.int64)
    tiles = set()
    for t in range(T * (T + 1) // 2):
        ti, tj = _triangle_tile(t)
        assert ti <= tj < T
        tiles.add((ti, tj))
        a0, b0 = ti * 128, tj * 128
        D = _counts_by_fragments(_tile_of(Z, a0, M), _tile_of(Z, b0, M),
                                 q)[r, c]
        ok = (a0 + r < M) & (b0 + c < M)
        rows, cols, vals = (a0 + r)[ok], (b0 + c)[ok], D[ok]
        out[rows, cols] = vals
        np.add.at(writes, (rows, cols), 1)
        if ti != tj:
            out[cols, rows] = vals
            np.add.at(writes, (cols, rows), 1)
    assert len(tiles) == T * (T + 1) // 2
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        out, tdist.match_counts_torch(torch.as_tensor(Z), q).numpy())


@pytest.mark.parametrize("M", [32768, 100000])
def test_triangle_tiles_at_depth(M):
    """The triangle walk of kernels A and D at the depths of the main
    paths (M = 100,000 is the deep auto-theta cell: M^2 > 2^31): every
    launch index maps to a distinct tile ti <= tj < T, all T (T + 1) / 2
    of them, and the grid and the tiles' row offsets stay in 31 bits."""
    T = -(-M // 128)
    t = np.arange(T * (T + 1) // 2, dtype=np.int64)
    tj = ((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5).astype(np.int64)
    for _ in range(2):      # the kernel's integer fixes, vectorized
        tj += (tj + 1) * (tj + 2) // 2 <= t
        tj -= tj * (tj + 1) // 2 > t
    ti = t - tj * (tj + 1) // 2
    assert ((0 <= ti) & (ti <= tj) & (tj < T)).all()
    assert np.unique(ti * T + tj).size == t.size
    assert t.size < 2 ** 31 and (tj.max() + 1) * 128 < 2 ** 31
    assert all(_triangle_tile(int(k)) == (ti[k], tj[k])
               for k in (0, 1, t.size // 2, t.size - 1))
