"""PyTorch port: kernels E and F, their state count and their covers.

- ``row_stats_asym`` (kernel E's plain version on a CPU tensor) against
  the TPU kernel ``row_stats_asym_pallas`` in interpret mode, exactly, on
  tokens 0..31 at q = 9 and 21 (tokens above q match nothing), at JAX's
  own plan, at a grouped covering JAX walks itself, and at a width where
  the port has no plan (it takes ``row_stats``);
- numpy emulations of what the CUDA kernels walk, at M = 1 .. 300: kernel
  E's blocks (groups x chunks of the window, two resident 128-row tiles,
  the per-step liveness of each) and kernel F's persistent blocks over
  its grouped order of 128 x 256 tiles with the in-tile triangle mask.
  Each must count every ordered pair (a, b) toward row a exactly once: by
  a row partial where a lies in the tile's rows, by a column partial
  where a lies in its columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.ops import distance as jdist
from gaussdca_tpu_torch.ops import distance as tdist

COVER_M = (1, 63, 64, 127, 128, 129, 255, 256, 257, 300)


def _tokens_0_31(M, N, seed):
    """Tokens 0..31 with near-duplicate families (so neighbour counts
    exceed 1): states above q and token 0 both occur at q = 9 and 21."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(0, 32, size=(M, N), dtype=np.uint8)
    for f in range(0, M - 8, 12):
        mut = rng.random((7, N)) < 0.15
        Z[f + 1:f + 8] = np.where(mut, rng.integers(0, 32, (7, N)), Z[f])
    return Z


@pytest.mark.parametrize("q", [9, 21])
@pytest.mark.parametrize("M,N,jax_plan", [
    (300, 40, {}),                      # JAX's own plan (its square kernel)
    (300, 40, {"tile_b": 16, "k": 3}),  # JAX's grouped covering, T = 21
    (70, 1000, {}),                     # the port has no plan: row_stats
])
def test_row_stats_asym_counts_states_up_to_q(q, M, N, jax_plan):
    Z = _tokens_0_31(M, N, seed=M + N + q)
    Zt = torch.as_tensor(Z)
    assert (tdist.plan_asym(N) >= 2) == (N < 1000)
    for frac in (0.0, 0.1, 0.25):
        t = float(np.float32(np.floor(frac * N)))
        got = tdist.row_stats_asym(Zt, t, q)
        want = jdist.row_stats_asym_pallas(
            jnp.asarray(Z.astype(np.int8)), jnp.float32(t), q,
            interpret=True, **jax_plan)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # the plain version at the kernel's own covering, and kernel A
        if N < 1000:
            plain = tdist.row_stats_asym_torch(Zt, t, tdist.plan_asym(N), q)
            for g, w in zip(plain, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(tdist.row_stats(Zt, t, q), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _hits_ok(row_hits, col_hits):
    """Every ordered pair (a, b) reaches row a's statistics exactly once."""
    total = row_hits + col_hits.T
    assert (total == 1).all(), np.argwhere(total != 1)[:5]


def _asym_kernel_walk(M, sms, tile=128, k=2):
    """Kernel E's grid as ``row_stats_asym.cu`` walks it: block (g, c)
    takes steps jp of chunk c; consumer warpgroup r (tile alpha = g k + r)
    is live iff d = jp - r is in [0, T / 2] and not (2 d == T and alpha >=
    T / 2); a live tile counts rows < M against columns < M toward its
    rows, and toward the columns too unless d == 0."""
    T, J = tdist._asym_cover(M, k, tile)
    chunks = tdist.plan_asym_chunks(M, sms, k, tile)
    chunk = -(-J // chunks)
    row_hits = np.zeros((M, M), np.int64)
    col_hits = np.zeros((M, M), np.int64)
    for g in range(T // k):
        for c in range(-(-J // chunk)):
            for jp in range(c * chunk, min(J, (c + 1) * chunk)):
                for r in range(k):
                    alpha, d = g * k + r, jp - r
                    if not (d >= 0 and 2 * d <= T
                            and not (2 * d == T and 2 * alpha >= T)):
                        continue
                    beta = (g * k + jp) % T
                    rows = np.arange(alpha * tile, (alpha + 1) * tile)
                    cols = np.arange(beta * tile, (beta + 1) * tile)
                    rows, cols = rows[rows < M], cols[cols < M]
                    row_hits[np.ix_(rows, cols)] += 1
                    if d != 0:
                        col_hits[np.ix_(rows, cols)] += 1
    return row_hits, col_hits


@pytest.mark.parametrize("M,tile", [(M, 128) for M in COVER_M]
                         + [(300, 4), (257, 8), (129, 16)])
def test_asym_kernel_cover_counts_each_pair_once(M, tile):
    """Kernel E's 128-row tiles, and small tiles (T from 18 to 76, odd and
    even T / 2), at 1 to 132 SMs: the window split into chunks or not."""
    for sms in (1, 3, 5, 132):
        _hits_ok(*_asym_kernel_walk(M, sms, tile=tile))


def _e8_tile_at(t, Ta, Tb, group):
    """``tile_at`` of ``row_stats_e8.cu``: column tiles in groups of
    ``group`` (the kernel's GROUP = 2), each group over the row tiles i <
    min(Ta, 2 jend), column fastest; (i, j, live) with live iff i <= 2 j +
    1."""
    for j0 in range(0, Tb, group):
        jend = min(Tb, j0 + group)
        w = jend - j0
        rows = min(Ta, 2 * jend)
        if t < rows * w:
            i, j = t // w, j0 + t % w
            return i, j, i <= 2 * j + 1
        t -= rows * w
    raise AssertionError("t past the order")


def _e8_kernel_walk(M, sms, bm=128, bn=256, group=2):
    """Kernel F's persistent blocks: block b takes tiles t = b, b + grid,
    ... of the grouped order; a live tile counts entry (a, b) iff a < M, b
    < M and a <= b, toward row a, and toward column b when a < b."""
    Ta, Tb = -(-M // bm), -(-M // bn)
    L = sum(min(Ta, 2 * min(Tb, j0 + group)) * (min(Tb, j0 + group) - j0)
            for j0 in range(0, Tb, group))
    grid = min(L, sms)
    row_hits = np.zeros((M, M), np.int64)
    col_hits = np.zeros((M, M), np.int64)
    seen = set()
    for b in range(grid):
        for t in range(b, L, grid):
            i, j, live = _e8_tile_at(t, Ta, Tb, group)
            assert (i, j) not in seen and i < Ta and j < Tb
            seen.add((i, j))
            if not live:
                continue
            rows = np.arange(i * bm, (i + 1) * bm)
            cols = np.arange(j * bn, (j + 1) * bn)
            rows, cols = rows[rows < M], cols[cols < M]
            a, c = np.meshgrid(rows, cols, indexing="ij")
            keep = a <= c
            np.add.at(row_hits, (a[keep], c[keep]), 1)
            strict = a < c
            np.add.at(col_hits, (a[strict], c[strict]), 1)
    # every tile that reaches the triangle is in the order
    assert {(i, j) for i in range(Ta) for j in range(Tb)
            if i <= 2 * j + 1} <= seen
    return row_hits, col_hits


@pytest.mark.parametrize("M,bm", [(M, 128) for M in COVER_M]
                         + [(300, 4), (257, 8)])
def test_e8_kernel_cover_counts_each_pair_once(M, bm):
    """Kernel F's 128 x 256 tiles, and small tiles (bm x 2 bm: many column
    groups, a ragged last group and row tile), on 1, 7 and 132 persistent
    blocks, in groups of 2 column tiles (the kernel's) and of 1, 3 and 8."""
    for sms in (1, 7, 132):
        for group in (2, 1, 3, 8):
            _hits_ok(*_e8_kernel_walk(M, sms, bm=bm, bn=2 * bm, group=group))
