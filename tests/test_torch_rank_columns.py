"""PyTorch port: the ranking sorted where S lies, built from whole columns.

``score.rank.compute_ranking`` on a tensor gathers and sorts on S's
device; on an ndarray it sorts on the host. Both are held to the JAX
package's ``compute_ranking``, order included, on S with many tied
scores and with a -0.0 beside a 0.0, in f32 and f64, at separations
from 0 to past N (no pairs). The two top-k functions give the head of
that list (up to the order of the pairs tied at the k-th score, which
their docstrings leave open), and ``api._checked_ranking`` still
refuses a NaN, through ``api.compute_ranking``. CPU tensors.
"""

import math

import numpy as np
import pytest
import torch

from gaussdca_tpu.score import rank as jrank
from gaussdca_tpu_torch import api
from gaussdca_tpu_torch.score import rank

DTYPES = {"f32": np.float32, "f64": np.float64}


def scores(kind, N, dtype, seed):
    """An [N, N] score matrix: ``ties`` draws from five values, so runs
    of equal scores are long; ``signed_zero`` is mostly zeros of either
    sign, so a -0.0 sits beside a 0.0 in generation order."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        S = rng.integers(-2, 3, size=(N, N)) / 2.0
    else:
        S = np.where(rng.random((N, N)) < 0.5, -0.0, 0.0)
        S[rng.random((N, N)) < 0.1] = 1.0
        S[rng.random((N, N)) < 0.1] = -1.0
        # a 0.0 then a -0.0 at the head of the ranked region's first row
        if N > 2:
            S[1, 0], S[2, 0] = 0.0, -0.0
    return S.astype(dtype)


def signed(R):
    """The ranking with each score's sign bit, which ``==`` on floats
    does not see."""
    return [(i, j, x, math.copysign(1.0, x)) for i, j, x in R]


def assert_head(top, full, k):
    """``top`` is ``full[:k]`` up to the order of pairs whose score ties
    with others: the same scores in the same order, every pair a ranked
    pair with its own score, and the same pairs above the k-th score."""
    head = full[:k]
    assert len(top) == len(head)
    assert [x for *_, x in top] == [x for *_, x in head]
    where = {(i, j): x for i, j, x in full}
    assert len({(i, j) for i, j, _ in top}) == len(top)
    assert all(where[(i, j)] == x for i, j, x in top)
    if head:
        last = head[-1][2]
        assert ({(i, j) for i, j, x in top if x > last}
                == {(i, j) for i, j, x in head if x > last})


@pytest.mark.parametrize("kind", ["ties", "signed_zero"])
@pytest.mark.parametrize("N", [1, 7, 300])
@pytest.mark.parametrize("sep", [0, 1, 5, "N+1"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_tensor_ranking_equals_host_and_jax(kind, N, sep, dt):
    m = N + 1 if sep == "N+1" else sep
    S = scores(kind, N, DTYPES[dt], seed=N * 10 + (m % 7))
    T = torch.as_tensor(S)
    on_tensor = rank.compute_ranking(T, m)
    on_host = rank.compute_ranking(S, m)
    want = jrank.compute_ranking(S, m)
    assert on_tensor == on_host == want
    assert signed(on_tensor) == signed(on_host) == signed(want)
    assert all(type(i) is int and type(j) is int and type(x) is float
               for i, j, x in on_tensor)
    P = max(0, N - m) * max(0, N - m + 1) // 2
    assert len(on_tensor) == P
    for k in sorted({1, P // 3, P, P + 5} - {0}):
        assert_head(rank.top_k_ranking(S, m, k), want, k)
        assert_head(rank.top_k_device(T, m, k), want, k)


@pytest.mark.parametrize("at", ["corner", "inside"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_checked_ranking_refuses_one_nan(at, dt):
    """One NaN among finite scores: a descending ``torch.sort`` puts it
    first, and the endpoint check still raises."""
    S = torch.rand(12, 12, dtype=dt)
    j, i = (11, 0) if at == "corner" else (7, 2)
    S[j, i] = float("nan")
    with pytest.raises(ArithmeticError, match="positive definite"):
        api._checked_ranking(S, 2)


def test_checked_ranking_ranks_the_tensor_through_api_compute_ranking(
        monkeypatch):
    """The tensor itself reaches ``api.compute_ranking`` as two positional
    arguments (the name and the form a wrapper patches), not a host copy."""
    seen = []
    orig = api.compute_ranking

    def spy(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(api, "compute_ranking", spy)
    S = torch.rand(9, 9, dtype=torch.float64)
    R = api._checked_ranking(S, 3)
    (args, kwargs), = seen
    assert args[0] is S and args[1] == 3 and kwargs == {}
    assert R == rank.compute_ranking(S.numpy(), 3)
