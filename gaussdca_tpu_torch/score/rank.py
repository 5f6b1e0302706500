"""Ranking and text emission.

Reimplements the reference's ``compute_ranking`` (GaussDCA.jl's
src/GaussDCA.jl:88-99) and ``printrank`` (src/GaussDCA.jl:67-74):

- pairs (i, j) with 1 <= i <= N - m and i + m <= j <= N (m = min_separation),
  exactly (N-m)(N-m+1)/2 of them, scored from the lower triangle S[j, i],
- sorted by score descending (tie order unspecified, as in the reference's
  unstable sort — golden comparisons are set + value based),
- emitted as ``"%i %i %e"`` lines (the format is load-bearing: golden files
  are compared token-by-token).

The sort runs where S lies. For a tensor, ``compute_ranking`` gathers
the ranked scores on S's device, sorts them there (one stable
``torch.sort``), and copies back only the sorted scores and their pair
indices. For an ndarray, it sorts on the host (a stable NumPy
``argsort``, as in ``gaussdca_tpu.score.rank``). Either way the list is
built from whole columns (``tolist``), and both give the same order:
ties stay in generation order. ``top_k_ranking`` takes the head on the
host without a full sort (``argpartition``, then a stable sort of the
k); ``top_k_device`` selects it where S lies (``torch.topk``), so only
3k numbers reach the host.
"""

from __future__ import annotations

from typing import List, Tuple, Union, IO

import numpy as np
import torch

Ranking = List[Tuple[int, int, float]]


def ranking_pairs(N: int, min_separation: int) -> Tuple[np.ndarray, np.ndarray]:
    """1-based (i, j) index arrays of all ranked pairs, in generation order."""
    m = min_separation
    iu, ju = np.triu_indices(N, k=m)
    return iu + 1, ju + 1


def _columns(ii, jj, scores) -> Ranking:
    """(i, j, score) tuples from three equal-length columns."""
    return list(zip(ii.tolist(), jj.tolist(), scores.tolist()))


def compute_ranking(S: Union[np.ndarray, torch.Tensor],
                    min_separation: int) -> Ranking:
    """Ranked (i, j, score) triples, descending score; 1-based indices.
    A tensor S is gathered and sorted on its own device; an ndarray on
    the host. Ties keep generation order on both paths."""
    if isinstance(S, torch.Tensor):
        N = S.shape[0]
        ij = torch.triu_indices(N, N, offset=min_separation,
                                device=S.device)
        # the lower triangle S[j, i], as on the host below
        scores, order = torch.sort(S[ij[1], ij[0]], descending=True,
                                   stable=True)
        ij = (ij[:, order] + 1).cpu()
        return _columns(ij[0], ij[1], scores.cpu())
    S = np.asarray(S)
    N = S.shape[0]
    ii, jj = ranking_pairs(N, min_separation)
    # Reference reads the lower triangle S[j, i] (src/GaussDCA.jl:94).
    scores = S[jj - 1, ii - 1]
    order = np.argsort(-scores, kind="stable")
    return _columns(ii[order], jj[order], scores[order])


def top_k_ranking(S: np.ndarray, min_separation: int, k: int) -> Ranking:
    """Top-k ranked pairs without a full sort (host ``argpartition``, then
    a stable sort of the k). Ties at the k-th score resolve as
    ``argpartition`` leaves them."""
    S = np.asarray(S)
    N = S.shape[0]
    ii, jj = ranking_pairs(N, min_separation)
    scores = S[jj - 1, ii - 1]
    k = min(k, scores.size)
    part = np.argpartition(-scores, k - 1)[:k]
    order = part[np.argsort(-scores[part], kind="stable")]
    return _columns(ii[order], jj[order], scores[order])


def top_k_device(S: torch.Tensor, min_separation: int, k: int) -> Ranking:
    """Top-k ranked pairs selected on S's device (``torch.topk``). Ties
    may resolve differently from the host sort (both match the
    reference's unspecified tie order)."""
    N = S.shape[0]
    m = min_separation
    # t clamps at 0 so min_separation > N yields an empty ranking, as
    # compute_ranking does
    t = max(0, N - m)
    k = int(min(k, t * (t + 1) // 2))
    if k == 0:
        return []
    # the ranked region j >= i + m, read from the lower triangle S[j, i]
    rows = torch.arange(N, device=S.device)[:, None]
    cols = torch.arange(N, device=S.device)[None, :]
    flat = torch.where(cols >= rows + m, S.T, float("-inf")).reshape(-1)
    vals, idx = torch.topk(flat, k)
    return _columns((idx // N + 1).cpu(), (idx % N + 1).cpu(), vals.cpu())


def format_rank(R: Ranking) -> str:
    """The reference's "%i %i %e" emission format (src/GaussDCA.jl:69)."""
    return "".join(f"{i} {j} {x:e}\n" for i, j, x in R)


def printrank(out: Union[str, IO[str], Ranking], R: Ranking = None) -> None:
    """Write a ranking to a path or text IO (src/GaussDCA.jl:67-74).

    ``printrank(R)`` with the output omitted writes to stdout — the form
    the reference documents (its own no-output method referenced the
    pre-1.0 ``STDOUT`` name and was broken on Julia >= 1.0; implemented
    correctly here rather than replicated).
    """
    if R is None:
        import sys
        out, R = sys.stdout, out
    if isinstance(out, str):
        with open(out, "w") as fh:
            fh.write(format_rank(R))
    else:
        out.write(format_rank(R))
