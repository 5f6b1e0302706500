"""Sequence reweighting: auto-theta + similarity-threshold weights.

The contract of ``gaussdca_tpu.stats.reweight.compute_weights_streaming``:

- ``thresh = floor(theta * N)``; b is a neighbour of a iff
  ``hamming(a, b) = N - matches(a, b) < thresh`` (strict);
- ``W[a] = 1 / (1 + #{b != a : neighbour})``, ``Meff = sum(W)``; the
  self-match is dropped by subtracting ``(thresh > 0)`` and the count is
  clamped at 0 (token-0 rows match nothing, not even themselves);
- auto-theta ``theta = min(0.5, 0.1216 / meanfracid)`` from the closed
  form ``sum_ab matches(a, b) = sum_k sum_c n_kc^2`` over per-column state
  histograms, so the O(M^2 N) distance pass runs once in either theta
  mode.

The distance pass is ``row_stats_fn(Z, thresh, q)``, the JAX package's
contract (default ``ops.distance.row_stats`` over the alignment's states
1..q: the Hopper kernel on a CUDA tensor, its plain version on the CPU);
only O(M) state is kept. ``m_true`` is the unpadded row count when Z
carries token-0 padding rows (the mesh path pads M to a multiple of its
shard count): they leave the auto-theta pair count, W and Meff.

``compute_weights`` is the dense path of ``gaussdca_tpu.stats.reweight``:
the [M, M] identity counts from ``match_counts_fn`` (default
``ops.distance.match_counts``: kernel D on a CUDA tensor, its plain
version on the CPU), then ``weights_from_matches``; the same W, Meff and
theta as the streaming path, for O(M^2) memory.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from gaussdca_tpu_torch.ops.distance import match_counts, row_stats

AUTO_THETA_COEFF = 0.38 * 0.32  # = 0.1216, the reference's auto-theta constant


def total_matches_closed_form(Z: torch.Tensor, q: int) -> int:
    """``sum_{a,b} matches(a, b)`` over all ordered row pairs (a = b
    included), as an exact integer: ``sum_k sum_{c=1..q} n_kc^2`` with
    ``n_kc = #{a : Z[a, k] = c}``, counted in int64 (token 0 and tokens
    above q excluded)."""
    M, N = Z.shape
    offsets = torch.arange(N, device=Z.device, dtype=torch.int64) * (q + 1)
    Zq = Z.view(torch.uint8).to(torch.int64)
    idx = (Zq.masked_fill_(Zq > q, 0) + offsets).reshape(-1)
    n = torch.bincount(idx, minlength=N * (q + 1)).reshape(N, q + 1)[:, 1:]
    return int((n * n).sum())


def auto_theta_closed_form(Z: torch.Tensor, q: int,
                           m_true: Optional[int] = None) -> torch.Tensor:
    """Resolved auto-theta ``min(0.5, 0.1216 / meanfracid)``, a host f64
    scalar computed from the exact match total (NaN for a single row, as
    in the reference package). ``m_true``: the rows that are not token-0
    padding (padding adds no matches, only to the pair count)."""
    M, N = Z.shape
    M = M if m_true is None else int(m_true)
    tm = torch.tensor(total_matches_closed_form(Z, q), dtype=torch.float64)
    total = (tm - M * N) / 2.0
    mfi = total / (N * (M * (M - 1) / 2.0))
    return torch.minimum(torch.tensor(0.5, dtype=torch.float64),
                         AUTO_THETA_COEFF / mfi)


def _resolve_theta(Z: torch.Tensor, theta: Union[str, float], q: int,
                   m_true: Optional[int], dtype: torch.dtype) -> torch.Tensor:
    if isinstance(theta, str):
        if theta != "auto":
            raise ValueError(f"invalid theta: {theta}")
        theta = auto_theta_closed_form(Z, q, m_true)
    return torch.as_tensor(theta, dtype=torch.float64).to(dtype)


def compute_weights_streaming(
    Z: torch.Tensor,
    theta: Union[str, float],
    q: int,
    *,
    dtype: torch.dtype = torch.float64,
    row_stats_fn: Optional[Callable] = None,
    m_true: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W [M], Meff, resolved theta) of token matrix Z [M, N] in O(M)
    memory; theta is "auto" or a real in [0, 1].
    ``row_stats_fn(Z, thresh, q) -> (rowsum, below)`` defaults to
    ``row_stats``; rows at or past ``m_true`` get weight 0."""
    M, N = Z.shape
    th = _resolve_theta(Z, theta, q, m_true, dtype)
    thresh = torch.floor(th * N).to(torch.float32)
    _, below = (row_stats_fn or row_stats)(Z, thresh, q)
    self_match = 1.0 if bool(thresh > 0) else 0.0
    below = torch.clamp(below.to(dtype) - self_match, min=0.0)
    W = 1.0 / (1.0 + below)
    if m_true is not None:
        W = W * (torch.arange(M, device=W.device) < m_true).to(dtype)
    return W, W.sum(), th


def weights_from_matches(D: torch.Tensor, N: int, theta,
                         dtype: torch.dtype = torch.float64, *,
                         row_chunk: int = 4096
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, Meff) from the identity-count matrix D [M, M]: hamming(a, b) =
    N - D[a, b], neighbour iff hamming < floor(theta N), self excluded,
    W = 1 / (1 + neighbours). Counted ``row_chunk`` rows at a time, so
    the f64 hamming never exists for all of D at once."""
    thresh = torch.floor(torch.as_tensor(theta, dtype=dtype) * N)
    limit = thresh.to(D.device)
    M = D.shape[0]
    below = torch.empty(M, dtype=dtype, device=D.device)
    for r0 in range(0, M, row_chunk):
        ham = (N - D[r0:r0 + row_chunk]).to(dtype)
        below[r0:r0 + row_chunk] = (ham < limit).sum(1, dtype=dtype)
    # the diagonal (hamming 0) counts iff thresh > 0; clamp at 0: token-0
    # rows match nothing, not even themselves
    below = torch.clamp(below - (1.0 if bool(thresh > 0) else 0.0), min=0.0)
    W = 1.0 / (1.0 + below)
    return W, W.sum()


def compute_weights(
    Z: torch.Tensor,
    theta: Union[str, float],
    *,
    dtype: torch.dtype = torch.float64,
    match_counts_fn: Optional[Callable] = None,
    q: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(W [M], Meff, resolved theta) through the [M, M] count matrix.
    ``match_counts_fn(Z) -> [M, M]`` defaults to ``match_counts`` over
    states 1..q; auto-theta comes from the streaming path's closed form
    (``q=None`` takes the full 1..31 state range in both)."""
    q = q or 31
    counts = (match_counts_fn(Z) if match_counts_fn
              else match_counts(Z, q))
    th = _resolve_theta(Z, theta, q, None, dtype)
    W, Meff = weights_from_matches(counts, Z.shape[1], th, dtype)
    return W, Meff, th
