"""Weighted one- and two-site frequency statistics.

The contract of ``gaussdca_tpu.stats.frequencies.weighted_frequencies``:
states run over the reduced alphabet 1..s (s = q - 1; the highest state is
the gauge and gets a zero one-hot row), and with E the one-hot [M, N*s]

    Pi = W E / Meff,    Pij = E^T diag(W) E / Meff

(the one-hot product reproduces the diag(Pi) site blocks exactly). Both
are one dense matmul (``torch.matmul``, no kernel of this package: the JAX
package leaves the same product to XLA). Past ~1 GB of one-hot the
product is accumulated over sequence chunks, with the chunk rule of
``gaussdca_tpu.api`` (``frequency_chunk``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def frequency_chunk(M: int, N: int, q: int, dtype: torch.dtype) -> int:
    """Sequence chunk of the accumulation: 0 (one shot) while the one-hot
    stays within 1 GiB, else the rows that fit in 1 GiB (at least 256)."""
    itemsize = torch.finfo(dtype).bits // 8
    e_bytes = M * N * (q - 1) * itemsize
    if e_bytes <= 2 ** 30:
        return 0
    return max(256, (2 ** 30) // (N * (q - 1) * itemsize))


def one_hot_reduced(Z: torch.Tensor, q: int, dtype) -> torch.Tensor:
    """One-hot over states 1..q-1 (state q and token 0 -> zero row):
    [M, N*(q-1)]."""
    M, N = Z.shape
    states = torch.arange(1, q, dtype=Z.dtype, device=Z.device)
    return (Z[:, :, None] == states).reshape(M, N * (q - 1)).to(dtype)


def accumulate_frequencies(Z: torch.Tensor, W: torch.Tensor, q: int, *,
                           dtype: torch.dtype = torch.float64,
                           m_chunk: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized (pi [N*s], pij [N*s, N*s]) weighted one-hot sums;
    ``m_chunk > 0`` streams over sequence chunks of that size."""
    M, N = Z.shape
    W = W.to(dtype)
    if m_chunk <= 0 or m_chunk >= M:
        E = one_hot_reduced(Z, q, dtype)
        return W @ E, (E * W[:, None]).T @ E
    Ns = N * (q - 1)
    pi = torch.zeros(Ns, dtype=dtype, device=Z.device)
    pij = torch.zeros((Ns, Ns), dtype=dtype, device=Z.device)
    for r0 in range(0, M, m_chunk):
        Ec = one_hot_reduced(Z[r0:r0 + m_chunk], q, dtype)
        wc = W[r0:r0 + m_chunk]
        pi += wc @ Ec
        pij += (Ec * wc[:, None]).T @ Ec
    return pi, pij


def weighted_frequencies(Z: torch.Tensor, W: torch.Tensor, q: int, *,
                         dtype: torch.dtype = torch.float64,
                         m_chunk: int = 0):
    """(Pi_true [N*s], Pij_true [N*s, N*s], Meff) from tokens and weights."""
    Meff = W.to(dtype).sum()
    pi, pij = accumulate_frequencies(Z, W, q, dtype=dtype, m_chunk=m_chunk)
    return pi / Meff, pij / Meff, Meff
