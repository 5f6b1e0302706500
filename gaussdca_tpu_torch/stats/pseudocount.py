"""Pseudocount shrinkage and covariance assembly.

The contract of ``gaussdca_tpu.stats.pseudocount`` (unpadded alignments):

- ``Pi = (1-pc) * Pi_true + pc/q``
- off-diagonal site blocks: ``Pij = (1-pc) * Pij_true + pc/q^2``
- diagonal site blocks:     ``Pij = (1-pc) * Pij_true + delta_ab * pc/q``
- ``C = Pij - Pi Pi^T``  (dimension N*s with s = q-1)
"""

from __future__ import annotations

from typing import Tuple

import torch


def add_pseudocount(Pi_true: torch.Tensor, Pij_true: torch.Tensor, pc,
                    q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype, device = Pi_true.dtype, Pi_true.device
    pc = torch.tensor(float(pc), dtype=dtype)
    s = q - 1
    Ns = Pi_true.shape[0]
    pcq = pc / q
    Pi = (1 - pc) * Pi_true + pcq
    site = torch.arange(Ns, device=device) // s
    same_site = site[:, None] == site[None, :]
    Pij = (1 - pc) * Pij_true + torch.where(
        same_site, torch.zeros((), dtype=dtype, device=device),
        (pcq / q).to(device))
    Pij += pcq * torch.eye(Ns, dtype=dtype, device=device)
    return Pi, Pij


def compute_C(Pi: torch.Tensor, Pij: torch.Tensor) -> torch.Tensor:
    """Covariance C = Pij - Pi Pi^T (src/GaussDCA.jl:76)."""
    return Pij - torch.outer(Pi, Pi)
