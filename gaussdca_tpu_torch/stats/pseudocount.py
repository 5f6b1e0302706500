"""Pseudocount shrinkage and covariance assembly.

The contract of ``gaussdca_tpu.stats.pseudocount`` (unpadded alignments):

- ``Pi = (1-pc) * Pi_true + pc/q``
- off-diagonal site blocks: ``Pij = (1-pc) * Pij_true + pc/q^2``
- diagonal site blocks:     ``Pij = (1-pc) * Pij_true + delta_ab * pc/q``
- ``C = Pij - Pi Pi^T``  (dimension N*s with s = q-1)

``row0`` lets both act on a row slab ``Pij[row0:row0 + r]`` (the mesh
path keeps Pij and C as per-shard row slabs); ``Pi`` stays whole.
"""

from __future__ import annotations

from typing import Tuple

import torch


def add_pseudocount(Pi_true: torch.Tensor, Pij_true: torch.Tensor, pc,
                    q: int, row0: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype, device = Pij_true.dtype, Pij_true.device
    pc = torch.tensor(float(pc), dtype=dtype)
    s = q - 1
    r, Ns = Pij_true.shape
    pcq = pc / q
    Pi = (1 - pc) * Pi_true + pcq.to(Pi_true.device)
    rows = torch.arange(row0, row0 + r, device=device)
    cols = torch.arange(Ns, device=device)
    same_site = (rows // s)[:, None] == (cols // s)[None, :]
    Pij = (1 - pc) * Pij_true + torch.where(
        same_site, torch.zeros((), dtype=dtype, device=device),
        (pcq / q).to(device))
    Pij += pcq * (rows[:, None] == cols[None, :]).to(dtype)
    return Pi, Pij


def compute_C(Pi: torch.Tensor, Pij: torch.Tensor,
              row0: int = 0) -> torch.Tensor:
    """Covariance C = Pij - Pi Pi^T (src/GaussDCA.jl:76), or its rows
    ``row0:row0 + Pij.shape[0]``."""
    Pi = Pi.to(Pij.device)
    return Pij - torch.outer(Pi[row0:row0 + Pij.shape[0]], Pi)
