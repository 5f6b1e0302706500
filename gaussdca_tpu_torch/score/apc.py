"""Average-Product Correction.

The reference's ``correct_APC`` (src/GaussDCA.jl:78-86), as
``gaussdca_tpu.score.apc``: with Si the column sums, Sj the row sums and
Sa = sum(S) * (1 - 1/N), ``S -= (Sj Si) / Sa``. Assumes S symmetric with
a zero diagonal.
"""

from __future__ import annotations

import torch


def correct_apc(S: torch.Tensor) -> torch.Tensor:
    N = S.shape[0]
    Si = S.sum(0, keepdim=True)     # [1, N]
    Sj = S.sum(1, keepdim=True)     # [N, 1]
    Sa = S.sum() * (1.0 - 1.0 / N)
    # identically-zero scores (e.g. q=2, where the zero-sum gauge
    # annihilates the single reduced coupling) would make this 0/0
    safe = torch.where(Sa == 0, torch.ones_like(Sa), Sa)
    return S - (Sj * Si) / safe
