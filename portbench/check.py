"""The comparison that decides ``correct``: each ranking the window wrote
against the plain reference's ranking of the same file.

Three numbers, each with its limit from ``limits/<cell>.json``:

- ``missing``: rankings the window should have written and did not;
- ``pairs_off``: pairs outside the reference's pair set, pairs of it
  left out (only those that clearly belong in a ``top_k`` head), and
  places where the written scores rise instead of falling;
- ``score_err``: the widest gap between a written score and the
  reference's score of the same pair, over the largest reference score
  in magnitude of that family.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


def read_ranking(path: str) -> np.ndarray:
    """[pairs, 3] float64 (i, j, score) of a "%i %i %e" ranking file."""
    with open(path) as fh:
        return np.array(fh.read().split(), dtype=np.float64).reshape(-1, 3)


def compare(rows: np.ndarray, S: np.ndarray, min_separation: int,
            top_k: Optional[int] = None, score_limit: float = 0.0
            ) -> Dict[str, float]:
    """{pairs_off, score_err} of one written ranking ``rows`` against the
    reference scores S [N, N] (pair (i, j) scored S[j - 1, i - 1])."""
    N = S.shape[0]
    iu, ju = np.triu_indices(N, k=min_separation)
    ref = S[ju, iu]
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    i, j = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    valid = (i >= 1) & (j <= N) & (j - i >= min_separation)
    key = (i[valid] - 1) * N + (j[valid] - 1)
    want = iu * N + ju
    present = np.isin(want, key)
    off = int((~valid).sum()) + (key.size - np.unique(key).size) \
        + int(np.count_nonzero(np.diff(rows[:, 2]) > 0))
    if top_k is None:
        off += int((~present).sum())
    elif ref.size:
        # a head of k pairs leaves out only pairs scored clearly below its
        # k-th best reference score (ties are the program's to break)
        kth = np.sort(ref)[::-1][min(top_k, ref.size) - 1]
        off += int((~present & (ref > kth + score_limit * scale)).sum())
        off += abs(rows.shape[0] - min(top_k, ref.size))
    got = rows[valid, 2]
    err = 0.0
    if got.size and scale > 0:
        err = float(np.abs(got - S[j[valid] - 1, i[valid] - 1]).max()) / scale
    return {"pairs_off": off, "score_err": err}


def judge(outputs: List[str], refs: List[np.ndarray], min_separation: int,
          limits: Dict[str, float], top_k: Optional[int] = None
          ) -> Dict[str, Dict[str, float]]:
    """Every output path against its family's reference scores; returns
    {number: {"value", "limit"}} with the worst value of each."""
    worst = {"missing": 0, "pairs_off": 0, "score_err": 0.0}
    for path, S in zip(outputs, refs):
        if not os.path.isfile(path):
            worst["missing"] += 1
            continue
        one = compare(read_ranking(path), S, min_separation, top_k,
                      limits["score_err"])
        worst["pairs_off"] += one["pairs_off"]
        worst["score_err"] = max(worst["score_err"], one["score_err"])
    return {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
