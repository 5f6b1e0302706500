"""Public API: the full Gaussian DCA pipeline, on one device or a mesh.

``gdca(filename, **kwargs)`` mirrors ``gaussdca_tpu.gdca`` (the reference
``gDCA``): FASTA -> (dedup) -> reweighting -> weighted frequencies ->
pseudocount -> covariance -> Cholesky inverse -> FN or DI scores -> APC ->
min-separation ranking. The host does ingest, dedup and the final sort;
everything in between runs on ``cfg.device`` as eager PyTorch around the
two hand-written kernels (``ops.distance.row_stats``,
``ops.di_kernel.di_pairs``); ``top_k`` selects the head of the ranking
on the device. With ``mesh=`` the same pipeline runs
sharded over a grid of devices (``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.core.runtime import full_f32_matmuls, no_mark
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.parallel.mesh import Mesh, make_mesh
from gaussdca_tpu_torch.score.apc import correct_apc
from gaussdca_tpu_torch.score.di import di_score
from gaussdca_tpu_torch.score.frob import frob_score
from gaussdca_tpu_torch.score.rank import (Ranking, compute_ranking,
                                           printrank, top_k_device)
from gaussdca_tpu_torch.solve.cholesky import NOT_POSITIVE_DEFINITE, spd_inverse
from gaussdca_tpu_torch.stats import reweight
from gaussdca_tpu_torch.stats.frequencies import (frequency_chunk,
                                                   weighted_frequencies)
from gaussdca_tpu_torch.stats.pseudocount import add_pseudocount, compute_C

MAX_Q = 31  # the reference's 5-bit packing limit (src/GaussDCA.jl:26)


@dataclasses.dataclass
class GDCAResult:
    """Ranking plus the run metadata the reference never exposes."""

    ranking: Ranking
    M: int
    N: int
    q: int
    theta: float
    meff: float
    n_dropped_gaps: int
    n_dropped_dups: int

    def __iter__(self):
        return iter(self.ranking)

    def __len__(self):
        return len(self.ranking)

    def __getitem__(self, k):
        return self.ranking[k]


def scores_pipeline(Z: torch.Tensor, q: int, cfg: GDCAConfig, *,
                    mark: Callable[[str], None] = no_mark):
    """Device pipeline: tokens Z [M, N] (on the run's device) -> the
    APC-corrected score matrix S [N, N], the resolved theta and Meff.
    ``mark(stage)`` is called after each of "reweight", "frequencies",
    "solve" and "score" (a hook for stage timing)."""
    dtype = cfg.resolve_dtype()
    M, N = Z.shape
    theta = "auto" if cfg.auto_theta else float(cfg.theta)
    W, _, th = reweight.compute_weights_streaming(Z, theta, q, dtype=dtype)
    mark("reweight")
    Pi_t, Pij_t, meff = weighted_frequencies(
        Z, W, q, dtype=dtype, m_chunk=frequency_chunk(M, N, q, dtype))
    Pi, Pij = add_pseudocount(Pi_t, Pij_t, cfg.pseudocount, q)
    # drop each (N s)^2 buffer as soon as it is consumed: at N s = 20000
    # every one is 1.6 GB in f32
    del Pi_t, Pij_t
    C = compute_C(Pi, Pij)
    del Pi, Pij
    mark("frequencies")
    mJ = spd_inverse(C)
    mark("solve")
    if cfg.score == "DI":
        S = di_score(mJ, C, q)
    else:
        S = frob_score(mJ, q)
    S = correct_apc(S)
    mark("score")
    return S, th, meff


def _checked_ranking(S: torch.Tensor, min_separation: int,
                     top_k: Optional[int] = None) -> Ranking:
    """Rank S, refusing to emit a solver-poisoned (non-finite) ranking
    (the reference fails with PosDefException there). ``top_k``: only the
    k best pairs, selected where S lies. A NaN anywhere reaches every
    score through APC; a partial NaN sorts last on the host and first in
    ``torch.topk``, so the two endpoint scores suffice."""
    if top_k is not None:
        R = top_k_device(S, min_separation, top_k)
    else:
        R = compute_ranking(S.cpu().numpy(), min_separation)
    if R and not (np.isfinite(R[0][2]) and np.isfinite(R[-1][2])):
        raise ArithmeticError(NOT_POSITIVE_DEFINITE)
    return R


def resolve_mesh(mesh) -> Mesh:
    """Normalize a ``mesh`` argument: Mesh | "auto" | (dp, tp) -> Mesh.
    "auto" and a shape take the visible CUDA cards and raise when there
    are too few."""
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, str) and mesh == "auto":
        return make_mesh()
    if isinstance(mesh, (tuple, list)) and len(mesh) == 2:
        return make_mesh(int(mesh[0]) * int(mesh[1]),
                         shape=(int(mesh[0]), int(mesh[1])))
    raise ValueError(
        f"invalid mesh: {mesh!r} (expected a "
        "gaussdca_tpu_torch.parallel.mesh.Mesh, 'auto', "
        "or a (data, model) shape tuple)")


def gdca_from_msa(msa: fasta.MSA, cfg: GDCAConfig,
                  top_k: Optional[int] = None,
                  mesh: Any = None) -> GDCAResult:
    """Run the device pipeline + ranking on an already-ingested MSA.

    ``top_k``: return only the k best pairs, selected on the device
    (``torch.topk``), so the [N, N] score matrix never leaves it.

    ``mesh``: a ``Mesh``, a ``(dp, tp)`` shape or "auto" (every visible
    card) runs the sharded pipeline over it instead of ``cfg.device``
    (whose type must match the mesh's devices). Results match the
    single-device run to floating-point summation order."""
    if cfg.remove_dups:
        msa = fasta.remove_duplicate_sequences(msa)
    q = msa.q
    if q >= MAX_Q + 1:
        raise ValueError(f"parameter q={q} is too big (max {MAX_Q} is allowed)")
    if q < 2:
        # a single-state alignment has an empty reduced alphabet (s = 0):
        # no statistics exist to estimate
        raise ValueError(
            f"alignment uses only {q} symbol(s); at least 2 are required")
    if mesh is not None:
        from gaussdca_tpu_torch.parallel.sharded import pad_rows, \
            sharded_scores

        mesh = resolve_mesh(mesh)
        if mesh.home.type != cfg.resolve_device().type:
            raise ValueError(
                f"mesh on {mesh.home.type} devices but device="
                f"{cfg.device!r}: pass a matching device")
        Z = pad_rows(torch.as_tensor(msa.tokens), mesh.size)
        with full_f32_matmuls():
            S, th, meff = sharded_scores(mesh, Z, cfg, q, m_true=msa.M)
    else:
        Z = torch.as_tensor(msa.tokens, device=cfg.resolve_device())
        with full_f32_matmuls():
            S, th, meff = scores_pipeline(Z, q, cfg)
    R = _checked_ranking(S, cfg.min_separation, top_k)
    return GDCAResult(
        ranking=R, M=msa.M, N=msa.N, q=q,
        theta=float(th), meff=float(meff),
        n_dropped_gaps=msa.n_dropped_gaps,
        n_dropped_dups=msa.n_dropped_dups,
    )


def gdca(
    filename: str,
    *,
    pseudocount: float = 0.8,
    theta: Union[str, float] = "auto",
    max_gap_fraction: float = 0.9,
    score: str = "frob",
    min_separation: int = 5,
    remove_dups: bool = False,
    dtype: Any = torch.float32,
    device: Any = "cuda",
    top_k: Optional[int] = None,
    mesh: Any = None,
) -> GDCAResult:
    """Contact-prediction ranking of an MSA file.

    Same keyword names, defaults and validation as the reference ``gDCA``
    and ``gaussdca_tpu.gdca``; ``dtype`` (float32 or float64) and
    ``device`` (default "cuda"; a CPU device runs every kernel's plain
    PyTorch version) choose where and how it runs; ``top_k`` returns only
    the k best pairs, selected on the device, and ``mesh`` shards the run
    over several devices (see ``gdca_from_msa`` for both). Returns a
    GDCAResult: 1-based (i, j, score) triples sorted by descending score,
    plus run metadata.
    """
    cfg = GDCAConfig(
        pseudocount=pseudocount, theta=theta,
        max_gap_fraction=max_gap_fraction, score=score,
        min_separation=min_separation, remove_dups=remove_dups,
        dtype=dtype, device=device,
    )
    msa = fasta.read_fasta_alignment(filename, cfg.max_gap_fraction)
    return gdca_from_msa(msa, cfg, top_k=top_k, mesh=mesh)


__all__ = ["gdca", "gdca_from_msa", "printrank", "resolve_mesh", "Mesh",
           "GDCAConfig", "GDCAResult"]
