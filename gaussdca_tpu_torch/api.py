"""Public API: the full Gaussian DCA pipeline, on one device or a mesh.

``gdca(filename, **kwargs)`` mirrors ``gaussdca_tpu.gdca`` (the reference
``gDCA``): FASTA -> (dedup) -> reweighting -> weighted frequencies ->
pseudocount -> covariance -> Cholesky inverse -> FN or DI scores -> APC ->
min-separation ranking. The host does ingest and dedup; everything
after runs on ``cfg.device`` as eager PyTorch around the two
hand-written kernels (``ops.distance.row_stats``,
``ops.di_kernel.di_pairs``), the ranking's sort included (only the
sorted columns reach the host, which builds the list); ``top_k``
selects the head of the ranking on the device. With ``mesh=`` the same
pipeline runs sharded over a grid of devices (``parallel/sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.core.runtime import full_f32_matmuls
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.parallel.mesh import Mesh, make_mesh, make_pod_mesh
from gaussdca_tpu_torch.score.apc import correct_apc
from gaussdca_tpu_torch.score.di import di_score
from gaussdca_tpu_torch.score.frob import frob_score
from gaussdca_tpu_torch.score.rank import (Ranking, compute_ranking,
                                           printrank, top_k_device)
from gaussdca_tpu_torch.solve.cholesky import (NOT_POSITIVE_DEFINITE,
                                              solve_steps, spd_inverse)
from gaussdca_tpu_torch.stats import reweight
from gaussdca_tpu_torch.stats.frequencies import (frequency_chunk,
                                                   weighted_frequencies)
from gaussdca_tpu_torch.stats.pseudocount import add_pseudocount, compute_C
from gaussdca_tpu_torch.utils.log import dtype_name, span

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


def scores_pipeline(Z: torch.Tensor, q: int, cfg: GDCAConfig):
    """Device pipeline: tokens Z [M, N] (on the run's device) -> the
    APC-corrected score matrix S [N, N], the resolved theta and Meff.
    Each stage is a span (``utils.log``): "reweight", "frequencies",
    "covariance", "solve", "score" and "apc"."""
    dtype = cfg.resolve_dtype()
    dt = dtype_name(dtype)
    dev = Z.device
    M, N = Z.shape
    theta = "auto" if cfg.auto_theta else float(cfg.theta)
    with span("reweight", dev, M=M, N=N, q=q):
        W, _, th = reweight.compute_weights_streaming(Z, theta, q,
                                                      dtype=dtype)
    with span("frequencies", dev, M=M, N=N, q=q, dtype=dt):
        Pi_t, Pij_t, meff = weighted_frequencies(
            Z, W, q, dtype=dtype, m_chunk=frequency_chunk(M, N, q, dtype))
    with span("covariance", dev):
        Pi, Pij = add_pseudocount(Pi_t, Pij_t, cfg.pseudocount, q)
        # drop each (N s)^2 buffer as soon as it is consumed: at N s = 20000
        # every one is 1.6 GB in f32
        del Pi_t, Pij_t
        C = compute_C(Pi, Pij)
        del Pi, Pij
    Ns = C.shape[0]
    with span("solve", dev, Ns=Ns, dtype=dt, **solve_steps(Ns)):
        mJ = spd_inverse(C)
    with span("score", dev, score=cfg.score, N=N, q=q, dtype=dt):
        if cfg.score == "DI":
            S = di_score(mJ, C, q)
        else:
            S = frob_score(mJ, q)
    with span("apc", dev):
        S = correct_apc(S)
    return S, th, meff


def _checked_ranking(S: torch.Tensor, min_separation: int,
                     top_k: Optional[int] = None) -> Ranking:
    """Rank S where it lies, refusing to emit a solver-poisoned
    (non-finite) ranking (the reference fails with PosDefException there).
    ``top_k``: only the k best pairs. A NaN anywhere reaches every score
    through APC; a partial NaN sorts first in ``torch.sort`` and
    ``torch.topk`` (last in the host sort of an ndarray), so the two
    endpoint scores suffice. The ``wait`` span holds the host's wait for
    the queued pipeline (nothing else synchronizes), so ``rank`` holds
    the ranking alone; its ``sorted_on`` is the device type of the
    sort."""
    if top_k is not None:
        with span("topk", S.device):
            R = top_k_device(S, min_separation, top_k)
    else:
        with span("wait"):
            if S.device.type == "cuda":
                torch.cuda.current_stream(S.device).synchronize()
        with span("rank", S.device) as sp:
            R = compute_ranking(S, min_separation)
            sp.set(pairs=len(R), sorted_on=S.device.type)
    if R and not (np.isfinite(R[0][2]) and np.isfinite(R[-1][2])):
        raise ArithmeticError(NOT_POSITIVE_DEFINITE)
    return R


def resolve_mesh(mesh, device=None) -> Mesh:
    """Normalize a ``mesh`` argument: Mesh | "auto" | (dp, tp) -> Mesh.

    In a joined process group of more than one process (the pod) "auto"
    is one shard a process and a shape is split evenly over the
    processes (``make_pod_mesh``: ValueError when the world size does
    not divide it), each process's shards on ``device`` (default: the
    card ``rank % count``). Otherwise "auto" and a shape take the visible
    CUDA cards and raise when there are too few."""
    if isinstance(mesh, Mesh):
        return mesh
    auto = isinstance(mesh, str) and mesh == "auto"
    shape = isinstance(mesh, (tuple, list)) and len(mesh) == 2
    if not (auto or shape):
        raise ValueError(
            f"invalid mesh: {mesh!r} (expected a "
            "gaussdca_tpu_torch.parallel.mesh.Mesh, 'auto', "
            "or a (data, model) shape tuple)")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return make_pod_mesh(None if auto else mesh,
                             "cuda" if device is None else device)
    if auto:
        return make_mesh()
    return make_mesh(int(mesh[0]) * int(mesh[1]),
                     shape=(int(mesh[0]), int(mesh[1])))


def gdca_from_msa(msa: fasta.MSA, cfg: GDCAConfig,
                  top_k: Optional[int] = None,
                  mesh: Any = None) -> GDCAResult:
    """Run the device pipeline + ranking on an already-ingested MSA.

    ``top_k``: return only the k best pairs, selected on the device
    (``torch.topk``), so the [N, N] score matrix never leaves it.

    ``mesh``: a ``Mesh``, a ``(dp, tp)`` shape or "auto" (every visible
    card) runs the sharded pipeline over it instead of ``cfg.device``
    (whose type must match the mesh's devices). Results match the
    single-device run to floating-point summation order. In a joined
    process group every process calls this with the same MSA and a
    pod mesh (``resolve_mesh``): each holds the whole padded token matrix
    and its own shards, and each gets the same ranking."""
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

        mesh = resolve_mesh(mesh, cfg.resolve_device())
        if mesh.home.type != cfg.resolve_device().type:
            raise ValueError(
                f"mesh on {mesh.home.type} devices but device="
                f"{cfg.device!r}: pass a matching device")
        Z = pad_rows(torch.as_tensor(msa.tokens), mesh.size)
        with full_f32_matmuls():
            S, th, meff = sharded_scores(mesh, Z, cfg, q, m_true=msa.M)
    else:
        dev = cfg.resolve_device()
        with span("upload", dev):
            Z = torch.as_tensor(msa.tokens, device=dev)
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
