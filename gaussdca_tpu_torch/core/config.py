"""Configuration for the PyTorch Gaussian DCA pipeline.

Same keyword arguments, defaults, bounds and error texts as
``gaussdca_tpu.core.config.GDCAConfig`` (the reference's ``check_arguments``),
plus the two run-time choices PyTorch makes explicit: ``dtype`` (default
``torch.float32``) and ``device`` (default ``"cuda"``, never auto-detected).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Union

import torch

Theta = Union[str, float, int]

_VALID_SCORES = ("frob", "DI")
_VALID_DTYPES = (torch.float32, torch.float64)


def _is_real(x: Any) -> bool:
    # numbers.Real admits numpy scalars (a parameter sweep's np.float32)
    return isinstance(x, numbers.Real) and not isinstance(x, bool)


def _is_int(x: Any) -> bool:
    return isinstance(x, numbers.Integral) and not isinstance(x, bool)


def _as_torch_dtype(dt: Any) -> torch.dtype:
    """torch.float32 / torch.float64 from a torch dtype or a name
    ("float64", np.float64, ...); raises ValueError otherwise."""
    if isinstance(dt, torch.dtype):
        out = dt
    else:
        import numpy as np

        try:
            name = np.dtype(dt).name
        except TypeError:
            raise ValueError(f"invalid dtype value: {dt!r}") from None
        out = getattr(torch, name, None)
    if out not in _VALID_DTYPES:
        raise ValueError(
            f"invalid dtype value: {dt!r} (must be float32 or float64)")
    return out


@dataclasses.dataclass(frozen=True)
class GDCAConfig:
    """Frozen pipeline configuration.

    Reference-parity fields (names, defaults and validation of ``gDCA``):
    ``pseudocount`` in [0, 1] (0.8), ``theta`` "auto" or in [0, 1],
    ``max_gap_fraction`` in [0, 1] (0.9), ``score`` "frob" or "DI",
    ``min_separation`` >= 1 (5), ``remove_dups`` (False).

    ``dtype``: compute dtype of the statistical pipeline, float32 or
    float64 (a torch dtype or its name). ``device``: where the pipeline
    runs; a CPU device runs every kernel's plain PyTorch version.

    Mesh-path solve thresholds (``parallel/sharded.py``, as in the JAX
    package): at N*s >= ``solve_min_dim`` (4096) the covariance inverse
    switches from the replicated Cholesky to the storage-sharded
    factorization with ``solve_block``-sized panels (1024). Single-device
    runs ignore both.
    """

    pseudocount: float = 0.8
    theta: Theta = "auto"
    max_gap_fraction: float = 0.9
    score: str = "frob"
    min_separation: int = 5
    remove_dups: bool = False

    solve_min_dim: int = 4096
    solve_block: int = 1024

    dtype: Any = torch.float32
    device: Any = "cuda"

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ValueError on invalid settings (the reference's bounds
        and texts; file existence is checked at ingest)."""
        pc = self.pseudocount
        if not (_is_real(pc) and 0 <= pc <= 1):
            raise ValueError(
                f"invalid pseudocount value: {pc} (must be between 0 and 1)")
        th = self.theta
        theta_ok = (th == "auto") or (_is_real(th) and 0 <= th <= 1)
        if not theta_ok:
            raise ValueError(
                f"invalid theta value: {th} "
                "(must be either 'auto', or a number between 0 and 1)")
        mgf = self.max_gap_fraction
        if not (_is_real(mgf) and 0 <= mgf <= 1):
            raise ValueError(
                f"invalid max_gap_fraction value: {mgf} "
                "(must be between 0 and 1)")
        if self.score not in _VALID_SCORES:
            raise ValueError(
                f"invalid score value: {self.score} "
                "(must be either 'DI' or 'frob')")
        if not (_is_int(self.min_separation)
                and self.min_separation >= 1):
            raise ValueError(
                f"invalid min_separation value: {self.min_separation} "
                "(must be >= 1)")
        if not (isinstance(self.solve_min_dim, int)
                and self.solve_min_dim >= 1):
            raise ValueError(
                f"invalid solve_min_dim value: {self.solve_min_dim} "
                "(must be >= 1)")
        if not (isinstance(self.solve_block, int) and self.solve_block >= 8):
            raise ValueError(
                f"invalid solve_block value: {self.solve_block} "
                "(must be >= 8)")
        self.resolve_dtype()
        self.resolve_device()

    @property
    def auto_theta(self) -> bool:
        return self.theta == "auto"

    def resolve_dtype(self) -> torch.dtype:
        return _as_torch_dtype(self.dtype)

    def resolve_device(self) -> torch.device:
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            raise ValueError(f"invalid device value: {self.device!r}") \
                from None
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(
                f"invalid device value: {self.device!r} "
                "(must be a cpu or cuda device)")
        return dev
