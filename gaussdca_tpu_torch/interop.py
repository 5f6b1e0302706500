"""Carry the JAX package's state into the port.

This system has no weights: an ingested alignment and a configuration are
the whole state. Both cross over as plain data (numpy arrays and a dict),
so nothing here imports JAX:

- ``msa_from_arrays`` rebuilds an MSA from the token matrix and metadata
  of a ``gaussdca_tpu.io.fasta.MSA``;
- ``config_from_reference`` builds a ``GDCAConfig`` from
  ``dataclasses.asdict`` of a ``gaussdca_tpu.core.config.GDCAConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import numpy as np

from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.io.fasta import MSA

_SHARED_FIELDS = ("pseudocount", "theta", "max_gap_fraction", "score",
                  "min_separation", "remove_dups", "solve_min_dim",
                  "solve_block")

# fields of the reference config this port does not support yet, with the
# only value it accepts for each (the reference default)
_UNSUPPORTED_DEFAULTS = {
    "force_fallback": False,
    "precision": "highest",  # the port always runs full-f32 matmuls
    "m_bucket": 0,
    "n_bucket": 0,
}


def msa_from_arrays(tokens: np.ndarray, q: int, headers: Sequence[str],
                    n_dropped_gaps: int = 0, n_dropped_dups: int = 0) -> MSA:
    """An MSA from a uint8 [M, N] token matrix (states 1..q) and its
    metadata."""
    tokens = np.ascontiguousarray(tokens, dtype=np.uint8)
    if tokens.ndim != 2 or len(headers) != tokens.shape[0]:
        raise ValueError(
            f"tokens {tokens.shape} and {len(headers)} headers disagree")
    return MSA(tokens=tokens, headers=list(headers), q=int(q),
               n_dropped_gaps=int(n_dropped_gaps),
               n_dropped_dups=int(n_dropped_dups))


def config_from_reference(fields: Dict[str, Any]) -> GDCAConfig:
    """A port config from the reference config's fields. Raises
    ValueError on a field the port does not know, or does not support
    yet and is set to a non-default value. The reference ``dtype`` maps
    over when set (None keeps the port default, float32); the device
    stays the port default ("cuda") — use ``dataclasses.replace`` to
    change it."""
    kw = {}
    for name, value in fields.items():
        if name in _SHARED_FIELDS:
            kw[name] = value
        elif name == "dtype":
            if value is not None:
                kw["dtype"] = np.dtype(value).name
        elif name in _UNSUPPORTED_DEFAULTS:
            if value != _UNSUPPORTED_DEFAULTS[name]:
                raise ValueError(
                    f"reference config field {name}={value!r} is not "
                    "supported by gaussdca_tpu_torch yet (only "
                    f"{_UNSUPPORTED_DEFAULTS[name]!r})")
        else:
            raise ValueError(f"unknown reference config field {name!r}")
    cfg = GDCAConfig(**kw)
    return dataclasses.replace(cfg, dtype=cfg.resolve_dtype())
