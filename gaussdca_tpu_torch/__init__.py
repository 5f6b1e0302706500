"""Gaussian Direct Coupling Analysis in PyTorch, for one NVIDIA H100.

The PyTorch/CUDA port of ``gaussdca_tpu`` (which stays the reference it
is held against): the same FASTA input, configuration and ranking, with
the TPU's Pallas kernels replaced by hand-written CUDA kernels for Hopper
(``csrc/``, built with nvcc on first use). Imports torch and numpy, never
JAX.
"""

from gaussdca_tpu_torch.api import (GDCAConfig, GDCAResult, gdca,
                                    gdca_from_msa, printrank)

# Drop-in spelling for users coming from the reference (exports `gDCA`).
gDCA = gdca

__version__ = "0.1.0"

__all__ = [
    "gdca",
    "gDCA",
    "gdca_from_msa",
    "printrank",
    "GDCAConfig",
    "GDCAResult",
    "__version__",
]
