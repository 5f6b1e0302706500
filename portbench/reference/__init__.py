"""The plain reference of the Gaussian DCA pipeline, in NumPy and PyTorch.

Written from the method (GaussDCA.jl's ``gDCA`` and DCAUtils, Baldassi et
al. 2014) and checked against the golden rankings of ``tests/data``. It
imports nothing of the program under test and no JAX: it reads the same
FASTA files the program reads and works out every quantity again.
"""

from portbench.reference.gdca import (PRECISIONS, Ranking, read_fasta,
                                      reference_scores, reference_ranking)

__all__ = ["PRECISIONS", "Ranking", "read_fasta", "reference_scores",
           "reference_ranking"]
