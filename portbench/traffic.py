"""The one generator of every traffic mix: a pool of protein families,
written as gzipped FASTA files.

A mix (``traffic/<name>.json``) gives the number of families, how their
sizes are drawn, the alignment model and the batch command's options::

    {"families": 64,
     "M": {"log_uniform": [1000, 20000]}, "N": {"uniform": [50, 275]},
     "size_seed": 1, "q": 21, "mutation": 0.3, "founder_every": 32,
     "gzip_level": 6, "cli": {"prefetch": true, "top_k": null}}

A size is ``{"fixed": v}``, ``{"uniform": [lo, hi]}`` or
``{"log_uniform": [lo, hi]}`` (whole numbers, both ends included), drawn
from ``size_seed`` alone: every run seed gets the same set of sizes, in
an order and with contents of its own. A family is M mutated copies of
M // founder_every random founders over states 1..q (each site replaced
by a uniform state with probability ``mutation``; state q is present, so
the alphabet is exactly 1..q), the model of the port's real-size smoke
families.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gzip
import os
from typing import Dict, List, Tuple

import numpy as np

# states 1..20 are the amino acids in alphabetical order, 21 the gap
ALPHABET = b"ACDEFGHIKLMNPQRSTVWY-"


@dataclasses.dataclass(frozen=True)
class Family:
    path: str
    M: int
    N: int


def family_tokens(M: int, N: int, q: int, rng: np.random.Generator,
                  mutation: float = 0.3, founder_every: int = 32
                  ) -> np.ndarray:
    """uint8 [M, N]: mutated copies of M // founder_every founders."""
    founders = rng.integers(1, q + 1, size=(max(1, M // founder_every), N),
                            dtype=np.uint8)
    Z = founders[rng.integers(0, founders.shape[0], size=M)]
    hit = rng.random((M, N)) < mutation
    Z = np.where(hit, rng.integers(1, q + 1, size=(M, N), dtype=np.uint8), Z)
    Z[0, 0] = q
    return Z.astype(np.uint8)


def write_fasta_gz(path: str, tokens: np.ndarray, level: int = 6) -> None:
    """A gzipped FASTA file of the token matrix, one line a sequence."""
    rows = np.frombuffer(b"?" + ALPHABET, dtype=np.uint8)[tokens]
    text = b"".join(b">s%d\n%s\n" % (i, rows[i].tobytes())
                    for i in range(rows.shape[0]))
    with open(path, "wb") as fh:
        # no time stamp in the header, so a seed writes the same bytes
        fh.write(gzip.compress(text, compresslevel=level, mtime=0))


def _draw(spec: Dict, rng: np.random.Generator, n: int) -> np.ndarray:
    (kind, value), = spec.items()
    if kind == "fixed":
        return np.full(n, int(value), dtype=np.int64)
    lo, hi = (int(v) for v in value)
    if kind == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if kind == "log_uniform":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
        return np.clip(np.floor(x).astype(np.int64), lo, hi)
    raise ValueError(f"unknown size distribution {kind!r}")


def family_sizes(traffic: Dict) -> List[Tuple[int, int]]:
    """The mix's (M, N) of each family, the same for every run seed."""
    rng = np.random.default_rng(int(traffic["size_seed"]))
    n = int(traffic["families"])
    Ms, Ns = _draw(traffic["M"], rng, n), _draw(traffic["N"], rng, n)
    return [(int(m), int(k)) for m, k in zip(Ms, Ns)]


def make_pool(traffic: Dict, seed: int, directory: str) -> List[Family]:
    """Write the mix's families for ``seed`` into ``directory``: the
    sizes of ``family_sizes`` in the seed's order, each family's contents
    from (seed, its place)."""
    os.makedirs(directory, exist_ok=True)
    sizes = family_sizes(traffic)
    streams = np.random.SeedSequence(int(seed) % 2 ** 64).spawn(
        len(sizes) + 1)
    order = np.random.default_rng(streams.pop(0)).permutation(len(sizes))

    def one(k: int) -> Family:
        M, N = sizes[order[k]]
        tokens = family_tokens(
            M, N, int(traffic["q"]), np.random.default_rng(streams[k]),
            float(traffic["mutation"]), int(traffic["founder_every"]))
        path = os.path.join(directory, f"fam{k:03d}.fasta.gz")
        write_fasta_gz(path, tokens, int(traffic["gzip_level"]))
        return Family(path, M, N)

    # zlib and NumPy's generators leave the interpreter lock while they
    # work, so a few threads shorten the set-up
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(one, range(len(sizes))))
