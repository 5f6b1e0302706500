"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds; ``csrc/<name>.cpp`` (the FASTA parser)
is host code that ``g++`` builds (``build_host``). The shared library
lands in ``gaussdca_tpu_torch/_build/`` (git-ignored), named by a hash of
the source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs at
import time: the first call that needs a library triggers its build.
There is no fallback here: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a: Hopper with its architecture-specific features (wgmma,
# setmaxnreg) enabled; -Xptxas=-v records registers, shared memory and
# spills of every kernel in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of gaussdca_tpu_torch are built from source on first use")


def _keyed_path(stem: str, files: Sequence[str], flags: Sequence[str]) -> str:
    """``_build/<stem>-<hash>.so``, the hash over the ``csrc`` files (name
    and content) and the flags."""
    h = hashlib.sha256()
    for f in files:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    h.update("\0".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return _keyed_path(name, [name + ".cu", *headers], NVCC_FLAGS)


def _compile(argv, out: str) -> Tuple[bool, str]:
    """Run ``argv(tmp)``, a compiler command writing the library to
    ``tmp``; on success move it to ``out`` and keep the compiler's output
    beside it as ``.log``. Returns (built, the compiler's output)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(argv(tmp), capture_output=True, text=True)
        except OSError as e:
            return False, f"{argv(tmp)[0]}: {e}"
        output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return False, f"exit {proc.returncode}:\n{output}"
        with open(out[:-3] + ".log", "w") as fh:
            fh.write(output)
        os.replace(tmp, out)
        return True, output
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path. The compiler's output (with the
    ``-Xptxas=-v`` resource report) is kept beside it as ``.log``."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    src = os.path.join(CSRC_DIR, name + ".cu")
    ok, output = _compile(lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                       src], out)
    if not ok:
        raise RuntimeError(f"nvcc failed to build {src} ({output})")
    return out


GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_host(name: str, variants: Sequence[Tuple[Sequence[str],
                                                   Sequence[str]]]) -> str:
    """Compile the host source ``csrc/<name>.cpp`` with g++: ``variants``
    are (defines, libraries) pairs tried in order, each keyed by its own
    flags, so a library built by any of them is loaded as it is. Returns
    the first that exists or builds; raises RuntimeError with every
    attempt's compiler output when none does."""
    src = os.path.join(CSRC_DIR, name + ".cpp")
    cmds = [(_keyed_path(name, [name + ".cpp"],
                         (*GXX_FLAGS, *defs, *libs)), defs, libs)
            for defs, libs in variants]
    for out, _, _ in cmds:
        if os.path.isfile(out):
            return out
    errors = []
    for out, defs, libs in cmds:
        ok, output = _compile(lambda tmp: ["g++", *GXX_FLAGS, *defs, src,
                                           *libs, "-o", tmp], out)
        if ok:
            return out
        errors.append(f"g++ {' '.join((*defs, *libs))}: {output}")
    raise RuntimeError(f"g++ failed to build {src}:\n" + "\n".join(errors))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(build(name))
