"""ctypes bindings for the native C++ FASTA parser (``csrc/fasta_native.cpp``).

The library is built with g++ on first use into the git-ignored
``gaussdca_tpu_torch/_build/`` (``ops._build.build_host``: with libdeflate
and zlib, else with zlib alone), under a lock, because the CLI's prefetch
thread and its main thread can both be the first to parse. A failed build
is remembered with g++'s output (``build_error``) and not retried in the
process. ctypes releases the interpreter lock during the foreign call, so
a parse on the prefetch thread overlaps the device work of the main
thread.

Same tokens, headers, q, drop count and error texts as the NumPy parser of
``io/fasta.py``; tests/test_torch_native_io.py holds the two (and the JAX
package's parser) equal.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from gaussdca_tpu_torch.ops import _build

# (defines, libraries) tried in order: libdeflate inflates gzip ~2.3x
# faster than zlib; the source falls back to zlib alone under
# GDCA_NO_LIBDEFLATE
BUILD_VARIANTS = (((), ("-ldeflate", "-lz")),
                  (("-DGDCA_NO_LIBDEFLATE",), ("-lz",)))


class _Library:
    """The loaded parser, or the reason it could not be built."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._error: Optional[str] = None

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self._lib = _bind(ctypes.CDLL(
                        _build.build_host("fasta_native", BUILD_VARIANTS)))
                except (RuntimeError, OSError) as e:
                    self._error = str(e)
            return self._lib

    def error(self) -> Optional[str]:
        self.load()
        return self._error


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gdca_parse.restype = ctypes.c_void_p
    lib.gdca_parse.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.gdca_msa_error.restype = ctypes.c_char_p
    lib.gdca_msa_error.argtypes = [ctypes.c_void_p]
    for f in ("gdca_msa_m", "gdca_msa_n"):
        getattr(lib, f).restype = ctypes.c_int64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    for f in ("gdca_msa_q", "gdca_msa_dropped"):
        getattr(lib, f).restype = ctypes.c_int32
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.gdca_msa_tokens.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.gdca_msa_tokens.argtypes = [ctypes.c_void_p]
    lib.gdca_msa_header.restype = ctypes.c_char_p
    lib.gdca_msa_header.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gdca_msa_headers_blob.restype = ctypes.c_char_p
    lib.gdca_msa_headers_blob.argtypes = [ctypes.c_void_p]
    lib.gdca_msa_free.restype = None
    lib.gdca_msa_free.argtypes = [ctypes.c_void_p]
    return lib


_LIBRARY = _Library()


def available() -> bool:
    """Whether the parser builds (or is built) and loads."""
    return _LIBRARY.load() is not None


def build_error() -> Optional[str]:
    """g++'s output when the parser does not build, else None."""
    return _LIBRARY.error()


def parse_fasta(path: str, max_gap_fraction: float
                ) -> Tuple[np.ndarray, List[str], int, int]:
    """(tokens [M, N] uint8, headers, q, n_dropped). Raises ValueError on
    a parse error (the NumPy parser's texts) and RuntimeError, with g++'s
    output, when the library does not build."""
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"native FASTA parser unavailable: "
                           f"{_LIBRARY.error()}")
    # fsencode, not str.encode: surrogate-escaped (non-UTF-8) filesystem
    # paths must reach the C side as their original bytes
    h = lib.gdca_parse(os.fsencode(path), float(max_gap_fraction))
    if not h:
        raise MemoryError(f"native FASTA parser: no memory for {path}")
    try:
        err = lib.gdca_msa_error(h)
        if err:
            raise ValueError(err.decode())
        M = lib.gdca_msa_m(h)
        N = lib.gdca_msa_n(h)
        buf = ctypes.cast(lib.gdca_msa_tokens(h),
                          ctypes.POINTER(ctypes.c_uint8 * (M * N)))
        tokens = np.frombuffer(buf.contents, dtype=np.uint8).reshape(
            M, N).copy()
        headers = None
        blob = lib.gdca_msa_headers_blob(h)
        if blob is not None:
            # "replace", matching the NumPy parser: arbitrary header
            # bytes must not raise where the other parser succeeds
            parts = blob.decode("utf-8", "replace").split("\n")
            if len(parts) == M + 1 and parts[-1] == "":
                headers = parts[:-1]
        if headers is None:   # a NUL byte truncated the blob
            headers = [lib.gdca_msa_header(h, i).decode("utf-8", "replace")
                       for i in range(M)]
        return tokens, headers, int(lib.gdca_msa_q(h)), \
            int(lib.gdca_msa_dropped(h))
    finally:
        lib.gdca_msa_free(h)
