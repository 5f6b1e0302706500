"""Peaks of the card and the work each measured layer needs.

The work is counted from the shapes of a call and is the same whatever
implements the layer: the least that the layer's function needs in its
formulation as products on the card's units, symmetry used wherever the
function has it. It is frozen here, so a later change to the program
cannot move it. A layer's least time is the larger of its
operations over the peak rate and its bytes over the memory rate, each
input byte read once and each output byte written once. Its share of the
roofline is the sum of its calls' least times over the device time of
the kernels those calls launched (``trace.layer_device_s``).

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without
sparsity, at the 700 W power limit (the run records the card's limit).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
# CUDA-core float32, and float64 on the tensor cores (DGEMM)
FLOAT_FLOPS_S = {"float32": 67e12, "float64": 67e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def di_pair_flops(s: int) -> float:
    """One pair's DI, 1/2 sum_k log((1 + sqrt(1 + 4 l_k)) / 2) over the
    eigenvalues l_k of rho rho^T, rho = L_i^T J_ij L_j: the two products
    of a triangular and a full s x s block (s^2 (s + 1) each), the
    symmetric product rho rho^T (s^2 (s + 1)) and the eigenvalues of an
    s x s symmetric matrix by its tridiagonal reduction (4 s^3 / 3); the
    tridiagonal iteration's O(s^2) is left out. No iterative square root
    (the port's Newton-Schulz steps) is counted: that is the
    implementation's choice."""
    return 3.0 * s * s * (s + 1) + 4.0 * s ** 3 / 3.0


def work(layer: str, call: Dict) -> Tuple[float, float, float]:
    """(operations, their peak rate, bytes) of one call of ``layer``;
    ``call`` holds its shapes (M, N, q, Ns, dtype)."""
    dt = call.get("dtype", "float32")
    size = ITEMSIZE[dt]
    if layer == "reweight":
        M, N, q = call["M"], call["N"], call["q"]
        # int8 one-hot products over one triangle of the symmetric M x M
        # match counts, 2 N q operations a pair: M^2 N q
        return float(M) * M * N * q, INT8_OPS_S, M * N + 8.0 * M
    if layer == "frequencies":
        M, N, q = call["M"], call["N"], call["q"]
        Ns = N * (q - 1)
        # Pij = sum_m w_m e_m e_m^T is symmetric: a rank-M update of one
        # triangle (SYRK), M Ns (Ns + 1) operations
        return (float(M) * Ns * (Ns + 1), FLOAT_FLOPS_S[dt],
                M * N + size * (M + Ns + float(Ns) * Ns))
    if layer == "solve":
        Ns = call["Ns"]
        # Cholesky (Ns^3 / 3) and the inverse from it (2 Ns^3 / 3)
        return float(Ns) ** 3, FLOAT_FLOPS_S[dt], 2.0 * size * Ns * Ns
    if layer == "di":
        N, q = call["N"], call["q"]
        s = q - 1
        P = N * (N - 1) // 2
        # every pair, and the Cholesky factor of each site's block of C
        # (s^3 / 3); read once: the pairs' blocks of mJ and the sites'
        # blocks of C; written: S [N, N]
        return (P * di_pair_flops(s) + N * s ** 3 / 3.0, FLOAT_FLOPS_S[dt],
                size * (float(P) * s * s + N * s * s + N * N))
    raise KeyError(f"no work count for layer {layer!r}")


def least_seconds(layer: str, call: Dict) -> float:
    ops, rate, nbytes = work(layer, call)
    return max(ops / rate, nbytes / HBM_BYTES_S)


def share_pct(layer: str, calls, device_s: float) -> Optional[float]:
    """Percent of the roofline over ``calls`` (each one call's shapes),
    which took ``device_s`` of kernel time; None without calls or time."""
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(least_seconds(layer, c) for c in calls) / device_s
