#!/usr/bin/env python3
"""Split the time of kernels E (row_stats_asym.cu) and F (row_stats_e8.cu)
on one NVIDIA GPU, with no profiler.

    python3 scripts/torch_kernel_split.py [--reps 5] [--check-only]

Each kernel's source is copied and edited into variants, built with the
package's nvcc flags into ``gaussdca_tpu_torch/_build/split/`` and
launched through the same C entry point as the package's wrapper:

- ``full``: the kernel as it is;
- ``mma``: the tensor-core loop on constant stages (E: the producer
  stores nothing and the consumers take raw words as their fragments; F:
  the producer arrives without loading);
- ``feed``: the operand feed with no ``wgmma`` (E: the expansions; F: the
  TMA loads);
- ``wait0``: no ``wgmma`` group left in flight (``wait_group 0``);
- E ``roll1``: its stage loop not unrolled, so one fragment set serves
  the group in flight and the next;
- E ``sps1``: one state a stage (one handshake a state, 16 stages);
- F ``nogroup``, ``group1``, ``group4``: the tiles walked row after row
  with no column groups, or in groups of 1 or 4 column tiles (not 2).

First every package kernel is held against kernel A (exact equality) at a
few shapes and at M=32768, N=384, q=21; then the variants are timed there
(CUDA events, median of ``--reps``), with ``nvidia-smi`` clocks and power
sampled beside each timed window, and ptxas's report of each build. Needs
a CUDA device and nvcc; exits 1 without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (kernel, variant) -> [(text in the source, replacement)]; each text must
# occur exactly once
E_MMA_STORES = """            dst[0] = make_uint4(equal80(cur0.x, cc), equal80(cur0.y, cc),
                                equal80(cur0.z, cc), equal80(cur0.w, cc));
            dst[8] = make_uint4(equal80(cur1.x, cc), equal80(cur1.y, cc),
                                equal80(cur1.z, cc), equal80(cur1.w, cc));
"""
F_LOADS = """          pipe::mbar_arrive_expect_tx(&full[stage], STAGE_BYTES);
          tma_load(&map, sA, &full[stage], kb * BK, ti * BM);
          tma_load(&map, sB, &full[stage], kb * BK, tj * BN);
          tma_load(&map, sB + BM * BK, &full[stage], kb * BK, tj * BN + BM);
"""
VARIANTS = {
    ("row_stats_asym", "full"): [],
    ("row_stats_asym", "mma"): [
        (E_MMA_STORES, "            (void)dst;\n"),
        ("a[u][h][i] = equal80(x[h][i], cc);", "a[u][h][i] = x[h][i];"),
    ],
    ("row_stats_asym", "feed"): [
        ("          onehot::wgmma_s8(d[0], a[u][0], desc[u]);\n"
         "          onehot::wgmma_s8(d[1], a[u][1], desc[u]);\n",
         "          asm volatile(\"\" :: \"r\"(a[u][0][0] ^ a[u][0][1] ^ "
         "a[u][0][2] ^ a[u][0][3] ^ a[u][1][0] ^ a[u][1][1] ^ a[u][1][2] ^ "
         "a[u][1][3]), \"l\"(desc[u]));\n"),
    ],
    # E with one state a stage (a handshake a state), and with no wgmma
    # group left in flight
    ("row_stats_asym", "sps1"): [
        ("constexpr int SPS = 3;", "constexpr int SPS = 1;"),
        ("constexpr int STAGES = 6;", "constexpr int STAGES = 16;"),
    ],
    ("row_stats_asym", "wait0"): [
        ("#pragma unroll 2\n      for (int it = 0; it < nsteps; ++it) {\n",
         "      for (int it = 0; it < nsteps; ++it) {\n"),
        ("        pipe::wgmma_wait<1>();\n", "        pipe::wgmma_wait<0>();\n"),
    ],
    # E with its stage loop not unrolled: wait_group 1 on one fragment set
    ("row_stats_asym", "roll1"): [
        ("#pragma unroll 2\n      for (int it = 0; it < nsteps; ++it) {\n",
         "#pragma unroll 1\n      for (int it = 0; it < nsteps; ++it) {\n"),
    ],
    ("row_stats_e8", "full"): [],
    ("row_stats_e8", "wait0"): [
        ("        pipe::wgmma_wait<1>();\n", "        pipe::wgmma_wait<0>();\n"),
    ],
    # F walking its tiles row after row, with no column groups
    ("row_stats_e8", "nogroup"): [
        ("constexpr int GROUP = 2;", "constexpr int GROUP = 1 << 20;"),
    ],
    ("row_stats_e8", "group1"): [
        ("constexpr int GROUP = 2;", "constexpr int GROUP = 1;"),
    ],
    ("row_stats_e8", "group4"): [
        ("constexpr int GROUP = 2;", "constexpr int GROUP = 4;"),
    ],
    ("row_stats_e8", "mma"): [
        (F_LOADS, "          pipe::mbar_arrive(&full[stage]);\n"
                  "          (void)sB;\n"),
    ],
    ("row_stats_e8", "feed"): [
        ("          wgmma_s8_ss(d, da + 2 * kk, db + 2 * kk);   // +32 bytes "
         "of K\n",
         "          asm volatile(\"\" :: \"l\"(da + 2 * kk), \"l\"(db));\n"),
    ],
}


def variant_source(name: str, variant: str) -> str:
    from gaussdca_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as fh:
        src = fh.read()
    for old, new in VARIANTS[(name, variant)]:
        n = src.count(old)
        src = src.replace(old, new)
        if n != 1:
            raise RuntimeError(f"{name} {variant}: the edit matched {n} times")
    return src


def build_variant(name: str, variant: str) -> tuple:
    from gaussdca_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}-{variant}.cu")
    with open(src, "w") as fh:
        fh.write(variant_source(name, variant))
    lib = src[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC_DIR, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    report = [line.split(":", 1)[-1].strip()
              for line in (proc.stdout + proc.stderr).splitlines()
              if "registers" in line or "spill" in line or "wgmma" in line
              or "setmaxnreg" in line]
    return lib, report


def smi() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                        "power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "?"


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tokens(M, N, q, seed):
    rng = np.random.default_rng(seed)
    founders = rng.integers(1, q + 1, size=(max(1, M // 32), N),
                            dtype=np.uint8)
    Z = founders[rng.integers(0, founders.shape[0], size=M)]
    hit = rng.random((M, N)) < 0.3
    return np.where(hit, rng.integers(1, q + 1, size=(M, N), dtype=np.uint8),
                    Z).astype(np.uint8)


def check(dev) -> None:
    """E and F equal kernel A exactly, tokens 1..31 at q = 9, 21, 31."""
    import torch
    from gaussdca_tpu_torch.ops import distance

    for M, N in [(1, 40), (63, 40), (129, 53), (300, 40), (777, 250),
                 (1000, 53), (2000, 700), (4096, 384), (32768, 384)]:
        Z = torch.as_tensor(tokens(M, N, 31, seed=M + N), device=dev)
        for q in (9, 21, 31):
            for frac in (0.0, 0.2, 0.7):
                t = float(np.floor(frac * N))
                A = distance.row_stats(Z, t, q)
                E = distance.row_stats_asym(Z, t, q)
                F = distance.row_stats_sym_e8(Z, t, q)
                torch.cuda.synchronize()
                for got, what in ((E, "row_stats_asym"),
                                  (F, "row_stats_sym_e8")):
                    for g, w, stat in zip(got, A, ("rowsum", "below")):
                        if not torch.equal(g, w):
                            bad = int((g != w).sum())
                            raise AssertionError(
                                f"{what} {stat} != row_stats at M={M} N={N} "
                                f"q={q} t={t}: {bad} rows, e.g. "
                                f"{g[g != w][:4].tolist()} vs "
                                f"{w[g != w][:4].tolist()}")
        print(f"[check] E, F == A at M={M} N={N} (k={distance.plan_asym(N)})"
              ", q 9 / 21 / 31, t 0 / 0.2 N / 0.7 N", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_split: no CUDA device")
        return 1
    from gaussdca_tpu_torch.ops import distance

    dev = torch.device("cuda", 0)
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    print(f"[device] {p.stdout.strip()}", flush=True)
    check(dev)
    if args.check_only:
        return 0
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build_variant(*kv),
                                           VARIANTS)))
    for (name, variant), (_, report) in libs.items():
        for line in report:
            print(f"[ptxas] {name} {variant}: {line}", flush=True)

    M, N, q = 32768, 384, 21
    Z = torch.as_tensor(tokens(M, N, q, seed=1), device=dev)
    t = float(np.floor(0.2 * N))
    words = distance.pack_tokens(Z, q)
    planes = distance.one_hot_planes(Z, q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = distance.plan_asym_chunks(M, sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    rs = torch.zeros(M, dtype=torch.int64, device=dev)
    bl = torch.zeros(M, dtype=torch.int64, device=dev)
    calls = {}
    for (name, variant), (lib, _) in libs.items():
        cdll = ctypes.CDLL(lib)
        if name == "row_stats_asym":
            fn = cdll.gdca_row_stats_asym
            fn.argtypes = [P, I, I, I, F, I, I, P, P, P]
            args_ = (words.data_ptr(), M, words.shape[1], N, t, q, chunks,
                     rs.data_ptr(), bl.data_ptr(), stream)
        else:
            fn = cdll.gdca_row_stats_e8
            fn.argtypes = [P, I, I, I, F, P, P, P]
            args_ = (planes.data_ptr(), M, planes.shape[1], N, t,
                     rs.data_ptr(), bl.data_ptr(), stream)
        fn.restype = I

        def call(fn=fn, args_=args_, what=(name, variant)):
            err = fn(*args_)
            if err:
                raise RuntimeError(f"{what}: CUDA error {err}")
        calls[(name, variant)] = call
    ms = {}
    for key, call in calls.items():
        before = smi()
        ms[key] = cuda_ms(call, args.reps)
        print(f"[split] {key[0]} {key[1]} at M={M} N={N} q={q}: "
              f"{ms[key]:.3f} ms (nvidia-smi clocks.sm, power.draw, "
              f"power.limit before / after: {before} / {smi()})", flush=True)
    # the full variants reproduce the package kernels' results
    A = distance.row_stats(Z, t, q)
    for name in ("row_stats_asym", "row_stats_e8"):
        rs.zero_()
        bl.zero_()
        calls[(name, "full")]()
        torch.cuda.synchronize()
        if not (torch.equal(rs.float(), A[0]) and torch.equal(bl.float(),
                                                             A[1])):
            raise AssertionError(f"{name} full variant != row_stats")
    print("[split] full variants == row_stats", flush=True)
    # kernel D beside one int8 library product of the one-hot operands
    D = distance.match_counts(Z, q)
    states = torch.arange(1, q + 1, dtype=torch.uint8, device=dev)

    def int_mm():
        E = (Z[:, :, None] == states).reshape(M, -1).to(torch.int8)
        return torch._int_mm(E, E.T)
    same = torch.equal(int_mm(), D)
    del D
    print(f"[split] match_counts {cuda_ms(lambda: distance.match_counts(Z, q), args.reps):.3f} ms, "
          f"torch._int_mm on the one-hot {cuda_ms(int_mm, args.reps):.3f} ms"
          f" (equal: {same})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
