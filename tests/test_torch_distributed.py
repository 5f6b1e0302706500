"""PyTorch port: family mode across processes (``--distributed``), and
the harness that launches them.

Two real processes, launched by the port's ``parallel.podspawn`` with
torchrun's environment, join a gloo group through
``parallel.mesh.init_distributed`` and split a batch of four small
families round-robin on the CPU; their merge shards together hold the
lines of a single-process merged run. The harness hosts the rendezvous
store before any child starts, several pods run at once, and every
process leaves its group before its interpreter exits.
"""

import concurrent.futures
import subprocess
import time

import numpy as np
import pytest

from gaussdca_tpu.parallel.mesh import shard_families as jax_shard_families
from gaussdca_tpu_torch import cli
from gaussdca_tpu_torch.parallel import mesh, podspawn

ARGS = ["--device", "cpu", "--quiet", "--top-k", "5", "--min-separation",
        "2"]

_CLI_CHILD = r"""
out_dir, merge, *inputs = argv

from gaussdca_tpu_torch.cli import main

rc = main(inputs + ["-o", out_dir, "--distributed", "--merge-output",
                    merge] + %r)
print(f"CLI-RC p{rank} {rc}", flush=True)
""" % (ARGS,)


def _families(tmp_path):
    rng = np.random.default_rng(0)
    inputs = []
    for k in range(4):
        lines = []
        for m in range(30):
            seq = "".join("ACDEFGHIKLMNPQRSTVWY-"[c] for c in
                          rng.integers(0, 21, size=12))
            lines.append(f">s{m}\n{seq}\n")
        p = tmp_path / f"fam{k}.fasta"
        p.write_text("".join(lines))
        inputs.append(str(p))
    return inputs


def test_cli_family_mode_two_processes(tmp_path):
    inputs = _families(tmp_path)
    out_dir = tmp_path / "out"
    merge = tmp_path / "merged.txt"
    outs = podspawn.spawn_pod(
        _CLI_CHILD, timeout=240,
        args_per_proc=lambda i: [str(out_dir), str(merge), *inputs])
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {i} failed:\n{out}\n{err}"
        assert f"CLI-RC p{i} 0" in out, (out, err)
    assert not merge.exists()
    parts = [(tmp_path / f"merged.txt.part{i}of2").read_text().splitlines()
             for i in range(2)]
    assert {ln.split()[0] for ln in parts[0]} == {"fam0", "fam2"}
    assert {ln.split()[0] for ln in parts[1]} == {"fam1", "fam3"}
    for k in range(4):
        assert len((out_dir / f"fam{k}.rank.txt").read_text()
                   .splitlines()) == 5

    single = tmp_path / "single.txt"
    assert cli.main(inputs + ["-o", str(tmp_path / "one"), "--merge-output",
                              str(single), *ARGS]) == 0
    want = single.read_text().splitlines()
    assert sorted(parts[0] + parts[1]) == sorted(want) and len(want) == 20
    by_family = {}
    for ln in want:
        by_family.setdefault(ln.split()[0], []).append(ln)
    for i in range(2):
        assert parts[i] == by_family[f"fam{i}"] + by_family[f"fam{i + 2}"]


def test_init_distributed_without_rendezvous(monkeypatch):
    """Unconfigured: the single-process run, or with force an error from
    torch's env:// rendezvous (never a silent single-process run)."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed() == (0, 1)
    with pytest.raises(ValueError, match="RANK"):
        mesh.init_distributed(force=True)
    assert mesh.shard_families(["a", "b", "c"]) == ["a", "b", "c"]


@pytest.mark.parametrize("n,count", [(7, 2), (7, 3), (2, 4), (0, 2), (5, 1)])
def test_shard_families_matches_jax(n, count):
    paths = [f"f{k}" for k in range(n)]
    shards = [mesh.shard_families(paths, p, count) for p in range(count)]
    assert shards == [jax_shard_families(paths, p, count)
                      for p in range(count)]
    assert sorted(sum(shards, [])) == sorted(paths)


def test_spawn_pod_kills_on_timeout():
    t0 = time.perf_counter()
    with pytest.raises(subprocess.TimeoutExpired):
        podspawn.spawn_pod("import time\ntime.sleep(600)\n", timeout=3)
    assert time.perf_counter() - t0 < 60


def test_spawn_pod_environment():
    body = ("import os\n"
            "print(rank, argv, os.environ['RANK'], os.environ['WORLD_SIZE'],"
            " os.environ['MASTER_ADDR'])\n")
    outs = podspawn.spawn_pod(body, n_processes=3, timeout=60,
                              args_per_proc=lambda i: ["x", i])
    assert [o[1].split() for o in outs] == [
        [str(i), f"['x',", f"'{i}']", str(i), "3", "localhost"]
        for i in range(3)]
    assert all(o[0] == 0 for o in outs)


_PORT_CHILD = r"""
import os
import socket

port = int(os.environ["MASTER_PORT"])
# before this process imports torch or binds anything
with socket.create_connection(("localhost", port), timeout=10):
    pass
print("listening", port, os.environ["TORCHELASTIC_USE_AGENT_STORE"],
      os.environ["OMP_NUM_THREADS"])
"""


def test_spawn_pod_store_listens_before_the_children_start():
    """The rendezvous port is listening before any child starts: a port
    chosen, released and bound later by rank 0 could be taken in between
    by another process. Each child also gets the thread count asked for
    and joins torchrun's agent store as a client."""
    outs = podspawn.spawn_pod(_PORT_CHILD, n_processes=3, timeout=60,
                              threads=1)
    assert all(rc == 0 for rc, _, _ in outs), outs
    lines = {out.strip() for _, out, _ in outs}
    assert len(lines) == 1
    word, port, agent, threads = lines.pop().split()
    assert (word, agent, threads) == ("listening", "True", "1")
    assert 0 < int(port) < 65536


_JOIN_CHILD = r"""
import atexit

import torch
import torch.distributed as dist

# registered before the group is joined, so it runs after any exit hook
# that joining registers
atexit.register(lambda: print("joined at exit:", dist.is_initialized(),
                              flush=True))
from gaussdca_tpu_torch.parallel import mesh

assert mesh.init_distributed(force=True, device="cpu") == (rank, 2)
t = torch.tensor([rank + 1.0])
dist.all_reduce(t)
print("sum", float(t), flush=True)
"""


def test_concurrent_pods_join_and_leave_their_groups():
    """Four pods of two processes at once, each through
    ``init_distributed``'s rendezvous and a gloo all-reduce: every child
    succeeds and leaves its group before its interpreter exits (a
    process that exits with its group joined can abort in torch's
    teardown)."""
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        runs = list(ex.map(lambda _: podspawn.spawn_pod(
            _JOIN_CHILD, timeout=120, threads=1), range(4)))
    for outs in runs:
        for rc, out, err in outs:
            assert rc == 0, err
            assert out.split("\n")[:2] == ["sum 3.0", "joined at exit: False"]
