"""Launch N local processes of one job: the multi-process harness of the
tests and of ``chip_smoke.py``.

Each child runs ``CHILD_PRELUDE + body`` with torchrun's environment
contract: ``MASTER_ADDR=localhost``, ``MASTER_PORT``, ``RANK`` and
``WORLD_SIZE``, which ``torch.distributed``'s ``env://`` rendezvous reads
(``parallel.mesh.init_distributed``), and the repository on
``PYTHONPATH``. The parent hosts the rendezvous store itself, listening
on a port the system assigns, before any child starts, and sets
``TORCHELASTIC_USE_AGENT_STORE=True`` (torchrun's agent-store contract):
every rank then joins as a client, so no port is chosen, released and
bound again later, where another process could take it in between. The
body sees ``rank`` (int) and ``argv`` (the extra arguments) from the
prelude. Every child is killed when one times out.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

CHILD_PRELUDE = r"""
import sys
rank, argv = int(sys.argv[1]), sys.argv[2:]
"""


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_pod(body: str, *, n_processes: int = 2,
              args_per_proc: Optional[Callable[[int], Sequence]] = None,
              timeout: float = 600,
              threads: Optional[int] = None) -> List[Tuple[int, str, str]]:
    """Run ``CHILD_PRELUDE + body`` in ``n_processes`` processes of one
    job.

    Child ``i`` gets argv ``[script, i, *args_per_proc(i)]`` (default no
    extra arguments) and the rendezvous environment above. ``threads``:
    the intra-op thread count of each child (``OMP_NUM_THREADS``), for
    children that compute on the CPU beside other work; None keeps
    torch's default. Returns ``[(returncode, stdout, stderr)]`` in rank
    order; on timeout every child is killed and reaped and
    ``subprocess.TimeoutExpired`` raised.
    """
    from torch.distributed import TCPStore

    root = repo_root()
    # the store listens from here on; the children only connect to it
    store = TCPStore("localhost", 0, is_master=True, wait_for_workers=False)
    env = dict(os.environ)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(store.port),
               WORLD_SIZE=str(n_processes),
               TORCHELASTIC_USE_AGENT_STORE="True")
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "pod_child.py")
        with open(script, "w") as fh:
            fh.write(CHILD_PRELUDE + body)
        procs = []
        try:
            for i in range(n_processes):
                extra = [] if args_per_proc is None else args_per_proc(i)
                procs.append(subprocess.Popen(
                    [sys.executable, script, str(i), *map(str, extra)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=dict(env, RANK=str(i)), cwd=root))
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                outs.append((p.returncode, out, err))
            return outs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            del store
