"""Launch N local processes of one job: the multi-process harness of the
tests and of ``chip_smoke.py`` (stdlib only).

Each child runs ``CHILD_PRELUDE + body`` with torchrun's environment
contract: ``MASTER_ADDR=localhost``, ``MASTER_PORT`` (a free port),
``RANK`` and ``WORLD_SIZE``, which ``torch.distributed``'s ``env://``
rendezvous reads (``parallel.mesh.init_distributed``), and the
repository on ``PYTHONPATH``. The body sees ``rank`` (int) and ``argv``
(the extra arguments) from the prelude. Every child is killed when one
times out.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

CHILD_PRELUDE = r"""
import sys
rank, argv = int(sys.argv[1]), sys.argv[2:]
"""


def free_port() -> int:
    """A free localhost port for the rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_pod(body: str, *, n_processes: int = 2,
              args_per_proc: Optional[Callable[[int], Sequence]] = None,
              timeout: float = 600) -> List[Tuple[int, str, str]]:
    """Run ``CHILD_PRELUDE + body`` in ``n_processes`` processes of one
    job.

    Child ``i`` gets argv ``[script, i, *args_per_proc(i)]`` (default no
    extra arguments) and the rendezvous environment above. Returns
    ``[(returncode, stdout, stderr)]`` in rank order; on timeout every
    child is killed and reaped and ``subprocess.TimeoutExpired`` raised.
    """
    root = repo_root()
    env = dict(os.environ)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n_processes))
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
