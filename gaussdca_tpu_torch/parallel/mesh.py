"""A (data, model) grid of torch devices, one process or many, and its
collectives.

The counterpart of ``gaussdca_tpu.parallel.mesh``: a ``Mesh`` is a
``[dp, tp]`` grid of shards with the axis names ``("data", "model")``.
Shard ``d`` is the ``d``-th shard in row-major order, the order of
``P((DATA_AXIS, MODEL_AXIS))`` in the JAX package. Devices may repeat:
``Mesh([torch.device("cuda", 0)] * 4, (2, 2))`` runs four shards on one
card, as ``--xla_force_host_platform_device_count`` gives JAX virtual
devices; on a machine with several cards the same code puts one shard on
each.

A mesh may span the processes of a ``torch.distributed`` group (the pod,
``make_pod_mesh`` after ``init_distributed``): each of the ``world``
processes holds ``n_local = size / world`` consecutive shards, global
shard ``d`` on process ``d // n_local``, and every process runs the same
program on its own shards. ``flat``, ``shards``, ``home`` and
``distinct`` say what this process holds.

The collectives take the per-shard tensors of this process's shards.
With one process they are plain functions (no ``torch.distributed``
call); with several they run over the process group: NCCL when the
processes' cards are distinct, else gloo, through which CUDA tensors are
staged in host buffers (``Mesh.comm_device``). Receive buffers are always
fresh tensors. In one process ``Tensor.to`` onto the tensor's own device
returns the tensor itself, so a "broadcast" slab may alias its owner's:
callers never update one in place.

Each exchange of data is a ``collective`` span (``utils.log``) with its
``op`` and the ``bytes`` this process sends, and adds its host seconds
and bytes to the record's counters ``collective_s`` and
``collective_bytes``: in one process the copies between the shards'
devices, in a pod the ``torch.distributed`` call alone. The staging
copies to and from ``comm_device`` stay outside it: on gloo they wait
for the device's queue, which is compute, not communication.

Family mode (``--distributed`` without ``--mesh``) joins a gloo group and
deals each process its families (``shard_families``); it runs no
collective.
"""

from __future__ import annotations

import atexit
import contextlib
import pickle
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from gaussdca_tpu_torch.utils import log

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``[dp, tp]`` grid of shards, axes ``("data", "model")``;
    ``devices`` are the devices of this process's shards (all of them
    with one process, ``dp * tp / world`` in a pod)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: Sequence, shape: Tuple[int, int], *,
                 rank: int = 0, world: int = 1):
        devs = [torch.device(d) for d in devices]
        # "cuda" means the current card: pin the index, since tensors
        # report theirs and shards are matched to slabs by device
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in devs]
        dp, tp = (int(x) for x in shape)
        if dp * tp != len(devs) * world or dp < 1 or tp < 1:
            raise ValueError(
                f"mesh shape {dp}x{tp} != device count {len(devs) * world}")
        types = {d.type for d in devs}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(
                f"mesh devices must all be cpu or all cuda, got {types}")
        self._grid = (dp, tp)
        self._flat = devs
        self.rank, self.world = int(rank), int(world)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self._grid))

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self._grid[0] * self._grid[1]

    @property
    def n_local(self) -> int:
        return len(self._flat)

    @property
    def flat(self) -> List[torch.device]:
        """This process's shards -> their devices, in shard order."""
        return list(self._flat)

    @property
    def shards(self) -> range:
        """The global indices of this process's shards."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    def owner(self, d: int) -> int:
        """The process that holds global shard ``d``."""
        return d // self.n_local

    def is_local(self, d: int) -> bool:
        return self.owner(d) == self.rank

    @property
    def home(self) -> torch.device:
        """This process's first shard's device: where gathered results
        and replicated small state live."""
        return self._flat[0]

    @property
    def distinct(self) -> List[torch.device]:
        """Each device of this process's shards once, in shard order."""
        return list(dict.fromkeys(self._flat))

    @property
    def comm_device(self) -> torch.device:
        """Where this process's collectives exchange tensors: the card
        under NCCL, the host under gloo."""
        import torch.distributed as dist

        return self.home if dist.get_backend() == "nccl" \
            else torch.device("cpu")

    def __repr__(self) -> str:
        pod = f", rank={self.rank}, world={self.world}" \
            if self.world > 1 else ""
        return f"Mesh({[str(d) for d in self._flat]}, {self._grid}{pod})"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into (dp, tp) with tp the largest power-of-two <= sqrt-ish
    divisor — a balanced default when the caller doesn't specify shape."""
    tp = 1
    while tp * 2 <= n and n % (tp * 2) == 0 and tp * 2 <= 4:
        tp *= 2
    return n // tp, tp


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` devices (default:
    every visible CUDA card). Raises when there are none: a mesh never
    falls back to the CPU unless its devices say so."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} visible")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("no CUDA device visible: a mesh needs at least one")
    dp, tp = shape if shape is not None else _factor2(n)
    if dp * tp != n:
        raise ValueError(f"mesh shape {dp}x{tp} != device count {n}")
    return Mesh(devs, (dp, tp))


def process_device(device, rank: int) -> torch.device:
    """The device a process of a group runs on: a bare "cuda" takes the
    card ``rank % device_count`` (one card a process, round-robin over the
    visible cards); "cpu" and an indexed card are kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise ValueError("no CUDA device visible: pass a cpu device")
        dev = torch.device("cuda", rank % n)
    return dev


def make_pod_mesh(shape: Optional[Tuple[int, int]] = None,
                  device="cuda", *, rank: Optional[int] = None,
                  world: Optional[int] = None) -> Mesh:
    """The mesh of a joined process group (the counterpart of JAX's
    ``make_mesh`` over a pod's ``jax.devices()``): ``shape`` (default
    ``_factor2(world)``, one shard a process) split evenly over the
    processes, each process's shards on its ``process_device``. Raises
    ValueError when the world size does not divide the shard count.
    ``rank`` and ``world`` default to the group's."""
    if rank is None or world is None:
        import torch.distributed as dist

        rank, world = dist.get_rank(), dist.get_world_size()
    dp, tp = (int(x) for x in shape) if shape is not None \
        else _factor2(world)
    if dp < 1 or tp < 1 or (dp * tp) % world:
        raise ValueError(
            f"mesh shape {dp}x{tp}: its {dp * tp} shards do not split "
            f"evenly over the {world} processes of the group")
    dev = process_device(device, rank)
    return Mesh([dev] * (dp * tp // world), (dp, tp), rank=rank,
                world=world)


# --- collectives: each takes this process's per-shard tensors ------------

def _pod(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world > 1


def _nbytes(parts: Sequence[torch.Tensor]) -> int:
    return sum(p.numel() * p.element_size() for p in parts)


@contextlib.contextmanager
def _collective(op: str, nbytes: int, on: bool = True):
    """The ``collective`` span of one exchange (none where ``on`` is
    false), and its counters."""
    if not (on and log.tracing_on()):
        yield
        return
    with log.span("collective", op=op, bytes=nbytes) as sp:
        yield
    log.count(collective_s=sp.t1 - sp.t0, collective_bytes=nbytes)


def psum(parts: Sequence[torch.Tensor], device: torch.device,
         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of the per-shard tensors of every process, on ``device``. A
    fresh tensor: the parts are never updated."""
    pod = _pod(mesh)
    with _collective("psum", _nbytes(parts), on=not pod):
        out = parts[0].to(device, copy=True)
        for p in parts[1:]:
            out += p.to(device)
    if pod:
        import torch.distributed as dist

        buf = out.to(mesh.comm_device)
        with _collective("psum", _nbytes([buf])):
            dist.all_reduce(buf)
        out = buf.to(device)
    return out


def all_gather(parts: Sequence[torch.Tensor], device: torch.device,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The per-shard tensors of every process concatenated along dim 0
    in shard order, on ``device``. Their lengths may differ: across
    processes each process's rows are padded to the longest and cut
    back after the exchange."""
    if not _pod(mesh):
        with _collective("all_gather", _nbytes(parts)):
            return torch.cat([p.to(device) for p in parts])
    import torch.distributed as dist

    comm = mesh.comm_device
    local = torch.cat([p.to(comm) for p in parts])
    n = torch.tensor([local.shape[0]], dtype=torch.int64, device=comm)
    ns = [torch.empty_like(n) for _ in range(mesh.world)]
    with _collective("all_gather", _nbytes([n])):
        dist.all_gather(ns, n)
    ns = [int(x) for x in ns]
    top = max(ns)
    if local.shape[0] < top:
        local = torch.cat([local, local.new_zeros(
            (top - local.shape[0], *local.shape[1:]))])
    bufs = [local.new_empty((top, *local.shape[1:]))
            for _ in range(mesh.world)]
    with _collective("all_gather", _nbytes([local])):
        dist.all_gather(bufs, local)
    return torch.cat([b[:k] for b, k in zip(bufs, ns)]).to(device)


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` (a value every process holds) on each of this process's
    shards' devices, one copy per distinct device (shards on one device
    share it: read-only)."""
    on = {d: x.to(d) for d in mesh.distinct}
    return [on[d] for d in mesh.flat]


def broadcast(x: Optional[torch.Tensor], src: int, mesh: Mesh,
              shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """Global shard ``src``'s tensor ``x`` (``shape``, ``dtype``; None on
    the other processes) on every process. One process: ``x`` itself,
    on its shard's device; a pod: a fresh tensor on ``mesh.home`` (on
    the owner, possibly ``x``). Read only."""
    if not _pod(mesh):
        return x
    import torch.distributed as dist

    comm = mesh.comm_device
    if mesh.is_local(src):
        buf = x.to(comm).contiguous()
    else:
        buf = torch.empty(shape, dtype=dtype, device=comm)
    with _collective("broadcast",
                     _nbytes([buf]) if mesh.is_local(src) else 0):
        dist.broadcast(buf, src=mesh.owner(src))
    return buf.to(mesh.home)


def reduce(x: torch.Tensor, dst: int, mesh: Mesh) -> Optional[torch.Tensor]:
    """The sum over the processes of each one's ``x`` (same shape on
    all), on global shard ``dst``'s process (on ``mesh.home``); None on
    the others. One process: ``x``."""
    if not _pod(mesh):
        return x
    import torch.distributed as dist

    buf = x.to(mesh.comm_device, copy=True)
    with _collective("reduce", _nbytes([buf])):
        dist.reduce(buf, dst=mesh.owner(dst))
    return buf.to(mesh.home) if mesh.is_local(dst) else None


def reduce_scatter(slabs: Sequence[torch.Tensor],
                   mesh: Mesh) -> List[torch.Tensor]:
    """Per-process partial sums of one slab per GLOBAL shard -> the summed
    slabs of this process's shards, each on its shard's device (one
    reduce to each slab's owner). One process: the slabs themselves."""
    if not _pod(mesh):
        return list(slabs)
    out = []
    for d, slab in enumerate(slabs):
        r = reduce(slab, d, mesh)
        if r is not None:
            out.append(r.to(mesh.flat[d - mesh.shards.start]))
    return out


def all_to_all(send: Sequence[Sequence[torch.Tensor]],
               mesh: Mesh) -> List[List[torch.Tensor]]:
    """``send[i][d]``: the 2-D piece this process's ``i``-th shard sends
    to global shard ``d`` -> ``recv[i][src]``: the piece global shard
    ``src`` sent to this process's ``i``-th shard, on its device. Pieces
    may differ in shape; one dtype. A pod exchanges the shapes first,
    then every piece in one ``all_to_all_single``."""
    if not _pod(mesh):
        with _collective("all_to_all", _nbytes([p for row in send
                                                for p in row])):
            return [[send[src][d].to(dev) for src in range(mesh.size)]
                    for d, dev in zip(mesh.shards, mesh.flat)]
    import torch.distributed as dist

    comm, n, world = mesh.comm_device, mesh.n_local, mesh.world
    mine = torch.tensor([list(p.shape) for row in send for p in row],
                        dtype=torch.int64, device=comm)    # [n * size, 2]
    tables = [torch.empty_like(mine) for _ in range(world)]
    with _collective("all_gather", _nbytes([mine])):
        dist.all_gather(tables, mine)
    shapes = torch.cat(tables).reshape(mesh.size, mesh.size, 2).tolist()
    flat_in, in_splits = [], []
    for q in range(world):
        pieces = [send[i][d].reshape(-1) for i in range(n)
                  for d in range(q * n, (q + 1) * n)]
        in_splits.append(sum(p.numel() for p in pieces))
        flat_in += [p.to(comm) for p in pieces]
    inp = torch.cat(flat_in)
    out_splits = [sum(shapes[src][d][0] * shapes[src][d][1]
                      for src in range(q * n, (q + 1) * n)
                      for d in mesh.shards) for q in range(world)]
    out = inp.new_empty(sum(out_splits))
    with _collective("all_to_all", _nbytes([inp])):
        dist.all_to_all_single(out, inp, out_splits, in_splits)
    recv = [[None] * mesh.size for _ in range(n)]
    k = 0
    for src in range(mesh.size):          # sender-major, as packed above
        for i, d in enumerate(mesh.shards):
            r, c = shapes[src][d]
            recv[i][src] = out[k:k + r * c].reshape(r, c).to(mesh.flat[i])
            k += r * c
    return recv


def on_first(mesh: Mesh, fn: Callable[[], torch.Tensor],
             shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """``fn()`` computed once, on process 0, and broadcast: every process
    gets the same bits (on ``mesh.home``). A failure there is raised on
    every process (ArithmeticError as itself), so none waits alone."""
    if not _pod(mesh):
        return fn()
    out, err = None, ""
    if mesh.rank == 0:
        try:
            out = fn()
        except Exception as e:  # sent to the peers, then raised here too
            err = f"{type(e).__name__}: {e}"
            failure = e
    msg = broadcast_object(mesh, err)
    if msg:
        if mesh.rank == 0:
            raise failure
        if msg.startswith("ArithmeticError: "):
            raise ArithmeticError(msg[len("ArithmeticError: "):])
        raise RuntimeError(f"process 0 failed: {msg}")
    return broadcast(out, 0, mesh, shape, dtype)


def broadcast_object(mesh: Optional[Mesh], obj, src: int = 0):
    """Process ``src``'s picklable ``obj`` on every process of the
    group (one process: ``obj``)."""
    if not _pod(mesh):
        return obj
    import torch.distributed as dist

    box = [obj]
    nbytes = len(pickle.dumps(obj)) \
        if mesh.rank == src and log.tracing_on() else 0
    with _collective("broadcast_object", nbytes):
        dist.broadcast_object_list(box, src=src, device=mesh.comm_device)
    return box[0]


# --- process groups ---------------------------------------------------

def _card(dev: torch.device) -> str:
    """What identifies a process's device across the group: the host and
    the card's UUID, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return f"{socket.gethostname()}/" \
           f"{torch.cuda.get_device_properties(dev).uuid}"


def choose_backend(cards: Sequence[str]) -> str:
    """NCCL when every process has a card of its own; gloo when the
    tensors are on the CPU or two processes share a card (NCCL refuses
    two ranks on one card)."""
    if "cpu" in cards or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def _leave_group() -> None:
    """Leave the default process group, if one is still joined: run at
    interpreter exit (``init_distributed`` registers it), while the
    interpreter and torch are still whole."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _leave_at_exit() -> None:
    # once, however often a process joins and leaves
    atexit.unregister(_leave_group)
    atexit.register(_leave_group)


def init_distributed(force: bool = False,
                     device=None) -> Tuple[int, int]:
    """Join the process group of a multi-process run; returns (rank,
    world size).

    Rendezvous is torchrun's contract: ``env://``, where torch reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.
    Without ``device`` (family mode, no collective) the backend is gloo.
    With ``device`` (the pod: "cuda" takes the card ``rank % count``,
    ``process_device``) the processes first exchange what their devices
    are through the rendezvous store and pick the backend by
    ``choose_backend``; a failed NCCL initialization raises.
    ``force=True`` (the CLI's ``--distributed``) lets torch raise when the
    rendezvous is not configured: running single-process would contradict
    what the user asked for. Without ``force`` an unconfigured rendezvous
    is the single-process run, (0, 1). A group already joined is kept.
    A group joined here is left at interpreter exit, if the caller has
    not left it: a process that exits with its gloo group still joined
    can abort in torch's teardown ("terminate called without an active
    exception")."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    try:
        if device is None:
            dist.init_process_group(backend="gloo", init_method="env://")
            _leave_at_exit()
            return dist.get_rank(), dist.get_world_size()
        store, rank, world = next(dist.rendezvous("env://"))
    except ValueError:
        if force:
            raise
        return 0, 1
    dev = process_device(device, rank)
    store.set(f"gdca/card/{rank}", _card(dev))
    backend = choose_backend([store.get(f"gdca/card/{r}").decode()
                              for r in range(world)])
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, store=store, rank=rank,
                            world_size=world)
    _leave_at_exit()
    return rank, world


def shard_families(paths: Sequence, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> list:
    """Round-robin family assignment for multi-process batch runs: each
    family is independent, so process p of P takes families p, p + P, ...
    The defaults are this process's rank and the group's size (0 and 1
    outside a process group)."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    p = (dist.get_rank() if joined else 0) if process_index is None \
        else process_index
    n = (dist.get_world_size() if joined else 1) if process_count is None \
        else process_count
    return [f for k, f in enumerate(paths) if k % n == p]
