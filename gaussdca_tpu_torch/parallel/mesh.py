"""A (data, model) grid of torch devices and its collectives.

The counterpart of ``gaussdca_tpu.parallel.mesh`` in one process: a
``Mesh`` is a ``[dp, tp]`` array of ``torch.device`` with the axis names
``("data", "model")``. Shard ``d`` is the ``d``-th device in row-major
order, the order of ``P((DATA_AXIS, MODEL_AXIS))`` in the JAX package.
Devices may repeat: ``Mesh([torch.device("cuda", 0)] * 4, (2, 2))`` runs
four shards on one card, as ``--xla_force_host_platform_device_count``
gives JAX virtual devices; on a machine with several cards the same code
puts one shard on each.

The collectives are plain functions over the per-shard tensors (one
process drives every shard, so nothing here uses ``torch.distributed``).
``Tensor.to`` onto the tensor's own device returns the tensor itself, so a
"broadcast" slab may alias its owner's: callers never update one in place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``[dp, tp]`` grid of torch devices, axes ``("data", "model")``."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: Sequence, shape: Tuple[int, int]):
        devs = [torch.device(d) for d in devices]
        # "cuda" means the current card: pin the index, since tensors
        # report theirs and shards are matched to slabs by device
        devs = [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in devs]
        dp, tp = (int(x) for x in shape)
        if dp * tp != len(devs) or dp < 1 or tp < 1:
            raise ValueError(
                f"mesh shape {dp}x{tp} != device count {len(devs)}")
        types = {d.type for d in devs}
        if len(types) != 1 or not types <= {"cpu", "cuda"}:
            raise ValueError(
                f"mesh devices must all be cpu or all cuda, got {types}")
        self.devices = np.empty((dp, tp), dtype=object)
        for k, d in enumerate(devs):
            self.devices[k // tp, k % tp] = d

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> List[torch.device]:
        """Shard d -> its device, row-major."""
        return list(self.devices.reshape(-1))

    @property
    def home(self) -> torch.device:
        """Shard 0's device: where gathered results and replicated
        small state live."""
        return self.flat[0]

    @property
    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in shard order."""
        return list(dict.fromkeys(self.flat))

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.flat]}, "
                f"{tuple(self.devices.shape)})")


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


def psum(parts: Sequence[torch.Tensor],
         device: torch.device) -> torch.Tensor:
    """Sum of the per-shard tensors, on ``device``. A fresh tensor: the
    parts are never updated."""
    out = parts[0].to(device, copy=True)
    for p in parts[1:]:
        out += p.to(device)
    return out


def all_gather(parts: Sequence[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The per-shard tensors concatenated along dim 0 on ``device``."""
    return torch.cat([p.to(device) for p in parts])


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``x`` on every shard's device, one copy per distinct device
    (shards on one device share it: read-only)."""
    on = {d: x.to(d) for d in mesh.distinct}
    return [on[d] for d in mesh.flat]
