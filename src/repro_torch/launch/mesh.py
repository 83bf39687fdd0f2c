"""Production and debug meshes.

The port of ``repro.launch.mesh``.  The production mesh is a
:class:`repro_torch.sharding.Mesh` on the ``meta`` device: its axis
names and sizes, all that the sharding rules and the dry run read.
Making one touches no device and checks no device count, so the dry run
can describe a 256-chip pod on a machine with one card or none.  The
debug mesh is a description too, unless a process group is initialised:
then it is a ``DeviceMesh`` over the group's ranks, on the cards for an
``nccl`` group and on the CPU for ``gloo``.
"""

from __future__ import annotations

import torch.distributed as dist

from .. import sharding


def make_production_mesh(*, multi_pod: bool = False) -> sharding.Mesh:
    """16x16 = 256 chips per pod; the multi-pod mesh stacks 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes, device="meta")


def make_debug_mesh(data: int = 2, model: int = 2) -> sharding.Mesh:
    """A small mesh; ``make_debug_mesh(1, 1)`` is one card.  Over an
    initialised process group it holds the group's ranks (``data *
    model`` of them, or this raises); without one it is a description."""
    if not dist.is_initialized():
        return sharding.make_mesh((data, model), ("data", "model"), device="meta")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return sharding.make_mesh((data, model), ("data", "model"), device=device)
