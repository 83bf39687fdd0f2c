"""Production mesh descriptions.

The port of ``repro.launch.mesh``.  A mesh here is a
:class:`repro_torch.sharding.Mesh` on the ``meta`` device: its axis
names and sizes, all that the sharding rules and the dry run read.
Making one touches no device and checks no device count, so the dry run
can describe a 256-chip pod on a machine with one card or none.
"""

from __future__ import annotations

from .. import sharding


def make_production_mesh(*, multi_pod: bool = False) -> sharding.Mesh:
    """16x16 = 256 chips per pod; the multi-pod mesh stacks 2 pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return sharding.make_mesh(shape, axes, device="meta")


def make_debug_mesh(data: int = 2, model: int = 2) -> sharding.Mesh:
    """A small mesh; ``make_debug_mesh(1, 1)`` is one card."""
    return sharding.make_mesh((data, model), ("data", "model"), device="meta")
