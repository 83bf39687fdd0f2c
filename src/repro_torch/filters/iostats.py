"""Modeled I/O accounting inside the filter states.

The port of ``repro.filters.iostats``: :class:`IOCounters` holds the
paper's access schedule as scalar tensors on the state's device (op
counts int32, byte counters float32), updated in the same order as the
JAX package so the counters agree exactly.  :func:`to_iolog` converts
to the host-side ``IOLog`` at reporting time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cost_model import IOLog


class IOCounters(NamedTuple):
    """Scalar tensors mirroring the fields of ``IOLog``.

    ``resizes``, ``migrate_chunks`` and ``settles`` have no ``IOLog``
    counterpart; they are kept so the state matches the JAX package's
    field for field.
    """

    rand_page_reads: torch.Tensor  # int32
    rand_page_writes: torch.Tensor  # int32
    seq_read_bytes: torch.Tensor  # float32
    seq_write_bytes: torch.Tensor  # float32
    flushes: torch.Tensor  # int32
    merges: torch.Tensor  # int32
    resizes: torch.Tensor  # int32
    migrate_chunks: torch.Tensor  # int32
    settles: torch.Tensor  # int32


_FLOAT_FIELDS = ("seq_read_bytes", "seq_write_bytes")


def zeros(device) -> IOCounters:
    return IOCounters(
        *(
            torch.zeros(
                (),
                dtype=torch.float32 if f in _FLOAT_FIELDS else torch.int32,
                device=device,
            )
            for f in IOCounters._fields
        )
    )


def f32(x, device) -> torch.Tensor:
    """A byte count as a float32 scalar on ``device`` (the counters' type),
    filled in there: no copy from the host."""
    return torch.full((), x, dtype=torch.float32, device=device)


def add(a: IOCounters, b: IOCounters) -> IOCounters:
    return IOCounters(*(x + y for x, y in zip(a, b)))


def to_iolog(io: IOCounters) -> IOLog:
    """Host-side conversion for benchmarks / reporting (syncs the device)."""
    return IOLog(
        rand_page_reads=int(io.rand_page_reads),
        rand_page_writes=int(io.rand_page_writes),
        seq_read_bytes=int(io.seq_read_bytes),
        seq_write_bytes=int(io.seq_write_bytes),
        flushes=int(io.flushes),
        merges=int(io.merges),
    )
