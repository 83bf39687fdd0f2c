"""Quotient filter under the functional protocol (paper §3).

The port of ``repro.filters.qf_filter``.  The ``backend`` spec field
keeps the JAX package's spelling so one spec dict drives both packages:
``"reference"`` runs the plain PyTorch bulk ops of
:mod:`repro_torch.core.quotient_filter`; ``"pallas"`` runs the port's
kernel path (:mod:`repro_torch.kernels.ops`: CUDA kernels for state on
the card, their plain versions for state on the CPU), keys hashed by
the ``fingerprint`` kernel on insert and probe.  Deletes keep the plain
build, as in the JAX package, and the plain hash.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..core import quotient_filter as qf
from ..kernels import fingerprint as kfp
from ..kernels import ops as kops
from .registry import FilterImpl, register

BACKENDS = ("reference", "pallas")


class QFilterConfig(NamedTuple):
    q: int
    r: int
    slack: int = 1024
    seed: int = 0
    max_load: float = 0.75
    backend: str = "reference"
    window: int = 256  # reference lookup window (see qf.lookup)
    # low watermark: shrink only once the count fits the HALVED table at
    # this fraction of its design capacity (hysteresis vs needs_resize)
    shrink_load: float = 0.4

    @property
    def core(self) -> qf.QFConfig:
        return qf.QFConfig(
            q=self.q,
            r=self.r,
            slack=self.slack,
            seed=self.seed,
            max_load=self.max_load,
        )


def _check_backend(cfg) -> None:
    if cfg.backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {cfg.backend!r}")
    # widest remainder across levels: flat QF carries r, the layered
    # configs (buffered/cascade) derive it from p and the smallest q
    max_r = cfg.r if hasattr(cfg, "r") else cfg.p - cfg.ram_q
    if cfg.backend == "pallas" and max_r > 31:
        raise ValueError("pallas backend keeps remainders of r <= 31 bits")


def valid_mask(keys, k) -> torch.Tensor:
    """bool[B] marking the first ``k`` rows valid (all rows if k is None)."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    if k is None:
        return idx >= 0
    if not torch.is_tensor(k):  # compared as a scalar: no copy to the card
        return idx < int(k)
    return idx < torch.as_tensor(k, dtype=torch.int32, device=keys.device)


def build_fn(backend: str):
    """The bulk rebuild pass of a backend: the kernel path or the plain one."""
    return kops.build_sorted if backend == "pallas" else qf.build_sorted


def extract_fn(backend: str):
    """The decode of a backend's bulk ops, planes to sorted streams: the
    ``qf_decode`` kernel or the plain one."""
    return kops.extract if backend == "pallas" else qf.extract


def _kernel_fingerprints(core: qf.QFConfig, keys):
    return kfp.fingerprint(keys, core.q, core.r, core.seed, torch.int64)


def fingerprint_fn(backend: str):
    """The keys-to-fingerprints pass of a backend's inserts: the
    ``fingerprint`` kernel (int64 out, the core's stream contract) or the
    plain chain."""
    return _kernel_fingerprints if backend == "pallas" else qf.fingerprints


def insert_fingerprints(
    core: qf.QFConfig, backend: str, state: qf.QFState, fq, fr, valid
) -> qf.QFState:
    """Merge a validity-masked fingerprint batch into ``state``."""
    with tracing.span("qf.sort"):
        fq, fr = qf._pad_sort(fq, fr, valid)
    k = valid.sum(dtype=torch.int32)
    return qf.merge_sorted_with(
        core, state, fq, fr, k, build_fn(backend), extract_fn(backend)
    )


def insert_keys(
    core: qf.QFConfig, backend: str, state: qf.QFState, keys, k=None
) -> qf.QFState:
    with tracing.span("qf.fingerprint"):
        fq, fr = fingerprint_fn(backend)(core, keys)
    return insert_fingerprints(core, backend, state, fq, fr, valid_mask(keys, k))


def contains_keys(core: qf.QFConfig, backend: str, state, keys, window=256):
    if backend == "pallas":
        return kops.contains(core, state, keys)
    return qf.contains(core, state, keys, window)


def delete_masked(
    core: qf.QFConfig, backend: str, state: qf.QFState, fq, fr, mask
) -> qf.QFState:
    """Delete one copy of each fingerprint where ``mask`` is set, the
    table rebuilt by the backend's build pass."""
    fq, fr = qf._pad_sort(fq, fr, mask)
    return qf.delete_sorted(
        core, state, fq, fr, mask.sum(dtype=torch.int32), build_fn(backend),
        extract_fn(backend),
    )


def batch_occurrence_rank(fq, fr, valid) -> torch.Tensor:
    """0-based rank of each batch row among equal valid fingerprints.

    Routes the j-th duplicate of a key to the j-th structure that still
    holds a copy in the layered deletes (buffered/cascade).
    """
    B = fq.shape[0]
    key = torch.where(valid, qf.pack(fq, fr), qf.pack(qf.INT32_MAX, qf.UINT32_MAX))
    key_s, idx_s = torch.sort(key, stable=True)
    first = torch.searchsorted(key_s, key_s)
    rank_s = torch.arange(B, device=fq.device) - first
    out = torch.zeros(B, dtype=torch.int32, device=fq.device)
    out[idx_s] = rank_s.to(torch.int32)
    return out


def multiplicity(core: qf.QFConfig, backend: str, state: qf.QFState, fq, fr) -> torch.Tensor:
    """How many copies of each queried fingerprint the filter holds."""
    qs, rs, _ = extract_fn(backend)(core, state)
    lo = qf.lex_searchsorted(qs, rs, fq, fr, "left")
    hi = qf.lex_searchsorted(qs, rs, fq, fr, "right")
    return (hi - lo).to(torch.int32)


# -- protocol bindings -------------------------------------------------------


def make(device=None, **spec):
    cfg = QFilterConfig(**spec)
    _check_backend(cfg)
    return cfg, qf.empty(cfg.core, device)


def insert(cfg: QFilterConfig, state, keys, k=None):
    return insert_keys(cfg.core, cfg.backend, state, keys, k)


def contains(cfg: QFilterConfig, state, keys):
    return contains_keys(cfg.core, cfg.backend, state, keys, cfg.window)


def delete(cfg: QFilterConfig, state, keys, k=None):
    core = cfg.core
    fq, fr = qf.fingerprints(core, keys)
    return delete_masked(core, cfg.backend, state, fq, fr, valid_mask(keys, k))


def merge(cfg: QFilterConfig, sa, sb):
    core = cfg.core
    return qf.merge(
        core, core, core, sa, sb, build=build_fn(cfg.backend),
        extract=extract_fn(cfg.backend),
    )


def needs_resize(cfg: QFilterConfig, state):
    """Bool scalar on the state's device: at or over the max-load point."""
    return state.n >= cfg.core.capacity


def resize(cfg: QFilterConfig, state, new_q: int):
    """Re-split the p-bit fingerprints at ``new_q`` (paper §3 'Resizing').

    The slot planes change shape; the requotient and rebuild are one
    streaming pass, through the build kernel under ``backend="pallas"``.
    """
    new_r = cfg.q + cfg.r - new_q
    if not (1 <= new_q <= 30 and 1 <= new_r):
        raise ValueError(
            f"cannot re-split p={cfg.q + cfg.r} fingerprint bits at q={new_q}"
        )
    _, st = qf.resize(
        cfg.core, state, new_q, build=build_fn(cfg.backend),
        extract=extract_fn(cfg.backend),
    )
    return cfg._replace(q=new_q, r=new_r), st


def grow(cfg: QFilterConfig, state):
    """One doubling step: steal one remainder bit for the quotient."""
    return resize(cfg, state, cfg.q + 1)


def _can_halve(cfg: QFilterConfig) -> bool:
    # shrinking re-merges a remainder bit: r widens by one, which must
    # stay within the remainder plane (31 bits under pallas)
    max_r = 31 if cfg.backend == "pallas" else 32
    return cfg.q > 1 and cfg.r + 1 <= max_r


def needs_shrink(cfg: QFilterConfig, state):
    """Bool scalar: the population fits the halved table at the low
    watermark (``shrink_load`` of its capacity), the hysteresis band
    that keeps grow and shrink from thrashing."""
    if not _can_halve(cfg):
        return torch.zeros((), dtype=torch.bool, device=state.n.device)
    halved = cfg.core._replace(q=cfg.q - 1, r=cfg.r + 1)
    return state.n <= int(cfg.shrink_load * halved.capacity)


def shrink(cfg: QFilterConfig, state):
    """One halving step: re-merge a quotient bit into the remainder
    (paper §3 resizing run downward: the fp rate improves)."""
    if not _can_halve(cfg):
        raise ValueError(f"cannot shrink q={cfg.q}, r={cfg.r} further")
    return resize(cfg, state, cfg.q - 1)


def stats(cfg: QFilterConfig, state):
    return {
        "n": state.n,
        "load": qf.load(cfg.core, state),
        "overflow": state.overflow,
        "size_bytes": cfg.core.size_bytes,
    }


IMPL = register(
    FilterImpl(
        name="qf",
        paper_section="§3 (quotient filter: insert/may-contain/delete/merge/resize)",
        cfg_cls=QFilterConfig,
        make=make,
        insert=insert,
        contains=contains,
        stats=stats,
        delete=delete,
        merge=merge,
        needs_resize=needs_resize,
        grow=grow,
        resize=resize,
        needs_shrink=needs_shrink,
        shrink=shrink,
    )
)
