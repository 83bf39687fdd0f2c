"""Logical-axis sharding: one place that decides how tensors map to the mesh.

The port of ``repro.sharding``.  Every tensor in the model is annotated
with *logical* axis names ("batch", "seq", "heads", ...).  A
:class:`ShardingRules` object maps logical names to mesh axes, with
per-architecture fallbacks (e.g. an 8-expert MoE cannot shard experts
over a 16-way model axis, so experts fall back to replicated and the
per-expert ffn dim takes the model axis).

The mesh is a description, :class:`Mesh`: its axis names and sizes (all
that the rules read, as with ``jax.sharding.AbstractMesh``) and the
device its arrays live on.  A partition spec is a plain tuple, one entry
a dim: ``None`` (replicated), a mesh axis name, or a tuple of names.
``constrain`` keeps the reference's rank check and returns its input
unchanged: a sharding constraint changes no value, and on a mesh of one
device there is nothing to place.  Placement across cards waits for a
machine with two or more; :func:`check_devices` refuses a mesh larger
than the devices there are, as JAX refuses one.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from .core.quotient_filter import resolve_device

_STATE = threading.local()


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``shape`` an ordered {axis name: size}."""

    shape: dict
    device: torch.device

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(sizes, names, device=None) -> Mesh:
    """A mesh of ``sizes`` over ``names`` whose arrays live on ``device``
    (the card unless asked; without one this raises)."""
    if len(sizes) != len(names):
        raise ValueError(f"mesh sizes {tuple(sizes)} and names {tuple(names)} differ in rank")
    return Mesh(shape=dict(zip(names, (int(s) for s in sizes))), device=resolve_device(device))


def check_devices(mesh: Mesh) -> None:
    """Raise unless the mesh's device type has ``mesh.size`` devices: the
    card count for CUDA, one for the CPU (one process is one device)."""
    have = torch.cuda.device_count() if mesh.device.type == "cuda" else 1
    if mesh.size > have:
        raise ValueError(
            f"a mesh of {mesh.size} devices {dict(mesh.shape)} needs {mesh.size} "
            f"{mesh.device.type} devices, and {have} are there"
        )


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


@dataclass
class ShardingRules:
    mesh: Any
    mapping: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def for_config(cls, mesh, cfg=None, *, seq_shard: bool = True,
                   decode: bool = False) -> "ShardingRules":
        """Default DP/FSDP + TP(+SP) rules for the production mesh.

        data-parallel axes ("pod","data") shard batch and the FSDP
        (scan-over-layers) param dim; "model" shards heads / ffn /
        vocab (Megatron TP) and the residual-stream sequence dim
        between blocks (sequence parallelism).
        """
        names = mesh.axis_names
        dp = tuple(a for a in ("pod", "data") if a in names)
        tp = "model" if "model" in names else None
        dp_size = _axis_size(mesh, dp)

        def fits(dim: int, over=tp, size=None) -> bool:
            n = size if size is not None else _axis_size(mesh, over)
            return over is not None and dim > 0 and dim % n == 0

        m = {
            # ZeRO/FSDP: params' d_model dim shards over the DP axes; on
            # activations "embed" dedups to None because "batch" already
            # consumed the DP axes (ShardingRules.spec drops reused axes).
            "batch": dp,
            "seq": tp if seq_shard else None,  # SP between blocks
            "kv_seq": None,
            "embed": None,
            "heads": tp,
            "kv_heads": None,  # set per-config below
            "head_dim": None,
            "qk_dim": None,
            "ffn": tp,
            "vocab": tp,
            "layers": None,
            "experts": None,
            "expert_ffn": tp,
            "lru": tp,
            "ssm_inner": tp,
            "state": None,
            "conv": None,
        }
        if cfg is not None:
            if fits(cfg.d_model, dp, dp_size):
                m["embed"] = dp
            if not fits(cfg.n_heads):
                m["heads"] = None
            if not fits(cfg.vocab_size):
                m["vocab"] = None
            if cfg.d_ff and not fits(cfg.d_ff):
                m["ffn"] = None
            if cfg.n_kv_heads and fits(cfg.n_kv_heads):
                m["kv_heads"] = tp
            elif decode and cfg.n_kv_heads and fits(cfg.head_dim):
                # decode with few KV heads: shard the KV cache's head_dim
                # (the scores contraction all-reduces); queries follow so
                # q/k layouts stay consistent
                m["head_dim"] = tp
                m["heads"] = None
            # train with kv < tp: KV stays replicated (q sharded by heads)
            if cfg.n_experts:
                if fits(cfg.n_experts):
                    m["experts"] = tp  # true expert parallelism
                    m["expert_ffn"] = None
                else:
                    m["experts"] = None  # replicate experts, TP the ffn dim
                    m["expert_ffn"] = tp if fits(cfg.moe_d_ff or cfg.d_ff) else None
            if cfg.attn_kind == "mla":
                m["kv_heads"] = None
                m["head_dim"] = None
            if cfg.lru_width and not fits(cfg.lru_width):
                m["lru"] = None
        return cls(mesh=mesh, mapping=m)

    def spec(self, axes: tuple, shape: tuple = None) -> tuple:
        """The partition spec (a tuple) for logical axes; with ``shape``,
        any mapping whose mesh-axis product does not divide the dim falls
        back to replicated (placement demands exact divisibility)."""
        parts, used = [], set()
        for i, a in enumerate(axes):
            if a is None:
                parts.append(None)
                continue
            mapped = self.mapping.get(a)
            if mapped is None:
                parts.append(None)
                continue
            tup = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            tup = tuple(x for x in tup if x not in used)
            if shape is not None and tup:
                n = 1
                for x in tup:
                    n *= self.mesh.shape[x]
                if n == 0 or shape[i] % n != 0:
                    parts.append(None)
                    continue
            used.update(tup)
            parts.append(tup if len(tup) > 1 else (tup[0] if tup else None))
        return tuple(parts)

    def sharding(self, axes: tuple, shape: tuple = None) -> tuple:
        """(mesh, spec): where ``NamedSharding`` stands in the reference."""
        return self.mesh, self.spec(axes, shape)


def shards(mesh, spec) -> tuple:
    """How many pieces each dim of a leaf with ``spec`` is cut into."""
    return tuple(_axis_size(mesh, part) for part in spec)


def active_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axes: a rank
    check under active rules (a ``ValueError`` on a mismatch), then ``x``
    unchanged."""
    rules = active_rules()
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"rank mismatch: {axes} vs {tuple(x.shape)}")
    return x
