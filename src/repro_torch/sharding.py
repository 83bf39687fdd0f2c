"""Logical-axis sharding: one place that decides how tensors map to the mesh.

The port of ``repro.sharding``.  Every tensor in the model is annotated
with *logical* axis names ("batch", "seq", "heads", ...).  A
:class:`ShardingRules` object maps logical names to mesh axes, with
per-architecture fallbacks (e.g. an 8-expert MoE cannot shard experts
over a 16-way model axis, so experts fall back to replicated and the
per-expert ffn dim takes the model axis).

A :class:`Mesh` is its axis names and sizes (all that the rules read, as
with ``jax.sharding.AbstractMesh``), the device its arrays live on and,
when it was made over an initialised process group, a
``torch.distributed`` ``DeviceMesh``.  A partition spec is a plain
tuple, one entry a dim: ``None`` (replicated), a mesh axis name, or a
tuple of names.  On a mesh with a ``DeviceMesh`` the spec becomes DTensor
placements (:meth:`ShardingRules.placements`), :func:`place` distributes
a tree by its specs and :func:`constrain` redistributes a DTensor, where
the reference calls ``with_sharding_constraint``.  A plain tensor passes
``constrain`` unchanged (after the rank check), so a description-only
mesh (the dry run's ``meta`` meshes) and every unplaced path run as
before.  :func:`check_devices` refuses a mesh that is not one rank a
device of the group.  :func:`row_local` runs a per-row function (what the
reference ``vmap``s over the batch) on each rank's own rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from .core.quotient_filter import resolve_device

_STATE = threading.local()


@dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``shape`` an ordered {axis name: size}, and
    ``device_mesh`` the ranks' ``DeviceMesh`` (``None``: a description)."""

    shape: dict
    device: torch.device
    device_mesh: Any = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(sizes, names, device=None) -> Mesh:
    """A mesh of ``sizes`` over ``names`` whose arrays live on ``device``
    (the card unless asked; without one this raises).  Over an
    initialised process group it holds a ``DeviceMesh`` of the group's
    ranks (:func:`check_devices` first); on ``meta``, or with no group,
    it is a description."""
    if len(sizes) != len(names):
        raise ValueError(f"mesh sizes {tuple(sizes)} and names {tuple(names)} differ in rank")
    mesh = Mesh(shape=dict(zip(names, (int(s) for s in sizes))), device=resolve_device(device))
    if mesh.device.type == "meta" or not dist.is_initialized():
        return mesh
    from torch.distributed.device_mesh import init_device_mesh

    check_devices(mesh)
    dm = init_device_mesh(mesh.device.type, tuple(mesh.shape.values()),
                          mesh_dim_names=mesh.axis_names)
    return dataclasses.replace(mesh, device_mesh=dm)


def check_devices(mesh: Mesh) -> None:
    """Raise unless the mesh is one rank a device: ``mesh.size`` equal to
    the process group's world size (1 without a group: one process is one
    device), and on CUDA no more ranks than cards."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size != world:
        raise ValueError(
            f"a mesh of {mesh.size} devices {dict(mesh.shape)} needs a group of {mesh.size} "
            f"ranks, one a device, and the group has {world}"
        )
    cards = torch.cuda.device_count() if mesh.device.type == "cuda" else world
    if world > cards:
        raise ValueError(f"{world} ranks on {cards} cuda devices: at most one rank a device")


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

    def placements(self, axes: tuple, shape: tuple = None) -> tuple:
        """``spec(axes, shape)`` as DTensor placements (:func:`placements`)."""
        return placements(self.mesh, self.spec(axes, shape))


def shards(mesh, spec) -> tuple:
    """How many pieces each dim of a leaf with ``spec`` is cut into."""
    return tuple(_axis_size(mesh, part) for part in spec)


def placements(mesh, spec) -> tuple:
    """A partition spec as DTensor placements, one a mesh axis in the
    mesh's order: ``Shard(d)`` where the axis cuts tensor dim ``d``,
    ``Replicate()`` elsewhere, and on an axis of one device, which cuts
    nothing (a ``Shard`` there would stop DTensor from merging the dim in
    a view, as a decode step's ``seq`` of 1).  JAX cuts a dim named by a
    tuple of axes major to minor in the tuple's order, DTensor in
    mesh-axis order, so a tuple against the mesh's order (a layout
    DTensor's ``Shard`` cannot hold) raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec {spec} cuts dim {d} by {axes} major to minor; "
                f"the mesh {names} would cut it in its own order"
            )
        for i in order:
            if mesh.shape[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x):
    """The rank's own shard of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_placed(x) else x


def like(x, ref):
    """``x`` redistributed to the placements of the DTensor ``ref``; ``x``
    itself when ``ref`` is a plain tensor."""
    if not is_placed(ref):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def from_local(x, ref):
    """A rank's shard ``x`` as a DTensor placed as ``ref``, of ``ref``'s
    global shape; ``x`` itself when ``ref`` is a plain tensor."""
    if not is_placed(ref):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, ref.device_mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride())


def unshard(x, dim: int):
    """A DTensor redistributed so that no mesh axis cuts ``dim``, its other
    placements kept: the explicit redistribution before an op whose
    DTensor strategy fails on a cut dim.  A plain tensor as it is."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def row_local(fn):
    """``fn`` run on each rank's own rows, where the reference ``vmap``s a
    per-row function over the batch (its data-dependent sorts, gathers and
    scatters stay local to the rows a device holds).  With no DTensor among
    the arguments (nested tuples) ``fn`` is called as it is.  Otherwise the
    first DTensor argument's cuts of dim 0, the batch, are the rows'
    placements; each DTensor argument is redistributed to them (an explicit
    redistribution: an all-gather of any other dim a mesh axis cuts, an
    all-reduce of a partial sum), ``fn`` runs on the local shards, and each
    tensor it returns becomes a DTensor of those placements.  Dim 0 of every
    tensor argument and result is the batch.  ``to_local`` and
    ``from_local`` carry gradients, so a train step's backward goes through."""

    @functools.wraps(fn)
    def wrapped(*args):
        first = next((a for a in _tensors(args) if is_placed(a)), None)
        if first is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = first.device_mesh
        rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                     for p in first.placements)
        down = lambda a: a.redistribute(mesh, rows).to_local() if is_placed(a) else a
        up = lambda t: DTensor.from_local(t, mesh, rows, run_check=False)
        return _map_tensors(up, fn(*_map_tensors(down, args)))

    return wrapped


def _tensors(tree):
    if isinstance(tree, tuple):
        for t in tree:
            yield from _tensors(t)
    elif torch.is_tensor(tree):
        yield tree


def _map_tensors(f, tree):
    if isinstance(tree, tuple):
        return tuple(_map_tensors(f, t) for t in tree)
    return f(tree) if torch.is_tensor(tree) else tree


def whole(x):
    """The full value of a DTensor on every rank (a collective: every rank
    calls it); a plain tensor as it is."""
    return x.full_tensor() if is_placed(x) else x


def all_max(x, ref):
    """The largest of every rank's ``x`` (a shard's own maximum) over the
    mesh of the DTensor ``ref``: the maximum of the whole leaf, as XLA
    reduces a sharded ``amax``.  ``x`` itself when ``ref`` is plain."""
    if not is_placed(ref):
        return x
    from torch.distributed.tensor import DTensor, Partial

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Partial("max")] * mesh.ndim).full_tensor()


def place(tree, spec_tree, mesh: Mesh):
    """Each leaf of a tree (nested dicts, ``NamedTuple`` fields, ``None``)
    on ``mesh``'s ``DeviceMesh`` by its spec: a plain tensor distributed
    (every rank holds the same whole tensor, made from one seed; DTensor
    takes rank 0's), a DTensor redistributed.  A mesh without a
    ``DeviceMesh`` raises: nothing is placed on a description."""
    if mesh.device_mesh is None:
        raise ValueError(f"the mesh {dict(mesh.shape)} has no DeviceMesh to place on")
    from torch.distributed.tensor import distribute_tensor

    def one(x, spec):
        pl = placements(mesh, spec)
        if is_placed(x):
            return x.redistribute(mesh.device_mesh, pl)
        return distribute_tensor(x.to(mesh.device), mesh.device_mesh, pl)

    def walk(x, spec):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(x[k], spec[k]) for k in x}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(a, b) for a, b in zip(x, spec)))
        return one(x, spec)

    return walk(tree, spec_tree)


def active_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Run under ``rules``.  On a mesh with a ``DeviceMesh``, a plain
    tensor that meets a DTensor in an op counts as replicated
    (``implicit_replication``): the model makes such tensors (positions,
    masks, running sums) from global shapes, the same on every rank."""
    placed = contextlib.nullcontext()
    if rules is not None and rules.mesh.device_mesh is not None:
        from torch.distributed.tensor.experimental import implicit_replication

        placed = implicit_replication()
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        with placed:
            yield rules
    finally:
        _STATE.rules = prev


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axes: a rank
    check under active rules (a ``ValueError`` on a mismatch), then a
    DTensor redistributed to ``placements(axes, x.shape)`` (and described
    as its shard is laid out, :func:`_as_laid_out`); a plain tensor is
    returned unchanged."""
    rules = active_rules()
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"rank mismatch: {axes} vs {tuple(x.shape)}")
    if not is_placed(x):
        return x
    return _as_laid_out(x.redistribute(x.device_mesh,
                                       rules.placements(tuple(axes), tuple(x.shape))))


def _as_laid_out(x):
    """A DTensor whose new local shard is contiguous, with the contiguous
    global stride.  A redistribution keeps the global stride of the tensor
    it started from (an einsum's output is a permuted view) while the
    shard it makes is contiguous; an op that then views by the global
    stride (the next einsum's reshape) fails on the shard."""
    loc = x.to_local()
    if x.is_contiguous() or not loc.is_contiguous():
        return x
    from torch.distributed.tensor import DTensor

    stride = [1] * x.ndim
    for d in range(x.ndim - 2, -1, -1):
        stride[d] = stride[d + 1] * x.shape[d + 1]
    return DTensor.from_local(loc, x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=tuple(stride))
