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
mesh and every unplaced path run as before.  :func:`meta_mesh` holds a
``DeviceMesh`` whose arrays live on ``meta``: the dry run's placed mesh,
where :func:`place` makes each leaf rank 0's shard with no memory.
:func:`check_devices` refuses a mesh that is not one rank a device of
the group.

Where GSPMD partitions an op that DTensor cannot (a view of a dim cut
inside its leading part; on torch 2.11, a view of several dims as one
where any but the first is cut), the model calls a named redistribution
that is the identity on a plain tensor: :func:`unflatten` and
:func:`flatten` view dims as several or as one, :func:`matmul` gathers
a cut sequence before a product, :func:`take_rows` picks a table's rows
for each rank's own index rows, :func:`row_local` runs a per-row
function (what the reference ``vmap``s over the batch) on each rank's
own rows and :func:`local_over` an attention core on each rank's own
batch and heads.
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
    ``device_mesh`` the ranks' ``DeviceMesh`` (``None``: a description),
    whose dims are ``device_axes``' groups of adjacent axes."""

    shape: dict
    device: torch.device
    device_mesh: Any = None
    # the DeviceMesh's dims as groups of axis names (None: one axis a dim)
    device_axes: Optional[tuple] = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def groups(self) -> tuple:
        """The axes each dim of the ``DeviceMesh`` stands for."""
        return self.device_axes or tuple((a,) for a in self.shape)


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


def meta_mesh(sizes, names, device_axes=None) -> Mesh:
    """A mesh of ``sizes`` over ``names`` whose arrays live on ``meta`` and
    that holds a ``DeviceMesh`` (of the CPU's device type) over the
    initialised group's ranks, one a device (:func:`check_devices`).  The
    dry run's placed mesh: its workers open a ``fake`` group of
    ``mesh.size`` ranks as rank 0, :func:`place` makes each leaf rank 0's
    shard on ``meta``, and a step then runs every redistribution and
    collective its placements call for, on shapes alone.  ``device_axes``
    groups adjacent axes into one dim of the ``DeviceMesh`` (axes every
    spec cuts together, as the data-parallel ("pod", "data")): one
    collective then spans the group's ranks, as XLA's does."""
    if not dist.is_initialized():
        raise ValueError("a placed meta mesh needs an initialised process group")
    mesh = dataclasses.replace(make_mesh(sizes, names, device="meta"),
                               device_axes=None if device_axes is None
                               else tuple(map(tuple, device_axes)))
    if [a for g in mesh.groups for a in g] != list(mesh.shape):
        raise ValueError(f"device axes {mesh.groups} are not the axes {tuple(mesh.shape)} in order")
    check_devices(mesh)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh("cpu", tuple(math.prod(mesh.shape[a] for a in g) for g in mesh.groups),
                          mesh_dim_names=tuple("_".join(g) for g in mesh.groups))
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
    """A partition spec as DTensor placements, one a dim of the mesh's
    ``DeviceMesh`` (a mesh axis, or a group of them, ``Mesh.groups``) in
    the mesh's order: ``Shard(d)`` where the axis cuts tensor dim ``d``,
    ``Replicate()`` elsewhere, and on an axis of one device, which cuts
    nothing (a ``Shard`` there would stop DTensor from merging the dim in
    a view, as a decode step's ``seq`` of 1).  JAX cuts a dim named by a
    tuple of axes major to minor in the tuple's order, DTensor in
    mesh-axis order, so a tuple against the mesh's order (a layout
    DTensor's ``Shard`` cannot hold) raises, as does a spec that cuts a
    part of a group."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate()] * len(mesh.groups)
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
        for i, group in enumerate(mesh.groups):
            cut = [a for a in group if a in axes]
            if cut and len(cut) < len(group):
                raise ValueError(f"spec {spec} cuts dim {d} by {axes}, a part of the "
                                 f"device mesh dim {group}")
            if cut and math.prod(mesh.shape[a] for a in group) > 1:
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


def unshard(x, *dims: int):
    """A DTensor redistributed so that no mesh axis cuts ``dims``, its
    other placements kept: the explicit redistribution before an op whose
    DTensor strategy fails on a cut dim.  A plain tensor as it is."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def unflatten(x, dim: int, sizes: tuple):
    """``x.unflatten(dim, sizes)``.  On a DTensor, the mesh axes that cut
    ``dim`` are first gathered (an explicit all-gather, :func:`unshard`)
    unless their product divides ``sizes[0]``: DTensor cannot view a cut
    dim as several when the cut falls inside the leading one (a 16-way
    cut of 8 KV heads' columns, of a 256-row batch viewed as 2
    microbatches, of an SSD's 24 heads)."""
    if is_placed(x):
        from torch.distributed.tensor import Shard

        dim %= x.ndim
        cuts = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                         if isinstance(p, Shard) and p.dim == dim)
        if sizes[0] % cuts:
            x = unshard(x, dim)
    return x.unflatten(dim, sizes)


def matmul(x, w):
    """``x @ w`` for x (..., d) and w (d, n).  ``aten.matmul`` views x's
    leading dims as one; DTensor of torch 2.11 cannot view dims as one
    where a mesh axis cuts any but the first (a sequence cut between
    blocks, sequence parallelism), so on a DTensor those cuts are gathered
    first (an explicit all-gather, as Megatron's sequence parallelism
    gathers the sequence before a column-parallel product).  The product
    is then redistributed to its own placements, so that its gradient
    comes back in them before the backward's products view it the same
    way."""
    if not (is_placed(x) and x.ndim > 2):
        return x @ w
    return _grad_as_output(unshard(x, *range(1, x.ndim - 1)) @ w)


def take_rows(table, idx):
    """``table[idx]``: rows of a table picked by an index tensor.  On a
    mesh each rank picks the rows of its own index rows (dim 0 of
    ``idx``, the batch) from the whole table; the table's gradient is
    each rank's picks summed over the ranks whose index rows differ (a
    partial sum, which DTensor reduces into the table's placements).
    DTensor of torch 2.11 has no working strategy for the backward
    (``index_put``) of a table indexed by a cut index; with no gradient to
    take (serving) the rows are DTensor's own pick, which gathers no
    table."""
    if not (is_placed(table) or is_placed(idx)) or not (
            torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (idx if is_placed(idx) else table).device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in idx.placements) if is_placed(idx) else (Replicate(),) * mesh.ndim
    if is_placed(table):
        sums = [Partial() if isinstance(p, Shard) else Replicate() for p in rows]
        table = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=sums)
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    if is_placed(idx):
        idx = idx.redistribute(mesh, rows).to_local()
    return DTensor.from_local(table[idx], mesh, rows, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _grad_as_output(y):
    """The DTensor ``y`` redistributed to its own placements: nothing moves
    in the forward, and the backward brings the gradient to them."""
    return y.redistribute(y.device_mesh, y.placements)


def local_over(*dims):
    """A decorator: ``fn`` run on each rank's own block of ``dims`` (an
    attention core's batch and heads, each block's work independent of
    the others') where the reference lets GSPMD partition the ops inside.
    DTensor of torch 2.11 cannot run them partitioned: each batched
    product views the batch and the heads as one dim, both cut.  With no
    DTensor among the arguments, or one cut outside ``dims`` (a cache's
    head dim cut for few KV heads: a contraction DTensor sums over the
    ranks, where blocks would gather the cache), ``fn`` is called as it
    is.  Otherwise the first DTensor argument's cuts are the blocks: each tensor argument is redistributed
    to them (a plain tensor taken as replicated, so a local slice; an
    argument keeps the cuts of the dims it has), ``fn`` runs on the local
    tensors, and each tensor it returns becomes a DTensor of those
    placements.  ``to_local`` and ``from_local`` carry gradients."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            placed = [a for a in args if is_placed(a)]
            if not placed:
                return fn(*args, **kwargs)
            from torch.distributed.tensor import DTensor, Replicate, Shard

            if any(isinstance(p, Shard) and p.dim not in dims
                   for a in placed for p in a.placements):
                return fn(*args, **kwargs)
            first = placed[0]
            mesh = first.device_mesh

            def blocks(t):
                return tuple(p if isinstance(p, Shard) and p.dim < t.ndim else Replicate()
                             for p in first.placements)

            def down(a):
                if not torch.is_tensor(a):
                    return a
                if not is_placed(a):
                    a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
                return a.redistribute(mesh, blocks(a)).to_local()

            n = math.prod(mesh.size(i) for i, p in enumerate(first.placements)
                          if isinstance(p, Shard))
            prev = getattr(_STATE, "blocks", None)
            _STATE.blocks = (prev or 1) * n
            try:
                out = fn(*(down(a) for a in args), **kwargs)
            finally:
                _STATE.blocks = prev
            def up(t):  # a cut dim of a result is the first argument's (maybe uneven)
                pl = blocks(t)
                cuts = [1] * t.ndim
                for i, p in enumerate(pl):
                    if isinstance(p, Shard):
                        cuts[p.dim] *= mesh.size(i)
                shape = tuple(first.shape[d] if cuts[d] > 1 else n for d, n in enumerate(t.shape))
                if shape == tuple(n * c for n, c in zip(t.shape, cuts)):
                    return DTensor.from_local(t, mesh, pl, run_check=False)
                return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False, shape=shape,
                                          stride=_contiguous_stride(shape))

            return _map_tensors(up, out)

        return wrapped

    return decorate


def local_blocks() -> Optional[int]:
    """How many blocks the work in progress is one of: inside a
    :func:`local_over` call on a mesh, the product of the sizes of the
    mesh axes that cut its blocks (the dry run's meter counts a block's
    flops this many times); None outside."""
    return getattr(_STATE, "blocks", None)


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``.  On a DTensor the flattened tensor is then
    redistributed to its own placements: nothing moves in the forward,
    and the backward brings the gradient to those placements (an explicit
    all-gather where it comes back cut) before the view that unflattens
    it, which DTensor cannot make of a gradient cut inside the leading dim
    (a weight's columns cut 16 ways behind 8 KV heads, an SSD output cut
    16 ways behind 24 heads)."""
    y = x.flatten(start, end)
    return _grad_as_output(y) if is_placed(y) else y


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
    takes rank 0's), a DTensor redistributed.  On a :func:`meta_mesh` a
    plain leaf becomes rank 0's shard (the ceiling shard, the one
    :func:`shards` counts), empty on ``meta``, at the leaf's global shape
    and stride.  A mesh without a ``DeviceMesh`` raises: nothing is placed
    on a description."""
    if mesh.device_mesh is None:
        raise ValueError(f"the mesh {dict(mesh.shape)} has no DeviceMesh to place on")
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, spec):
        pl = placements(mesh, spec)
        if is_placed(x):
            return x.redistribute(mesh.device_mesh, pl)
        if mesh.device.type == "meta":
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

            shape, _ = compute_local_shape_and_global_offset(x.shape, mesh.device_mesh, pl)
            return DTensor.from_local(torch.empty(shape, dtype=x.dtype, device="meta"),
                                      mesh.device_mesh, pl, run_check=False,
                                      shape=x.shape, stride=x.stride())
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

    return DTensor.from_local(loc, x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=_contiguous_stride(x.shape))
