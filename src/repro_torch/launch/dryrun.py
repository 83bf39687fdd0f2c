"""Dry run: every (arch x shape x mesh) cell's step on the ``meta`` device.

The port of ``repro.launch.dryrun``.  For each cell this builds the
params (``model.abstract``), the train state (``train_step.
abstract_state``), the caches and the inputs on ``meta``, where a tensor
has a shape and a dtype and no memory, and runs the real step function
under the mesh's sharding rules and a meter (``StepMeter``):

  train    train_step.make_train_step(..., remat=True)
  prefill  model.prefill(..., headroom=0)
  decode   model.decode_step

The 1 x 1 cell runs unplaced.  A ``16x16`` or ``2x16x16`` cell runs
placed, in a spawned worker of its own (``run_grid``) that opens a
``fake`` process group of the mesh's size as rank 0 (``fake_group``;
the process that calls the dry run never holds a group).  There every
leaf is rank 0's shard on ``meta`` (``sharding.meta_mesh``,
``sharding.place``) and the step runs as DTensor partitions it: each
redistribution and collective that its placements call for is made, on
shapes alone.  What a placed run proves is what the reference's
``.lower().compile()`` proves of its sharding: every placement composes
through the whole step, and every collective is one DTensor can issue.
A meta run also proves that the step reads nothing on the host
(``.item()`` of a meta tensor raises).  A cell that fails placed is an
``error`` with DTensor's message; nothing falls back to the unplaced
count.

Each cell reports, per device of its mesh:

- ``argument_bytes``: each leaf's bytes over ``sharding.shards(mesh,
  spec)`` (a shard holds the ceiling of each dim), summed over the
  params, optimizer state, caches and batch: exact arithmetic, and what
  ``fits_80GB`` reads;
- ``step_bytes_estimate``: the most bytes the eager step held at once
  beyond its arguments (temporaries and outputs), by a dispatch mode that
  adds each new storage's bytes and takes them off when the storage is
  freed: on the 1 x 1 card the whole step's, on a placed mesh rank 0's
  shards'; an estimate, since meta tensors have no allocator;
- ``collectives``: the bytes of every collective rank 0 issues, by kind
  (all-gather, all-reduce, reduce-scatter, all-to-all,
  collective-permute) and in all (``total``), in the reference's
  output-shape convention (``roofline.collective_bytes``), with their
  counts (``collective_calls``); ``null`` on the 1 x 1 card;
- the flops ``FlopCounterMode``'s formulas count (matrix products and
  attention) over the whole step, and the roofline terms: those flops,
  the bytes the step must move (``roofline.step_bytes``, the count that
  the serving and training steps' least times read: a decode's weights,
  caches and states over the shape's whole context, a prefill's weights,
  a train step's state; not what the eager operations happen to read and
  write), each over the mesh's devices, the collective bytes over
  ``roofline.LINK_BW``, with ``model_flops_estimate`` as
  ``model_flops``.

An eager meta run dispatches every operation, so a full-depth
``prefill_32k`` takes minutes of host time.  Two things make a cell
cheap and keep its flops exact:

- **depth**: every looped unit is the same work, so a count is
  ``a + n_units * b``.  The step runs with the unit stack cut to one and
  to two units (the leading dense and the remainder layers kept) and the
  counts (collectives too) are carried to the config's unit count.  This
  stands where the reference's ``hlo_analysis`` multiplies a while body
  by its trip count.  The operations carried so are an estimate: at one
  unit a ``.contiguous()`` of an already contiguous view copies nothing.
- **length** (prefill only, past ``SEQ_CHECK``): on the chunked attention
  path (``attend``: ``q_chunk`` 512, ``kv_chunk`` 1024) a prefill's flops
  are a quadratic in the length.  The step runs at ``SEQ_POINTS``; the
  quadratic through them must give the count at ``SEQ_CHECK`` exactly,
  or the cell runs at its own length.  The operations and collectives
  are carried by the same fit, the peak by a line through the two
  longest runs: estimates.

``tests/test_torch_launch.py`` holds these flops equal to full-depth,
full-length meta runs' wherever those are cheap;
``tests/test_torch_dryrun_placed.py`` holds the collectives' bytes to
the reference's convention and runs placed cells at full width.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--jobs 6] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass, replace
from fractions import Fraction
from multiprocessing import get_context

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import sharding as shd
from ..configs import ARCHS, get_config
from ..models import model
from ..models.transformer import split_layers, unit_pattern
from ..serve.serve_step import cache_pspecs
from ..train import optimizer as optim
from ..train import train_step as ts
from . import roofline as rf
from .mesh import make_production_mesh
from .shapes import SHAPES, ShapeSpec, cell_applicable, spec_inputs

# per-arch overrides that make the big cells fit 16 GiB a chip (the reference's)
DRYRUN_OVERRIDES = {
    "grok-1-314b": dict(opt_dtype="bfloat16", microbatches=8),
    "starcoder2-15b": dict(opt_dtype="bfloat16"),
    "deepseek-v2-lite-16b": dict(opt_dtype="bfloat16", microbatches=2),
    "whisper-large-v3": dict(microbatches=2),
    "qwen2-vl-7b": dict(microbatches=2),
    "recurrentgemma-9b": dict(microbatches=4),
}

DEVICE_BYTES = 80 * 2**30  # an H100's HBM
SEQ_POINTS = (3072, 4096, 5120)  # lengths on the chunked path the length fit runs at
SEQ_CHECK = 6144  # the fit must give this length's count exactly


def one_card() -> shd.Mesh:
    """The 1 x 1 mesh as a description, in a process with a process group too."""
    return shd.make_mesh((1, 1), ("data", "model"), device="meta")


MESHES = {"1x1": one_card,
          "16x16": lambda: make_production_mesh(multi_pod=False),
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}
PLACED = ("16x16", "2x16x16")  # meshes whose cells run placed, each in a worker
# a placed mesh's DeviceMesh dims: the data-parallel axes, which every rule
# cuts together, as one dim of 32 ranks.  DTensor then issues one collective
# over them where XLA does, and plans each redistribution over two mesh dims:
# over three it plans some by a graph search (40 minutes of host time for one
# train cell).
DEVICE_AXES = {"2x16x16": (("pod", "data"), ("model",))}
NO_COLLECTIVES = "one device runs no collective"
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")  # the reference's kinds (roofline._COLLECTIVES)


# ---------------------------------------------------------------------------
# What a step does on meta
# ---------------------------------------------------------------------------


def _tensors(values) -> list:
    """The tensors among ``values`` and in their lists and tuples."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(_tensors(v))
    return out


def _collective_kinds() -> dict:
    """{op packet: kind} of the collectives a placed step issues."""
    f = torch.ops._c10d_functional
    kinds = {f.all_gather_into_tensor: "all-gather",
             f.all_gather_into_tensor_coalesced: "all-gather",
             f.all_reduce: "all-reduce", f.all_reduce_coalesced: "all-reduce",
             f.reduce_scatter_tensor: "reduce-scatter",
             f.reduce_scatter_tensor_coalesced: "reduce-scatter",
             f.all_to_all_single: "all-to-all"}
    if hasattr(torch.ops, "_dtensor") and hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        kinds[torch.ops._dtensor.shard_dim_alltoall] = "all-to-all"
    return kinds


_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")
_MOVES_NOTHING = ("_c10d_functional::wait_tensor", "_c10d_functional::_wrap_tensor_autograd",
                  "c10d_functional::wait_tensor")


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors((out,)))


class StepMeter(TorchDispatchMode):
    """Counts a step's aten operations, their flops (by the formulas of
    ``FlopCounterMode``, ``flop_registry``: matrix products, convolutions
    and attention), the most bytes of storage the step held at once, and
    the collectives it issued.

    A storage is new when no tensor input of the operation shares it; its
    bytes count from the operation that made it until the last tensor
    made on it inside the meter is freed.  Storages of the arguments,
    made before the meter, never count.

    On DTensors (a placed step) the meter sees each operation twice: at
    the DTensor level, on global shapes, where it counts the flops (the
    whole step's, as unplaced) and lets DTensor run (``NotImplemented``),
    and then as the plain operations DTensor issues on rank 0's shards,
    where it counts the operations, the storages and the collectives (and
    the flops of a block that ``sharding.local_over`` runs on local
    tensors, times the blocks it is one of).  A
    collective's bytes are its output's (the reference's output-shape
    convention, ``roofline.collective_bytes``).  On a CPU mesh DTensor
    makes an all-to-all of an all-gather and a chunk
    (``shard_dim_alltoall``); the meter counts it as the all-to-all an
    NCCL mesh runs, with that operation's output bytes.  An operation of
    a collective namespace the meter does not know raises."""

    def __init__(self, placed: bool = False):
        super().__init__()
        self.placed = placed
        self.ops = 0
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_calls = dict.fromkeys(COLLECTIVES, 0)
        self._refs: dict = {}  # storage -> [bytes, tensors alive]
        self._kinds = _collective_kinds()
        self._in_alltoall = 0
        self._patched: list = []
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor, self._fake = DTensor, FakeTensor

    def _release(self, key) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def _collective(self, kind: str, out) -> None:
        self.coll_bytes[kind] += _nbytes(out)
        self.coll_calls[kind] += 1

    def collectives(self) -> dict:
        """{kind: bytes} and ``total``, then {``calls:``kind: count}."""
        out = {k: self.coll_bytes[k] for k in COLLECTIVES}
        out["total"] = sum(self.coll_bytes.values())
        out.update({f"calls:{k}": self.coll_calls[k] for k in COLLECTIVES})
        return out

    def __enter__(self):
        from torch.distributed.tensor import _collective_utils, placement_types

        def counted(real):
            def shard_dim_alltoall(*args, **kwargs):
                self._in_alltoall += 1
                try:
                    out = real(*args, **kwargs)
                finally:
                    self._in_alltoall -= 1
                self._collective("all-to-all", out)
                return out
            return shard_dim_alltoall

        for mod in (_collective_utils, placement_types):
            real = getattr(mod, "shard_dim_alltoall", None)
            if real is not None:
                self._patched.append((mod, real))
                mod.shard_dim_alltoall = counted(real)
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, real in self._patched:
            mod.shard_dim_alltoall = real
        self._patched.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._fake) for t in types):
            return func(*args, **kwargs)  # DTensor's sharding propagation, not the step
        if any(issubclass(t, self._dtensor) for t in types):
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=None)
            return NotImplemented  # DTensor runs it, as plain operations on shards
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        if self.placed and not any(t.device.type == "meta" for t in ins + _tensors((out,))):
            return out  # DTensor's own index arithmetic on the host, not the step
        self.ops += 1
        kind = self._kinds.get(func.overloadpacket)
        if kind is not None:
            if not self._in_alltoall:
                self._collective(kind, out)
        elif func.namespace in _COLLECTIVE_NAMESPACES and func._schema.name not in _MOVES_NOTHING:
            raise NotImplementedError(f"the dry run's meter does not count {func}")
        elif not self.placed or shd.local_blocks():
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out) * (shd.local_blocks() or 1)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in _tensors((out,)):
            key = t.untyped_storage()._cdata
            if key in self._refs:
                self._refs[key][1] += 1
            elif key in in_keys:
                continue  # a view of, or a write into, an argument
            else:
                nbytes = t.untyped_storage().nbytes()
                self._refs[key] = [nbytes, 1]
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, key)
        return out


def _batch_specs(rules, batch) -> dict:
    """Each batch leaf's spec: its rows over the batch axes where they divide."""
    return {k: rules.spec(("batch",) + (None,) * (v.ndim - 1), tuple(v.shape))
            for k, v in batch.items()}


def _step(cfg, spec: ShapeSpec, microbatches: int, ocfg, rules=None):
    """The cell's step as a thunk over its meta inputs; with ``rules`` of a
    placed mesh, each input placed by its spec (``sharding.place``: rank
    0's shard), as the reference's ``in_shardings`` place them."""
    placed = rules is not None and rules.mesh.device_mesh is not None
    put = (lambda tree, specs: shd.place(tree, specs, rules.mesh)) if placed else (
        lambda tree, specs: tree)
    if spec.kind == "train":
        state = ts.abstract_state(cfg, ocfg)
        batch = spec_inputs(cfg, spec)["batch"]
        if placed:
            state = put(state, ts.state_pspecs(cfg, ocfg, rules))
            batch = put(batch, _batch_specs(rules, batch))
        step = ts.make_train_step(cfg, ocfg, microbatches=microbatches, remat=True)
        return lambda: step(state, batch)
    params = model.abstract(cfg)
    if placed:
        params = put(params, model.partition_pspecs(cfg, rules))
    if spec.kind == "prefill":
        batch = spec_inputs(cfg, spec)["batch"]
        if placed:
            batch = put(batch, _batch_specs(rules, batch))
        return lambda: model.prefill(params, cfg, batch, headroom=0)
    inputs = spec_inputs(cfg, spec)
    cache, tokens = inputs["cache"], inputs["tokens"]
    if placed:
        cache = put(cache, cache_pspecs(cfg, rules, cache))
        tokens = put(tokens, rules.spec(("batch", None), tuple(tokens.shape)))
    return lambda: model.decode_step(params, cfg, cache, tokens)


def measure(cfg, spec: ShapeSpec, *, microbatches: int = 1, ocfg=None, mesh=None) -> dict:
    """One meta run of ``cfg``'s step at ``spec`` on ``mesh`` (the 1 x 1
    card unless given; a ``sharding.meta_mesh`` runs it placed): its
    counted flops, its peak bytes beyond its arguments, its aten
    operations and, placed, its collectives (``StepMeter.collectives``)."""
    ocfg = ocfg or optim.OptConfig()
    mesh = mesh or one_card()
    placed = mesh.device_mesh is not None
    rules = shd.ShardingRules.for_config(mesh, cfg, decode=spec.kind == "decode")
    thunk = _step(cfg, spec, microbatches, ocfg, rules)
    grad = torch.enable_grad() if spec.kind == "train" else torch.no_grad()
    with grad, shd.use_rules(rules), StepMeter(placed=placed) as m:
        out = thunk()
        del out
    counts = {"flops": m.flops, "peak": m.peak, "ops": m.ops}
    if placed:
        counts.update(m.collectives())
    return counts


def with_units(cfg, n_units: int):
    """``cfg`` with its looped units cut to ``n_units``; the leading dense
    and the remainder layers stay."""
    prefix, _, tail = split_layers(cfg)
    return cfg.replace(n_layers=prefix + n_units * len(unit_pattern(cfg)) + len(tail))


def _at_depth(counts1: dict, counts2: dict, n_units: int) -> dict:
    """Counts at ``n_units`` from those at one and two units; the peak at
    least the larger measured."""
    out = {k: counts1[k] + (n_units - 1) * (counts2[k] - counts1[k]) for k in counts1}
    out["peak"] = max(out["peak"], counts1["peak"], counts2["peak"])
    return out


def _quadratic_at(points, values, x) -> Fraction:
    """The quadratic through three (point, value) pairs, at ``x``."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(points, values)):
        term = Fraction(yi)
        for j, xj in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def _length_fit(fn, spec: ShapeSpec):
    """``fn(length)``'s counts at ``spec.seq``: the flops, operations and
    collectives by the quadratic through ``SEQ_POINTS``; the peak by the line through the
    two longest runs (it grows with the activations, the logits and the
    cache, each linear in the length).  None unless the quadratic gives
    ``fn(SEQ_CHECK)``'s flops, and a placed run's collectives, exactly:
    DTensor picks each op's layout by its sizes, so the collectives of
    some placed prefills follow no one quadratic in the length."""
    runs = [fn(s) for s in SEQ_POINTS]
    check = fn(SEQ_CHECK)
    exact = [k for k in check if k == "flops" or k in COLLECTIVES or k.startswith("calls:")]
    if any(_quadratic_at(SEQ_POINTS, [r[k] for r in runs], SEQ_CHECK) != check[k]
           for k in exact):
        return None
    out = {k: _quadratic_at(SEQ_POINTS, [r[k] for r in runs], spec.seq)
           for k in runs[0] if k != "peak"}
    slope = Fraction(check["peak"] - runs[-1]["peak"], SEQ_CHECK - SEQ_POINTS[-1])
    out["peak"] = max(check["peak"], check["peak"] + slope * (spec.seq - SEQ_CHECK))
    return {k: int(v) if v.denominator == 1 else float(v) for k, v in out.items()}


def count_cell(cfg, spec: ShapeSpec, *, microbatches: int = 1, ocfg=None, mesh=None) -> dict:
    """``measure``'s counts for the whole config at ``spec`` on ``mesh``,
    from cut runs (see the module docstring).  ``method`` says how they
    were had."""
    _, n_units, _ = split_layers(cfg)
    kw = dict(microbatches=microbatches, ocfg=ocfg, mesh=mesh)

    def at(length: int) -> dict:
        s = replace(spec, seq=length)
        if n_units <= 2:
            return measure(cfg, s, **kw)
        one = measure(with_units(cfg, 1), s, **kw)
        two = measure(with_units(cfg, 2), s, **kw)
        return _at_depth(one, two, n_units)

    depth = "units 1, 2" if n_units > 2 else "full depth"
    if spec.kind == "prefill" and spec.seq > SEQ_CHECK and spec.seq % 1024 == 0:
        counts = _length_fit(at, spec)
        if counts is not None:
            return {**counts, "method": f"{depth}; lengths {SEQ_POINTS} checked at "
                    f"{SEQ_CHECK}"}
    return {**at(spec.seq), "method": f"{depth}; full length"}


# ---------------------------------------------------------------------------
# Bytes a device holds
# ---------------------------------------------------------------------------


def _leaf_pairs(tree, specs):
    """(tensor, spec) over a value tree and its partition-spec tree: dicts,
    NamedTuples and tuples walked by the values, ``None`` no leaf."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaf_pairs(tree[k], specs[k])
    else:
        for t, s in zip(tree, specs):
            yield from _leaf_pairs(t, s)


def shard_bytes(mesh, tree, specs) -> int:
    """Bytes of one device's shards of ``tree``: each leaf cut into
    ``sharding.shards(mesh, spec)`` pieces a dim, a piece the ceiling."""
    total = 0
    for t, spec in _leaf_pairs(tree, specs):
        parts = shd.shards(mesh, spec) if spec else (1,) * t.ndim
        total += math.prod(-(-d // n) for d, n in zip(t.shape, parts)) * t.element_size()
    return total


def argument_bytes(cfg, spec: ShapeSpec, mesh, ocfg) -> dict:
    """Per-device bytes of the step's arguments, by kind."""
    rules = shd.ShardingRules.for_config(mesh, cfg, decode=spec.kind == "decode")

    def batch_bytes(batch):
        return shard_bytes(mesh, batch, _batch_specs(rules, batch))

    inputs = spec_inputs(cfg, spec)
    if spec.kind == "train":
        state = ts.abstract_state(cfg, ocfg)
        pspecs = ts.state_pspecs(cfg, ocfg, rules)
        return {"params": shard_bytes(mesh, state.params, pspecs.params),
                "optimizer": shard_bytes(mesh, state.opt, pspecs.opt),
                "batch": batch_bytes(inputs["batch"])}
    params = shard_bytes(mesh, model.abstract(cfg), model.partition_pspecs(cfg, rules))
    if spec.kind == "prefill":
        return {"params": params, "batch": batch_bytes(inputs["batch"])}
    cache, tokens = inputs["cache"], inputs["tokens"]
    return {"params": params,
            "cache": shard_bytes(mesh, cache, cache_pspecs(cfg, rules, cache)),
            "batch": shard_bytes(mesh, tokens, rules.spec(("batch", None), tuple(tokens.shape)))}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    meshes: tuple
    microbatches: int = 1


def _settings(cell: Cell) -> tuple:
    """(cfg, spec, optimizer config, microbatches) of a cell."""
    cfg, spec = get_config(cell.arch), SHAPES[cell.shape]
    ov = DRYRUN_OVERRIDES.get(cell.arch, {})
    ocfg = optim.OptConfig(opt_dtype=ov.get("opt_dtype", "float32"))
    mb = cell.microbatches if cell.microbatches != 1 else ov.get("microbatches", 1)
    return cfg, spec, ocfg, mb if spec.kind == "train" else 1


def _skipped(cell: Cell, name: str):
    """The cell's ``skipped`` result on mesh ``name``, or None if it applies."""
    ok, why = cell_applicable(get_config(cell.arch), cell.shape)
    if ok:
        return None
    return {"arch": cell.arch, "shape": cell.shape, "mesh": name, "status": "skipped",
            "reason": why}


def run_on(cell: Cell, name: str) -> dict:
    """The cell's result on the mesh ``name``, in this process.  A mesh of
    ``PLACED`` runs placed, and needs this process to hold the ``fake``
    group of its size (``fake_group``: a dry-run worker's)."""
    skipped = _skipped(cell, name)
    if skipped is not None:
        return skipped
    cfg, spec, ocfg, mb = _settings(cell)
    mesh = MESHES[name]()
    placed = name in PLACED
    t0 = time.perf_counter()
    run_mesh = shd.meta_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                             DEVICE_AXES.get(name)) if placed else None
    counts = count_cell(cfg, spec, microbatches=mb, ocfg=ocfg, mesh=run_mesh)
    seconds = time.perf_counter() - t0
    mf = rf.model_flops_estimate(cfg, spec.kind, spec.batch, spec.seq)
    whole = argument_bytes(cfg, spec, one_card(), ocfg)
    must_move = rf.step_bytes(cfg, spec.kind, spec.batch, spec.seq,
                              state_bytes=whole["params"] + whole.get("optimizer", 0),
                              param_bytes=whole["params"])
    chips = mesh.size
    args = argument_bytes(cfg, spec, mesh, ocfg)
    arg_b = sum(args.values())
    coll = {k: counts[k] for k in COLLECTIVES + ("total",)} if placed else None
    roof = rf.Roofline(flops=counts["flops"] / chips, bytes_accessed=must_move / chips,
                       coll_bytes=coll["total"] if placed else 0.0, chips=chips,
                       model_flops=mf)
    terms = roof.as_dict()
    if not placed:
        terms["coll_bytes_per_device"] = terms["t_collective_s"] = None
    out = {
        "arch": cell.arch, "shape": cell.shape, "mesh": name, "chips": chips,
        "status": "ok", "seconds": seconds, "microbatches": mb,
        "opt_dtype": ocfg.opt_dtype, "method": counts["method"],
        "memory": {
            "argument_bytes": arg_b,
            "argument_bytes_by_kind": args,
            "step_bytes_estimate": counts["peak"],  # placed: rank 0's own storages
            "fits_80GB": arg_b < DEVICE_BYTES,
        },
        "flops": counts["flops"],
        "aten_ops": counts["ops"],
        "collectives": coll,
        "roofline": terms,
    }
    if placed:
        calls = {k: counts[f"calls:{k}"] for k in COLLECTIVES}
        out["collective_calls"] = {**calls, "total": sum(calls.values())}
    else:
        out["collectives_reason"] = NO_COLLECTIVES
    return out


@contextlib.contextmanager
def fake_group(size: int):
    """A ``fake`` process group of ``size`` ranks with this process as rank
    0, for the block: a collective on it moves nothing, and on meta
    tensors it is a shape.  For the dry run's workers (``run_grid``): a
    process that already holds a group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a placed dry-run cell runs in a worker that holds no process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run_task(task: tuple) -> dict:
    """One (cell, mesh name): placed inside a ``fake_group`` of the mesh's
    size; an exception is the cell's ``error``, with its message."""
    cell, name = task
    try:
        if name in PLACED:
            with fake_group(MESHES[name]().size):
                return run_on(cell, name)
        return run_on(cell, name)
    except Exception as e:  # noqa: BLE001 - reported as the cell's status
        traceback.print_exc()
        return {"arch": cell.arch, "shape": cell.shape, "mesh": name, "status": "error",
                "error": f"{type(e).__name__}: {e}"}


def run_cell(cell: Cell) -> list:
    """The cell's result on each of its meshes (a list of dicts, in
    ``cell.meshes``' order), by ``run_grid``."""
    got = {r["mesh"]: r for _, res in run_grid([cell]) for r in res}
    return [got[m] for m in cell.meshes]


def _worker_init() -> None:
    torch.set_num_threads(1)


_KIND_ORDER = {"train": 0, "prefill": 1, "decode": 2}


def run_grid(cells, jobs: int = 1):
    """Each (cell, mesh)'s result as it ends; yields (cell, [result]).  A
    placed mesh's cell runs in a spawned worker (one thread, its own
    ``fake_group``, closed when the cell ends), so the calling process
    never holds a process group; with ``jobs`` above one every cell runs
    in ``jobs`` such workers, the longest kinds first, else the 1 x 1
    cells run here.  Skipped cells are yielded first."""
    tasks = []
    for c in cells:
        for m in c.meshes:
            skipped = _skipped(c, m)
            if skipped is not None:
                yield c, [skipped]
            else:
                tasks.append((c, m))
    here = [t for t in tasks if jobs <= 1 and t[1] not in PLACED]
    away = sorted((t for t in tasks if t not in here),
                  key=lambda t: (_KIND_ORDER[SHAPES[t[0].shape].kind], t[1] not in PLACED))
    for t in here:
        yield t[0], [_run_task(t)]
    if not away:
        return
    with ProcessPoolExecutor(max_workers=max(1, min(jobs, len(away))),
                             mp_context=get_context("spawn"), initializer=_worker_init) as pool:
        futures = {pool.submit(_run_task, t): t for t in away}
        for f in as_completed(futures):
            yield futures[f][0], [f.result()]


def summary(res: dict) -> str:
    tag = f"{res['arch']}__{res['shape']}__{res['mesh']}"
    if res["status"] != "ok":
        return f"[dryrun] {tag}: {res['status']} {res.get('reason') or res.get('error', '')}"
    m, r = res["memory"], res["roofline"]
    return (f"[dryrun] {tag}: ok {res['seconds']:.2f}s args/dev={m['argument_bytes'] / 2**30:.3f}GiB"
            f" step/dev~{m['step_bytes_estimate'] / 2**30:.3f}GiB fits={m['fits_80GB']}"
            f" flops={res['flops']:.4e} coll/dev={(res['collectives'] or {}).get('total', 0):.4e}B"
            f" bound={r['bound']} t_lb={r['step_time_lb_s']:.4e}s mfu={r['roofline_mfu']:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="16x16 and 2x16x16 (with the 1x1 card always)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=1, help="worker processes")
    ap.add_argument("--out", default="dryrun_out")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]
    if args.both_meshes:
        meshes = ("1x1", "16x16", "2x16x16")
    else:
        meshes = ("1x1", "2x16x16" if args.multi_pod else "16x16")
    cells = [Cell(a, s, meshes, args.microbatches) for a, s in pairs]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t0 = time.perf_counter()
    cells.sort(key=lambda c: _KIND_ORDER[SHAPES[c.shape].kind])
    for _, results in run_grid(cells, args.jobs):
        for res in results:
            tag = f"{res['arch']}__{res['shape']}__{res['mesh']}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=2)
            failures += res["status"] == "error"
            print(summary(res), flush=True)
    print(f"[dryrun] {len(cells)} cells x {len(meshes)} meshes in "
          f"{time.perf_counter() - t0:.1f}s, {failures} errors", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
