"""Dry run: every (arch x shape x mesh) cell's step on the ``meta`` device.

The port of ``repro.launch.dryrun``.  For each cell this builds the
params (``model.abstract``), the train state (``train_step.
abstract_state``), the caches and the inputs on ``meta``, where a tensor
has a shape and a dtype and no memory, and runs the real step function
under the mesh's sharding rules and a flop counter (``StepMeter``):

  train    train_step.make_train_step(..., remat=True)
  prefill  model.prefill(..., headroom=0)
  decode   model.decode_step

What a meta run proves: the shapes compose through the whole step, and
the step reads nothing on the host (``.item()`` of a meta tensor raises).
It does not prove what the reference's ``.lower().compile()`` proves: no
program is compiled, placed or partitioned across devices (the rules
check ranks and change nothing, ``sharding.constrain``), so a count does
not depend on the mesh and is taken once a cell.

Each cell reports, per device of its mesh:

- ``argument_bytes``: each leaf's bytes over ``sharding.shards(mesh,
  spec)`` (a shard holds the ceiling of each dim), summed over the
  params, optimizer state, caches and batch: exact arithmetic, and what
  ``fits_80GB`` reads;
- ``step_bytes_estimate``: the most bytes the eager step held at once
  beyond its arguments (temporaries and outputs), by a dispatch mode that
  adds each new storage's bytes and takes them off when the storage is
  freed, split evenly over the mesh: an estimate, since meta tensors have
  no allocator;
- the flops ``FlopCounterMode``'s formulas count (matrix products and
  attention), and the roofline terms: those flops, the bytes the step
  must move (``roofline.step_bytes``, the count that the serving and
  training steps' least times read: a decode's weights, caches and
  states over the shape's whole context, a prefill's weights, a train
  step's state; not what the eager operations happen to read and
  write), each over the mesh's devices, with ``model_flops_estimate`` as
  ``model_flops``.  Collective bytes are ``null``: one device runs no
  collective, and there is no HLO to read.

An eager meta run dispatches every operation, so a full-depth
``prefill_32k`` takes minutes of host time.  Two things make a cell
cheap and keep its flops exact:

- **depth**: every looped unit is the same work, so a count is
  ``a + n_units * b``.  The step runs with the unit stack cut to one and
  to two units (the leading dense and the remainder layers kept) and the
  counts are carried to the config's unit count.  This stands where the
  reference's ``hlo_analysis`` multiplies a while body by its trip count.
  The operations carried so are an estimate: at one unit a
  ``.contiguous()`` of an already contiguous view copies nothing.
- **length** (prefill only, past ``SEQ_CHECK``): on the chunked attention
  path (``attend``: ``q_chunk`` 512, ``kv_chunk`` 1024) a prefill's flops
  are a quadratic in the length.  The step runs at ``SEQ_POINTS``; the
  quadratic through them must give the count at ``SEQ_CHECK`` exactly,
  or the cell runs at its own length.  The operations are carried by the
  same fit, the peak by a line through the two longest runs: estimates.

``tests/test_torch_launch.py`` holds these flops equal to full-depth,
full-length meta runs' wherever those are cheap.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--jobs 6] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
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
NO_COLLECTIVES = ("one device runs no collective, and a meta run has no HLO to "
                  "read them from (launch/roofline.py)")


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


class StepMeter(TorchDispatchMode):
    """Counts a step's aten operations, their flops (by the formulas of
    ``FlopCounterMode``, ``flop_registry``: matrix products, convolutions
    and attention), and the most bytes of storage the step held at once.

    A storage is new when no tensor input of the operation shares it; its
    bytes count from the operation that made it until the last tensor
    made on it inside the meter is freed.  Storages of the arguments,
    made before the meter, never count."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}  # storage -> [bytes, tensors alive]

    def _release(self, key) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self.live -= ref[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
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


def _step(cfg, spec: ShapeSpec, microbatches: int, ocfg):
    """The cell's step as a thunk over its meta inputs."""
    if spec.kind == "train":
        state = ts.abstract_state(cfg, ocfg)
        batch = spec_inputs(cfg, spec)["batch"]
        step = ts.make_train_step(cfg, ocfg, microbatches=microbatches, remat=True)
        return lambda: step(state, batch)
    params = model.abstract(cfg)
    if spec.kind == "prefill":
        batch = spec_inputs(cfg, spec)["batch"]
        return lambda: model.prefill(params, cfg, batch, headroom=0)
    inputs = spec_inputs(cfg, spec)
    return lambda: model.decode_step(params, cfg, inputs["cache"], inputs["tokens"])


def measure(cfg, spec: ShapeSpec, *, microbatches: int = 1, ocfg=None) -> dict:
    """One meta run of ``cfg``'s step at ``spec``: its counted flops, its
    peak bytes beyond its arguments, and its aten operations."""
    ocfg = ocfg or optim.OptConfig()
    rules = shd.ShardingRules.for_config(one_card(), cfg,
                                         decode=spec.kind == "decode")
    thunk = _step(cfg, spec, microbatches, ocfg)
    grad = torch.enable_grad() if spec.kind == "train" else torch.no_grad()
    with grad, shd.use_rules(rules), StepMeter() as m:
        out = thunk()
        del out
    return {"flops": m.flops, "peak": m.peak, "ops": m.ops}


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
    """``fn(length)``'s counts at ``spec.seq``: the flops and operations by
    the quadratic through ``SEQ_POINTS``; the peak by the line through the
    two longest runs (it grows with the activations, the logits and the
    cache, each linear in the length).  None unless the quadratic gives
    ``fn(SEQ_CHECK)``'s flops exactly."""
    runs = [fn(s) for s in SEQ_POINTS]
    check = fn(SEQ_CHECK)
    flops = [r["flops"] for r in runs]
    if _quadratic_at(SEQ_POINTS, flops, SEQ_CHECK) != check["flops"]:
        return None
    out = {k: _quadratic_at(SEQ_POINTS, [r[k] for r in runs], spec.seq) for k in ("flops", "ops")}
    slope = Fraction(check["peak"] - runs[-1]["peak"], SEQ_CHECK - SEQ_POINTS[-1])
    out["peak"] = max(check["peak"], check["peak"] + slope * (spec.seq - SEQ_CHECK))
    return {k: int(v) if v.denominator == 1 else float(v) for k, v in out.items()}


def count_cell(cfg, spec: ShapeSpec, *, microbatches: int = 1, ocfg=None) -> dict:
    """``measure``'s counts for the whole config at ``spec``, from cut runs
    (see the module docstring).  ``method`` says how they were had."""
    _, n_units, _ = split_layers(cfg)

    def at(length: int) -> dict:
        s = replace(spec, seq=length)
        if n_units <= 2:
            return measure(cfg, s, microbatches=microbatches, ocfg=ocfg)
        one = measure(with_units(cfg, 1), s, microbatches=microbatches, ocfg=ocfg)
        two = measure(with_units(cfg, 2), s, microbatches=microbatches, ocfg=ocfg)
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
        bspec = {k: rules.spec(("batch",) + (None,) * (v.ndim - 1), tuple(v.shape))
                 for k, v in batch.items()}
        return shard_bytes(mesh, batch, bspec)

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


def run_cell(cell: Cell) -> list:
    """The cell's result on each of its meshes (a list of dicts)."""
    cfg = get_config(cell.arch)
    spec = SHAPES[cell.shape]
    ok, why = cell_applicable(cfg, cell.shape)
    if not ok:
        return [{"arch": cell.arch, "shape": cell.shape, "mesh": m, "status": "skipped",
                 "reason": why} for m in cell.meshes]
    ov = DRYRUN_OVERRIDES.get(cell.arch, {})
    ocfg = optim.OptConfig(opt_dtype=ov.get("opt_dtype", "float32"))
    mb = cell.microbatches if cell.microbatches != 1 else ov.get("microbatches", 1)
    if spec.kind != "train":
        mb = 1
    t0 = time.perf_counter()
    counts = count_cell(cfg, spec, microbatches=mb, ocfg=ocfg)
    seconds = time.perf_counter() - t0
    mf = rf.model_flops_estimate(cfg, spec.kind, spec.batch, spec.seq)
    whole = argument_bytes(cfg, spec, one_card(), ocfg)
    must_move = rf.step_bytes(cfg, spec.kind, spec.batch, spec.seq,
                              state_bytes=whole["params"] + whole.get("optimizer", 0),
                              param_bytes=whole["params"])
    out = []
    for name in cell.meshes:
        mesh = MESHES[name]()
        chips = mesh.size
        args = argument_bytes(cfg, spec, mesh, ocfg)
        arg_b = sum(args.values())
        step_b = counts["peak"] / chips
        roof = rf.Roofline(flops=counts["flops"] / chips, bytes_accessed=must_move / chips,
                           coll_bytes=0.0, chips=chips, model_flops=mf)
        terms = roof.as_dict()
        terms["coll_bytes_per_device"] = terms["t_collective_s"] = None
        out.append({
            "arch": cell.arch, "shape": cell.shape, "mesh": name, "chips": chips,
            "status": "ok", "seconds": seconds, "microbatches": mb,
            "opt_dtype": ocfg.opt_dtype, "method": counts["method"],
            "memory": {
                "argument_bytes": arg_b,
                "argument_bytes_by_kind": args,
                "step_bytes_estimate": step_b,
                "fits_80GB": arg_b < DEVICE_BYTES,
            },
            "flops": counts["flops"],
            "aten_ops": counts["ops"],
            "collectives": None,
            "collectives_reason": NO_COLLECTIVES,
            "roofline": terms,
        })
    return out


def _safe_run(cell: Cell) -> list:
    try:
        return run_cell(cell)
    except Exception as e:  # noqa: BLE001 - reported as the cell's status
        traceback.print_exc()
        return [{"arch": cell.arch, "shape": cell.shape, "mesh": m, "status": "error",
                 "error": f"{type(e).__name__}: {e}"} for m in cell.meshes]


def _worker_init() -> None:
    torch.set_num_threads(1)


def run_grid(cells, jobs: int = 1):
    """Each cell's results, in order; ``jobs`` worker processes (spawned,
    one thread each) when more than one.  Yields (cell, results)."""
    if jobs <= 1 or len(cells) <= 1:
        for c in cells:
            yield c, _safe_run(c)
        return
    with ProcessPoolExecutor(max_workers=min(jobs, len(cells)), mp_context=get_context("spawn"),
                             initializer=_worker_init) as pool:
        yield from zip(cells, pool.map(_safe_run, cells))


def summary(res: dict) -> str:
    tag = f"{res['arch']}__{res['shape']}__{res['mesh']}"
    if res["status"] != "ok":
        return f"[dryrun] {tag}: {res['status']} {res.get('reason') or res.get('error', '')}"
    m, r = res["memory"], res["roofline"]
    return (f"[dryrun] {tag}: ok {res['seconds']:.2f}s args/dev={m['argument_bytes'] / 2**30:.3f}GiB"
            f" step/dev~{m['step_bytes_estimate'] / 2**30:.3f}GiB fits={m['fits_80GB']}"
            f" flops={res['flops']:.4e} bound={r['bound']} t_lb={r['step_time_lb_s']:.4e}s"
            f" mfu={r['roofline_mfu']:.3f}")


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
