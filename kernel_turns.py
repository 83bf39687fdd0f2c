#!/usr/bin/env python3
"""Time the port's QF builds against an earlier checkout's, in turns.

Run from the repository root on a machine with one NVIDIA card::

    git archive <rev> | tar -x -C chip_scratch/parent
    python3 kernel_turns.py --parent chip_scratch/parent

``--parent`` is a checkout of the port whose kernel-path builds take
their probe positions from ``torch.cummax`` (``quotient_filter.
probe_positions`` in front of ``qf_build_planes``, and ``ops._span_math``
in front of a ``qf_build_span`` that is handed its positions).  Its
package is imported under another name and builds its own sources with
its own wrappers.  Each pair below is first held equal bit for bit, then
timed by CUDA events in the order parent, this tree, this tree, parent,
twice over, at ``chip_smoke.py``'s phase 2 and 11 shapes:

- ``ops.build_sorted`` of the q = 25 stream ``chip_smoke.q25_stream``
  (12,582,912 valid rows of 33,555,456);
- ``ops.build_span`` as a whole call, from the int64 streams: a
  migration chunk of 61,440 items half way through a drain into q = 25,
  and the drain of all 12,582,912 (each appended again in place, which
  writes the same bytes), with the host's time to issue one chunk;
- ``filters.insert`` of one batch of 2,048 keys into a ``qf`` grown to
  q = 25 from a full q = 24 table (the blocking growth call's insert);
- one migrating insert (``incremental_resize.insert``: a chunk moved, a
  batch into the side buffer) at the same shapes;
- phase 3's ingest of bench_ssd's 50,331,648 keys into ``cascade`` and
  ``buffered_qf``, wall time around the 64 insert calls, in keys/s.

Each tree's calls run this tree's façade over that tree's kernel path
(its ``ops``).  Last, ``torch.profiler``'s count of device operations a
call of the chunk's ``ops.build_span`` and of the migrating insert, and
the split of their device time by kernel: after the profiler the host
issues launches more slowly, so it comes after every timing.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import re
import statistics
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from repro_torch import filters
from repro_torch.core import quotient_filter as qf
from repro_torch.filters import cascade, incremental_resize, qf_filter
from repro_torch.kernels import cuda_lib, ops

THREADS = 256


def occupancy(report: str) -> str:
    """Registers, spills and resident threads per SM (of 2048) at THREADS a
    block, from nvcc's ``-Xptxas -v`` report: registers are allocated in
    units of 8 a thread from the SM's 65,536."""
    out = []
    for regs in re.findall(r"Used (\d+) registers", report):
        per_thread = -(-int(regs) // 8) * 8
        blocks = min(2048 // THREADS, 65536 // (per_thread * THREADS))
        out.append(f"{regs} registers, {blocks * THREADS} threads/SM")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", report)))
    smem = sorted(set(re.findall(r"(\d+) bytes smem", report)))
    return "; ".join(out) + f"; spill stores {spills} bytes; smem {smem} bytes"


def load_parent(root: Path):
    """The package ``src/repro_torch`` of the checkout at ``root``, imported
    as ``parent_repro_torch``; returns its ``kernels`` package with the
    modules ``cuda_lib`` and ``ops`` loaded."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[spec.name])
    for name in ("cuda_lib", "ops"):
        importlib.import_module(f"parent_repro_torch.kernels.{name}")
    return sys.modules["parent_repro_torch.kernels"]


@contextlib.contextmanager
def parent_path(pk):
    """This tree's façade over the parent's kernel path (its ``ops``); a
    parent whose ``ops`` has no ``extract`` decoded by the plain path."""
    kernel_path = pk.ops
    if not hasattr(kernel_path, "extract"):
        kernel_path = types.SimpleNamespace(**{**vars(pk.ops), "extract": qf.extract})
    mods = (qf_filter, cascade, incremental_resize)
    names = ("kops", "kernel_ops", "kops")
    saved = [getattr(m, n) for m, n in zip(mods, names)]
    for m, n in zip(mods, names):
        setattr(m, n, kernel_path)
    try:
        yield
    finally:
        for m, n, v in zip(mods, names, saved):
            setattr(m, n, v)


def on_parent(pk, fn):
    """``fn`` run with the parent's kernel path under this tree's façade."""
    def call():
        with parent_path(pk):
            return fn()
    return call


def turns(label: str, fns: dict, iters: int, rounds: int = 2) -> None:
    """Time each thunk in the order given and back, ``rounds`` times."""
    names = list(fns)
    times = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            times[n].append(cs.cuda_ms(fns[n], iters))
    for n in names:
        t = times[n]
        cs.log(f"  {label} {n}: {', '.join(f'{x:.5f}' for x in t)} ms; "
               f"mean {sum(t) / len(t):.5f}, median {statistics.median(t):.5f}")


def host_us(fn, calls: int = 200) -> float:
    """Microseconds the host takes to issue one call of ``fn``, over
    ``calls`` calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ops(label, call, calls: int = 5) -> None:
    """One call's device operations and device time by kernel, by
    ``torch.profiler`` (it slows the host, so only the device's own times
    are read from it)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows) / calls
    n_ops = sum(e.count for e in rows) // calls
    cs.log(f"  {label} under the profiler: {n_ops} device operations a call, "
           f"{busy_us:.1f} us of device time")
    for e in rows[:10]:
        cs.log(f"    {e.self_device_time_total / calls:9.1f} us  {e.count // calls:3d}x  "
               f"{e.key[:70]}")


def exact(label: str, got, want) -> None:
    if cs.max_abs_err(got, want) != 0:
        raise AssertionError(f"{label}: the trees disagree")


def same_state(label: str, got, want) -> None:
    diff = cs.differing_fields(got, want)
    if diff:
        raise AssertionError(f"{label}: the trees' states differ in {diff}")


def build_turns(pk, stream) -> None:
    """``ops.build_sorted`` of the q = 25 stream, both trees."""
    cfg, fq, fr, n = stream
    mine, theirs = ops.build_sorted(cfg, fq, fr, n), pk.ops.build_sorted(cfg, fq, fr, n)
    exact("ops.build_sorted", mine, theirs)
    del mine, theirs
    turns(f"ops.build_sorted of {fq.shape[0]} rows ({n} valid)", {
        "parent": lambda: pk.ops.build_sorted(cfg, fq, fr, n),
        "this tree": lambda: ops.build_sorted(cfg, fq, fr, n),
    }, 3)


def span_turns(pk, stream) -> dict:
    """``ops.build_span`` as a whole call, the chunk and the drain, both
    trees; returns the chunk's two calls for the profiler."""
    cfg, sfq, sfr, n = stream
    fq, fr = sfq[:n], sfr[:n]
    calls = {}
    for label, start, span, iters in (("chunk", n // 2, cs.INC_CHUNK, 50),
                                      ("drain", 0, n, 5)):
        (sq, sr, k, _, _, lp, lf), planes = cs.span_args(
            cfg, fq, fr, start, span, span, fq.device)
        st = qf.empty(cfg, fq.device)._replace(
            rem=planes[0], occ=planes[1], shf=planes[2], con=planes[3])
        if start:
            st = st._replace(n=torch.full((), start, dtype=torch.int32, device=fq.device))
        outs = []
        for o in (ops, pk.ops):
            s = st._replace(**{f: getattr(st, f).clone() for f in ("rem", "occ", "shf", "con")})
            new, a, b = o.build_span(cfg, s, sq, sr, k, lp, lf)
            outs.append((*new, a, b))
        exact(f"ops.build_span ({label})", *outs)
        args = (cfg, st, sq, sr, k, lp, lf)
        both = {  # bound to this span's arguments, not the loop's names
            "parent": lambda args=args: pk.ops.build_span(*args),
            "this tree": lambda args=args: ops.build_span(*args),
        }
        turns(f"ops.build_span {label} of {span} items", both, iters)
        if label == "chunk":
            cs.log(f"  ops.build_span chunk, host issue time a call: " + ", ".join(
                f"{t} {host_us(both[t]):.2f} us"
                for t in ("parent", "this tree", "this tree", "parent")))
            calls.update({f"ops.build_span chunk ({t})": f for t, f in both.items()})
    return calls


def filled_qf(keys):
    """A ``qf`` at q = ``INC_Q`` filled to capacity with the first keys."""
    cfg, st = filters.make("qf", q=cs.INC_Q, r=cs.P_BITS - cs.INC_Q, backend="pallas")
    return cfg, filters.insert(cfg, st, keys[: cfg.core.capacity])


def insert_turns(pk, keys) -> dict:
    """An insert of one batch into the grown q = 25 table, and one migrating
    insert, both trees; returns the migrating inserts for the profiler."""
    cfg, st = filled_qf(keys)
    cap = cfg.core.capacity
    batch = keys[cap : cap + cs.INC_BATCH]
    gcfg, grown = filters.grow(cfg, st)
    ins = {
        "parent": on_parent(pk, lambda: filters.insert(gcfg, grown, batch)),
        "this tree": lambda: filters.insert(gcfg, grown, batch),
    }
    same_state("insert at q = 25", ins["this tree"](), ins["parent"]())
    turns(f"insert of {cs.INC_BATCH} keys at q = {gcfg.q}", ins, 3)
    del grown
    mcfg, ms = incremental_resize.begin(cfg, st, chunk=cs.INC_CHUNK, buf_q=cs.INC_BUF_Q)
    ms = filters.insert(mcfg, ms, batch)  # the cursor off 0
    mig = {
        "parent": on_parent(pk, lambda: filters.insert(mcfg, ms, batch)),
        "this tree": lambda: filters.insert(mcfg, ms, batch),
    }
    same_state("migrating insert", mig["this tree"](), mig["parent"]())
    turns(f"migrating insert (chunk {cs.INC_CHUNK}, {cs.INC_BATCH} keys)", mig, 10)
    cs.log("  migrating insert, host issue time a call: " + ", ".join(
        f"{t} {host_us(mig[t], 50):.2f} us"
        for t in ("parent", "this tree", "this tree", "parent")))
    return {f"migrating insert ({t})": f for t, f in mig.items()}


def ingest_turns(pk, keys) -> None:
    """Phase 3's ingest of ``keys`` into ``cascade`` and ``buffered_qf``:
    keys/s over the wall time of the 64 insert calls, in turns."""
    specs = cs.specs("pallas")
    step = keys.shape[0] // cs.BATCHES

    def ingest(name):
        cfg, st = filters.make(name, **specs[name])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in range(cs.BATCHES):
            st = filters.insert(cfg, st, keys[b * step : (b + 1) * step])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, cfg, st

    for name in ("buffered_qf", "cascade"):
        rates, finals = {"parent": [], "this tree": []}, {}
        for tree in ("parent", "this tree", "this tree", "parent"):
            if tree == "parent":
                with parent_path(pk):
                    s, cfg, st = ingest(name)
            else:
                s, cfg, st = ingest(name)
            rates[tree].append(keys.shape[0] / s)
            finals[tree] = st
            del st
            torch.cuda.empty_cache()
        same_state(f"{name} ingest", finals["this tree"], finals["parent"])
        del finals
        for tree, r in rates.items():
            cs.log(f"  phase 3 ingest {name} {tree}: "
                   f"{', '.join(f'{x:.0f}' for x in r)} keys/s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    pk = load_parent(args.parent)
    for tree, lib in (("this tree", cuda_lib), ("parent", pk.cuda_lib)):
        for name, report in lib.build().items():
            cs.log(f"  nvcc {name} ({tree}): {occupancy(report)}")
    cs.log(f"built in {time.perf_counter() - t0:.3f} s")

    stream = cs.q25_stream(device)
    build_turns(pk, stream)
    calls = span_turns(pk, stream)
    del stream
    torch.cuda.empty_cache()

    rng = np.random.default_rng(cs.SEED)
    n_total = cs.RATIO * qf.QFConfig(q=cs.RAM_Q, r=1).capacity
    keys = cs.uint32_keys(rng, n_total, device)
    calls.update(insert_turns(pk, keys))
    ingest_turns(pk, keys)

    # the profiler last: after it the host issues launches more slowly
    for name, call in calls.items():
        device_ops(name, call)
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
