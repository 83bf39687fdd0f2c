#!/usr/bin/env python3
"""Time the port's two probe kernels against an earlier checkout's, in turns,
beside the card's rate of random gathers and a façade probe's idle share.

Run from the repository root on a machine with one NVIDIA card::

    git archive <rev> | tar -x -C chip_scratch/parent
    python3 kernel_turns.py --parent chip_scratch/parent [--groups 2 4 6 12]

``--parent`` is a checkout whose ``cascade_probe`` takes no level counts:
its caller cleared the bits of levels with ``n == 0`` after the launch,
and so does this script.  Its package is imported under another name and
builds its own sources with its own wrappers.  ``bloom_probe`` and
``cascade_probe`` of both trees run on the inputs ``chip_smoke.py`` times
them on: the cascade of its phase 3 after ``MID_BATCHES`` batches with
2**22 probes (and the first 2**21, a façade probe's size), and the
ingested plain and counting ``blocked_bloom`` of its phase 5 with 2**22
probes.  Each is first held to the plain PyTorch version bit for bit,
then timed by CUDA events in the order parent, this tree, this tree,
parent, twice over.  ``--groups`` also builds this tree's
``bloom_probe.cu`` with each listed group width (``-DGROUP``) and times
those once each way.

Beside them: a gather kernel written for the purpose (int32 indices read
coalesced, ``U`` independent cell loads in flight per thread) and
``torch.take`` read 2**25 uniform cells of each Bloom plane, the card's
rate of random sectors at that plane's size.  A façade probe of 2**21
keys on the cascade is timed without a profiler: the host's time to
issue it, its wall time by CUDA events, and the replay of the same call
captured in a CUDA graph (its kernels back to back, the device's busy
time); then ``torch.profiler`` splits one call's device time by kernel.
The nvcc report (registers, spills) and the occupancy it gives at 256
threads a block are printed for each build.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from repro_torch import filters
from repro_torch.filters import bloom_filter
from repro_torch.kernels import bloom_block, cascade_probe, cuda_lib

THREADS = 256
GATHER_WIDTHS = (1, 2, 4, 8, 16)
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
_CELL = {torch.uint8: "u8", torch.int16: "i16"}

# U uniform gathers per thread, all in flight together: the card's rate of
# random sectors, with nothing of a filter around it
GATHER_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int U, typename Cell>
__global__ void __launch_bounds__(256)
    gather(const Cell* __restrict__ cells, const int32_t* __restrict__ idx,
           long long threads, uint8_t* __restrict__ out) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= threads) return;
  Cell v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = __ldg(cells + __ldg(idx + u * threads + t));
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) any |= v[u] != 0;
  out[t] = any;
}

template <typename Cell>
static int run(int u, const void* cells, const void* idx, long long n,
               void* out, void* stream) {
  long long threads = n / u;
  unsigned blocks = (unsigned)((threads + 255) / 256);
  const Cell* c = (const Cell*)cells;
  const int32_t* i = (const int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (u) {
    case 1: gather<1, Cell><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 2: gather<2, Cell><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 4: gather<4, Cell><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 8: gather<8, Cell><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 16: gather<16, Cell><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_u8(int u, const void* cells, const void* idx, long long n,
                         void* out, void* stream) {
  return run<uint8_t>(u, cells, idx, n, out, stream);
}

extern "C" int gather_i16(int u, const void* cells, const void* idx, long long n,
                          void* out, void* stream) {
  return run<int16_t>(u, cells, idx, n, out, stream);
}
"""


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
    return "; ".join(out) + f"; spill stores {spills} bytes"


def build(sources: dict) -> dict:
    """nvcc each ``name -> (.cu path, extra flags)`` into ``_build/turns``,
    all at once; a source's own directory is on its include path."""
    out_dir = cuda_lib.BUILD_DIR / "turns"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {
        n: subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, *flags, "-o",
             str(out_dir / f"{n}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for n, (src, flags) in sources.items()
    }
    libs = {}
    for n, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {n}:\n{report}")
        cs.log(f"  nvcc {n}: {occupancy(report)}")
        libs[n] = ctypes.CDLL(str(out_dir / f"{n}.so"))
    return libs


def load_parent(root: Path):
    """The package ``src/repro_torch`` of the checkout at ``root``, imported
    as ``parent_repro_torch``; returns its ``kernels`` package with the
    modules ``cuda_lib``, ``bloom_block`` and ``cascade_probe`` loaded."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[spec.name])
    for name in ("cuda_lib", "bloom_block", "cascade_probe"):
        importlib.import_module(f"parent_repro_torch.kernels.{name}")
    return sys.modules["parent_repro_torch.kernels"]


def bloom_entry(lib):
    """A ``bloom_probe.cu`` built here, as a function of (cells, idx)."""

    def run(cells, idx):
        hit = torch.empty(idx.shape[0], dtype=torch.bool, device=idx.device)
        fn = getattr(lib, f"bloom_probe_{_CELL[cells.dtype]}")
        fn.argtypes = [_P, _I64, _P, _I64, ctypes.c_int, _P, _P]
        cuda_lib.check(
            fn(cells.data_ptr(), cells.shape[0], idx.data_ptr(), idx.shape[0],
               idx.shape[1], hit.data_ptr(), cuda_lib.stream_handle(idx.device)),
            "bloom_probe",
        )
        return hit

    return run


def gather_rate(lib, cells, label: str, n: int = 1 << 25) -> None:
    """The rate of random sectors over ``cells``: ``n`` uniform gathers by
    the gather kernel at each width and by ``torch.take``."""
    gen = torch.Generator(device=cells.device).manual_seed(cs.SEED)
    idx = torch.randint(0, cells.shape[0], (n,), device=cells.device,
                        dtype=torch.int32, generator=gen)
    out = torch.empty(n, dtype=torch.uint8, device=cells.device)
    fn = getattr(lib, f"gather_{_CELL[cells.dtype]}")
    fn.argtypes = [ctypes.c_int, _P, _P, _I64, _P, _P]
    stream = cuda_lib.stream_handle(cells.device)
    for u in GATHER_WIDTHS:
        ms = cs.cuda_ms(lambda u=u: cuda_lib.check(
            fn(u, cells.data_ptr(), idx.data_ptr(), n, out.data_ptr(), stream),
            "gather"), 20)
        cs.log(f"  gather kernel, {u} loads a thread, {n} uniform cells of {label}: "
               f"{ms:.5f} ms, {n / ms / 1e6:.4f} G sectors/s")
    wide = idx.to(torch.int64)
    ms = cs.cuda_ms(lambda: torch.take(cells, wide), 20)
    cs.log(f"  torch.take of {n} uniform cells of {label}: {ms:.5f} ms, "
           f"{n / ms / 1e6:.4f} G sectors/s")


def cascade_turn(parent_cp, level_planes, level_n, level_r, fq, fr, r):
    """The parent's ``cascade_probe``: every level read, and the bits of
    levels with ``n == 0`` cleared after, as its caller did."""
    hit = parent_cp.cascade_probe(level_planes, level_r, fq, fr, r)
    for lvl, n in enumerate(level_n):
        hit &= ~((n <= 0).to(torch.int32) << lvl)
    return hit


def turns(label: str, fns: dict, iters: int, rounds: int) -> None:
    """Time each thunk in the order given and back, ``rounds`` times."""
    names = list(fns)
    times = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            times[n].append(cs.cuda_ms(fns[n], iters))
    for n in names:
        t = times[n]
        cs.log(f"  {label} {n}: {', '.join(f'{x:.5f}' for x in t)} ms; "
               f"mean {sum(t) / len(t):.5f}")


def facade_split(cfg, state, keys, calls: int = 5) -> None:
    """Where a façade probe's time goes: ``filters.probe`` of ``keys``."""
    def call():
        filters.probe(cfg, state, keys)

    call()
    torch.cuda.synchronize()
    issue, wall = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        call()
        issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        wall.append(start.elapsed_time(end))
    wall_ms = statistics.median(wall)
    cs.log(f"  façade probe of {keys.shape[0]} keys, no profiler: wall "
           f"{', '.join(f'{x:.5f}' for x in wall)} ms by CUDA events (median "
           f"{wall_ms:.5f}); host issue {', '.join(f'{x:.5f}' for x in issue)} ms")

    # the same call's kernels back to back: a CUDA graph's replay
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    replays = [cs.cuda_ms(graph.replay, 1) for _ in range(calls)]
    busy_ms = statistics.median(replays)
    cs.log(f"  the same call as a CUDA graph: {', '.join(f'{x:.5f}' for x in replays)} "
           f"ms (median {busy_ms:.5f}); device idle share of the eager call "
           f"{1 - busy_ms / wall_ms:.4f}")
    del graph

    # one call's device time by kernel (the profiler slows the host, so
    # only the device's own times are read from it)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in rows) / calls
    n_kernels = sum(e.count for e in rows) // calls
    cs.log(f"  under the profiler: {n_kernels} device operations a call, "
           f"{busy_us:.1f} us of device time")
    for e in rows[:12]:
        cs.log(f"    {e.self_device_time_total / calls:9.1f} us  {e.count // calls:3d}x  "
               f"{e.key[:70]}")


def exact(label: str, got, want) -> None:
    if cs.max_abs_err([got], [want]) != 0:
        raise AssertionError(f"{label} disagrees with the plain version")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--groups", type=int, nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # builds: this tree's, the parent's, the group widths and the gather
    t0 = time.perf_counter()
    pk = load_parent(args.parent)
    names = ("bloom_probe", "cascade_probe")
    for tree, lib in (("this tree", cuda_lib), ("parent", pk.cuda_lib)):
        for name, report in lib.build(names).items():
            cs.log(f"  nvcc {name} ({tree}): {occupancy(report)}")
    gather_src = cuda_lib.BUILD_DIR / "turns" / "gather.cu"
    gather_src.parent.mkdir(parents=True, exist_ok=True)
    gather_src.write_text(GATHER_CU)
    bloom_src = cuda_lib.CSRC / "bloom_probe.cu"
    libs = build({
        "gather": (gather_src, ()),
        **{f"group{g}": (bloom_src, (f"-DGROUP={g}",)) for g in args.groups},
    })
    cs.log(f"built in {time.perf_counter() - t0:.3f} s")

    # the main path's keys, as chip_smoke.py's phase 3 makes them
    rng = np.random.default_rng(cs.SEED)
    n_total = cs.RATIO * cs.qf.QFConfig(q=cs.RAM_Q, r=1).capacity
    step = n_total // cs.BATCHES
    keys = cs.uint32_keys(rng, n_total, device)
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    sample = keys[torch.from_numpy(rng.integers(0, n_total, cs.PROBES)).to(device)]
    fresh = cs.fresh_keys(rng, inserted_sorted, cs.PROBES, device)
    del inserted_sorted

    # cascade_probe on the cascade after MID_BATCHES, check_cascade's probes
    cfg, state = filters.make("cascade", **cs.specs("pallas")["cascade"])
    for b in range(cs.MID_BATCHES):
        state = filters.insert(cfg, state, keys[b * step : (b + 1) * step])
    structs = (state.q0, *state.levels)
    widths = [cfg.q0_cfg.r] + [cfg.level_cfg(i).r for i in range(cfg.levels)]
    crng = np.random.default_rng(cs.SEED + 2)
    half = cs.PARITY_PROBES // 2
    mid = keys[: step * cs.MID_BATCHES]
    pick = torch.from_numpy(crng.integers(0, mid.shape[0], half)).to(device)
    probes = torch.cat([mid[pick], cs.uint32_keys(crng, half, device)])
    fq, fr, rc = cs.canonical_queries(cfg, probes)
    cargs = ([(s.rem, s.occ, s.shf, s.con) for s in structs], [s.n for s in structs],
             widths, fq, fr, rc)
    cs.log(f"cascade_probe on a cascade holding {[int(s.n) for s in structs]}")
    want = cascade_probe.cascade_probe_plain(*cargs)
    exact("this tree's cascade_probe", cascade_probe.cascade_probe(*cargs), want)
    exact("the parent's cascade_probe", cascade_turn(pk.cascade_probe, *cargs), want)
    for size in (cs.PARITY_PROBES, cs.PROBES):
        a = (*cargs[:3], fq[:size], fr[:size], rc)
        turns(f"cascade_probe {size} queries", {
            "parent": lambda a=a: pk.cascade_probe.cascade_probe(a[0], *a[2:]),
            "this tree": lambda a=a: cascade_probe.cascade_probe(*a),
        }, 10, 2)
    facade_split(cfg, state, fresh)
    del state, structs, cargs, want
    torch.cuda.empty_cache()

    # bloom_probe on the ingested blocked_bloom, plain and counting
    bprobes = torch.cat([sample, fresh])
    for label, (name, spec) in cs.bloom_specs(n_total, "pallas").items():
        if name != "blocked_bloom":
            continue
        bcfg, bstate = filters.make(name, **spec)
        for b in range(cs.BATCHES):
            bstate = filters.insert(bcfg, bstate, keys[b * step : (b + 1) * step])
        cells, idx = bstate.cells, bloom_filter._indices(bcfg, bprobes)
        want = bloom_block.bloom_probe_plain(cells, idx)
        fns = {"parent": pk.bloom_block.bloom_probe, "this tree": bloom_block.bloom_probe}
        fns.update({f"group{g}": bloom_entry(libs[f"group{g}"]) for g in args.groups})
        for n, fn in fns.items():
            exact(f"bloom_probe ({n})", fn(cells, idx), want)
        cs.log(f"bloom_probe on {label} ({cells.dtype}), {tuple(idx.shape)} indices")
        thunks = {n: (lambda fn=fn: fn(cells, idx)) for n, fn in fns.items()}
        turns(f"bloom_probe {label}", {n: thunks[n] for n in ("parent", "this tree")},
              20, 2)
        if args.groups:
            turns(f"bloom_probe {label}", {f"group{g}": thunks[f"group{g}"]
                                           for g in args.groups}, 20, 1)
        gather_rate(libs["gather"], cells, label)
        del bstate, cells, idx, want
        torch.cuda.empty_cache()
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
