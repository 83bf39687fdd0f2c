#!/usr/bin/env python3
"""Time the port's hashed probe path against an earlier checkout's, in
turns, beside the card's rate of random gathers.

Run from the repository root on a machine with one NVIDIA card::

    git archive <rev> | tar -x -C chip_scratch/parent
    python3 kernel_turns.py --parent chip_scratch/parent

``--parent`` is a checkout of the port whose ``fuse_probe`` takes hashed
positions and whose kernel path hashes keys with the plain PyTorch
chain.  Its package is imported under another name and builds its own
sources with its own wrappers.  Each pair below is first held to the
plain version bit for bit, then timed by CUDA events in the order
parent, this tree, this tree, parent, twice over (four times for the
façade probes, which are host-bound and so noisier):

- ``fingerprint``: the plain int64 chain (``core.fingerprint``, then the
  narrowing the probes need) against the kernel, on uniform keys at
  p = 39 in the split (24, 15): 2**22 and 2**21 keys into int32 (what a
  probe hashes) and one insert batch, 786,432 keys, into int64 (what an
  insert hashes); and the host's time to issue one call of each;
- the frozen lookup ``ops.fuse_lookup`` of both trees (the parent's:
  ``fuse_hash`` in PyTorch, then its three-gather kernel; this tree's:
  one kernel that hashes) on level 1 of the frozen cascade of
  ``chip_smoke.py``'s phase 8 after ``MID_BATCHES`` batches, with
  ``check_fuse``'s queries, 2**22 and their first 2**21;
- the façade probes (``filters.probe``) of 2**21 fresh keys on phase 3's
  ``cascade`` and ``buffered_qf`` and on that frozen cascade, each after
  ``MID_BATCHES`` batches, with this tree's façade over either tree's
  kernel path (``ops``).  Then, for each façade probe and each tree (in
  the order parent, this tree, this tree, parent), the host's time to
  issue it and its wall time by CUDA events, one call at a time, the
  replay of the same call captured in a CUDA graph (its kernels back to
  back, the device's busy time) and the device's idle share of the eager
  call.  Last of the three, for each, ``torch.profiler``'s count of
  device operations a call and split of its device time by kernel; the
  host issues launches more slowly once the profiler has run, so the
  cascade's timings are taken again after it.

Last, a gather kernel written for the purpose (int32 indices read
coalesced, ``U`` independent cell loads in flight per thread) and
``torch.take`` read 2**25 uniform cells of a uint8 plane of phase 5's
Bloom size: the card's rate of random sectors, which bounds the three
gathers of a frozen lookup.  The nvcc report (registers, spills) and
the occupancy it gives at 256 threads a block are printed for each
build.
"""

from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.core import fuse_filter as fuse
from repro_torch.filters import cascade, qf_filter
from repro_torch.kernels import cuda_lib, fingerprint, ops

THREADS = 256
GATHER_WIDTHS = (1, 4, 16)
_P, _I64 = ctypes.c_void_p, ctypes.c_longlong

# U uniform gathers per thread, all in flight together: the card's rate of
# random sectors, with nothing of a filter around it
GATHER_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int U>
__global__ void __launch_bounds__(256)
    gather(const uint8_t* __restrict__ cells, const int32_t* __restrict__ idx,
           long long threads, uint8_t* __restrict__ out) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= threads) return;
  uint8_t v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = __ldg(cells + __ldg(idx + u * threads + t));
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) any |= v[u] != 0;
  out[t] = any;
}

extern "C" int gather_u8(int u, const void* cells, const void* idx, long long n,
                         void* out, void* stream) {
  long long threads = n / u;
  unsigned blocks = (unsigned)((threads + 255) / 256);
  const uint8_t* c = (const uint8_t*)cells;
  const int32_t* i = (const int32_t*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (u) {
    case 1: gather<1><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 4: gather<4><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    case 16: gather<16><<<blocks, 256, 0, s>>>(c, i, threads, (uint8_t*)out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
    smem = sorted(set(re.findall(r"(\d+) bytes smem", report)))
    return "; ".join(out) + f"; spill stores {spills} bytes; smem {smem} bytes"


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
    """This tree's façade over the parent's kernel path (its ``ops``: the
    keys hashed by the plain chain, its kernels)."""
    saved = qf_filter.kops, cascade.kernel_ops
    qf_filter.kops = cascade.kernel_ops = pk.ops
    try:
        yield
    finally:
        qf_filter.kops, cascade.kernel_ops = saved


def gather_rate(lib, cells, label: str, n: int = 1 << 25) -> None:
    """The rate of random sectors over ``cells``: ``n`` uniform gathers by
    the gather kernel at each width and by ``torch.take``."""
    gen = torch.Generator(device=cells.device).manual_seed(cs.SEED)
    idx = torch.randint(0, cells.shape[0], (n,), device=cells.device,
                        dtype=torch.int32, generator=gen)
    out = torch.empty(n, dtype=torch.uint8, device=cells.device)
    fn = lib.gather_u8
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
               f"mean {sum(t) / len(t):.5f}, median {statistics.median(t):.5f}")


def host_us(fn, calls: int = 200) -> float:
    """Microseconds the host takes to issue one call of ``fn``, over
    ``calls`` calls issued back to back (fewer launches than the card's
    queue holds, so the host never waits on it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def facade_timing(label, call, calls: int = 5) -> None:
    """A façade probe ``call`` unprofiled: the host's time to issue it and
    its wall time by CUDA events, one call at a time; then the replay of
    the same call captured in a CUDA graph (its kernels back to back, the
    device's busy time) and the device's idle share of the eager call."""
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
    cs.log(f"  {label} façade probe, no profiler: wall "
           f"{', '.join(f'{x:.5f}' for x in wall)} ms by CUDA events (median "
           f"{wall_ms:.5f}); host issue {', '.join(f'{x:.5f}' for x in issue)} ms "
           f"(median {statistics.median(issue):.5f})")

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
    cs.log(f"  {label}: the same call as a CUDA graph: "
           f"{', '.join(f'{x:.5f}' for x in replays)} ms (median {busy_ms:.5f}); "
           f"device idle share of the eager call {1 - busy_ms / wall_ms:.4f}")
    del graph


def facade_profile(label, call, calls: int = 5) -> None:
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
    n_kernels = sum(e.count for e in rows) // calls
    cs.log(f"  {label} under the profiler: {n_kernels} device operations a call, "
           f"{busy_us:.1f} us of device time")
    for e in rows[:12]:
        cs.log(f"    {e.self_device_time_total / calls:9.1f} us  {e.count // calls:3d}x  "
               f"{e.key[:70]}")


def exact(label: str, got, want) -> None:
    if cs.max_abs_err(got, want) != 0:
        raise AssertionError(f"{label} disagrees with the plain version")


def fingerprint_turns(keys) -> None:
    """The plain chain against the kernel, at p = 39 in the split (24, 15):
    a probe's keys into int32, an insert batch's into int64."""
    q, r = cs.RAM_Q, cs.P_BITS - cs.RAM_Q
    batch = keys.shape[0] // cs.BATCHES
    for size, dtype in ((cs.PARITY_PROBES, torch.int32), (cs.PROBES, torch.int32),
                        (batch, torch.int64)):
        k = keys[:size]
        want = fingerprint.fingerprint_plain(k, q, r, 0, dtype)
        exact("fingerprint", fingerprint.fingerprint(k, q, r, 0, dtype), want)
        both = {
            "eager chain": lambda k=k, d=dtype: fingerprint.fingerprint_plain(
                k, q, r, 0, d),
            "kernel": lambda k=k, d=dtype: fingerprint.fingerprint(k, q, r, 0, d),
        }
        label = f"fingerprint {size} keys into {str(dtype)[6:]}"
        turns(label, both, 20, 2)
        cs.log(f"  {label}, host issue time a call: " + ", ".join(
            f"{n} {host_us(both[n]):.2f} us" for n in ("eager chain", "kernel",
                                                       "kernel", "eager chain")))


def fuse_turns(pk, cfg, state, keys, held: int) -> None:
    """``ops.fuse_lookup`` of both trees on the frozen level 1 of ``state``,
    ``check_fuse``'s queries: half of the first ``held`` keys, half
    uniform."""
    device = keys.device
    fc, level = cfg.fuse_cfg(cs.FROZEN_BELOW), state.levels[cs.FROZEN_BELOW]
    rng = np.random.default_rng(cs.SEED + 4)
    half = cs.PARITY_PROBES // 2
    pick = torch.from_numpy(rng.integers(0, held, half)).to(device)
    probes = torch.cat([keys[pick], cs.uint32_keys(rng, half, device)])
    fq, fr, _ = cs.canonical_queries(cfg, probes)
    cs.log(f"frozen level 1: {level.table.numel()} cells, {int(level.n)} fingerprints, "
           f"{fc.fp_bits}-bit cells")
    for size in (cs.PARITY_PROBES, cs.PROBES):
        q, r = fq[:size], fr[:size]
        want = fuse.lookup_fp(fc, level, q, r)
        exact("this tree's fuse_lookup", [ops.fuse_lookup(fc, level, q, r)], [want])
        exact("the parent's fuse_lookup", [pk.ops.fuse_lookup(fc, level, q, r)], [want])
        both = {
            "parent (fuse_hash + its kernel)": lambda q=q, r=r: pk.ops.fuse_lookup(
                fc, level, q, r),
            "this tree (one hashing kernel)": lambda q=q, r=r: ops.fuse_lookup(
                fc, level, q, r),
        }
        turns(f"fuse_lookup {size} queries", both, 20, 2)
        cs.log(f"  fuse_lookup {size} queries, host issue time a call: " + ", ".join(
            f"{n.split(' (')[0]} {host_us(both[n]):.2f} us"
            for n in list(both) + list(both)[::-1]))


def facade_calls(pk, label, cfg, state, fresh) -> dict:
    """``filters.probe`` of ``fresh`` over either tree's kernel path, held
    equal, timed in turns and by ``facade_timing``; returns the two calls
    by label."""
    _, want = filters.probe(cfg, state, fresh)
    with parent_path(pk):
        _, got = filters.probe(cfg, state, fresh)
    exact(f"{label}'s façade probe over the parent's kernel path", [got], [want])

    def parent_probe():
        with parent_path(pk):
            filters.probe(cfg, state, fresh)

    calls = {
        f"{label} (parent)": parent_probe,
        f"{label} (this tree)": lambda: filters.probe(cfg, state, fresh),
    }
    turns(f"{label} façade probe", dict(zip(("parent", "this tree"), calls.values())),
          20, 4)
    for name in list(calls) + list(calls)[::-1]:
        facade_timing(name, calls[name])
    return calls


def ingest(name, spec, keys, batches):
    """``filters.make`` and ``batches`` insert batches of ``keys``, as
    phase 3 does them."""
    cfg, state = filters.make(name, **spec)
    step = keys.shape[0] // cs.BATCHES
    for b in range(batches):
        state = filters.insert(cfg, state, keys[b * step : (b + 1) * step])
    return cfg, state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # builds: this tree's, the parent's, and the gather kernel
    t0 = time.perf_counter()
    pk = load_parent(args.parent)
    for tree, lib in (("this tree", cuda_lib), ("parent", pk.cuda_lib)):
        for name, report in lib.build().items():
            cs.log(f"  nvcc {name} ({tree}): {occupancy(report)}")
    gather_src = cuda_lib.BUILD_DIR / "turns" / "gather.cu"
    gather_src.parent.mkdir(parents=True, exist_ok=True)
    gather_src.write_text(GATHER_CU)
    libs = build({"gather": (gather_src, ())})
    cs.log(f"built in {time.perf_counter() - t0:.3f} s")

    # the main path's keys, as chip_smoke.py's phase 3 makes them
    rng = np.random.default_rng(cs.SEED)
    n_total = cs.RATIO * cs.qf.QFConfig(q=cs.RAM_Q, r=1).capacity
    keys = cs.uint32_keys(rng, n_total, device)
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    rng.integers(0, n_total, cs.PROBES)  # phase 3's sample of inserted keys
    fresh = cs.fresh_keys(rng, inserted_sorted, cs.PROBES, device)
    del inserted_sorted

    fingerprint_turns(keys)
    specs = cs.specs("pallas")
    calls, states = {}, []
    for name in ("cascade", "buffered_qf"):
        cfg, state = ingest(name, specs[name], keys, cs.MID_BATCHES)
        cs.log(f"{name} after {cs.MID_BATCHES} batches: "
               f"{filters.stats(cfg, state)['n'].item()} fingerprints")
        calls.update(facade_calls(pk, name, cfg, state, fresh))
        states.append(state)
    cfg, state = ingest("cascade", cs.frozen_spec("pallas"), keys, cs.MID_BATCHES)
    cs.log(f"frozen cascade after {cs.MID_BATCHES} batches: level counts "
           f"{filters.stats(cfg, state)['level_counts'].tolist()}")
    fuse_turns(pk, cfg, state, keys, keys.shape[0] // cs.BATCHES * 48)
    calls.update(facade_calls(pk, "frozen cascade", cfg, state, fresh))
    states.append(state)

    # the profiler last: after it the host issues launches more slowly, so
    # one timing is taken again after it to show by how much
    for name, call in calls.items():
        facade_profile(name, call)
    cs.log("after the profiler:")
    for name in ("cascade (parent)", "cascade (this tree)"):
        facade_timing(name, calls[name])
    del calls, states, cfg, state, keys
    torch.cuda.empty_cache()

    # the card's rate of random sectors on a plane of phase 5's Bloom size
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    cells = torch.randint(0, 2, (cs.bloom_m_bits(n_total),), dtype=torch.uint8,
                          device=device, generator=gen)
    gather_rate(libs["gather"], cells, f"a {cells.numel()}-byte plane")
    cs.log(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
