#!/usr/bin/env python3
"""Time the port's quotient-filter kernels against an earlier checkout's, in
turns, beside the card's rate of random gathers and the façade probes.

Run from the repository root on a machine with one NVIDIA card::

    git archive <rev> | tar -x -C chip_scratch/parent
    python3 kernel_turns.py --parent chip_scratch/parent

``--parent`` is a checkout of the port whose ``cascade_probe`` takes the
levels' counts.  Its package is imported under another name and builds
its own sources with its own wrappers.  On the inputs ``chip_smoke.py``
uses, each kernel of both trees is first held to the plain PyTorch
version bit for bit, then timed by CUDA events in the order parent, this
tree, this tree, parent, twice over:

- ``qf_build_planes`` on the q = 24 build of phase 2 (0.75 * 2**24
  sorted fingerprints) and on a quarter-load build of the same table
  (2**22), each with its planes' allocation (the parent's zero fills
  included);
- ``qf_probe`` on phase 2's 2**22 probes of that table, half inserted
  keys and half uniform, and on their first 2**21 (a façade probe's
  size), the pack of the bit planes included; and the host's time to
  issue one call of each;
- ``cascade_probe`` on the cascade of phase 3 after ``MID_BATCHES``
  batches, 2**22 and 2**21 probes.

Then the steps of this tree's ``qf_probe`` alone (the pack of the bit
planes, the walk over them, the walk over the byte planes, and the bit
walk on queries sorted by quotient), and the quotient-ordered designs
it was measured against (``ORDERED_CU``): the quotient order by the card's
counting sort or by ``torch.sort`` and a gather of the remainders, and
the walk staged in shared memory (b) or in global memory (a); each step
alone, then each design whole, once each way at both sizes.

The façade probes of 2**21 fresh keys on phase 3's ``buffered_qf`` (two
``qf_probe`` calls a probe) and ``cascade`` after ``MID_BATCHES``
batches: ``buffered_qf``'s with this tree's and the parent's
``qf_probe`` in turns (four rounds: it is host-bound, so noisier), and
``qf_probe``'s two walks on each of its
tiers (the RAM tier at q = 24, where ``DENSE`` picks the bit walk, and
the disk tier at q = 27, where it picks the byte walk); then, for each
façade probe, the host's time to issue it, its
wall time by CUDA events, the replay of the same call captured in a
CUDA graph (its kernels back to back, the device's busy time), and
``torch.profiler``'s split of one call's device time by kernel.  Last, a
gather kernel written for the purpose (int32 indices read coalesced,
``U`` independent cell loads in flight per thread) and ``torch.take``
read 2**25 uniform cells of a uint8 plane of phase 5's Bloom size: the
card's rate of random sectors.  The nvcc report (registers, spills) and
the occupancy it gives at 256 threads a block are printed for each
build.
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
from repro_torch.kernels import cascade_probe, cuda_lib, ops, qf_build, qf_probe

THREADS = 256
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


# A quotient-ordered design of qf_probe, kept here to time the shipped one
# against it: a counting sort of the queries into buckets of 2**shift slots on
# the card (histogram by atomics, one block's scan, scatter of (fq, fr) and
# index), then one thread per ordered query walks it and writes its answer at
# the query's own index.  With STAGE > 0 (walk (b)) a block first copies the
# slot window its quotients need, MARGIN slots either side, into shared
# memory and walks there (global memory outside it); a block whose window
# would pass STAGE slots stages nothing.  STAGE = 0 (walk (a)) walks in
# global memory (qf_walk.cuh).
ORDERED_CU = r"""
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "qf_walk.cuh"

#ifndef STAGE
#define STAGE 4096  // slots of the staged window; 0 walks in global memory
#endif
#define MARGIN 256  // slots staged on either side of a block's quotients
#define THREADS 256
#define SCAN_THREADS 1024

__device__ __forceinline__ long long bucket_of(int32_t q, long long total,
                                               int shift) {
  long long c = q < 0 ? 0 : (q >= total ? total - 1 : (long long)q);
  return c >> shift;
}

__global__ void __launch_bounds__(THREADS)
    bucket_count_kernel(const int32_t* __restrict__ fq, long long n,
                        long long total, int shift, int32_t* __restrict__ count) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(count + bucket_of(fq[i], total, shift), 1);
}

// count[0:nb) becomes its exclusive prefix sum, in one block: thread t
// sums a contiguous segment, the block scans the sums, then each thread
// writes its segment's offsets.
__global__ void __launch_bounds__(SCAN_THREADS)
    bucket_scan_kernel(int32_t* __restrict__ count, long long nb) {
  __shared__ int32_t warp_sum[SCAN_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long per = (nb + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long a = min(t * per, nb), b = min(a + per, nb);
  int32_t sum = 0;
  for (long long j = a; j < b; ++j) sum += count[j];
  int32_t incl = sum;  // inclusive scan within the warp
  for (int d = 1; d < 32; d <<= 1) {
    int32_t v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      int32_t v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    warp_sum[lane] = w - warp_sum[lane];  // exclusive, per warp
  }
  __syncthreads();
  int32_t run = warp_sum[warp] + incl - sum;
  for (long long j = a; j < b; ++j) {
    int32_t c = count[j];
    count[j] = run;
    run += c;
  }
}

__global__ void __launch_bounds__(THREADS)
    bucket_scatter_kernel(const int32_t* __restrict__ fq,
                          const int32_t* __restrict__ fr, long long n,
                          long long total, int shift,
                          int32_t* __restrict__ cursor,
                          int32_t* __restrict__ order, int2* __restrict__ qr) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t q = fq[i];
  int32_t d = atomicAdd(cursor + bucket_of(q, total, shift), 1);
  order[d] = (int32_t)i;
  qr[d] = make_int2(q, fr[i]);
}

#if STAGE > 0
// The planes, read from the block's staged window where a slot lies in it.
struct Window {
  const int32_t* __restrict__ rem;
  const uint8_t* __restrict__ occ;
  const uint8_t* __restrict__ shf;
  const uint8_t* __restrict__ con;
  const int32_t* s_rem;
  const uint8_t* s_occ;
  const uint8_t* s_shf;
  const uint8_t* s_con;
  long long w0;
  unsigned long long wlen;

  __device__ __forceinline__ bool in(long long x) const {
    return (unsigned long long)(x - w0) < wlen;
  }
  __device__ __forceinline__ uint8_t o(long long x) const {
    return in(x) ? s_occ[x - w0] : occ[x];
  }
  __device__ __forceinline__ uint8_t s(long long x) const {
    return in(x) ? s_shf[x - w0] : shf[x];
  }
  __device__ __forceinline__ uint8_t c(long long x) const {
    return in(x) ? s_con[x - w0] : con[x];
  }
  __device__ __forceinline__ int32_t r(long long x) const {
    return in(x) ? s_rem[x - w0] : rem[x];
  }
};

// qf_walk (qf_walk.cuh) step for step, through the window.
__device__ __forceinline__ int window_walk(const Window& w, long long total,
                                           long long q, int32_t r) {
  if (q < 0 || q >= total || !w.o(q)) return 0;
  long long b = q;
  while (b > 0 && w.s(b)) --b;
  long long R = 0;
  for (long long j = b; j <= q; ++j) R += w.o(j);
  long long s = b;
  for (long long c = 1; c < R;) {
    if (++s >= total) return 0;
    if ((w.o(s) | w.s(s)) && !w.c(s)) ++c;
  }
  for (;;) {
    if (w.r(s) == r) return 1;
    if (++s >= total || !w.c(s)) return 0;
  }
}
#endif

__global__ void __launch_bounds__(THREADS)
    qf_walk_kernel(const int32_t* __restrict__ rem,
                   const uint8_t* __restrict__ occ,
                   const uint8_t* __restrict__ shf,
                   const uint8_t* __restrict__ con, long long total,
                   bool aligned, const int2* __restrict__ qr,
                   const int32_t* __restrict__ order, long long n,
                   uint8_t* __restrict__ present) {
  long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const bool act = k < n;
  const int2 v = act ? qr[k] : make_int2(0, 0);
#if STAGE > 0
  __shared__ __align__(16) int32_t s_rem[STAGE];
  __shared__ __align__(16) uint8_t s_occ[STAGE];
  __shared__ __align__(16) uint8_t s_shf[STAGE];
  __shared__ __align__(16) uint8_t s_con[STAGE];
  __shared__ int32_t lo_s[THREADS / 32], hi_s[THREADS / 32];
  __shared__ long long w0_s, wlen_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the block's least and greatest in-range quotient
  const bool live = act && v.x >= 0 && v.x < total;
  int32_t lo = __reduce_min_sync(0xffffffffu, live ? v.x : INT_MAX);
  int32_t hi = __reduce_max_sync(0xffffffffu, live ? v.x : -1);
  if (lane == 0) lo_s[warp] = lo, hi_s[warp] = hi;
  __syncthreads();
  if (tid == 0) {  // lo and hi are warp 0's already
    for (int i = 1; i < THREADS / 32; ++i)
      lo = min(lo, lo_s[i]), hi = max(hi, hi_s[i]);
    long long w0 = max((long long)lo - MARGIN, 0ll) & ~15ll;
    long long end = min((long long)hi + MARGIN + 1, total);
    w0_s = w0;
    wlen_s = hi >= 0 && end - w0 <= STAGE ? end - w0 : 0;
  }
  __syncthreads();
  const long long w0 = w0_s;
  const int wlen = (int)wlen_s;
  // stage the window: whole 16-byte chunks where the planes allow, then
  // the ragged end
  const int vec = aligned ? wlen & ~15 : 0;
  for (int c = tid; c < vec / 4; c += THREADS)
    reinterpret_cast<int4*>(s_rem)[c] = reinterpret_cast<const int4*>(rem + w0)[c];
  for (int c = tid; c < vec / 16; c += THREADS) {
    reinterpret_cast<uint4*>(s_occ)[c] = reinterpret_cast<const uint4*>(occ + w0)[c];
    reinterpret_cast<uint4*>(s_shf)[c] = reinterpret_cast<const uint4*>(shf + w0)[c];
    reinterpret_cast<uint4*>(s_con)[c] = reinterpret_cast<const uint4*>(con + w0)[c];
  }
  for (int s = vec + tid; s < wlen; s += THREADS) {
    s_rem[s] = rem[w0 + s];
    s_occ[s] = occ[w0 + s];
    s_shf[s] = shf[w0 + s];
    s_con[s] = con[w0 + s];
  }
  __syncthreads();
  if (!act) return;
  const Window w{rem, occ, shf, con, s_rem, s_occ, s_shf, s_con, w0,
                 (unsigned long long)wlen};
  present[order[k]] = window_walk(w, total, v.x, v.y);
#else
  if (!act) return;
  present[order[k]] = qf_walk(rem, occ, shf, con, total, v.x, v.y);
#endif
}

// Step 1: the queries' quotient order.  count holds nb int32 (zeroed
// here), order n int32, qr n int2 (8-byte aligned).  Returns
// cudaGetLastError().
extern "C" int qf_probe_order(const void* fq, const void* fr, long long n,
                              long long total, int shift, long long nb,
                              void* count, void* order, void* qr,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    cudaMemsetAsync(count, 0, nb * sizeof(int32_t), s);
    bucket_count_kernel<<<blocks, THREADS, 0, s>>>(
        (const int32_t*)fq, n, total, shift, (int32_t*)count);
    bucket_scan_kernel<<<1, SCAN_THREADS, 0, s>>>((int32_t*)count, nb);
    bucket_scatter_kernel<<<blocks, THREADS, 0, s>>>(
        (const int32_t*)fq, (const int32_t*)fr, n, total, shift,
        (int32_t*)count, (int32_t*)order, (int2*)qr);
  }
  return (int)cudaGetLastError();
}

// Step 2: walk the ordered queries.  Returns cudaGetLastError().
extern "C" int qf_probe_walk(const void* rem, const void* occ, const void* shf,
                             const void* con, long long total, const void* qr,
                             const void* order, long long n, void* present,
                             void* stream) {
  if (n > 0) {
    bool aligned =
        ((uintptr_t)rem | (uintptr_t)occ | (uintptr_t)shf | (uintptr_t)con) % 16 == 0;
    unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    qf_walk_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rem, (const uint8_t*)occ, (const uint8_t*)shf,
        (const uint8_t*)con, total, aligned, (const int2*)qr,
        (const int32_t*)order, n, (uint8_t*)present);
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
    modules ``cuda_lib``, ``qf_build``, ``qf_probe`` and ``cascade_probe``
    loaded."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", pkg / "__init__.py", submodule_search_locations=[str(pkg)]
    )
    sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[spec.name])
    for name in ("cuda_lib", "qf_build", "qf_probe", "cascade_probe"):
        importlib.import_module(f"parent_repro_torch.kernels.{name}")
    return sys.modules["parent_repro_torch.kernels"]


def ordered_entries(lib):
    """``ORDERED_CU`` as built here: ``order(fq, fr, slots)`` gives
    ``(qr, order)``, the queries' ``(fq, fr)`` pairs bucket by bucket and
    their indices; ``walk(planes, qr, order)`` answers them in the
    caller's order."""
    lib.qf_probe_order.argtypes = [_P, _P, _I64, _I64, ctypes.c_int, _I64, _P, _P, _P, _P]
    lib.qf_probe_walk.argtypes = [_P, _P, _P, _P, _I64, _P, _P, _I64, _P, _P]

    def order(fq, fr, t):
        n = fq.shape[0]
        # the fewest power-of-two buckets, at most one per 32 queries
        target, shift = min(max(n // 32, 1), 1 << 17), 0
        while ((t - 1) >> shift) + 1 > target:
            shift += 1
        nb = ((t - 1) >> shift) + 1
        scratch = torch.empty(3 * n + nb, dtype=torch.int32, device=fq.device)
        qr, idx, count = scratch[: 2 * n].view(n, 2), scratch[2 * n : 3 * n], scratch[3 * n :]
        cuda_lib.check(lib.qf_probe_order(
            fq.data_ptr(), fr.data_ptr(), n, t, shift, nb, count.data_ptr(),
            idx.data_ptr(), qr.data_ptr(), cuda_lib.stream_handle(fq.device)), "order")
        return qr, idx

    def walk(planes, qr, idx):
        present = torch.empty(idx.shape[0], dtype=torch.bool, device=idx.device)
        cuda_lib.check(lib.qf_probe_walk(
            *(p.data_ptr() for p in planes), planes[0].shape[0], qr.data_ptr(),
            idx.data_ptr(), idx.shape[0], present.data_ptr(),
            cuda_lib.stream_handle(idx.device)), "ordered walk")
        return present

    return order, walk


def sort_order(fq, fr, t=None):
    """The quotient order by ``torch.sort``, as ``ordered_entries``'s
    ``order`` gives it, fully sorted."""
    sq, idx = torch.sort(fq)
    return torch.stack([sq, fr[idx]], 1), idx.to(torch.int32)


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
               f"mean {sum(t) / len(t):.5f}")


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


def facade_split(label, cfg, state, keys, calls: int = 5) -> None:
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
    cs.log(f"  {label} façade probe of {keys.shape[0]} keys, no profiler: wall "
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
    cs.log(f"  {label}: the same call as a CUDA graph: "
           f"{', '.join(f'{x:.5f}' for x in replays)} ms (median {busy_ms:.5f}); "
           f"device idle share of the eager call {1 - busy_ms / wall_ms:.4f}")
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
    cs.log(f"  {label} under the profiler: {n_kernels} device operations a call, "
           f"{busy_us:.1f} us of device time")
    for e in rows[:12]:
        cs.log(f"    {e.self_device_time_total / calls:9.1f} us  {e.count // calls:3d}x  "
               f"{e.key[:70]}")


def exact(label: str, got, want) -> None:
    if cs.max_abs_err(got, want) != 0:
        raise AssertionError(f"{label} disagrees with the plain version")


def build_turns(pk, device) -> tuple:
    """``qf_build_planes`` of both trees at full and at quarter load;
    returns the full-load table's ``(cfg, planes, keys)``."""
    cfg = cs.qf.QFConfig(q=cs.RAM_Q, r=cs.P_BITS - cs.RAM_Q)
    keys = cs.uint32_keys(np.random.default_rng(cs.SEED), cfg.capacity, device)
    full = None
    for label, n in (("full load", cfg.capacity), ("quarter load", cfg.m // 4)):
        fq, fr = cs.sorted_stream(cfg, keys[:n])
        nn, _, pos, _ = cs.qf.probe_positions(cfg, fq, n)
        args = (cs.i32(pos), cs.i32(fq), cs.i32(fr), nn, cfg.total_slots)
        want = qf_build.build_planes_plain(*args)
        got = qf_build.qf_build_planes(*args)
        exact("this tree's qf_build_planes", got, want)
        exact("the parent's qf_build_planes", pk.qf_build.qf_build_planes(*args), want)
        cs.log(f"qf_build_planes, {label}: {n} items on {cfg.total_slots} slots")
        turns(f"qf_build_planes {label}", {
            "parent": lambda a=args: pk.qf_build.qf_build_planes(*a),
            "this tree": lambda a=args: qf_build.qf_build_planes(*a),
        }, 10, 2)
        full = full or (cfg, got, keys)
        del want
    return full


def probe_turns(pk, libs, built, device) -> None:
    """``qf_probe`` of both trees on ``check_probe``'s queries, then the
    steps of this tree's design and of the quotient-ordered ones alone,
    and each design whole."""
    cfg, planes, keys = built
    rng = np.random.default_rng(cs.SEED + 1)
    half = cs.PARITY_PROBES // 2
    hits = keys[torch.from_numpy(rng.integers(0, keys.shape[0], half)).to(device)]
    fq, fr = cs.qf.fingerprints(cfg, torch.cat([hits, cs.uint32_keys(rng, half, device)]))
    fq, fr = cs.i32(fq), cs.i32(fr)
    t = planes[0].shape[0]
    count_order, walk_b = ordered_entries(libs["ordered_b"])
    _, walk_a = ordered_entries(libs["ordered_a"])
    orders = {"counting order": count_order, "torch.sort": sort_order}
    walks = {"walk (a)": walk_a, "walk (b)": walk_b}
    bits = qf_probe.pack_bits(*planes[1:])
    for size in (cs.PARITY_PROBES, cs.PROBES):
        q, r = fq[:size], fr[:size]
        want = qf_probe.probe_plain(*planes, q, r)
        exact("this tree's qf_probe", [qf_probe.qf_probe(*planes, q, r)], [want])
        exact("the parent's qf_probe", [pk.qf_probe.qf_probe(*planes, q, r)], [want])
        exact("the byte walk", [qf_probe.walk(*planes, q, r)], [want])
        sqr, sidx = sort_order(q, r)
        sq, sr, idx = sqr[:, 0].contiguous(), sqr[:, 1].contiguous(), sidx.long()
        exact("the bit walk on sorted queries",
              [qf_probe.walk(*planes, sq, sr, bits)], [want[idx]])

        def sorted_bit_walk():
            qr, i = sort_order(q, r)
            out = torch.empty_like(want)
            out[i.long()] = qf_probe.walk(*planes, qr[:, 0].contiguous(),
                                           qr[:, 1].contiguous(),
                                           qf_probe.pack_bits(*planes[1:]))
            return out

        exact("torch.sort + bit walk", [sorted_bit_walk()], [want])
        for on, order in orders.items():
            for wn, walk in walks.items():
                exact(f"{on} + {wn}", [walk(planes, *order(q, r, t))], [want])
        cs.log(f"qf_probe, {size} queries on the full-load q = {cfg.q} table")
        both = {
            "parent": lambda: pk.qf_probe.qf_probe(*planes, q, r),
            "this tree": lambda: qf_probe.qf_probe(*planes, q, r),
        }
        turns(f"qf_probe {size} queries", both, 20, 2)
        cs.log(f"  qf_probe {size} queries, host issue time a call: " + ", ".join(
            f"{n} {host_us(fn):.2f} us" for n in ("parent", "this tree", "this tree",
                                                   "parent") for fn in [both[n]]))
        made = {on: order(q, r, t) for on, order in orders.items()}
        steps = {
            "pack": lambda: qf_probe.pack_bits(*planes[1:]),
            "bit walk": lambda: qf_probe.walk(*planes, q, r, bits),
            "byte walk": lambda: qf_probe.walk(*planes, q, r),
            "bit walk on sorted queries": lambda: qf_probe.walk(*planes, sq, sr, bits),
        }
        steps.update({on: (lambda o=order: o(q, r, t)) for on, order in orders.items()})
        steps.update({
            f"{wn} after {on}": (lambda w=walk, a=made[on]: w(planes, *a))
            for on in orders for wn, walk in walks.items()
        })
        turns(f"qf_probe {size} queries, one step:", steps, 20, 1)
        whole = {"pack + bit walk (this tree)": lambda: qf_probe.qf_probe(*planes, q, r),
                 "torch.sort + pack + bit walk + un-permute": sorted_bit_walk}
        whole.update({
            f"{on} + {wn}": (lambda o=order, w=walk: w(planes, *o(q, r, t)))
            for on, order in orders.items() for wn, walk in walks.items()
        })
        turns(f"qf_probe {size} queries, whole designs:", whole, 20, 1)
        del made, steps, whole


def dense_rule(cfg, state, keys) -> None:
    """``qf_probe``'s two walks on each tier of a ``buffered_qf`` façade
    probe of ``keys``: which one ``DENSE`` picks, and what each costs."""
    for tier, tcfg, s in (("RAM", cfg.ram, state.ram), ("disk", cfg.disk, state.disk)):
        fq, fr = (cs.i32(x) for x in cs.qf.fingerprints(tcfg, keys))
        planes = (s.rem, s.occ, s.shf, s.con)
        want = qf_probe.probe_plain(*planes, fq, fr)
        fns = {
            "byte walk": lambda p=planes, q=fq, r=fr: qf_probe.walk(*p, q, r),
            "pack + bit walk": lambda p=planes, q=fq, r=fr: qf_probe.walk(
                *p, q, r, qf_probe.pack_bits(*p[1:])),
        }
        for name, fn in fns.items():
            exact(f"the {tier} tier's {name}", [fn()], [want])
        dense = fq.shape[0] * qf_probe.DENSE >= planes[0].shape[0]
        cs.log(f"buffered_qf's {tier} tier, q = {tcfg.q}: {fq.shape[0]} queries on "
               f"{planes[0].shape[0]} slots ({int(s.n)} fingerprints); qf_probe "
               f"{'packs' if dense else 'walks the byte planes'}")
        turns(f"qf_probe on the {tier} tier", fns, 20, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns.py: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # builds: this tree's, the parent's, the ordered designs and the gather
    t0 = time.perf_counter()
    pk = load_parent(args.parent)
    names = ("qf_build", "qf_probe", "cascade_probe")
    for tree, lib in (("this tree", cuda_lib), ("parent", pk.cuda_lib)):
        for name, report in lib.build(names).items():
            cs.log(f"  nvcc {name} ({tree}): {occupancy(report)}")
    gather_src = cuda_lib.BUILD_DIR / "turns" / "gather.cu"
    gather_src.parent.mkdir(parents=True, exist_ok=True)
    gather_src.write_text(GATHER_CU)
    ordered_src = cuda_lib.BUILD_DIR / "turns" / "ordered.cu"
    ordered_src.write_text(ORDERED_CU)
    inc = ("-I", str(cuda_lib.CSRC))
    libs = build({
        "gather": (gather_src, ()),
        "ordered_a": (ordered_src, (*inc, "-DSTAGE=0")),
        "ordered_b": (ordered_src, inc),
    })
    cs.log(f"built in {time.perf_counter() - t0:.3f} s")

    built = build_turns(pk, device)
    probe_turns(pk, libs, built, device)
    del built
    torch.cuda.empty_cache()

    # the main path's keys, as chip_smoke.py's phase 3 makes them
    rng = np.random.default_rng(cs.SEED)
    n_total = cs.RATIO * cs.qf.QFConfig(q=cs.RAM_Q, r=1).capacity
    step = n_total // cs.BATCHES
    keys = cs.uint32_keys(rng, n_total, device)
    inserted_sorted = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF).values
    rng.integers(0, n_total, cs.PROBES)  # phase 3's sample of inserted keys
    fresh = cs.fresh_keys(rng, inserted_sorted, cs.PROBES, device)
    del inserted_sorted
    specs = cs.specs("pallas")

    # cascade_probe on the cascade after MID_BATCHES, check_cascade's probes
    cfg, state = filters.make("cascade", **specs["cascade"])
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
    exact("this tree's cascade_probe", [cascade_probe.cascade_probe(*cargs)], [want])
    exact("the parent's cascade_probe", [pk.cascade_probe.cascade_probe(*cargs)], [want])
    for size in (cs.PARITY_PROBES, cs.PROBES):
        a = (*cargs[:3], fq[:size], fr[:size], rc)
        turns(f"cascade_probe {size} queries", {
            "parent": lambda a=a: pk.cascade_probe.cascade_probe(*a),
            "this tree": lambda a=a: cascade_probe.cascade_probe(*a),
        }, 10, 2)
    facade_split("cascade", cfg, state, fresh)
    del state, structs, cargs, want
    torch.cuda.empty_cache()

    # the buffered_qf façade probe, with each tree's qf_probe behind ops.lookup
    cfg, state = filters.make("buffered_qf", **specs["buffered_qf"])
    for b in range(cs.MID_BATCHES):
        state = filters.insert(cfg, state, keys[b * step : (b + 1) * step])
    mine = ops.qf_probe
    _, want = filters.probe(cfg, state, fresh)
    ops.qf_probe = pk.qf_probe.qf_probe
    _, got = filters.probe(cfg, state, fresh)
    ops.qf_probe = mine
    exact("buffered_qf's façade probe with the parent's qf_probe", [got], [want])

    def parent_probe():
        ops.qf_probe = pk.qf_probe.qf_probe
        try:
            filters.probe(cfg, state, fresh)
        finally:
            ops.qf_probe = mine

    cs.log(f"buffered_qf façade probe of {fresh.shape[0]} fresh keys, RAM tier "
           f"{int(state.ram.n)}, disk tier {int(state.disk.n)} fingerprints")
    turns("buffered_qf façade probe", {
        "parent": parent_probe,
        "this tree": lambda: filters.probe(cfg, state, fresh),
    }, 20, 4)
    dense_rule(cfg, state, fresh)
    facade_split("buffered_qf", cfg, state, fresh)
    del state, keys
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
