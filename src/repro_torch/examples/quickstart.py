"""Quickstart: the paper's data structures through the one functional API.

The port of ``examples/quickstart.py``.  Every filter is an opaque
``(cfg, state)`` pair from ``repro_torch.filters``; insert / contains /
delete / merge are the same four verbs for every structure.  The JAX
example's two jitted ``lax.scan`` ingest loops are a plain loop of
``filters.insert`` over the same 25 batches here: the flush and merge
decisions are the families' own.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import filters
from ..core.cost_model import PAPER_SSD, modeled_throughput
from ..core.quotient_filter import resolve_device


def uint32_keys(rng, n: int, device) -> torch.Tensor:
    """``n`` uniform uint32 keys drawn as the JAX example draws them, as
    the int32 bit patterns the port's filters take."""
    keys = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(keys.view(np.int32)).to(device)


def pallas_hits(keys: torch.Tensor, backend: str = "pallas") -> torch.Tensor:
    """Section 4: a ``qf(q=14, r=12)`` of the first 10,000 keys under
    ``backend``, and its answers for them (the kernels on the card)."""
    kcfg, kst = filters.make("qf", q=14, r=12, backend=backend, device=keys.device)
    kst = filters.insert(kcfg, kst, keys[:10_000])
    return filters.contains(kcfg, kst, keys[:10_000])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    rng = np.random.default_rng(0)
    keys = uint32_keys(rng, 50_000, device)

    # 1. Quotient filter (paper §3): insert / query / delete
    cfg, st = filters.make("qf", q=16, r=12, device=device)  # fp ~ alpha * 2^-12
    st = filters.insert(cfg, st, keys[:40_000])
    out["qf_load"] = float(filters.stats(cfg, st)["load"])
    out["qf_all_present"] = bool(filters.contains(cfg, st, keys[:40_000]).all())
    print("QF load:", out["qf_load"])
    print("all present:", out["qf_all_present"])
    absent = uint32_keys(rng, 100_000, device)
    out["qf_fp_rate"] = float(filters.contains(cfg, st, absent).float().mean())
    print("fp rate:", out["qf_fp_rate"], "~", 0.61 * 2**-12)
    st = filters.delete(cfg, st, keys[:10_000])
    out["qf_n_after_delete"] = int(filters.stats(cfg, st)["n"])
    print("after delete:", out["qf_n_after_delete"])

    # 2. Buffered QF (paper §4): RAM buffer + sequential flush to "flash",
    #    25 batches of 2,000 keys; I/O accounting lives in device counters.
    batches = keys.reshape(25, 2_000)
    bcfg, bst = filters.make("buffered_qf", ram_q=12, disk_q=16, p=28, device=device)
    for ks in batches:
        bst = filters.insert(bcfg, bst, ks)
    io = filters.to_iolog(bst.io)
    out["bqf_flushes"] = io.flushes
    out["bqf_modeled_insert_ops_per_s"] = modeled_throughput(50_000, io, PAPER_SSD)
    print("BQF flushes:", io.flushes,
          "| insert modeled ops/s on the paper's SSD:",
          f"{out['bqf_modeled_insert_ops_per_s']:,.0f}")

    # 3. Cascade filter (paper §4): LSM-of-QFs, insert-optimized — same verbs.
    ccfg, cst = filters.make("cascade", ram_q=12, p=28, fanout=2, levels=4, device=device)
    for ks in batches:
        cst = filters.insert(ccfg, cst, ks)
    s = filters.stats(ccfg, cst)
    out["cf_levels"] = int(s["nonempty_levels"])
    out["cf_merges"] = int(s["merges"])
    out["cf_modeled_insert_ops_per_s"] = modeled_throughput(
        50_000, filters.to_iolog(cst.io), PAPER_SSD)
    out["cf_all_present"] = bool(filters.contains(ccfg, cst, keys[:5_000]).all())
    print("CF levels:", out["cf_levels"], "merges:", out["cf_merges"],
          "insert modeled ops/s:", f"{out['cf_modeled_insert_ops_per_s']:,.0f}")
    print("CF membership:", out["cf_all_present"])

    # 4. Same API, different engine: the QF build and probe through the
    #    CUDA kernels (their plain versions on the CPU).
    out["pallas_all_present"] = bool(pallas_hits(keys).all())
    print("pallas backend membership:", out["pallas_all_present"])

    # 5. Dynamic resizing (paper §3, the QF's headline edge over Blooms):
    #    start deliberately tiny and let auto_grow double the table in
    #    place whenever the load crosses the operating point.
    gcfg, gst = filters.make("qf", q=10, r=18, device=device)
    for i in range(0, 50_000, 1_000):
        gcfg, gst = filters.auto_grow(gcfg, gst, keys[i : i + 1_000])
    gs = filters.stats(gcfg, gst)
    out.update(
        auto_grow_q=gcfg.q, auto_grow_n=int(gs["n"]),
        auto_grow_load=float(gs["load"]), auto_grow_overflow=bool(gs["overflow"]),
        auto_grow_all_present=bool(filters.contains(gcfg, gst, keys).all()),
    )
    print("auto_grow: q 10 ->", gcfg.q,
          "| n:", out["auto_grow_n"],
          "| load:", round(out["auto_grow_load"], 2),
          "| overflow:", out["auto_grow_overflow"],
          "| all present:", out["auto_grow_all_present"])
    return out


if __name__ == "__main__":
    main()
