"""Serving with an AMQ prefix-cache front (paper's per-subtable filter
pattern): repeated prompts skip the remote KV-store probe.

The port of ``examples/serve_prefix_cache.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_prefix_cache [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.quotient_filter import resolve_device
from ..serve.prefix_cache import PrefixCacheFilter


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pc = PrefixCacheFilter(q=14, r=16, device=resolve_device(args.device))
    rng = np.random.default_rng(0)
    remote_probes_without = 0
    remote_probes_with = 0
    catalog = []
    for step in range(20):
        # 60% fresh prompts, 40% repeats
        bsz = 32
        prompts = rng.integers(0, 32000, (bsz, 64))
        n_rep = int(0.4 * bsz)
        if catalog:
            for j in range(n_rep):
                prompts[j] = catalog[rng.integers(0, len(catalog))]
        hits = pc.check_and_insert(prompts)
        catalog.extend(list(prompts[~hits]))
        remote_probes_without += bsz  # naive: always probe remote store
        remote_probes_with += int(hits.sum())  # filtered: only on maybe-hit
    out = {
        "remote_probes_naive": remote_probes_without,
        "remote_probes_with_filter": remote_probes_with,
        "saved": 1 - remote_probes_with / remote_probes_without,
        "load": pc.load,
    }
    print(f"remote probes naive={remote_probes_without}  "
          f"with QF front={remote_probes_with}  "
          f"({100 * out['saved']:.0f}% saved)")
    print(f"filter load={out['load']:.2f}")
    return out


if __name__ == "__main__":
    main()
