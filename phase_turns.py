#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s Bloom and cascade ingests against an earlier checkout, in turns.

Run from the repository root on a machine with one NVIDIA card::

    git archive <rev> | tar -x -C chip_scratch/parent
    python3 phase_turns.py --parent chip_scratch/parent

Each turn is a process of its own, started in the root of one tree: it
imports that tree's ``chip_smoke.py`` (and so that tree's whole package,
façade and filters included) and runs three of its phases at their own
sizes, then prints their rates as one JSON line:

- phase 5: ``drive_bloom("pallas", ...)``, bench_ssd's 50,331,648 keys
  into ``bloom``, ``blocked_bloom`` and the counting ``blocked_bloom`` in
  64 insert calls, keys/s over the wall time around the calls;
- phase 10: ``drive_inram``, Table 1(a) at q = 26, the ``bloom`` and
  ``qf`` insert ops/s of a 2**22-key batch (median of 5 calls by CUDA
  events) at r = k = 6, 9, 12;
- phase 15: ``ssd_experiment(24, 22, ...)``, bench_ssd's 1:24 draws into
  the cascade, the buffered QF and the three Bloom baselines, keys/s over
  the wall time of their ingest.

The turns go parent, this tree, this tree, parent; each tree builds its
own kernels on its first turn.  The card's name and power limit come
last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs

dev = torch.device("cuda")
cs.cuda_lib.build()
n = cs.RATIO * cs.qf.QFConfig(q=cs.RAM_Q, r=1).capacity
keys = cs.uint32_keys(np.random.default_rng(cs.SEED), n, dev)
blooms, _ = cs.drive_bloom("pallas", keys, keys[: cs.PROBES])
out = {"phase 5 keys/s": {label: n / r[4] for label, r in blooms.items()}}
del blooms, keys
torch.cuda.empty_cache()
out["phase 10 insert ops/s"] = {
    f"r={r['r']}": {s: r[s]["insert_ops_per_s"] for s in ("bf", "qf")}
    for r in cs.drive_inram(dev)
}
torch.cuda.empty_cache()
report, _, _ = cs.ssd_experiment(cs.LARGE_RATIO, cs.LARGE_RAM_Q, cs.PROBES, dev)
out["phase 15 keys/s"] = report["card_ingest_keys_per_s"]
print("RESULT " + json.dumps(out), flush=True)
"""


def turn(root: Path) -> dict:
    """One process in ``root`` running ``CHILD``; its JSON result."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise RuntimeError(f"the turn in {root} exited {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "this tree": Path(__file__).resolve().parent}
    results = {t: [] for t in trees}
    for t in ("parent", "this tree", "this tree", "parent"):
        results[t].append(turn(trees[t]))
        print(f"{t}: {json.dumps(results[t][-1])}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
