"""Run a cell several times, each run its own process, and measure the
spread of each metric: what a bound is set from.

    python3 amqbench/spread.py --workload <cell> --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 30 [--trace 0] [--out chiprun_out/spread]

Each set runs every seed once, in order; every set uses the same seeds.
A metric's spread in a set is the distance between its first and third
quartiles (``statistics.quantiles(values, n=4)``) over its median.
Prints one JSON object: each run's result line, and per metric each
set's median and spread, the widest spread, five times it (the bound it
suggests, at least 0.01), and the mean of the sets' spreads with each
set's run farthest from its median left out.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def summary(sets: list) -> dict:
    """Per metric over ``sets`` (each a list of ``{name: value}``)."""
    out = {}
    for name in sorted(set().union(*(r for s in sets for r in s))):
        per = [[r[name] for r in s if name in r] for s in sets]
        if any(len(v) < 4 for v in per):
            continue
        spreads = [spread(v) for v in per]
        out[name] = {
            "medians": [statistics.median(v) for v in per],
            "spreads": spreads,
            "widest": max(spreads),
            "suggested_bound": max(0.01, 5 * max(spreads)),
            "trimmed_mean_spread": statistics.mean(spread(trimmed(v)) for v in per),
        }
    return out


def one_run(workload, seed, seconds, trace, out: Path):
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE.parent)
    tag = f"{workload}.s{seed}.t{trace}"
    (out / f"{tag}.out").write_text(proc.stdout)
    (out / f"{tag}.err").write_text(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode or not lines:
        return {"seed": seed, "rc": proc.returncode, "err": proc.stderr[-2000:]}
    return {"seed": seed, "rc": 0, "line": json.loads(lines[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/spread")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs, sets = [], []
    for _ in range(args.sets):
        values = []
        for seed in seeds:
            r = one_run(args.workload, seed, args.seconds, args.trace, out)
            runs.append(r)
            if r["rc"] == 0:
                values.append({k: m["value"] for k, m in r["line"]["metrics"].items()})
        sets.append(values)
    report = {
        "workload": args.workload,
        "runs": runs,
        "correct": [r.get("line", {}).get("correct") for r in runs],
        "metrics": summary(sets),
    }
    print(json.dumps(report))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
