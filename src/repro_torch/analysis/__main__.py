"""CLI for the static analysis pass: ``python -m repro_torch.analysis``.

Subcommands (default ``all``):

- ``lint``  — AST host-sync lint over ``src/repro_torch`` against the
  committed ``baseline.toml`` allowlist.
- ``trace`` — op audit of every registry family's ops against the
  committed ``trace_manifest.json``, on the CPU, or on the card with
  ``--device cuda`` (``--update`` refreshes that device's section after a
  reviewed change; ``--strict`` promotes operation-set drift to failure).
- ``spec``  — CUDA kernel-contract checker (ctypes bindings against the
  ``extern "C"`` prototypes; counters, plain versions, tests and
  ``chip_smoke.py`` entries).
- ``all``   — run the three in sequence; exit non-zero if any fails.

Exit code 0 = clean against committed baselines; 1 = findings.
"""

from __future__ import annotations

import argparse
import os
import sys


def _repo_root() -> str:
    # src/repro_torch/analysis/__main__.py -> repo root
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _run_lint(ns) -> int:
    from .lint import render_report, run_lint

    result = run_lint(_repo_root())
    print(render_report(result, verbose=ns.verbose))
    return 0 if result.ok else 1


def _run_trace(ns) -> int:
    from .trace_audit import run_audit

    from .trace_audit import MANIFEST_PATH

    return run_audit(update=ns.update, strict=ns.strict, verbose=ns.verbose,
                     device=ns.device, manifest_path=ns.manifest or MANIFEST_PATH)


def _run_spec(ns) -> int:
    from .spec_check import run_spec_check

    return run_spec_check(verbose=ns.verbose)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="host-sync + kernel-contract static analysis pass",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd")
    for name in ("lint", "trace", "spec", "all"):
        p = sub.add_parser(name)
        p.add_argument("-v", "--verbose", action="store_true")
        if name in ("trace", "all"):
            p.add_argument("--update", action="store_true",
                           help="refresh the committed trace manifest")
            p.add_argument("--strict", action="store_true",
                           help="operation-set drift fails instead of noting")
            p.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                           help="where the audit runs the families (its manifest section)")
            p.add_argument("--manifest", default=None,
                           help="a manifest other than the committed one")
    ns = parser.parse_args(argv)
    cmd = ns.cmd or "all"
    if not hasattr(ns, "update"):
        ns.update, ns.strict, ns.device, ns.manifest = False, False, "cpu", None

    if cmd == "lint":
        return _run_lint(ns)
    if cmd == "trace":
        return _run_trace(ns)
    if cmd == "spec":
        return _run_spec(ns)

    rc = 0
    for title, fn in (("repro-lint", _run_lint), ("trace-audit", _run_trace),
                      ("spec-check", _run_spec)):
        print(f"== {title} ==")
        rc = max(rc, fn(ns))
    return rc


if __name__ == "__main__":
    sys.exit(main())
