"""Op audit: every registry family's ops, their aten operations and host reads.

The port of ``repro.analysis.trace_audit``, which audits jaxprs.  The
port has no trace to read, so the audit runs each op and watches it.
For each registered filter family (the reference's small geometries,
``family_specs``) it runs ``insert`` on the empty state, then
``contains / delete / merge / probe / needs_resize / needs_shrink`` on
the state that insert left, each under :class:`OpAudit`, a
``TorchDispatchMode``, and records per op:

- **status** — ``device`` (no host read), ``host`` (it read the host:
  the op is host-composed by design, e.g. the frozen cascade's peeling
  merge-down), ``unbound`` (the family does not register the op),
  ``unsupported`` (a config-level refusal), or ``error``.
- **ops** — the count of aten operations, the audit's size fingerprint
  (the reference's ``eqns``): a silent fallback from a kernel to its
  plain version, or to a host loop, shows up as a blow-up here.
- **aten** — the histogram of aten operations (the reference's
  ``prims``).

A host read is ``_local_scalar_dense`` (``HOST_READS``: ``.item()``,
``int()``, ``bool()`` and a Python branch on a tensor all reach it) or,
on the card, a copy from the card to the CPU.  ``.numpy()`` and
``.cpu()`` of a CPU tensor dispatch nothing, so the CPU audit sees only
the former; the lint covers the rest statically.  On the card
(``device="cuda"``) every op runs under ``torch.cuda.
set_sync_debug_mode("error")`` too, so any synchronizing call, seen or
not (a boolean-mask index or ``nonzero`` waits for its row count),
makes the op ``host``, and each synchronizing call is pinned to its site:
the port's ``path::function`` that issued it (``sync_site``).  The
``cuda`` section records per op ``syncs`` (their count) and
``sync_sites`` (the count at each site); every site there is a
deliberate read listed in ``KNOWN_SYNC_SITES`` with its reason, so a
new copy from the host cannot hide in an op that is already ``host``.
The kernels are ctypes calls that no
dispatch mode sees, so the ``cuda`` section's counts are smaller than the
``cpu`` section's for the ``[pallas]`` families: a wrapper that quietly
ran its plain version on the card would blow its count up past
``BLOWUP``.

The result diffs against the committed ``trace_manifest.json``, whose
``cpu`` section tier-1 checks and whose ``cuda`` section ``chip_smoke.py``
checks on the card: status changes (a ``device`` op that reads the host
fails, as a forbidden primitive fails the reference's audit), new or
removed ops, op-count blow-ups (> ``BLOWUP`` x), and on the card more
syncs than committed, a new sync site or a site's count grown, fail with
a readable diff; operation-set drift is informational unless ``--strict``.
Refresh a section with ``python -m repro_torch.analysis trace --update
[--device cuda]`` after a reviewed change.

Where the ``cpu`` section's statuses differ from the JAX package's
committed manifest (``traced`` there is ``device`` here), each is a
deviation of the port by design (ROADMAP Queue 3), listed in
``JAX_STATUS_DIFFERENCES``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import warnings
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "trace_manifest.json")
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
_PACKAGE_DIR = os.path.dirname(_ANALYSIS_DIR)

OPS = (
    "insert",
    "contains",
    "delete",
    "merge",
    "probe",
    "needs_resize",
    "needs_shrink",
)

# the aten operation that hands a tensor's value to a Python scalar
HOST_READS = ("_local_scalar_dense",)

BLOWUP = 2.0  # an op's aten count may not exceed manifest * BLOWUP

# (family, op) -> why its status on the CPU is ``host`` where the JAX
# package's is ``traced``: each a deviation of the port by design (ROADMAP
# Queue 3), the site that reads
_PLAIN_LOOKUP = "the plain path's lookup reads a window overflow (core/quotient_filter.py lookup)"
_COLLAPSE = "the merge-down target level is read (filters/cascade.py _collapse_target)"
_MERGE = "a merge reads its target level (filters/cascade.py merge)"
_EMPTY_LEVEL = ("the plain path skips an empty level (filters/cascade.py _qf_contains), "
                "and " + _PLAIN_LOOKUP)
_PLAIN_CASCADE = ("on the CPU the kernel's plain version skips empty levels "
                  "(kernels/cascade_probe.py cascade_probe_plain); the cuda section has it")
JAX_STATUS_DIFFERENCES = {
    ("qf", "contains"): _PLAIN_LOOKUP,
    ("buffered_qf", "insert"): "the flush decision reads the RAM QF's load "
                               "(filters/buffered.py insert)",
    ("buffered_qf", "contains"): _PLAIN_LOOKUP,
    ("buffered_qf", "probe"): _PLAIN_LOOKUP,
    ("cascade", "insert"): _COLLAPSE,
    ("cascade", "contains"): _EMPTY_LEVEL,
    ("cascade", "merge"): _MERGE,
    ("cascade", "probe"): _EMPTY_LEVEL,
    ("cascade[pallas]", "insert"): _COLLAPSE,
    ("cascade[pallas]", "contains"): _PLAIN_CASCADE,
    ("cascade[pallas]", "merge"): _MERGE,
    ("cascade[pallas]", "probe"): _PLAIN_CASCADE,
    ("cascade[frozen]", "insert"): _COLLAPSE,
    ("cascade[frozen]", "contains"): _EMPTY_LEVEL,
    ("cascade[frozen]", "merge"): _MERGE + ", and the freeze sizes its planes "
                                  "(core/fuse_filter.py freeze_stream)",
    ("cascade[frozen]", "probe"): _EMPTY_LEVEL,
    ("sharded_qf", "contains"): _PLAIN_LOOKUP,
}

# ``path::function`` -> why the port reads the card there on purpose (ROADMAP
# Queue 3, "deviations of the port by design").  Every site in the manifest's
# ``cuda`` section must be one of these; a copy from the host is repaired.
KNOWN_SYNC_SITES = {
    "filters/buffered.py::insert":
        "the flush decision reads the RAM QF's load (bool), where the JAX package "
        "branches with lax.cond",
    "filters/cascade.py::_collapse_target":
        "the merge-down target level is read (int), once an insert batch",
    "filters/cascade.py::merge":
        "a merge reads its target level (int) before it rebuilds",
    "filters/steady.py::insert":
        "one transfer an insert (buffer count, idle flag, clean, k) decides the "
        "JAX package's three lax.conds",
    "core/quotient_filter.py::lookup":
        "backend=\"reference\": a window overflow retries wider, then exact; "
        "read once a chunk",
    "filters/cascade.py::_qf_contains":
        "backend=\"reference\": membership skips an empty level",
    "filters/xor_fuse.py::merge":
        "the union's count (int), read once: checked against the frozen "
        "capacity (a ValueError, as the reference raises) and the re-peel's size",
    "core/fuse_filter.py::freeze_stream":
        "a freeze reads its stream's count (int) to size its run planes, and "
        "its distinct fingerprints (nonzero) to size the peel",
    "core/fuse_filter.py::_peel":
        "the peel compacts its live keys (alive[live]) after 1, 2, 4, ... 32 "
        "rounds, and the boolean-mask index waits for their count",
    "core/fuse_filter.py::_peel_assign":
        "the peel's keys per round (bincount, tolist), read once to replay the "
        "assignment round by round",
}


class OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _is_host_read(name: str, args, out) -> bool:
    """``_local_scalar_dense``, or a copy from the card to the CPU."""
    if name in HOST_READS:
        return True
    if name in ("_to_copy", "copy_"):
        ins = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        return any(t.is_cuda for t in ins) and any(t.is_cpu for t in outs)
    return False


class OpAudit(TorchDispatchMode):
    """The aten operations dispatched inside it, by name, and the host
    reads among them."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.aten: dict[str, int] = {}
        self.host_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.n += 1
        self.aten[name] = self.aten.get(name, 0) + 1
        self.host_reads += _is_host_read(name, (args, kwargs), out)
        return out


def family_specs() -> dict[str, dict]:
    """The reference's small geometries: the counts depend on the code,
    not the width."""
    return {
        "qf": dict(q=8, r=8),
        "qf[pallas]": dict(q=8, r=8, backend="pallas"),
        "bloom": dict(m_bits=2048, k=4, counting=True),
        "blocked_bloom": dict(m_bits=65536, k=4, block_bits=32768, counting=True),
        "buffered_qf": dict(ram_q=6, disk_q=10, p=20),
        "cascade": dict(ram_q=6, p=20, levels=2),
        "cascade[pallas]": dict(ram_q=6, p=20, levels=2, backend="pallas"),
        "cascade[frozen]": dict(ram_q=6, p=24, levels=2, frozen_below=1),
        "sharded_qf": dict(q=8, r=8, n_shards=1),
        "xor_fuse": dict(capacity=128),
    }


def _keys(n: int = 64, device="cpu"):
    """The reference's deterministic uint32 batch (Knuth multiplicative),
    as the int32 bit patterns the port's filters take."""
    mixed = (torch.arange(1, n + 1, dtype=torch.int64) * 2654435761) & 0xFFFFFFFF
    mixed = mixed ^ 0x9E3779B9
    return (mixed - ((mixed >> 31) << 32)).to(torch.int32).to(device)


def sync_site(frame) -> str:
    """``path::function`` of the innermost frame of the port outside
    ``analysis/``, walking out from ``frame``: the port's code that issued
    a call.  The function is its qualified name without ``<locals>``, as
    the lint's baseline names it.  A warning raised through a dispatch
    mode names the mode's frame, so the walk passes it.  A call with no
    frame of the port names the innermost frame that warned."""
    first = frame
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PACKAGE_DIR + os.sep) and not path.startswith(
            _ANALYSIS_DIR + os.sep
        ):
            rel = os.path.relpath(path, _PACKAGE_DIR).replace(os.sep, "/")
            return f"{rel}::{frame.f_code.co_qualname.replace('.<locals>', '')}"
        frame = frame.f_back
    while first is not None and first.f_code.co_filename == warnings.__file__:
        first = first.f_back
    code = first.f_code if first is not None else None
    where = f"{os.path.basename(code.co_filename)}::{code.co_qualname}" if code else "?"
    return f"<outside the port: {where}>"


@contextlib.contextmanager
def recorded_syncs():
    """Yield a dict that counts, by :func:`sync_site`, the synchronizing
    calls the card warns of inside the block (sync-debug ``"warn"``)."""
    sites: dict[str, int] = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            site = sync_site(sys._getframe(1))
            sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        yield sites


def _run_watched(device: str, thunk, audit, mode: str):
    """``thunk()`` inside ``audit``; on the card under sync-debug ``mode``.
    Returns (its result, the synchronizing calls the card warned of, by
    site)."""
    if device != "cuda":
        with audit:
            return thunk(), {}
    prev = torch.cuda.get_sync_debug_mode()
    with recorded_syncs() as sites:
        torch.cuda.set_sync_debug_mode(mode)
        try:
            with audit:
                out = thunk()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sites


def _audit_op(device: str, thunk) -> tuple[dict, object]:
    """One op's record and result.  On the card it runs under sync-debug
    ``"warn"`` (a synchronizing call makes it ``host``), and a ``device``
    op runs again under ``"error"``, which must raise nothing."""
    from ..filters.registry import UnsupportedOpError

    audit = OpAudit()
    try:
        out, sites = _run_watched(device, thunk, audit, "warn")
        if device == "cuda" and not (sites or audit.host_reads):
            out, _ = _run_watched(device, thunk, OpAudit(), "error")
    except UnsupportedOpError:
        return {"status": "unsupported"}, None
    except Exception as e:  # noqa: BLE001 - audited + surfaced below
        return {"status": "error", "error": f"{type(e).__name__}: {e}"}, None
    status = "host" if audit.host_reads or sites else "device"
    entry = {"status": status, "ops": audit.n, "aten": audit.aten}
    if device == "cuda":
        entry.update(syncs=sum(sites.values()), sync_sites=dict(sorted(sites.items())))
    return entry, out


def trace_family(fam: str, spec: dict, device: str = "cpu") -> dict[str, dict]:
    from .. import filters
    from ..filters.registry import by_cfg

    name = fam.split("[")[0]
    cfg, state = filters.make(name, device=device, **spec)
    impl = by_cfg(cfg)
    keys = _keys(device=device)
    out: dict[str, dict] = {}
    if impl.insert is not None:
        out["insert"], new = _audit_op(device, lambda: impl.insert(cfg, state, keys))
        state = new if new is not None else state
    for op in OPS:
        if op in out:
            continue
        fn = getattr(impl, op, None)
        if fn is None:
            out[op] = {"status": "unbound"}
            continue
        if op == "delete" and not impl.deletable(cfg):
            out[op] = {"status": "unsupported"}
            continue
        if op in ("contains", "delete", "probe"):
            thunk = lambda fn=fn: fn(cfg, state, keys)  # noqa: E731
        elif op == "merge":
            thunk = lambda fn=fn: fn(cfg, state, state)  # noqa: E731
        else:  # needs_resize / needs_shrink
            thunk = lambda fn=fn: fn(cfg, state)  # noqa: E731
        out[op], _ = _audit_op(device, thunk)
    return out


def collect(families: Optional[list[str]] = None, device: str = "cpu") -> dict:
    specs = family_specs()
    if families:
        specs = {
            k: v
            for k, v in specs.items()
            if k.split("[")[0] in families or k in families
        }
    return {"families": {fam: trace_family(fam, spec, device)
                         for fam, spec in specs.items()}}


def errors(current: dict) -> list[str]:
    out = []
    for fam, ops in current["families"].items():
        for op, entry in ops.items():
            if entry["status"] == "error":
                out.append(f"{fam}.{op}: the op raised {entry['error']}")
    return out


def diff(current: dict, manifest: dict, strict: bool = False) -> tuple[list[str], bool]:
    """Readable diff lines + pass/fail against the committed manifest."""
    lines: list[str] = []
    failed = False
    cur, man = current["families"], manifest.get("families", {})
    for fam in sorted(set(cur) | set(man)):
        if fam not in man:
            lines.append(f"FAIL {fam}: new family not in manifest (run --update)")
            failed = True
            continue
        if fam not in cur:
            lines.append(f"FAIL {fam}: in manifest but no longer audited (run --update)")
            failed = True
            continue
        for op in sorted(set(cur[fam]) | set(man[fam])):
            c, m = cur[fam].get(op), man[fam].get(op)
            if m is None:
                lines.append(f"FAIL {fam}.{op}: new op not in manifest (run --update)")
                failed = True
                continue
            if c is None:
                lines.append(f"FAIL {fam}.{op}: op disappeared (run --update)")
                failed = True
                continue
            if c["status"] != m["status"]:
                lines.append(
                    f"FAIL {fam}.{op}: status {m['status']} -> {c['status']} — "
                    "a device op reading the host (or the reverse) must be a "
                    "reviewed change (run --update after review)"
                )
                failed = True
                continue
            if c["status"] not in ("device", "host"):
                continue
            if c["ops"] > m["ops"] * BLOWUP:
                lines.append(
                    f"FAIL {fam}.{op}: aten op count {m['ops']} -> {c['ops']} "
                    f"(> {BLOWUP:.1f}x blow-up — a kernel fell back to its plain version?)"
                )
                failed = True
            added = set(c["aten"]) - set(m["aten"])
            removed = set(m["aten"]) - set(c["aten"])
            if added or removed:
                note = (
                    f"{'FAIL' if strict else 'note'} {fam}.{op}: operation set "
                    f"drift (+{sorted(added)} -{sorted(removed)})"
                )
                lines.append(note)
                failed = failed or strict
            if "syncs" in c:
                bad = _sync_growth(c, m)
                lines += [f"FAIL {fam}.{op}: {b} — a synchronizing call the "
                          "committed cuda section lacks (repair it, or list a "
                          "deliberate read in KNOWN_SYNC_SITES and run --update)"
                          for b in bad]
                failed = failed or bool(bad)
                if not bad and c["sync_sites"] != m.get("sync_sites", {}):
                    lines.append(f"note {fam}.{op}: fewer syncs ({m.get('syncs', 0)} -> "
                                 f"{c['syncs']}; run --update to pin them)")
    return lines, not failed


def _sync_growth(c: dict, m: dict) -> list[str]:
    """How the syncs of a card entry ``c`` exceed its committed entry ``m``."""
    out = []
    if c["syncs"] > m.get("syncs", 0):
        out.append(f"syncs {m.get('syncs', 0)} -> {c['syncs']}")
    committed = m.get("sync_sites", {})
    for site, n in sorted(c["sync_sites"].items()):
        if site not in committed:
            out.append(f"new sync site {site} ({n})")
        elif n > committed[site]:
            out.append(f"sync site {site} {committed[site]} -> {n}")
    return out


def load_manifest(path: str = MANIFEST_PATH, device: str = "cpu") -> Optional[dict]:
    """The manifest's section for ``device`` ({"families": ...}), or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get(device)


def write_manifest(current: dict, path: str = MANIFEST_PATH, device: str = "cpu") -> None:
    """Write ``current`` as the manifest's ``device`` section, keeping the other."""
    payload = {}
    if os.path.exists(path):
        with open(path) as f:
            payload = json.load(f)
    payload["comment"] = (
        "Committed op-audit manifest of the port (see repro_torch.analysis."
        "trace_audit): a section for each device the families ran on. Refresh "
        "one with `python -m repro_torch.analysis trace --update [--device "
        "cuda]` after a reviewed change."
    )
    payload[device] = {"families": current["families"]}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")


def render_summary(current: dict) -> str:
    lines = []
    for fam, ops in sorted(current["families"].items()):
        for op, entry in sorted(ops.items()):
            extra = f" ops={entry['ops']}" if "ops" in entry else ""
            if entry.get("syncs"):
                extra += f" syncs={entry['syncs']} {json.dumps(entry['sync_sites'])}"
            lines.append(f"  {fam + '.' + op:40s} {entry['status']}{extra}")
    return "\n".join(lines)


def run_audit(
    update: bool = False,
    strict: bool = False,
    manifest_path: str = MANIFEST_PATH,
    verbose: bool = False,
    device: str = "cpu",
) -> int:
    if device == "cuda":  # one-time work on the card (lazy init, loads) is no op's
        collect(device=device)
    current = collect(device=device)
    problems = errors(current)
    if verbose:
        print(render_summary(current))
    for p in problems:
        print(f"FAIL {p}")
    if update:
        if problems:
            print("trace-audit: refusing to --update a failing audit")
            return 1
        write_manifest(current, manifest_path, device)
        n_dev = sum(
            1
            for ops in current["families"].values()
            for e in ops.values()
            if e["status"] == "device"
        )
        print(f"trace-audit: {device} manifest refreshed ({n_dev} device ops) -> "
              f"{manifest_path}")
        return 0
    manifest = load_manifest(manifest_path, device)
    if manifest is None:
        print(f"trace-audit: no {device} section in {manifest_path} (run --update)")
        return 1
    lines, ok = diff(current, manifest, strict=strict)
    for line in lines:
        print(line)
    n_ops = sum(len(ops) for ops in current["families"].values())
    verdict = "passed" if ok and not problems else "FAILED"
    print(
        f"trace-audit {verdict} ({device}): {len(current['families'])} families, "
        f"{n_ops} ops audited"
    )
    return 0 if ok and not problems else 1
