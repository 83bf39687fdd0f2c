"""The port's static analysis (``repro_torch.analysis``), on the CPU.

* **Rule fixtures**: snippets that trip each host-sync rule, beside
  near-misses that must not (the reference's ``TestRuleFixtures``, on
  the torch rules), and the torch behaviour that keeps RL106.
* **Committed artifacts**: the baseline's load/apply (``TestBaseline``),
  ``toml_lite`` against the JAX package's on the same texts, the op
  audit's manifest round trip and diff (``TestTraceAudit``), one live
  audit of ``qf`` against the committed ``cpu`` section, and the
  section's status differences from the JAX package's manifest; the
  ``cuda`` section's syncs per op and per site (``TestSyncSites``: a
  new site or a grown count fails, every committed site is a deliberate
  read of ``KNOWN_SYNC_SITES``, the cascade's counts equal its calls).
* **Repaired host-to-card copies** (``TestFilledScalars``): each value
  that was a copy from the host, now filled in on the device, has the
  old construction's dtype and value.
* **Kernel contracts**: ``spec_check`` passes over the real ``csrc/``
  and rejects a wrong arity, a wrong integer width, a missing
  ``launches`` counter and a missing test.
* **CLI**: ``python -m repro_torch.analysis`` exits 0 against the
  committed baseline and manifest.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import types
import warnings

import pytest
import torch

from repro.analysis import toml_lite as jtoml
from repro_torch.analysis import spec_check, toml_lite, trace_audit
from repro_torch.analysis.lint import (
    BaselineEntry,
    analyze_sources,
    apply_baseline,
    load_baseline,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def rules_hit(code: str, path: str = "src/repro_torch/fix.py") -> dict[str, int]:
    out: dict[str, int] = {}
    for f in analyze_sources({path: code}):
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


TORCH = "import torch\nimport numpy as np\n"
# a device root: an op bound in a FilterImpl registration
ROOTED = "\nIMPL = FilterImpl(insert=f)\n"


class TestRuleFixtures:
    def test_rl101_item_trips(self):
        code = TORCH + "def f(x):\n    return x.item() + len(x.tolist())\n"
        assert rules_hit(code).get("RL101") == 2

    def test_rl101_near_misses(self):
        code = TORCH + (
            "def f(d, x):\n"
            "    a = d.items()\n"  # dict iteration, not a sync
            "    return x.item(0)\n"  # indexed .item is not the bare sync form
        )
        assert "RL101" not in rules_hit(code)

    def test_rl102_scalar_cast_trips(self):
        code = TORCH + "def f(x):\n    return int(x) + float(x) + bool(x)\n"
        assert rules_hit(code).get("RL102") == 3

    def test_rl102_near_misses(self):
        code = TORCH + (
            "LIMIT = 128\n"
            "def f(x, cfg):\n"
            "    a = int(x.shape[0])\n"  # static shape
            "    b = int(cfg.q)\n"  # config attribute (static root)
            "    c = int(LIMIT * 2)\n"  # module literal constant
            "    d = int('ff', 16)\n"  # two-arg form, host string parse
            "    e = int(x.numel()) + int(x.dim())\n"  # host methods
            "    return a + b + c + d + e\n"
        )
        assert "RL102" not in rules_hit(code)

    def test_rl103_host_round_trip_trips(self):
        code = TORCH + (
            "def f(x):\n"
            "    a = x.cpu()\n"
            "    b = x.numpy()\n"
            "    c = x.to('cpu')\n"
            "    d = x.to(device=torch.device('cpu'))\n"
            "    return np.asarray(x), a, b, c, d\n"
        )
        assert rules_hit(code).get("RL103") == 5

    def test_rl103_near_misses(self):
        code = TORCH + (
            "def f(x, device):\n"
            "    a = x.to('cuda')\n"
            "    b = x.to(torch.float32)\n"
            "    c = torch.as_tensor([1, 2], device=device)\n"
            "    return np.asarray(x.shape), a, b, c\n"  # a host tuple
        )
        assert "RL103" not in rules_hit(code)

    def test_rl104_python_branch_in_a_device_root_trips(self):
        code = TORCH + (
            "def f(cfg, state, keys):\n"
            "    if torch.any(keys > 0):\n"
            "        return state\n"
            "    while (keys < 0).all():\n"
            "        keys = keys + 1\n"
            "    if state.n:\n"
            "        return state\n"
            "    return state\n"
        ) + ROOTED
        assert rules_hit(code).get("RL104") == 3

    def test_rl104_near_misses(self):
        host = TORCH + (
            "def f(cfg, state, keys):\n"
            "    if torch.any(keys > 0):\n"  # not device-reachable: no finding
            "        return state\n"
            "    return state\n"
        )
        assert "RL104" not in rules_hit(host)
        static = TORCH + (
            "def f(cfg, state, keys):\n"
            "    if torch.is_tensor(keys) and state.n.dtype == torch.int32:\n"
            "        return state\n"
            "    if keys.shape[0] == 0 or torch.cuda.is_available():\n"
            "        return state\n"
            "    return state\n"
        ) + ROOTED
        assert "RL104" not in rules_hit(static)

    def test_rl106_bare_sentinel_compare_trips(self):
        code = TORCH + "def f(x):\n    return (x == 2**31) | (x < 4294967295)\n"
        assert rules_hit(code).get("RL106") == 2

    def test_rl106_in_range_or_typed_bound_is_fine(self):
        code = TORCH + (
            "def f(x):\n"
            "    big = torch.tensor(2**31, dtype=torch.int64)\n"
            "    return (x.to(torch.int64) == big) | (x == 5) | (x < 2**30)\n"
        )
        assert "RL106" not in rules_hit(code)

    def test_rl106_torch_wraps_a_python_int_past_int32(self):
        """Why RL106 carries over (``rules.py``'s docstring): torch converts
        the Python int to the int32 tensor's dtype without a check."""
        t = torch.tensor([-2**31, 2**31 - 1, -1, 0], dtype=torch.int32)
        assert (t == 2**31).tolist() == [True, False, False, False]
        assert not (t < 2**31).any()
        assert (t == 2**32 - 1).tolist() == [False, False, True, False]

    def test_the_jax_rules_do_not_carry_over(self):
        from repro_torch.analysis.rules import RULES

        assert [r.id for r in RULES] == ["RL101", "RL102", "RL103", "RL104", "RL106"]

    def test_reachability_escalates_severity(self):
        # the same construct is a warning in host code, an error when a
        # device root can reach it through the call graph
        host = TORCH + "def helper(x):\n    return int(x)\n"
        sevs = [f.severity for f in analyze_sources({"src/repro_torch/fix.py": host})]
        assert sevs == ["warning"]
        rooted = host + "def f(cfg, state, keys):\n    return helper(keys)\n" + ROOTED
        sevs = [f.severity for f in analyze_sources({"src/repro_torch/fix.py": rooted})]
        assert sevs == ["error"]

    def test_model_steps_are_roots(self):
        code = TORCH + "def decode_step(params, cfg, cache, tokens):\n    return tokens.item()\n"
        (f,) = analyze_sources({"src/repro_torch/models/model.py": code})
        assert (f.rule, f.severity) == ("RL101", "error")
        (f,) = analyze_sources({"src/repro_torch/models/other.py": code})
        assert f.severity == "warning"

    def test_a_nested_def_counts_once(self):
        code = TORCH + "def outer(x):\n    def inner(y):\n        return y.item()\n    return inner\n"
        assert [f.func for f in analyze_sources({"src/repro_torch/fix.py": code})] == [
            "outer.inner"]


class TestBaseline:
    CODE = TORCH + "def f(x):\n    return int(x)\n"

    def test_covered_finding_passes(self):
        findings = analyze_sources({"src/repro_torch/fix.py": self.CODE})
        res = apply_baseline(
            findings,
            [BaselineEntry("RL102", "src/repro_torch/fix.py", "known host code", count=1)],
        )
        assert res.ok and res.covered == 1

    def test_count_overflow_fails(self):
        code = TORCH + "def f(x):\n    return int(x) + int(x)\n"
        findings = analyze_sources({"src/repro_torch/fix.py": code})
        res = apply_baseline(
            findings,
            [BaselineEntry("RL102", "src/repro_torch/fix.py", "one known site", count=1)],
        )
        assert not res.ok and res.problems

    def test_stale_entry_noted_but_passes(self):
        res = apply_baseline(
            [], [BaselineEntry("RL102", "src/repro_torch/gone.py", "was removed")]
        )
        assert res.ok and len(res.stale) == 1

    def test_uncovered_finding_fails(self):
        findings = analyze_sources({"src/repro_torch/fix.py": self.CODE})
        assert not apply_baseline(findings, []).ok

    def test_load_rejects_missing_reason(self, tmp_path):
        p = tmp_path / "baseline.toml"
        p.write_text('[[allow]]\nrule = "RL102"\npath = "a.py"\n')
        with pytest.raises(ValueError):
            load_baseline(str(p))

    def test_load_roundtrip(self, tmp_path):
        p = tmp_path / "baseline.toml"
        p.write_text(
            "[[allow]]\n"
            'rule = "RL103"\n'
            'path = "src/repro_torch/a.py"\n'
            'func = "F.g"\n'
            "count = 2\n"
            'reason = "because"\n'
        )
        (e,) = load_baseline(str(p))
        assert (e.rule, e.path, e.func, e.count) == (
            "RL103", "src/repro_torch/a.py", "F.g", 2,
        )

    def test_committed_baseline_has_a_reason_for_every_entry(self):
        entries = load_baseline(os.path.join(SRC, "repro_torch", "analysis", "baseline.toml"))
        assert entries and all(e.reason.strip() and e.count for e in entries)


TOML_TEXTS = [
    "[tool.demo]\n"
    'name = "x"  # comment\n'
    "n = 3\n"
    "ratio = 1.5\n"
    "on = true\n"
    'paths = [\n  "a",\n  "b",\n]\n'
    "[[tool.demo.allow]]\n"
    'rule = "R1"\n'
    "[[tool.demo.allow]]\n"
    'rule = "R2"\n',
    '[a."b.c"]\nx = -4\ny = [1, 2.5, "s"]\n[[list]]\nk = false\n',
]


class TestTomlLite:
    @pytest.mark.parametrize("text", TOML_TEXTS)
    def test_same_results_as_the_jax_package(self, text):
        assert toml_lite.loads(text) == jtoml.loads(text)

    def test_the_committed_files_parse_alike(self):
        for path in ("pyproject.toml", "src/repro_torch/analysis/baseline.toml",
                     "src/repro/analysis/baseline.toml"):
            with open(os.path.join(ROOT, path)) as f:
                text = f.read()
            assert toml_lite.loads(text) == jtoml.loads(text), path

    @pytest.mark.parametrize("text", ["this is not toml\n", "[a\n", "x = [1, 2\n"])
    def test_malformed_raises_in_both(self, text):
        with pytest.raises(ValueError):
            toml_lite.loads(text)
        with pytest.raises(ValueError):
            jtoml.loads(text)


def _fam(status="device", ops=100, aten=None):
    e = {"status": status}
    if status in ("device", "host"):
        e["ops"] = ops
        e["aten"] = aten or {"add": 3, "mul": 1}
    return e


class TestTraceAudit:
    def test_manifest_roundtrip_keeps_the_other_section(self, tmp_path):
        path = str(tmp_path / "m.json")
        cpu = {"families": {"qf": {"contains": _fam()}}}
        cuda = {"families": {"qf": {"contains": _fam(ops=7)}}}
        trace_audit.write_manifest(cpu, path, "cpu")
        trace_audit.write_manifest(cuda, path, "cuda")
        assert trace_audit.load_manifest(path, "cpu") == cpu
        assert trace_audit.load_manifest(path, "cuda") == cuda
        lines, ok = trace_audit.diff(cpu, trace_audit.load_manifest(path, "cpu"))
        assert ok and not any(line.startswith("FAIL") for line in lines)

    def test_status_change_fails(self):
        cur = {"families": {"qf": {"contains": _fam(status="host")}}}
        man = {"families": {"qf": {"contains": _fam()}}}
        lines, ok = trace_audit.diff(cur, man)
        assert not ok and any("status" in line for line in lines)

    def test_op_count_blowup_fails(self):
        cur = {"families": {"qf": {"contains": _fam(ops=500)}}}
        man = {"families": {"qf": {"contains": _fam(ops=100)}}}
        lines, ok = trace_audit.diff(cur, man)
        assert not ok and any("blow-up" in line for line in lines)

    def test_new_op_fails_until_update(self):
        cur = {"families": {"qf": {"contains": _fam(), "probe": _fam()}}}
        man = {"families": {"qf": {"contains": _fam()}}}
        _, ok = trace_audit.diff(cur, man)
        assert not ok

    def test_operation_drift_notes_unless_strict(self):
        cur = {"families": {"qf": {"contains": _fam(aten={"add": 3, "sub": 1})}}}
        man = {"families": {"qf": {"contains": _fam()}}}
        lines, ok = trace_audit.diff(cur, man, strict=False)
        assert ok and any(line.startswith("note") for line in lines)
        _, ok = trace_audit.diff(cur, man, strict=True)
        assert not ok

    def test_a_host_read_is_seen(self):
        x = torch.arange(8)
        with trace_audit.OpAudit() as a:
            y = (x * 2).sum()
        assert (a.host_reads, a.aten) == (0, {"mul": 1, "sum": 1})
        with trace_audit.OpAudit() as a:
            bool(y > 3)
            int(x[0])
        assert a.host_reads == 2 and a.aten["_local_scalar_dense"] == 2

    def test_live_audit_matches_committed_manifest_for_qf(self):
        cur = trace_audit.collect(families=["qf"])
        man = trace_audit.load_manifest(device="cpu")
        assert man is not None, "committed trace_manifest.json has no cpu section"
        sub = {"families": {k: v for k, v in man["families"].items() if k in cur["families"]}}
        lines, ok = trace_audit.diff(cur, sub)
        assert ok, "\n".join(lines)
        assert cur["families"]["qf[pallas]"]["contains"]["status"] == "device"

    def test_status_differences_from_the_jax_manifest_are_listed(self):
        with open(os.path.join(SRC, "repro", "analysis", "trace_manifest.json")) as f:
            jax_fams = json.load(f)["families"]
        ours = trace_audit.load_manifest(device="cpu")["families"]
        assert set(ours) == set(jax_fams)
        differ = set()
        for fam, ops in ours.items():
            assert set(ops) == set(jax_fams[fam]), fam
            for op, e in ops.items():
                theirs = {"traced": "device"}.get(jax_fams[fam][op]["status"],
                                                 jax_fams[fam][op]["status"])
                if e["status"] != theirs:
                    differ.add((fam, op))
        assert differ == set(trace_audit.JAX_STATUS_DIFFERENCES)

    def test_the_cuda_section_is_committed(self):
        cuda = trace_audit.load_manifest(device="cuda")
        assert cuda is not None and set(cuda["families"]) == set(trace_audit.family_specs())


def _synced(syncs: dict, status="host"):
    e = _fam(status=status)
    e.update(syncs=sum(syncs.values()), sync_sites=dict(syncs))
    return e


_COLLAPSE_SITE = "filters/cascade.py::_collapse_target"
_MERGE_SITE = "filters/cascade.py::merge"


class TestSyncSites:
    def _diff(self, cur: dict, man: dict):
        return trace_audit.diff({"families": {"cascade": {"insert": cur}}},
                                {"families": {"cascade": {"insert": man}}})

    def test_a_new_site_fails(self):
        lines, ok = self._diff(_synced({_COLLAPSE_SITE: 1, "filters/iostats.py::f32": 1}),
                               _synced({_COLLAPSE_SITE: 1, "core/quotient_filter.py::x": 1}))
        assert not ok and any("new sync site filters/iostats.py::f32" in x for x in lines)

    def test_a_grown_site_count_fails(self):
        lines, ok = self._diff(_synced({_COLLAPSE_SITE: 2}), _synced({_COLLAPSE_SITE: 1}))
        assert not ok and any("syncs 1 -> 2" in x for x in lines)
        assert any(f"sync site {_COLLAPSE_SITE} 1 -> 2" in x for x in lines)

    def test_more_syncs_fail(self):
        cur = _synced({_COLLAPSE_SITE: 1})
        cur["syncs"] = 2
        lines, ok = self._diff(cur, _synced({_COLLAPSE_SITE: 1}))
        assert not ok and any("syncs 1 -> 2" in x for x in lines)

    def test_fewer_syncs_note(self):
        lines, ok = self._diff(_synced({_COLLAPSE_SITE: 1}),
                               _synced({_COLLAPSE_SITE: 1, "filters/iostats.py::f32": 4}))
        assert ok and any(x.startswith("note") and "fewer syncs" in x for x in lines)

    def test_a_sync_in_a_device_op_fails(self):
        lines, ok = self._diff(_synced({_COLLAPSE_SITE: 1}), _synced({}, status="device"))
        assert not ok and any("status device -> host" in x for x in lines)

    def test_the_committed_cuda_section_passes(self):
        cuda = trace_audit.load_manifest(device="cuda")
        lines, ok = trace_audit.diff(cuda, cuda, strict=True)
        assert ok and not lines

    def test_every_committed_site_is_a_known_read(self):
        cuda = trace_audit.load_manifest(device="cuda")["families"]
        for fam, ops in cuda.items():
            for op, e in ops.items():
                if e["status"] not in ("device", "host"):
                    continue
                assert e["syncs"] == sum(e["sync_sites"].values()), (fam, op)
                assert (e["status"] == "host") == (e["syncs"] > 0 or "_local_scalar_dense"
                                                   in e["aten"]), (fam, op)
                unknown = set(e["sync_sites"]) - set(trace_audit.KNOWN_SYNC_SITES)
                assert not unknown, (fam, op, unknown)
        assert all(trace_audit.KNOWN_SYNC_SITES.values())

    def test_the_repaired_copies_are_gone_from_the_cuda_section(self):
        cuda = trace_audit.load_manifest(device="cuda")["families"]
        for fam in ("bloom", "blocked_bloom"):
            for op in ("insert", "delete"):
                assert cuda[fam][op]["status"] == "device", (fam, op)
        gone = ("core/quotient_filter.py::build_sorted", "filters/bloom_filter.py::_count",
                "filters/iostats.py::f32")
        for fam, ops in cuda.items():
            for op, e in ops.items():
                assert not set(e.get("sync_sites", {})) & set(gone), (fam, op)

    def test_cascade_sites_count_one_sync_a_call(self, monkeypatch):
        """The committed counts at the cascade's two deliberate reads equal
        how many times each op calls that function, counted on the CPU:
        the ``int(...)`` alone, no copy beside it."""
        from repro_torch.filters import cascade

        codes = {cascade._collapse_target.__code__: _COLLAPSE_SITE,
                 cascade.merge.__code__: _MERGE_SITE}
        real = trace_audit._audit_op

        def counted(device, thunk):
            calls = dict.fromkeys(codes.values(), 0)

            def hook(frame, event, arg):
                if event == "call" and frame.f_code in codes:
                    calls[codes[frame.f_code]] += 1

            sys.setprofile(hook)
            try:
                entry, out = real(device, thunk)
            finally:
                sys.setprofile(None)
            return dict(entry, calls=calls), out

        monkeypatch.setattr(trace_audit, "_audit_op", counted)
        cuda = trace_audit.load_manifest(device="cuda")["families"]
        specs = trace_audit.family_specs()
        for fam in ("cascade", "cascade[pallas]", "cascade[frozen]"):
            for op, e in trace_audit.trace_family(fam, specs[fam]).items():
                if "calls" not in e:
                    continue
                for site, n in e["calls"].items():
                    assert cuda[fam][op].get("sync_sites", {}).get(site, 0) == n, (fam, op, site)
                if op in ("insert", "merge"):
                    assert sum(e["calls"].values()) == 1, (fam, op)

    def test_a_site_is_the_ports_calling_function(self, monkeypatch):
        """A warning raised below the port (here in ``torch.full``) names the
        port's function that made the call, as ``path::function``."""
        from repro_torch.filters import iostats

        full = torch.full

        def warning_full(*args, **kwargs):
            warnings.warn("called a synchronizing CUDA operation")
            return full(*args, **kwargs)

        monkeypatch.setattr(torch, "full", warning_full)
        with trace_audit.recorded_syncs() as sites:
            iostats.f32(3, "cpu")
            iostats.f32(4, "cpu")
            warnings.warn("an unrelated warning")
        assert sites == {"filters/iostats.py::f32": 2}

    def test_the_cpu_section_lifts_no_host_data_outside_the_plain_kernels(self):
        """``lift_fresh`` on the CPU is a tensor made from host data, which
        on the card is a synchronizing copy; only the kernels' plain
        versions (CPU only) make one."""
        cpu = trace_audit.load_manifest(device="cpu")["families"]
        for fam, ops in cpu.items():
            if "[pallas]" in fam:
                continue
            for op, e in ops.items():
                assert "lift_fresh" not in e.get("aten", {}), (fam, op)


class TestFilledScalars:
    """The repaired constructions against the copies they replaced."""

    @pytest.mark.parametrize("x", [0, 1, 4096, 2**20 + 1, (1 << 30) - 1])
    def test_i32(self, x):
        from repro_torch.core import quotient_filter as qf

        got, want = qf._i32(x, "cpu"), torch.as_tensor(x, dtype=torch.int32)
        assert got.dtype == want.dtype and got.shape == () and torch.equal(got, want)
        t = torch.tensor(x, dtype=torch.int32)
        assert qf._i32(t, "cpu") is t  # a tensor on the device passes untouched

    @pytest.mark.parametrize("x", [0, 1536, 98_304.0, 2**24 + 1, 3 * 2**33 + 7, 123456789])
    def test_f32(self, x):
        from repro_torch.filters import iostats

        got = iostats.f32(x, "cpu")
        want = torch.tensor(float(x), dtype=torch.float32)
        assert got.dtype == torch.float32 and got.shape == () and torch.equal(got, want)

    @pytest.mark.parametrize("k", [None, 5, torch.tensor(7, dtype=torch.int32)])
    def test_bloom_count(self, k):
        from repro_torch.filters import bloom_filter

        keys = torch.arange(9, dtype=torch.int32)
        got = bloom_filter._count(keys, k)
        want = torch.as_tensor(9 if k is None else k, dtype=torch.int32)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        if torch.is_tensor(k):
            assert got is k

    @pytest.mark.parametrize("spec", [dict(ram_q=6, p=20, levels=2),
                                      dict(ram_q=12, p=28, fanout=4, levels=4),
                                      dict(ram_q=10, p=30, levels=3, max_load=0.9)])
    def test_level_caps(self, spec):
        from repro_torch.filters import cascade

        cfg = cascade.CascadeConfig(**spec)
        want = torch.tensor([cfg.level_cfg(i).capacity for i in range(cfg.levels)],
                            dtype=torch.int32)
        got = cascade._level_caps(cfg, "cpu")
        assert got.dtype == torch.int32 and torch.equal(got, want)

    def test_fuse_scalars(self):
        from repro_torch.core import fuse_filter

        for args in ((0, 0, 0, False), (96, 90, 0x7FFFFFFF, True)):
            got = fuse_filter._scalars("cpu", *args)
            want = (*(torch.tensor(v, dtype=torch.int32) for v in args[:3]),
                    torch.tensor(args[3]))
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == () and torch.equal(g, w)

    def test_build_sorted_occupancy(self):
        """``index_fill_`` of the occupied quotients equals the indexed
        assignment it replaced, duplicates and the dump slot included."""
        from repro_torch.core import quotient_filter as qf

        cfg = qf.QFConfig(q=6, r=8, slack=16)
        fq = torch.tensor([1, 1, 3, 40, 40, 63, qf.INT32_MAX, qf.INT32_MAX], dtype=torch.int64)
        fr = torch.arange(8, dtype=torch.int64)
        st = qf.build_sorted(cfg, fq, fr, 6)
        want = torch.zeros(cfg.total_slots + 1, dtype=torch.bool)
        valid = torch.arange(8) < 6
        want[torch.where(valid, fq, cfg.total_slots)] = True
        assert st.occ.dtype == torch.bool and torch.equal(st.occ, want[: cfg.total_slots])


def _proto(*params, name="k"):
    return spec_check.Prototype("src", name, params, "int")


def _bound(*argtypes, restype=ctypes.c_int):
    fn = spec_check._RecordingFn()
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


class TestSpecCheck:
    def test_real_csrc_passes(self, capsys):
        assert spec_check.run_spec_check() == 0
        assert "13 entries, 10 wrappers, 0 problems" in capsys.readouterr().out

    def test_prototypes_are_parsed(self):
        text = ('extern "C" int f(const void* a, long long n, int k, unsigned s,\n'
                '                  void* stream) {\n  return 0;\n}\n'
                'extern "C" int g(void) { return 4; }\n')
        f, g = spec_check.parse_prototypes(text, "x")
        assert f.params == ("pointer", "long long", "int", "unsigned", "pointer")
        assert (g.name, g.params) == ("g", ())

    def test_a_matching_binding_is_clean(self):
        p = _proto("pointer", "long long", "int", "unsigned")
        b = _bound(ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32)
        assert spec_check.check_binding(p, b) == []

    def test_wrong_arity_rejected(self):
        p = _proto("pointer", "long long", "pointer")
        problems = spec_check.check_binding(p, _bound(ctypes.c_void_p, ctypes.c_longlong))
        assert any("2 argtypes for 3 parameters" in m for m in problems)

    def test_wrong_integer_width_rejected(self):
        p = _proto("pointer", "long long")
        problems = spec_check.check_binding(p, _bound(ctypes.c_void_p, ctypes.c_int))
        assert any("parameter 1 is long long" in m for m in problems)

    def test_unbound_entry_and_wrong_restype_rejected(self):
        assert spec_check.check_binding(_proto("pointer"), None)
        p = _proto("pointer")
        assert spec_check.check_binding(p, _bound(ctypes.c_void_p, restype=None))

    def _module(self, launches=True, plain=True):
        def wrapper():
            pass

        if launches:
            wrapper.launches = 0
        mod = types.SimpleNamespace(wrapper=wrapper)
        if plain:
            mod.wrapper_plain = lambda: None
        return mod

    W = spec_check.Wrapper("m", "wrapper", "wrapper_plain")

    def test_a_complete_wrapper_is_clean(self):
        assert spec_check.check_wrapper(self.W, self._module(), {"wrapper"}, {"wrapper"}) == []

    def test_missing_launches_counter_rejected(self):
        problems = spec_check.check_wrapper(self.W, self._module(launches=False),
                                            {"wrapper"}, {"wrapper"})
        assert any("launches" in m for m in problems)

    def test_missing_test_or_smoke_entry_rejected(self):
        problems = spec_check.check_wrapper(self.W, self._module(), set(), {"wrapper"})
        assert any("test_torch_kernels" in m for m in problems)
        problems = spec_check.check_wrapper(self.W, self._module(plain=False), {"wrapper"}, set())
        assert any("plain version" in m for m in problems)
        assert any("chip_smoke" in m for m in problems)

    def test_recording_leaves_the_real_loader_in_place(self):
        from repro_torch.kernels import cuda_lib, qf_build

        real = cuda_lib.library
        libs = spec_check.record_bindings("qf_build", "_library")
        assert cuda_lib.library is real and qf_build._library.cache_info().currsize == 0
        assert set(libs["qf_build"].fns) == {"qf_build_planes", "qf_positions", "qf_build_span"}


class TestCli:
    @pytest.mark.parametrize("sub", ["lint", "spec", "trace"])
    def test_subcommand_exits_zero(self, sub):
        from repro_torch.analysis.__main__ import main

        assert main([sub]) == 0

    def test_module_invocation(self):
        env = dict(os.environ, PYTHONPATH=SRC)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "lint"],
            capture_output=True, text=True, cwd=ROOT, env=env,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout
