"""The port's static analysis (``repro_torch.analysis``), on the CPU.

* **Rule fixtures**: snippets that trip each host-sync rule, beside
  near-misses that must not (the reference's ``TestRuleFixtures``, on
  the torch rules), and the torch behaviour that keeps RL106.
* **Committed artifacts**: the baseline's load/apply (``TestBaseline``),
  ``toml_lite`` against the JAX package's on the same texts, the op
  audit's manifest round trip and diff (``TestTraceAudit``), one live
  audit of ``qf`` against the committed ``cpu`` section, and the
  section's status differences from the JAX package's manifest.
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


def _proto(*params, name="k"):
    return spec_check.Prototype("src", name, params, "int")


def _bound(*argtypes, restype=ctypes.c_int):
    fn = spec_check._RecordingFn()
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


class TestSpecCheck:
    def test_real_csrc_passes(self, capsys):
        assert spec_check.run_spec_check() == 0
        assert "12 entries, 9 wrappers, 0 problems" in capsys.readouterr().out

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
