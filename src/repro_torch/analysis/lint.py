"""Host-sync lint engine: AST scopes, call graph, reachability, baseline.

The port of ``repro.analysis.lint``.  The engine parses every configured
source file, splits it into function *scopes* (one per ``def``, nested
defs separate, plus a ``<module>`` pseudo-scope), builds a project-wide
call graph (direct calls, calls through import aliases, and bare-``Name``
references so higher-order passage like ``remat_call(fn, ...)`` is
followed), marks *device roots* (where the reference marks ``jax.jit``
roots) —

- functions bound to an op keyword of a ``FilterImpl(...)``
  registration (the façade's device surface, ``filters/registry.py``),
- the model's steps, ``model.prefill``, ``model.decode_step`` and
  ``model.loss_fn``, and ``train_step.make_train_step``'s step
  (``ROOTS``),

— and BFS-propagates reachability.  Rules from
:mod:`repro_torch.analysis.rules` then run per scope; findings inside
device-reachable scopes are errors, host-side ones warnings, and both
must be fixed or carried in ``baseline.toml`` with a reason.  The lint
carries its configuration here (``DEFAULT_PATHS``, ``DEFAULT_EXCLUDE``,
``DEFAULT_BASELINE``): the ``[tool.repro-lint]`` section of
``pyproject.toml`` configures the JAX package's lint.
"""

from __future__ import annotations

import ast
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

from . import toml_lite
from .rules import RULES, Finding, dotted_name

DEVICE_OPS = {
    "insert",
    "contains",
    "delete",
    "merge",
    "probe",
    "stats",
    "needs_resize",
    "needs_shrink",
}

# (module, in-file qualname) of the steps that run on the device
ROOTS = {
    ("repro_torch.models.model", "prefill"),
    ("repro_torch.models.model", "decode_step"),
    ("repro_torch.models.model", "loss_fn"),
    ("repro_torch.train.train_step", "make_train_step.train_step"),
}

DEFAULT_PATHS = ["src/repro_torch"]
DEFAULT_EXCLUDE = ["src/repro_torch/analysis"]
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.toml"


class Scope:
    def __init__(self, qualname: str, node: ast.AST, nodes: list[ast.AST]):
        self.qualname = qualname
        self.node = node
        self.nodes = nodes
        self.root = False
        self.reachable = False
        self.edges: set["Scope"] = set()
        self.param_names: set[str] = set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            self.param_names = {
                p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]
            }
            if a.vararg:
                self.param_names.add(a.vararg.arg)
            if a.kwarg:
                self.param_names.add(a.kwarg.arg)

    def __repr__(self):  # pragma: no cover - debugging aid
        flags = "R" if self.root else ("r" if self.reachable else "-")
        return f"<Scope {self.qualname} {flags}>"


class FileContext:
    def __init__(
        self, path: str, modname: str, tree: ast.Module, is_package: bool = False
    ):
        self.path = path
        self.modname = modname
        self.is_package = is_package
        self.tree = tree
        self.np_aliases: set[str] = set()
        self.torch_aliases: set[str] = set()
        self.import_mods: dict[str, str] = {}  # local alias -> module path
        self.from_names: dict[str, tuple[str, str]] = {}  # name -> (mod, orig)
        self.static_roots: set[str] = set()
        self.state_roots: set[str] = {"state"}
        self.scopes: list[Scope] = []
        self._collect_imports()
        self._collect_scopes()

    # -- imports ----------------------------------------------------------
    def _resolve_relative(self, module: Optional[str], level: int) -> str:
        if not level:
            return module or ""
        parts = self.modname.split(".")
        if self.is_package:
            # from a package's __init__, level=1 is the package itself
            parts = parts + ["<pkg>"]
        base = parts[: len(parts) - level]
        return ".".join(base + (module.split(".") if module else []))

    def _note_module(self, alias: str, mod: str) -> None:
        self.import_mods[alias] = mod
        if mod == "numpy":
            self.np_aliases.add(alias)
        elif mod == "torch":
            self.torch_aliases.add(alias)

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    # `import torch.nn as nn` binds nn to the submodule;
                    # plain `import torch.nn` binds the root package
                    self._note_module(
                        alias, a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                mod = self._resolve_relative(node.module, node.level)
                for a in node.names:
                    alias = a.asname or a.name
                    submod = f"{mod}.{a.name}" if mod else a.name
                    # `from pkg import name`: name may be a module or a
                    # function — record both interpretations
                    self._note_module(alias, submod)
                    self.from_names[alias] = (mod, a.name)

    # -- scopes -----------------------------------------------------------
    @staticmethod
    def _own_nodes(body: Iterable[ast.AST]) -> list[ast.AST]:
        """All nodes under `body`, not descending into nested defs (a def
        in `body` itself is its own scope too: the reference's engine
        walks it, so its findings count in the enclosing scope twice)."""
        out: list[ast.AST] = []
        stack = [n for n in body if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        while stack:
            n = stack.pop()
            out.append(n)
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                stack.append(c)
        return out

    def _collect_scopes(self) -> None:
        module_body: list[ast.AST] = []

        def walk(nodes, prefix):
            for n in nodes:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{n.name}"
                    self.scopes.append(
                        Scope(qual, n, self._own_nodes(n.body))
                    )
                    walk(n.body, f"{qual}.")
                elif isinstance(n, ast.ClassDef):
                    walk(n.body, f"{prefix}{n.name}.")
                    module_body.extend(
                        c
                        for c in n.body
                        if not isinstance(
                            c, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                        )
                    )
                else:
                    if not prefix:
                        module_body.append(n)

        walk(self.tree.body, "")
        self.scopes.append(
            Scope("<module>", self.tree, self._own_nodes(module_body))
        )
        # module-level literal constants (SHRINK_LOAD = 0.4) are static
        for n in self.tree.body:
            if isinstance(n, ast.Assign) and _is_literal_node(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        self.static_roots.add(t.id)


class Project:
    """Cross-module call graph over a set of parsed files."""

    def __init__(self, sources: dict[str, str], src_prefix: str = "src", roots=ROOTS):
        self.files: dict[str, FileContext] = {}
        errors = []
        for path, text in sorted(sources.items()):
            modname = _modname_for(path, src_prefix)
            try:
                tree = ast.parse(text, filename=path)
            except SyntaxError as e:  # pragma: no cover - repo parses
                errors.append(f"{path}: syntax error: {e}")
                continue
            self.files[path] = FileContext(
                path, modname, tree, is_package=path.endswith("__init__.py")
            )
        self.parse_errors = errors
        # (modname, func trailing name) -> scopes
        self.func_index: dict[tuple[str, str], list[tuple[FileContext, Scope]]] = {}
        for ctx in self.files.values():
            for sc in ctx.scopes:
                tail = sc.qualname.rsplit(".", 1)[-1]
                if tail == "<module>":
                    continue
                self.func_index.setdefault((ctx.modname, tail), []).append((ctx, sc))
        self._build_edges_and_roots(roots)
        self._propagate()

    # -- resolution -------------------------------------------------------
    def _targets(
        self,
        ctx: FileContext,
        name_node: ast.AST,
        shadowed: Optional[set] = None,
    ) -> list[Scope]:
        """Scopes a call/reference expression may land on."""
        fn = dotted_name(name_node)
        if fn is None:
            return []
        parts = fn.split(".")
        if len(parts) == 1:
            name = parts[0]
            if shadowed and name in shadowed:
                return []
            if name in ctx.from_names:
                mod, orig = ctx.from_names[name]
                hits = self.func_index.get((mod, orig), [])
                if hits:
                    return [sc for _, sc in hits]
            return [sc for _, sc in self.func_index.get((ctx.modname, name), [])]
        alias, name = parts[0], parts[-1]
        mod = ctx.import_mods.get(alias)
        if mod is None:
            return []
        return [sc for _, sc in self.func_index.get((mod, name), [])]

    def _build_edges_and_roots(self, roots) -> None:
        for ctx in self.files.values():
            local = {
                sc.qualname.rsplit(".", 1)[-1]: sc
                for sc in ctx.scopes
                if sc.qualname != "<module>"
            }
            for sc in ctx.scopes:
                call_funcs = set()
                for n in sc.nodes:
                    if isinstance(n, ast.Call):
                        call_funcs.add(id(n.func))
                for n in sc.nodes:
                    if isinstance(n, ast.Call):
                        for t in self._targets(ctx, n.func, sc.param_names):
                            sc.edges.add(t)
                        self._mark_call_roots(ctx, n)
                    elif (
                        isinstance(n, ast.Name)
                        and isinstance(getattr(n, "ctx", None), ast.Load)
                        and id(n) not in call_funcs
                        and n.id not in sc.param_names
                        and n.id in local
                    ):
                        # bare reference: follow (higher-order passage)
                        sc.edges.add(local[n.id])
                if (ctx.modname, sc.qualname) in roots:
                    sc.root = True

    def _mark_call_roots(self, ctx: FileContext, call: ast.Call) -> None:
        fn = dotted_name(call.func)
        if fn is None:
            return
        tail = fn.rpartition(".")[2]
        if tail == "FilterImpl":
            for kw in call.keywords:
                if kw.arg in DEVICE_OPS and kw.value is not None:
                    for sc in self._targets(ctx, kw.value):
                        sc.root = True

    def _propagate(self) -> None:
        q = deque(
            sc for ctx in self.files.values() for sc in ctx.scopes if sc.root
        )
        for sc in q:
            sc.reachable = True
        while q:
            sc = q.popleft()
            for t in sc.edges:
                if not t.reachable:
                    t.reachable = True
                    q.append(t)

    # -- rules ------------------------------------------------------------
    def run_rules(self) -> list[Finding]:
        findings: list[Finding] = []
        for path in sorted(self.files):
            ctx = self.files[path]
            for sc in ctx.scopes:
                for rule in RULES:
                    if rule.device_only and not sc.reachable:
                        continue
                    sev = "error" if sc.reachable else "warning"
                    for line, msg in rule.visit(sc, ctx):
                        findings.append(
                            Finding(
                                rule=rule.id,
                                path=path,
                                line=line,
                                func=sc.qualname,
                                message=msg,
                                severity=sev,
                                hint=rule.hint,
                            )
                        )
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings


def _is_literal_node(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool))
    if isinstance(node, ast.BinOp):
        return _is_literal_node(node.left) and _is_literal_node(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_literal_node(node.operand)
    return False


def _modname_for(path: str, src_prefix: str) -> str:
    p = path.replace(os.sep, "/")
    if p.startswith(src_prefix.rstrip("/") + "/"):
        p = p[len(src_prefix.rstrip("/")) + 1 :]
    if p.endswith("/__init__.py"):
        p = p[: -len("/__init__.py")]
    elif p.endswith(".py"):
        p = p[:-3]
    return p.replace("/", ".")


# --------------------------------------------------------------------------
# baseline


@dataclass
class BaselineEntry:
    rule: str
    path: str
    reason: str
    func: Optional[str] = None
    count: Optional[int] = None

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        if self.func is not None:
            return f.func == self.func or f.func.startswith(self.func + ".")
        return True


def load_baseline(path: str) -> list[BaselineEntry]:
    if not os.path.exists(path):
        return []
    data = toml_lite.load_path(path)
    entries = []
    for i, raw in enumerate(data.get("allow", [])):
        try:
            e = BaselineEntry(
                rule=raw["rule"],
                path=raw["path"],
                reason=raw["reason"],
                func=raw.get("func"),
                count=raw.get("count"),
            )
        except KeyError as k:
            raise ValueError(
                f"{path}: allow entry #{i + 1} missing required key {k}"
            ) from None
        if not str(e.reason).strip():
            raise ValueError(
                f"{path}: allow entry #{i + 1} ({e.rule} {e.path}) has an "
                "empty reason — every baselined finding needs one"
            )
        entries.append(e)
    return entries


@dataclass
class LintResult:
    findings: list[Finding]  # unbaselined — these fail the run
    covered: int = 0
    stale: list[BaselineEntry] = field(default_factory=list)
    problems: list[str] = field(default_factory=list)
    n_files: int = 0
    n_scopes: int = 0
    n_reachable: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings and not self.problems


def apply_baseline(
    findings: list[Finding], entries: list[BaselineEntry]
) -> LintResult:
    pool = list(findings)
    covered = 0
    stale: list[BaselineEntry] = []
    problems: list[str] = []
    for e in entries:
        matched = [f for f in pool if e.matches(f)]
        if not matched:
            stale.append(e)
            continue
        if e.count is not None and len(matched) > e.count:
            problems.append(
                f"baseline entry {e.rule} {e.path}"
                + (f":{e.func}" if e.func else "")
                + f" allows {e.count} finding(s) but {len(matched)} matched — "
                "new violations appeared"
            )
        covered += len(matched)
        pool = [f for f in pool if not e.matches(f)]
    return LintResult(findings=pool, covered=covered, stale=stale, problems=problems)


# --------------------------------------------------------------------------
# config + entry points


@dataclass
class LintConfig:
    paths: list[str] = field(default_factory=lambda: list(DEFAULT_PATHS))
    exclude: list[str] = field(default_factory=lambda: list(DEFAULT_EXCLUDE))
    baseline: str = DEFAULT_BASELINE
    src_prefix: str = "src"


def collect_sources(root: str, cfg: LintConfig) -> dict[str, str]:
    sources: dict[str, str] = {}
    excludes = [e.rstrip("/") for e in cfg.exclude]
    for base in cfg.paths:
        for dirpath, dirnames, filenames in os.walk(os.path.join(root, base)):
            rel_dir = os.path.relpath(dirpath, root).replace(os.sep, "/")
            if any(rel_dir == e or rel_dir.startswith(e + "/") for e in excludes):
                dirnames[:] = []
                continue
            for fn in filenames:
                if not fn.endswith(".py"):
                    continue
                rel = f"{rel_dir}/{fn}"
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    sources[rel] = f.read()
    return sources


def analyze_sources(sources: dict[str, str], src_prefix: str = "src",
                    roots=ROOTS) -> list[Finding]:
    """Rule findings for in-memory sources (the test/fixture entry point)."""
    return Project(sources, src_prefix=src_prefix, roots=roots).run_rules()


def run_lint(root: str = ".", config: Optional[LintConfig] = None) -> LintResult:
    """The lint over ``root`` with the port's own configuration (the
    ``[tool.repro-lint]`` section of ``pyproject.toml`` is the JAX
    package's)."""
    cfg = config or LintConfig()
    sources = collect_sources(root, cfg)
    project = Project(sources, src_prefix=cfg.src_prefix)
    findings = project.run_rules()
    entries, missing = [], []
    if cfg.baseline:
        bpath = os.path.join(root, cfg.baseline)
        if os.path.exists(bpath):
            entries = load_baseline(bpath)
        else:
            missing = [f"baseline file {cfg.baseline} not found"]
    result = apply_baseline(findings, entries)
    result.problems = project.parse_errors + missing + result.problems
    result.n_files = len(project.files)
    result.n_scopes = sum(len(c.scopes) for c in project.files.values())
    result.n_reachable = sum(
        1 for c in project.files.values() for s in c.scopes if s.reachable
    )
    return result


def render_report(result: LintResult, verbose: bool = False) -> str:
    lines = []
    for f in result.findings:
        lines.append(f.render())
        if verbose and f.hint:
            lines.append(f"    hint: {f.hint}")
    for e in result.stale:
        lines.append(
            f"note: stale baseline entry {e.rule} {e.path}"
            + (f":{e.func}" if e.func else "")
            + " matched nothing (consider removing)"
        )
    for p in result.problems:
        lines.append(f"error: {p}")
    lines.append(
        f"repro-lint: {result.n_files} files, {result.n_scopes} scopes "
        f"({result.n_reachable} device-reachable), "
        f"{len(result.findings)} finding(s), {result.covered} baselined"
    )
    return "\n".join(lines)
