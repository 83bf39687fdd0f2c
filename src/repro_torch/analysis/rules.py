"""Host-sync lint rules: each a small class with id, severity and fix hint.

The port of ``repro.analysis.rules``, for PyTorch.  Rules are registered
in a module-level list that :mod:`repro_torch.analysis.lint` iterates.
Each rule's :meth:`Rule.visit` walks one function scope (the AST nodes
owned by a single ``def``, nested defs excluded) and yields ``(lineno,
message)`` violations; the engine attaches file / function /
device-reachability context and severity.

Rule ids (stable, referenced from ``baseline.toml``), the reference's
where a rule carries over:

- **RL101** ``.item()`` / ``.tolist()``: a copy to the host and a wait
  for the card.
- **RL102** ``int()`` / ``float()`` / ``bool()`` of a tensor: the same,
  spelled as a cast.
- **RL103** a host round trip: ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``np.asarray`` / ``np.array`` of a tensor.
- **RL104** a Python ``if`` / ``while`` on a tensor (an implicit
  ``bool()``), inside device-reachable code.
- **RL106** a bare int32-range literal in a comparison.  It carries over
  because torch wraps it: a Python int compared with an int32 tensor is
  converted to int32 without a check, so on the CPU (torch 2.13)
  ``t == 2**31`` is true where ``t`` is ``-2**31``, ``t < 2**31`` is false
  everywhere and ``t == 2**32 - 1`` is true where ``t`` is ``-1``
  (``tests/test_torch_analysis.py`` pins this).  Write such a bound as a
  tensor of an explicit dtype, or keep it inside the int32 range.

Two of the reference's rules do not carry over: RL105 (a kernel mode
resolved inside traced code) and RL107 (a ``jax.jit`` of a state without
``donate_argnums``).  The port has no mode to resolve, as a kernel
wrapper dispatches by the device of its inputs (``kernels/dispatch.py``),
and no ``jit``: an eager step writes its new state where it likes and
donates nothing.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    func: str  # dotted in-file qualname; "<module>" for top-level code
    message: str
    severity: str  # "error" (device-reachable) | "warning"
    hint: str

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} [{self.severity}] "
            f"{self.message}  (in {self.func})"
        )


class Rule:
    """Base rule.  Subclasses set the class attrs and implement visit."""

    id: str = "RL000"
    title: str = ""
    hint: str = ""
    # True: only report inside device-reachable scopes (the construct is
    # fine on the host); False: report everywhere, severity by reachability
    device_only: bool = False

    def visit(self, scope: "Scope", ctx: "FileContext") -> Iterator[tuple[int, str]]:
        raise NotImplementedError


RULES: list[Rule] = []


def register(cls: type) -> type:
    RULES.append(cls())
    return cls


def rule_by_id(rule_id: str) -> Rule:
    for r in RULES:
        if r.id == rule_id:
            return r
    raise KeyError(f"unknown rule {rule_id!r}; known: {[r.id for r in RULES]}")


# --------------------------------------------------------------------------
# shared AST helpers


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an arbitrary expression chain (calls/subscripts ok)."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, (ast.Subscript, ast.Call)):
            node = node.func if isinstance(node, ast.Call) else node.value
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


_SENTINELS = {2147483647, 2147483648, -2147483648, 4294967295}

# cfg-ish roots whose attributes are static python scalars by protocol
_STATIC_ROOT_SUFFIXES = ("cfg", "spec", "math")

# tensor attributes that are host values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_cpu", "is_meta",
                 "requires_grad"}

_HOST_CAST_SAFE_CALLS = {"len", "round", "abs", "min", "max", "ord", "pow", "sum"}

# tensor methods that return host values
_HOST_METHODS = {"dim", "numel", "size", "element_size", "nelement", "get_device",
                 "is_contiguous", "data_ptr", "is_floating_point", "stride"}

# torch functions whose result is a host value (a predicate on the process,
# a dtype or device, never on a tensor's contents)
_HOST_TORCH_CALLS = {"is_tensor", "is_floating_point", "is_grad_enabled", "device",
                     "is_inference_mode_enabled", "are_deterministic_algorithms_enabled",
                     "get_default_dtype", "is_autocast_enabled"}

# tensor methods whose result, in an ``if``, is a tensor's contents
_DEVICE_TEST_METHODS = {"any", "all", "equal", "sum", "nonzero", "count_nonzero"}


def _is_static_expr(node: ast.AST, ctx: "FileContext") -> bool:
    """Conservatively: does this expression never hold a tensor's contents?"""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        final_static = node.attr in _STATIC_ATTRS
        root = root_name(node)
        root_static = root is not None and (
            root.endswith(_STATIC_ROOT_SUFFIXES) or root in ctx.static_roots
        )
        return final_static or root_static
    if isinstance(node, ast.Name):
        return node.id in ctx.static_roots or node.id.endswith(_STATIC_ROOT_SUFFIXES)
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value, ctx)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS:
            return True
        fn = dotted_name(node.func)
        if fn is None:
            return False
        base = fn.split(".")[0]
        if fn in _HOST_CAST_SAFE_CALLS or base == "math":
            if fn == "len":
                return True  # len() of anything is a host int
            return all(_is_static_expr(a, ctx) for a in node.args)
        if base.endswith(_STATIC_ROOT_SUFFIXES) or base in ctx.static_roots:
            # method on a static config (cfg.slots(), spec.total_bits())
            return all(_is_static_expr(a, ctx) for a in node.args)
        if "." not in fn and node.args:
            # local helper on static-only args (geometry math like
            # _cells(cfg)); tensors enter through state/keys args
            return all(_is_static_expr(a, ctx) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left, ctx) and _is_static_expr(node.right, ctx)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand, ctx)
    if isinstance(node, ast.BoolOp):
        return all(_is_static_expr(v, ctx) for v in node.values)
    if isinstance(node, ast.Compare):
        return _is_static_expr(node.left, ctx) and all(
            _is_static_expr(c, ctx) for c in node.comparators
        )
    if isinstance(node, ast.IfExp):
        return (
            _is_static_expr(node.test, ctx)
            and _is_static_expr(node.body, ctx)
            and _is_static_expr(node.orelse, ctx)
        )
    return False


def _is_literal_arith(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float))
    if isinstance(node, ast.BinOp):
        return _is_literal_arith(node.left) and _is_literal_arith(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_literal_arith(node.operand)
    return False


def _contains_sentinel_literal(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and sub.value in _SENTINELS:
            return True
        if isinstance(sub, ast.BinOp):
            lo, hi = sub.left, sub.right
            if (
                isinstance(sub.op, (ast.Pow, ast.LShift))
                and isinstance(lo, ast.Constant)
                and isinstance(hi, ast.Constant)
                and lo.value in (1, 2)
                and hi.value in (31, 32)
            ):
                return True
    return False


def _is_cpu_device(node: ast.AST, ctx) -> bool:
    """``"cpu"``, or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn and fn.rpartition(".")[2] == "device" and node.args:
            return _is_cpu_device(node.args[0], ctx)
    return False


# --------------------------------------------------------------------------
# rules


@register
class HostItemCall(Rule):
    id = "RL101"
    title = "device-to-host .item()/.tolist() sync"
    hint = (
        "keep the value on the device (torch ops compose without a read); "
        "if a host scalar is genuinely needed, move the read to the host "
        "driver and baseline it with a reason"
    )

    def visit(self, scope, ctx):
        for node in scope.nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("item", "tolist")
                and not node.args
                and not node.keywords
            ):
                yield node.lineno, f".{node.func.attr}() forces a host sync"


@register
class HostScalarCast(Rule):
    id = "RL102"
    title = "int()/float()/bool() of a tensor"
    hint = (
        "compare and select on the device (torch.where, a mask); a cast of "
        "a CUDA tensor copies it to the host and waits for the card"
    )

    def visit(self, scope, ctx):
        for node in scope.nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float", "bool")
                and len(node.args) == 1
                and not node.keywords
                and not _is_static_expr(node.args[0], ctx)
            ):
                yield (
                    node.lineno,
                    f"{node.func.id}() of a potential tensor forces a host sync",
                )


@register
class HostRoundTrip(Rule):
    id = "RL103"
    title = "host round trip"
    hint = (
        ".cpu()/.numpy()/.to('cpu')/np.asarray copy the buffer to host RAM; "
        "stay in torch on the device, or baseline genuinely host-side code "
        "with a reason"
    )

    def visit(self, scope, ctx):
        for node in scope.nodes:
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in ("cpu", "numpy") and not node.args:
                    yield node.lineno, f".{attr}() copies the tensor to the host"
                    continue
                if attr == "to":
                    dev = [a for a in node.args[:1]] + [
                        k.value for k in node.keywords if k.arg == "device"]
                    if any(_is_cpu_device(d, ctx) for d in dev):
                        yield node.lineno, ".to('cpu') copies the tensor to the host"
                        continue
            fn = dotted_name(node.func)
            if fn is None:
                continue
            base, _, attr = fn.rpartition(".")
            if base in ctx.np_aliases and attr in ("asarray", "array") and not (
                node.args and _is_static_expr(node.args[0], ctx)
            ):
                yield node.lineno, f"{fn}() copies the tensor to the host"


@register
class PythonBranchOnDevice(Rule):
    id = "RL104"
    title = "Python if/while on a tensor"
    device_only = True
    hint = (
        "a Python branch on a CUDA tensor's contents copies it to the host "
        "and waits for the card; select with torch.where or a mask"
    )

    def visit(self, scope, ctx):
        for node in scope.nodes:
            if not isinstance(node, (ast.If, ast.While)):
                continue
            test = node.test
            # int()/bool() casts in the test are RL102's finding
            if any(
                isinstance(s, ast.Call)
                and isinstance(s.func, ast.Name)
                and s.func.id in ("int", "float", "bool")
                for s in ast.walk(test)
            ):
                continue
            devicey = False
            inner = {id(s.value) for s in ast.walk(test) if isinstance(s, ast.Attribute)}
            for s in ast.walk(test):
                if isinstance(s, ast.Call):
                    fn = dotted_name(s.func)
                    if fn:
                        parts = fn.split(".")
                        if (parts[0] in ctx.torch_aliases and len(parts) == 2
                                and parts[1] not in _HOST_TORCH_CALLS):
                            devicey = True
                    if (isinstance(s.func, ast.Attribute)
                            and s.func.attr in _DEVICE_TEST_METHODS and not s.args
                            and root_name(s.func) not in ctx.np_aliases):
                        devicey = True
                if (isinstance(s, ast.Attribute) and id(s) not in inner
                        and root_name(s) in ctx.state_roots and s.attr not in _STATIC_ATTRS):
                    devicey = True
            if devicey:
                kw = "if" if isinstance(node, ast.If) else "while"
                yield node.lineno, f"Python `{kw}` on a tensor"


@register
class BareInt32Sentinel(Rule):
    id = "RL106"
    title = "bare int32-range literal in a comparison"
    hint = (
        "torch converts a Python int to an int32 tensor's dtype without a "
        "check, so a bound past the int32 range wraps; compare with a tensor "
        "of an explicit dtype, or keep the bound inside the range"
    )

    def visit(self, scope, ctx):
        for node in scope.nodes:
            if not isinstance(node, ast.Compare):
                continue
            for side in [node.left, *node.comparators]:
                if not _is_literal_arith(side):
                    continue
                if _contains_sentinel_literal(side):
                    yield (
                        side.lineno,
                        "int32-range literal compared without an explicit "
                        "dtype",
                    )
