"""CUDA kernel-contract checker.

The port of ``repro.analysis.spec_check``, which checks each Pallas
kernel's grid and ``BlockSpec``s.  The port's launch geometry lives in
the ``.cu`` host code (the ``<<<...>>>`` launches), so there are no
BlockSpecs to check.  What carries over is the contract between a
wrapper and its kernel, and the kernel's bindings to its oracle and
tests.  A wrapper calls a kernel through ``ctypes``: the C entry's
prototype and the binding's ``argtypes`` must agree parameter for
parameter and width for width, or the call passes silent garbage, or
raises ``OverflowError`` at a large count.  This checker validates
statically, on the CPU, with no ``nvcc`` and no card, that:

- every ``extern "C"`` entry of ``csrc/*.cu`` has a ctypes binding in
  its ``kernels/*.py`` wrapper module (``SOURCES``), read by calling the
  module's binder with a recording stand-in for ``cuda_lib.library``
  (the capture of ``pl.pallas_call`` in the reference);
- the binding's ``argtypes`` match the prototype (the arity rule): a
  pointer is ``c_void_p``, ``long long`` ``c_longlong``, ``int``
  ``c_int``, ``unsigned`` ``c_uint32``; the ``restype`` is ``c_int``;
- each wrapper (``WRAPPERS``) keeps a ``launches`` counter and a plain
  version, and has a case in ``tests/test_torch_kernels.py`` and an
  entry in ``chip_smoke.py``'s kernel dicts (the binding rule).
"""

from __future__ import annotations

import ast
import ctypes
import dataclasses
import importlib
import os
import re
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))

# csrc/<source>.cu -> (kernels module, the function that binds its entries)
SOURCES = {
    "qf_build": ("qf_build", "_library"),
    "qf_probe": ("qf_probe", "_library"),
    "cascade_probe": ("cascade_probe", "_library"),
    "bloom_count": ("bloom_block", "_count_library"),
    "bloom_probe": ("bloom_block", "_probe_library"),
    "fuse_probe": ("fuse_probe", "_library"),
    "fingerprint": ("fingerprint", "_library"),
    "qf_decode": ("qf_decode", "_library"),
}


@dataclasses.dataclass(frozen=True)
class Wrapper:
    module: str  # under repro_torch.kernels
    name: str  # the wrapper, which counts its launches
    plain: str  # its plain PyTorch version


WRAPPERS = (
    Wrapper("qf_build", "qf_build_planes", "build_planes_plain"),
    Wrapper("qf_build", "qf_positions", "positions_plain"),
    Wrapper("qf_build", "qf_build_span", "build_span_plain"),
    Wrapper("qf_probe", "qf_probe", "probe_plain"),
    Wrapper("cascade_probe", "cascade_probe", "cascade_probe_plain"),
    Wrapper("bloom_block", "bloom_count", "bloom_count_plain"),
    Wrapper("bloom_block", "bloom_probe", "bloom_probe_plain"),
    Wrapper("fuse_probe", "fuse_probe", "fuse_probe_plain"),
    Wrapper("fingerprint", "fingerprint", "fingerprint_plain"),
    Wrapper("qf_decode", "qf_decode", "decode_plain"),
)

# a C parameter's type -> its ctypes type (and the name a message gives it)
_WIDTHS = {"pointer": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int,
           "unsigned": ctypes.c_uint32}


# --------------------------------------------------------------------------
# the C side


@dataclasses.dataclass(frozen=True)
class Prototype:
    source: str
    name: str
    params: tuple  # each a key of _WIDTHS
    returns: str


_EXTERN = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')


def _param_kind(decl: str) -> str:
    decl = " ".join(decl.replace("*", " * ").split())
    if "*" in decl:
        return "pointer"
    words = [w for w in decl.split() if w != "const"][:-1]  # the name goes
    kind = " ".join(words)
    if kind in ("unsigned", "unsigned int", "uint32_t"):
        return "unsigned"
    if kind in ("long long", "long long int", "int64_t"):
        return "long long"
    if kind in ("int", "int32_t"):
        return "int"
    raise ValueError(f"parameter {decl!r}: no ctypes width known for {kind!r}")


def parse_prototypes(text: str, source: str) -> list[Prototype]:
    """The ``extern "C"`` definitions of a ``.cu`` source."""
    out = []
    for ret, name, params in _EXTERN.findall(text):
        params = params.strip()
        kinds = () if params in ("", "void") else tuple(
            _param_kind(p) for p in params.split(","))
        out.append(Prototype(source, name, kinds, " ".join(ret.split())))
    return out


def prototypes(csrc: str = CSRC) -> list[Prototype]:
    out = []
    for fn in sorted(os.listdir(csrc)):
        if fn.endswith(".cu"):
            with open(os.path.join(csrc, fn)) as f:
                out.extend(parse_prototypes(f.read(), fn[:-3]))
    return out


# --------------------------------------------------------------------------
# the Python side: what a binder assigns


def _kernel_module(name: str):
    """``repro_torch.kernels.<name>``, imported after the package (the
    kernel modules and ``core`` import each other)."""
    importlib.import_module("repro_torch.filters")
    return importlib.import_module(f"repro_torch.kernels.{name}")


class _RecordingFn:
    """Stands in for a ctypes function: keeps what is assigned to it."""

    def __init__(self):
        self.argtypes = None
        self.restype = None


class _RecordingLib:
    def __init__(self, source: str):
        self.source = source
        self.fns: dict[str, _RecordingFn] = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _RecordingFn())


def record_bindings(module: str, binder: str) -> dict[str, _RecordingLib]:
    """Call ``repro_torch.kernels.<module>.<binder>()`` with ``cuda_lib.
    library`` recording: the libraries it asked for, by source, each with
    the entries it typed.  Nothing is built or loaded; the binder's cache
    is cleared before and after, so a later real call binds for real."""
    from ..kernels import cuda_lib

    mod = _kernel_module(module)
    fn = getattr(mod, binder)
    libs: dict[str, _RecordingLib] = {}
    real = cuda_lib.library

    def recording(name):
        return libs.setdefault(name, _RecordingLib(name))

    clear = getattr(fn, "cache_clear", lambda: None)
    clear()
    cuda_lib.library = recording
    try:
        fn()
    finally:
        cuda_lib.library = real
        clear()
    return libs


def check_binding(proto: Prototype, bound: Optional[_RecordingFn]) -> list[str]:
    """One entry's binding against its prototype (empty = clean)."""
    where = f"{proto.source}.cu::{proto.name}"
    if proto.returns != "int":
        return [f"{where}: returns {proto.returns!r}; an entry returns int (its error code)"]
    if bound is None or bound.argtypes is None:
        return [f"{where}: no ctypes binding sets its argtypes"]
    problems = []
    if bound.restype is not ctypes.c_int:
        problems.append(f"{where}: restype {bound.restype!r}, want c_int")
    got = list(bound.argtypes)
    if len(got) != len(proto.params):
        problems.append(f"{where}: {len(got)} argtypes for {len(proto.params)} parameters")
        return problems
    for i, (kind, t) in enumerate(zip(proto.params, got)):
        if t is not _WIDTHS[kind]:
            problems.append(f"{where}: parameter {i} is {kind}, bound as "
                            f"{getattr(t, '__name__', t)} (want {_WIDTHS[kind].__name__})")
    return problems


# --------------------------------------------------------------------------
# wrappers: counter, plain version, test case, chip_smoke entry


def _names_in(text: str) -> set:
    """Every name and attribute a Python text refers to."""
    out = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def smoke_kernel_entries(text: str) -> set:
    """``"name": module.name`` entries of the dict literals in a script."""
    out = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and isinstance(v, ast.Attribute)
                        and k.value == v.attr):
                    out.add(k.value)
    return out


def check_wrapper(w: Wrapper, module, test_names: set, smoke_entries: set) -> list[str]:
    where = f"kernels/{w.module}.py::{w.name}"
    fn = getattr(module, w.name, None)
    if fn is None:
        return [f"{where}: no such wrapper"]
    problems = []
    if not isinstance(getattr(fn, "launches", None), int):
        problems.append(f"{where}: keeps no `launches` counter")
    if not callable(getattr(module, w.plain, None)):
        problems.append(f"{where}: its plain version {w.plain} is missing")
    if w.name not in test_names:
        problems.append(f"{where}: no case in tests/test_torch_kernels.py calls it")
    if w.name not in smoke_entries:
        problems.append(f"{where}: no entry in chip_smoke.py's kernel dicts")
    return problems


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def run_spec_check(root: str = ROOT, verbose: bool = False) -> int:
    """Check every entry's binding and every wrapper's contract."""
    problems: list[str] = []
    protos = prototypes(os.path.join(root, "src", "repro_torch", "csrc"))
    recorded: dict[str, _RecordingLib] = {}
    for source, (module, binder) in SOURCES.items():
        try:
            recorded.update(record_bindings(module, binder))
        except Exception as e:  # noqa: BLE001 - reported, not raised
            problems.append(f"kernels/{module}.py::{binder}: raised {type(e).__name__}: {e}")
    for p in protos:
        lib = recorded.get(p.source)
        ps = check_binding(p, None if lib is None else lib.fns.get(p.name))
        problems.extend(ps)
        if verbose:
            print(f"  {p.source + '.cu::' + p.name:34s} ({len(p.params)} params) "
                  f"{'FAIL' if ps else 'ok'}")
    for source in sorted({p.source for p in protos} - set(SOURCES)):
        problems.append(f"csrc/{source}.cu: no wrapper module binds it (spec_check.SOURCES)")
    test_names = _names_in(_read(os.path.join(root, "tests", "test_torch_kernels.py")))
    smoke = smoke_kernel_entries(_read(os.path.join(root, "chip_smoke.py")))
    for w in WRAPPERS:
        ps = check_wrapper(w, _kernel_module(w.module), test_names, smoke)
        problems.extend(ps)
        if verbose:
            print(f"  {w.module + '.' + w.name:34s} wrapper {'FAIL' if ps else 'ok'}")
    for p in problems:
        print(f"FAIL {p}")
    verdict = "FAILED" if problems else "passed"
    print(f"spec-check {verdict}: {len(protos)} entries, {len(WRAPPERS)} wrappers, "
          f"{len(problems)} problems")
    return 1 if problems else 0
