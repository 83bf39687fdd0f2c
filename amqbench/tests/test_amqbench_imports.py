"""What the benchmark loads: never JAX or the JAX package ``repro``, and in
the reference nothing of the program (``repro_torch``).  Top-level names
are compared whole: ``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PROGRAM = f"""
import importlib, importlib.util, pathlib, sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, {str(BENCH)!r}]
bench = pathlib.Path({str(BENCH)!r})
for p in sorted(bench.rglob('*.py')):
    rel = p.relative_to(bench.parent)
    if 'tests' in rel.parts:
        continue
    if p.parent.name == 'metrics':
        spec = importlib.util.spec_from_file_location('m_' + p.stem.replace('.', '_'), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module('.'.join(rel.with_suffix('').parts).replace('.__init__', ''))
import amqbench.harness.engine as e, torch
e.Port({{'family': 'qf', 'spec': {{'q': 6, 'r': 8}}}}, 'cpu').make()
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(program):
    out = subprocess.run([sys.executable, "-c", program], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_nothing_loads_jax_or_the_jax_package():
    names = loaded(PROGRAM)
    assert "amqbench" in names and "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(f"""
import sys
sys.path[:0] = [{str(ROOT)!r}]
import amqbench.reference.qf, amqbench.reference.cascade, amqbench.reference.fingerprint
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
""")
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_each_other(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= {"torch", "numpy", "typing", "__future__", "importlib"}
