"""The benchmark's own tests: the reference against the port on the CPU,
the traffic, the metric arithmetic, the imports and the check's faults.

Run from the root of the repository: ``python -m pytest amqbench/tests``.
Tests marked ``card`` need a CUDA device and skip without one; the
fixture ``card`` decides, when a test asks for it.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
