"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``chip`` marker, for tests that need a CUDA card;
whether there is one is decided inside the ``card`` fixture, never at
import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")
    # the tests run their small models under several workers: one intra-op
    # thread each, or the workers' thread pools take the cores in turns
    import torch
    torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
