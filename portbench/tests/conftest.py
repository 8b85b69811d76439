"""The benchmark's own tests: ``python -m pytest portbench/tests -q``.

Tests marked ``card`` need an NVIDIA card and skip elsewhere; whether there
is one is decided inside the ``card`` fixture, never at import. On the card:
``python -m pytest portbench/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the card's tests run on the chip")
    return torch.device("cuda")
