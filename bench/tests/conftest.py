"""The benchmark's tests: ``python -m pytest -q bench/tests`` (CPU, tiny
cells); ``python -m pytest -q -m cuda bench/tests`` on a card runs the
control at the cells' own sizes."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
