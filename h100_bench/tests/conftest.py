"""The benchmark's CPU tests: ``python -m pytest h100_bench/tests -q`` from the
root of the repository. Tests marked ``gpu`` need a CUDA card and decide so
inside a fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
