"""The benchmark's CPU tests: ``python -m pytest portbench/tests`` from the
root of the checkout. The program is imported from ``src``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card only)")
    return torch.device("cuda")
