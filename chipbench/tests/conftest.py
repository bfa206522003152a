"""Fixtures of the benchmark's own tests (CPU, small sizes)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def no_card():
    """Skip the test where there is a CUDA device: it checks what a run
    does without one."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no CUDA device")
