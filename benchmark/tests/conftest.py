"""The benchmark's own tests: on the CPU they drive the harness with the
port's plain kernels at a tiny batch; tests marked `chip` need a CUDA card
and skip here (run them on the card with
`python3 -m pytest benchmark/tests -m chip`)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
