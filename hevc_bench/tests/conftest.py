"""Tests of the benchmark harness. They run on the CPU, at small sizes;
those marked `card` need a CUDA card and skip without one (decided in the
`card` fixture, never at import). On the card:

    python3 -m pytest hevc_bench/tests -q -m card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def root():
    return ROOT
