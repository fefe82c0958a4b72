"""Settings of the benchmark's tests: the import path, the card marker
and the thread count."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason "
        "where none is present")


@pytest.fixture
def one_thread():
    """The harness pins torch to one thread; give the worker its count
    back afterwards."""
    import torch
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test where no NVIDIA GPU is present (decided here, at
    run time, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
