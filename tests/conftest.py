import os
import sys

# smoke tests and benches must see ONE cpu device (the dry-run sets its own
# 512-device flag in its own process) — keep XLA_FLAGS untouched here.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason "
        "where none is present")
