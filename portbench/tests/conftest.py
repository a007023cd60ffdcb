"""Puts the checkout's root on the path and registers the marker of the
tests that need a card (they decide inside the test whether one is
there)."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit "
        "(skipped without one)")
