"""Shared test config: make the tests directory importable so the
``_hypothesis_fallback`` shim resolves regardless of pytest rootdir."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the PyTorch port's kernels); "
        "skipped where torch.cuda is not available")
