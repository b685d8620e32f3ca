"""pytest setup for the benchmark's own tests (run from the repository root:
`python -m pytest benchmark/tests -q`). Tests that need a CUDA card carry
the `cuda` marker and skip inside the test where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs on a CUDA card; skips without an NVIDIA GPU")
