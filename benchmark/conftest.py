"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the repository root on the path, and the marker of the
tests that need a CUDA card, which skip without one (decided inside each
test)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run on the "
        "card: python3 -m pytest benchmark/tests -m card)")
