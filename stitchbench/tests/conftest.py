"""The benchmark's own CPU tests (run them with
``python -m pytest stitchbench/tests -q`` from the repository's root).
Tests marked ``card`` need a CUDA card and skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
