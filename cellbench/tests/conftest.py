"""CPU tests of the benchmark: ``python -m pytest cellbench/tests``.

Tests marked ``cuda`` need the card and skip without one; run them on a
CUDA host with ``python -m pytest cellbench/tests -m cuda``.
"""

import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda_card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and cellbench/, without its
    tests) to add data files to; returns its root."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "cellbench"),
                    tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return tmp_path
