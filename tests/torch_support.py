"""Shared setup of the port's CPU tests (``tests/test_torch_*.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from seqalign_torch.io import parse_score_matrix_file


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions step through small tensors thousands of times;
    one intra-op thread is faster there than many, and the suite runs
    several workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def score_matrix(k: int) -> np.ndarray:
    """The bundled DNA (k=4, blast) or protein (k=23, blosum62) matrix."""
    path = ("scoreMatrices/dna/blast.txt" if k == 4
            else "scoreMatrices/protein/blosum62.txt")
    sm = np.zeros((k, k), dtype=np.int32)
    assert parse_score_matrix_file(path, k, sm) == 0
    return sm
