"""Local alignment model (Smith-Waterman, linear gap penalty)."""

from __future__ import annotations

from .base import PairAligner


class SmithWaterman(PairAligner):
    """Device fill with per-row best tracking (the analog of the
    reference's block max-reduce, alignSequenceGPU.cu:203-216) +
    traceback from the first best cell in row-major order."""

    local = True
