"""Global alignment model (Needleman-Wunsch, linear gap penalty)."""

from __future__ import annotations

from .base import PairAligner


class NeedlemanWunsch(PairAligner):
    """Device fill + traceback of the best global path, from (m, n)."""

    local = False
