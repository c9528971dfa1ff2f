"""Semi-global ("fit") alignment model — extension beyond the reference
(its SEMI_GLOBAL enum value is unreachable from its CLI): the pattern
aligns globally while text end-gaps are free.  The native oracle defines
the contract; the GPU engine takes the direct route when the pair fits
it, else the checkpoint engine."""

from __future__ import annotations

import numpy as np

from .. import config
from .base import PairAligner


class SemiGlobal(PairAligner):
    local = False
    semi = True

    def align(self, text, pattern, score_matrix, alphabet_size, gap_penalty,
              gap_extend=None, device=None):
        # gap_extend: affine (Gotoh) fit, on the same two routes.
        return self._align_long(
            np.asarray(text, dtype=np.int32),
            np.asarray(pattern, dtype=np.int32),
            score_matrix, alphabet_size,
            gap_penalty, device or config.device(), semi=True,
            gap_extend=gap_extend,
        )
