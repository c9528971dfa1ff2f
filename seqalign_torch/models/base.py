"""Shared pairwise-aligner machinery of the GPU engine."""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import config
from ..native import bindings
from ..ops import direct, layout, wavefront

AFFINE_NOT_PORTED = (
    "affine gaps (--gap-extend) need the affine engine, which the GPU "
    "package does not have yet; use -c"
)


def beyond_direct_message(n: int, m: int) -> str:
    return (
        f"a {m} x {n} pair exceeds the direct route (one strip of "
        f"{16 * direct.DEFAULT_CKPT_SLOTS} rows); the checkpoint engine "
        f"it needs is not in the GPU package yet; use -c"
    )


@dataclasses.dataclass
class AlignmentResult:
    """Engine-level alignment result (alphabet indices, gap == K)."""

    aligned_text: np.ndarray
    aligned_pattern: np.ndarray
    start_in_aligned_text: int
    start_in_aligned_pattern: int
    score: int


class PairAligner:
    """Base: one sequence pair through the wavefront or the direct route,
    linear gaps only."""

    local: bool = False

    def align(self, text, pattern, score_matrix, alphabet_size, gap_penalty,
              gap_extend=None, device=None):
        """Align on ``device`` (default ``config.device()``).  Raises
        ValueError for what this package cannot run yet: affine gaps, and
        pairs beyond the direct route."""
        if gap_extend is not None:
            raise ValueError(AFFINE_NOT_PORTED)
        return self._align_wavefront(
            text, pattern, score_matrix, alphabet_size, gap_penalty,
            device or config.device(),
        )

    def _align_wavefront(self, text, pattern, score_matrix, alphabet_size,
                         gap_penalty, device):
        """Small pairs: multi-strip fill on the device, words to the host,
        native skewed traceback.  Pairs whose words exceed the host
        budget take the direct route."""
        text = np.asarray(text, dtype=np.int32)
        pattern = np.asarray(pattern, dtype=np.int32)
        sm = layout.pack_score_matrix(score_matrix, alphabet_size)
        # Host-RAM guard for the words (2 bits/cell + pipeline skew), the
        # JAX package's estimate at its default geometry.
        rows = wavefront.strip_rows()
        steps_est = text.shape[0] + wavefront.SLOTS
        words_bytes = (
            -(-pattern.shape[0] // rows)
            * (steps_est // 16 + 1) * wavefront.ROWS_PER_SLOT
            * wavefront.SLOTS * 4
        )
        if words_bytes > config.host_dirs_budget():
            return self._align_direct(
                text, pattern, sm, alphabet_size, gap_penalty, device
            )
        score, bi, bj, words, steps_pad = wavefront.wavefront_fill(
            text, pattern, sm, alphabet_size, gap_penalty,
            local=self.local, device=device,
        )
        aligned_text, aligned_pattern, start_t, start_p = (
            bindings.traceback_skewed(
                1 if self.local else 0, words, steps_pad, text, pattern,
                alphabet_size, best_i=bi, best_j=bj,
                rps=wavefront.ROWS_PER_SLOT, slots=wavefront.SLOTS,
            )
        )
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, score)

    def _align_direct(self, text, pattern, score_matrix, alphabet_size,
                      gap_penalty, device, semi: bool = False):
        """Fill, best-cell merge and walk on the device (ops/direct.py)."""
        n, m = len(text), len(pattern)
        if not direct.fits_direct(n, m):
            raise ValueError(beyond_direct_message(n, m))
        score, _, _, aligned_text, aligned_pattern, start_t, start_p = (
            direct.direct_align(
                text, pattern, score_matrix, alphabet_size, gap_penalty,
                local=self.local, semi=semi, device=device,
            )
        )
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, score)
