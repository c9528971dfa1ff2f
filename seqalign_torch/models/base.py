"""Shared pairwise-aligner machinery of the GPU engine."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config
from ..native import bindings
from ..ops import checkpoint, direct, layout, wavefront

@dataclasses.dataclass
class AlignmentResult:
    """Engine-level alignment result (alphabet indices, gap == K)."""

    aligned_text: np.ndarray
    aligned_pattern: np.ndarray
    start_in_aligned_text: int
    start_in_aligned_pattern: int
    score: int


class PairAligner:
    """Base: one sequence pair through the wavefront route, the direct
    route or the checkpoint engine."""

    local: bool = False

    def align(self, text, pattern, score_matrix, alphabet_size, gap_penalty,
              gap_extend=None, device=None):
        """Align on ``device`` (default ``config.device()``).  Affine
        (Gotoh) gap costs with ``gap_extend`` (``gap_penalty`` is then the
        open cost) take the direct route or the checkpoint engine: the
        wavefront route's native traceback is linear."""
        device = device or config.device()
        if gap_extend is not None:
            return self._align_long(
                np.asarray(text, dtype=np.int32),
                np.asarray(pattern, dtype=np.int32), score_matrix,
                alphabet_size, gap_penalty, device, gap_extend=gap_extend,
            )
        return self._align_wavefront(
            text, pattern, score_matrix, alphabet_size, gap_penalty, device,
        )

    def _align_wavefront(self, text, pattern, score_matrix, alphabet_size,
                         gap_penalty, device):
        """Small pairs: multi-strip fill on the device, words to the host,
        native skewed traceback.  Pairs whose words exceed the host
        budget take ``_align_long``."""
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
            return self._align_long(
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

    def _align_long(self, text, pattern, score_matrix, alphabet_size,
                    gap_penalty, device, semi: bool = False, gap_extend=None):
        """The direct route when the pair fits it, else the checkpoint
        engine.  A direct run that runs out of device memory (the budget
        assumes a card of its own) is retried on the checkpoint engine, on
        the same device; any other error propagates."""
        n, m = len(text), len(pattern)
        if direct.fits_direct(n, m, affine=gap_extend is not None):
            try:
                return self._align_direct(text, pattern, score_matrix,
                                          alphabet_size, gap_penalty, device,
                                          semi=semi, gap_extend=gap_extend)
            except torch.cuda.OutOfMemoryError:
                pass  # retried below, once the failed run's tensors are freed
        return self._align_checkpoint(text, pattern, score_matrix,
                                      alphabet_size, gap_penalty, device,
                                      semi=semi, gap_extend=gap_extend)

    def _align_direct(self, text, pattern, score_matrix, alphabet_size,
                      gap_penalty, device, semi: bool = False,
                      gap_extend=None):
        """Fill, best-cell merge and walk on the device (ops/direct.py)."""
        score, _, _, aligned_text, aligned_pattern, start_t, start_p = (
            direct.direct_align(
                text, pattern, score_matrix, alphabet_size, gap_penalty,
                local=self.local, semi=semi, gap_extend=gap_extend,
                device=device,
            )
        )
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, score)

    def _align_checkpoint(self, text, pattern, score_matrix, alphabet_size,
                          gap_penalty, device, semi: bool = False,
                          gap_extend=None):
        """Boundary-checkpoint fill and path-tile traceback on the device
        (ops/checkpoint.py), for pairs of any length."""
        score, _, _, aligned_text, aligned_pattern, start_t, start_p = (
            checkpoint.checkpointed_align(
                text, pattern, score_matrix, alphabet_size, gap_penalty,
                local=self.local, semi=semi, gap_extend=gap_extend,
                device=device,
            )
        )
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, score)
