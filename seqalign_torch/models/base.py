"""Shared pairwise-aligner machinery of the GPU engine."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..native import bindings
from ..ops import checkpoint, direct, layout, strip_fill, tiled, wavefront
from ..ops.traceback import run_device_traceback

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
    route, the checkpoint engine or the strip engine."""

    local: bool = False
    semi: bool = False

    def score(self, text, pattern, score_matrix, alphabet_size, gap_penalty,
              device=None) -> int:
        """Optimal score alone (linear gaps), on ``device`` (default
        ``config.device()``): the checkpoint engine's phase 1, K1
        score-only, whose trackers give the mode's score (local: the best
        over every row; semi-global: row m's; global: S[m, n]).  The JAX
        ``score()`` runs its XLA scan engine whatever the engine setting,
        so no route is chosen here either."""
        return checkpoint.checkpointed_fill(
            np.asarray(text, dtype=np.int32),
            np.asarray(pattern, dtype=np.int32), score_matrix,
            alphabet_size, gap_penalty, local=self.local, semi=self.semi,
            ckpt_cols=checkpoint.DEFAULT_CKPT_COLS,
            device=device or config.device(),
        ).score

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
        engine = config.pair_engine()
        if engine == "strip":
            return self._align_strip(text, pattern, score_matrix,
                                     alphabet_size, gap_penalty, device)
        if engine == "checkpoint":
            return self._align_checkpoint(
                np.asarray(text, dtype=np.int32),
                np.asarray(pattern, dtype=np.int32), score_matrix,
                alphabet_size, gap_penalty, device,
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
        """The sequence-parallel route when ``config.sequence_parallel``
        lets it and the pair's strips fit the default mesh of ``device``
        (the JAX routing, ``seqalign_tpu/models/base.py:94-112``, here for
        the affine and semi-global requests too; never in a process
        group, whose ranks align pairs of their own), else the direct
        route when
        the pair fits it, else the checkpoint engine.  A direct run that
        runs out of device memory (the budget assumes a card of its own)
        is retried on the checkpoint engine, on the same device: any
        ``RuntimeError`` whose message says "out of memory" (any case) or
        "RESOURCE_EXHAUSTED", as the reference tests, which takes in
        ``torch.cuda.OutOfMemoryError``, a kernel launch's
        ``cudaErrorMemoryAllocation`` and torch's untyped "CUDA error: out
        of memory".  Any other error propagates."""
        n, m = len(text), len(pattern)
        if not dist.is_initialized() and config.sequence_parallel(device):
            from ..parallel import mesh as mesh_lib
            from ..parallel.sequence import ROUTE_SPEEDUP, estimated_speedup

            mesh = mesh_lib.make_data_mesh(
                devices=config.mesh_devices(device))
            # The mesh only where the pipeline's modelled time (its steps
            # and each chunk's measured cost) beats one device's, unless
            # SEQALIGN_SEQUENCE_PARALLEL=1 forces it.
            est = estimated_speedup(n, m, mesh.size,
                                    checkpoint.DEFAULT_CKPT_COLS)
            forced = os.environ.get("SEQALIGN_SEQUENCE_PARALLEL") == "1"
            if est > 0 and (forced or est >= ROUTE_SPEEDUP):
                return self._align_sequence_parallel(
                    text, pattern, score_matrix, alphabet_size, gap_penalty,
                    mesh, semi=semi, gap_extend=gap_extend)
        if direct.fits_direct(n, m, affine=gap_extend is not None):
            try:
                return self._align_direct(text, pattern, score_matrix,
                                          alphabet_size, gap_penalty, device,
                                          semi=semi, gap_extend=gap_extend)
            except RuntimeError as e:
                msg = str(e)
                if ("out of memory" not in msg.lower()
                        and "RESOURCE_EXHAUSTED" not in msg):
                    raise
            # Retried here, once the failed run's tensors are freed.
        return self._align_checkpoint(text, pattern, score_matrix,
                                      alphabet_size, gap_penalty, device,
                                      semi=semi, gap_extend=gap_extend)

    def _align_sequence_parallel(self, text, pattern, score_matrix,
                                 alphabet_size, gap_penalty, mesh,
                                 semi: bool = False, gap_extend=None):
        """The checkpoint engine with its phase 1 pipelined over ``mesh``
        (``parallel/sequence.py``), then ``checkpointed_traceback`` on the
        mesh's first device: the checkpoint engine's bytes."""
        from ..parallel.sequence import sequence_parallel_checkpointed_fill

        ck = sequence_parallel_checkpointed_fill(
            text, pattern, score_matrix, alphabet_size, gap_penalty,
            local=self.local, semi=semi, gap_extend=gap_extend,
            ckpt_cols=checkpoint.DEFAULT_CKPT_COLS, mesh=mesh)
        aligned_text, aligned_pattern, start_t, start_p = (
            checkpoint.checkpointed_traceback(ck, text, pattern, score_matrix,
                                              alphabet_size))
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, ck.score)

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

    def _fill_strip(self, text, pattern, score_matrix, alphabet_size,
                    gap_penalty, device):
        """K5 over one region when the pair fits it, else the tiled fill
        (the JAX ``_fill_pallas``'s routing).  Returns (words, score, bi,
        bj): the words (m_pad/16, P) int32 stay on the device for one
        region and are a host array for the tiled fill."""
        n, m = len(text), len(pattern)
        sm = layout.pack_score_matrix(score_matrix, alphabet_size)
        p_cols = strip_fill.pair_columns(n)
        m_pad = strip_fill.pair_rows(m)
        dirs_bytes = (m_pad // strip_fill.DIR_ROWS_PER_WORD) * p_cols * 4
        budget = config.host_dirs_budget(config.MAX_DIRS_BYTES)
        if (dirs_bytes > budget or p_cols > strip_fill.MAX_STRIP_COLS
                or m_pad > strip_fill.MAX_CHUNK_ROWS):
            result = tiled.tiled_fill(text, pattern, sm, alphabet_size,
                                      gap_penalty, local=self.local,
                                      device=device)
            return result.words, result.score, result.best_i, result.best_j
        pat = np.zeros(m_pad, dtype=np.int32)
        pat[:m] = pattern
        to_device = [torch.from_numpy(x).to(device) for x in (
            strip_fill.strip_letters(text, 0, p_cols), sm, pat)]
        return strip_fill.pair_fill(*to_device, gap_penalty, n, m,
                                    local=self.local)

    def _align_strip(self, text, pattern, score_matrix, alphabet_size,
                     gap_penalty, device):
        """The strip engine (``SEQALIGN_PAIR_ENGINE=strip``), linear
        global and local: ``_fill_strip``, then the native walk over the
        words on the host or, with ``SEQALIGN_TRACEBACK=device``, K4 on
        the device and the native replay of its moves."""
        text = np.asarray(text, dtype=np.int32)
        pattern = np.asarray(pattern, dtype=np.int32)
        words, score, bi, bj = self._fill_strip(
            text, pattern, score_matrix, alphabet_size, gap_penalty, device)
        if config.traceback_mode() == "device":
            aligned_text, aligned_pattern, start_t, start_p = (
                run_device_traceback(words, text, pattern, len(text),
                                     len(pattern), bi, bj, alphabet_size,
                                     self.local, device=device))
        else:
            if isinstance(words, torch.Tensor):
                words = words.cpu().numpy()
            aligned_text, aligned_pattern, start_t, start_p = (
                bindings.traceback_packed(
                    1 if self.local else 0, words, text, pattern,
                    alphabet_size, best_i=bi, best_j=bj))
        return AlignmentResult(aligned_text, aligned_pattern, start_t,
                               start_p, score)
