"""Tiled long-pair fill: column strips x row blocks of K5 (the JAX
package's ``ops/tiled.py``).

* The DP matrix is cut into column strips of ``strip_cols`` columns.
* Each strip runs top to bottom as ``strip_fill`` calls over row blocks,
  carrying the strip's last DP row and its state on the device and
  bringing the 2-bit words to host RAM block by block, so the device
  holds one strip's state and one block of words.  On a CUDA device a
  block's words go through one pinned staging buffer, and the host copies
  them into the host array while the next block's K5 runs.
* A strip's right boundary column becomes the next strip's left one.
* The per-strip states are merged on the host: local, the largest value,
  then the smallest row, then the smallest column (counted only when the
  best is above 0), the reference's row-major first occurrence; global,
  the largest score, with the walk's start at (m, n).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import config
from .strip_fill import (DIR_ROWS_PER_WORD, MAX_CHUNK_ROWS, ROWS_PER_STEP,
                         init_prev_row, nw_boundary_col, pair_rows,
                         strip_fill, strip_letters, zeros_state)

# Strip width in DP columns (a multiple of 1024) and the row blocks whose
# words go to the host at a time: the JAX package's defaults.
DEFAULT_STRIP_COLS = 32768
DEFAULT_BLOCK_ROWS = 8192


@dataclasses.dataclass
class TiledResult:
    score: int
    best_i: int
    best_j: int
    # Packed direction words on the host, (m_pad/16, total_p_cols) int32,
    # or None in score-only mode.
    words: Optional[np.ndarray]
    p_cols: int


def tiled_fill(text, pattern, score_matrix, k_alpha: int, gap: int,
               local: bool = False, with_dirs: bool = True,
               strip_cols: int = DEFAULT_STRIP_COLS,
               block_rows: int = DEFAULT_BLOCK_ROWS,
               device=None) -> TiledResult:
    """Fill a single-pair DP matrix of any size on ``device`` (default
    ``config.device()``): the device holds one strip's state plus one
    row block of words; the host gathers the words (2 bits a cell) when
    ``with_dirs``."""
    device = torch.device(device or config.device())
    text_np = np.asarray(text, dtype=np.int32)
    pattern_np = np.asarray(pattern, dtype=np.int32)
    sm = np.asarray(score_matrix, dtype=np.int32).reshape(-1)[
        :k_alpha * k_alpha].reshape(k_alpha, k_alpha)
    n, m = text_np.shape[0], pattern_np.shape[0]
    gap = int(gap)

    m_pad = pair_rows(m)
    block_rows = min(
        m_pad, MAX_CHUNK_ROWS,
        max(ROWS_PER_STEP, (block_rows // ROWS_PER_STEP) * ROWS_PER_STEP),
    )
    num_strips = max(1, -(-n // strip_cols))
    total_p = num_strips * strip_cols

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    pat_pad = np.zeros(m_pad, dtype=np.int32)
    pat_pad[:m] = pattern_np
    pat_dev = tensor(pat_pad)
    sm_dev = tensor(sm)
    words_host = (
        np.empty((m_pad // DIR_ROWS_PER_WORD, total_p), dtype=np.int32)
        if with_dirs else None
    )
    staged = _Staging(block_rows // DIR_ROWS_PER_WORD, strip_cols) \
        if with_dirs and device.type == "cuda" else None

    # Boundary columns: S[i, strip_off] for i = 0..m_pad, per strip edge.
    left_col = tensor(nw_boundary_col(0, m_pad, gap, local))
    strip_states = []
    for c in range(num_strips):
        strip_off = c * strip_cols
        letters = tensor(strip_letters(text_np, strip_off, strip_cols))
        prev_row = tensor(init_prev_row(strip_cols, strip_off, gap, local))
        state = tensor(zeros_state())
        # The right boundary column across the row blocks; entry 0 is the
        # init row's S[0, strip_off + strip_cols].
        top_val = 0 if local else -gap * (strip_off + strip_cols)
        rcol_parts = [torch.full((1,), top_val, dtype=torch.int32,
                                 device=device)]
        for row_base in range(0, m_pad, block_rows):
            rows_here = min(block_rows, m_pad - row_base)
            words, prev_row, rcol, state = strip_fill(
                letters, sm_dev, pat_dev[row_base:row_base + rows_here],
                gap, n, m, row_base, strip_off,
                left_col[row_base:row_base + rows_here + 1],
                prev_row, state, local=local, with_dirs=with_dirs,
            )
            rcol_parts.append(rcol)
            if with_dirs:
                dst = words_host[
                    row_base // DIR_ROWS_PER_WORD:
                    (row_base + rows_here) // DIR_ROWS_PER_WORD,
                    strip_off:strip_off + strip_cols,
                ]
                if staged is None:
                    dst[...] = words.numpy()
                else:
                    staged.put(words, dst)
            del words  # one block's words on the device at a time
        strip_states.append(state.tolist())
        if c + 1 < num_strips:
            left_col = torch.cat(rcol_parts)

    if staged is not None:
        staged.flush()

    if local:
        best, bi, bj = 0, 0, 0
        for s_best, s_bi, s_bj, _ in strip_states:
            if s_best > best or (s_best == best and s_best > 0
                                 and (s_bi, s_bj) < (bi, bj)):
                best, bi, bj = s_best, s_bi, s_bj
        score = best
    else:
        score = max(s[3] for s in strip_states)
        bi, bj = m, n
    return TiledResult(score=score, best_i=bi, best_j=bj, words=words_host,
                       p_cols=total_p)


class _Staging:
    """One pinned block of words between the device and the host array.

    ``put`` first copies the block staged before into its place in the
    host array (the device is then running the K5 launch just queued),
    then queues this block's device-to-host copy into the buffer.
    ``flush`` places the last block."""

    def __init__(self, word_rows: int, cols: int):
        self.buf = torch.empty((word_rows, cols), dtype=torch.int32,
                               pin_memory=True)
        self.pending = None

    def put(self, words, dst):
        self.flush()
        rows = words.shape[0]
        self.buf[:rows].copy_(words, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(words.device))
        self.pending = (dst, rows, done)

    def flush(self):
        if self.pending is not None:
            dst, rows, done = self.pending
            done.synchronize()
            dst[...] = self.buf[:rows].numpy()
            self.pending = None


def tiled_fill_score(text, pattern, score_matrix, k_alpha: int, gap: int,
                     local: bool = False,
                     strip_cols: int = DEFAULT_STRIP_COLS,
                     device=None) -> int:
    """Score-only tiled fill: no words, O(strip) device memory, row
    blocks of MAX_CHUNK_ROWS."""
    return tiled_fill(
        text, pattern, score_matrix, k_alpha, gap, local=local,
        with_dirs=False, strip_cols=strip_cols, block_rows=1 << 30,
        device=device,
    ).score
