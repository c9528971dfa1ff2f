"""Tracebacks that end on the host: the strip engine's walk on the device
(``run_device_traceback``, the JAX package's function of that name) and
the replay of an affine (Gotoh) walk's moves into the aligned index
arrays (its ``emit_moves_affine``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..native import bindings
from .batch_traceback import walk_packed
from .walk import unpack_moves

_LEFT, _TOP = 0, 2


def emit_moves_affine(moves: np.ndarray, start_i: int, start_j: int,
                      text: np.ndarray, pattern: np.ndarray,
                      gap_index: int):
    """Replay an affine move list (walk order) into aligned index arrays.

    The affine oracle emits straight from the walk cursor with no clamp
    quirks (oracle.cpp sa_align_affine): at each move, the text letter is
    text[j-1] unless the move is TOP, the pattern letter pattern[i-1]
    unless LEFT; the start offsets are the final (j, i) floored at 0.
    Returns (aligned_text_idx, aligned_pattern_idx, start_text,
    start_pattern).
    """
    moves = np.asarray(moves, dtype=np.int64)
    text = np.asarray(text)
    pattern = np.asarray(pattern)
    if moves.size == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                max(start_j, 0), max(start_i, 0))
    take_t = moves != _TOP
    take_p = moves != _LEFT
    j_pos = start_j - np.concatenate([[0], np.cumsum(take_t[:-1])])
    i_pos = start_i - np.concatenate([[0], np.cumsum(take_p[:-1])])
    at = np.where(take_t, text[np.maximum(j_pos - 1, 0)],
                  gap_index).astype(np.uint8)
    ap = np.where(take_p, pattern[np.maximum(i_pos - 1, 0)],
                  gap_index).astype(np.uint8)
    final_j = int(start_j - take_t.sum())
    final_i = int(start_i - take_p.sum())
    return at[::-1].copy(), ap[::-1].copy(), max(final_j, 0), max(final_i, 0)


def run_device_traceback(words, text, pattern, n, m, best_i, best_j,
                         alphabet_size: int, local: bool, device=None):
    """Walk the strip engine's packed words (W, P) on the device and
    replay the moves on the host.

    ``words`` is a tensor (walked where it lies: a single region's words
    stay on the device) or a numpy array (the tiled fill's host words,
    uploaded to ``device``, default ``config.device()``).  K4 walks from
    (m, n) (global) or (best_i, best_j) (local); only the moves come
    back, and the native ``emit_moves`` replays them.  Returns
    (aligned_text_idx, aligned_pattern_idx, start_text, start_pattern),
    as the JAX package's ``run_device_traceback`` does.
    """
    if not isinstance(words, torch.Tensor):
        words = torch.from_numpy(
            np.ascontiguousarray(words, dtype=np.int32)
        ).to(device or config.device())
    n, m, best_i, best_j = int(n), int(m), int(best_i), int(best_j)
    max_len = max(16, -(-(n + m) // 16) * 16)
    packed, stats = walk_packed(words, n, m, best_i, best_j, local, max_len)
    count = int(stats[0])
    moves = unpack_moves(packed[:-(-count // 16)].cpu().numpy(), count)
    start_i, start_j = (best_i, best_j) if local else (m, n)
    return bindings.emit_moves(moves, start_i, start_j, local, text, pattern,
                               alphabet_size)
