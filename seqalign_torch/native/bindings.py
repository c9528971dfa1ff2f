"""ctypes bindings for the native oracle library (``oracle.cpp``).

Exposes the C-ABI entry points the port needs as numpy-friendly Python
functions.  All sequence inputs are int8 alphabet-index arrays; aligned
outputs come back as uint8 index arrays (gap == alphabet_size).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .build import ensure_built

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        pi64 = ctypes.POINTER(ctypes.c_int64)
        pi32 = ctypes.POINTER(ctypes.c_int32)

        lib.sa_align.restype = i32
        lib.sa_align.argtypes = [
            i32, i8p, i64, i8p, i64, i32p, i32, i32,
            u8p, u8p, pi64, pi64, pi64, pi32,
        ]
        lib.sa_fill.restype = i32
        lib.sa_fill.argtypes = [
            i32, i8p, i64, i8p, i64, i32p, i32, i32, u8p, pi32, pi64,
        ]
        lib.sa_traceback_nw_skewed.restype = None
        lib.sa_traceback_nw_skewed.argtypes = [
            i32p, i64, i64, i64, i64, i64, i8p, i8p, i32,
            u8p, u8p, pi64, pi64, pi64,
        ]
        lib.sa_traceback_sw_skewed.restype = None
        lib.sa_traceback_sw_skewed.argtypes = [
            i32p, i64, i64, i64, i64, i64, i8p, i8p, i32,
            u8p, u8p, pi64, pi64, pi64,
        ]
        for name in ("sa_traceback_nw_packed", "sa_traceback_sw_packed"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                i32p, i64, i64, i64, i8p, i8p, i32,
                u8p, u8p, pi64, pi64, pi64,
            ]
        lib.sa_fill_affine.restype = i32
        lib.sa_fill_affine.argtypes = [
            i32, i8p, i64, i8p, i64, i32p, i32, i32, i32, pi32, pi64,
        ]
        lib.sa_align_affine.restype = i32
        lib.sa_align_affine.argtypes = [
            i32, i8p, i64, i8p, i64, i32p, i32, i32, i32,
            u8p, u8p, pi64, pi64, pi64, pi32,
        ]
        lib.sa_emit_moves.restype = None
        lib.sa_emit_moves.argtypes = [
            u8p, i64, i64, i64, i32, i8p, i8p, i32,
            u8p, u8p, pi64, pi64, pi64,
        ]
        lib.sa_emit_moves_batch.restype = None
        lib.sa_emit_moves_batch.argtypes = [
            i32p, i64, i32p, i32p, i32p, i32, i8p, i64, i8p, i64,
            i32, i64, i64, u8p, u8p, i32p, i32p,
        ]
        _lib = lib
    return _lib


def _as_i8(seq: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(seq, dtype=np.int8)


def _as_matrix(score_matrix: np.ndarray, k: int) -> np.ndarray:
    m = np.ascontiguousarray(score_matrix, dtype=np.int32).reshape(-1)
    return m[: k * k]


def oracle_align(
    algo: int,
    text: np.ndarray,
    pattern: np.ndarray,
    score_matrix: np.ndarray,
    alphabet_size: int,
    gap_penalty: int,
) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Full native alignment.

    Returns (aligned_text_idx, aligned_pattern_idx, start_text,
    start_pattern, score).  ``algo``: 0 global, 1 local, 2 semi-global.
    """
    lib = _library()
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    n, m = text.shape[0], pattern.shape[0]
    out_text = np.empty(n + m + 1, dtype=np.uint8)
    out_pattern = np.empty(n + m + 1, dtype=np.uint8)
    out_len = ctypes.c_int64()
    out_st = ctypes.c_int64()
    out_sp = ctypes.c_int64()
    out_score = ctypes.c_int32()
    rc = lib.sa_align(
        algo, text, n, pattern, m,
        _as_matrix(score_matrix, alphabet_size), alphabet_size, gap_penalty,
        out_text, out_pattern,
        ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        ctypes.byref(out_score),
    )
    if rc != 0:
        raise MemoryError("native oracle: allocation failed")
    k = out_len.value
    return (
        out_text[:k].copy(),
        out_pattern[:k].copy(),
        out_st.value,
        out_sp.value,
        out_score.value,
    )


def oracle_fill(
    algo: int,
    text: np.ndarray,
    pattern: np.ndarray,
    score_matrix: np.ndarray,
    alphabet_size: int,
    gap_penalty: int,
) -> Tuple[np.ndarray, int, int]:
    """DP fill only.  Returns (direction matrix (m+1, n+1) uint8, score,
    best_idx)."""
    lib = _library()
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    n, m = text.shape[0], pattern.shape[0]
    dirs = np.empty((m + 1, n + 1), dtype=np.uint8)
    out_score = ctypes.c_int32()
    out_best = ctypes.c_int64()
    rc = lib.sa_fill(
        algo, text, n, pattern, m,
        _as_matrix(score_matrix, alphabet_size), alphabet_size, gap_penalty,
        dirs.reshape(-1), ctypes.byref(out_score), ctypes.byref(out_best),
    )
    if rc != 0:
        raise MemoryError("native oracle: allocation failed")
    return dirs, out_score.value, out_best.value


def oracle_align_affine(
    algo: int,
    text: np.ndarray,
    pattern: np.ndarray,
    score_matrix: np.ndarray,
    alphabet_size: int,
    gap_open: int,
    gap_extend: int,
) -> Tuple[np.ndarray, np.ndarray, int, int, int]:
    """Full affine-gap (Gotoh) alignment: a gap run of length L costs
    open + (L-1)*extend.  Returns (aligned_text_idx, aligned_pattern_idx,
    start_text, start_pattern, score)."""
    lib = _library()
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    n, m = text.shape[0], pattern.shape[0]
    out_text = np.empty(n + m + 1, dtype=np.uint8)
    out_pattern = np.empty(n + m + 1, dtype=np.uint8)
    out_len = ctypes.c_int64()
    out_st = ctypes.c_int64()
    out_sp = ctypes.c_int64()
    out_score = ctypes.c_int32()
    rc = lib.sa_align_affine(
        algo, text, n, pattern, m,
        _as_matrix(score_matrix, alphabet_size), alphabet_size,
        gap_open, gap_extend,
        out_text, out_pattern,
        ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        ctypes.byref(out_score),
    )
    if rc != 0:
        raise MemoryError("native oracle: allocation failed")
    k = out_len.value
    return (
        out_text[:k].copy(),
        out_pattern[:k].copy(),
        out_st.value,
        out_sp.value,
        out_score.value,
    )


def oracle_fill_affine(
    algo: int,
    text: np.ndarray,
    pattern: np.ndarray,
    score_matrix: np.ndarray,
    alphabet_size: int,
    gap_open: int,
    gap_extend: int,
) -> Tuple[int, int]:
    """Affine-gap score-only fill in O(n) memory.  With gap_extend ==
    gap_open it is the linear-gap score.  Returns (score, best_flat_idx):
    the first row-major best cell for local, the first best cell of the
    last row for semi-global, 0 for global."""
    lib = _library()
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    out_score = ctypes.c_int32()
    out_best = ctypes.c_int64()
    rc = lib.sa_fill_affine(
        algo, text, text.shape[0], pattern, pattern.shape[0],
        _as_matrix(score_matrix, alphabet_size), alphabet_size,
        gap_open, gap_extend,
        ctypes.byref(out_score), ctypes.byref(out_best),
    )
    if rc != 0:
        raise MemoryError("native oracle: allocation failed")
    return out_score.value, out_best.value


def traceback_skewed(
    algo: int,
    words: np.ndarray,
    steps_pad: int,
    text: np.ndarray,
    pattern: np.ndarray,
    alphabet_size: int,
    best_i: int = 0,
    best_j: int = 0,
    rps: int = 8,
    slots: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Traceback over the wavefront kernel's skewed word format.

    ``words`` is (num_strips, steps_pad/16 * rps, slots) int32.  algo 0
    walks from (m, n) (global); any other value walks from (best_i,
    best_j) with the local stop rules.
    """
    lib = _library()
    words = np.ascontiguousarray(words, dtype=np.int32)
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    n, m = text.shape[0], pattern.shape[0]
    out_text = np.empty(n + m + 1, dtype=np.uint8)
    out_pattern = np.empty(n + m + 1, dtype=np.uint8)
    out_len = ctypes.c_int64()
    out_st = ctypes.c_int64()
    out_sp = ctypes.c_int64()
    flat = words.reshape(-1)
    if algo == 0:
        lib.sa_traceback_nw_skewed(
            flat, steps_pad, rps, slots, n, m, text, pattern, alphabet_size,
            out_text, out_pattern,
            ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        )
    else:
        lib.sa_traceback_sw_skewed(
            flat, steps_pad, rps, slots, best_i, best_j, text, pattern,
            alphabet_size,
            out_text, out_pattern,
            ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        )
    k = out_len.value
    return out_text[:k].copy(), out_pattern[:k].copy(), out_st.value, out_sp.value


def traceback_packed(
    algo: int,
    words: np.ndarray,
    text: np.ndarray,
    pattern: np.ndarray,
    alphabet_size: int,
    best_i: int = 0,
    best_j: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Traceback over the strip engine's packed direction words.

    ``words`` is (num_word_rows, P) int32 — word row w, column position
    p holds the directions of DP rows 16w+1..16w+16 at column p+1.
    For algo 0 (global) the walk starts at (m, n); for algo 1 (local) at
    (best_i, best_j).
    """
    lib = _library()
    words = np.ascontiguousarray(words, dtype=np.int32)
    if words.ndim == 3:
        words = words.reshape(words.shape[0], -1)
    p_cols = words.shape[1]
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    n, m = text.shape[0], pattern.shape[0]
    out_text = np.empty(n + m + 1, dtype=np.uint8)
    out_pattern = np.empty(n + m + 1, dtype=np.uint8)
    out_len = ctypes.c_int64()
    out_st = ctypes.c_int64()
    out_sp = ctypes.c_int64()
    flat = words.reshape(-1)
    if algo == 0:
        lib.sa_traceback_nw_packed(
            flat, p_cols, n, m, text, pattern, alphabet_size,
            out_text, out_pattern,
            ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        )
    else:
        lib.sa_traceback_sw_packed(
            flat, p_cols, best_i, best_j, text, pattern, alphabet_size,
            out_text, out_pattern,
            ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
        )
    k = out_len.value
    return out_text[:k].copy(), out_pattern[:k].copy(), out_st.value, out_sp.value


def emit_moves(
    moves: np.ndarray,
    start_i: int,
    start_j: int,
    local: bool,
    text: np.ndarray,
    pattern: np.ndarray,
    alphabet_size: int,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Replay a move list recorded in walk (end-to-start) order into
    aligned index arrays; see oracle.cpp sa_emit_moves.  Returns
    (aligned_text_idx, aligned_pattern_idx, start_text, start_pattern)."""
    lib = _library()
    moves = np.ascontiguousarray(moves, dtype=np.uint8)
    text = _as_i8(text)
    pattern = _as_i8(pattern)
    out_text = np.empty(max(moves.shape[0], 1), dtype=np.uint8)
    out_pattern = np.empty(max(moves.shape[0], 1), dtype=np.uint8)
    out_len = ctypes.c_int64()
    out_st = ctypes.c_int64()
    out_sp = ctypes.c_int64()
    lib.sa_emit_moves(
        moves, moves.shape[0], start_i, start_j, 1 if local else 0,
        text, pattern, alphabet_size, out_text, out_pattern,
        ctypes.byref(out_len), ctypes.byref(out_st), ctypes.byref(out_sp),
    )
    k = out_len.value
    return out_text[:k].copy(), out_pattern[:k].copy(), out_st.value, out_sp.value


def emit_moves_batch(
    packed: np.ndarray,
    lens: np.ndarray,
    start_is: np.ndarray,
    start_js: np.ndarray,
    mode: int,
    texts: np.ndarray,
    patterns: np.ndarray,
    alphabet_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Replay a whole bucket's packed move lists in one native call.

    packed: (B, words_per_pair) pair-major int32 move words (the device
    walkers' 2-bit layout); texts/patterns: padded (B, n)/(B, m) int8
    letter matrices; mode: 0 global, 1 local, 2 affine (see oracle.cpp
    sa_emit_moves_batch).  Returns (aligned_text, aligned_pattern,
    start_text, start_pattern) where the aligned arrays are
    (B, 16*words_per_pair) uint8 rows — row r's alignment is the first
    lens[r] entries.
    """
    lib = _library()
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    b, words = packed.shape
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    start_is = np.ascontiguousarray(start_is, dtype=np.int32)
    start_js = np.ascontiguousarray(start_js, dtype=np.int32)
    texts = np.ascontiguousarray(texts, dtype=np.int8)
    patterns = np.ascontiguousarray(patterns, dtype=np.int8)
    out_stride = 16 * words
    out_text = np.empty((b, out_stride), dtype=np.uint8)
    out_pattern = np.empty((b, out_stride), dtype=np.uint8)
    out_st = np.empty(b, dtype=np.int32)
    out_sp = np.empty(b, dtype=np.int32)
    lib.sa_emit_moves_batch(
        packed, words, lens, start_is, start_js, mode,
        texts, texts.shape[1], patterns, patterns.shape[1],
        alphabet_size, b, out_stride, out_text, out_pattern,
        out_st, out_sp,
    )
    return out_text, out_pattern, out_st, out_sp
