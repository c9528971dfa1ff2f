"""Traceback walker over skewed direction words (K2): wrapper, plain
version and move unpacking.

The walk starts at a cell and follows K1's stored directions while it
stays inside the tile (rows > row_lo, columns > col_lo).  Local walks
stop on STOP and after a move that reaches row 0 or column 0.  Move p is
packed at bits 2*(p%16) of move word p//16 — the JAX walker's layout.
Affine (Gotoh) walks also read K1's run-bit plane ``words2`` and carry a
gap state (0 in H, 1 in an E run, 2 in an F run) from move to move and,
through ``state0`` and the result, from tile to tile.

``walk_skewed_window`` launches the CUDA kernel (``csrc/walk.cu``) for
words on a CUDA device and runs ``walk_skewed_window_plain`` for words on
the CPU.  The kernel walks from windows of the words staged in shared
memory: ``window_shape`` gives a window's slots and word groups at each
rps, the shape the kernel fixes at compile time.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import c_function, check_launch, int_function, library

_LEFT, _DIAG, _TOP, _STOP = 0, 1, 2, 3

# K2's window (csrc/walk.cu's window_slots, window_groups) by rps:
# (slots, word groups) linear and affine.  A window holds all rps rows of
# its slots, 16 sweep steps a group: 512 rows x 512 steps linear, 256 x
# 512 affine (two planes), 128 KB of shared memory for its two buffers.
WINDOW_SHAPES = {rps: {False: (512 // rps, 32), True: (256 // rps, 32)}
                 for rps in (1, 2, 4, 8, 16)}


def window_shape(rps: int, affine: bool) -> tuple[int, int]:
    """(slots, word groups) of K2's window for words of ``rps`` rows a
    slot, linear or affine; ValueError for an rps the kernel has no
    window for."""
    if rps not in WINDOW_SHAPES:
        raise ValueError(f"K2 walks words of rps 1, 2, 4, 8 or 16, not {rps}")
    return WINDOW_SHAPES[rps][bool(affine)]


def _check(words, rps, row_lo, col_lo, i0, j0, max_moves, words2=None,
           state0=0):
    if words.dtype != torch.int32 or words.dim() != 3:
        raise ValueError("words must be an int32 (W, slots/128, 128) tensor")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words2 is None:
        if state0 != 0:
            raise ValueError("a linear walk (no words2) starts in state 0")
    elif (words2.dtype != torch.int32 or words2.shape != words.shape
          or words2.device != words.device or not words2.is_contiguous()):
        raise ValueError("words2 must be a contiguous int32 tensor shaped "
                         "like words, on its device")
    if state0 not in (0, 1, 2):
        raise ValueError(f"state0 must be 0, 1 or 2, got {state0}")
    if row_lo < 0 or col_lo < 0:
        raise ValueError("row_lo and col_lo must be >= 0")
    w_rows, srows, lanes = words.shape
    if lanes != 128 or rps < 1 or w_rows % rps:
        raise ValueError(f"words of shape {tuple(words.shape)} do not hold "
                         f"whole groups of rps={rps} rows")
    if max_moves < 0:
        raise ValueError("max_moves must be >= 0")
    slots = srows * 128
    if i0 > row_lo and j0 > col_lo:
        # The walk's sweep step only decreases, so its first read is its
        # furthest one.
        if i0 - row_lo > rps * slots:
            raise ValueError(f"start row {i0} is outside the strip")
        t = (j0 - col_lo - 1) + (i0 - row_lo - 1) // rps
        if (t // 16) * rps >= w_rows:
            raise ValueError(f"start column {j0} is outside the words")


def walk_skewed_window(words, rps: int, row_lo: int, col_lo: int, i0: int,
                       j0: int, local: bool, max_moves: int, words2=None,
                       state0: int = 0):
    """Walk the skewed words from (i0, j0), affine with ``words2`` (K1's
    run bits) from gap state ``state0``.

    Returns (moves, result) on the words' device: moves is
    (ceil(max_moves/16),) int32 packed moves, result (5,) int32 = count,
    i, j, state (always 0 for a linear walk), done.  The walk stops at
    the end of the move buffer with done = 0.
    """
    _check(words, rps, row_lo, col_lo, i0, j0, max_moves, words2, state0)
    device = words.device
    if device.type == "cpu":
        return walk_skewed_window_plain(words, rps, row_lo, col_lo, i0, j0,
                                        local, max_moves, words2, state0)
    if device.type != "cuda":
        raise ValueError(f"walk_skewed_window runs on cuda or cpu, "
                         f"not {device}")
    launch, out = kernel_launch(words, rps, row_lo, col_lo, i0, j0, local,
                                max_moves, words2, state0)
    launch()
    walk_skewed_window.launches += 1
    return out


walk_skewed_window.launches = 0


def kernel_launch(words, rps, row_lo, col_lo, i0, j0, local, max_moves,
                  words2=None, state0=0):
    """K2 on the words' CUDA device, ready to launch: the outputs
    allocated.  Returns (launch, (moves, result)); each ``launch()`` runs
    the kernel once on the current stream, raising if the launch failed
    (its shared memory refused, say), and counts nothing (the wrapper
    counts its launches)."""
    return shape_launch(library("walk"), None, words, rps, row_lo, col_lo,
                        i0, j0, local, max_moves, words2, state0)


def shape_launch(lib, shape, words, rps, row_lo, col_lo, i0, j0, local,
                 max_moves, words2=None, state0=0, trace=None):
    """``kernel_launch`` through ``lib``, a build of ``csrc/walk.cu``:
    ``shape`` None calls ``sa_walk_skewed`` at the window of
    ``window_shape``; ``shape`` = (slots, groups) calls the all-shapes
    build's ``sa_walk_skewed_shape`` with that window and ``trace`` (None,
    or an int64 tensor of 9 the walker fills)."""
    window_shape(rps, words2 is not None)
    for x in (words, words2):
        if x is not None and x.data_ptr() % 16:
            raise ValueError("K2 loads the words in 16-byte chunks: they "
                             "must be 16-byte aligned")
    device = words.device
    move_words = -(-max_moves // 16)
    moves = torch.empty(max(move_words, 1), dtype=torch.int32, device=device)
    result = torch.empty(5, dtype=torch.int32, device=device)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p] + [i] * 8 + [p, ctypes.c_int64, p]
    if shape is None:
        fn = c_function(lib, "sa_walk_skewed", head + [p])
        tail = ()
    else:
        fn = c_function(lib, "sa_walk_skewed_shape", head + [i, i, p, p])
        tail = (*shape, None if trace is None else trace.data_ptr())

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(
                words.data_ptr(),
                None if words2 is None else words2.data_ptr(), rps,
                words.shape[1] * 128, int(row_lo), int(col_lo), int(i0),
                int(j0), int(state0), int(local), moves.data_ptr(),
                move_words, result.data_ptr(), *tail, stream,
            )
        check_launch("walk", rc)

    return launch, (moves, result)


def library_window_shape(lib, rps: int, affine: bool) -> tuple[int, int]:
    """(slots, word groups) of the window the build ``lib`` of
    ``csrc/walk.cu`` fixes at this rps and variant ((0, 0): none)."""
    return tuple(int_function(lib, f"sa_walk_window_{name}", 2)(
        rps, int(affine)) for name in ("slots", "groups"))


def walk_skewed_window_plain(words, rps: int, row_lo: int, col_lo: int,
                             i0: int, j0: int, local: bool, max_moves: int,
                             words2=None, state0: int = 0):
    """Plain version of ``walk_skewed_window``: the same walk on a host
    copy of the words, results returned on the words' device.  The
    affine walk is the JAX package's ``device_walk_affine_skewed_window``:
    in state 1 the move is LEFT, in state 2 TOP, and the cell's run bit
    decides whether the run goes on."""
    device = words.device
    slots = words.shape[1] * 128
    flat = words.reshape(-1).cpu().numpy()
    flat2 = None if words2 is None else words2.reshape(-1).cpu().numpy()
    move_words = -(-max_moves // 16)
    capacity = move_words * 16
    moves = np.zeros(max(move_words, 1), dtype=np.uint32)
    i, j, st, count, done = int(i0), int(j0), int(state0), 0, False
    while not done and i > row_lo and j > col_lo and count < capacity:
        il = i - row_lo - 1
        s, r = divmod(il, rps)
        t = j - col_lo - 1 + s
        idx = ((t >> 4) * rps + r) * slots + s
        shift = 2 * (t & 15)
        bits = 0 if flat2 is None else (int(flat2[idx]) >> shift) & 3
        if st == 1:  # in an E run: LEFT, whatever the word says
            d = _LEFT
        elif st == 2:  # in an F run: TOP
            d = _TOP
        else:
            d = (int(flat[idx]) >> shift) & 3
        if local and st == 0 and d == _STOP:
            done = True
            break
        moves[count >> 4] |= np.uint32(d << (2 * (count & 15)))
        count += 1
        if d == _LEFT and bits & 1:
            st = 1
        elif d == _TOP and bits & 2:
            st = 2
        else:
            st = 0
        if d in (_DIAG, _TOP):
            i -= 1
        if d in (_DIAG, _LEFT):
            j -= 1
        if local and (i == 0 or j == 0):
            done = True
    result = torch.tensor([count, i, j, st, int(done)], dtype=torch.int32)
    return (torch.from_numpy(moves.view(np.int32)).to(device),
            result.to(device))


def unpack_moves(packed, count: int) -> np.ndarray:
    """(ceil(max/16),) packed int32 -> (count,) uint8 move list (numpy)."""
    packed = np.asarray(packed)
    idx = np.arange(count)
    return ((packed[idx // 16] >> (2 * (idx % 16))) & 3).astype(np.uint8)
