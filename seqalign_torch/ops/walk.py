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
the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_launch, library

_LEFT, _DIAG, _TOP, _STOP = 0, 1, 2, 3


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
    the kernel once on the current stream, raising if the launch failed,
    and counts nothing (the wrapper counts its launches)."""
    device = words.device
    move_words = -(-max_moves // 16)
    moves = torch.empty(max(move_words, 1), dtype=torch.int32, device=device)
    result = torch.empty(5, dtype=torch.int32, device=device)

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _kernel()(
                words.data_ptr(),
                None if words2 is None else words2.data_ptr(), rps,
                words.shape[1] * 128, int(row_lo), int(col_lo), int(i0),
                int(j0), int(state0), int(local), moves.data_ptr(),
                move_words, result.data_ptr(), stream,
            )
        check_launch("walk", rc)

    return launch, (moves, result)


def _kernel():
    fn = library("walk").sa_walk_skewed
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p, ctypes.c_int64, p, p]
        fn.restype = ctypes.c_int
    return fn


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
