"""Per-pair batch traceback walk (K4): wrapper and plain version.

Every pair of a batch is walked over K3's direction words
(``batch_fill.batch_fill_dirs``, JAX layout (tiles, M/16, N,
tile_pairs/128, 128)).  The walk starts at (ms, ns) for global and at
(bis, bjs) for local and semi-global, reads the direction of cell
(max(i,1), max(j,1)), forces TOP in column 0 and LEFT in row 0 for
global and semi, and stops on STOP without recording it for local.  It
lives while i > 0 and j > 0 (local), i > 0 (semi) or i > 0 or j > 0
(global), and stops at max_len moves, the end of its buffer — the TPU
walker's stop (the JAX lockstep walk clamps its step there instead; the
two differ only on a path longer than the buffer).  Move k of pair p
sits at bits 2*(k%16) of packed word (k//16, p); words past a pair's
last move are 0.  A start outside the words walks no move.

With ``dirs2``, K3's affine run bits, the walk is the three-state Gotoh
walk of the JAX ``batch_device_traceback(dirs2=...)``: in state H a
LEFT/TOP move whose cell has its run bit set enters the E/F run; inside
a run the move is forced (LEFT in E, TOP in F) before the global/semi
edge overrides; local stops on STOP only in state H.

``batch_walk`` launches the CUDA kernel (``csrc/batch_walk.cu``) for
tensors on a CUDA device and runs ``batch_walk_plain``, the lockstep
walk of the JAX ``batch_device_traceback``, for tensors on the CPU.

``walk_packed`` walks one pair over the strip engine's (W, P) words
(``strip_fill``, ``tiled_fill``) with the same kernel: one tile of one
pair, so word (w, p) is read at w * P + p, the K4 address with
tile_pairs = 1.  The walk's edge overrides and stop rules are those of
the JAX ``ops/traceback.py::device_traceback``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, library
from .batch_fill import DIR_ROWS_PER_WORD, mode_code

_LEFT, _DIAG, _TOP, _STOP = 0, 1, 2, 3


def _check(dirs, ns, ms, bis, bjs, local, semi, max_len, dirs2=None):
    if local and semi:
        raise ValueError("local and semi are exclusive")
    if dirs.dtype != torch.int32 or dirs.dim() != 5 or dirs.shape[4] != 128:
        raise ValueError("dirs must be an int32 (tiles, M/16, N, "
                         "tile_pairs/128, 128) tensor")
    if not dirs.is_contiguous():
        raise ValueError("dirs must be contiguous")
    if dirs2 is not None and (
            dirs2.dtype != torch.int32 or dirs2.shape != dirs.shape
            or dirs2.device != dirs.device or not dirs2.is_contiguous()):
        raise ValueError("dirs2 must be a contiguous int32 tensor shaped "
                         "like dirs, on its device")
    tiles, _, _, sub_rows, _ = dirs.shape
    b = tiles * sub_rows * 128
    for name, x in (("ns", ns), ("ms", ms), ("bis", bis), ("bjs", bjs)):
        if x.device != dirs.device:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{dirs.device}")
        if x.dtype != torch.int32 or tuple(x.shape) != (b,):
            raise ValueError(f"{name} must be ({b},) int32")
    if max_len < 16 or max_len % 16:
        raise ValueError(f"max_len must be a positive multiple of 16, "
                         f"got {max_len}")
    if dirs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batch_walk runs on cuda or cpu, not "
                         f"{dirs.device}")


def batch_walk(dirs, ns, ms, bis, bjs, local: bool, semi: bool,
               max_len: int, dirs2=None):
    """Walk every pair of the batch (affine with ``dirs2``).

    Returns (packed, lengths, i, j) on the words' device: packed is
    (max_len/16, B) int32 moves, lengths (B,) the move counts, and i, j
    (B,) the final cursors (semi's start offset in the text is j).
    """
    _check(dirs, ns, ms, bis, bjs, local, semi, max_len, dirs2)
    if dirs.device.type == "cpu":
        return batch_walk_plain(dirs, ns, ms, bis, bjs, local, semi,
                                max_len, dirs2=dirs2)
    launch, out = kernel_launch(dirs, ns, ms, bis, bjs, local, semi, max_len,
                                dirs2=dirs2)
    launch()
    batch_walk.launches += 1
    return out


batch_walk.launches = 0


def _kernel():
    fn = library("batch_walk").sa_batch_walk
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 6 + [ctypes.c_int64, i, i, i, i,
                                  ctypes.c_int64] + [p] * 5)
        fn.restype = ctypes.c_int
    return fn


def kernel_launch(dirs, ns, ms, bis, bjs, local: bool, semi: bool,
                  max_len: int, dirs2=None):
    """K4 on the words' CUDA device, ready to launch: the outputs
    allocated, the move words zeroed.  Returns (launch, (packed, lengths,
    i, j)); each ``launch()`` runs the kernel once on the current stream
    (a second run writes the same words), raising if the launch failed,
    and counts nothing (``batch_walk`` counts its launches)."""
    _, num_w, n_cols, sub_rows, _ = dirs.shape
    return _launcher(dirs, num_w, n_cols, sub_rows * 128, ns, ms, bis, bjs,
                     local, semi, max_len, dirs2)


def _launcher(dirs, num_w, n_cols, tile_pairs, ns, ms, bis, bjs, local,
              semi, max_len, dirs2=None):
    """``kernel_launch`` over words of any tile geometry: dirs (and
    dirs2) hold (B/tile_pairs, num_w, n_cols, tile_pairs) int32 in that
    order."""
    device = dirs.device
    b = ns.shape[0]
    i32 = torch.int32
    packed = torch.zeros((max_len // 16, b), dtype=i32, device=device)
    lengths = torch.empty(b, dtype=i32, device=device)
    fi = torch.empty(b, dtype=i32, device=device)
    fj = torch.empty(b, dtype=i32, device=device)
    ns, ms, bis, bjs = (x.contiguous() for x in (ns, ms, bis, bjs))

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _kernel()(
                dirs.data_ptr(),
                None if dirs2 is None else dirs2.data_ptr(),
                ns.data_ptr(), ms.data_ptr(),
                bis.data_ptr(), bjs.data_ptr(), b, num_w, n_cols,
                tile_pairs, mode_code(local, semi), max_len,
                packed.data_ptr(), lengths.data_ptr(), fi.data_ptr(),
                fj.data_ptr(), stream,
            )
        check_launch("batch_walk", rc)

    return launch, (packed, lengths, fi, fj)


def batch_walk_plain(dirs, ns, ms, bis, bjs, local: bool, semi: bool,
                     max_len: int, dirs2=None):
    """Plain PyTorch version of ``batch_walk``: all pairs walk in
    lockstep, one gathered word a live pair a step (a pair moves on a
    prefix of the steps, so its k-th move is made at step k), on the
    words' device, with identical outputs."""
    _, num_w, n_cols, sub_rows, _ = dirs.shape
    return _walk_plain(dirs.reshape(-1), num_w, n_cols, sub_rows * 128, ns,
                       ms, bis, bjs, local, semi, max_len,
                       None if dirs2 is None else dirs2.reshape(-1))


def _walk_plain(flat, num_w, n_cols, tile_pairs, ns, ms, bis, bjs, local,
                semi, max_len, flat2=None):
    """``batch_walk_plain`` over flat words of any tile geometry (flat2:
    the affine run bits, or None)."""
    device = flat.device
    b = ns.shape[0]
    pair = torch.arange(b, device=device)
    base = (pair // tile_pairs) * (num_w * n_cols * tile_pairs) \
        + pair % tile_pairs
    if local or semi:
        i, j = bis.long(), bjs.long()
    else:
        i, j = ms.long(), ns.long()

    def lives(i, j):
        if local:
            return (i > 0) & (j > 0)
        if semi:
            return i > 0
        return (i > 0) | (j > 0)

    inside = (i >= 0) & (i <= num_w * DIR_ROWS_PER_WORD) & (j >= 0) \
        & (j <= n_cols)
    alive = inside & lives(i, j)
    packed = torch.zeros((max_len // 16, b), dtype=torch.int32,
                         device=device)
    k = torch.zeros(b, dtype=torch.int64, device=device)
    state = torch.zeros(b, dtype=torch.int64, device=device)
    for step in range(max_len):
        if not bool(alive.any()):
            break
        ic = i.clamp(min=1) - 1
        jc = j.clamp(min=1) - 1
        at = base + ((ic // DIR_ROWS_PER_WORD) * n_cols + jc) * tile_pairs
        at = torch.where(alive, at, base)
        bit = 2 * (ic % DIR_ROWS_PER_WORD)
        d = (flat[at] >> bit) & 3
        if flat2 is not None:  # inside a gap run the move is forced
            d = torch.where(state == 1, _LEFT,
                            torch.where(state == 2, _TOP, d))
        if local:
            emit = alive & (d != _STOP)  # never STOP inside a run
        else:
            d = torch.where(j == 0, _TOP, torch.where(i == 0, _LEFT, d))
            emit = alive
        if flat2 is not None:
            runs = (flat2[at] >> bit) & 3
            run_e = (d == _LEFT) & ((runs & 1) != 0)
            run_f = (d == _TOP) & ((runs & 2) != 0)
            state = torch.where(emit, torch.where(
                run_e, 1, torch.where(run_f, 2, 0)), state)
        shift = 2 * (step % 16)
        packed[step // 16] |= torch.where(emit, d, 0).to(torch.int32) << shift
        k += emit
        i = i - (emit & ((d == _DIAG) | (d == _TOP))).long()
        j = j - (emit & ((d == _DIAG) | (d == _LEFT))).long()
        alive = emit & lives(i, j)
    i32 = torch.int32
    return packed, k.to(i32), i.to(i32), j.to(i32)


def _check_packed(words, n, m, bi, bj, local, max_len):
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be an int32 (W, P) tensor")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"walk_packed runs on cuda or cpu, not "
                         f"{words.device}")
    num_w, n_cols = words.shape
    i0, j0 = (bi, bj) if local else (m, n)
    if not (0 <= i0 <= num_w * DIR_ROWS_PER_WORD and 0 <= j0 <= n_cols):
        raise ValueError(f"start ({i0}, {j0}) lies outside words of "
                         f"{num_w * DIR_ROWS_PER_WORD} rows x {n_cols} "
                         f"columns")
    if max_len < 16 or max_len % 16:
        raise ValueError(f"max_len must be a positive multiple of 16, "
                         f"got {max_len}")


def walk_packed(words, n: int, m: int, bi: int, bj: int, local: bool,
                max_len: int):
    """Walk one pair over the strip engine's words (W, P) from (m, n)
    (global) or (bi, bj) (local), with K4 on a CUDA device or its plain
    version on the CPU; a launch counts in ``batch_walk.launches``.

    Returns (packed, stats) on the words' device: packed (max_len/16,)
    int32 moves in walk order, stats (3,) int32 [moves, i, j] with the
    final cursor.
    """
    _check_packed(words, n, m, bi, bj, local, max_len)
    num_w, n_cols = words.shape
    one = [torch.tensor([x], dtype=torch.int32, device=words.device)
           for x in (n, m, bi, bj)]
    if words.device.type == "cpu":
        packed, lengths, i, j = _walk_plain(
            words.reshape(-1), num_w, n_cols, 1, *one, local, False,
            max_len)
    else:
        launch, (packed, lengths, i, j) = _launcher(
            words, num_w, n_cols, 1, *one, local, False, max_len)
        launch()
        batch_walk.launches += 1
    return packed[:, 0], torch.cat([lengths, i, j])
