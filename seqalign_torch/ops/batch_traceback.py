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
walk of the JAX ``batch_device_traceback``, for tensors on the CPU.  The
kernel walks one pair a lane and keeps a run of the next ``RUN`` column
words of the pair's word row in flight (cp.async copies into shared
memory), so a walk waits for device memory once a word-row crossing, not
once a move.  What bounds it then is a warp's own chain of instructions
an iteration (a lane's move and copy, ≈ 0.3 µs with about 4 warps an
SM) and the restarts; its floor is the 32-byte sectors its words take
from device memory (one a word: a pair's words lie tile_pairs x 4 B
apart).

``walk_packed`` walks one pair over the strip engine's (W, P) words
(``strip_fill``, ``tiled_fill``) with the kernel's single-pair entry
point: one warp walking from a window of ``PACKED_WINDOW`` word rows x
columns staged in shared memory, which six warps load ahead of the path
(K2's protocol); in a step each lane reads one of the next 32 columns of
the cell's word row and the warp makes the LEFT moves at their head at
once, so a step is one chain of a shared-memory load, a ballot and a
shuffle for each move that is not LEFT.  Word (w, p) is read at
w * P + p, the K4 address with tile_pairs = 1; the loaders read 16-byte
chunks, so on a CUDA device P must be a multiple of 4 and the words
16-byte aligned (``check_kernel_words``).  The walk's edge
overrides and stop rules are those of the JAX
``ops/traceback.py::device_traceback``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import c_function, check_launch, int_function, library
from .batch_fill import DIR_ROWS_PER_WORD, mode_code

_LEFT, _DIAG, _TOP, _STOP = 0, 1, 2, 3

# csrc/batch_walk.cu's shapes (sa_batch_walk_shape_of): the batch walk's
# run of column words and most threads a block; the single-pair walk's
# window, word rows x columns (64 KB a buffer, two buffers).
RUN = 4
BATCH_THREADS = 128
PACKED_WINDOW = (16, 1024)


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
    return shape_launch(library("batch_walk"), None, dirs, num_w, n_cols,
                        tile_pairs, ns, ms, bis, bjs, local, semi, max_len,
                        dirs2)


def shape_launch(lib, shape, dirs, num_w, n_cols, tile_pairs, ns, ms, bis,
                 bjs, local, semi, max_len, dirs2=None, trace=None):
    """``_launcher`` through ``lib``, a build of ``csrc/batch_walk.cu``:
    ``shape`` None calls ``sa_batch_walk`` (the run ``RUN``); ``shape`` =
    (run, threads) calls the all-shapes build's ``sa_batch_walk_shape``
    with that run and block (threads 0: the production rule) and
    ``trace`` (None, or an int64 tensor of 9 the walk adds to as uint64,
    entry 6 set to -1)."""
    device = dirs.device
    b = ns.shape[0]
    i32 = torch.int32
    packed = torch.zeros((max_len // 16, b), dtype=i32, device=device)
    lengths = torch.empty(b, dtype=i32, device=device)
    fi = torch.empty(b, dtype=i32, device=device)
    fj = torch.empty(b, dtype=i32, device=device)
    ns, ms, bis, bjs = (x.contiguous() for x in (ns, ms, bis, bjs))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 6 + [ctypes.c_int64, i, i, i, i, ctypes.c_int64] + [p] * 4
    if shape is None:
        fn = c_function(lib, "sa_batch_walk", head + [p])
        tail = ()
    else:
        fn = c_function(lib, "sa_batch_walk_shape", head + [i, i, p, p])
        tail = (*shape, None if trace is None else trace.data_ptr())

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(
                dirs.data_ptr(),
                None if dirs2 is None else dirs2.data_ptr(),
                ns.data_ptr(), ms.data_ptr(),
                bis.data_ptr(), bjs.data_ptr(), b, num_w, n_cols,
                tile_pairs, mode_code(local, semi), max_len,
                packed.data_ptr(), lengths.data_ptr(), fi.data_ptr(),
                fj.data_ptr(), *tail, stream,
            )
        check_launch("batch_walk", rc)

    return launch, (packed, lengths, fi, fj)


def library_shapes(lib) -> dict:
    """The shapes a build ``lib`` of ``csrc/batch_walk.cu`` fixes: the
    batch walk's run and most threads, the single-pair walk's window."""
    fn = int_function(lib, "sa_batch_walk_shape_of", 1)
    return {"run": fn(0), "threads": fn(1), "window": (fn(2), fn(3))}


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
    if words.device.type == "cuda":
        check_kernel_words(words)
    i0, j0 = (bi, bj) if local else (m, n)
    if not (0 <= i0 <= num_w * DIR_ROWS_PER_WORD and 0 <= j0 <= n_cols):
        raise ValueError(f"start ({i0}, {j0}) lies outside words of "
                         f"{num_w * DIR_ROWS_PER_WORD} rows x {n_cols} "
                         f"columns")
    if max_len < 16 or max_len % 16:
        raise ValueError(f"max_len must be a positive multiple of 16, "
                         f"got {max_len}")


def check_kernel_words(words):
    """Raise ValueError unless the single-pair walk's kernel can load
    ``words`` (W, P): its loaders read a window row in 16-byte chunks, so
    P must be a multiple of 4 and the words 16-byte aligned, as the strip
    engine's words (P a multiple of 1,024, their own allocation) are.
    The plain version on the CPU takes any P."""
    if words.shape[1] % 4:
        raise ValueError(f"K4's single-pair walk loads 16-byte chunks: P "
                         f"must be a multiple of 4, got {words.shape[1]}")
    if words.data_ptr() % 16:
        raise ValueError("K4's single-pair walk loads 16-byte chunks: the "
                         "words must be 16-byte aligned")


def walk_packed(words, n: int, m: int, bi: int, bj: int, local: bool,
                max_len: int):
    """Walk one pair over the strip engine's words (W, P) from (m, n)
    (global) or (bi, bj) (local), with K4's single-pair walk on a CUDA
    device or its plain version on the CPU; a launch counts in
    ``walk_packed.launches``.

    Returns (packed, stats) on the words' device: packed (max_len/16,)
    int32 moves in walk order, stats (3,) int32 [moves, i, j] with the
    final cursor.
    """
    _check_packed(words, n, m, bi, bj, local, max_len)
    num_w, n_cols = words.shape
    if words.device.type == "cpu":
        one = [torch.tensor([x], dtype=torch.int32) for x in (n, m, bi, bj)]
        packed, lengths, i, j = _walk_plain(
            words.reshape(-1), num_w, n_cols, 1, *one, local, False,
            max_len)
        return packed[:, 0], torch.cat([lengths, i, j])
    launch, out = packed_launch(words, n, m, bi, bj, local, max_len)
    launch()
    walk_packed.launches += 1
    return out


walk_packed.launches = 0


def packed_launch(words, n: int, m: int, bi: int, bj: int, local: bool,
                  max_len: int):
    """K4's single-pair walk on the words' CUDA device, ready to launch:
    the move words zeroed.  Returns (launch, (packed, stats)); each
    ``launch()`` runs the kernel once on the current stream (a second run
    writes the same words), raising if the launch failed, and counts
    nothing (``walk_packed`` counts its launches)."""
    return packed_shape_launch(library("batch_walk"), None, words, n, m,
                               bi, bj, local, max_len)


def packed_shape_launch(lib, window, words, n, m, bi, bj, local, max_len,
                        trace=None):
    """``packed_launch`` through ``lib``, a build of
    ``csrc/batch_walk.cu``: ``window`` None calls ``sa_walk_packed`` (the
    window ``PACKED_WINDOW``); ``window`` = (rows, columns) calls the
    all-shapes build's ``sa_walk_packed_shape`` with that window and
    ``trace`` (None, or an int64 tensor of 11 the walker fills)."""
    device = words.device
    num_w, n_cols = words.shape
    i0, j0 = (bi, bj) if local else (m, n)
    packed = torch.zeros(max_len // 16, dtype=torch.int32, device=device)
    stats = torch.empty(3, dtype=torch.int32, device=device)
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, i, i, i, i, i, p, ctypes.c_int64, p]
    if window is None:
        fn = c_function(lib, "sa_walk_packed", head + [p])
        tail = ()
    else:
        fn = c_function(lib, "sa_walk_packed_shape", head + [i, i, p, p])
        tail = (*window, None if trace is None else trace.data_ptr())

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(words.data_ptr(), num_w, n_cols, int(i0), int(j0),
                    int(local), packed.data_ptr(), max_len // 16,
                    stats.data_ptr(), *tail, stream)
        check_launch("batch_walk", rc)

    return launch, (packed, stats)
