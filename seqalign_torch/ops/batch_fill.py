"""Inter-pair batch fill (K3): wrappers and plain versions.

Every pair of a padded batch fills its own DP matrix; the batch is the
parallel axis (the SWIPE formulation of the JAX package's
``pallas_fill._interpair_kernel``).  Two public functions share one
kernel body:

* ``batch_score`` — the optimal score of every pair;
* ``batch_fill_dirs`` — the scores, the best cells and the 2-bit
  direction words in the JAX layout (tiles, M/16, N, tile_pairs/128,
  128): word (t, w, j) holds rows 16w+1..16w+16 at column j+1 of pair
  t*tile_pairs + slot, row 16w+1+r at bits 2r.

Inputs are the JAX wrappers' arrays as tensors: pair-major (B, N) texts
and (B, M) patterns (int8 or int32 letters in 0..k-1), (B,) int32
lengths with 0 <= ns <= N and 0 <= ms <= M (pairs with ns = 0 are
padding: their outputs are defined but meaningless), and the (k, k)
int32 score matrix.  Linear gaps only: global, local and semi-global.

For tensors on a CUDA device the wrappers launch the kernel
(``csrc/interpair.cu``), after moving the letters to [column][pair]
order with plain tensor ops; for tensors on the CPU they run the plain
versions.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import library

NEG_INF = -(1 << 30)
DIR_ROWS_PER_WORD = 16
TILE_QUANTUM = 128  # tile_pairs is a multiple of this (the JAX layout)


def mode_code(local: bool, semi: bool) -> int:
    """The kernels' mode argument: 0 global, 1 local, 2 semi-global."""
    return 1 if local else (2 if semi else 0)


def _check(texts, patterns, ns, ms, score_matrix, k_alpha, local, semi,
           tile_pairs=None):
    if local and semi:
        raise ValueError("local and semi are exclusive")
    if not 1 <= k_alpha <= 32:
        raise ValueError(f"alphabet size must be in 1..32, got {k_alpha}")
    if texts.dim() != 2 or patterns.dim() != 2:
        raise ValueError("texts and patterns must be (B, N) and (B, M)")
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    if patterns.shape[0] != b or n_cols < 1 or m_rows < 1:
        raise ValueError(f"texts {tuple(texts.shape)} and patterns "
                         f"{tuple(patterns.shape)} do not make a batch")
    device = texts.device
    for name, x, shape in (("patterns", patterns, None), ("ns", ns, (b,)),
                           ("ms", ms, (b,)),
                           ("score_matrix", score_matrix,
                            (k_alpha, k_alpha))):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    for name, x in (("texts", texts), ("patterns", patterns)):
        if x.dtype not in (torch.int8, torch.int32):
            raise ValueError(f"{name} must be int8 or int32 letters")
    for name, x in (("ns", ns), ("ms", ms), ("score_matrix", score_matrix)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if tile_pairs is not None:
        if m_rows % DIR_ROWS_PER_WORD:
            raise ValueError(f"patterns' width {m_rows} is not a multiple "
                             f"of {DIR_ROWS_PER_WORD}")
        if tile_pairs < 1 or tile_pairs % TILE_QUANTUM or b % tile_pairs:
            raise ValueError(f"tile_pairs {tile_pairs} must be a multiple "
                             f"of {TILE_QUANTUM} dividing the batch {b}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the batch fill runs on cuda or cpu, not {device}")


def kernel_launch(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                  local, semi, tile_pairs, with_dirs):
    """K3 on the inputs' CUDA device, ready to launch: the letters moved to
    [column][pair] int8 order and the outputs allocated.  Returns
    (launch, (scores, best_is, best_js, dirs)); each ``launch()`` runs the
    kernel once on the current stream, raising if the launch failed, and
    counts nothing (the wrappers count their launches)."""
    device = texts.device
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    # [column][pair] int8 letters: a warp reads 32 neighbouring bytes.
    texts_cp = texts.to(torch.int8).t().contiguous()
    patterns_cp = patterns.to(torch.int8).t().contiguous()
    ns = ns.contiguous()
    ms = ms.contiguous()
    sm = score_matrix.contiguous()
    i32 = torch.int32
    row = torch.empty((n_cols, b), dtype=i32, device=device)
    scores = torch.empty(b, dtype=i32, device=device)
    best_is = best_js = dirs = None
    if with_dirs:
        best_is = torch.empty(b, dtype=i32, device=device)
        best_js = torch.empty(b, dtype=i32, device=device)
        dirs = torch.empty(
            (b // tile_pairs, m_rows // DIR_ROWS_PER_WORD, n_cols,
             tile_pairs // 128, 128), dtype=i32, device=device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _kernel()(
                texts_cp.data_ptr(), patterns_cp.data_ptr(), ns.data_ptr(),
                ms.data_ptr(), sm.data_ptr(), k_alpha, int(gap), b, n_cols,
                m_rows, tile_pairs or TILE_QUANTUM, mode_code(local, semi),
                int(with_dirs), row.data_ptr(), scores.data_ptr(),
                ptr(best_is), ptr(best_js), ptr(dirs), stream,
            )
        if rc != 0:
            raise RuntimeError(f"interpair kernel launch failed: "
                               f"cudaError_t {rc}")

    return launch, (scores, best_is, best_js, dirs)


def _kernel():
    fn = library("interpair").sa_interpair_fill
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 5 + [i, i, ctypes.c_int64, i, i, i, i, i]
                       + [p] * 6)
        fn.restype = ctypes.c_int
    return fn


def batch_score(texts, patterns, ns, ms, score_matrix, gap, k_alpha: int,
                local: bool = False, semi: bool = False):
    """Optimal scores of a padded batch (the JAX ``batch_score_pallas``,
    linear gaps, int32 cells).  Returns (B,) int32 on the inputs' device:
    local scores floored at 0; padding pairs (ns = 0) score 0 (local) or
    NEG_INF."""
    _check(texts, patterns, ns, ms, score_matrix, k_alpha, local, semi)
    if texts.device.type == "cpu":
        return batch_score_plain(texts, patterns, ns, ms, score_matrix, gap,
                                 k_alpha, local=local, semi=semi)
    launch, (scores, _, _, _) = kernel_launch(
        texts, patterns, ns, ms, score_matrix, gap, k_alpha, local, semi,
        None, False)
    launch()
    batch_score.launches += 1
    return scores


batch_score.launches = 0


def batch_fill_dirs(texts, patterns, ns, ms, score_matrix, gap,
                    k_alpha: int, local: bool = False, semi: bool = False,
                    tile_pairs: int = TILE_QUANTUM):
    """Fill with direction words (the JAX ``batch_fill_dirs_pallas``,
    linear gaps, int32 cells).  M must be a multiple of 16 and B of
    tile_pairs.

    Returns (scores, best_is, best_js, dirs) on the inputs' device:
    scores (B,) as ``batch_score``; best_is/best_js (B,) the local or
    semi best cell, the first in row-major order (0 for global, whose
    walk starts at (m, n)); dirs (B/tile_pairs, M/16, N, tile_pairs/128,
    128) int32 words, every word defined, padding included.
    """
    _check(texts, patterns, ns, ms, score_matrix, k_alpha, local, semi,
           tile_pairs)
    if texts.device.type == "cpu":
        return batch_fill_dirs_plain(texts, patterns, ns, ms, score_matrix,
                                     gap, k_alpha, local=local, semi=semi,
                                     tile_pairs=tile_pairs)
    launch, out = kernel_launch(texts, patterns, ns, ms, score_matrix, gap,
                                k_alpha, local, semi, tile_pairs, True)
    launch()
    batch_fill_dirs.launches += 1
    return out


batch_fill_dirs.launches = 0


def _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha, local,
                semi, tile_pairs):
    """Row-by-row fill of every pair at once, on the inputs' device.

    A linear-gap row resolves its left dependency with one running
    maximum: H[j] = max(T[j], H[j-1] - gap) with T = max(diag, top - gap)
    (floored at 0 for local) is cummax(T[k] + gap*k) - gap*j, with H[i, 0]
    in front.  Returns (scores, best_is, best_js, dirs or None)."""
    device = texts.device
    i32 = torch.int32
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    gap = int(gap)
    text = texts.long()
    pat = patterns.long()
    sm = score_matrix.reshape(-1)
    n = ns.long().clamp(max=n_cols)[:, None]
    m = ms.long().clamp(max=m_rows)
    col = torch.arange(n_cols, device=device)[None, :]  # j: DP column j+1
    ramp = (gap * torch.arange(n_cols + 1, device=device)).to(i32)
    in_text = col < n
    if local or semi:
        prev = torch.zeros((b, n_cols), dtype=i32, device=device)
    else:
        prev = (-gap * (col + 1)).to(i32).expand(b, n_cols)
    acc = torch.full((b,), NEG_INF, dtype=i32, device=device)
    bi = torch.zeros(b, dtype=i32, device=device)
    bj = torch.zeros(b, dtype=i32, device=device)
    with_dirs = tile_pairs is not None
    if with_dirs:
        words = torch.empty((m_rows // DIR_ROWS_PER_WORD, n_cols, b),
                            dtype=i32, device=device)
    for i in range(1, m_rows + 1):
        h0 = torch.full((b, 1), 0 if local else -gap * i, dtype=i32,
                        device=device)
        d0 = torch.full((b, 1), 0 if local else -gap * (i - 1), dtype=i32,
                        device=device)
        sub = sm[pat[:, i - 1:i] * k_alpha + text]
        diag = torch.cat([d0, prev[:, :-1]], dim=1) + sub
        t = torch.maximum(diag, prev - gap)
        if local:
            t = t.clamp_min(0)
        chain = torch.cummax(torch.cat([h0, t], dim=1) + ramp, dim=1).values
        cur = (chain - ramp)[:, 1:]
        if with_dirs:
            left = torch.cat([h0, cur[:, :-1]], dim=1)
            gap_best = torch.maximum(prev, left) - gap
            d = torch.where(diag > gap_best, 1,
                            torch.where(left >= prev, 0, 2)).to(i32)
            if local:
                d = torch.where(torch.maximum(diag, gap_best) > 0, d, 3)
            r = (i - 1) % DIR_ROWS_PER_WORD
            word = d if r == 0 else word | (d << (2 * r))
            if r == DIR_ROWS_PER_WORD - 1:
                words[(i - 1) // DIR_ROWS_PER_WORD] = word.t()
        if local or semi:
            row_ok = (i <= m) if local else (m == i)
            cand = torch.where(in_text & row_ok[:, None], cur, NEG_INF)
            best, arg = cand.max(dim=1)  # the first best column of the row
            better = best > acc
            acc = torch.where(better, best, acc)
            bi = torch.where(better, i, bi)
            bj = torch.where(better, (arg + 1).to(i32), bj)
        else:
            hit = (m == i) & (n[:, 0] >= 1)
            at_n = cur.gather(1, (n - 1).clamp(min=0)).reshape(-1)
            acc = torch.where(hit, at_n, acc)
        prev = cur
    scores = acc.clamp_min(0) if local else acc
    if not with_dirs:
        return scores, bi, bj, None
    tiles = b // tile_pairs
    dirs = (words.reshape(m_rows // DIR_ROWS_PER_WORD, n_cols, tiles,
                          tile_pairs)
            .permute(2, 0, 1, 3)
            .reshape(tiles, m_rows // DIR_ROWS_PER_WORD, n_cols,
                     tile_pairs // 128, 128)
            .contiguous())
    return scores, bi, bj, dirs


def batch_score_plain(texts, patterns, ns, ms, score_matrix, gap,
                      k_alpha: int, local: bool = False, semi: bool = False):
    """Plain PyTorch version of ``batch_score``, on the inputs' device,
    with identical outputs."""
    return _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                       local, semi, None)[0]


def batch_fill_dirs_plain(texts, patterns, ns, ms, score_matrix, gap,
                          k_alpha: int, local: bool = False,
                          semi: bool = False,
                          tile_pairs: int = TILE_QUANTUM):
    """Plain PyTorch version of ``batch_fill_dirs``, on the inputs'
    device, with identical outputs."""
    return _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                       local, semi, tile_pairs)
