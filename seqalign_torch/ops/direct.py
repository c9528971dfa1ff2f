"""Direct route: fill and walk on the device for pairs that fit one strip.

K1 fills the strip with its direction words in device memory, the best
cell is merged on the device (row-major first occurrence,
alignSequenceCPU.cpp:191-192), and K2 walks the path there — only the
score, the best cell and the 2-bit packed moves come back to the host,
which replays them through the native emitter.  Affine (Gotoh) gaps
add K1's run-bit plane beside the words, which K2's three-state walk
reads, and the moves replay through ``emit_moves_affine``.  Pairs whose
pattern exceeds one strip, or whose words exceed the device budget, take
the checkpoint engine (``ops/checkpoint.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import tracing
from ..native import bindings
from . import layout, wavefront
from .checkpoint import _pick_geometry
from .traceback import emit_moves_affine
from .walk import unpack_moves, walk_skewed_window

_LEFT, _TOP = 0, 2

# Cap of the walker's move list.
MAX_DIRECT_MOVES = 4 << 20
# Device-memory budget for the strip's direction words.
MAX_DIRECT_DIRS_BYTES = int(
    os.environ.get("SEQALIGN_MAX_DIRECT_DIRS_BYTES", 10 << 30)
)


def _direct_geometry(m: int):
    """Shallowest strip of 4096 slots the pattern fits."""
    rps, slots = _pick_geometry(m, None, None)
    while m > rps * slots and rps < 16:
        rps *= 2
    return rps, slots


def fits_direct(n: int, m: int, affine: bool = False) -> bool:
    rps, slots = _direct_geometry(m)
    if m > rps * slots:
        return False
    if n + m + 1 > MAX_DIRECT_MOVES:
        return False
    dirs_bytes = (layout.steps_padded(n, slots) // 16) * rps * slots * 4
    if affine:  # the run-bit plane beside the words
        dirs_bytes *= 2
    return dirs_bytes <= MAX_DIRECT_DIRS_BYTES


def best_cell(rowmax, argj, snap, rps: int, slots: int, n: int, m: int,
              local: bool, semi: bool):
    """(score, best_i, best_j) of one strip from row 0, merged from K1's
    trackers on their device: local takes the max with the smallest row
    on ties (the tracker keeps the first column in a row), the reference's
    row-major first occurrence with its 0/0/0 floor; semi-global the
    first best column of row m; global S[m, n] at (m, n)."""
    rowmax = rowmax.reshape(rps, slots)
    argj = argj.reshape(rps, slots)
    slot = torch.arange(slots, device=rowmax.device)[None, :]
    r_idx = torch.arange(rps, device=rowmax.device)[:, None]
    i_all = rps * slot + r_idx + 1
    if local:
        best = rowmax.max()
        ties = rowmax == best
        win_i = torch.where(ties, i_all, 1 << 30).min()
        bj = torch.where(ties & (i_all == win_i), argj, 0).max()
        tracing.count("host_waits")
        score, bi, bj = (int(x) for x in torch.stack([best, win_i, bj]).cpu())
        if score <= 0:
            return 0, 0, 0
        return score, bi, bj
    if semi:
        mask = i_all == m
        tracing.count("host_waits", 2)
        score = int(torch.where(mask, rowmax, wavefront.NEG_INF).max())
        return score, m, int(torch.where(mask, argj, 0).max())
    tracing.count("host_waits")
    return int(snap.max()), m, n


def direct_fill_walk(text_steps, pattern_slots, score_matrix, gap, n, m,
                     k_alpha: int, local: bool, semi: bool, rps: int,
                     slots: int, max_moves: int,
                     gap_extend: int | None = None):
    """K1 over one strip from row 0, the best-cell merge, and K2 from the
    best cell, all on the inputs' device; affine with ``gap_extend``
    (``gap`` is then the open cost).

    Returns (score, best_i, best_j, moves, result): Python ints, then
    the walker's packed moves and (count, i, j, state, done) tensors.
    """
    device = text_steps.device
    bottom = layout.top_row(text_steps.numel(), gap, local or semi, device,
                            ext=gap_extend)
    affine = gap_extend is not None
    outs = wavefront.wavefront_strip(
        text_steps, bottom, pattern_slots, score_matrix, gap, n, m, 0,
        k_alpha=k_alpha, local=local, rps=rps, slots=slots, semi=semi,
        affine=affine, ext=gap_extend or 0,
        fbot_in=(torch.full_like(bottom, wavefront.NEG_HALF) if affine
                 else None),
    )
    dirs, _, rowmax, argj, snap = outs[:5]
    score, bi, bj = best_cell(rowmax, argj, snap, rps, slots, n, m, local,
                              semi)
    moves, result = walk_skewed_window(
        dirs, rps, 0, 0, bi, bj, local, max_moves,
        words2=outs[6] if affine else None,
    )
    return score, bi, bj, moves, result


def strip_inputs(text, pattern, score_matrix, k_alpha: int, rps: int,
                 slots: int, device):
    """K1's inputs for one strip from row 0 on ``device``:
    (text_steps, pattern_slots, score_matrix) tensors."""
    steps_pad = layout.steps_padded(len(text), slots)
    pat_pad = np.zeros(rps * slots, dtype=np.int32)
    pat_pad[:len(pattern)] = pattern
    return (
        torch.as_tensor(layout.text_steps(text, steps_pad)).to(device),
        torch.as_tensor(layout.pattern_slots(pat_pad, rps, slots)).to(device),
        torch.as_tensor(layout.pack_score_matrix(score_matrix, k_alpha)).to(
            device),
    )


def direct_align(text, pattern, score_matrix, k_alpha: int, gap: int,
                 local: bool = False, semi: bool = False,
                 gap_extend: int | None = None,
                 rps: int | None = None, slots: int | None = None,
                 device="cuda"):
    """Full alignment on ``device`` (see the module docstring); affine
    (Gotoh) gap costs with ``gap_extend``, ``gap`` then the open cost.

    Returns (score, best_i, best_j, aligned_text_idx,
    aligned_pattern_idx, start_text, start_pattern) — byte-identical to
    the oracle.
    """
    with tracing.span("direct.align"):
        text_np = np.asarray(text, dtype=np.int32)
        pattern_np = np.asarray(pattern, dtype=np.int32)
        sm = layout.pack_score_matrix(score_matrix, k_alpha)
        n, m = text_np.shape[0], pattern_np.shape[0]
        if rps is None and slots is None:
            rps, slots = _direct_geometry(m)
        else:
            rps, slots = _pick_geometry(m, rps, slots)
        if m > rps * slots:
            raise ValueError(f"pattern of {m} rows exceeds one strip of "
                             f"{rps * slots}")

        max_moves = -(-(n + m + 1) // 16) * 16
        inputs = strip_inputs(text_np, pattern_np, sm, k_alpha, rps, slots,
                              device)
        score, bi, bj, moves_dev, result = direct_fill_walk(
            *inputs, gap, n, m, k_alpha=k_alpha, local=local, semi=semi,
            rps=rps, slots=slots, max_moves=max_moves, gap_extend=gap_extend,
        )
        tracing.count("host_waits", 2)
        k, i, j, _, _ = (int(x) for x in result.cpu())
        moves = unpack_moves(moves_dev.cpu().numpy(), k)
        if not local and (i == 0 or j == 0) and not (i == 0 and j == 0):
            # Forced first-row/column moves (alignSequenceCPU.cpp:77-81);
            # semi-global stops at row 0 without the free text end-gap.
            if j == 0 and i > 0:
                moves = np.concatenate([moves, np.full(i, _TOP, np.uint8)])
            elif i == 0 and j > 0 and not semi:
                moves = np.concatenate([moves, np.full(j, _LEFT, np.uint8)])
        start_i = bi if (local or semi) else m
        start_j = bj if (local or semi) else n
        with tracing.span("native.emit"):
            if gap_extend is not None:
                at, ap, st, sp = emit_moves_affine(
                    moves, start_i, start_j, text_np, pattern_np, k_alpha
                )
            else:
                at, ap, st, sp = bindings.emit_moves(
                    moves, start_i, start_j, local, text_np, pattern_np,
                    k_alpha
                )
        if semi:
            st, sp = (j if j > 0 else 0), 0
        return score, bi, bj, at, ap, st, sp
