"""Skewed-wavefront single-pair fill (K1): wrapper, plain version, and
the multi-strip fill of the wavefront route.

Slot s of a strip owns DP rows i0 + rps*s + 1 .. i0 + rps*s + rps and at
sweep step t computes column j = t - s + 1 of all of them; only a
slot's last row crosses to the next slot.  Direction bits are emitted in
the skewed word format of the JAX package: word (t//16)*rps + r of slot
s holds steps 16(t//16) .. 16(t//16)+15 of row r at bits 2*(t%16), so
the native ``sa_traceback_*_skewed`` walkers and K2 read it unchanged.

``wavefront_strip`` launches the CUDA kernel (``csrc/wavefront.cu``: the
strip as a chain of one-warp bands over the whole card, handing their
last rows on through streams in a scratch buffer the wrapper owns) for
tensors on a CUDA device and runs ``wavefront_strip_plain`` for tensors
on the CPU.  Global, local and semi-global, with linear or affine
(Gotoh) gap costs; with the direction words (and, affine, the run-bit
plane ``dirs2``) or score-only with column checkpoints, and from a given
left boundary column (the checkpoint engine's variants).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import layout
from ._build import c_function, check_launch, int_function, library

SLOTS = 1024           # slots of the wavefront route's strips
ROWS_PER_SLOT = 8      # rows per slot of the wavefront route
STEPS = layout.STEPS   # sweep steps per block of the streams
DIR_STEPS_PER_WORD = 16
NEG_INF = -(1 << 30)
NEG_HALF = NEG_INF // 2  # affine E/F "minus infinity": survives extends
RPS_CHOICES = (1, 2, 4, 8, 16)
# K1's scratch (csrc/wavefront.cu): SCRATCH_COUNTERS int32 (the ticket,
# the windows loaded and those found empty, from STARTED_BLOCKS and
# GENERAL_BLOCKS the blocks all lanes ran on each path as int64, from
# SM_LOG each CTA's SM + 1, from BAND_START / BAND_END each band's first
# and last iteration in ns), then the bands' tagged streams.
SCRATCH_COUNTERS = 4096
STARTED_BLOCKS = 4
GENERAL_BLOCKS = 6
SM_LOG = 1024
BAND_START = 2048
BAND_END = 3072


def strip_rows(r: int = ROWS_PER_SLOT) -> int:
    return r * SLOTS


def num_checkpoints(steps: int, ckpt_every: int) -> int:
    """Checkpoint columns a strip of ``steps`` sweep steps keeps room for
    (the JAX wrapper's count)."""
    return max(1, steps // ckpt_every)


def _check(text_steps, bottom_in, pattern_slots, score_matrix, k_alpha,
           rps, slots, local, semi, with_dirs, ckpt_every, left_in,
           affine=False, fbot_in=None, left_e=None):
    if rps not in RPS_CHOICES:
        raise ValueError(f"rps must be one of {RPS_CHOICES}, got {rps}")
    if slots % 128 or not (slots <= 1024 or slots in (2048, 4096)):
        raise ValueError(
            f"slots must be a multiple of 128 up to 1024, or 2048 or "
            f"4096, got {slots}"
        )
    if local and semi:
        raise ValueError("local and semi are exclusive")
    if not 1 <= k_alpha <= 32:
        raise ValueError(f"alphabet size must be in 1..32, got {k_alpha}")
    if ckpt_every and (ckpt_every < slots + DIR_STEPS_PER_WORD
                       or ckpt_every & (ckpt_every - 1)):
        raise ValueError(f"ckpt_every must be a power of two >= slots + "
                         f"{DIR_STEPS_PER_WORD}, got {ckpt_every}")
    if bool(with_dirs) == bool(ckpt_every):
        raise ValueError("the score-only fill (with_dirs=False) is the one "
                         "with column checkpoints (ckpt_every > 0)")
    num_blocks = text_steps.shape[0]
    shapes = {
        "text_steps": (text_steps, (num_blocks, STEPS)),
        "bottom_in": (bottom_in, (num_blocks, STEPS)),
        "pattern_slots": (pattern_slots, (rps, slots // 128, 128)),
        "score_matrix": (score_matrix, (k_alpha, k_alpha)),
    }
    if left_in is not None:
        shapes["left_in"] = (left_in, (rps + 1, slots // 128, 128))
    if affine:
        if fbot_in is None:
            raise ValueError("affine fills need fbot_in, the top row of F")
        if (left_e is None) != (left_in is None):
            raise ValueError("affine fills take left_e exactly with left_in")
        shapes["fbot_in"] = (fbot_in, (num_blocks, STEPS))
        if left_e is not None:
            shapes["left_e"] = (left_e, (rps + 1, slots // 128, 128))
    elif fbot_in is not None or left_e is not None:
        raise ValueError("fbot_in and left_e are affine inputs")
    device = text_steps.device
    for name, (x, shape) in shapes.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wavefront_strip(text_steps, bottom_in, pattern_slots, score_matrix,
                    gap, n, m, i0, k_alpha: int, local: bool = False,
                    with_dirs: bool = True, rps: int = ROWS_PER_SLOT,
                    ckpt_every: int = 0, slots: int = SLOTS,
                    semi: bool = False, left_in=None, affine: bool = False,
                    ext: int = 0, fbot_in=None, left_e=None):
    """Run one (rps*slots)-row strip sweep (the JAX ``wavefront_strip``).

    Args:
      text_steps: (num_blocks, STEPS) int32 — text[t] per step.
      bottom_in: (num_blocks, STEPS) int32 — the strip's top boundary
        row, H[i0, col_lo+t+1] per step.
      pattern_slots: (rps, slots/128, 128) int32 (``layout``).
      score_matrix: (k_alpha, k_alpha) int32.
      with_dirs: store the direction words; False (score only) exactly
        when ckpt_every is set.
      ckpt_every: 0 with the words, or for the score-only fill a power
        of two >= slots + 16: keep the values of every ckpt_every-th
        column.
      semi: global recurrence with row-m tracking; the caller passes a
        zero top row.
      left_in: None (the arithmetic column-0 boundary) or the (rps+1,
        slots/128, 128) left boundary column of ``make_left_input``: the
        strip then fills the columns after an arbitrary column col_lo,
        and j counts from col_lo.
      affine: Gotoh gap costs, gap the open cost and ``ext`` the extend
        cost (a run of L gaps costs gap + (L-1)*ext).
      fbot_in: affine only, (num_blocks, STEPS) int32 — the top row of
        F (the TOP-run state), NEG_HALF at the DP's row 0.
      left_e: affine with left_in only, the left column's E (the
        LEFT-run state) in ``make_left_input``'s layout (entry 0 of each
        slot unused).

    Returns (dirs, bottom_stream, rowmax, argj, snap, ckpts), and when
    affine (dirs, bottom_stream, rowmax, argj, snap, ckpts, dirs2,
    fbot_stream, ckpts_e), int32 on the inputs' device:
      dirs: (num_blocks*STEPS/16*rps, slots/128, 128) skewed words, or
        None without with_dirs;
      bottom_stream: (num_blocks, STEPS) — the last slot's last row
        after each step;
      rowmax / argj: (rps, slots/128, 128) — per-row maximum and first
        best column (local: rows <= m; semi: row m; NEG_INF / 0 for
        other rows and in global mode);
      snap: (slots/128, 128) — S[m, n] in the slot owning row m
        (global), NEG_INF elsewhere;
      ckpts: None without ckpt_every, else (num_checkpoints*rps,
        slots/128, 128): entry (q*rps + r, slot) holds S[i0 + rps*slot
        + r + 1, (q+1)*ckpt_every], and 0 where the slot does not reach
        that column within the strip's steps;
      dirs2: shaped like dirs, each cell's run bits in its 2 bits (bit 0:
        extending E strictly beats opening it; bit 1: the same for F),
        or None without with_dirs;
      fbot_stream: (num_blocks, STEPS) — the last slot's last-row F;
      ckpts_e: shaped like ckpts, E at the checkpoint columns, or None.
    """
    _check(text_steps, bottom_in, pattern_slots, score_matrix, k_alpha,
           rps, slots, local, semi, with_dirs, ckpt_every, left_in, affine,
           fbot_in, left_e)
    device = text_steps.device
    if device.type == "cpu":
        return wavefront_strip_plain(
            text_steps, bottom_in, pattern_slots, score_matrix, gap, n, m,
            i0, k_alpha, local=local, with_dirs=with_dirs, rps=rps,
            ckpt_every=ckpt_every, slots=slots, semi=semi, left_in=left_in,
            affine=affine, ext=ext, fbot_in=fbot_in, left_e=left_e,
        )
    if device.type != "cuda":
        raise ValueError(f"wavefront_strip runs on cuda or cpu, not {device}")
    launch, out = kernel_launch(
        text_steps, bottom_in, pattern_slots, score_matrix, gap, n, m, i0,
        k_alpha, local, rps, ckpt_every, slots, semi, left_in, affine=affine,
        ext=ext, fbot_in=fbot_in, left_e=left_e,
    )
    launch()
    wavefront_strip.launches += 1
    return out


wavefront_strip.launches = 0


def kernel_launch(text_steps, bottom_in, pattern_slots, score_matrix, gap,
                  n, m, i0, k_alpha, local, rps, ckpt_every, slots, semi,
                  left_in, affine=False, ext=0, fbot_in=None, left_e=None):
    """K1 on the inputs' CUDA device, ready to launch: the outputs
    allocated, the checkpoints zeroed; words without ckpt_every, the
    score-only fill with checkpoints with it.  Returns (launch, outputs) with
    the outputs of ``wavefront_strip``; each ``launch()`` runs the kernel
    once on the current stream, raising if the launch failed, and counts
    nothing (the wrapper counts its launches).  ``launch.scratch`` is the
    launch's scratch (the bands' streams), re-zeroed by every
    ``launch()``; ``_build.launch_sms(launch)`` reads where its CTAs ran."""
    lib = library("wavefront")
    shape = tuple(int_function(lib, name, 5)(rps, int(affine),
                                             int(ckpt_every), int(local),
                                             int(left_in is not None))
                  for name in ("sa_wavefront_split", "sa_wavefront_block"))
    return split_launch(lib, None, shape, text_steps, bottom_in,
                        pattern_slots, score_matrix, gap, n, m, i0, k_alpha,
                        local, rps, ckpt_every, slots, semi, left_in, affine,
                        ext, fbot_in, left_e)


def split_launch(lib, entry, shape, text_steps, bottom_in, pattern_slots,
                 score_matrix, gap, n, m, i0, k_alpha, local, rps, ckpt_every,
                 slots, semi, left_in, affine, ext, fbot_in, left_e):
    """``kernel_launch`` through ``lib`` (a build of ``csrc/wavefront.cu``)
    at ``shape`` = (lanes a slot, steps a lane's iteration): ``entry``
    None calls ``sa_wavefront_strip`` (which takes its own shape,
    ``shape`` then being it), else the C function ``entry``, which takes
    the shape before the scratch."""
    split = shape[0]
    device = text_steps.device
    i32 = torch.int32
    num_blocks = text_steps.shape[0]
    steps = num_blocks * STEPS
    srows = slots // 128
    dirs = ckpts = dirs2 = fbot_out = ckpts_e = None
    if ckpt_every:
        ckpts = torch.zeros(
            (num_checkpoints(steps, ckpt_every) * rps, srows, 128),
            dtype=i32, device=device)
    else:
        dirs = torch.empty((steps // DIR_STEPS_PER_WORD * rps, srows, 128),
                           dtype=i32, device=device)
    bottom_out = torch.empty((num_blocks, STEPS), dtype=i32, device=device)
    rowmax = torch.empty((rps, srows, 128), dtype=i32, device=device)
    argj = torch.empty_like(rowmax)
    snap = torch.empty((srows, 128), dtype=i32, device=device)
    if affine:
        dirs2 = None if dirs is None else torch.empty_like(dirs)
        ckpts_e = None if ckpts is None else torch.zeros_like(ckpts)
        fbot_out = torch.empty_like(bottom_out)
    # The bands' streams, the ticket and the CTAs' SM log (csrc/
    # wavefront.cu's head note); the C entry point zeroes them on the
    # stream before every launch.
    nbytes = int_function(lib, "sa_wavefront_scratch_bytes", 4,
                          ctypes.c_longlong)(steps, slots, split, int(affine))
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function(lib, entry or "sa_wavefront_strip",
                    [p] * 16 + [i] * (15 if entry else 13) + [p, p])
    tail = tuple(shape) if entry else ()

    def ptr(x):
        return None if x is None else x.data_ptr()

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(
                text_steps.data_ptr(), bottom_in.data_ptr(), ptr(fbot_in),
                pattern_slots.data_ptr(), score_matrix.data_ptr(),
                ptr(left_in), ptr(left_e), ptr(dirs), ptr(dirs2),
                bottom_out.data_ptr(), ptr(fbot_out), rowmax.data_ptr(),
                argj.data_ptr(), snap.data_ptr(), ptr(ckpts), ptr(ckpts_e),
                steps, slots, rps, k_alpha, int(gap), int(ext), int(n),
                int(m), int(i0), int(local), int(semi), int(affine),
                int(ckpt_every), *tail, scratch.data_ptr(), stream,
            )
        check_launch("wavefront", rc)

    launch.scratch = scratch
    launch.sm_log = SM_LOG
    launch.ctas = slots // 32
    out = (dirs, bottom_out, rowmax, argj, snap, ckpts)
    if affine:
        out += (dirs2, fbot_out, ckpts_e)
    return launch, out


def make_left_input(lc_full, rps: int, slots: int):
    """Slot layout of a left boundary column for ``wavefront_strip``'s
    left_in (the JAX ``make_left_input``).

    lc_full: (rps*slots + 1,) — lc_full[ri] = S[row_lo + ri, col_lo] for
    ri = 0..rows.  Returns (rps+1, slots/128, 128) int32 on its device:
    entry (0, slot) is lc_full[rps*slot] (the neighbour-boundary and
    corner value) and entry (r+1, slot) is lc_full[rps*slot + r + 1] (the
    slot's own rows).
    """
    lc_full = torch.as_tensor(lc_full).to(torch.int32)
    body = lc_full[1:].reshape(slots, rps).t()
    head = lc_full[:-1].reshape(slots, rps)[:, :1].t()
    return torch.cat([head, body]).contiguous().reshape(
        rps + 1, slots // 128, 128)


def wavefront_strip_plain(text_steps, bottom_in, pattern_slots,
                          score_matrix, gap, n, m, i0, k_alpha: int,
                          local: bool = False, with_dirs: bool = True,
                          rps: int = ROWS_PER_SLOT, ckpt_every: int = 0,
                          slots: int = SLOTS, semi: bool = False,
                          left_in=None, affine: bool = False, ext: int = 0,
                          fbot_in=None, left_e=None):
    """Plain PyTorch version of ``wavefront_strip``, on the inputs'
    device, with identical outputs.  Each step updates all slots at once;
    the rps rows of a slot, which chain through the top neighbour, are
    resolved with one running maximum down the rows.  Linear:
    H[r] = max(c[r], H[r-1] - gap) = max_k (c[k] - gap*(r-k)), c the
    diagonal and LEFT moves.  Affine, F chains instead: with c[r] =
    max(diag, E, 0 if local) and H[r] = max(c[r], F[r]),
    F[r] = max(F[r-1] - ext, H[r-1] - gap) = max(F[r-1] - g, c[r-1] - gap)
    for r >= 1, g = min(ext, gap), so F[r] = max_k (x[k] - g*(r-k)) with
    x[0] = F[0] = max(F_above - ext, H_above - gap) and x[k] = c[k-1] -
    gap: integer max and subtraction of a constant commute, so this equals
    the row-by-row chain exactly."""
    device = text_steps.device
    i32 = torch.int32
    num_blocks = text_steps.shape[0]
    steps = num_blocks * STEPS
    text = text_steps.reshape(-1)
    bottom = bottom_in.reshape(-1)
    sub_flat = score_matrix.reshape(-1)
    pat_off = pattern_slots.reshape(rps, slots).to(torch.int64) * k_alpha
    gap, ext = int(gap), int(ext)
    slot = torch.arange(slots, device=device)
    ibase = i0 + rps * slot
    rows_i = ibase[None, :] + torch.arange(
        1, rps + 1, device=device)[:, None]                # (rps, slots)
    if left_in is not None:
        left = left_in.reshape(rps + 1, slots)
        H = left[1:].clone()
        topsh = left[0].clone()
    elif local:
        H = torch.zeros((rps, slots), dtype=i32, device=device)
        topsh = torch.zeros(slots, dtype=i32, device=device)
    elif affine:
        H = (-(gap + ext * (rows_i - 1))).to(i32)
        topsh = torch.where(ibase == 0, 0, -(gap + ext * (ibase - 1))).to(i32)
    else:
        H = (-gap * rows_i).to(i32)
        topsh = (-gap * ibase).to(i32)
    ramp = (gap * torch.arange(rps + 1, device=device)).to(i32)[:, None]
    if affine:
        E = (left_e.reshape(rps + 1, slots)[1:].clone() if left_e is not None
             else torch.full((rps, slots), NEG_HALF, dtype=i32,
                             device=device))
        flast = torch.full((slots,), NEG_HALF, dtype=i32, device=device)
        fbottom = fbot_in.reshape(-1)
        framp = (min(ext, gap) * torch.arange(rps, device=device)).to(
            i32)[:, None]
        fstream = torch.empty(steps, dtype=i32, device=device)
    # text_ext[slots + x] = text[x]; zeros stand for "before the text".
    text_ext = torch.cat([torch.zeros(slots, dtype=i32, device=device), text])
    text_idx = slots - slot
    track = local or semi
    row_ok = (rows_i <= m) if local else (rows_i == m)
    acc = torch.full((rps, slots), NEG_INF, dtype=i32, device=device)
    acc_j = torch.zeros((rps, slots), dtype=i32, device=device)
    snap = torch.full((slots,), NEG_INF, dtype=i32, device=device)
    # Global: S[m, n] is computed by the slot owning row m at step
    # n + slot - 1.
    hit_r = hit_s = hit_t = None
    if not track and i0 < m <= i0 + rps * slots:
        hit_s, hit_r = divmod(m - 1 - i0, rps)
        hit_t = n + hit_s - 1
    dirs = ckpts = dirs2 = ckpts_e = None
    if with_dirs:
        dirs = torch.empty((steps // DIR_STEPS_PER_WORD * rps, slots),
                           dtype=i32, device=device)
        word = torch.zeros((rps, slots), dtype=i32, device=device)
        if affine:
            dirs2 = torch.empty_like(dirs)
            word2 = torch.zeros_like(word)
    if ckpt_every:
        ckpts = torch.zeros((num_checkpoints(steps, ckpt_every) * rps, slots),
                            dtype=i32, device=device)
        if affine:
            ckpts_e = torch.zeros_like(ckpts)
    stream = torch.empty(steps, dtype=i32, device=device)
    for t in range(steps):
        jvec = t - slot + 1
        started = (jvec >= 1)[None, :]
        w = text_ext[text_idx + t]
        nb_top = torch.cat([bottom[t:t + 1], H[rps - 1, :-1]])
        diag = torch.cat([topsh[None, :], H[:-1]]) + sub_flat[pat_off + w]
        left = H
        if affine:
            nb_f = torch.cat([fbottom[t:t + 1], flast[:-1]])
            e_ext = E - ext
            e_open = left - gap
            e_new = torch.maximum(e_ext, e_open)
            c = torch.maximum(diag, e_new)
            if local:
                c = c.clamp_min(0)
            f0 = torch.maximum(nb_f - ext, nb_top - gap)
            x = torch.cat([f0[None, :], c[:-1] - gap])
            f = torch.cummax(x + framp, dim=0).values - framp
            cur = torch.where(started, torch.maximum(c, f), left)
            F = torch.where(started, f, nb_f[None, :])
            E = torch.where(started, e_new, E)
            flast = F[rps - 1]
            fstream[t] = flast[slots - 1]
        else:
            c = torch.maximum(diag, left - gap)
            if local:
                c = c.clamp_min(0)
            chain = torch.cummax(torch.cat([nb_top[None, :], c]) + ramp,
                                 dim=0).values - ramp
            cur = torch.where(started, chain[1:], left)
        if with_dirs:
            top = torch.cat([nb_top[None, :], cur[:-1]])
            if affine:
                # F from above as each cell saw it (passed through
                # unstarted slots), and its run bits.
                f_ext = torch.cat([nb_f[None, :], F[:-1]]) - ext
                f_open = top - gap
                f_new = torch.maximum(f_ext, f_open)
                gap_best = torch.maximum(e_new, f_new)
                left_wins = e_new >= f_new
                d2 = ((e_ext > e_open).to(i32)
                      | ((f_ext > f_open).to(i32) << 1))
            else:
                gap_best = torch.maximum(top, left) - gap
                left_wins = left >= top
            d = torch.where(diag > gap_best, 1, torch.where(left_wins, 0, 2))
            if local:
                d = torch.where(torch.maximum(diag, gap_best) > 0, d, 3)
            u = t % DIR_STEPS_PER_WORD
            word = d.to(i32) if u == 0 else word | (d.to(i32) << (2 * u))
            if affine:
                word2 = d2 if u == 0 else word2 | (d2 << (2 * u))
            if u == DIR_STEPS_PER_WORD - 1:
                b = t // DIR_STEPS_PER_WORD
                dirs[b * rps:(b + 1) * rps] = word
                if affine:
                    dirs2[b * rps:(b + 1) * rps] = word2
        if ckpt_every:
            # At most one slot reaches a checkpoint column j = (q+1)*C at
            # step t (C > slots): the slot t + 1 - j.
            s_hit = (t + 1) % ckpt_every
            if s_hit < slots and t + 1 - s_hit >= ckpt_every:
                q = (t + 1 - s_hit) // ckpt_every - 1
                ckpts[q * rps:(q + 1) * rps, s_hit] = cur[:, s_hit]
                if affine:
                    ckpts_e[q * rps:(q + 1) * rps, s_hit] = E[:, s_hit]
        if track:
            valid = started & (jvec <= n)[None, :] & row_ok
            cand = torch.where(valid, cur, NEG_INF)
            acc_j = torch.where(cand > acc, jvec.to(i32)[None, :], acc_j)
            acc = torch.maximum(acc, cand)
        elif t == hit_t:
            snap[hit_s] = cur[hit_r, hit_s]
        H = cur
        topsh = nb_top
        stream[t] = H[rps - 1, slots - 1]
    srows = slots // 128

    def planes(x):
        return None if x is None else x.reshape(-1, srows, 128)

    out = (planes(dirs), stream.reshape(num_blocks, STEPS),
           acc.reshape(rps, srows, 128), acc_j.reshape(rps, srows, 128),
           snap.reshape(srows, 128), planes(ckpts))
    if affine:
        out += (planes(dirs2), fstream.reshape(num_blocks, STEPS),
                planes(ckpts_e))
    return out


def merge_local_best(rowmaxs, argjs, rows: int, rps: int, m: int,
                     slots: int = SLOTS):
    """Merge per-row local maxima in DP-row order: max value, smallest
    row on ties (argj already holds the first column within a row) — the
    reference's row-major first occurrence (alignSequenceCPU.cpp:191-192).

    rowmaxs/argjs: lists of (rps, slots) numpy arrays, one per strip.
    Returns (best, best_i, best_j) with the reference's 0/0/0 floor.
    """
    num_strips = len(rowmaxs)
    rm_all = np.stack(rowmaxs)    # (strips, rps, slots)
    aj_all = np.stack(argjs)
    c_idx, r_idx, s_idx = np.meshgrid(
        np.arange(num_strips), np.arange(rps), np.arange(slots),
        indexing="ij",
    )
    i_all = c_idx * rows + rps * s_idx + r_idx + 1
    valid = i_all <= m
    v_all = np.where(valid, rm_all, NEG_INF)
    best = int(v_all.max(initial=NEG_INF))
    if best <= 0:
        return 0, 0, 0
    ties = v_all == best
    flat = np.where(ties.reshape(-1), i_all.reshape(-1), 1 << 62)
    win = int(flat.argmin())
    return best, int(i_all.reshape(-1)[win]), int(aj_all.reshape(-1)[win])


def wavefront_fill(text, pattern, score_matrix, k_alpha: int, gap: int,
                   local: bool = False, with_dirs: bool = True,
                   rps: int = ROWS_PER_SLOT, slots: int = SLOTS,
                   device="cuda"):
    """Full single-pair fill through (rps*slots)-row strips run in order,
    each strip's bottom row feeding the next one's top row.

    Returns (score, best_i, best_j, words, steps_pad) where words is the
    host copy of the skewed direction words, (num_strips, steps_pad/16 *
    rps, slots) int32, or None without ``with_dirs``.  K1 is score-only
    only with column checkpoints, so the score-only fill asks for one
    checkpoint column past the strip's steps and drops it.
    """
    text_np = np.asarray(text, dtype=np.int32)
    pattern_np = np.asarray(pattern, dtype=np.int32)
    sm = torch.as_tensor(layout.pack_score_matrix(score_matrix, k_alpha))
    n, m = text_np.shape[0], pattern_np.shape[0]
    gap = int(gap)
    rows = rps * slots
    num_strips = max(1, -(-m // rows))
    steps_pad = layout.steps_padded(n, slots)
    num_blocks = steps_pad // STEPS

    pat_pad = np.zeros(num_strips * rows, dtype=np.int32)
    pat_pad[:m] = pattern_np
    ts_dev = torch.as_tensor(layout.text_steps(text_np, steps_pad)).to(device)
    sm_dev = sm.to(device)
    bottom = layout.top_row(steps_pad, gap, local, device)

    words, ckpt_every = None, 0
    if with_dirs:
        words = np.empty(
            (num_strips, (steps_pad // DIR_STEPS_PER_WORD) * rps, slots),
            dtype=np.int32,
        )
    else:
        ckpt_every = 1 << (max(steps_pad, slots + DIR_STEPS_PER_WORD)
                           - 1).bit_length()
    rowmaxs, argjs, snaps = [], [], []
    for c in range(num_strips):
        i0 = c * rows
        pat_slots = torch.as_tensor(
            layout.pattern_slots(pat_pad[i0:i0 + rows], rps, slots)
        ).to(device)
        dirs, bot_out, rowmax, argj, snap, _ = wavefront_strip(
            ts_dev, bottom, pat_slots, sm_dev, gap, n, m, i0,
            k_alpha=k_alpha, local=local, with_dirs=with_dirs, rps=rps,
            ckpt_every=ckpt_every, slots=slots,
        )
        if with_dirs:
            words[c] = dirs.reshape(-1, slots).cpu().numpy()
        rowmaxs.append(rowmax.reshape(rps, slots).cpu().numpy())
        argjs.append(argj.reshape(rps, slots).cpu().numpy())
        snaps.append(snap.reshape(-1).cpu().numpy())
        if c + 1 < num_strips:
            # Step t of this strip's stream is H[i0+rows, t-slots+2]; the
            # next strip's step t needs H[i0+rows, t+1].
            flat = bot_out.reshape(-1)
            bottom = torch.cat([
                flat[slots - 1:],
                torch.zeros(slots - 1, dtype=torch.int32, device=flat.device),
            ]).reshape(num_blocks, STEPS)

    if local:
        best, bi, bj = merge_local_best(
            rowmaxs, argjs, rows, rps, m, slots=slots
        )
        return best, bi, bj, words, steps_pad
    strip = (m - 1) // rows
    slot_idx = ((m - 1) % rows) // rps
    return int(snaps[strip][slot_idx]), m, n, words, steps_pad
