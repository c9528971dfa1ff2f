"""Skewed-wavefront single-pair fill (K1): wrapper, plain version, and
the multi-strip fill of the wavefront route.

Slot s of a strip owns DP rows i0 + rps*s + 1 .. i0 + rps*s + rps and at
sweep step t computes column j = t - s + 1 of all of them; only a
slot's last row crosses to the next slot.  Direction bits are emitted in
the skewed word format of the JAX package: word (t//16)*rps + r of slot
s holds steps 16(t//16) .. 16(t//16)+15 of row r at bits 2*(t%16), so
the native ``sa_traceback_*_skewed`` walkers and K2 read it unchanged.

``wavefront_strip`` launches the CUDA kernel (``csrc/wavefront.cu``) for
tensors on a CUDA device and runs ``wavefront_strip_plain`` for tensors
on the CPU.  Linear gaps only: global, local and semi-global.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import layout
from ._build import library

SLOTS = 1024           # slots of the wavefront route's strips
ROWS_PER_SLOT = 8      # rows per slot of the wavefront route
STEPS = layout.STEPS   # sweep steps per block of the streams
DIR_STEPS_PER_WORD = 16
NEG_INF = -(1 << 30)
RPS_CHOICES = (1, 2, 4, 8, 16)


def strip_rows(r: int = ROWS_PER_SLOT) -> int:
    return r * SLOTS


def _check(text_steps, bottom_in, pattern_slots, score_matrix, k_alpha,
           rps, slots, local, semi):
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
    num_blocks = text_steps.shape[0]
    shapes = {
        "text_steps": (text_steps, (num_blocks, STEPS)),
        "bottom_in": (bottom_in, (num_blocks, STEPS)),
        "pattern_slots": (pattern_slots, (rps, slots // 128, 128)),
        "score_matrix": (score_matrix, (k_alpha, k_alpha)),
    }
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
                    rps: int = ROWS_PER_SLOT, slots: int = SLOTS,
                    semi: bool = False):
    """Run one (rps*slots)-row strip sweep (the JAX ``wavefront_strip``
    with dirs, linear gaps, no checkpoints or left column).

    Args:
      text_steps: (num_blocks, STEPS) int32 — text[t] per step.
      bottom_in: (num_blocks, STEPS) int32 — the strip's top boundary
        row, H[i0, t+1] per step.
      pattern_slots: (rps, slots/128, 128) int32 (``layout``).
      score_matrix: (k_alpha, k_alpha) int32.
      semi: global recurrence with row-m tracking; the caller passes a
        zero top row.

    Returns (dirs, bottom_stream, rowmax, argj, snap), all int32 on the
    inputs' device:
      dirs: (num_blocks*STEPS/16*rps, slots/128, 128) skewed words;
      bottom_stream: (num_blocks, STEPS) — the last slot's last row
        after each step;
      rowmax / argj: (rps, slots/128, 128) — per-row maximum and first
        best column (local: rows <= m; semi: row m; NEG_INF / 0 for
        other rows and in global mode);
      snap: (slots/128, 128) — S[m, n] in the slot owning row m
        (global), NEG_INF elsewhere.
    """
    _check(text_steps, bottom_in, pattern_slots, score_matrix, k_alpha,
           rps, slots, local, semi)
    device = text_steps.device
    if device.type == "cpu":
        return wavefront_strip_plain(
            text_steps, bottom_in, pattern_slots, score_matrix, gap, n, m,
            i0, k_alpha, local=local, rps=rps, slots=slots, semi=semi,
        )
    if device.type != "cuda":
        raise ValueError(f"wavefront_strip runs on cuda or cpu, not {device}")
    num_blocks = text_steps.shape[0]
    steps = num_blocks * STEPS
    srows = slots // 128
    dirs = torch.empty(
        (steps // DIR_STEPS_PER_WORD * rps, srows, 128),
        dtype=torch.int32, device=device,
    )
    bottom_out = torch.empty((num_blocks, STEPS), dtype=torch.int32,
                             device=device)
    rowmax = torch.empty((rps, srows, 128), dtype=torch.int32, device=device)
    argj = torch.empty_like(rowmax)
    snap = torch.empty((srows, 128), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel()(
            text_steps.data_ptr(), bottom_in.data_ptr(),
            pattern_slots.data_ptr(), score_matrix.data_ptr(),
            dirs.data_ptr(), bottom_out.data_ptr(), rowmax.data_ptr(),
            argj.data_ptr(), snap.data_ptr(), steps, slots, rps, k_alpha,
            int(gap), int(n), int(m), int(i0), int(local), int(semi),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"wavefront kernel launch failed: cudaError_t {rc}")
    wavefront_strip.launches += 1
    return dirs, bottom_out, rowmax, argj, snap


wavefront_strip.launches = 0


def _kernel():
    fn = library("wavefront").sa_wavefront_strip
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 10 + [p]
        fn.restype = ctypes.c_int
    return fn


def wavefront_strip_plain(text_steps, bottom_in, pattern_slots,
                          score_matrix, gap, n, m, i0, k_alpha: int,
                          local: bool = False, rps: int = ROWS_PER_SLOT,
                          slots: int = SLOTS, semi: bool = False):
    """Plain PyTorch version of ``wavefront_strip``, on the inputs'
    device, with identical outputs.  Each step updates all slots at once;
    the rps rows of a slot, which chain through the top neighbour, are
    resolved with one running maximum down the rows:
    H[r] = max(c[r], H[r-1] - gap) = max_k (c[k] - gap*(r-k))."""
    device = text_steps.device
    i32 = torch.int32
    num_blocks = text_steps.shape[0]
    steps = num_blocks * STEPS
    text = text_steps.reshape(-1)
    bottom = bottom_in.reshape(-1)
    sub_flat = score_matrix.reshape(-1)
    pat_off = pattern_slots.reshape(rps, slots).to(torch.int64) * k_alpha
    gap = int(gap)
    slot = torch.arange(slots, device=device)
    rows_i = (i0 + rps * slot)[None, :] + torch.arange(
        1, rps + 1, device=device)[:, None]                # (rps, slots)
    if local:
        H = torch.zeros((rps, slots), dtype=i32, device=device)
        topsh = torch.zeros(slots, dtype=i32, device=device)
    else:
        H = (-gap * rows_i).to(i32)
        topsh = (-gap * (i0 + rps * slot)).to(i32)
    ramp = (gap * torch.arange(rps + 1, device=device)).to(i32)[:, None]
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
    dirs = torch.empty((steps // DIR_STEPS_PER_WORD * rps, slots),
                       dtype=i32, device=device)
    stream = torch.empty(steps, dtype=i32, device=device)
    word = torch.zeros((rps, slots), dtype=i32, device=device)
    for t in range(steps):
        jvec = t - slot + 1
        started = (jvec >= 1)[None, :]
        w = text_ext[text_idx + t]
        nb_top = torch.cat([bottom[t:t + 1], H[rps - 1, :-1]])
        diag = torch.cat([topsh[None, :], H[:-1]]) + sub_flat[pat_off + w]
        left = H
        c = torch.maximum(diag, left - gap)
        if local:
            c = c.clamp_min(0)
        chain = torch.cummax(torch.cat([nb_top[None, :], c]) + ramp,
                             dim=0).values - ramp
        cur = torch.where(started, chain[1:], left)
        top = torch.cat([nb_top[None, :], cur[:-1]])
        gap_best = torch.maximum(top, left) - gap
        best = torch.maximum(diag, gap_best)
        d = torch.where(diag > gap_best, 1, torch.where(left >= top, 0, 2))
        if local:
            d = torch.where(best > 0, d, 3)
        u = t % DIR_STEPS_PER_WORD
        word = d.to(i32) if u == 0 else word | (d.to(i32) << (2 * u))
        if u == DIR_STEPS_PER_WORD - 1:
            b = t // DIR_STEPS_PER_WORD
            dirs[b * rps:(b + 1) * rps] = word
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
    return (
        dirs.reshape(-1, srows, 128),
        stream.reshape(num_blocks, STEPS),
        acc.reshape(rps, srows, 128),
        acc_j.reshape(rps, srows, 128),
        snap.reshape(srows, 128),
    )


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
                   local: bool = False, rps: int = ROWS_PER_SLOT,
                   slots: int = SLOTS, device="cuda"):
    """Full single-pair fill through (rps*slots)-row strips run in order,
    each strip's bottom row feeding the next one's top row.

    Returns (score, best_i, best_j, words, steps_pad) where words is the
    host copy of the skewed direction words, (num_strips, steps_pad/16 *
    rps, slots) int32.
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
    if local:
        bottom = np.zeros(steps_pad, dtype=np.int64)
    else:
        bottom = -gap * (np.arange(steps_pad, dtype=np.int64) + 1)
    ts_dev = torch.as_tensor(layout.text_steps(text_np, steps_pad)).to(device)
    sm_dev = sm.to(device)
    bottom = torch.as_tensor(
        bottom.astype(np.int32).reshape(num_blocks, STEPS)).to(device)

    words = np.empty(
        (num_strips, (steps_pad // DIR_STEPS_PER_WORD) * rps, slots),
        dtype=np.int32,
    )
    rowmaxs, argjs, snaps = [], [], []
    for c in range(num_strips):
        i0 = c * rows
        pat_slots = torch.as_tensor(
            layout.pattern_slots(pat_pad[i0:i0 + rows], rps, slots)
        ).to(device)
        dirs, bot_out, rowmax, argj, snap = wavefront_strip(
            ts_dev, bottom, pat_slots, sm_dev, gap, n, m, i0,
            k_alpha=k_alpha, local=local, rps=rps, slots=slots,
        )
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
