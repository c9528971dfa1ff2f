"""Sequence-parallel single-pair fills over a device mesh (the JAX
package's ``parallel/sequence.py``).

One long pair's DP matrix is cut across the entries of the mesh
(``parallel/mesh.py``) and filled as a pipelined wavefront: entry d runs
piece s - d at superstep s, and what it hands to entry d + 1 (the halo,
``ppermute`` in the JAX package) is copied there behind a CUDA event on
entry d's stream.  The host queues the supersteps; each entry's work runs
on its own stream, so the entries' kernels overlap on the card(s).

* ``sequence_parallel_checkpointed_fill`` — the long-pair route of
  ``models/base.py``.  Entry d owns wavefront strip d (rps*slots pattern
  rows) and runs K1 score-only over text chunks of ``ckpt_cols``
  columns, each chunk one ``wavefront.wavefront_strip`` call: the
  chunk's column checkpoint is the next chunk's left column
  (``make_left_input``), and the strip's bottom row (H, and F for affine
  gaps) is the halo of strip d + 1.  The result is the port's
  ``CheckpointedFill``, so ``checkpointed_traceback`` walks it unchanged
  and the alignment is byte-identical to the checkpoint engine's.
* ``sequence_parallel_fill`` — K5 (``strip_fill``) over column strips,
  one an entry, in row blocks; the halo is a strip's right boundary
  column.

The pipelines run on one process's mesh; a mesh spread over processes is
refused.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import layout, strip_fill, wavefront
from ..ops.checkpoint import (DEFAULT_CKPT_COLS, CheckpointedFill,
                              _pick_geometry)
from . import mesh as mesh_lib

# A chunk's cost beyond its (ckpt_cols + slots) steps, in steps of the
# single-device strip loop.  The JAX package clamps its own to 0
# (``seqalign_tpu/parallel/sequence.py``: there a chunk costs less than
# its steps); on the H100 a K1 chunk pays the band pipeline's fill again.
# ``chip_smoke.py``'s mesh line measures it as ``chunk_overhead_steps``:
# an interior chunk of rps 16 x 4,096 slots, 32,768 columns, against the
# long pair's phase-1 strip at the strip's rate (17.914 ms for 36,864
# steps against 45.538 ms for 215,808 on an H100 80GB HBM3 at 700 W:
# 48,033 steps).
PIPE_CHUNK_OVERHEAD_STEPS = 48_000
# The speedup at which the long-pair route takes the mesh unasked.
ROUTE_SPEEDUP = 1.2


def estimated_speedup(n: int, m: int, d_count: int,
                      ckpt_cols: int = DEFAULT_CKPT_COLS,
                      overhead_steps: int | None = None) -> float:
    """Steps of the single-device strip loop over steps of the pipeline's
    critical path (the JAX model): one device sweeps every strip over the
    whole text, n + slots steps each; the pipeline runs (chunks + strips
    - 1) chunk fills of ckpt_cols + slots + ``overhead_steps`` steps
    (default ``PIPE_CHUNK_OVERHEAD_STEPS``; 0 is the JAX package's
    model).  0 when the pattern needs more strips than the mesh has
    entries."""
    if overhead_steps is None:
        overhead_steps = PIPE_CHUNK_OVERHEAD_STEPS
    rps, slots = _pick_geometry(m, None, None)
    rows = rps * slots
    num_strips = max(1, -(-m // rows))
    if num_strips > d_count:
        return 0.0
    num_chunks = max(1, -(-n // ckpt_cols))
    single = num_strips * (n + slots)
    par = (num_chunks + num_strips - 1) * (ckpt_cols + slots
                                           + overhead_steps)
    return single / par


def _one_process(mesh):
    if mesh.world_size != 1:
        raise ValueError("the sequence-parallel fills run on one process's "
                         "mesh")


class _ChunkStrip:
    """One wavefront strip of the checkpointed pipeline on its entry: the
    padded text, its pattern slots, the left column carried from chunk to
    chunk, the best-cell trackers and the boundaries kept."""

    def __init__(self, b, mesh, text_pad, pat_pad, sm, p):
        self.b, self.p = b, p
        device = mesh.devices[b]
        i32 = torch.int32
        rows, rps, slots = p["rows"], p["rps"], p["slots"]
        self.i0 = b * rows
        self.text = torch.from_numpy(text_pad).to(device)
        self.pattern = torch.from_numpy(layout.pattern_slots(
            pat_pad[self.i0:self.i0 + rows], rps, slots)).to(device)
        self.sm = torch.from_numpy(sm).to(device)
        # The left boundary of chunk 0, S[i0 + ri, 0] for ri = 0..rows.
        x = self.i0 + torch.arange(rows + 1, device=device)
        gap, ext = p["gap"], p["ext"]
        if p["local"]:
            self.left = torch.zeros(rows + 1, dtype=i32, device=device)
        elif p["affine"]:
            self.left = torch.where(x == 0, 0, -(gap + ext * (x - 1))).to(i32)
        else:
            self.left = (-gap * x).to(i32)
        srows = slots // 128
        self.acc = torch.full((rps, srows, 128), wavefront.NEG_INF,
                              dtype=i32, device=device)
        self.argj = torch.zeros_like(self.acc)
        self.snap = torch.full((srows, 128), wavefront.NEG_INF, dtype=i32,
                               device=device)
        width = p["num_chunks"] * p["ckpt_cols"]
        self.bounds = torch.zeros(width, dtype=i32, device=device)
        self.colvals = torch.zeros((p["num_chunks"], rows), dtype=i32,
                                   device=device)
        if p["affine"]:
            self.left_e = torch.full((rows + 1,), wavefront.NEG_HALF,
                                     dtype=i32, device=device)
            self.fbounds = torch.zeros_like(self.bounds)
            self.colvals_e = torch.zeros_like(self.colvals)

    def to_col(self, ckpts):
        """The chunk's first checkpoint, (rps, srows, 128) of
        (num_checkpoints*rps, ...), as the column of its rows."""
        p = self.p
        return (ckpts[:p["rps"]].reshape(p["rps"], p["slots"]).t()
                .reshape(p["rows"]))

    def run(self, c, halo):
        """Fill chunk c (K1 score-only with the left column and column
        checkpoints every ckpt_cols columns), from ``halo`` (strip b-1's
        bottom row over the chunk, and its F row when affine) or, in
        strip 0, the DP's top row.  Returns this strip's bottom row over
        the chunk (and its F row), the next strip's halo."""
        p = self.p
        cols, tile_steps, slots = p["ckpt_cols"], p["tile_steps"], p["slots"]
        device = self.text.device
        i32 = torch.int32
        col_lo = c * cols
        steps = lambda x: x.reshape(-1, layout.STEPS)  # noqa: E731
        pad = tile_steps - cols
        # Top row S[i0, col_lo + t + 1] per step: only its first ckpt_cols
        # entries are real; the rest feed the drain past the chunk, which
        # nothing kept reads.
        if self.b > 0:
            bot = torch.cat([halo[0], torch.zeros(pad, dtype=i32,
                                                  device=device)])
        elif p["local"] or p["semi"]:
            bot = torch.zeros(tile_steps, dtype=i32, device=device)
        else:
            t = col_lo + torch.arange(tile_steps, device=device)
            bot = (-(p["gap"] + p["ext"] * t) if p["affine"]
                   else -(p["gap"] * (t + 1))).to(i32)
        kwargs = {}
        if p["affine"]:
            neg = torch.full((pad if self.b > 0 else tile_steps,),
                             wavefront.NEG_HALF, dtype=i32, device=device)
            fbot = torch.cat([halo[1], neg]) if self.b > 0 else neg
            kwargs = dict(affine=True, ext=p["ext"], fbot_in=steps(fbot),
                          left_e=wavefront.make_left_input(
                              self.left_e, p["rps"], slots))
        # Tracking is confined to the chunk's own columns.
        n_eff = min(max(p["n"] - col_lo, 0), cols)
        outs = wavefront.wavefront_strip(
            steps(self.text[col_lo:col_lo + tile_steps]), steps(bot),
            self.pattern, self.sm, p["gap"], n_eff, p["m"], self.i0,
            p["k_alpha"], local=p["local"], with_dirs=False, rps=p["rps"],
            ckpt_every=cols, slots=slots, semi=p["semi"],
            left_in=wavefront.make_left_input(self.left, p["rps"], slots),
            **kwargs)
        _, bot_out, rowmax, argj, snap, ckpts = outs[:6]
        seg = bot_out.reshape(-1)[slots - 1:slots - 1 + cols]
        self.bounds[col_lo:col_lo + cols] = seg
        col = self.to_col(ckpts)
        self.colvals[c] = col
        # Chunks own disjoint ascending columns: a strict improvement
        # keeps the first occurrence.
        improved = rowmax > self.acc
        self.acc = torch.where(improved, rowmax, self.acc)
        self.argj = torch.where(improved, argj + col_lo, self.argj)
        if c == p["snap_chunk"]:
            self.snap = snap
        # The chunk's right column is the next chunk's left one; its corner
        # S[i0, col_lo + ckpt_cols] is the top row's last real entry.
        self.left = torch.cat([bot[cols - 1:cols], col])
        if not p["affine"]:
            return (seg,)
        fseg = outs[7].reshape(-1)[slots - 1:slots - 1 + cols]
        self.fbounds[col_lo:col_lo + cols] = fseg
        col_e = self.to_col(outs[8])
        self.colvals_e[c] = col_e
        self.left_e = torch.cat([self.left_e[:1], col_e])
        return seg, fseg


def sequence_parallel_checkpointed_fill(
        text, pattern, score_matrix, k_alpha: int, gap: int,
        local: bool = False, semi: bool = False,
        gap_extend: int | None = None, ckpt_cols: int = DEFAULT_CKPT_COLS,
        rps: int | None = None, slots: int | None = None,
        mesh=None) -> CheckpointedFill:
    """Phase 1 of the checkpoint engine for one pair, pipelined over
    ``mesh`` (default ``make_data_mesh()``): strip d of rps*slots rows on
    entry d, chunk s - d at superstep s.  Raises ValueError when the
    pattern needs more strips than the mesh has entries.

    Returns the ``CheckpointedFill`` of the JAX function: the score and
    best cell, and each strip's boundaries on the mesh's first device,
    colvals[b] (num_chunks, rows) — chunk c's right column — and
    boundaries[b] (num_chunks*ckpt_cols,), the index j-1 holding S[(b+1)
    *rows, j]; affine, colvals_e and boundaries_f alike.  Where
    ``checkpointed_fill`` at the same geometry defines them (the
    boundaries' first n entries, the checkpoints of columns <= n) they
    are its values."""
    mesh = mesh if mesh is not None else mesh_lib.make_data_mesh()
    _one_process(mesh)
    text_np = np.asarray(text, dtype=np.int32)
    pattern_np = np.asarray(pattern, dtype=np.int32)
    sm = layout.pack_score_matrix(score_matrix, k_alpha)
    n, m = text_np.shape[0], pattern_np.shape[0]
    affine = gap_extend is not None
    rps, slots = _pick_geometry(m, rps, slots)
    rows = rps * slots
    num_strips = max(1, -(-m // rows))
    if num_strips > mesh.size:
        raise ValueError(
            f"the pattern needs {num_strips} strips of {rows} rows, more "
            f"than the mesh's {mesh.size} entries; use the single-device "
            f"checkpoint engine")
    num_chunks = max(1, -(-n // ckpt_cols))
    tile_steps = layout.steps_padded(ckpt_cols, slots)
    p = dict(n=n, m=m, k_alpha=k_alpha, gap=int(gap),
             ext=int(gap_extend) if affine else 0, affine=affine,
             local=local, semi=semi, rps=rps, slots=slots, rows=rows,
             ckpt_cols=ckpt_cols, tile_steps=tile_steps,
             num_chunks=num_chunks, snap_chunk=max(0, (n - 1) // ckpt_cols))
    text_pad = np.zeros((num_chunks - 1) * ckpt_cols + tile_steps, np.int32)
    text_pad[:n] = text_np
    pat_pad = np.zeros(num_strips * rows, dtype=np.int32)
    pat_pad[:m] = pattern_np

    strips = []
    for b in range(num_strips):
        with mesh.on(b):
            strips.append(_ChunkStrip(b, mesh, text_pad, pat_pad, sm, p))
    halos = [None] * num_strips
    for s in range(num_chunks + num_strips - 1):
        sent = {}
        for b, strip in enumerate(strips):
            c = s - b
            if not 0 <= c < num_chunks:
                continue
            with mesh.on(b):
                out = strip.run(c, halos[b])
            if b + 1 < num_strips:
                sent[b + 1] = tuple(mesh.hand_over(x, b, b + 1) for x in out)
        halos = [sent.get(b, halos[b]) for b in range(num_strips)]

    def gathered(name):
        return [mesh.hand_over(getattr(strip, name), strip.b)
                for strip in strips]

    colvals, boundaries = gathered("colvals"), gathered("bounds")
    extra = {}
    if affine:
        extra = dict(gap_extend=p["ext"], colvals_e=gathered("colvals_e"),
                     boundaries_f=gathered("fbounds"))
    mesh.synchronize()

    def trackers(name):
        return [getattr(strip, name).reshape(rps, slots).cpu().numpy()
                for strip in strips]

    if local:
        score, bi, bj = wavefront.merge_local_best(
            trackers("acc"), trackers("argj"), rows, rps, m, slots=slots)
    else:
        strip = strips[(m - 1) // rows]
        slot_idx, r_idx = divmod((m - 1) % rows, rps)
        if semi:
            score = int(strip.acc.reshape(rps, slots)[r_idx, slot_idx])
            bi, bj = m, int(strip.argj.reshape(rps, slots)[r_idx, slot_idx])
        else:
            score, bi, bj = int(strip.snap.reshape(-1)[slot_idx]), m, n
    return CheckpointedFill(
        score=score, best_i=bi, best_j=bj, colvals=colvals,
        boundaries=boundaries, n=n, m=m, rows=rows, rps=rps,
        ckpt_cols=ckpt_cols, gap=int(gap), local=local, semi=semi, **extra)


def _merge_states(states: np.ndarray, local: bool, n: int, m: int):
    """Merge per-strip [best, bi, bj, score] rows (``ops/tiled.py``'s
    rule): local, the largest best, then the smallest (bi, bj), counted
    only when the best is above 0; global, the largest score, the walk
    starting at (m, n)."""
    if local:
        best, bi, bj = 0, 0, 0
        for s_best, s_bi, s_bj, _ in states:
            s_best, s_bi, s_bj = int(s_best), int(s_bi), int(s_bj)
            if s_best > best or (
                    s_best == best and s_best > 0 and (s_bi, s_bj) < (bi, bj)):
                best, bi, bj = s_best, s_bi, s_bj
        return best, bi, bj
    return max(int(s[3]) for s in states), m, n


class _Piece:
    """A column range of one entry's strip, at most MAX_STRIP_COLS wide
    (one K5 region's width): its letters, the DP row above the next
    block, the state and S[row_base, off] above its left column."""

    def __init__(self, text, off, width, gap, local, device):
        self.off, self.width = off, width
        self.letters = torch.from_numpy(
            strip_fill.strip_letters(text, off, width)).to(device)
        self.prev = torch.from_numpy(
            strip_fill.init_prev_row(width, off, gap, local)).to(device)
        self.state = torch.from_numpy(strip_fill.zeros_state()).to(device)
        self.top = torch.full((1,), 0 if local else -gap * off,
                              dtype=torch.int32, device=device)


def sequence_parallel_fill(text, pattern, score_matrix, k_alpha: int,
                           gap: int, local: bool = False,
                           with_dirs: bool = False, mesh=None,
                           block_rows: int = strip_fill.ROWS_PER_STEP):
    """Fill one pair's DP matrix with K5 across ``mesh`` (default
    ``make_data_mesh()``), linear gaps, global or local: the padded width
    (a multiple of 1,024 columns an entry) split into one strip an entry,
    run over row blocks of ``block_rows`` (a multiple of 128, at most
    ``strip_fill.MAX_CHUNK_ROWS``), entry d's block s - d at superstep s,
    its right boundary column the halo of entry d + 1.  A strip wider
    than one K5 region (``MAX_STRIP_COLS``) runs as pieces in column
    order within the superstep.

    Returns (score, best_i, best_j, words): words is the host array of
    packed directions, (m_pad/16, mesh.size * strip_cols) int32, with
    ``with_dirs``, else None."""
    mesh = mesh if mesh is not None else mesh_lib.make_data_mesh()
    _one_process(mesh)
    text_np = np.asarray(text, dtype=np.int32)
    pattern_np = np.asarray(pattern, dtype=np.int32)
    sm = layout.pack_score_matrix(score_matrix, k_alpha)
    n, m = text_np.shape[0], pattern_np.shape[0]
    gap = int(gap)
    d_count = mesh.size

    quantum = strip_fill.COLS_QUANTUM * d_count
    total_p = max(quantum, -(-n // quantum) * quantum)
    strip_p = total_p // d_count
    r = max(strip_fill.ROWS_PER_STEP, block_rows // strip_fill.ROWS_PER_STEP
            * strip_fill.ROWS_PER_STEP)
    if r > strip_fill.MAX_CHUNK_ROWS:
        raise ValueError(f"block_rows {block_rows} is past K5's "
                         f"{strip_fill.MAX_CHUNK_ROWS} rows a region")
    m_pad = max(r, -(-m // r) * r)
    t_blocks = m_pad // r
    wpb = r // strip_fill.DIR_ROWS_PER_WORD
    # An entry's strip as pieces of whole 1,024-column quanta.
    quanta = strip_p // strip_fill.COLS_QUANTUM
    count = -(-strip_p // strip_fill.MAX_STRIP_COLS)
    widths = [strip_fill.COLS_QUANTUM
              * (quanta // count + (i < quanta % count))
              for i in range(count)]

    pat_pad = np.zeros(m_pad, dtype=np.int32)
    pat_pad[:m] = pattern_np
    entries = []
    for d, device in enumerate(mesh.devices):
        with mesh.on(d):
            offs = d * strip_p + np.cumsum([0] + widths[:-1])
            entries.append(dict(
                sm=torch.from_numpy(sm).to(device),
                pattern=torch.from_numpy(pat_pad).to(device),
                left=(torch.from_numpy(strip_fill.nw_boundary_col(
                    0, m_pad, gap, local)).to(device) if d == 0 else None),
                pieces=[_Piece(text_np, int(off), w, gap, local, device)
                        for off, w in zip(offs, widths)]))
    words = (np.empty((m_pad // strip_fill.DIR_ROWS_PER_WORD, total_p),
                      dtype=np.int32) if with_dirs else None)

    halos = [None] * d_count
    for s in range(t_blocks + d_count - 1):
        sent = {}
        for d, entry in enumerate(entries):
            t = s - d
            if not 0 <= t < t_blocks:
                continue
            row_base = t * r
            left = halos[d]
            with mesh.on(d):
                for piece in entry["pieces"]:
                    if left is None:
                        lc = entry["left"][row_base:row_base + r + 1]
                    else:
                        lc = torch.cat([piece.top, left])
                        piece.top = left[r - 1:r]
                    dirs, piece.prev, left, piece.state = (
                        strip_fill.strip_fill(
                            piece.letters, entry["sm"],
                            entry["pattern"][row_base:row_base + r], gap, n,
                            m, row_base, piece.off, lc, piece.prev,
                            piece.state, local=local, with_dirs=with_dirs))
                    if with_dirs:
                        words[t * wpb:(t + 1) * wpb,
                              piece.off:piece.off + piece.width] = \
                            dirs.cpu().numpy()
            if d + 1 < d_count:
                sent[d + 1] = mesh.hand_over(left, d, d + 1)
        halos = [sent.get(d, halos[d]) for d in range(d_count)]

    mesh.synchronize()
    states = np.stack([piece.state.cpu().numpy() for entry in entries
                       for piece in entry["pieces"]])
    score, bi, bj = _merge_states(states, local, n, m)
    return score, bi, bj, words
