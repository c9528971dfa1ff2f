"""One query against a database held on the device: protein database
search (SSEARCH, CUDASW++) on the batch path.

``BatchAligner.database(sequences)`` packs a database once and uploads
it once.  Its sequences are sorted by length, longest first, into groups
of ``batch_fill.GROUP`` (64) neighbours, the length buckets of the
search: each group is one K3-cell16 CTA or two K3 CTAs, and is stored
pair-interleaved ([column][pair], the kernels' layout) at the width of
its longest sequence, so the padding is what 64 sequences of nearly one
length leave (``Database.padding``).  The groups are dealt out over the
mesh's entries in turn, so that each entry gets long and short ones;
each entry holds its share on its device.

``BatchAligner.search(query, database)`` scores the query against every
sequence, in database order, with the aligner's costs and mode (the
exact local affine scores of CUDASW++ for ``local=True`` and
``gap_extend``).  A request's host work is O(buckets): ``dispatch``
uploads the query once to each entry and launches K3 once for each run
of groups that one kernel fills (``search_score``, the query shared by
every pair, no copy of it a pair): the int16 cells (K3-cell16) for the
groups whose width, against the query's rows, the gate admits, then the
int32 cells for the wider ones, beside them on the tail's stream.
In local mode the gate is ``int16_local_ok``, whatever
``SEQALIGN_INT16_CELLS`` says: H >= 0 there, so the gaps add nothing to
the bound, which with BLOSUM62 (max|sub| 11) admits every group of width
<= 1,436 and, for a query of up to 1,424 letters, every group.  The
int16 cells give the int32 cells' scores exactly, two cells a 32-bit
lane.  In global and semi mode the gate is ``cell16_for``, as in
``BatchAligner.score``.  The scores are then scattered into database
order on the device; ``search.collect`` brings them back in one copy an
entry.  The longest sequences, above ``TAIL_LETTERS``,
would hold one CTA for longer than the rest of the request takes (a
pair is one lane's chain of warps), so they go to K1 score-only
(``checkpoint.checkpointed_fill``) on a stream of their own, at a
higher priority than K3's, one pair after another while K3 fills the
card.  Sequences with no letter go to the native oracle, as in
``BatchAligner``.  Across processes each process scores its entries'
share, and the shares are all-gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..native import bindings
from ..ops import batch_fill, checkpoint, layout
from .batch import _replicas, cell16_for

GROUP = batch_fill.GROUP
# Database sequences longer than this go to K1, the rest to K3: K3 gives
# a pair one lane, so a CTA of long ones runs far longer than the
# request's other CTAs (PERF.md §5, the threshold's measurement).
TAIL_LETTERS = 8192
# Residues a step of the database's packing lays out on the device.
PACK_RESIDUES = 1 << 24


def tail_geometry(m: int) -> tuple[int, int]:
    """(rps, slots) of K1's strips for a query of ``m`` rows in the tail:
    the fewest rows of 4, 8 or 16 a slot over at most 1,024 slots, so a
    tail pair keeps its strip to the query's rows and a few SMs while
    K3 has the rest."""
    for rps in (4, 8, 16):
        slots = max(128, -(-m // (rps * 128)) * 128)
        if slots <= 1024:
            return rps, slots
    return 16, 1024


class _Share:
    """One mesh entry's part of a database on its device: ``texts`` the
    groups' blocks back to back (int8), ``groups`` (G,) int64 their
    offsets, ``ns`` (G * GROUP,) int32 the lengths (0 for padding),
    ``where`` (G * GROUP,) int64 each pair's database index (``size`` for
    padding); ``widths`` (G,), ``offsets`` and ``residues_before`` (the
    residues of the groups before each, G + 1) on the host; ``tail``
    the entry's K1 pairs, (database index, int8 letters on the host:
    ``checkpointed_fill`` uploads a pair's few KB itself); ``stream``, on
    a CUDA device, the int32 groups' and the tail's (``dispatch``,
    ``_tail``)."""

    def __init__(self, device, letters, starts, lengths, pairs, size,
                 tail):
        self.device = device
        lens = np.where(pairs >= 0, lengths[np.maximum(pairs, 0)], 0)
        self.widths = lens.reshape(-1, GROUP).max(axis=1)
        self.offsets = np.concatenate(
            [[0], np.cumsum(GROUP * self.widths.astype(np.int64))])
        self.texts = torch.zeros(int(self.offsets[-1]), dtype=torch.int8,
                                 device=device)
        self._lay_out(letters, starts, pairs, lens)
        self.groups = torch.from_numpy(self.offsets[:-1]).to(device)
        self.ns = torch.from_numpy(lens.astype(np.int32)).to(device)
        self.where = torch.from_numpy(
            np.where(pairs >= 0, pairs, size)).to(device)
        self.residues_before = np.concatenate(
            [[0], np.cumsum(lens.reshape(-1, GROUP).sum(axis=1))])
        self.residues = int(self.residues_before[-1])
        self.tail = tail
        self.stream = (torch.cuda.Stream(device, priority=-1)
                       if device.type == "cuda" else None)

    def _lay_out(self, letters, starts, pairs, lens):
        """Copy every pair's letters (``letters`` the whole database's,
        on the device) into its group's block there, whole groups of at
        most about PACK_RESIDUES letters at a time."""
        dev = self.device
        step = max(1, PACK_RESIDUES // GROUP // max(
            1, int(self.widths.max(initial=1)))) * GROUP
        for p0 in range(0, pairs.shape[0], step):
            p1 = min(p0 + step, pairs.shape[0])
            n = torch.from_numpy(lens[p0:p1]).to(dev)
            # Each letter's pair (from p0) and column.
            pair = torch.repeat_interleave(
                torch.arange(p1 - p0, device=dev), n)
            col = (torch.arange(pair.shape[0], device=dev)
                   - (torch.cumsum(n, 0) - n)[pair])
            src = torch.from_numpy(
                starts[np.maximum(pairs[p0:p1], 0)]).to(dev)[pair] + col
            block = torch.from_numpy(
                self.offsets[p0 // GROUP:p1 // GROUP]).to(dev)
            dest = (block[pair // GROUP] + col * GROUP + pair % GROUP)
            self.texts[dest] = letters[src]


class Database:
    """Sequences packed once onto a mesh for ``BatchAligner.search``
    (the module's docstring).  ``size`` sequences of ``residues`` letters
    in all; ``padded`` letters stored for the K3 groups' ``residues``
    less the tail's (``padding`` their share); ``tail`` the sequences
    longer than TAIL_LETTERS, K1's."""

    def __init__(self, sequences, mesh, alphabet_size: int):
        seqs = [np.asarray(s) for s in sequences]
        self.mesh = mesh
        self.size = len(seqs)
        lengths = np.fromiter(map(len, seqs), dtype=np.int64,
                              count=self.size)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(
            np.int64)
        flat = (np.concatenate(seqs).astype(np.int8) if lengths.sum()
                else np.zeros(0, dtype=np.int8))
        if flat.size and (flat.min() < 0 or flat.max() >= alphabet_size):
            raise ValueError(f"letters must lie in 0..{alphabet_size - 1}")
        self.lengths = lengths
        self.residues = int(lengths.sum())
        self.empty = np.flatnonzero(lengths == 0)
        in_k3 = np.flatnonzero((lengths > 0) & (lengths <= TAIL_LETTERS))
        tail = np.flatnonzero(lengths > TAIL_LETTERS)
        self.tail = tail
        # Longest first; a stable sort keeps database order among equals.
        pairs = in_k3[np.argsort(-lengths[in_k3], kind="stable")]
        groups = -(-pairs.shape[0] // GROUP)
        pairs = np.concatenate(
            [pairs, np.full(groups * GROUP - pairs.shape[0], -1,
                            dtype=np.int64)]
        ).reshape(groups, GROUP)
        self.shares = []
        for e, device in enumerate(mesh.devices):
            g = mesh.first + e
            with mesh.on(e):
                letters = torch.from_numpy(flat).to(device)
                self.shares.append(_Share(
                    device, letters, starts, lengths,
                    pairs[g::mesh.size].reshape(-1), self.size,
                    [(int(i), flat[starts[i]:starts[i] + lengths[i]])
                     for i in tail[g::mesh.size]]))
                del letters
        k3 = int(lengths[in_k3].sum())
        self.padded = sum(int(s.offsets[-1]) for s in self.shares)
        if mesh.world_size > 1:
            self.padded = int(mesh.all_gather(
                torch.tensor([self.padded])).sum())
        self.padding = (self.padded - k3) / k3 if k3 else 0.0


def dispatch(aligner, database: Database, query: np.ndarray) -> list:
    """Queue a request on every local entry: the query's upload, K3 over
    each run of groups one kernel fills, and the scatter of the scores
    into database order.  The groups ``_first_cell16``'s gate admits, the
    shortest, go first, in int16 cells on the entry's stream; the wider
    ones then in int32 cells, beside them on ``share.stream``, ahead of
    the tail's pairs: a launch of the widest groups alone lasts as long
    as its longest CTA, and on one stream with the int16 run the card
    would wait out that CTA's tail (PERF.md §6, PR 21).  Returns, an entry,
    (the scores in database order on the device with a last slot for the
    padding pairs, the launches)."""
    mesh = aligner.mesh
    m = query.shape[0]
    stripe = batch_fill.DIR_ROWS_PER_WORD
    rows = -(-m // stripe) * stripe  # the query's rows K3 fills
    sms = _replicas(mesh, aligner.score_matrix, aligner._sm_cache)
    out = []
    for e, share in enumerate(database.shares):
        with mesh.on(e):
            q = torch.from_numpy(query).to(share.device, non_blocking=True)
            scores = torch.zeros(database.size + 1, dtype=torch.int32,
                                 device=share.device)
            g16 = _first_cell16(aligner, share.widths, rows)
            groups = share.widths.shape[0]
            # The int32 run goes beside an int16 run; alone, it keeps the
            # entry's stream and the tail runs beside it.
            side = share.stream if 0 < g16 < groups else None
            if side is not None:
                main = torch.cuda.current_stream(share.device)
                uploaded = main.record_event()
            launches = 0
            for g0, g1, cell16 in ((g16, groups, True), (0, g16, False)):
                if g0 == g1:
                    continue
                run = (aligner, share, q, sms[e], g0, g1, cell16)
                if cell16 or side is None:
                    got = _fill(*run)
                else:
                    side.wait_event(uploaded)
                    q.record_stream(side)
                    with torch.cuda.stream(side):
                        got = _fill(*run)
                    main.wait_stream(side)
                    got.record_stream(main)
                scores[share.where[g0 * GROUP:g1 * GROUP]] = got
                launches += 1
                tracing.count("search.cells_padded", rows * int(
                    share.offsets[g1] - share.offsets[g0]))
                if cell16:
                    tracing.count("search.cells16", m * int(
                        share.residues_before[g1]
                        - share.residues_before[g0]))
        out.append((scores, launches))
    return out


def _fill(aligner, share, q, sm, g0: int, g1: int, cell16: bool):
    """K3 over the share's groups g0..g1 on the current stream: their
    scores, (g1 - g0) * GROUP int32 in the groups' order."""
    lo, hi = int(share.offsets[g0]), int(share.offsets[g1])
    return batch_fill.search_score(
        share.texts[lo:hi], share.groups[g0:g1], int(share.widths[g0]),
        share.ns[g0 * GROUP:g1 * GROUP], q, sm, aligner.gap_penalty,
        aligner.alphabet_size, local=aligner.local, semi=aligner.semi,
        gap_extend=aligner.gap_extend, cell16=cell16)


def _first_cell16(aligner, widths: np.ndarray, rows: int) -> int:
    """The first group (widths longest first) whose shape (width, query
    rows) takes int16 cells, or the group count: in local mode those
    ``batch_fill.int16_local_ok`` admits, whatever
    ``SEQALIGN_INT16_CELLS`` says; in global and semi mode those
    ``cell16_for`` takes.  The admitted widths are the shortest, so a
    binary search."""
    gate = batch_fill.int16_local_ok if aligner.local else cell16_for
    lo, hi = 0, widths.shape[0]
    while lo < hi:
        mid = (lo + hi) // 2
        if gate(int(widths[mid]), rows, aligner.score_matrix,
                aligner.alphabet_size, aligner.gap_penalty,
                aligner.gap_extend):
            hi = mid
        else:
            lo = mid + 1
    return lo


def search(aligner, query, database: Database) -> np.ndarray:
    """``BatchAligner.search``: (size,) int32 scores of ``query`` against
    every database sequence, in database order (the text the database
    sequence, the pattern the query, as ``score(..., swap=False)``)."""
    if database.mesh is not aligner.mesh:
        raise ValueError("the database lies on another mesh than the "
                         "aligner's")
    query = np.asarray(query)
    if query.ndim != 1 or query.shape[0] == 0:
        raise ValueError("the query must be one non-empty sequence")
    aligner._check_letters(query)
    query = np.ascontiguousarray(query, dtype=np.int8)
    mesh = aligner.mesh
    with tracing.span("batch.search"):
        with tracing.span("search.dispatch"):
            queued = dispatch(aligner, database, query)
        launches = sum(x[1] for x in queued)
        tracing.annotate("buckets", launches)
        tracing.count("search.buckets", launches)
        tracing.count("search.cells", query.shape[0] * database.residues)
        out = np.zeros(database.size, dtype=np.int32)
        with tracing.span("search.tail"):
            for e, share in enumerate(database.shares):
                _tail(aligner, share, query, out, mesh, e)
        with tracing.span("search.collect"):
            # The entries' scatters (and tails) are disjoint, zeros
            # elsewhere: their sum is the database's scores.
            for e, (scores, _) in enumerate(queued):
                with mesh.on(e):
                    tracing.count("host_waits")
                    out += scores[:-1].cpu().numpy()
            if mesh.world_size > 1:
                out = mesh.all_gather(torch.from_numpy(out)).reshape(
                    mesh.world_size, -1).sum(dim=0).to(torch.int32).numpy()
            _score_empty(aligner, database, query, out)
    return out


def _tail(aligner, share, query, out, mesh, e):
    """The entry's tail pairs' scores into ``out``: K1 score-only, one
    pair after another on the share's stream (each uploads its letters
    and the query there, and reads its score back)."""
    if not share.tail:
        return
    rps, slots = tail_geometry(query.shape[0])
    rows = -(-query.shape[0] // (rps * slots)) * rps * slots
    stream = share.stream
    with (torch.cuda.stream(stream) if stream is not None else mesh.on(e)):
        for i, letters in share.tail:
            tracing.count("search.tail_pairs")
            tracing.count("search.cells_padded", rows * layout.steps_padded(
                letters.shape[0], slots))
            out[i] = checkpoint.checkpointed_fill(
                letters, query, aligner.score_matrix, aligner.alphabet_size,
                aligner.gap_penalty,
                local=aligner.local, semi=aligner.semi,
                gap_extend=aligner.gap_extend, rps=rps, slots=slots,
                device=share.device).score


def _score_empty(aligner, database, query, out):
    """The empty sequences' scores, from the native oracle (every process
    alike)."""
    if not database.empty.size:
        return
    algo = 2 if aligner.semi else (1 if aligner.local else 0)
    none = np.zeros(0, dtype=np.int8)
    args = (algo, none, query, aligner.score_matrix, aligner.alphabet_size,
            aligner.gap_penalty)
    if aligner.gap_extend is not None:
        score, _ = bindings.oracle_fill_affine(*args, aligner.gap_extend)
    else:
        _, score, _ = bindings.oracle_fill(*args)
    out[database.empty] = score


__all__ = ["Database", "TAIL_LETTERS", "dispatch", "search",
           "tail_geometry"]
