"""Length-bucketed many-pair scoring and alignment over a device mesh.

The port of the JAX package's ``parallel/batch.py``: ``BatchAligner`` and
``sharded_batch_score``.  Pairs are grouped into buckets of one padded
shape, and a bucket's batch is padded to a multiple of the mesh's size
times ``batch_fill.TILE_QUANTUM`` and cut into one contiguous block an
entry of the mesh (``parallel/mesh.py``).  On each entry, on its own
stream, K3 (``ops/batch_fill``) fills the block, 32 pairs a CTA, and, for
``align``, K4 (``ops/batch_traceback``) walks every pair's path on the
device, so only scores, best cells and 2-bit packed moves come back.  The
host replays the moves through the native ``sa_emit_moves_batch``,
byte-identical to the oracle.  Pairs with an empty sequence go to the
native oracle.  Linear or affine (Gotoh) gaps: global, local and
semi-global.  Under ``SEQALIGN_INT16_CELLS`` (``config.int16_cells``) a
bucket whose padded shape ``int16_cells_ok`` admits is filled in int16
cells (``csrc/interpair16.cu``), as in the JAX class; no output changes.

Across processes (``torch.distributed``), ``score`` all-gathers its
scores, and ``align`` returns the alignments of this process's blocks
only: the other processes' pairs stay None, as in the JAX class.

``database`` and ``search`` score one query against many sequences
packed once onto the mesh (``parallel/search.py``): protein database
search, with no per-pair host work a request.
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from ..models.base import AlignmentResult
from ..native import bindings
from ..ops import batch_fill, batch_traceback, layout
from . import mesh as mesh_lib

# Device budget for one chunk's direction words on each entry of the
# mesh; buckets of big pairs are aligned in chunks under it.  Same name
# and default as the JAX package.
DIRS_HBM_BUDGET = 2 << 30
# Pairs of one align chunk at most: a bucket is cut into chunks of this
# size so that the host's download and native emit of one chunk overlap
# the devices' fill and walk of the next.  The JAX package's default.
PIPELINE_PAIRS = 16384
# Chunks dispatched to the devices and not yet downloaded, and downloaded
# chunks waiting for the emit thread: at most this many of each (each
# chunk holds one block of pinned outputs an entry of the mesh).
MAX_PENDING = 2


def _align_pad(length: int) -> int:
    return max(128, -(-length // 128) * 128)


@dataclasses.dataclass
class _Bucket:
    indices: list
    n_pad: int
    m_pad: int


def cell16_for(n_pad: int, m_pad: int, score_matrix, k_alpha: int, gap,
               gap_extend=None) -> bool:
    """Whether a bucket of padded shape (n_pad, m_pad) takes the int16
    cells: never under ``SEQALIGN_INT16_CELLS=0``; where
    ``int16_cells_ok`` admits it under ``auto``; always under ``1``, which
    refuses a bucket it does not admit, with the JAX ValueError."""
    mode = config.int16_cells()
    if mode == "0":
        return False
    ok = batch_fill.int16_cells_ok(n_pad, m_pad, score_matrix, k_alpha, gap,
                                   gap_extend)
    if mode == "1" and not ok:
        raise ValueError(
            "SEQALIGN_INT16_CELLS=1 but the padded shapes/scores "
            "exceed the int16 value cap (int16_cells_ok is False)")
    return ok


def _replicas(mesh, array, cache=None):
    """``array`` for every local entry of the mesh (the JAX
    ``replicated``), each copy made on its entry's stream, which reads it;
    ``cache`` keeps them across calls, by entry."""
    cache = {} if cache is None else cache
    for e, device in enumerate(mesh.devices):
        if e not in cache:
            with mesh.on(e):
                cache[e] = torch.as_tensor(array).to(device)
    return [cache[e] for e in range(mesh.local_size)]


def sharded_batch_score(mesh, texts, patterns, ns, ms, score_matrix, gap,
                        local: bool = False, semi: bool = False,
                        gap_extend=None, uniform: bool = False
                        ) -> np.ndarray:
    """Scores of a padded batch over ``mesh`` (the JAX
    ``sharded_batch_score``).  texts (B, N) and patterns (B, M) are host
    letter arrays (int8 or int32), ns and ms (B,) int32 lengths (0 for
    padding pairs), score_matrix (k, k); B is a multiple of ``mesh.size``.
    Each local entry fills its block with K3 on its own stream (int16
    cells as ``cell16_for`` decides over (N, M)); the blocks' scores come
    back in global order, all-gathered from every process.  ``uniform``
    is the JAX signature's (its kernel then drops the masking of cells
    past a pair's lengths); the port's K3 masks every cell, so it changes
    nothing.  Returns (B,) int32: padding pairs score as
    ``batch_fill.batch_score`` says."""
    del uniform
    texts, patterns, ns, ms = (np.asarray(x) for x in (texts, patterns, ns,
                                                       ms))
    k = score_matrix.shape[0]
    cell16 = cell16_for(texts.shape[1], patterns.shape[1], score_matrix, k,
                        gap, gap_extend)
    sms = _replicas(mesh, score_matrix)
    b = texts.shape[0]
    scores = []
    for e, device in enumerate(mesh.devices):
        rows = mesh.rows(b, e)
        with mesh.on(e):
            block = [torch.from_numpy(np.ascontiguousarray(x[rows])).to(
                device, non_blocking=True) for x in (texts, patterns, ns,
                                                     ms)]
            scores.append(batch_fill.batch_score(
                *block, sms[e], gap, k, local=local, semi=semi,
                gap_extend=gap_extend, cell16=cell16))
    host = []
    for e, s in enumerate(scores):
        with mesh.on(e):
            host.append(s.cpu())
    return mesh.all_gather(torch.cat(host)).numpy()


class BatchAligner:
    """Length-bucketed many-pair scorer and aligner over a device mesh.

    The JAX class's constructor.  ``mesh`` is a ``parallel/mesh.DataMesh``;
    ``device`` stays as the shorthand for a mesh of that one device in
    this process, and neither given means ``make_data_mesh()`` (every
    visible CUDA device).  ``gap_extend``: affine (Gotoh) gap costs, a run
    of length L costing gap_penalty + (L-1)*gap_extend, with gap_penalty
    >= gap_extend; None is the linear model.  On a CUDA entry every block
    runs through K3 and K4 (their affine instances with ``gap_extend``);
    the plain PyTorch versions run only on a CPU entry.  A failed launch
    or collective raises: no entry's work moves to another device.
    """

    def __init__(self, score_matrix: np.ndarray, alphabet_size: int,
                 gap_penalty: int, local: bool = False, semi: bool = False,
                 gap_extend: Optional[int] = None, mesh=None, device=None):
        if gap_extend is not None and gap_penalty < gap_extend:
            raise ValueError("affine gaps require gap_penalty >= gap_extend")
        if semi and local:
            raise ValueError("semi is exclusive with local")
        if mesh is not None and device is not None:
            raise ValueError("give a mesh or a device, not both")
        k = alphabet_size
        sm = np.asarray(score_matrix, dtype=np.int32).reshape(-1)[:k * k]
        # Raises ValueError for |score| > 127, the JAX engines' contract.
        self.score_matrix = layout.pack_score_matrix(sm.reshape(k, k), k)
        self.alphabet_size = k
        self.gap_penalty = int(gap_penalty)
        self.gap_extend = None if gap_extend is None else int(gap_extend)
        self.local = local
        self.semi = semi
        if device is not None:
            mesh = mesh_lib.DataMesh([device])
        self.mesh = mesh if mesh is not None else mesh_lib.make_data_mesh()
        self._sm_cache = {}

    @staticmethod
    def _pairs(texts, patterns):
        """The sequences as lists of arrays (no copies of their letters)."""
        texts = [np.asarray(t) for t in texts]
        patterns = [np.asarray(p) for p in patterns]
        if len(texts) != len(patterns):
            raise ValueError(f"{len(texts)} texts but {len(patterns)} "
                             f"patterns")
        return texts, patterns

    def _check_letters(self, letters):
        """ValueError unless every letter lies in 0..alphabet_size-1 (the
        kernels read int8 letters)."""
        if letters.size and (letters.min() < 0
                             or letters.max() >= self.alphabet_size):
            raise ValueError(f"letters must lie in 0..{self.alphabet_size - 1}")

    @staticmethod
    def _buckets(texts, patterns, pad_text, pad_pattern) -> list[_Bucket]:
        """Group the pairs with no empty sequence by their padded shape
        (pad_text(n), pad_pattern(m)); empty ones go to the oracle."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (t, p) in enumerate(zip(texts, patterns)):
            if len(t) == 0 or len(p) == 0:
                continue
            groups.setdefault((pad_text(len(t)), pad_pattern(len(p))),
                              []).append(i)
        return [_Bucket(idx, n_pad, m_pad)
                for (n_pad, m_pad), idx in sorted(groups.items())]

    def _oracle_degenerate(self, out, results, texts, patterns):
        """Score (``out``) or align (``results``) the pairs with an empty
        sequence through the native oracle, the source of truth on every
        input."""
        algo = 2 if self.semi else (1 if self.local else 0)
        k = self.alphabet_size
        for i, (t, p) in enumerate(zip(texts, patterns)):
            if len(t) != 0 and len(p) != 0:
                continue
            self._check_letters(t)
            self._check_letters(p)
            args = (algo, t, p, self.score_matrix, k, self.gap_penalty)
            if self.gap_extend is not None:
                if out is not None:
                    out[i], _ = bindings.oracle_fill_affine(
                        *args, self.gap_extend)
                else:
                    results[i] = AlignmentResult(
                        *bindings.oracle_align_affine(*args, self.gap_extend))
            elif out is not None:
                _, out[i], _ = bindings.oracle_fill(*args)
            else:
                results[i] = AlignmentResult(*bindings.oracle_align(*args))

    def _pack(self, idx, n_pad, m_pad, b_pad, texts, patterns):
        """Host arrays of one batch: (b_pad, n_pad) and (b_pad, m_pad) int8
        letters, zero-padded, and (b_pad,) int32 lengths (0 for padding
        pairs).  ValueError unless every letter lies in the alphabet."""
        ns = np.zeros(b_pad, dtype=np.int32)
        ms = np.zeros(b_pad, dtype=np.int32)
        ns[:len(idx)] = [len(texts[i]) for i in idx]
        ms[:len(idx)] = [len(patterns[i]) for i in idx]
        return (self._rows([texts[i] for i in idx], ns, n_pad),
                self._rows([patterns[i] for i in idx], ms, m_pad), ns, ms)

    def _rows(self, seqs, lengths, width):
        """The sequences as zero-padded int8 rows, checked on the way: one
        concatenation, one range check and one masked store."""
        letters = np.concatenate(seqs)
        self._check_letters(letters)
        rows = np.zeros((lengths.shape[0], width), dtype=np.int8)
        rows[np.arange(width) < lengths[:, None]] = letters
        return rows

    def score(self, texts: Sequence[np.ndarray],
              patterns: Sequence[np.ndarray], *,
              swap: bool = True) -> np.ndarray:
        """Scores of all pairs, in order.  As in the JAX class, pairs whose
        pattern is longer than the text are swapped by default (the CLI's
        orientation; for semi-global it decides which sequence gets the
        free end gaps); ``swap=False`` scores them as given, the
        orientation ``align`` uses."""
        texts, patterns = self._pairs(texts, patterns)
        if swap:
            for i in range(len(texts)):
                if texts[i].shape[0] < patterns[i].shape[0]:
                    texts[i], patterns[i] = patterns[i], texts[i]
        out = np.zeros(len(texts), dtype=np.int32)
        self._oracle_degenerate(out, None, texts, patterns)
        quantum = self.mesh.size * batch_fill.TILE_QUANTUM
        for bucket in self._buckets(
                texts, patterns, lambda n: layout.padded_width(n) - 1,
                layout.padded_rows):
            b = len(bucket.indices)
            arrays = self._pack(bucket.indices, bucket.n_pad, bucket.m_pad,
                                -(-b // quantum) * quantum, texts, patterns)
            scores = sharded_batch_score(
                self.mesh, *arrays, self.score_matrix, self.gap_penalty,
                local=self.local, semi=self.semi, gap_extend=self.gap_extend)
            out[bucket.indices] = scores[:b]
        return out

    def database(self, sequences: Sequence[np.ndarray]):
        """The ``sequences`` (letter arrays) packed and uploaded once for
        ``search``: a ``parallel.search.Database`` on this aligner's
        mesh."""
        from . import search

        return search.Database(sequences, self.mesh, self.alphabet_size)

    def search(self, query: np.ndarray, database) -> np.ndarray:
        """(database.size,) int32 scores of ``query`` against every
        sequence of ``database`` (made by ``database``), in its order:
        the sequence the text and the query the pattern, as
        ``score(sequences, [query] * size, swap=False)`` gives them."""
        from . import search

        return search.search(self, query, database)

    def _dirs_tile_pairs(self, n_pad: int, m_pad: int,
                         d_count: int = 1) -> tuple[int, int]:
        """(tile_pairs, chunk_pairs) of an align bucket over ``d_count``
        mesh entries.  The kernels coalesce over any 32 neighbouring pairs,
        so the tile is only the unit of the JAX word layout: its smallest,
        128, pads an entry's block by fewer than 128 pairs.  An entry's
        words (both planes with affine gaps, where the JAX class counts
        one) stay under DIRS_HBM_BUDGET (at least one tile), and a chunk's
        pairs under PIPELINE_PAIRS, rounded up to whole tiles on every
        entry.  The chunking changes no output: every pair is filled and
        walked on its own."""
        tile = batch_fill.TILE_QUANTUM
        planes = 1 if self.gap_extend is None else 2
        words_bytes = planes * (m_pad // 16) * n_pad * 4
        per_entry = max(tile, DIRS_HBM_BUDGET // words_bytes // tile * tile)
        quantum = tile * d_count
        return tile, min(per_entry * d_count,
                         -(-PIPELINE_PAIRS // quantum) * quantum)

    def align(self, texts: Sequence[np.ndarray],
              patterns: Sequence[np.ndarray]) -> list:
        """Full alignments of all pairs, as given (no swap: the tie policy
        depends on the orientation).  Returns one ``AlignmentResult`` a
        pair (alphabet indices, gap == alphabet size), byte-identical to
        the oracle; each owns its arrays.  Across processes, the pairs of
        the other processes' blocks stay None (the JAX contract: move
        lists are too large to all-gather); pairs with an empty sequence,
        which the oracle aligns, are in every process's results.

        Buckets are cut into chunks (``_dirs_tile_pairs``), each padded to
        whole tiles on every entry of the mesh.  A chunk's fill and walk
        are queued on each entry's stream with its small outputs' copy to
        the host behind them; the host collects one chunk behind the
        devices and replays the moves on a worker thread, so downloads
        and the native emit overlap the next chunk's fill.
        """
        texts, patterns = self._pairs(texts, patterns)
        results: list = [None] * len(texts)
        self._oracle_degenerate(None, results, texts, patterns)
        # Align buckets quantise both lengths to 128 (the JAX align
        # buckets); the walk's buffer holds n_pad + m_pad moves.
        buckets = self._buckets(texts, patterns, _align_pad, _align_pad)

        pending: collections.deque = collections.deque()
        emits: collections.deque = collections.deque()
        with ThreadPoolExecutor(max_workers=1) as emitter:
            def collect():
                host = self._download_bucket(pending.popleft())
                if len(emits) >= MAX_PENDING:
                    emits.popleft().result()
                emits.append(emitter.submit(self._emit_bucket, host,
                                            results))

            for bucket in buckets:
                n_pad, m_pad, idx = bucket.n_pad, bucket.m_pad, bucket.indices
                tile_pairs, chunk = self._dirs_tile_pairs(n_pad, m_pad,
                                                          self.mesh.size)
                for c0 in range(0, len(idx), chunk):
                    pending.append(self._dispatch_bucket(
                        idx[c0:c0 + chunk], n_pad, m_pad, tile_pairs,
                        texts, patterns))
                    if len(pending) >= MAX_PENDING:
                        collect()
            while pending:
                collect()
            while emits:
                emits.popleft().result()
        return results

    def _dispatch_bucket(self, idx, n_pad, m_pad, tile_pairs, texts,
                         patterns):
        """Queue one chunk's uploads, fills (K3), walks (K4) and the copy
        of their outputs to the host, one block a local entry of the mesh
        on its stream; returns what collecting it needs.  Entries whose
        block holds padding pairs only get no work."""
        mesh = self.mesh
        cell16 = cell16_for(n_pad, m_pad, self.score_matrix,
                            self.alphabet_size, self.gap_penalty,
                            self.gap_extend)
        quantum = tile_pairs * mesh.size
        b_pad = -(-len(idx) // quantum) * quantum
        t_arr, p_arr, ns, ms = self._pack(idx, n_pad, m_pad, b_pad, texts,
                                          patterns)
        sms = _replicas(mesh, self.score_matrix, self._sm_cache)
        max_len = -(-(n_pad + m_pad) // 16) * 16
        blocks = []
        for e, device in enumerate(mesh.devices):
            rows = mesh.rows(b_pad, e)
            if rows.start >= len(idx):
                continue
            with mesh.on(e):
                t_dev, p_dev, ns_dev, ms_dev = (
                    torch.from_numpy(x[rows]).to(device, non_blocking=True)
                    for x in (t_arr, p_arr, ns, ms))
                out = batch_fill.batch_fill_dirs(
                    t_dev, p_dev, ns_dev, ms_dev, sms[e], self.gap_penalty,
                    self.alphabet_size, local=self.local, semi=self.semi,
                    tile_pairs=tile_pairs, gap_extend=self.gap_extend,
                    cell16=cell16)
                scores, bis, bjs, dirs = out[:4]
                dirs2 = out[4] if self.gap_extend is not None else None
                if self.local:
                    # No-match pairs (best <= 0): an empty alignment with
                    # the reference's cursor sentinels.
                    matched = scores > 0
                    bis = torch.where(matched, bis, 0)
                    bjs = torch.where(matched, bjs, 0)
                packed, lengths, _, j_fin = batch_traceback.batch_walk(
                    dirs, ns_dev, ms_dev, bis, bjs, self.local, self.semi,
                    max_len, dirs2=dirs2)
                outs = (scores, bis, bjs, packed, lengths, j_fin)
                done = None
                if device.type == "cuda":
                    host = tuple(torch.empty(x.shape, dtype=x.dtype,
                                             pin_memory=True) for x in outs)
                    for h, x in zip(host, outs):
                        h.copy_(x, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(mesh.streams[e])
                    outs = host
            blocks.append((rows, outs, done))
        return idx, t_arr, p_arr, ns, ms, blocks

    @staticmethod
    def _download_bucket(pending):
        """Wait for one chunk's outputs on the host (only that chunk's
        work, not the chunks queued after it); returns one host tuple a
        block, its pairs' indices first."""
        idx, t_arr, p_arr, ns, ms, blocks = pending
        host = []
        for rows, outs, done in blocks:
            if done is not None:
                done.synchronize()
            host.append((idx[rows.start:rows.stop], t_arr[rows], p_arr[rows],
                         ns[rows], ms[rows]) + tuple(x.numpy() for x in outs))
        return host

    def _emit_bucket(self, host, results):
        """Replay one chunk's moves, one native call a block (numpy and
        ctypes only, so it runs on the worker thread), into results."""
        for block in host:
            self._emit_block(block, results)

    def _emit_block(self, block, results):
        (idx, t_arr, p_arr, ns, ms, scores, bis, bjs, packed, lengths,
         j_fin) = block
        if self.local or self.semi:
            start_is, start_js = bis, bjs
        else:
            start_is, start_js = ms, ns
        # Mode 2 replays affine walks in every alignment mode, as the JAX
        # class does.
        mode = 2 if self.gap_extend is not None else (1 if self.local else 0)
        at_all, ap_all, st_all, sp_all = bindings.emit_moves_batch(
            packed.T, lengths, start_is, start_js, mode, t_arr, p_arr,
            self.alphabet_size)
        lengths = lengths.tolist()
        scores = scores.tolist()
        if self.semi:
            starts = zip(j_fin.tolist(), [0] * len(idx))
        else:
            starts = zip(st_all.tolist(), sp_all.tolist())
        for row, (i, (st, sp)) in enumerate(zip(idx, starts)):
            ln = lengths[row]
            results[i] = AlignmentResult(
                aligned_text=at_all[row, :ln].copy(),
                aligned_pattern=ap_all[row, :ln].copy(),
                start_in_aligned_text=st,
                start_in_aligned_pattern=sp,
                score=scores[row],
            )
