"""Length-bucketed many-pair scoring and alignment on one device.

The port of the JAX package's ``parallel/batch.py::BatchAligner`` for a
single GPU.  Pairs are grouped into buckets of one padded shape; K3
(``ops/batch_fill``) fills a bucket, 32 pairs a CTA, and, for
``align``, K4 (``ops/batch_traceback``) walks every pair's path on the
device, so only scores, best cells and 2-bit packed moves come back.
The host replays the moves through the native ``sa_emit_moves_batch``,
byte-identical to the oracle.  Pairs with an empty sequence go to the
native oracle.  Linear or affine (Gotoh) gaps: global, local and
semi-global.  Under ``SEQALIGN_INT16_CELLS`` (``config.int16_cells``) a
bucket whose padded shape ``int16_cells_ok`` admits is filled in int16
cells (``csrc/interpair16.cu``), as in the JAX class; no output changes.
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

# Device budget for one chunk's direction words; buckets of big pairs are
# aligned in chunks under it.  Same name and default as the JAX package.
DIRS_HBM_BUDGET = 2 << 30
# Pairs of one align chunk at most: a bucket is cut into chunks of this
# size so that the host's download and native emit of one chunk overlap
# the device's fill and walk of the next.  The JAX package's default.
PIPELINE_PAIRS = 16384
# Chunks dispatched to the device and not yet downloaded, and downloaded
# chunks waiting for the emit thread: at most this many of each.
MAX_PENDING = 2


def _align_pad(length: int) -> int:
    return max(128, -(-length // 128) * 128)


@dataclasses.dataclass
class _Bucket:
    indices: list
    n_pad: int
    m_pad: int


class BatchAligner:
    """Length-bucketed many-pair scorer and aligner on one device.

    The JAX class's constructor, with an explicit ``device`` (default
    ``config.device()``, so ``cuda``) in place of its mesh.
    ``gap_extend``: affine (Gotoh) gap costs, a run of length L costing
    gap_penalty + (L-1)*gap_extend, with gap_penalty >= gap_extend; None
    is the linear model.  On a CUDA device every bucket runs through K3
    and K4 (their affine instances with ``gap_extend``); the plain
    PyTorch versions run only when ``device`` is the CPU.
    """

    def __init__(self, score_matrix: np.ndarray, alphabet_size: int,
                 gap_penalty: int, local: bool = False, semi: bool = False,
                 gap_extend: Optional[int] = None, device=None):
        if gap_extend is not None and gap_penalty < gap_extend:
            raise ValueError("affine gaps require gap_penalty >= gap_extend")
        if semi and local:
            raise ValueError("semi is exclusive with local")
        k = alphabet_size
        sm = np.asarray(score_matrix, dtype=np.int32).reshape(-1)[:k * k]
        # Raises ValueError for |score| > 127, the JAX engines' contract.
        self.score_matrix = layout.pack_score_matrix(sm.reshape(k, k), k)
        self.alphabet_size = k
        self.gap_penalty = int(gap_penalty)
        self.gap_extend = None if gap_extend is None else int(gap_extend)
        self.local = local
        self.semi = semi
        self.device = torch.device(
            device if device is not None else config.device())
        self._sm_device = None

    def _sm(self) -> torch.Tensor:
        if self._sm_device is None:
            self._sm_device = torch.as_tensor(self.score_matrix).to(
                self.device)
        return self._sm_device

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

    def _cell16(self, n_pad: int, m_pad: int) -> bool:
        """Whether a bucket of padded shape (n_pad, m_pad) takes the int16
        cells: never under ``SEQALIGN_INT16_CELLS=0``; where
        ``int16_cells_ok`` admits it under ``auto``; always under ``1``,
        which refuses a bucket it does not admit, with the JAX class's
        ValueError."""
        mode = config.int16_cells()
        if mode == "0":
            return False
        ok = batch_fill.int16_cells_ok(n_pad, m_pad, self.score_matrix,
                                       self.alphabet_size, self.gap_penalty,
                                       self.gap_extend)
        if mode == "1" and not ok:
            raise ValueError(
                "SEQALIGN_INT16_CELLS=1 but the padded shapes/scores "
                "exceed the int16 value cap (int16_cells_ok is False)")
        return ok

    def _upload(self, *arrays):
        return [torch.from_numpy(a).to(self.device) for a in arrays]

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
        for bucket in self._buckets(
                texts, patterns, lambda n: layout.padded_width(n) - 1,
                layout.padded_rows):
            cell16 = self._cell16(bucket.n_pad, bucket.m_pad)
            arrays = self._pack(bucket.indices, bucket.n_pad, bucket.m_pad,
                                len(bucket.indices), texts, patterns)
            scores = batch_fill.batch_score(
                *self._upload(*arrays), self._sm(), self.gap_penalty,
                self.alphabet_size, local=self.local, semi=self.semi,
                gap_extend=self.gap_extend, cell16=cell16)
            out[bucket.indices] = scores.cpu().numpy()
        return out

    def _dirs_tile_pairs(self, n_pad: int, m_pad: int) -> tuple[int, int]:
        """(tile_pairs, chunk_pairs) of an align bucket.  The kernels
        coalesce over any 32 neighbouring pairs, so the tile is only the
        unit of the JAX word layout: its smallest, 128, pads a chunk by
        fewer than 128 pairs.  A chunk's words (both planes with affine
        gaps, where the JAX class counts one) stay under DIRS_HBM_BUDGET
        (at least one tile) and its pairs under PIPELINE_PAIRS, rounded
        up to whole tiles.  The chunking changes no output: every pair
        is filled and walked on its own."""
        tile = batch_fill.TILE_QUANTUM
        planes = 1 if self.gap_extend is None else 2
        words_bytes = planes * (m_pad // 16) * n_pad * 4
        chunk = max(tile, DIRS_HBM_BUDGET // words_bytes // tile * tile)
        return tile, min(chunk, -(-PIPELINE_PAIRS // tile) * tile)

    def align(self, texts: Sequence[np.ndarray],
              patterns: Sequence[np.ndarray]) -> list:
        """Full alignments of all pairs, as given (no swap: the tie policy
        depends on the orientation).  Returns one ``AlignmentResult`` a
        pair (alphabet indices, gap == alphabet size), byte-identical to
        the oracle; each owns its arrays.

        Buckets are cut into chunks (``_dirs_tile_pairs``).  A chunk's
        fill and walk are queued on the device with its small outputs'
        copy to the host behind them; the host collects one chunk behind
        the device and replays the moves on a worker thread, so
        downloads and the native emit overlap the next chunk's fill.
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
                tile_pairs, chunk = self._dirs_tile_pairs(n_pad, m_pad)
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
        """Queue one chunk's upload, fill (K3), walk (K4) and the copy of
        its outputs to the host; returns what collecting it needs."""
        cell16 = self._cell16(n_pad, m_pad)
        b_pad = -(-len(idx) // tile_pairs) * tile_pairs
        t_arr, p_arr, ns, ms = self._pack(idx, n_pad, m_pad, b_pad, texts,
                                          patterns)
        t_dev, p_dev, ns_dev, ms_dev = self._upload(t_arr, p_arr, ns, ms)
        out = batch_fill.batch_fill_dirs(
            t_dev, p_dev, ns_dev, ms_dev, self._sm(), self.gap_penalty,
            self.alphabet_size, local=self.local, semi=self.semi,
            tile_pairs=tile_pairs, gap_extend=self.gap_extend, cell16=cell16)
        scores, bis, bjs, dirs = out[:4]
        dirs2 = out[4] if self.gap_extend is not None else None
        if self.local:
            # No-match pairs (best <= 0): an empty alignment with the
            # reference's cursor sentinels.
            matched = scores > 0
            bis = torch.where(matched, bis, 0)
            bjs = torch.where(matched, bjs, 0)
        max_len = -(-(n_pad + m_pad) // 16) * 16
        packed, lengths, _, j_fin = batch_traceback.batch_walk(
            dirs, ns_dev, ms_dev, bis, bjs, self.local, self.semi, max_len,
            dirs2=dirs2)
        outs = (scores, bis, bjs, packed, lengths, j_fin)
        done = None
        if self.device.type == "cuda":
            host = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         for x in outs)
            for h, x in zip(host, outs):
                h.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            outs = host
        return idx, t_arr, p_arr, ns, ms, outs, done

    @staticmethod
    def _download_bucket(pending):
        """Wait for one chunk's outputs on the host (only that chunk's
        work, not the chunks queued after it)."""
        idx, t_arr, p_arr, ns, ms, outs, done = pending
        if done is not None:
            done.synchronize()
        return (idx, t_arr, p_arr, ns, ms) + tuple(x.numpy() for x in outs)

    def _emit_bucket(self, host, results):
        """Replay one chunk's moves through one native call (numpy and
        ctypes only, so it runs on the worker thread) into results."""
        (idx, t_arr, p_arr, ns, ms, scores, bis, bjs, packed, lengths,
         j_fin) = host
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
