"""One query against the whole database a request, through
``seqalign_torch``'s ``BatchAligner.search`` over a ``Database`` built
once in set-up (by the first request: the warm-up).

A request's answer is the scores of every database sequence, in database
order.  The check judges, of each sampled request, every planted homolog
of its query, the ``check.always`` longest database sequences (the
titin and those next to it, where a long tail of the database goes), the
answer's 20 highest scores and ``check.sequences`` database sequences
drawn from the seed (``check.longest`` of them from the longest
``check.longest_share`` of the database) against the plain reference
(``cellbench.reference.affine``): any score that differs makes the
request wrong.
"""

from __future__ import annotations

import numpy as np

from ..pool import seeded
from ..reference import affine

# Benchmark spans around program functions (label -> module, function).
SPANS = {"dispatch": ("seqalign_torch.parallel.search", "dispatch")}
ALIGNS = False
CONTROLS = ("int8", "linear")
TOP = 20


class Entry:
    def __init__(self, config: dict, traffic: dict, device):
        from seqalign_torch.parallel import BatchAligner

        if not hasattr(BatchAligner, "search"):
            raise RuntimeError("seqalign_torch's BatchAligner has no "
                               "database search")
        self._aligner = BatchAligner(
            np.asarray(config["score_matrix"], dtype=np.int32),
            len(config["alphabet"]), config["gap_penalty"], local=True,
            gap_extend=config["gap_extend"], device=device)
        self._source = self._db = None

    def run(self, item):
        if item["db"] is not self._source:
            self._db = self._aligner.database(item["db"].sequences())
            self._source = item["db"]
        return self._aligner.search(item["query"], self._db)


def missing(item, answer) -> int:
    """Database sequences of the request without a score."""
    if answer is None:
        return item["pairs"]
    return max(0, item["pairs"] - len(answer))


def moves(item, answer) -> int:
    return 0


def judged(traffic: dict, item, answer) -> np.ndarray:
    """The database indices judged of a request: the query's homologs,
    the database's ``check.always`` longest, the answer's TOP highest
    scores, and a draw from the seed."""
    db, check = item["db"], traffic["check"]
    rng = seeded(db.seed, 7, sum(map(ord, item["id"])))
    size = db.lengths.shape[0]
    by_length = np.argsort(-db.lengths, kind="stable")
    longest = by_length[:max(1, int(size * check["longest_share"]))]
    drawn = [rng.choice(longest, size=min(check["longest"], len(longest)),
                        replace=False),
             rng.choice(size, size=min(check["sequences"] - check["longest"],
                                       size), replace=False)]
    top = ([] if answer is None or len(answer) != size
           else np.argsort(-np.asarray(answer), kind="stable")[:TOP])
    return np.unique(np.concatenate(
        [db.homologs[item["id"]], by_length[:check["always"]], top,
         *drawn]).astype(np.int64))


def _reference(config, item, idx, device, **control) -> np.ndarray:
    db = item["db"]
    extend = control.pop("extend", config["gap_extend"])
    return affine.local_scores([db.sequence(i) for i in idx], item["query"],
                               config["score_matrix"], config["gap_penalty"],
                               extend, device=device, **control)


def check(config: dict, traffic: dict, samples, device) -> list:
    """One reason (None: equal to the reference's) a judged database
    sequence of each sampled request: ``missing`` or ``score``."""
    reasons = []
    for item, answer in samples:
        idx = judged(traffic, item, answer)
        want = _reference(config, item, idx, device)
        if answer is None or len(answer) != item["pairs"]:
            reasons += ["missing"] * len(idx)
            continue
        got = np.asarray(answer)[idx]
        reasons += [None if g == w else "score" for g, w in zip(got, want)]
    return reasons


def control(config: dict, traffic: dict, samples, device, kind) -> list:
    """The program's answers with the judged sequences' scores computed as
    the control ``kind`` computes them: ``int8`` cells saturating at 127,
    or ``linear`` gaps (``gap_extend`` ignored)."""
    out = []
    for item, answer in samples:
        idx = judged(traffic, item, answer)
        wrong = np.array(answer, dtype=np.int64)
        wrong[idx] = _reference(
            config, item, idx, device,
            **({"saturate": 127} if kind == "int8"
               else {"extend": config["gap_penalty"]}))
        out.append(wrong)
    return out
