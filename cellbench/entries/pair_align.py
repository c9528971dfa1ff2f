"""One pair a request through ``seqalign_torch.api.align`` on the GPU
engine: what ``python -m seqalign_torch -g`` runs for its two files.

Traffic keys: ``mode`` (``global`` or ``local``).  A request's answer is
the response's aligned strings, starts and score, judged by the
reference (``cellbench.reference.verify``).
"""

from __future__ import annotations

import io

import numpy as np

from ..dna import ALPHABET
from ..reference import verify, walk

# Benchmark spans around program functions (label -> module, function).
SPANS = {"emit": ("seqalign_torch.native.bindings", "emit_moves")}
ALIGNS = True

_INDEX = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET + "-"):
    _INDEX[ord(_c)] = _i


def _indices(text: str) -> np.ndarray:
    return _INDEX[np.frombuffer(text.encode("latin-1"), dtype=np.uint8)]


class Entry:
    def __init__(self, config: dict, traffic: dict, device):
        from seqalign_torch import api, constants, types

        self._api, self._types = api, types
        self._device_type = constants.Device.GPU
        self._mode = {"global": constants.AlignmentType.GLOBAL,
                      "local": constants.AlignmentType.LOCAL}[traffic["mode"]]
        self._sm = np.asarray(config["score_matrix"], dtype=np.int32)
        self._gap = int(config["gap_penalty"])

    def run(self, item):
        request = self._types.Request(
            device_type=self._device_type, alignment_type=self._mode,
            text=item["text"], pattern=item["pattern"],
            score_matrix=self._sm, gap_penalty=self._gap)
        response = self._types.Response()
        err = io.StringIO()
        rc = self._api.align(request, response, err=err)
        if rc != 0:
            raise RuntimeError(f"api.align returned {rc}: {err.getvalue()}")
        return response


def missing(item, answer) -> int:
    """Pairs of the request without an answer."""
    return 0 if answer is not None and answer.aligned_text else 1


def moves(item, answer) -> int:
    """Columns of the alignments the request returned."""
    return len(answer.aligned_text)


def _judged(samples):
    texts = [item["text"] for item, _ in samples]
    patterns = [item["pattern"] for item, _ in samples]
    outs = [a if a is None or isinstance(a, verify.Alignment)
            else verify.Alignment(
                _indices(a.aligned_text), _indices(a.aligned_pattern),
                a.start_in_aligned_text, a.start_in_aligned_pattern, a.score)
            for _, a in samples]
    return texts, patterns, outs


def check(config: dict, traffic: dict, samples, device) -> list:
    """Reasons (None: equal to the reference's) for the sampled pairs; an
    answer is a response of the port or a ``verify.Alignment``."""
    texts, patterns, outs = _judged(samples)
    reasons, _ = verify.check(texts, patterns, outs, config["score_matrix"],
                              config["gap_penalty"],
                              traffic["mode"] == "local", device=device)
    return reasons


CONTROLS = walk.CONTROLS


def control(config: dict, traffic: dict, samples, device, kind) -> list:
    """The control ``kind``'s answers to the sampled pairs
    (``walk.control``), to be judged in the program's place."""
    texts, patterns, outs = _judged(samples)
    return walk.control(texts, patterns, outs, config["score_matrix"],
                        config["gap_penalty"], traffic["mode"] == "local",
                        kind, device=device)
