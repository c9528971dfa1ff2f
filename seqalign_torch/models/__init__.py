"""Alignment model families of the GPU engine.

* :class:`NeedlemanWunsch` — global alignment (reference:
  alignSequenceCPU.cpp:203-284, alignSequenceGPU.cu:73-178).
* :class:`SmithWaterman` — local alignment (reference:
  alignSequenceCPU.cpp:116-201, alignSequenceGPU.cu:219-353).
* :class:`SemiGlobal` — "fit" alignment: pattern aligned globally, text
  end-gaps free (declared but not implemented by the reference,
  SequenceAlignment.hpp:17).
"""

from __future__ import annotations

from ..constants import AlignmentType
from .base import AlignmentResult, PairAligner
from .needleman_wunsch import NeedlemanWunsch
from .semi_global import SemiGlobal
from .smith_waterman import SmithWaterman

_GLOBAL = NeedlemanWunsch()
_LOCAL = SmithWaterman()
_SEMI = SemiGlobal()


def aligner_for(alignment_type: AlignmentType) -> PairAligner:
    if alignment_type is AlignmentType.GLOBAL:
        return _GLOBAL
    if alignment_type is AlignmentType.LOCAL:
        return _LOCAL
    if alignment_type is AlignmentType.SEMI_GLOBAL:
        return _SEMI
    raise NotImplementedError(f"{alignment_type} not implemented")


__all__ = [
    "AlignmentResult",
    "PairAligner",
    "NeedlemanWunsch",
    "SemiGlobal",
    "SmithWaterman",
    "aligner_for",
]
