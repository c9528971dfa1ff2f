"""Request/Response value types.

Equivalents of the reference's core structs
(reference: SequenceAlignment.hpp:71-120).  Sequences are held as numpy
int8 arrays of alphabet indices (the reference stores index bytes in
char buffers); the substitution matrix is an int32 numpy array.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants
from .constants import AlignmentType, Device, SequenceType


@dataclasses.dataclass
class Request:
    """One alignment request (reference: SequenceAlignment.hpp:71-99)."""

    device_type: Device = constants.DEFAULT_DEVICE
    sequence_type: SequenceType = constants.DEFAULT_SEQUENCE
    alignment_type: AlignmentType = constants.DEFAULT_ALIGNMENT_TYPE
    # Alphabet-index encodings.  ``text`` is always the longer sequence
    # (columns of the DP matrix); ``pattern`` the shorter (rows).
    text: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int8)
    )
    pattern: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int8)
    )
    alphabet: tuple[str, ...] = constants.DNA_ALPHABET
    alphabet_size: int = constants.NUM_DNA_CHARS
    # Row-major (alphabet_size x alphabet_size) integer substitution matrix.
    score_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(
            (constants.NUM_PROTEIN_CHARS, constants.NUM_PROTEIN_CHARS),
            dtype=np.int32,
        )
    )
    gap_penalty: int = constants.DEFAULT_GAP_PENALTY
    # Extension beyond the reference: affine (Gotoh) gap costs when set —
    # a run of length L costs gap_penalty + (L-1)*gap_extend.
    gap_extend: "int | None" = None

    @property
    def text_num_bytes(self) -> int:
        return int(self.text.shape[0])

    @property
    def pattern_num_bytes(self) -> int:
        return int(self.pattern.shape[0])

    def set_sequence_type(self, sequence_type: SequenceType) -> None:
        self.sequence_type = sequence_type
        self.alphabet = constants.alphabet_for(sequence_type)
        self.alphabet_size = constants.alphabet_size_for(sequence_type)


@dataclasses.dataclass
class Response:
    """One alignment result (reference: SequenceAlignment.hpp:101-120)."""

    aligned_text: str = ""
    aligned_pattern: str = ""
    start_in_aligned_text: int = 0
    start_in_aligned_pattern: int = 0
    score: int = 0

    @property
    def num_alignment_bytes(self) -> int:
        return len(self.aligned_text)
