"""Sequence / score-matrix I-O with the reference's exact normalization.

Behavioral contract mirrored from the reference I/O layer
(reference: utilities.cpp:10-129): FASTA ``>`` header lines ignored via a
two-state machine, lowercase folded to uppercase, bytes outside A-Z
dropped, remaining letters replaced by their alphabet index, unknown
letters an error.  Score matrices are ``K*K`` whitespace-separated ints.
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO

import numpy as np

from .types import Request

# Vectorized normalization tables -------------------------------------------

_UPPER = np.arange(256, dtype=np.int32)
_UPPER[_UPPER > 90] -= 32  # reference quirk: any byte >90 gets 32 subtracted
_IS_LETTER = (_UPPER >= 65) & (_UPPER <= 90)


def _index_table(alphabet: tuple[str, ...], alphabet_size: int) -> np.ndarray:
    table = np.full(256, -1, dtype=np.int8)
    for i, ch in enumerate(alphabet[:alphabet_size]):
        table[ord(ch)] = i
    return table


def index_of_letter(letter: str, alphabet: tuple[str, ...], alphabet_size: int) -> int:
    """Index of ``letter`` in the alphabet, or -1 (reference: utilities.cpp:10-15)."""
    try:
        return alphabet[:alphabet_size].index(letter)
    except ValueError:
        return -1


def get_score(
    char1: str,
    char2: str,
    alphabet: tuple[str, ...],
    alphabet_size: int,
    score_matrix: np.ndarray,
) -> int:
    """Substitution score of a letter pair (reference: utilities.cpp:17-25)."""
    i = index_of_letter(char1, alphabet, alphabet_size)
    j = index_of_letter(char2, alphabet, alphabet_size)
    return int(score_matrix.reshape(-1)[i * alphabet_size + j])


def validate_and_transform(
    sequence: str | bytes,
    alphabet: tuple[str, ...],
    alphabet_size: int,
    err: TextIO = sys.stderr,
) -> Optional[np.ndarray]:
    """Normalize raw file text into alphabet indices.

    Returns the int8 index array, or None when a letter is outside the
    alphabet (in which case the reference's exact diagnostic is emitted).
    Mirrors utilities.cpp:31-63 including its FASTA state machine: a '>'
    anywhere outside an ignored region starts header-skipping until the
    next newline.
    """
    raw = sequence.encode("latin-1") if isinstance(sequence, str) else sequence
    data = np.frombuffer(raw, dtype=np.uint8)

    # FASTA header stripping.  '>' flips to IGNORE; '\n' while ignoring
    # flips back to READ (the newline itself is then processed in READ
    # state as a non-letter, exactly like the reference).
    if (data == ord(">")).any():
        keep = np.empty(data.shape[0], dtype=bool)
        ignoring = False
        gt, nl = ord(">"), ord("\n")
        for i, b in enumerate(data):
            if not ignoring and b == gt:
                ignoring = True
                keep[i] = True  # processed in READ state (dropped as non-letter)
            elif ignoring and b == nl:
                ignoring = False
                keep[i] = True
            else:
                keep[i] = not ignoring
        data = data[keep]

    upper = _UPPER[data]
    upper = upper[_IS_LETTER[data]]
    indices = _index_table(alphabet, alphabet_size)[upper]
    bad = np.flatnonzero(indices < 0)
    if bad.size:
        err.write(f"'{chr(int(upper[bad[0]]))}' letter not in alphabet.\n")
        return None
    return indices


def read_sequence_file(
    fname: str, request: Request, err: TextIO = sys.stderr
) -> int:
    """Read+normalize a sequence file into the request.

    The first successfully-read file fills ``text``, the second fills
    ``pattern`` (reference: utilities.cpp:65-104).  Returns 0 on success
    and -1 when the file does not exist.  An un-normalizable or empty
    file is *not* an error here; the request simply stays unfilled.
    """
    try:
        with open(fname, "rb") as f:
            contents = f.read()
    except OSError:
        err.write(f"{fname} file does not exist\n")
        return -1

    indices = validate_and_transform(
        contents, request.alphabet, request.alphabet_size, err=err
    )
    if indices is None or indices.size == 0:
        return 0
    if request.text_num_bytes == 0:
        request.text = indices
    elif request.pattern_num_bytes == 0:
        request.pattern = indices
    return 0


def parse_score_matrix_file(
    fname: str,
    alphabet_size: int,
    buffer: np.ndarray,
    err: TextIO = sys.stderr,
) -> int:
    """Parse a K*K whitespace-separated int matrix into ``buffer``.

    Mirrors utilities.cpp:106-129: a missing file prints a diagnostic but
    still returns 0 (leaving the buffer untouched); a non-integer token
    returns -1.
    """
    try:
        with open(fname, "r") as f:
            tokens = f.read().split()
    except OSError:
        err.write(f"{fname} file does not exist\n")
        return 0

    flat = buffer.reshape(-1)
    needed = alphabet_size * alphabet_size
    for k in range(needed):
        if k >= len(tokens):
            return -1
        try:
            # std::istream >> int accepts optional sign + digits only.
            flat[k] = int(tokens[k], 10)
        except ValueError:
            return -1
    return 0
