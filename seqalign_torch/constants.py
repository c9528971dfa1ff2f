"""Core constants of the alignment contract.

The reference engine's public contract (reference:
SequenceAlignment.hpp:10-68).  Alphabets, default program arguments,
canonical user-facing message strings and the direction encoding are
observable behavior and therefore preserved bit-for-bit.
"""

from __future__ import annotations

import enum


class Device(enum.Enum):
    """Execution backend for a request (reference: programArgs CPU/GPU).

    CPU means the native C++ oracle engine and GPU the CUDA engine
    (``--tpu`` is accepted as an alias of ``-g`` on the command line).
    """

    CPU = "cpu"
    GPU = "gpu"


class SequenceType(enum.Enum):
    DNA = "dna"
    PROTEIN = "protein"


class AlignmentType(enum.Enum):
    GLOBAL = "global"
    LOCAL = "local"
    # Declared but unimplemented in the reference (SequenceAlignment.hpp:17);
    # kept for CLI-surface parity.
    SEMI_GLOBAL = "semi_global"


# Direction encoding for traceback matrices (reference: SequenceAlignment.hpp:122).
LEFT = 0
DIAG = 1
TOP = 2
STOP = 3

NUM_DNA_CHARS = 4
NUM_PROTEIN_CHARS = 23

# Scored characters + trailing gap character.  A letter is encoded as its
# index in this tuple (reference: SequenceAlignment.hpp:56-58).
DNA_ALPHABET = ("A", "T", "C", "G", "-")
PROTEIN_ALPHABET = (
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I", "L", "K",
    "M", "F", "P", "S", "T", "W", "Y", "V", "B", "Z", "X", "-",
)

DEFAULT_DEVICE = Device.CPU
DEFAULT_SEQUENCE = SequenceType.DNA
DEFAULT_ALIGNMENT_TYPE = AlignmentType.GLOBAL
DEFAULT_GAP_PENALTY = 5
DEFAULT_DNA_SCORE_MATRIX_FILE = "scoreMatrices/dna/blast.txt"
DEFAULT_PROTEIN_SCORE_MATRIX_FILE = "scoreMatrices/protein/blosum50.txt"

# Canonical user messages (reference: SequenceAlignment.hpp:35-50).  The
# test suite string-compares stderr against these, so they are fixed.
USAGE = """\
Usage: ./alignSequence [-d|-p] [-c|-g] [--global|--local] [-s <file>] [--gap-penalty <int>] <file> <file>
       -d, --dna             - align dna sequences (default)
       -p, --protein         - align protein sequence
       -c, --cpu             - use cpu device (default)
       -g, --gpu             - use gpu device
       --global              - use global alignment (default)
       --local               - use local alignment
       -s, --score-matrix    - next argument is a score matrix file
       --gap-penalty         - next argument is a gap open penalty (default 5)
"""
SEQ_NOT_READ_ERROR = "error: text sequence or pattern sequence not read\n"
MEM_ERROR = "error: sequence is too long, not enough memory\n"
SCORE_MATRIX_NOT_READ_ERROR = (
    "error: matrix scores not read. Only integer scores accepted (int)\n"
)
GAP_PENALTY_NOT_READ_ERROR = (
    "error: gap penalty not read. Only integer scores accepted (int)\n"
)


def alphabet_for(sequence_type: SequenceType) -> tuple[str, ...]:
    return DNA_ALPHABET if sequence_type is SequenceType.DNA else PROTEIN_ALPHABET


def alphabet_size_for(sequence_type: SequenceType) -> int:
    return (
        NUM_DNA_CHARS
        if sequence_type is SequenceType.DNA
        else NUM_PROTEIN_CHARS
    )
