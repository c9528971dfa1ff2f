"""Command-line front end.

Replicates the reference CLI's observable behavior exactly — flags,
defaults, sequential argument processing, canonical error strings, and
the text-is-always-longer swap (reference: utilities.cpp:131-241,
mainDriver.cu:4-27).  ``-g/--gpu`` selects the CUDA engine; ``--tpu`` is
kept as an alias so the same argv drives both packages.
"""

from __future__ import annotations

import re
import sys
from typing import Optional, Sequence, TextIO

from . import constants, io
from .constants import AlignmentType, Device, SequenceType
from .types import Request, Response

_FLAG_MAP = {
    "--cpu": ("device", Device.CPU),
    "-c": ("device", Device.CPU),
    "--gpu": ("device", Device.GPU),
    "-g": ("device", Device.GPU),
    "--tpu": ("device", Device.GPU),
    "--dna": ("sequence", SequenceType.DNA),
    "-d": ("sequence", SequenceType.DNA),
    "--protein": ("sequence", SequenceType.PROTEIN),
    "-p": ("sequence", SequenceType.PROTEIN),
    "--global": ("alignment", AlignmentType.GLOBAL),
    "--local": ("alignment", AlignmentType.LOCAL),
    # Extension: the reference declares SEMI_GLOBAL but maps no flag to
    # it (SequenceAlignment.hpp:17, :23-32); the usage/error strings stay
    # byte-identical to the reference.
    "--semi-global": ("alignment", AlignmentType.SEMI_GLOBAL),
    "--score-matrix": ("score_matrix", None),
    "-s": ("score_matrix", None),
    "--gap-penalty": ("gap_penalty", None),
    # Extension: affine (Gotoh) gap costs; the reference is linear-only.
    "--gap-extend": ("gap_extend", None),
}

# std::stoi semantics: optional whitespace, optional sign, leading digits;
# trailing junk ignored.
_STOI = re.compile(r"^\s*([+-]?\d+)")


def _stoi(token: str) -> Optional[int]:
    m = _STOI.match(token)
    return int(m.group(1)) if m else None


def parse_arguments(
    argv: Sequence[str], request: Request, err: TextIO = sys.stderr
) -> int:
    """Fill ``request`` from argv (argv[0] = program name). Returns 0/1."""
    if len(argv) == 1:
        err.write(constants.USAGE)
        return 1

    request.device_type = constants.DEFAULT_DEVICE
    request.set_sequence_type(constants.DEFAULT_SEQUENCE)
    request.alignment_type = constants.DEFAULT_ALIGNMENT_TYPE
    request.gap_penalty = constants.DEFAULT_GAP_PENALTY
    request.text = request.text[:0]
    request.pattern = request.pattern[:0]

    request.gap_extend = None
    score_matrix_state = "not_read"
    gap_penalty_state = "not_read"
    gap_extend_state = "not_read"
    for arg in argv[1:]:
        kind = _FLAG_MAP.get(arg)
        if kind is not None:
            what, value = kind
            if what == "device":
                request.device_type = value
            elif what == "sequence":
                request.set_sequence_type(value)
            elif what == "alignment":
                request.alignment_type = value
            elif what == "score_matrix":
                score_matrix_state = "to_read"
            elif what == "gap_penalty":
                gap_penalty_state = "to_read"
            elif what == "gap_extend":
                gap_extend_state = "to_read"
        elif gap_extend_state == "to_read":
            parsed = _stoi(arg)
            if parsed is None:
                err.write(constants.GAP_PENALTY_NOT_READ_ERROR)
                return 1
            request.gap_extend = parsed
            gap_extend_state = "read"
        elif gap_penalty_state == "to_read":
            parsed = _stoi(arg)
            if parsed is None:
                err.write(constants.GAP_PENALTY_NOT_READ_ERROR)
                return 1
            request.gap_penalty = parsed
            gap_penalty_state = "read"
        elif score_matrix_state == "to_read":
            if (
                io.parse_score_matrix_file(
                    arg, request.alphabet_size, request.score_matrix, err=err
                )
                == -1
            ):
                err.write(constants.SCORE_MATRIX_NOT_READ_ERROR)
                return 1
            score_matrix_state = "read"
        else:
            if io.read_sequence_file(arg, request, err=err) == -1:
                err.write(constants.SEQ_NOT_READ_ERROR)
                return 1

    if request.text_num_bytes == 0 or request.pattern_num_bytes == 0:
        err.write(constants.SEQ_NOT_READ_ERROR + constants.USAGE)
        return 1
    if request.text_num_bytes < request.pattern_num_bytes:
        request.text, request.pattern = request.pattern, request.text

    if score_matrix_state != "read":
        default_scores = (
            constants.DEFAULT_DNA_SCORE_MATRIX_FILE
            if request.sequence_type is SequenceType.DNA
            else constants.DEFAULT_PROTEIN_SCORE_MATRIX_FILE
        )
        io.parse_score_matrix_file(
            default_scores, request.alphabet_size, request.score_matrix, err=err
        )
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI driver: parse -> dispatch engine -> pretty print (mainDriver.cu:4-27)."""
    from . import api
    from .pretty import pretty_alignment_print

    argv = list(sys.argv if argv is None else argv)
    request = Request()
    if parse_arguments(argv, request):
        return 1
    response = Response()
    if api.align(request, response):
        return 1
    pretty_alignment_print(response, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
