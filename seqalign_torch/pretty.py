"""EMBOSS-style alignment report, byte-compatible with the reference
pretty printer (reference: utilities.cpp:253-315), including its quirks:

* the pattern line's left-hand index is the block offset ``i+1`` without
  the pattern start offset, while its right-hand index omits the offset
  entirely;
* percentages print with 3 significant digits (C++ setprecision(3)).
"""

from __future__ import annotations

import sys
from typing import TextIO

from .types import Response

_CHARS_PER_LINE = 50


def _sig3(x: float) -> str:
    # std::ostream with precision(3): up to 3 significant digits, trailing
    # zeros trimmed, no exponent for the magnitudes that occur here.
    return f"{x:.3g}"


def pretty_alignment_print(response: Response, stream: TextIO = sys.stdout) -> None:
    n = response.num_alignment_bytes
    if n == 0:
        return

    max_i = n + max(response.start_in_aligned_text, response.start_in_aligned_pattern)
    width = 0
    while True:
        max_i //= 10
        width += 1
        if max_i == 0:
            break

    text = response.aligned_text
    pattern = response.aligned_pattern
    num_identity = 0
    num_gaps = 0
    for i in range(0, n, _CHARS_PER_LINE):
        j = min(i + _CHARS_PER_LINE, n)
        text_idx = i + 1 + response.start_in_aligned_text
        pattern_idx = j + response.start_in_aligned_pattern

        stream.write(f"{text_idx:>{width}} {text[i:j]}   {pattern_idx} \n")

        rail = []
        for k in range(i, j):
            if text[k] == pattern[k]:
                rail.append("|")
                num_identity += 1
            elif text[k] == "-" or pattern[k] == "-":
                rail.append(" ")
                num_gaps += 1
            else:
                rail.append(".")
        stream.write(f"{' ':>{width}} {''.join(rail)}\n")

        stream.write(f"{i + 1:>{width}} {pattern[i:j]}   {j}\n\n")

    stream.write(
        f"# Length: \t{n}\n"
        f"# Identity: \t{num_identity}/{n} ({_sig3(num_identity / n * 100)}%)\n"
        f"# Gaps: \t{num_gaps}/{n} ({_sig3(num_gaps / n * 100)}%)\n"
        f"# Score: \t{response.score}\n"
    )
