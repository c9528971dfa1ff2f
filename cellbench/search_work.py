"""The yardstick's arithmetic for the database search: the operations a
request needs and the card's peak for them.

A cell of the local affine score, H = max(0, diag + s, E, F) with E =
max(E - extend, left - gap) and F = max(F - extend, up - gap), is 10
integer operations, the count PERF.md §6 gives K3-affine score-only: 2
for E, 2 for F, 3 for H with the floor, the table index and its lookup,
and the tracker's max.  The count is of what the inputs need: the
query's length times the database's residues, m x n a pair, whatever a
kernel pads or however it fills them (K3's int32 or int16 cells, or K1
for the longest sequences).

The peak is the card's fastest rate for this recurrence: packed 16-bit
DPX (two cells a 32-bit lane), 132 SMs x 64 lanes x 2 halves x 2
operations (an add-max) x 1.98 GHz, 67 T operations a second (NVIDIA
H100 SXM at 700 W).  So a share reads the same work whichever precision
or kernel fills it, and reads under 100 % with any of them.
"""

from __future__ import annotations

OPS_PER_CELL = 10
PACKED16_OPS_PER_S = 67e12


def roofline_pct(cells: int, device_seconds: float) -> float | None:
    """Share (%) of the packed 16-bit peak that ``cells`` cells of the
    local affine score in ``device_seconds`` of kernel time reach; None
    when no kernel ran."""
    if device_seconds <= 0 or cells <= 0:
        return None
    return 100.0 * cells * OPS_PER_CELL / (PACKED16_OPS_PER_S
                                           * device_seconds)
