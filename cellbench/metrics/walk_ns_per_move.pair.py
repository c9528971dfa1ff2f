"""K2's (``walk_window_kernel``) device time in the trace over the columns
of the alignments the traced requests returned, in ns a move."""

KERNEL = "walk_window_kernel"


def read(rec):
    if rec.trace is None or not rec.traced["moves"]:
        return None
    seconds = rec.trace["kernels"].get(KERNEL, 0.0)
    return 1e9 * seconds / rec.traced["moves"] if seconds else None
