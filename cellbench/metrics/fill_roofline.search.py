"""Share of the packed 16-bit peak that the search's fill kernels reach:
the cells the traced requests need (the query's length times the
database's residues, 10 operations a cell; ``cellbench.search_work``)
over K3's (``interpair_kernel``, ``interpair16_kernel``) and the tail's
K1 (``wavefront_strip_kernel``) device time in the trace."""

from cellbench import search_work

KERNELS = ("interpair_kernel", "interpair16_kernel", "wavefront_strip_kernel")


def read(rec):
    if rec.trace is None:
        return None
    seconds = sum(rec.trace["kernels"].get(k, 0.0) for k in KERNELS)
    return search_work.roofline_pct(rec.traced["cells"], seconds)
