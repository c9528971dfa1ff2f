"""Share of the int32 peak that the pair fill kernels reach: the work the
traced requests need (m x n cells, 11 operations a cell aligned, 5 scored;
``cellbench.work``) over K1's (``wavefront_strip_kernel``) and K5's
(``strip_band_kernel``) device time in the trace."""

from cellbench import work

KERNELS = ("wavefront_strip_kernel", "strip_band_kernel")


def read(rec):
    if rec.trace is None:
        return None
    seconds = sum(rec.trace["kernels"].get(k, 0.0) for k in KERNELS)
    return work.roofline_pct(work.ops(rec.traced["cells"], rec.aligns),
                             seconds)
