"""The long tail's cost: K1's (``wavefront_strip_kernel``) device time
in the trace per traced request, in ms."""

KERNEL = "wavefront_strip_kernel"


def read(rec):
    if rec.trace is None or not rec.traced["requests"]:
        return None
    seconds = rec.trace["kernels"].get(KERNEL, 0.0)
    return 1e3 * seconds / rec.traced["requests"] if seconds else None
