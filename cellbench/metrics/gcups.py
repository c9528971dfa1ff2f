"""DP cells of every request completed in the window, over the window's
seconds, in billions a second (the single-pair cells' throughput)."""


def read(rec):
    if not rec.done:
        return None
    return sum(r["cells"] for r in rec.done) / rec.seconds / 1e9
