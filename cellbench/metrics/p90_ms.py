"""The 90th percentile (nearest rank) of the latency of every request
completed in the window, in ms."""

import math


def read(rec):
    lat = sorted(r["latency_s"] for r in rec.done)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
