"""query_p90_ms (ms, client layer, host clock): the 90th percentile, by
nearest rank, of the client wall of every statement answered inside the
window. A window of the cell's length holds more than 100 of them, so
that 10 or more lie beyond it (PERF.md)."""

import math


def read(w):
    walls = sorted(r["recv"] - r["send"] for r in w.done)
    if not walls:
        return None
    return walls[math.ceil(0.9 * len(walls)) - 1] * 1e3
