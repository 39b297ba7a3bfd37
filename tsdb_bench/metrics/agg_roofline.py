"""agg_roofline (%, kernels layer, device trace): the least time the
window's statements need on the device, over the time the device was
busy (every kernel, copy and set that the profiler recorded in it).

The need is counted here from the benchmark's own statements, whatever
implements them: each statement reads, once, 4 bytes of every aggregated
field of every row it selects (the configuration's float32 device
mirror) and writes 8 bytes of every moment of every group (a count and
one per field); all of it at the H100's 3.35 TB/s. A statement counts
as in queries_per_s, by the share of its wall inside the window. Nothing
without device time.
"""

HBM_BYTES_PER_S = 3.35e12
MIRROR_BYTES = 4
MOMENT_BYTES = 8


def rows_selected(stmt, cfg):
    """Hosts times the intervals of [a, b) that the table held when the
    statement was sent."""
    iv, t0 = cfg["interval_ms"], cfg["start_ms"]
    n = int(cfg["hours"] * 3600_000 // iv) + stmt["acked"]
    lo = min(max(0, -(-(stmt["a"] - t0) // iv)), n)
    hi = min(max(0, -(-(stmt["b"] - t0) // iv)), n)
    hosts = cfg["hosts"] if stmt["hosts"] is None else len(stmt["hosts"])
    return hosts * max(0, hi - lo)


def groups(stmt, cfg):
    """Host x time-bucket groups of [a, b)."""
    B = stmt["bucket_ms"]
    hosts = cfg["hosts"] if stmt["hosts"] is None else len(stmt["hosts"])
    return hosts * ((stmt["b"] - 1) // B - stmt["a"] // B + 1)


def bytes_needed(stmt, cfg):
    f = len(stmt["fields"])
    return rows_selected(stmt, cfg) * f * MIRROR_BYTES + \
        groups(stmt, cfg) * (1 + f) * MOMENT_BYTES


def read(w):
    if w.device is None or w.device.busy_s <= 0:
        return None
    need = sum(bytes_needed(r["stmt"], w.cfg) * w.prorated([r], "send", "recv")
               for r in w.records)
    return need / HBM_BYTES_PER_S / w.device.busy_s * 100.0
