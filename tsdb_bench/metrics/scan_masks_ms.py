"""scan_masks_ms (ms, query/tpu_exec region reduce layer, program spans):
per statement, the seconds of the `scan_runs` and `scan_masks` spans
inside the window, summed over threads: the region reduce's host runs
over (series, bucket) and the tag-predicate and row masks. Statements
count as in queries_per_s. Nothing where the program opens none of these
spans."""

SPANS = ("scan_runs", "scan_masks")


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    if not any(s[0] in SPANS for s in w.spans):
        return None
    return sum(w.span_seconds(s) for s in SPANS) / n * 1e3
