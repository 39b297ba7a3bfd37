"""finalize_ms (ms, query/ir layer, program spans): per statement, the
seconds of the `finalize` spans inside the window, summed over threads:
the fold of the regions' moment frames into the answer's groups
(`_finalize`). Statements count as in queries_per_s. Nothing where the
program opens none of these spans."""

SPANS = ("finalize",)


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    if not any(s[0] in SPANS for s in w.spans):
        return None
    return sum(w.span_seconds(s) for s in SPANS) / n * 1e3
