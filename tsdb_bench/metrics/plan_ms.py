"""plan_ms (ms, frontend + query engine layer, program spans): per
statement, the seconds of the `parse_sql`, `plan` and `project` spans
inside the window, summed over threads: the parse, the plan into the
device path's aggregate node with its dispatch decision, and the
projection, ORDER BY and LIMIT with the answer's batch. Statements count
as in queries_per_s. Nothing where the program opens none of these
spans."""

SPANS = ("parse_sql", "plan", "project")


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    if not any(s[0] in SPANS for s in w.spans):
        return None
    return sum(w.span_seconds(s) for s in SPANS) / n * 1e3
