"""frontend_ms (ms, frontend + query engine layer, program spans): per
statement, the seconds of `execute_stmt` less those of `tpu_execute`
inside the window: parse, plan, projection, ORDER BY and the answer's
batches."""


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    return (w.span_seconds("execute_stmt") -
            w.span_seconds("tpu_execute")) / n * 1e3
