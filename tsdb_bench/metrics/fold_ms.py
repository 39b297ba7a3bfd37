"""fold_ms (ms, query/ir layer, program spans): per statement, the
seconds of `tpu_execute` less those of its `region_scan` spans inside
the window: the dispatch, a fused statement's wait for its leader's
scan, the fold across regions and `_finalize`."""


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    return (w.span_seconds("tpu_execute") -
            w.span_seconds("region_scan")) / n * 1e3
