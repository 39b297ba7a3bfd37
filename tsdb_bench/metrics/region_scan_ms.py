"""region_scan_ms (ms, query/tpu_exec region reduce layer, program
spans): per statement, the seconds of the `region_scan` spans inside the
window, in every region: the scan cache with any merge, masks, the
launch, the fetch and the collect."""


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    return w.span_seconds("region_scan") / n * 1e3
