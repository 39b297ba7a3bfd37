"""flight_encode_ms (ms, servers/flight layer, program spans): per
statement, the seconds of the `flight_encode` spans inside the window,
summed over threads: the answer's batches encoded into Arrow as the
Flight stream pulls them. Statements count as in queries_per_s. Nothing
where the program opens none of these spans."""

SPANS = ("flight_encode",)


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    if not any(s[0] in SPANS for s in w.spans):
        return None
    return sum(w.span_seconds(s) for s in SPANS) / n * 1e3
