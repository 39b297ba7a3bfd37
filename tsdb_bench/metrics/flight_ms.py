"""flight_ms (ms, servers/flight layer, program spans): per statement,
the seconds of the clients' walls inside the window less those of the
`execute_stmt` spans (the frontend's statement) inside it: the Flight
server's threads, the answer's encoding and decoding, and the waits for
the interpreter's lock around them. Statements count as in
queries_per_s."""


def read(w):
    n = w.prorated(w.records, "send", "recv")
    if w.spans is None or n <= 0:
        return None
    return (w.client_seconds() - w.span_seconds("execute_stmt")) / n * 1e3
