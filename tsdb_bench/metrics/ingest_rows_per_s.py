"""ingest_rows_per_s (rows/s, host clock): rows that the writer had
acknowledged, over the window's seconds; a batch in flight at either end
counts by the share of its send-to-acknowledgement time inside the
window. Nothing in a mix without a writer."""


def read(w):
    if not w.mix.get("writer"):
        return None
    return sum(b["rows"] * w.prorated([b], "send", "ack")
               for b in w.batches) / w.seconds
