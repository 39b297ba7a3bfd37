"""background_pct (%, storage background layer, program spans): the
seconds of the `region_flush` and `compaction` spans inside the window,
over the window's seconds. Nothing in a mix without a writer."""


def read(w):
    if w.spans is None or not w.mix.get("writer"):
        return None
    busy = w.span_seconds("region_flush") + w.span_seconds("compaction")
    return busy / w.seconds * 100.0
