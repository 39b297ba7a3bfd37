"""queries_per_s (queries/s, host clock): SQL statements answered to the
clients without error, over the window's seconds. A statement in flight
at either end of the window counts by the share of its client wall that
lies inside it (`Window.prorated`), so that a few long statements do not
make the count jump by whole units."""


def read(w):
    return w.prorated(w.records, "send", "recv") / w.seconds
