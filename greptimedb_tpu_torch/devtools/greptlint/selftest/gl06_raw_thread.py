"""Seeded GL06 violation: a bespoke thread that bypasses
common.runtime, so the worker detaches from the caller's trace and
ExecStats context."""

import threading


def start_background_flush(fn):
    t = threading.Thread(target=fn, daemon=True, name="rogue-flush")
    t.start()
    return t
