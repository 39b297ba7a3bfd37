"""Seeded GL15 violation: a non-daemon thread that is never joined,
so a forgotten worker keeps the interpreter alive after main()
returns (the process hangs on exit instead of stopping)."""

import threading


def start_forever_worker(fn):
    t = threading.Thread(target=fn, name="immortal")  # greptlint: disable=GL06
    t.start()
    return t
