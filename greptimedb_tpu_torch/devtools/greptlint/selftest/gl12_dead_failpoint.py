"""Seeded GL12 violation: a registered failpoint whose only evaluation
site lives in a function no non-test code calls — arming the point in a
torture experiment would silently never fire."""

register("gl12_dead_failpoint")  # noqa: F821 — parsed, never run


def _never_called():
    fail_point("gl12_dead_failpoint")  # noqa: F821
