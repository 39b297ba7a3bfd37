"""Seeded GL05 violation: bare RuntimeError in a retry-classified layer
(selftest/ is in the rule's scope precisely so this fixture can live
here instead of inside storage/)."""


def commit(version):
    if version < 0:
        raise RuntimeError(f"bad version {version}")
