"""Seeded GL04 violation: a fail_point() site naming a point nobody
registered — at runtime it only WARNs once and never fires."""

from ....common import failpoint as _fp


def flush_with_typo():
    _fp.fail_point("flush_memtabel_typo_never_registered")
