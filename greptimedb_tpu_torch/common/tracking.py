"""tracked_state indirection: core runtime must not hard-depend on
devtools.

Every engine structure that may opt into race detection imports
:func:`tracked_state` from HERE. The port ships no race detector
(`devtools/` is not ported), so this is the identity function: nothing
is tracked. Reference: greptimedb_tpu/common/tracking.py, whose guarded
import of its detector degrades to the same identity.
"""

from __future__ import annotations

from typing import Any


def tracked_state(obj: Any, name: str) -> Any:
    """Identity: no race detector in the port, nothing is tracked."""
    return obj


__all__ = ["tracked_state"]
