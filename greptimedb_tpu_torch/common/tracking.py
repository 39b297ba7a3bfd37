"""tracked_state indirection: core runtime must not hard-depend on
devtools.

Every engine/meta/frontend structure that opts into greptsan race
detection imports :func:`tracked_state` from HERE, not from
``devtools.greptsan`` directly — a trimmed deployment that ships the
runtime without ``devtools/`` degrades to the identity function (no
tracking, no crash at import), the same contract as common/locks.py's
guarded greptsan import. With the detector off (``GREPTIME_RACE_CHECK``
unset) the imported function returns its argument unchanged too.

Reference: greptimedb_tpu/common/tracking.py.
"""

from __future__ import annotations

from typing import Any

try:
    from ..devtools.greptsan import tracked_state as tracked_state
except ImportError:
    def tracked_state(obj: Any, name: str) -> Any:
        """Identity fallback: devtools absent, nothing is tracked."""
        return obj

__all__ = ["tracked_state"]
