"""Retrying object-store wrapper: exponential backoff + jitter over
transient faults.

Reference behavior: opendal's retry layer (the reference wraps its S3
operator in `RetryLayer` with exponential backoff) — transient service
errors (HTTP 5xx/429, socket resets) retry transparently; logical errors
(404, signature mismatch) surface immediately. Only idempotent operations
retry: whole-object GET/PUT/DELETE/HEAD/LIST all are, which is every
operation this interface exposes.

Knobs (live — SET applies to in-flight stores):

- ``GREPTIME_OBJSTORE_MAX_RETRIES`` / ``SET objstore_max_retries`` —
  attempts AFTER the first try (default 3; 0 disables retry).
- ``GREPTIME_OBJSTORE_RETRY_BASE_MS`` / ``SET objstore_retry_base_ms`` —
  first backoff; doubles per attempt, capped at 5s, ±50% jitter.

Counters (runtime_metrics / /metrics): ``greptime_objstore_retry_total``
(sleeps taken), ``greptime_objstore_retry_giveup_total`` (transient
failures that exhausted the budget and surfaced).
"""

from __future__ import annotations

import logging
import random
import time
from typing import List, Optional

from ..utils import env_int as _env_int
from .object_store import ObjectStore, _SpoolPut

logger = logging.getLogger(__name__)

_MAX_BACKOFF_MS = 5000

_max_retries: List[int] = [_env_int("GREPTIME_OBJSTORE_MAX_RETRIES", 3)]
_base_ms: List[int] = [_env_int("GREPTIME_OBJSTORE_RETRY_BASE_MS", 50)]


def configure_retry(*, max_retries: Optional[int] = None,
                    base_ms: Optional[int] = None) -> None:
    """SET objstore_max_retries / objstore_retry_base_ms."""
    if max_retries is not None:
        _max_retries[0] = max(0, int(max_retries))
    if base_ms is not None:
        _base_ms[0] = max(1, int(base_ms))


def retry_settings() -> dict:
    return {"max_retries": _max_retries[0], "base_ms": _base_ms[0]}


def is_transient(exc: BaseException) -> bool:
    """Transient ⇔ a later identical attempt can plausibly succeed.
    FileNotFoundError and friends are logical outcomes, not faults."""
    from ..common.failpoint import FailpointError
    if isinstance(exc, FailpointError):
        return exc.transient
    from ..errors import TransientRpcError
    if isinstance(exc, TransientRpcError):
        return True
    if isinstance(exc, (FileNotFoundError, NotADirectoryError,
                        IsADirectoryError, PermissionError)):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError,
                            InterruptedError))


class RetryingObjectStore(ObjectStore):
    """Wrap any ObjectStore; every idempotent op retries transient
    faults with exponential backoff + jitter before surfacing."""

    def __init__(self, inner: ObjectStore):
        self.inner = inner

    def _with_retry(self, what: str, key: str, fn):
        from ..common.telemetry import increment_counter
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient(e) or attempt >= _max_retries[0]:
                    if attempt:
                        increment_counter("objstore_retry_giveup")
                    raise
                attempt += 1
                delay_ms = min(_base_ms[0] * (2 ** (attempt - 1)),
                               _MAX_BACKOFF_MS)
                delay_s = delay_ms / 1e3 * (0.5 + random.random())
                increment_counter("objstore_retry")
                logger.warning(
                    "objstore %s %s failed transiently (%s); retry %d/%d "
                    "in %.0fms", what, key, e, attempt, _max_retries[0],
                    delay_s * 1e3)
                time.sleep(delay_s)

    # ---- ObjectStore surface ----
    def read(self, key: str) -> bytes:
        data = self._with_retry("read", key,
                                lambda: self.inner.read(key))
        # per-read byte accounting: lands on the active statement's
        # ExecStats collector (live `bytes_read` in the processes view);
        # a thread-local read when nobody collects, so the hot path
        # stays unobserved-free
        from ..common import exec_stats
        exec_stats.record("io_read", bytes=len(data))
        return data

    def write(self, key: str, data: bytes) -> None:
        return self._with_retry("write", key,
                                lambda: self.inner.write(key, data))

    def delete(self, key: str) -> None:
        return self._with_retry("delete", key,
                                lambda: self.inner.delete(key))

    def exists(self, key: str) -> bool:
        return self._with_retry("exists", key,
                                lambda: self.inner.exists(key))

    def list(self, prefix: str) -> List[str]:
        return self._with_retry("list", prefix,
                                lambda: self.inner.list(prefix))

    def local_path(self, key: str) -> Optional[str]:
        return self.inner.local_path(key)

    def put_path(self, key: str):
        """Local backends keep their atomic in-place rename (a local
        rename has no transient failure mode worth a spool copy); remote
        backends spool here so the final upload goes through write() —
        and therefore through the retry loop."""
        if type(self.inner).put_path is not ObjectStore.put_path:
            return self.inner.put_path(key)
        return _SpoolPut(self, key)

    def delete_dir(self, key: str) -> None:
        inner_delete = getattr(self.inner, "delete_dir", None)
        if inner_delete is not None:
            self._with_retry("delete_dir", key, lambda: inner_delete(key))
        else:
            for k in self.list(key if key.endswith("/") else key + "/"):
                self.delete(k)

    def __getattr__(self, name: str):
        # pass through backend extras (root, hit_ratio, config, ...);
        # 'inner' itself must miss normally or unpickling would recurse
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)
