"""In-memory metadata KV store.

Reference behavior: src/meta-srv/src/service/store/memory.rs — `MemStore`,
the etcd stand-in used by every in-process distributed test (and the same
API shape the etcd-backed store implements: range scans by prefix, CAS).

Ported from greptimedb_tpu/meta/kv.py (a copy).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..common import failpoint as _fp

_fp.register("meta_kv_put")


class MemKv:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def range(self, prefix: str) -> List[Tuple[str, bytes]]:
        with self._lock:
            return sorted((k, v) for k, v in self._data.items()
                          if k.startswith(prefix))

    def compare_and_put(self, key: str, expect: Optional[bytes],
                        value: bytes) -> bool:
        """Atomic put iff the current value equals `expect` (None = absent)."""
        with self._lock:
            cur = self._data.get(key)
            if cur != expect:
                return False
            self._data[key] = value
            return True

    def compare_and_delete(self, key: str, expect: bytes) -> bool:
        """Atomic delete iff the current value equals `expect` (lease
        release must not clobber a lock a later holder re-acquired)."""
        with self._lock:
            if self._data.get(key) != expect:
                return False
            del self._data[key]
            return True

    def incr(self, key: str, start: int = 0) -> int:
        """Atomic counter (sequence allocation, reference sequence.rs)."""
        with self._lock:
            cur = int(self._data.get(key, str(start).encode()))
            nxt = cur + 1
            self._data[key] = str(nxt).encode()
            return nxt

    def batch(self, ops: List[Tuple[str, str, Optional[bytes]]],
              guard: Optional[Tuple[str, Optional[bytes]]] = None) -> bool:
        """Apply [(op, key, value)] atomically; op is "put" or "delete".
        `guard` = (key, expect) aborts the whole batch unless the key's
        current value equals expect (None = absent) — the etcd-txn shape
        multi-key moves (table rename) need so a crash can't leave a
        half-renamed route."""
        with self._lock:
            if guard is not None and self._data.get(guard[0]) != guard[1]:
                return False
            self._apply_batch_locked(ops)
            return True

    def _apply_batch_locked(
            self, ops: List[Tuple[str, str, Optional[bytes]]]) -> None:
        # validate before mutating: a bad op mid-list must not leave the
        # batch half-applied (all-or-nothing contract)
        for op, key, value in ops:
            if op not in ("put", "delete"):
                raise ValueError(f"unknown batch op {op!r}")
            if op == "put" and not isinstance(value, bytes):
                raise ValueError(f"batch put needs bytes for {key!r}")
        for op, key, value in ops:
            if op == "put":
                self._data[key] = value
            else:
                self._data.pop(key, None)


class FileKv(MemKv):
    """MemKv with a JSON snapshot on every mutation — the etcd stand-in
    for single-meta deployments (reference deploys etcd; route/peer state
    must survive a metasrv restart either way)."""

    def __init__(self, path: str) -> None:
        super().__init__()
        import base64
        import json
        import os
        self._path = path
        self._b64 = base64
        self._json = json
        if os.path.exists(path):
            with open(path) as f:
                doc = json.load(f)
            self._data = {k: base64.b64decode(v) for k, v in doc.items()}

    def _persist_locked(self) -> None:
        from ..utils import atomic_write
        _fp.fail_point("meta_kv_put")
        doc = {k: self._b64.b64encode(v).decode()
               for k, v in self._data.items()}
        # fsync before the rename: the rename alone orders directory
        # metadata, not the data blocks — a power cut could otherwise
        # promote an empty/short snapshot
        atomic_write(self._path, self._json.dumps(doc), tmp_prefix=".kv-")

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = value
            self._persist_locked()

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = self._data.pop(key, None) is not None
            if existed:
                self._persist_locked()
            return existed

    def compare_and_put(self, key: str, expect: Optional[bytes],
                        value: bytes) -> bool:
        with self._lock:
            cur = self._data.get(key)
            if cur != expect:
                return False
            self._data[key] = value
            self._persist_locked()
            return True

    def compare_and_delete(self, key: str,
                           expect: Optional[bytes]) -> bool:
        with self._lock:
            if self._data.get(key) != expect:
                return False
            del self._data[key]
            self._persist_locked()
            return True

    def incr(self, key: str, start: int = 0) -> int:
        with self._lock:
            cur = int(self._data.get(key, str(start).encode()))
            nxt = cur + 1
            self._data[key] = str(nxt).encode()
            self._persist_locked()
            return nxt

    def batch(self, ops: List[Tuple[str, str, Optional[bytes]]],
              guard: Optional[Tuple[str, Optional[bytes]]] = None
              ) -> bool:
        with self._lock:
            if guard is not None and self._data.get(guard[0]) != guard[1]:
                return False
            self._apply_batch_locked(ops)
            self._persist_locked()
            return True
