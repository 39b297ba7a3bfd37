"""LRU disk read-cache layer over any ObjectStore.

Reference behavior: src/object-store/src/cache_policy.rs:38-100 —
`LruCacheLayer` caches whole-object reads on local disk with LRU
eviction by total bytes and recovers its index by scanning the cache dir
on start. Reads hit the cache first; writes/deletes invalidate. The extra
capability here: `local_path` serves the cached file so Parquet readers
mmap remote SSTs — the local disk cache feeds the host scan, and through
it the GPU, directly.

Ported from greptimedb_tpu/storage/cache.py unchanged: the same eviction
order, invalidation, corrupt-blob fallback, `cache_read` failpoint and
`read_cache_{hit,miss,corrupt}` counters.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import List, Optional

from ..common import failpoint as _fp
from ..common.locks import TrackedLock
from .object_store import ObjectStore

_fp.register("cache_read")


class LruCacheLayer(ObjectStore):
    def __init__(self, inner: ObjectStore, cache_dir: str,
                 capacity_bytes: int = 512 * 1024 * 1024):
        self.inner = inner
        self.cache_dir = os.path.abspath(cache_dir)
        self.capacity_bytes = capacity_bytes
        os.makedirs(self.cache_dir, exist_ok=True)
        # NOT io_ok=False: _admit/_evict write and unlink blob files
        # while holding this lock (admission is serialized by design)
        self._lock = TrackedLock("storage.cache")
        from ..common.tracking import tracked_state
        self._entries: "OrderedDict[str, int]" = tracked_state(
            OrderedDict(), "storage.cache.entries")       # key→bytes
        self._size = 0
        self.hits = 0
        self.misses = 0
        self._recover()

    # ---- cache index ----
    def _cache_path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(self.cache_dir, digest)

    def _recover(self) -> None:
        """Rebuild the index from cache files surviving a restart
        (reference: recover_cache on layer init, cache_policy.rs:60)."""
        for fn in sorted(os.listdir(self.cache_dir)):
            path = os.path.join(self.cache_dir, fn)
            if not os.path.isfile(path) or not fn.endswith(".key"):
                continue
            with open(path) as f:
                key = f.read()
            blob = path[:-4]
            if os.path.isfile(blob):
                size = os.path.getsize(blob)
                self._entries[key] = size
                self._size += size

    def _touch(self, key: str) -> None:
        self._entries.move_to_end(key)

    def _admit(self, key: str, data: bytes) -> str:
        path = self._cache_path(key)
        with self._lock:
            if key not in self._entries:
                from ..utils import atomic_write
                # no fsync: a torn cache blob after a crash is re-fetched
                # from the backing store, but a HALF-torn one must never
                # be readable, hence the atomic publish
                atomic_write(path, data, fsync=False)
                with open(path + ".key", "w") as f:
                    f.write(key)
                self._entries[key] = len(data)
                self._size += len(data)
                self._evict()
            else:
                self._touch(key)
        return path

    def _evict(self) -> None:
        while self._size > self.capacity_bytes and len(self._entries) > 1:
            old_key, size = self._entries.popitem(last=False)
            self._size -= size
            p = self._cache_path(old_key)
            for suffix in ("", ".key"):
                try:
                    os.unlink(p + suffix)
                except OSError:
                    pass

    def _invalidate(self, key: str) -> None:
        with self._lock:
            size = self._entries.pop(key, None)
            if size is not None:
                self._size -= size
                p = self._cache_path(key)
                for suffix in ("", ".key"):
                    try:
                        os.unlink(p + suffix)
                    except OSError:
                        pass

    def hit_ratio(self) -> float:
        """Fraction of reads served from the local cache (0.0 when the
        layer has seen no traffic) — surfaced by /status and the
        information_schema.runtime_metrics gauges."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    # ---- ObjectStore surface ----
    def read(self, key: str) -> bytes:
        from ..common.telemetry import increment_counter
        with self._lock:
            if key in self._entries:
                self._touch(key)
                path = self._cache_path(key)
                expect_size = self._entries[key]
            else:
                path = None
        if path is not None:
            try:
                _fp.fail_point("cache_read")
                with open(path, "rb") as f:
                    data = f.read()
                if len(data) != expect_size:
                    # truncated/overwritten cache blob: disk corruption,
                    # not a miss — fall through to a cold read
                    raise OSError(
                        f"cache blob for {key} is {len(data)}B, "
                        f"expected {expect_size}B")
                # count the hit only once the blob actually served: a
                # corrupt entry must not inflate the hit ratio AND the
                # miss counter for one read
                self.hits += 1
                increment_counter("read_cache_hit")
                return data
            except FileNotFoundError:
                self._invalidate(key)
            except Exception as e:  # noqa: BLE001 — degrade, don't fail
                # a corrupt cache entry must never surface to the reader:
                # drop it and serve the authoritative backend copy cold
                import logging
                logging.getLogger(__name__).warning(
                    "read cache entry for %s unusable (%s); falling back "
                    "to cold read", key, e)
                increment_counter("read_cache_corrupt")
                self._invalidate(key)
        self.misses += 1
        increment_counter("read_cache_miss")
        data = self.inner.read(key)
        self._admit(key, data)
        return data

    def write(self, key: str, data: bytes) -> None:
        self.inner.write(key, data)
        self._invalidate(key)

    def delete(self, key: str) -> None:
        self.inner.delete(key)
        self._invalidate(key)

    def delete_dir(self, key: str) -> None:
        prefix = key if key.endswith("/") else key + "/"
        with self._lock:
            stale = [k for k in self._entries if k.startswith(prefix)]
        for k in stale:
            self._invalidate(k)
        if hasattr(self.inner, "delete_dir"):
            self.inner.delete_dir(key)
        else:
            for k in self.inner.list(prefix):
                self.inner.delete(k)

    def exists(self, key: str) -> bool:
        with self._lock:
            if key in self._entries:
                return True
        return self.inner.exists(key)

    def list(self, prefix: str) -> List[str]:
        return self.inner.list(prefix)

    def local_path(self, key: str) -> Optional[str]:
        """Cached objects are local files — Parquet readers mmap them."""
        inner_path = self.inner.local_path(key)
        if inner_path is not None:
            return inner_path
        try:
            self.read(key)                # pull through the cache
        except FileNotFoundError:
            return None
        return self._cache_path(key)
