"""Object store abstraction.

Reference behavior: src/object-store (opendal re-export with Fs/S3/OSS
backends plus LRU disk cache). Here: a minimal Operator interface with a
filesystem backend (atomic writes via rename); S3/GCS backends can slot in
behind the same interface. The host reads SSTs through this layer; the
GPU never touches it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import List, Optional

from ..common import failpoint as _fp
from ..common.locks import TrackedLock

_fp.register("objstore_read")
_fp.register("objstore_write")
_fp.register("objstore_delete")


class ObjectStore:
    """Flat key → bytes store. Keys use '/' separators."""

    def read(self, key: str) -> bytes:
        raise NotImplementedError

    def write(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def local_path(self, key: str) -> Optional[str]:
        """If the object is addressable as a local file (for mmap/parquet
        readers), return its path; else None and callers fall back to read()."""
        return None

    def put_path(self, key: str):
        """Context manager yielding a local filesystem path for the caller
        to write the object into directly (parquet writers stream pages to
        it instead of buffering the whole file in memory). The object
        becomes visible under `key` only when the context exits cleanly.
        Default implementation spools to a temp file and write()s it."""
        return _SpoolPut(self, key)


class _SpoolPut:
    def __init__(self, store: "ObjectStore", key: str):
        self._store = store
        self._key = key
        self._tmp: Optional[str] = None

    def __enter__(self) -> str:
        fd, self._tmp = tempfile.mkstemp(prefix=".gdb-put-")
        os.close(fd)
        return self._tmp

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                with open(self._tmp, "rb") as f:
                    self._store.write(self._key, f.read())
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass


class _FsPut:
    """Direct put: write into a temp file in the destination directory,
    fsync, rename — the same atomicity as FsObjectStore.write without the
    intermediate whole-file buffer."""

    def __init__(self, store: "FsObjectStore", key: str):
        self._path = store._path(key)
        self._tmp: Optional[str] = None

    def __enter__(self) -> str:
        d = os.path.dirname(self._path)
        os.makedirs(d, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
        os.close(fd)
        return self._tmp

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            from ..utils import atomic_publish
            atomic_publish(self._tmp, self._path)  # unlinks tmp on failure
            return
        self._unlink_tmp()

    def _unlink_tmp(self) -> None:
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


class FsObjectStore(ObjectStore):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = TrackedLock("storage.objstore")

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        if not p.startswith(self.root):
            raise ValueError(f"key escapes root: {key}")
        return p

    def read(self, key: str) -> bytes:
        _fp.fail_point("objstore_read")
        with open(self._path(key), "rb") as f:
            return f.read()

    def write(self, key: str, data: bytes) -> None:
        _fp.fail_point("objstore_write")
        from ..utils import atomic_write
        atomic_write(self._path(key), data)

    def delete(self, key: str) -> None:
        _fp.fail_point("objstore_delete")
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def delete_dir(self, key: str) -> None:
        shutil.rmtree(self._path(key), ignore_errors=True)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str) -> List[str]:
        base = self._path(prefix) if prefix else self.root
        out = []
        if not os.path.isdir(base):
            return out
        for dirpath, _dirs, files in os.walk(base):
            for fn in files:
                if fn.startswith(".tmp-"):
                    continue
                full = os.path.join(dirpath, fn)
                out.append(os.path.relpath(full, self.root).replace(os.sep, "/"))
        return sorted(out)

    def local_path(self, key: str) -> Optional[str]:
        p = self._path(key)
        return p if os.path.exists(p) else None

    def put_path(self, key: str) -> "_FsPut":
        return _FsPut(self, key)


def new_fs_object_store(root: str) -> FsObjectStore:
    return FsObjectStore(root)


def build_object_store(storage: dict, data_home: str) -> "ObjectStore":
    """Construct the configured backend (reference: datanode builds its
    object store from ObjectStoreConfig — Fs/S3/Oss — and optionally wraps
    the LRU disk cache, src/datanode/src/instance.rs:334-359)."""
    from .retry import RetryingObjectStore
    kind = str(storage.get("type", "File")).lower()
    if kind in ("file", "fs"):
        store: ObjectStore = FsObjectStore(
            storage.get("data_home", data_home))
    elif kind == "s3":
        from .s3 import S3Config, S3ObjectStore
        store = S3ObjectStore(S3Config(
            bucket=storage["bucket"],
            root=storage.get("root", ""),
            endpoint=storage.get("endpoint"),
            region=storage.get("region", "us-east-1"),
            access_key_id=storage.get("access_key_id", ""),
            secret_access_key=storage.get("secret_access_key", "")))
    else:
        raise ValueError(f"unknown storage type {storage.get('type')!r}")
    # transient faults (S3 5xx/429, socket resets, injected failpoints)
    # retry with backoff before any engine code sees them; the cache
    # layer stacks on top so cache hits never pay the wrapper
    store = RetryingObjectStore(store)
    cache = storage.get("cache_path")
    if cache:
        from .cache import LruCacheLayer
        store = LruCacheLayer(
            store, cache, int(storage.get("cache_capacity",
                                          512 * 1024 * 1024)))
    return store
