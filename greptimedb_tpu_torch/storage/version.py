"""MVCC region version control.

Reference behavior: src/storage/src/version.rs — an immutable `Version`
snapshot (schema + memtables + SST levels + sequences) swapped atomically
under a lock; readers grab the current version without blocking writers.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

from ..common.locks import TrackedLock
from ..datatypes import Schema
from .memtable import Memtable, MemtableVersion
from .series import SeriesDict
from .sst import FileMeta, LevelMetas


@dataclass(frozen=True)
class Version:
    schema: Schema
    memtables: MemtableVersion
    ssts: LevelMetas
    flushed_sequence: int
    manifest_version: int


class VersionControl:
    def __init__(self, version: Version, committed_sequence: int = 0):
        self._lock = TrackedLock("storage.version", io_ok=False)
        self._current = version
        self._committed_sequence = committed_sequence

    @property
    def current(self) -> Version:
        return self._current

    @property
    def committed_sequence(self) -> int:
        return self._committed_sequence

    def set_committed_sequence(self, seq: int) -> None:
        self._committed_sequence = seq

    def next_sequence(self) -> int:
        return self._committed_sequence + 1

    # ---- transitions (called under the region writer lock) ----
    def freeze_mutable(self, new_mutable: Memtable) -> None:
        with self._lock:
            v = self._current
            self._current = replace(v, memtables=v.memtables.freeze(new_mutable))

    def apply_flush(self, *, memtable_ids: Sequence[int],
                    files: Sequence[FileMeta], flushed_sequence: int,
                    manifest_version: int) -> None:
        with self._lock:
            v = self._current
            self._current = replace(
                v,
                memtables=v.memtables.remove_immutables(memtable_ids),
                ssts=v.ssts.add_files(files),
                flushed_sequence=max(v.flushed_sequence, flushed_sequence),
                manifest_version=manifest_version)

    def apply_compaction(self, *, removed: Sequence[str],
                         added: Sequence[FileMeta],
                         manifest_version: int) -> None:
        with self._lock:
            v = self._current
            self._current = replace(
                v, ssts=v.ssts.remove_files(removed).add_files(added),
                manifest_version=manifest_version)

    def apply_schema_change(self, schema: Schema, new_mutable: Memtable,
                            manifest_version: int) -> None:
        with self._lock:
            v = self._current
            self._current = replace(
                v, schema=schema,
                memtables=v.memtables.freeze(new_mutable),
                manifest_version=manifest_version)
