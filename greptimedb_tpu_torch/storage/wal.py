"""Write-ahead log: segmented, checksummed, per-region append log.

Reference behavior: src/log-store/src/raft_engine/log_store.rs +
src/storage/src/wal.rs — per-region namespaces, append(seq, payload),
read_from(seq) for replay, obsolete(seq) truncation after flush. Host-side
only; the accelerator never sees the WAL.

Format: segment files `{first_seq:020d}.wal`, each a sequence of records:
    [len u32][crc32 u32][seq u64][schema_version u32][payload]
Records are append-only; fsync policy is configurable (group commit happens
at the region writer level by batching mutations into one WriteBatch).
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from ..common import failpoint as _fp
from ..common.locks import TrackedLock
# hoisted to module scope: `append` runs per region write — a function-
# local import on the hot loop re-resolves sys.modules every call
# (matching every other storage module)
from ..common.telemetry import increment_counter, timer
from ..errors import StorageError

logger = logging.getLogger(__name__)

_REC_HDR = struct.Struct("<IIQI")  # len, crc, seq, schema_version

_fp.register("wal_append")
_fp.register("wal_append_torn")
_fp.register("wal_fsync")
#: crash window between a cohort member's record write and the shared
#: group-commit fsync: at most the (unacked) cohort may be lost, never
#: an acked row (tests/torture.py drives it)
_fp.register("wal_group_commit")


# ---------------------------------------------------------------------------
# group commit configuration (process-wide; SET wal_group_commit /
# wal_group_max_wait_us / wal_group_max_batch and the matching
# GREPTIME_WAL_GROUP_* env knobs route here)
# ---------------------------------------------------------------------------

from ..utils import env_flag as _env_flag, env_int as _env_int

#: one-element lists so SET mutates in place without rebinding (the
#: pattern telemetry/runtime knobs use; greptlint GL08 wants the
#: mutation behind a lock — these are single-slot swaps guarded below)
_GC_LOCK = TrackedLock("storage.wal_group_config")
#: max_wait_us defaults to 0 — pure fsync chaining: the cohort is
#: whatever piled up while the previous fsync was in flight, so group
#: commit never ADDS latency on a fast device; a positive window only
#: pays off when fsync is expensive relative to the OS sleep quantum
_GC_ENABLED = [_env_flag("GREPTIME_WAL_GROUP_COMMIT", True)]
_GC_MAX_WAIT_US = [_env_int("GREPTIME_WAL_GROUP_MAX_WAIT_US", 0)]
_GC_MAX_BATCH = [_env_int("GREPTIME_WAL_GROUP_MAX_BATCH", 128)]
#: hard bound on how long a cohort member parks for the shared fsync
#: before surfacing a storage error (never deadlock on a dead leader)
_GC_WAIT_TIMEOUT_S = 30.0


def configure_group_commit(*, enabled: Optional[bool] = None,
                           max_wait_us: Optional[int] = None,
                           max_batch: Optional[int] = None) -> None:
    """Process-wide group-commit knobs (SET wal_group_commit & co)."""
    with _GC_LOCK:
        if enabled is not None:
            _GC_ENABLED[0] = bool(enabled)
        if max_wait_us is not None:
            if max_wait_us < 0:
                raise ValueError("wal_group_max_wait_us must be >= 0")
            _GC_MAX_WAIT_US[0] = int(max_wait_us)
        if max_batch is not None:
            if max_batch < 1:
                raise ValueError("wal_group_max_batch must be >= 1")
            _GC_MAX_BATCH[0] = int(max_batch)


def group_commit_enabled() -> bool:
    return _GC_ENABLED[0]


def group_commit_settings() -> Tuple[bool, int, int]:
    """(enabled, max_wait_us, max_batch) — one consistent read."""
    with _GC_LOCK:
        return _GC_ENABLED[0], _GC_MAX_WAIT_US[0], _GC_MAX_BATCH[0]


class Wal:
    """WAL for one region, stored under `dir`."""

    SEGMENT_BYTES = 64 * 1024 * 1024

    def __init__(self, dir_path: str, *, sync_on_write: bool = False,
                 segment_bytes: Optional[int] = None):
        self.dir = dir_path
        self.sync_on_write = sync_on_write
        self.segment_bytes = segment_bytes or self.SEGMENT_BYTES
        os.makedirs(self.dir, exist_ok=True)
        self._lock = TrackedLock("storage.wal")
        self._fh = None
        self._fh_path: Optional[str] = None
        self._fh_size = 0
        # ---- group-commit cohort state (all under _gc_cond's lock) ----
        # tickets count records written to the OS; the leader's fsync
        # covers every ticket <= the value it sampled under _lock, so a
        # waiter is durable once _synced_ticket reaches its own ticket.
        self._gc_cond = threading.Condition(
            TrackedLock("storage.wal_group"))
        self._written_ticket = 0      # bumped under _lock per record
        self._synced_ticket = 0       # highest ticket a good fsync covers
        self._failed_ticket = 0       # highest ticket a failed fsync hit
        self._sync_exc: Optional[BaseException] = None
        self._leader_active = False
        # set when an injected torn write left garbage at the tail of the
        # OPEN segment and the process survived (the torture rig abandons
        # the object; a live server does not) — the next append must cut
        # the garbage off before writing or it would bury later acked
        # records behind bytes replay cannot cross
        self._fh_dirty_tail = False

    # ---- segments ----
    def _segments(self) -> List[Tuple[int, str]]:
        segs = []
        for fn in os.listdir(self.dir):
            if fn.endswith(".wal"):
                try:
                    segs.append((int(fn[:-4]), os.path.join(self.dir, fn)))
                except ValueError:
                    continue
        segs.sort()
        return segs

    def _open_segment(self, first_seq: int) -> None:
        if self._fh is not None:
            if self.sync_on_write:
                # group commit fsyncs OUTSIDE the WAL lock against the
                # current fd only: a rotation must not close a segment
                # carrying cohort records that never saw an fsync (in
                # per-append mode this re-syncs already-durable bytes
                # once per 64 MiB — noise)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            self._fh.close()
        path = os.path.join(self.dir, f"{first_seq:020d}.wal")
        self._fh = open(path, "ab")
        self._fh_path = path
        self._fh_size = self._fh.tell()

    # ---- api ----
    def group_commit_active(self) -> bool:
        """True when this WAL's durability waits should ride the shared
        group-commit fsync (the region writer then appends under its
        lock and parks OUTSIDE it, so concurrent writers overlap)."""
        return self.sync_on_write and group_commit_enabled()

    def append(self, seq: int, payload: bytes, schema_version: int = 0) -> None:
        """Write one record; when `sync_on_write`, return only after an
        fsync covers it — per-append (group commit off) or shared
        (group commit on)."""
        group = self.group_commit_active()
        ticket = self._append_locked(
            seq, payload, schema_version,
            inline_sync=self.sync_on_write and not group)
        if group:
            self.wait_durable(ticket)

    def append_async(self, seq: int, payload: bytes,
                     schema_version: int = 0) -> int:
        """Write one record WITHOUT waiting for durability; returns the
        commit ticket to pass to :meth:`wait_durable`. The region writer
        uses this under its writer lock so the (slow) fsync wait happens
        after the lock is released."""
        return self._append_locked(seq, payload, schema_version,
                                   inline_sync=False)

    def _append_locked(self, seq: int, payload: bytes, schema_version: int,
                       *, inline_sync: bool) -> int:
        with self._lock:
            _fp.fail_point("wal_append")
            if self._fh is not None and self._fh_dirty_tail:
                # in-process recovery from an injected torn write: drop
                # the garbage (_fh_size never advanced past it) so this
                # record lands replayable. Runs BEFORE the rotation check
                # so a full segment can never rotate away with garbage
                # buried mid-log.
                self._fh.truncate(self._fh_size)
                self._fh.flush()
                self._fh_dirty_tail = False
            if self._fh is None or self._fh_size >= self.segment_bytes:
                self._open_segment(seq)
            crc = zlib.crc32(payload)
            rec = _REC_HDR.pack(len(payload), crc, seq, schema_version) + payload
            if _fp.fires("wal_append_torn"):
                # crash mid-append: half the record reaches the file —
                # recovery must truncate it away and keep earlier records
                self._fh.write(rec[:max(1, len(rec) // 2)])
                self._fh.flush()
                self._fh_dirty_tail = True
                raise _fp.SimulatedCrash("wal_append_torn")
            self._fh.write(rec)
            self._fh.flush()
            # account the record before the fsync: it is in the file now,
            # so a failed fsync must not leave segment rotation blind to it
            self._fh_size += len(rec)
            self._written_ticket += 1
            ticket = self._written_ticket
            if inline_sync:
                _fp.fail_point("wal_fsync")
                with timer("wal_fsync"):
                    os.fsync(self._fh.fileno())
            increment_counter("wal_bytes", len(rec))
        return ticket

    # ---- group commit ----
    def wait_durable(self, ticket: int) -> None:
        """Park until a shared fsync covers `ticket`. The first waiter of
        a cohort elects itself leader, batches the flush+fsync, and wakes
        everyone; followers re-check on a bounded wait so a dead leader
        (or a KILL on the waiting statement) can never wedge the cohort."""
        from ..common.process_list import check_cancelled
        _fp.fail_point("wal_group_commit")
        deadline = time.monotonic() + _GC_WAIT_TIMEOUT_S
        while True:
            lead = False
            with self._gc_cond:
                if self._synced_ticket >= ticket:
                    return                     # a shared fsync covered us
                if self._failed_ticket >= ticket:
                    raise StorageError(
                        f"wal group fsync failed for ticket {ticket}: "
                        f"{self._sync_exc}", cause=self._sync_exc
                        if isinstance(self._sync_exc, Exception) else None)
                if not self._leader_active:
                    self._leader_active = True
                    lead = True
                else:
                    self._gc_cond.wait(timeout=0.05)
            if lead:
                self._lead_sync()              # re-loop to check coverage
                continue
            check_cancelled()                  # killed mid-wait: bail out
            if time.monotonic() > deadline:
                raise StorageError(
                    f"wal group commit wait timed out after "
                    f"{_GC_WAIT_TIMEOUT_S:.0f}s (ticket {ticket})")

    def _lead_sync(self) -> None:
        """Leader duties: give the cohort a short window to pile on, then
        pay ONE fsync for every record written so far and publish the
        covered ticket. Any fsync failure (or injected crash) is recorded
        for the cohort and re-raised in the leader's own thread.

        The flush serves a whole cohort, so it roots its own trace +
        background_jobs entry (common/background_jobs) rather than
        riding whichever writer happened to get elected."""
        from ..common import background_jobs
        with background_jobs.job("wal_group_commit",
                                 region=os.path.basename(self.dir)):
            self._lead_sync_inner()

    def _lead_sync_inner(self) -> None:
        _enabled, max_wait_us, max_batch = group_commit_settings()
        if max_wait_us > 0:
            with self._gc_cond:
                backlog = self._written_ticket - self._synced_ticket
            if backlog < max_batch:
                # the accumulation window — bounded, microseconds-scale
                time.sleep(max_wait_us / 1e6)
        target = 0
        try:
            dup_fd = -1
            with self._lock:
                target = self._written_ticket
                if self._fh is not None and target > self._synced_ticket:
                    # flush userspace buffers under the lock, then fsync
                    # a dup'd fd OUTSIDE it: the whole point of group
                    # commit is that appends keep landing while the
                    # device syncs (the dup survives a concurrent
                    # rotation, and rotation itself fsyncs the old
                    # segment before closing it — see _open_segment)
                    self._fh.flush()
                    dup_fd = os.dup(self._fh.fileno())
            if dup_fd >= 0:
                try:
                    _fp.fail_point("wal_fsync")
                    with timer("wal_fsync"):
                        os.fsync(dup_fd)
                finally:
                    os.close(dup_fd)
        except BaseException as e:
            # the cohort (including this thread's own caller) must see
            # the failure; the ORIGINAL exception propagates here so an
            # injected SimulatedCrash stays a crash in the leader
            with self._gc_cond:
                self._failed_ticket = max(self._failed_ticket,
                                          target or self._written_ticket)
                self._sync_exc = e
                self._leader_active = False
                self._gc_cond.notify_all()
            raise
        with self._gc_cond:
            cohort = target - self._synced_ticket
            self._synced_ticket = max(self._synced_ticket, target)
            self._leader_active = False
            self._gc_cond.notify_all()
        if cohort > 0:
            increment_counter("wal_group_commit_fsyncs")
            increment_counter("wal_group_commit_records", cohort)

    def sync(self) -> None:
        with self._lock:
            target = self._written_ticket
            if self._fh is not None:
                self._fh.flush()
                with timer("wal_fsync"):
                    os.fsync(self._fh.fileno())
        # an explicit full sync covers every written record: release any
        # parked cohort members up to the sampled ticket
        with self._gc_cond:
            if target > self._synced_ticket:
                self._synced_ticket = target
                self._gc_cond.notify_all()

    def read_from(self, start_seq: int) -> Iterator[Tuple[int, int, bytes]]:
        """Yield (seq, schema_version, payload) for all records with
        seq >= start_seq.

        A torn/corrupt record in the FINAL segment is a crash mid-append:
        the scan terminates cleanly AND the segment is truncated at the
        last good record (with a WARN) so later appends never land past
        the garbage — without the truncate, append-mode writes would bury
        the torn bytes mid-segment and brick the next replay. The same in
        an EARLIER segment means acknowledged writes were lost (bit rot) —
        replay aborts with StorageError rather than silently skipping to
        newer segments. Each record carries a CRC32 over its payload, so a
        corrupt-but-complete record is detected, never silently replayed."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            segs = self._segments()
        for i, (first, path) in enumerate(segs):
            # skip whole segments below start_seq (next segment's first seq
            # bounds this one's contents)
            if i + 1 < len(segs) and segs[i + 1][0] <= start_seq:
                continue
            records, clean, good_pos = self._read_segment(path, start_seq)
            yield from records
            if not clean:
                if i + 1 < len(segs):
                    raise StorageError(
                        f"corrupt WAL record mid-log in {path}; refusing to "
                        f"replay past the gap")
                self._repair_torn_tail(path, good_pos)
                return  # torn tail of the active segment: normal crash

    def _repair_torn_tail(self, path: str, good_pos: int) -> None:
        """Drop a torn/corrupt tail record left by a crash mid-append."""
        with self._lock:
            if self._fh is not None and self._fh_path == path:
                return  # segment reopened for appends already; leave it
            try:
                size = os.path.getsize(path)
                logger.warning(
                    "wal %s: torn/corrupt tail record; truncating %d bytes "
                    "at offset %d (crash mid-append)", path,
                    size - good_pos, good_pos)
                with open(path, "rb+") as f:
                    f.truncate(good_pos)
                    os.fsync(f.fileno())
            except OSError as e:  # pragma: no cover
                raise StorageError(f"wal tail repair failed: {e}", cause=e)

    def _read_segment(self, path: str, start_seq: int
                      ) -> Tuple[List[Tuple[int, int, bytes]], bool, int]:
        """Returns (records >= start_seq, clean, offset past the last good
        record) — the offset is the truncation point on a torn tail."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return [], True, 0
        out: List[Tuple[int, int, bytes]] = []
        pos = 0
        n = len(data)
        while pos + _REC_HDR.size <= n:
            ln, crc, seq, sv = _REC_HDR.unpack_from(data, pos)
            body_start = pos + _REC_HDR.size
            if body_start + ln > n:
                return out, False, pos  # torn record
            payload = data[body_start:body_start + ln]
            if zlib.crc32(payload) != crc:
                return out, False, pos  # corrupt record
            pos = body_start + ln
            if seq >= start_seq:
                out.append((seq, sv, payload))
        return out, pos == n, pos

    def obsolete(self, seq: int) -> None:
        """Delete segments whose entire contents are <= seq."""
        with self._lock:
            segs = self._segments()
            # a segment can be deleted if the NEXT segment starts at <= seq+1,
            # meaning every record in it has seq <= that bound.
            for i, (first, path) in enumerate(segs):
                if i + 1 < len(segs) and segs[i + 1][0] <= seq + 1:
                    if self._fh_path == path and self._fh is not None:
                        continue  # never delete the active segment
                    try:
                        os.unlink(path)
                    except OSError as e:  # pragma: no cover
                        raise StorageError(f"wal gc failed: {e}", cause=e)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None


class NoopWal(Wal):
    """WAL-less mode for tests/benchmarks (reference: src/log-store/src/noop.rs)."""

    sync_on_write = False

    def __init__(self):  # noqa: super-init-not-called
        self._lock = TrackedLock("storage.wal")

    def group_commit_active(self):
        return False

    def append(self, seq, payload, schema_version=0):
        pass

    def append_async(self, seq, payload, schema_version=0):
        return 0

    def wait_durable(self, ticket):
        pass

    def sync(self):
        pass

    def read_from(self, start_seq):
        return iter(())

    def obsolete(self, seq):
        pass

    def close(self):
        pass
