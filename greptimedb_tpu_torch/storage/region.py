"""Region: one shard of a table — the durable LSM unit.

Reference behavior: src/storage/src/region.rs + region/writer.rs — a region
owns a WAL namespace, memtables, SST levels and a manifest. Writes are
serialized (WAL append → memtable insert → sequence bump); flush freezes the
mutable memtable and dumps it to Parquet; recovery replays WAL from
`flushed_sequence + 1` after restoring the manifest.

Deltas from the reference (as in greptimedb_tpu/storage/region.py):
- memtables are unordered SoA buffers; ordering/dedup is one host sort
  at scan/flush time (see storage/memtable.py docstring);
- the series dictionary (string tags → dense ids) is part of durable state,
  persisted on flush next to the manifest so SST series ids stay stable;
- scans return SoA runs ready for device transfer, not row iterators.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..common import failpoint as _fp
from ..common.locks import TrackedRLock
from ..common.telemetry import span
from ..common.time import TimestampRange
from ..datatypes import RecordBatch, Schema, Vector
from ..datatypes.vector import compat_column, null_column
from ..errors import (InvalidArgumentsError, RegionClosedError,
                      StorageError)
from .memtable import Memtable, MemtableSnapshot, MemtableVersion
from .manifest import RegionManifest
from .object_store import ObjectStore
from .series import SeriesDict
from .sst import (AccessLayer, DEFAULT_ROW_GROUP_SIZE, FileMeta, LevelMetas,
                  SERIES_COL)
from .version import Version, VersionControl
from .wal import NoopWal, Wal
from .write_batch import OP_DELETE, OP_PUT, WriteBatch
from ..ops.kernels import merge_dedup_numpy

logger = logging.getLogger(__name__)

_fp.register("flush_commit")
_fp.register("bulk_commit")
_fp.register("compaction_commit")
_fp.register("dict_persist")
_fp.register("region_write_memtable")
_fp.register("balancer_wal_tail_replay")
_fp.register("balancer_handoff_fence")

#: node-local fence marker (lives in the region's WAL dir, NOT on the
#: shared object store: the fence is about THIS node's serving state —
#: the adopting node must open the same shared region dir writable)
FENCE_MARKER = "FENCED"


@dataclass
class RegionDescriptor:
    name: str
    schema: Schema
    region_dir: str               # key prefix on the object store
    wal_dir: str                  # local filesystem dir for the WAL


@dataclass
class IngestProfile:
    """Stage-by-stage wall-clock breakdown of one bulk_ingest call
    (`last_ingest_profile`; chip_smoke.py prints it). `sst_write` covers the parallel parquet encode + fsync of all chunks,
    so with N concurrent writers it is wall time, not CPU time."""
    rows: int = 0
    total_s: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)

    def mrows_per_s(self) -> float:
        return self.rows / self.total_s / 1e6 if self.total_s else 0.0

    def merge(self, other: "IngestProfile") -> None:
        """Accumulate another call's profile (multi-batch loads)."""
        self.rows += other.rows
        self.total_s += other.total_s
        for k, v in other.stages.items():
            self.stages[k] = self.stages.get(k, 0.0) + v

    def describe(self) -> str:
        parts = ", ".join(f"{k}={v:.3f}s"
                          for k, v in sorted(self.stages.items(),
                                             key=lambda kv: -kv[1]))
        return (f"{self.rows} rows in {self.total_s:.3f}s "
                f"({self.mrows_per_s():.2f} Mrows/s): {parts}")


@dataclass
class ScanProfile:
    """Stage-by-stage breakdown of the last aggregate scan over this
    region (`last_scan_profile`) — the scan twin of IngestProfile. `path`
    names the route taken: "resident" (scan cache + device kernel),
    "streamed" (cold slice streaming, query/stream_exec.py) or
    "indexed-point" (the SST index, then a host reduction); a flow fold
    leaves "flow-fold" (storage/downsample.py names its stages) or
    "flow-fold-cold" (read_merged, reduce, sink_write: the host fold of
    flow/lowering.py). Host-clock
    stages (seconds) of the resident path (query/tpu_exec.py): scan_prep
    (cache lookup or merged scan build; on a miss or an incremental
    merge, its parts region_scan — memtables and SST decode — and
    merge), runs (host run ids and their keys), masks (tag predicates
    and row mask), h2d (device mirrors, mask and run ends), launch (the
    kernel call's host time), fetch (the one device-to-host copy, which
    waits for the kernel), collect (the per-run moment frame),
    host_reduce (sketch and expression moments); `stage()` times each of
    them as a span of the statement's trace too (`scan_cache`,
    `scan_read`, `scan_merge`, `scan_runs`, ... `scan_host_reduce`). The
    streamed path
    marks slice_plan, decode_reduce, fold and device_fetch, the
    indexed-point path scan and reduce. `counters` carries path facts:
    `cache_hit` / `cache_incremental` / `cache_full` (scan cache),
    slices / lean_slices / merged_slices / dedup_skip_slices /
    device_slices (streamed), candidate_sids (indexed-point)."""
    path: str = ""
    rows: int = 0
    total_s: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)

    def mark(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    @contextlib.contextmanager
    def stage(self, name: str, span_name: Optional[str] = None,
              **attrs: object) -> Iterator[Dict]:
        """Time one stage as a span (`span_name`, by default
        `scan_<name>`) and mark the span's own seconds as `name`, so the
        span sink and this profile read one measurement. Yields the
        span: attributes known only at the end go into its `attrs`."""
        with span(span_name or f"scan_{name}", **attrs) as s:
            yield s
        self.mark(name, s["elapsed_ms"] / 1e3)

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def describe(self) -> str:
        parts = ", ".join(f"{k}={v:.3f}s"
                          for k, v in sorted(self.stages.items(),
                                             key=lambda kv: -kv[1]))
        cnts = ", ".join(f"{k}={v}" for k, v in sorted(
            self.counters.items()))
        return (f"{self.path}: {self.rows} rows in {self.total_s:.3f}s"
                f" ({parts})" + (f" [{cnts}]" if cnts else ""))


@dataclass
class ScanData:
    """Concatenated unsorted runs from memtables + SSTs (SoA).

    Consumers run the merge/dedup (ops/kernels.py merge_dedup_numpy)
    before interpreting rows."""
    schema: Schema
    series_dict: SeriesDict
    series_ids: np.ndarray
    ts: np.ndarray
    seq: np.ndarray
    op_types: np.ndarray
    fields: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]

    @property
    def num_rows(self) -> int:
        return len(self.ts)


class RegionSnapshot:
    """A consistent read view (reference: src/storage/src/snapshot.rs)."""

    def __init__(self, region: "Region", version: Version, visible_seq: int):
        self._region = region
        self._version = version
        self.visible_sequence = visible_seq

    @property
    def schema(self) -> Schema:
        return self._version.schema

    def scan(self, *, projection: Optional[Sequence[str]] = None,
             time_range: Optional[TimestampRange] = None,
             series_range: Optional[Tuple[int, int]] = None,
             sid_set: Optional[np.ndarray] = None,
             synthetic_seq: bool = False,
             need_ts: bool = True,
             need_mvcc: bool = True) -> ScanData:
        """need_ts=False / need_mvcc=False let a caller that PROVED it
        will not consult row times / sequence+op values (dup-free,
        delete-free, key-disjoint slice — the streamed cold scan's
        fast path) skip decoding and materializing those columns; the
        returned arrays are 0-stride placeholders. need_ts=False also
        skips the per-file time-range mask: the caller asserts every
        selected row group lies inside its requested range.

        `sid_set` is a SORTED candidate series-id array (a point/IN tag
        predicate resolved through the series dictionary): whole SSTs
        are dropped through their index sidecars (bloom over the file's
        sid set — storage/index.py) before any parquet footer is read,
        surviving files prune row groups through the sidecar's per-group
        sid summary, and rows are masked to exact membership. Files
        without a usable index degrade to stats-only pruning."""
        region = self._region
        v = self._version
        schema = v.schema
        # cooperative KILL: a killed statement stops before (and between)
        # file reads instead of decoding the rest of the region
        from ..common import process_list
        process_list.check_cancelled()
        field_names = [c.name for c in schema.field_columns()
                       if projection is None or c.name in projection]
        runs: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                         Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]]] = []
        # memtables (filter by visible sequence + time range, host-side)
        for mt in v.memtables.all_memtables():
            snap = mt.snapshot()
            if snap.num_rows == 0:
                continue
            sel = snap.seq <= self.visible_sequence
            if time_range is not None:
                if time_range.start is not None:
                    sel &= snap.ts >= time_range.start
                if time_range.end is not None:
                    sel &= snap.ts < time_range.end
            if series_range is not None:
                sel &= (snap.series_ids >= series_range[0]) & \
                       (snap.series_ids < series_range[1])
            if sid_set is not None:
                sel &= np.isin(snap.series_ids, sid_set)
            if not sel.any():
                continue
            fields = {}
            for name in field_names:
                if name in snap.fields:
                    data, valid = snap.fields[name]
                    fields[name] = (data[sel], valid[sel] if valid is not None else None)
                else:  # column added after this memtable was created
                    fields[name] = compat_column(
                        schema.column_schema(name), int(sel.sum()))
            runs.append((snap.series_ids[sel], snap.ts[sel], snap.seq[sel],
                         snap.op_types[sel], fields))
        # SSTs (row-group pruned; concurrent readers — parquet decode
        # drops the GIL, so IO and decompression overlap across files;
        # in-order streaming consumption keeps at most the decoded-but-
        # unprocessed files alive, not the whole region)
        from ..common.runtime import parallel_imap
        candidates = v.ssts.files_in_range(time_range)
        if sid_set is not None and candidates:
            # the index pruning tier: drop whole files through their
            # sid blooms before any footer is opened (stats-only
            # degrade keeps un-indexed files); the prune stage reports
            # files pruned by index as index_files_pruned/_checked
            from .index import prune_files, sst_index_enabled
            if sst_index_enabled():
                candidates, _, _ = prune_files(
                    region.access_layer.load_index, candidates, sid_set)
        for sst in parallel_imap(
                lambda m: region.access_layer.read_sst(
                    m, projection=field_names, time_range=time_range,
                    series_range=series_range, sid_set=sid_set,
                    synthetic_seq=synthetic_seq,
                    need_ts=need_ts),
                candidates):
            process_list.check_cancelled()     # per-file batch boundary
            if sst.num_rows == 0:
                continue
            sel = None
            need_mask = False
            if time_range is not None and need_ts:
                # skip the mask (and the per-column copies it forces) when
                # every surviving row group lies inside the range — the
                # common case for slice reads cut on row-group edges
                tmin, tmax = int(sst.ts.min()), int(sst.ts.max())
                need_mask |= (time_range.start is not None and
                              tmin < time_range.start) or \
                             (time_range.end is not None and
                              tmax >= time_range.end)
            if series_range is not None:
                smin = int(sst.series_ids.min())
                smax = int(sst.series_ids.max())
                need_mask |= smin < series_range[0] or \
                    smax >= series_range[1]
            sid_mask = None
            if sid_set is not None:
                sid_mask = np.isin(sst.series_ids, sid_set)
                need_mask |= not sid_mask.all()
            if need_mask:
                sel = np.ones(sst.num_rows, dtype=bool)
                if time_range is not None and need_ts:
                    if time_range.start is not None:
                        sel &= sst.ts >= time_range.start
                    if time_range.end is not None:
                        sel &= sst.ts < time_range.end
                if series_range is not None:
                    sel &= (sst.series_ids >= series_range[0]) & \
                           (sst.series_ids < series_range[1])
                if sid_mask is not None:
                    sel &= sid_mask
                if not sel.any():
                    continue
            def take(a):
                return a if sel is None else a[sel]
            fields = {name: (take(d), take(vd) if vd is not None else None)
                      for name, (d, vd) in sst.fields.items()}
            runs.append((take(sst.series_ids), take(sst.ts), take(sst.seq),
                         take(sst.op_types), fields))

        if not runs:
            empty = {name: null_column(schema.column_schema(name).dtype, 0)
                     for name in field_names}
            z = np.zeros(0, np.int64)
            return ScanData(schema, region.series_dict, np.zeros(0, np.int32),
                            z, z.copy(), np.zeros(0, np.int8), empty)
        if len(runs) == 1:
            # single source: no concat copies (np.concatenate of one
            # array still copies — measurable on multi-million-row slices)
            sids1, ts1, seq1, op1, fields1 = runs[0]
            return ScanData(schema, region.series_dict, sids1, ts1, seq1,
                            op1, fields1)
        # order runs by their first (sid, ts): key-disjoint sorted runs
        # (sid-chunked bulk loads, series-sliced reads) then concatenate
        # into a globally sorted array and downstream consumers skip the
        # merge sort entirely; overlapping runs are unaffected (they get
        # merge-sorted anyway)
        runs.sort(key=lambda r: (int(r[0][0]), int(r[1][0]))
                  if len(r[0]) else (0, 0))
        series_ids = np.concatenate([r[0] for r in runs])
        total = len(series_ids)
        # placeholder columns stay 0-stride through the concat — a lean
        # scan of N runs must not pay an 8B×rows materialize per column
        # it promised never to read
        ts = np.concatenate([r[1] for r in runs]) if need_ts \
            else np.broadcast_to(np.int64(0), (total,))
        if need_mvcc:
            seq = np.concatenate([r[2] for r in runs])
            op = np.concatenate([r[3] for r in runs])
        else:
            seq = np.broadcast_to(np.int64(0), (total,))
            op = np.broadcast_to(np.int8(0), (total,))
        fields = {}
        for name in field_names:
            datas = [r[4][name][0] for r in runs]
            valids = [r[4][name][1] for r in runs]
            data = np.concatenate(datas)
            if any(vd is not None for vd in valids):
                valid = np.concatenate([
                    vd if vd is not None else np.ones(len(d), dtype=bool)
                    for vd, d in zip(valids, datas)])
            else:
                valid = None
            fields[name] = (data, valid)
        return ScanData(schema, region.series_dict, series_ids, ts, seq, op, fields)

    def read_merged(self, **kwargs) -> ScanData:
        """Host-side merged+deduped view (merge_dedup_numpy) — used by
        compaction, protocol rows paths and tests."""
        data = self.scan(**kwargs)
        if data.num_rows == 0:
            return data
        kept = merge_dedup_numpy(data.series_ids, data.ts, data.seq,
                                 data.op_types)
        data.series_ids = data.series_ids[kept]
        data.ts = data.ts[kept]
        data.seq = data.seq[kept]
        data.op_types = data.op_types[kept]
        data.fields = {n: (d[kept], v[kept] if v is not None else None)
                       for n, (d, v) in data.fields.items()}
        return data



class Region:
    """See module docstring. All mutating entry points are serialized by
    `_writer_lock` (reference: single-writer-per-region mutex,
    src/storage/src/region/writer.rs:55-101)."""

    def __init__(self, descriptor: RegionDescriptor, store: ObjectStore,
                 *, wal: Optional[Wal] = None,
                 flush_size_bytes: int = 64 * 1024 * 1024,
                 checkpoint_margin: int = 10,
                 row_group_size: int = DEFAULT_ROW_GROUP_SIZE,
                 scheduler=None,
                 purger=None,
                 ttl_ms: Optional[int] = None,
                 compaction_time_window_ms: Optional[int] = None,
                 max_l0_files: int = 4,
                 stall_bytes: Optional[int] = None,
                 wal_opts: Optional[dict] = None,
                 sweep_orphans: bool = True):
        self.descriptor = descriptor
        self.name = descriptor.name
        # unique per in-process region object: cache keys must not collide
        # across engines whose regions share names (same table ids in
        # different data homes)
        import uuid
        self.uid = uuid.uuid4().hex
        self.store = store
        self.flush_size_bytes = flush_size_bytes
        # background machinery (None = synchronous inline fallback)
        self.scheduler = scheduler
        self.purger = purger
        self.ttl_ms = ttl_ms
        self.compaction_time_window_ms = compaction_time_window_ms
        self.max_l0_files = max_l0_files
        # open-time orphan-SST sweep switch: failover adoption on a SHARED
        # object store must not sweep (an unfenced old owner may still be
        # mid-flush; deleting its yet-uncommitted output would poison the
        # manifest edit it is about to write)
        self.sweep_orphans = sweep_orphans
        # writers stall when frozen-but-unflushed memtables pile up past
        # this (reference write-stall: src/storage/src/region/writer.rs:584)
        self.stall_bytes = stall_bytes if stall_bytes is not None \
            else 4 * flush_size_bytes
        self._flush_done = threading.Event()
        self._flush_done.set()
        # bumped whenever committed data is *retracted* (TTL expiry) rather
        # than superseded — incremental scan caches must rebuild then
        self.retraction_epoch = 0
        # elastic-region handoff fence: a fenced region rejects writes
        # with StaleRouteError and suppresses flush/compaction so the
        # adopting node's view of the shared region dir stays stable.
        # Persisted as a node-local marker file so a restart mid-handoff
        # cannot resurrect an unfenced old owner (see fence()).
        self.fenced = False
        # read-replica standby: the region serves reads and applies
        # shipped WAL records at their original sequences, but never
        # accepts client writes and never flushes/compacts — the shared
        # region dir and its manifest belong to the LEADER. Implies
        # fenced; persisted as marker content "standby" (see
        # make_standby()) so a restarted replica datanode comes back in
        # the same role.
        self.standby = False
        #: post-commit replication hook (datanode/replication.py): called
        #: with the region after a write's durability wait. The hook only
        #: nudges the shipper thread — acks NEVER wait on followers.
        self.on_commit = None
        self._writer_lock = TrackedRLock("storage.region_writer")
        if wal is not None:
            self.wal = wal
        else:
            # native group-commit WAL when the toolchain allows, Python
            # twin otherwise (same on-disk format either way)
            from .native_wal import make_wal
            self.wal = make_wal(descriptor.wal_dir, **(wal_opts or {}))
        self.manifest = RegionManifest(
            store, f"{descriptor.region_dir}/manifest",
            checkpoint_margin=checkpoint_margin)
        # schema may be None when opening (recovered from the manifest)
        self.series_dict = (SeriesDict.for_schema(descriptor.schema)
                            if descriptor.schema is not None else None)
        self.access_layer = AccessLayer(
            store, f"{descriptor.region_dir}/sst", descriptor.schema,
            row_group_size=row_group_size)
        self._dict_version = 0
        self._persisted_series = 0
        self.version_control: Optional[VersionControl] = None
        self.last_ingest_profile: Optional[IngestProfile] = None
        self.last_scan_profile: Optional[ScanProfile] = None
        # background-job health: consecutive failures drive retry backoff,
        # lifetime counts + last error surface in /status
        self._bg_failures: Dict[str, int] = {}
        self.bg_errors: Dict[str, Dict] = {}
        self.closed = False

    # ---- lifecycle ----
    @classmethod
    def create(cls, descriptor: RegionDescriptor, store: ObjectStore,
               **kwargs) -> "Region":
        region = cls(descriptor, store, **kwargs)
        # manifest must be virgin: restarting the version counter over an
        # existing region would leave stale higher-version deltas that
        # resurrect on the next open
        state, actions = region.manifest.load()
        if state is not None or actions:
            raise StorageError(
                f"region {descriptor.name} already exists on storage; "
                f"open it instead of creating")
        mutable = Memtable(descriptor.schema, region.series_dict)
        version = Version(schema=descriptor.schema,
                          memtables=MemtableVersion(mutable),
                          ssts=LevelMetas(), flushed_sequence=0,
                          manifest_version=-1)
        region.version_control = VersionControl(version)
        # manifest-first create: the change action makes the region durable
        mv = region.manifest.save([{
            "type": "change", "schema": descriptor.schema.to_dict(),
            "committed_sequence": 0}])
        version_after = Version(schema=descriptor.schema,
                                memtables=version.memtables,
                                ssts=version.ssts, flushed_sequence=0,
                                manifest_version=mv)
        region.version_control = VersionControl(version_after)
        return region

    @classmethod
    def open(cls, descriptor: RegionDescriptor, store: ObjectStore,
             **kwargs) -> Optional["Region"]:
        """Recover a region: manifest → series dict → WAL replay.
        Returns None if the region was never created."""
        region = cls(descriptor, store, **kwargs)
        state, actions = region.manifest.load()
        schema: Optional[Schema] = None
        ssts = LevelMetas()
        flushed_sequence = 0
        committed_sequence = 0
        dict_file: Optional[str] = None
        if state is not None:
            schema = Schema.from_dict(state["schema"])
            ssts = LevelMetas.from_dict(state["ssts"])
            flushed_sequence = state["flushed_sequence"]
            committed_sequence = state.get("committed_sequence", flushed_sequence)
            dict_file = state.get("series_dict_file")
        seen_any = state is not None
        for a in actions:
            seen_any = True
            if a["type"] == "change":
                schema = Schema.from_dict(a["schema"])
                committed_sequence = max(committed_sequence,
                                         a.get("committed_sequence", 0))
            elif a["type"] == "edit":
                ssts = ssts.remove_files(a.get("removed", [])).add_files(
                    [FileMeta.from_dict(f) for f in a.get("added", [])])
                flushed_sequence = max(flushed_sequence,
                                       a.get("flushed_sequence", 0))
                # bulk loads burn sequences into SSTs without WAL entries
                # and may cap flushed_sequence below them — recovery must
                # not re-issue those sequences (equal (sid, ts, seq) keys
                # have an undefined MVCC winner)
                committed_sequence = max(committed_sequence,
                                         a.get("committed_sequence", 0))
                if a.get("series_dict_file"):
                    dict_file = a["series_dict_file"]
            elif a["type"] == "remove":
                return None
        if not seen_any:
            return None
        assert schema is not None
        region.descriptor.schema = schema
        region.series_dict = SeriesDict.for_schema(schema)
        if dict_file is not None:
            raw = json.loads(store.read(f"{descriptor.region_dir}/{dict_file}"))
            region.series_dict = SeriesDict.from_dict(raw)
            region._persisted_series = region.series_dict.num_series
            region._dict_version = int(dict_file.rsplit("-", 1)[-1].split(".")[0]) + 1
        region.access_layer = AccessLayer(
            store, f"{descriptor.region_dir}/sst", schema,
            row_group_size=region.access_layer.row_group_size,
            field_encoding=region.access_layer.field_encoding)
        mutable = Memtable(schema, region.series_dict)
        version = Version(schema=schema, memtables=MemtableVersion(mutable),
                          ssts=ssts, flushed_sequence=flushed_sequence,
                          manifest_version=region.manifest._version)
        region.version_control = VersionControl(
            version, committed_sequence=max(committed_sequence, flushed_sequence))
        if region.sweep_orphans:
            region._sweep_orphan_ssts()
        region._replay_wal(flushed_sequence)
        import os as _os
        marker = region._fence_marker_path()
        if _os.path.exists(marker):
            # this node fenced the region mid-handoff and then restarted:
            # it must come back fenced (an unfenced resurrection could
            # ack writes the migration target will never see). The marker
            # CONTENT distinguishes a mid-migration fence from a standby
            # replica, which reopens fenced-for-writes but read-serving.
            region.fenced = True
            try:
                with open(marker, encoding="utf-8") as fh:
                    kind = fh.read().strip()
            except OSError:
                kind = "fenced"
            if kind == "standby":
                region.standby = True
                logger.info("region %s reopened as a STANDBY replica",
                            region.name)
            else:
                logger.warning("region %s reopened FENCED (handoff marker "
                               "present)", region.name)
        return region

    def _sweep_orphan_ssts(self) -> int:
        """Delete SST files the recovered manifest does not reference.

        At open the region is exclusive and the manifest is authoritative,
        so an unreferenced parquet file is garbage from a crash: a flush /
        compaction / bulk-ingest output whose manifest commit never landed,
        or a compaction victim whose purger delete never ran. Sweeping here
        keeps crashes from leaking storage forever (nothing else ever
        revisits unreferenced files)."""
        referenced = set()
        for f in self.version_control.current.ssts.all_files():
            referenced.add(f.file_name)
            if f.index_file is not None:
                referenced.add(f.index_file)
        prefix = f"{self.descriptor.region_dir}/sst/"
        removed = 0
        try:
            keys = self.store.list(prefix)
        except Exception as e:  # noqa: BLE001 — sweep must not fail open
            logger.warning("region %s: orphan sweep list failed: %s",
                           self.name, e)
            return 0
        for key in keys:
            if key.rsplit("/", 1)[-1] in referenced:
                continue
            try:
                self.store.delete(key)
                removed += 1
            except Exception as e:  # noqa: BLE001
                logger.warning("region %s: orphan sweep could not delete "
                               "%s: %s", self.name, key, e)
        if removed:
            from ..common.telemetry import increment_counter
            increment_counter("orphan_ssts_purged", removed)
            logger.warning("region %s: purged %d orphan SST file(s) left "
                           "by a crash", self.name, removed)
        return removed

    def _replay_wal(self, flushed_sequence: int) -> None:
        vc = self.version_control
        replayed = skipped = 0
        for seq, schema_version, payload in self.wal.read_from(flushed_sequence + 1):
            if seq <= flushed_sequence:
                continue
            # a malformed record must not brick the region forever: count the
            # sequence as consumed, log, and continue (write-side validation
            # makes this unreachable in normal operation)
            try:
                wb = WriteBatch.decode(payload, vc.current.schema)
                vc.current.memtables.mutable.write(seq, wb)
                replayed += 1
            except Exception:  # noqa: BLE001
                logger.exception(
                    "region %s: skipping unreplayable WAL record seq=%d",
                    self.name, seq)
                skipped += 1
            vc.set_committed_sequence(max(vc.committed_sequence, seq))
        if replayed or skipped:
            logger.info("region %s replayed %d WAL entries (%d skipped)",
                        self.name, replayed, skipped)

    # ---- write path ----
    def write(self, batch: WriteBatch) -> int:
        """WAL append → memtable insert → sequence bump. Returns rows written.

        With WAL group commit active (sync_on_write + `SET
        wal_group_commit`), the record is appended under the writer lock
        but the fsync wait happens OUTSIDE it: N concurrent writers
        overlap their appends and share ONE fsync. The ack-side contract
        is unchanged — success returns only after the shared fsync
        covers this write's record. The FAILURE path differs from
        per-append mode: the memtable insert precedes the durability
        wait (visibility must precede the committed-sequence bump the
        incremental scan cache watermarks on), so a write whose shared
        fsync FAILS surfaces its error un-acked but leaves its rows
        visible until restart — the same may-be-durable, never-acked
        class recovery already legally resurfaces (torture invariant:
        "unacked rows appear at most once, or not at all")."""
        from ..common.telemetry import increment_counter, timer
        stall = False
        wal_ticket = None
        with timer("region_write"), self._writer_lock:
            if self.closed:
                raise RegionClosedError(f"region {self.name} closed")
            if self.fenced:
                from ..errors import StaleRouteError
                raise StaleRouteError(
                    f"region {self.name} is fenced for migration")
            vc = self.version_control
            seq = vc.next_sequence()
            with timer("wal_append"):
                try:
                    if self.wal.group_commit_active():
                        wal_ticket = self.wal.append_async(
                            seq, batch.encode(),
                            schema_version=vc.current.schema.version)
                    else:
                        self.wal.append(
                            seq, batch.encode(),
                            schema_version=vc.current.schema.version)
                except BaseException:
                    # the record may already be durable (fsync failed AFTER
                    # the write, an injected wal_fsync fault, a torn tail):
                    # burn the sequence — reusing it would put two different
                    # batches at one seq and make the replay winner undefined
                    vc.set_committed_sequence(
                        max(vc.committed_sequence, seq))
                    raise
            # committed_sequence advances only after the memtable insert:
            # snapshot readers sample it without the writer lock, so rows
            # must be visible in the memtable before their sequence is —
            # the incremental scan cache records `visible` as its permanent
            # high-watermark and would otherwise skip the batch forever.
            # The finally still consumes the sequence on insert failure
            # (it hit the WAL; reuse would corrupt replay).
            try:
                # crash HERE = killed between WAL append and memtable
                # insert: the row is unacked but durable, so recovery may
                # legally surface it (once) — the torture matrix asserts
                # exactly that
                _fp.fail_point("region_write_memtable")
                vc.current.memtables.mutable.write(seq, batch)
            finally:
                vc.set_committed_sequence(seq)
            mts = vc.current.memtables
            if mts.mutable_bytes >= self.flush_size_bytes:
                if self.scheduler is None:
                    self.flush()          # no background pool: inline
                else:
                    self._freeze_and_schedule_flush(background=True)
            stall = (self.version_control.current.memtables.total_bytes -
                     self.version_control.current.memtables.mutable_bytes
                     ) >= self.stall_bytes
        if wal_ticket is not None:
            # group commit: park for the shared fsync OUTSIDE the writer
            # lock so concurrent writers can append meanwhile. A failure
            # here reaches the caller un-acked; the sequence is already
            # consumed and the record replays (at most once) like any
            # other durable-but-unacked write.
            with timer("wal_group_wait"):
                self.wal.wait_durable(wal_ticket)
        if stall and self.scheduler is not None:
            # write stall: block (outside the writer lock so the flush
            # worker can commit) until the backlog drains
            increment_counter("region_write_stalls")
            self._flush_done.wait(timeout=300)
        hook = self.on_commit
        if hook is not None:
            # continuous replica ship: the hook only wakes the shipper
            # thread, after durability — a hook failure must never turn
            # an acked write into an error
            try:
                hook(self)
            except Exception:  # noqa: BLE001
                logger.exception("region %s on_commit hook failed",
                                 self.name)
        increment_counter("region_write_rows", batch.num_rows)
        return batch.num_rows

    def bulk_ingest(self, data, *,
                    chunk_rows: Optional[int] = None) -> int:
        """WAL-less bulk load: sort, series-encode, and write the batch
        straight to L0 SSTs — in parallel chunks — then commit one
        manifest edit. Durability comes from the SSTs themselves (the
        manifest edit is the commit point; a crash before it leaves only
        orphan files), so the WAL append, memtable copy, and later flush
        of the normal write path disappear. The LSM "direct part write"
        pattern; the reference reaches similar rates by keeping its
        write path native end-to-end (src/storage/src/region/writer.rs).

        Any buffered memtable rows are flushed first so the manifest's
        flushed_sequence may advance past this batch's sequence without
        orphaning their WAL entries at replay.

        Each call records its stage breakdown in `self.last_ingest_profile`
        (series encode / sort / parquet+fsync / manifest — the profile
        BASELINE.md publishes)."""
        import os as _os
        import time as _time

        from ..common.runtime import parallel_map
        from ..common.telemetry import increment_counter
        from ..ops.kernels import _merge_order

        prof = IngestProfile()
        _t = _time.perf_counter()
        _t0 = _t

        def mark(stage: str) -> None:
            nonlocal _t
            now = _time.perf_counter()
            prof.stages[stage] = prof.stages.get(stage, 0.0) + (now - _t)
            _t = now

        if chunk_rows is None:
            # one SST per writer core: chunking only pays when parquet
            # encodes run concurrently, and fewer files mean single-run
            # (merge-free) scan slices later
            cpus = _os.cpu_count() or 1
            n_in = len(next(iter(data.values()))) if data else 0
            chunk_rows = max(2_000_000, -(-n_in // cpus))

        if self.fenced:
            from ..errors import StaleRouteError
            raise StaleRouteError(
                f"region {self.name} is fenced for migration")
        vc = self.version_control
        schema0 = vc.current.schema
        # all-ndarray batches skip the WriteBatch/Vector coercion (string
        # <U→object conversion alone costs ~0.2s per 2M rows); anything
        # else goes through the validating path
        raw = isinstance(data, dict) and \
            all(isinstance(v, np.ndarray) for v in data.values()) and \
            all(c.name in data for c in schema0.column_schemas) and \
            all(not (c.dtype.is_string or c.dtype.is_binary) or c.is_tag
                for c in schema0.column_schemas if c.name in data)
        if raw:
            rb = None
            n = len(next(iter(data.values())))
            if any(len(v) != n for v in data.values()):
                raise InvalidArgumentsError("ragged bulk_ingest columns")
        else:
            wb = WriteBatch(schema0)
            wb.put(data)
            rb = wb.mutations[0].data
            n = rb.num_rows
        if n == 0:
            return 0
        prof.rows = n
        mark("coerce")
        if any(mt.num_rows for mt in vc.current.memtables.all_memtables()):
            self.flush()
            mark("pre_flush")
        with self._writer_lock:
            if self.closed:
                raise RegionClosedError(f"region {self.name} closed")
            if self.fenced:
                # RE-checked under the lock: the early check races the
                # fence — a bulk commit slipping past it would land rows
                # in neither the pre-fence flush nor the shipped WAL
                # tail (acked-write loss across the migration)
                from ..errors import StaleRouteError
                raise StaleRouteError(
                    f"region {self.name} is fenced for migration")
            schema = vc.current.schema
            seq = vc.next_sequence()
            vc.set_committed_sequence(seq)
            tag_names = schema.tag_names()
            if tag_names:
                tag_cols = []
                for t in tag_names:
                    if rb is None:
                        tag_cols.append(data[t])
                    else:
                        vec = rb.column(t)
                        tag_cols.append(vec.data if vec.validity is None
                                        else vec.to_pylist())
                sids = self.series_dict.encode_rows(tag_cols)
            else:
                sids = self.series_dict.encode_zero_tags(n)
            mark("series_encode")
            ts_name = schema.timestamp_column.name
            ts = np.asarray(data[ts_name] if rb is None
                            else rb.column(ts_name).data, dtype=np.int64)
            # loaders usually present rows grouped by tag in time order —
            # already (sid, ts)-sorted, so the sort AND the per-column
            # gather copies can be skipped entirely
            pre_sorted = n <= 1 or bool(np.all(
                (sids[1:] > sids[:-1]) |
                ((sids[1:] == sids[:-1]) & (ts[1:] >= ts[:-1]))))
            if pre_sorted:
                order = None
                mark("sort_check")
            else:
                mark("sort_check")
                order = _merge_order(sids, ts, np.zeros(n, np.int64))
                sids = sids[order]
                ts = ts[order]
                mark("sort")
            fields = {}
            for c in schema.field_columns():
                if rb is None:
                    want = c.dtype.np_dtype
                    d = data[c.name]
                    if want is not None and d.dtype != want:
                        d = d.astype(want)
                    vd = None
                elif rb.schema.contains(c.name):
                    vec = rb.column(c.name)
                    d = np.asarray(vec.data)
                    vd = vec.validity
                else:
                    d, vd = compat_column(c, n)
                    fields[c.name] = (d, vd)
                    continue
                if order is not None:
                    d = d[order]
                    vd = vd[order] if vd is not None else None
                fields[c.name] = (d, vd)
            seq_arr = np.full(n, seq, dtype=np.int64)
            op_arr = np.zeros(n, dtype=np.int8)
            mark("field_prep")

            # chunk at SERIES boundaries: a (sid, ts) key must not span
            # two files (same sequence → undefined MVCC winner), and
            # keeping whole series per file makes the chunks' key
            # rectangles disjoint — so compaction trivially moves them
            # instead of rewriting the region. Write SSTs concurrently;
            # parquet encode drops the GIL.
            cuts = [0]
            pos = chunk_rows
            while pos < n:
                while pos < n and sids[pos] == sids[pos - 1]:
                    pos += 1
                if pos < n:
                    cuts.append(pos)
                pos += chunk_rows
            cuts.append(n)
            tag_id_cols = {
                name: self.series_dict.tag_id_column(sids, i)
                for i, name in enumerate(self.series_dict.tag_names)}

            def write_chunk(k):
                a, b = cuts[k], cuts[k + 1]
                return self.access_layer.write_sst(
                    level=0, series_ids=sids[a:b], ts=ts[a:b],
                    seq=seq_arr[a:b], op_types=op_arr[a:b],
                    fields={nm: (d[a:b],
                                 vd[a:b] if vd is not None else None)
                            for nm, (d, vd) in fields.items()},
                    tag_columns={nm: (idx[a:b], vals)
                                 for nm, (idx, vals) in tag_id_cols.items()},
                    schema=schema)

            mark("chunk_plan")
            files = [f for f in parallel_map(write_chunk,
                                             range(len(cuts) - 1))
                     if f is not None]
            mark("sst_write")
            flushed_seq = max(seq, vc.current.flushed_sequence)
            # a write() may have landed between the pre-lock flush and
            # acquiring the lock: its WAL entry carries a lower sequence,
            # and advancing flushed_sequence past it would skip it at
            # replay (WAL replays from flushed_sequence + 1). Cap below
            # the lowest unflushed memtable sequence; the bulk rows need
            # no WAL replay (they are durable in the SSTs just written).
            unflushed = [int(ms.seq.min()) for ms in
                         (mt.snapshot()
                          for mt in vc.current.memtables.all_memtables())
                         if ms.num_rows]
            if unflushed:
                flushed_seq = min(flushed_seq, min(unflushed) - 1)
            dict_file = self._persist_series_dict()
            mark("dict_persist")
            edit = {
                "type": "edit",
                "added": [f.to_dict() for f in files],
                "removed": [],
                "flushed_sequence": flushed_seq,
                # the batch's sequence is durable in the SSTs even when
                # flushed_sequence is capped below it (unflushed racing
                # write) — persist it so recovery never re-issues it
                "committed_sequence": seq,
            }
            if dict_file:
                edit["series_dict_file"] = dict_file
            # crash HERE = SSTs durable but uncommitted: the batch was
            # never acked, reopen must sweep the orphans and show nothing
            _fp.fail_point("bulk_commit")
            mv = self.manifest.save([edit])
            vc.apply_flush(memtable_ids=[], files=files,
                           flushed_sequence=flushed_seq,
                           manifest_version=mv)
            self._maybe_checkpoint()
            l0_count = len(vc.current.ssts.levels[0])
            mark("manifest")
            prof.total_s = _time.perf_counter() - _t0
            self.last_ingest_profile = prof
        increment_counter("ingest_rows", n)
        increment_counter("ingest_sst_files", len(files))
        from ..common.telemetry import _observe
        _observe("bulk_ingest", prof.total_s)
        if self.scheduler is not None and l0_count >= self.max_l0_files:
            self.schedule_compaction()
        return n

    # ---- flush ----
    #: background flush/compaction failures retry this many times with
    #: exponential backoff before standing down until the next trigger
    BG_MAX_RETRIES = 8

    def _freeze_and_schedule_flush(self, background: bool = False):
        """Freeze the mutable memtable and queue a background flush.
        Caller holds the writer lock. background=True (the write-path
        trigger, no caller waits) routes through the retrying wrapper:
        a transient failure backs off and re-runs instead of wedging
        the region behind a memtable backlog forever; the synchronous
        flush() path keeps raw error propagation through its handle."""
        vc = self.version_control
        if vc.current.memtables.mutable.num_rows:
            vc.freeze_mutable(Memtable(vc.current.schema, self.series_dict))
        if not vc.current.memtables.immutables:
            return None
        self._flush_done.clear()
        try:
            job = self._flush_job_bg if background else self._flush_job
            return self.scheduler.submit(f"flush:{self.uid}", job)
        except RuntimeError:
            # engine shutting down: skip — the WAL keeps the frozen data
            # durable and replay restores it on the next open
            self._flush_done.set()
            return None

    # ---- background-job degradation ----
    def _flush_job_bg(self) -> List[FileMeta]:
        try:
            files = self._flush_job()
        except Exception as e:  # noqa: BLE001 — retried below
            self._note_bg_failure("flush", e)
            return []
        self._note_bg_success("flush")
        return files

    def _compact_job_bg(self) -> List[FileMeta]:
        try:
            files = self._compact_job()
        except Exception as e:  # noqa: BLE001 — retried below
            self._note_bg_failure("compaction", e)
            return []
        self._note_bg_success("compaction")
        return files

    def _note_bg_success(self, op: str) -> None:
        self._bg_failures.pop(op, None)

    def _note_bg_failure(self, op: str, e: Exception) -> None:
        """A background flush/compaction failed: record it for /status,
        then re-queue with exponential backoff. After BG_MAX_RETRIES
        consecutive failures the job stands down (the next write-path
        trigger starts a fresh attempt cycle) instead of spinning."""
        from ..common.telemetry import increment_counter
        n = self._bg_failures.get(op, 0) + 1
        self._bg_failures[op] = n
        info = self.bg_errors.setdefault(op, {"count": 0, "last_error": ""})
        info["count"] += 1
        info["last_error"] = f"{type(e).__name__}: {e}"
        increment_counter(f"{op}_bg_failures")
        if self.closed or self.scheduler is None:
            return
        if n > self.BG_MAX_RETRIES:
            logger.error(
                "region %s: background %s failed %d times (%s); standing "
                "down until the next trigger", self.name, op, n, e)
            self._bg_failures.pop(op, None)
            return
        delay = min(0.05 * (2 ** (n - 1)), 30.0)
        increment_counter(f"{op}_bg_retries")
        logger.warning(
            "region %s: background %s failed (%s); retry %d/%d in %.2fs",
            self.name, op, e, n, self.BG_MAX_RETRIES, delay)
        if op == "flush":
            key, fn = f"flush:{self.uid}", self._flush_job_bg
        else:
            key, fn = f"compact:{self.uid}", self._compact_job_bg
        self.scheduler.submit_later(key, fn, delay)

    def flush(self) -> List[FileMeta]:
        """Flush all frozen + mutable data to L0 SSTs and wait for
        completion (reference: src/storage/src/flush.rs FlushJob). The
        write path instead schedules `_flush_job` asynchronously."""
        if self.fenced:
            # mid-handoff: the shared manifest belongs to the adopting
            # node; the WAL tail already shipped everything unflushed
            return []
        if self.scheduler is None:
            with self._writer_lock:
                vc = self.version_control
                if vc.current.memtables.mutable.num_rows:
                    vc.freeze_mutable(Memtable(vc.current.schema,
                                               self.series_dict))
                if not vc.current.memtables.immutables:
                    return []
                return self._flush_job()
        with self._writer_lock:
            handle = self._freeze_and_schedule_flush()
            frozen = {m.id for m in
                      self.version_control.current.memtables.immutables}
        files = handle.wait(timeout=600) if handle is not None else []
        # the submit may have coalesced onto an already-queued BACKGROUND
        # flush whose failure is swallowed for retry — a synchronous flush
        # must not report success while the memtables it froze are still
        # unflushed (callers like /v1/admin/flush rely on the contract)
        if not self.closed and not self.fenced and frozen & {
                m.id for m in
                self.version_control.current.memtables.immutables}:
            last = self.bg_errors.get("flush", {}).get("last_error",
                                                       "unknown error")
            raise StorageError(
                f"flush of region {self.name} failed: {last}")
        return files

    def _flush_job(self) -> List[FileMeta]:
        """Write every frozen memtable to L0 SSTs; record the edit in the
        manifest; truncate the WAL. Runs on a scheduler worker: SST encode
        happens outside the writer lock, only the commit takes it."""
        try:
            return self._flush_job_inner()
        finally:
            # a failed flush must not leave stalled writers blocking their
            # full timeout — they re-check the backlog and stall again if
            # it is still above the limit
            self._flush_done.set()

    def _flush_job_inner(self) -> List[FileMeta]:
        from ..common.telemetry import increment_counter, span, timer
        if self.closed or self.fenced:
            # a delayed retry may fire after DROP destroyed the region
            # dir: writing SSTs there would leak files forever (a dropped
            # region never reopens, so no sweep collects them). A FENCED
            # region's manifest belongs to the adopting node now — its
            # WAL tail already shipped, so flushing it here would race
            # the new owner's manifest edits with duplicate data.
            return []
        vc = self.version_control
        to_flush = list(vc.current.memtables.immutables)
        if not to_flush:
            return []
        # a background job roots its own trace (information_schema.
        # background_jobs + the durable trace store see it); the span
        # timer keeps feeding greptime_region_flush_seconds
        from ..common import background_jobs
        with background_jobs.job("flush", region=self.name), \
                span("region_flush", region=self.name), \
                timer("region_flush"):
            files = self._flush_memtables(to_flush)
        increment_counter("flush_files", len(files))
        increment_counter("flush_rows",
                          sum(f.num_rows for f in files))
        return files

    def _flush_memtables(self, to_flush) -> List[FileMeta]:
        vc = self.version_control
        # safe WAL truncation point: every row with seq <= the max sequence
        # in the frozen set lives in these memtables (the mutable only
        # receives later sequences)
        flushed_seq = 0
        files: List[FileMeta] = []
        for mt in to_flush:
            snap = mt.snapshot()
            if snap.num_rows:
                flushed_seq = max(flushed_seq, int(snap.seq.max()))
            meta = self._flush_memtable(mt)
            if meta is not None:
                files.append(meta)
        with self._writer_lock:
            if self.closed:
                return files
            flushed_seq = max(flushed_seq, vc.current.flushed_sequence)
            dict_file = self._persist_series_dict()
            edit = {
                "type": "edit",
                "added": [f.to_dict() for f in files],
                "removed": [],
                "flushed_sequence": flushed_seq,
            }
            if dict_file:
                edit["series_dict_file"] = dict_file
            # crash HERE = flush SSTs durable but uncommitted: the WAL
            # still covers every frozen row, so reopen replays them and
            # sweeps the orphan files — no loss, no duplication
            _fp.fail_point("flush_commit")
            mv = self.manifest.save([edit])
            vc.apply_flush(memtable_ids=[m.id for m in to_flush],
                           files=files, flushed_sequence=flushed_seq,
                           manifest_version=mv)
            self._maybe_checkpoint()
            self.wal.obsolete(flushed_seq)
            l0_count = len(vc.current.ssts.levels[0])
        if self.scheduler is not None and l0_count >= self.max_l0_files:
            self.schedule_compaction()
        return files

    def _flush_memtable(self, mt: Memtable) -> Optional[FileMeta]:
        snap = mt.snapshot()
        if snap.num_rows == 0:
            return None
        # sort by (series, ts, seq) but KEEP all sequences/ops: MVCC history
        # collapses only at compaction (dedup here would break snapshot reads
        # of older sequences — matches reference flush semantics)
        from ..ops.kernels import _merge_order
        order = _merge_order(snap.series_ids, snap.ts, snap.seq)
        sids = snap.series_ids[order]
        # (indices, values) pairs: write_sst builds DictionaryArrays
        # directly — no 2M-string materialize + re-encode round trip
        tag_cols = {
            name: self.series_dict.tag_id_column(sids, i)
            for i, name in enumerate(self.series_dict.tag_names)}
        fields = {}
        for name, (data, valid) in snap.fields.items():
            fields[name] = (data[order], valid[order] if valid is not None else None)
        return self.access_layer.write_sst(
            level=0, series_ids=sids, ts=snap.ts[order], seq=snap.seq[order],
            op_types=snap.op_types[order], fields=fields,
            tag_columns=tag_cols, schema=mt.schema)

    def _persist_series_dict(self) -> Optional[str]:
        if self.series_dict.num_series == self._persisted_series:
            return None
        _fp.fail_point("dict_persist")
        name = f"dict/series-{self._dict_version}.json"
        self.store.write(f"{self.descriptor.region_dir}/{name}",
                         json.dumps(self.series_dict.to_dict()).encode())
        self._dict_version += 1
        self._persisted_series = self.series_dict.num_series
        return name

    def _maybe_checkpoint(self) -> None:
        if not self.manifest.should_checkpoint():
            return
        vc = self.version_control
        v = vc.current
        dict_file = (f"dict/series-{self._dict_version - 1}.json"
                     if self._dict_version else None)
        self.manifest.save_checkpoint({
            "schema": v.schema.to_dict(),
            "ssts": v.ssts.to_dict(),
            "flushed_sequence": v.flushed_sequence,
            "committed_sequence": vc.committed_sequence,
            "series_dict_file": dict_file,
        })
        self.manifest.gc()

    # ---- compaction ----
    def schedule_compaction(self, wait: bool = False):
        """Queue a background compaction (dedup-keyed: repeat submits while
        one is queued coalesce). Returns the job handle."""
        if self.scheduler is None:
            return self._compact_job()
        try:
            # fire-and-forget submits degrade gracefully (retry with
            # backoff on failure); waited submits keep raw errors so the
            # caller sees them on handle.wait()
            job = self._compact_job if wait else self._compact_job_bg
            handle = self.scheduler.submit(f"compact:{self.uid}", job)
        except RuntimeError:
            return None                  # engine shutting down
        if wait:
            out = handle.wait(timeout=600)
            # the submit may have coalesced onto a queued BACKGROUND job
            # whose failure was swallowed for retry: a pending failure
            # count means the compaction the caller waited on did not land
            if not out and self._bg_failures.get("compaction"):
                raise StorageError(
                    f"compaction of region {self.name} failed: "
                    f"{self.bg_errors.get('compaction', {}).get('last_error', 'unknown error')}")
            return out
        return handle

    def compact(self, now_ms: Optional[int] = None) -> List[FileMeta]:
        """Synchronous manual compaction (reference: writer.rs:681 manual
        compact path; ALTER TABLE ... COMPACT / admin endpoint). Serialized
        with background compactions through the scheduler's dedup key —
        two concurrent runs over the same L0 inputs would each write an L1
        copy of every row."""
        if self.closed:
            return []
        if self.scheduler is not None:
            try:
                out = self.scheduler.submit(
                    f"compact:{self.uid}",
                    lambda: self._compact_job(min_l0_files=1,
                                              now_ms=now_ms)
                ).wait(timeout=600)
                if not out and \
                        self.version_control.current.ssts.levels[0]:
                    # the submit coalesced into an already-queued background
                    # job that declined (below its L0 threshold) — run the
                    # manual plan now that the key is free
                    out = self.scheduler.submit(
                        f"compact:{self.uid}",
                        lambda: self._compact_job(min_l0_files=1,
                                                  now_ms=now_ms)
                    ).wait(timeout=600)
                return out
            except RuntimeError:
                return []
        return self._compact_job(min_l0_files=1, now_ms=now_ms)

    def _compact_job(self, min_l0_files: Optional[int] = None,
                     now_ms: Optional[int] = None) -> List[FileMeta]:
        from .compaction import pick_compaction, run_compaction
        if self.closed or self.fenced:
            # fenced: the shared region dir belongs to the adopting node;
            # a compaction here would purge files its manifest references
            return []
        plan = pick_compaction(
            self.version_control.current.ssts, ttl_ms=self.ttl_ms,
            now_ms=now_ms,
            min_l0_files=self.max_l0_files if min_l0_files is None
            else min_l0_files,
            time_window_ms=self.compaction_time_window_ms)
        if plan is None:
            return []
        return run_compaction(self, plan, ttl_ms=self.ttl_ms, now_ms=now_ms)

    def commit_compaction(self, *, removed: List[str],
                          added: List[FileMeta],
                          retracts: bool = False,
                          purge: bool = True) -> None:
        """Swap compaction outputs into the version + manifest and hand the
        removed files to the purger (they stay readable until the grace
        period passes). retracts=True marks that visible rows disappeared
        (TTL expiry), invalidating incremental scan caches. purge=False is
        the trivial-move case: `removed` names reappear in `added` at a
        deeper level (same physical files), so nothing may be deleted."""
        with self._writer_lock:
            if self.closed:
                return
            # crash HERE = compaction outputs durable but uncommitted:
            # inputs stay referenced (still readable), outputs are
            # orphans for the reopen sweep — no data moves twice
            _fp.fail_point("compaction_commit")
            mv = self.manifest.save([{
                "type": "edit",
                "added": [f.to_dict() for f in added],
                "removed": list(removed),
            }])
            self.version_control.apply_compaction(
                removed=removed, added=added, manifest_version=mv)
            if retracts:
                self.retraction_epoch += 1
            self._maybe_checkpoint()
        if purge:
            for name in removed:
                if self.purger is not None:
                    self.purger.schedule(
                        (lambda n=name: self.access_layer.delete_sst(n)),
                        name)

    # ---- TTL ----
    def apply_ttl(self, now_ms: Optional[int] = None) -> int:
        """Drop whole SSTs past the region TTL (row-level expiry happens at
        compaction). Returns the number of files dropped."""
        if self.ttl_ms is None:
            return 0
        import time as _time
        now_ms = int(_time.time() * 1000) if now_ms is None else now_ms
        cutoff = now_ms - self.ttl_ms
        expired = [f for f in self.version_control.current.ssts.all_files()
                   if f.time_range[1] < cutoff]
        if not expired:
            return 0
        from ..common import background_jobs
        with background_jobs.job("ttl_sweep", region=self.name,
                                 files=len(expired)):
            self.commit_compaction(removed=[f.file_name for f in expired],
                                   added=[], retracts=True)
        return len(expired)

    # ---- alter ----
    def alter(self, new_schema: Schema) -> None:
        """Schema change: bump version, record in manifest, swap memtable.
        (reference: src/storage/src/region/writer.rs alter path)"""
        with self._writer_lock:
            vc = self.version_control
            new_schema = Schema(new_schema.column_schemas,
                                version=vc.current.schema.version + 1)
            mv = self.manifest.save([{
                "type": "change", "schema": new_schema.to_dict(),
                "committed_sequence": vc.committed_sequence}])
            # tags are immutable in v0 (same as reference): series dict unchanged
            new_mutable = Memtable(new_schema, self.series_dict)
            vc.apply_schema_change(new_schema, new_mutable, mv)
            self.descriptor.schema = new_schema
            self.access_layer.schema = new_schema
            self._maybe_checkpoint()

    @property
    def schema(self) -> Schema:
        """Current (possibly altered) region schema."""
        return self.version_control.current.schema

    # ---- read ----
    def snapshot(self) -> RegionSnapshot:
        vc = self.version_control
        return RegionSnapshot(self, vc.current, vc.committed_sequence)

    # ---- elastic handoff (meta/balancer.py drives these) ----
    def _fence_marker_path(self) -> str:
        import os as _os
        return _os.path.join(self.descriptor.wal_dir, FENCE_MARKER)

    def fence(self) -> None:
        """Stop accepting writes, durably: the marker file (node-local,
        next to the WAL) survives a restart, so a crashed-and-reopened
        old owner cannot ack a write the migration target never sees.
        Waits out any in-flight flush so the shared manifest is quiescent
        before the caller reads the WAL tail."""
        import os as _os
        from ..utils import atomic_write
        with self._writer_lock:
            if self.fenced:
                return
            _os.makedirs(self.descriptor.wal_dir, exist_ok=True)
            atomic_write(self._fence_marker_path(), "fenced\n",
                         tmp_prefix=".fence-")
            self.fenced = True
            # crash HERE (torture): the marker is durable, so the reopened
            # region comes back fenced and the balancer resumes the step
            _fp.fail_point("balancer_handoff_fence")
        # outside the writer lock: the flush worker needs it to commit
        self._flush_done.wait(timeout=60)
        logger.info("region %s fenced for handoff", self.name)

    def unfence(self) -> None:
        """Roll back a fence (aborted migration), or complete a standby
        promotion: the region starts accepting writes again."""
        import os as _os
        with self._writer_lock:
            try:
                _os.remove(self._fence_marker_path())
            except FileNotFoundError:
                pass
            self.fenced = False
            self.standby = False
        logger.info("region %s unfenced", self.name)

    def make_standby(self) -> None:
        """Mark this region a read-replica standby, durably: the marker
        (content "standby", same node-local file as fence()) survives a
        restart, so the replica reopens fenced-for-writes but
        read-serving. A standby never flushes or compacts — the shared
        region dir belongs to the leader — and catches up either from
        shipped WAL records (ingest_wal_tail) or by reopening from the
        leader's advanced manifest (StorageEngine.reopen_region)."""
        import os as _os
        from ..utils import atomic_write
        with self._writer_lock:
            _os.makedirs(self.descriptor.wal_dir, exist_ok=True)
            atomic_write(self._fence_marker_path(), "standby\n",
                         tmp_prefix=".fence-")
            self.fenced = True
            self.standby = True
        logger.info("region %s is now a standby replica", self.name)

    def wal_entries_since(self, after_seq: int,
                          max_records: Optional[int] = None) -> List[dict]:
        """WAL records in (after_seq, committed], wire-encodable — the
        continuous replica ship feed. Unlike wal_tail() this is safe on
        a LIVE region: records past the committed sequence (concurrent
        in-flight appends) are excluded, and the WAL's read path never
        truncates the active segment, so shipping proceeds under full
        write load without fencing."""
        import base64
        if isinstance(self.wal, NoopWal):
            return []        # disable_wal region: nothing to ship
        committed = self.version_control.committed_sequence
        out: List[dict] = []
        for seq, schema_version, payload in self.wal.read_from(
                after_seq + 1):
            if seq <= after_seq:
                continue
            if seq > committed:
                break
            out.append({"seq": int(seq), "schema_version": schema_version,
                        "payload": base64.b64encode(payload).decode()})
            if max_records is not None and len(out) >= max_records:
                break
        return out

    def wal_tail(self) -> List[dict]:
        """Every WAL record past the flushed sequence, wire-encodable —
        the delta the migration target replays on top of the shared
        object store's last-flushed state. Call only on a FENCED region
        (the tail must be final)."""
        import base64
        flushed = self.version_control.current.flushed_sequence
        out: List[dict] = []
        for seq, schema_version, payload in self.wal.read_from(flushed + 1):
            if seq <= flushed:
                continue
            out.append({"seq": int(seq), "schema_version": schema_version,
                        "payload": base64.b64encode(payload).decode()})
        return out

    def ingest_wal_tail(self, entries: List[dict]) -> int:
        """Replay a shipped WAL tail into this (adopted) region: each
        record appends to the LOCAL WAL for durability, then lands in
        the memtable at its ORIGINAL sequence so MVCC ordering matches
        the source exactly. Idempotent: records at or below the committed
        sequence are skipped, so a crash mid-replay resumes cleanly."""
        import base64
        replayed = 0
        with self._writer_lock:
            if self.closed:
                raise RegionClosedError(f"region {self.name} closed")
            vc = self.version_control
            for e in entries:
                seq = int(e["seq"])
                if seq <= vc.committed_sequence:
                    continue
                _fp.fail_point("balancer_wal_tail_replay")
                payload = base64.b64decode(e["payload"])
                self.wal.append(
                    seq, payload,
                    schema_version=int(e.get("schema_version") or 0))
                wb = WriteBatch.decode(payload, vc.current.schema)
                vc.current.memtables.mutable.write(seq, wb)
                vc.set_committed_sequence(seq)
                replayed += 1
        if replayed:
            logger.info("region %s replayed %d shipped WAL tail record(s)",
                        self.name, replayed)
        return replayed

    def release(self) -> None:
        """Hand the region off: close WITHOUT flushing (the new owner
        already has everything — last-flushed SSTs plus the shipped WAL
        tail) and delete the node-local WAL + fence marker. Shared
        object-store data is untouched: it belongs to the new owner."""
        with self._writer_lock:
            self.closed = True
            self.wal.close()
        import shutil
        shutil.rmtree(self.descriptor.wal_dir, ignore_errors=True)
        logger.info("region %s released to its new owner", self.name)

    # ---- misc ----
    def drop(self) -> None:
        """Tombstone the manifest, then physically delete region data + WAL.

        The remove action lands first so a crash mid-delete leaves a region
        that `open()` reports as gone; leftover files are garbage, never
        resurrected state. Physical removal lets the name be re-created
        (TRUNCATE = drop + create)."""
        with self._writer_lock:
            self.manifest.save([{"type": "remove"}])
            self.closed = True
            self.wal.close()
        for key in self.store.list(self.descriptor.region_dir):
            self.store.delete(key)
        import shutil
        shutil.rmtree(self.descriptor.wal_dir, ignore_errors=True)

    def close(self) -> None:
        with self._writer_lock:
            self.closed = True
            self.wal.close()


# ---- promotion-time WAL salvage (datanode repl_promote drives these; the
# old leader is DEAD, so its node-local WAL dir is operated on by path) ----

def fence_wal_dir(wal_dir: str) -> None:
    """Durably fence a region by WAL-directory path alone — written into
    a dead leader's node-local WAL dir before salvaging its tail: if the
    old owner resurrects, Region.open sees the marker and comes back
    fenced, so it can never ack a write the promoted replica misses."""
    import os as _os
    from ..utils import atomic_write
    _os.makedirs(wal_dir, exist_ok=True)
    atomic_write(_os.path.join(wal_dir, FENCE_MARKER), "fenced\n",
                 tmp_prefix=".fence-")


def salvage_wal_entries(wal_dir: str, after_seq: int) -> List[dict]:
    """Every record past after_seq from a dead node's WAL directory,
    wire-encodable. Opening a fresh Wal over the dir recovers its
    segments; a torn tail (the leader was killed mid-append) holds only
    never-acked records — the ack always follows the fsync — so the
    open-time repair-truncate cannot drop an acked row. A missing dir
    degrades to an empty salvage (a leader that never wrote)."""
    import base64
    import os as _os
    if not _os.path.isdir(wal_dir):
        return []
    wal = Wal(wal_dir)
    try:
        out: List[dict] = []
        for seq, schema_version, payload in wal.read_from(after_seq + 1):
            if seq <= after_seq:
                continue
            out.append({"seq": int(seq), "schema_version": schema_version,
                        "payload": base64.b64encode(payload).decode()})
        return out
    finally:
        wal.close()
