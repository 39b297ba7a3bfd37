"""The aggregate fast path on the GPU.

Executes the canonical time-series shape — scan → filter → group by tags
and/or time bucket → aggregate — as one kernel launch per region:

1. per-region merged scan (sorted by (series, ts), MVCC-deduped) from a
   version-keyed cache; its device mirrors stay resident across queries
   until the region version changes;
2. groups are contiguous runs over (series [, bucket]), found on the host;
3. the segment-moments kernel (ops/kernels.py, csrc/segment_moments.cu)
   computes every decomposable moment of the plan (sum/sum_sq/count/min/
   max/first+ts/last+ts) per run in one launch; one device-to-host copy
   brings them back, and runs fold into the final SQL groups on the host
   (`_finalize`), which also merges partials across regions.

Anything outside this shape returns None and the engine falls back to the
CPU columnar executor. Reference: greptimedb_tpu/query/tpu_exec.py.
A distributed table (frontend/distributed.py, `execute_tpu_plan`) takes
the aggregate pushdown: the datanodes reduce their regions and the
frontend folds their moment frames; it is never routed to the CPU by the
dispatch floor, and `SET dist_partial_agg = 0` plans no pushdown at all
(the raw-row scatter answers). A `count(DISTINCT)` lowers to a sketch
partial (`count_distinct`, query/sketches.py) only in that pushdown and
only while `SET exact_distinct` is 0; a local table keeps the exact
raw-row path.
`region_moment_frames` routes each region as the reference does: a point
or IN tag query on an uncached region takes the SST index
(`_indexed_point_frames`, reduced on the host), a region too big for the
cache streams in slices (`query/stream_exec.py`), and the rest go through
the cache, whose entries take in a new version's delta incrementally
(`_ScanCache._incremental`), with concurrent identical scans of a region
fused into one pass (`SCAN_FLIGHTS`). Sketch moments (count(DISTINCT),
approx_distinct, approx_percentile, median: query/sketches.py) and
expression moments (`sum(a*b)`) reduce on the host on every path
(`plan_needs_host`), as in the reference; their partials fold in
`_finalize` like the device's.

What the resident path reads from a table and its regions
(storage/region.py): a table's `schema`, `name`, `info` and `regions`; a
region's `uid`, `name`, `series_dict`, `version_control.current`
(memtable and SST row counts for the dispatch floor and the streaming
bounds) and `.committed_sequence` (scan fusion's key), its
`retraction_epoch` when it has one, and `snapshot()` with `.scan()` →
ScanData, `.visible_sequence` and `._version` (`.schema.version`,
`.ssts.all_files()`). The incremental merge, the streamed and the
indexed-point paths read the region's memtables, SSTs
(`access_layer`) and index sidecars as well.

Field mirrors follow the reference's 32-bit device types: DOUBLE/FLOAT
as float32, BIGINT as int32 when it fits (else float32), and the narrow
integers exactly — int8/int16/uint8/uint16 as int32, uint32 as int32
biased by -2^31 (order-preserving). After the fetch, `_narrow_results`
gives each moment the column's own dtype as the reference does: sums
wrap to it, and uint32 values are un-biased on the host.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import torch

from ..common import exec_stats, failpoint, process_list
from ..common.telemetry import increment_counter, span
from ..errors import DeviceUnavailableError, UnsupportedError
from ..ops.kernels import merge_dedup_numpy, sorted_grouped_aggregate
from ..sql.ast import (
    Between, BinaryOp, Column, Expr, FunctionCall, Interval, Literal, Query,
    UnaryOp,
)
from ..storage.region import ScanProfile
from ..utils import env_flag
from .expr import Evaluator, expr_name
from .functions import SKETCH_AGGREGATES, TPU_AGGREGATES, parse_interval_ms
from .planner import Analysis, _group_slot

failpoint.register("scan_cache_incremental")

_CMP_OPS = {"=": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt",
            ">=": "ge"}


# ---------------------------------------------------------------------------
# merged-scan cache (per region version and device)
# ---------------------------------------------------------------------------

#: integer field dtypes carried exactly as int32 device mirrors
_NARROW_INTS = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.uint8),
                np.dtype(np.uint16))
#: uint32 fields ride as int32 values v - 2^31
_U32_BIAS = 1 << 31


def mirror_values(vals: np.ndarray) -> np.ndarray:
    """A numeric field's host values in its device mirror's dtype, as the
    reference runs with x64 off: float32, int32 for BIGINT that fits,
    the narrow integers exactly as int32 and uint32 as int32 biased by
    -2^31 (the resident mirrors and the streamed slices share this)."""
    v = vals
    if v.dtype in _NARROW_INTS:
        v = v.astype(np.int32)
    elif v.dtype == np.uint32:
        v = (v.astype(np.int64) - _U32_BIAS).astype(np.int32)
    elif v.dtype == np.int64:
        v = v.astype(np.float64) if abs(v).max(initial=0) >= 2**31 \
            else v.astype(np.int32)
    if v.dtype != np.int32:
        v = v.astype(np.float32)
    return v


@dataclass
class MergedScan:
    series_ids: np.ndarray            # int32, sorted
    ts: np.ndarray                    # int64 epoch (region units)
    fields: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]
    series_dict: object
    ts_base: int                      # device ts = ts - ts_base (int32)
    torch_device: torch.device        # where the mirrors live
    seq: Optional[np.ndarray] = None  # per-row sequence (incremental merge)
    #: device mirrors and host run contexts, built at first use (a
    #: streamed slice's arrive staged, query/stream_exec.py)
    mirrors: Dict[str, object] = field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return len(self.ts)

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        dev = self.torch_device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "QueryEngine runs on 'cuda' but CUDA is not available; "
                "construct it with device='cpu' to run on the CPU")
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def host_ts(self) -> np.ndarray:
        """The device ts mirror's values: int32 offsets from ts_base."""
        rel = self.ts - self.ts_base
        if rel.size and (rel.max() >= 2**31 or rel.min() < 0):
            raise UnsupportedError("region time span exceeds int32")
        return rel.astype(np.int32)

    def device_ts(self) -> torch.Tensor:
        if "__ts" not in self.mirrors:
            self.mirrors["__ts"] = self.to_device(self.host_ts())
        return self.mirrors["__ts"]

    def device_field(self, name: str) -> torch.Tensor:
        key = f"f:{name}"
        if key not in self.mirrors:
            vals, _ = self.fields[name]
            if vals.dtype == object:
                raise UnsupportedError(f"field {name} is not numeric")
            self.mirrors[key] = self.to_device(mirror_values(vals))
        return self.mirrors[key]

    def device_field_f32(self, name: str) -> torch.Tensor:
        """float32 mirror of a field's values (a uint32 column's squares
        need its un-biased values)."""
        key = f"f32:{name}"
        if key not in self.mirrors:
            self.mirrors[key] = self.to_device(
                self.fields[name][0].astype(np.float32))
        return self.mirrors[key]

    def device_valid(self, name: str) -> torch.Tensor:
        """A field's validity mask on the device. A field with no null
        row shares the one all-valid mask, so the kernel reads no mask
        of its own for it (a scan that takes in memtable rows carries a
        validity array for every field: write batches build one even
        without nulls)."""
        key = f"v:{name}"
        if key not in self.mirrors:
            _, valid = self.fields[name]
            self.mirrors[key] = self.device_valid_all() \
                if valid is None or valid.all() else self.to_device(valid)
        return self.mirrors[key]

    def device_valid_all(self) -> torch.Tensor:
        if "__all_valid" not in self.mirrors:
            self.mirrors["__all_valid"] = self.to_device(
                np.ones(self.num_rows, dtype=bool))
        return self.mirrors["__all_valid"]

    @property
    def nbytes(self) -> int:
        """Host + device residency of this scan (cache accounting)."""
        total = self.series_ids.nbytes + self.ts.nbytes
        if self.seq is not None:
            total += self.seq.nbytes
        for vals, valid in self.fields.values():
            total += getattr(vals, "nbytes", 8 * len(vals))
            if valid is not None:
                total += valid.nbytes
        seen = set()                  # an all-valid field's mask is shared
        for v in self.mirrors.values():
            for x in (v if isinstance(v, tuple) else (v,)):
                if id(x) in seen:
                    continue
                seen.add(id(x))
                if isinstance(x, torch.Tensor):
                    total += x.numel() * x.element_size()
                else:
                    total += getattr(x, "nbytes", 0)
        return total


@dataclass
class _CacheEntry:
    scan: MergedScan
    visible: int                      # sequences <= visible are merged in
    sst_names: frozenset              # SSTs whose content is merged in
    schema_version: int
    retraction_epoch: int


class _ScanCache:
    """Per-region merged-scan cache: byte-budget LRU + incremental
    maintenance.

    On a version bump the cache merges only the delta — memtable rows
    with sequences beyond the cached watermark plus SSTs that carry such
    rows — into the cached sorted arrays, instead of re-reading and
    re-sorting the whole region; flushes and compactions whose files
    only hold covered sequences reuse the entry as it is. TTL retraction
    (region.retraction_epoch), a schema change and another device force
    a full rebuild. Whole scans evict LRU-first under a byte budget
    (host arrays + device mirrors); the newest entry always stays, even
    when it alone exceeds the budget (regions that large stream instead:
    region_streams_cold)."""

    def __init__(self, capacity: int = 16,
                 budget_bytes: int = 4 << 30):
        from ..common.locks import TrackedLock
        from ..common.tracking import tracked_state
        self.capacity = capacity
        self.budget_bytes = budget_bytes
        self._lock = TrackedLock("query.scan_cache")
        self._entries: Dict[str, _CacheEntry] = tracked_state(
            {}, "query.scan_cache.entries")          # insertion = LRU order
        # per-thread outcome of the most recent get(): "hit" /
        # "incremental" / "full"
        self._last = threading.local()

    def last_outcome(self) -> Optional[str]:
        return getattr(self._last, "outcome", None)

    def get(self, region, device,
            prof: Optional[ScanProfile] = None) -> MergedScan:
        """The region's merged scan on `device`; the reads and the merge
        behind a miss or an incremental merge are marked on `prof`
        (`region_scan`: memtables + SST decode, `merge`)."""
        device = torch.device(device)
        snap = region.snapshot()
        v = snap._version
        visible = snap.visible_sequence
        sst_names = frozenset(f.file_name for f in v.ssts.all_files())
        epoch = getattr(region, "retraction_epoch", 0)
        with self._lock:
            entry = self._entries.pop(region.uid, None)
            if entry is not None:                    # LRU touch
                self._entries[region.uid] = entry
        if entry is not None and entry.schema_version == v.schema.version \
                and entry.retraction_epoch == epoch \
                and entry.scan.torch_device == device \
                and entry.visible <= visible:
            if entry.visible == visible and entry.sst_names == sst_names:
                self._last.outcome = "hit"
                increment_counter("scan_cache_hit")
                return entry.scan
            try:
                failpoint.fail_point("scan_cache_incremental")
                scan = self._incremental(region, v, entry, visible, prof)
                self._last.outcome = "incremental"
                increment_counter("scan_cache_incremental")
            except Exception as e:  # noqa: BLE001 — degrade, don't fail
                # an unusable cached scan must never fail the query: drop
                # the entry and rebuild from storage, counted as a miss
                logging.getLogger(__name__).warning(
                    "scan cache entry for region %s unusable (%s); "
                    "rebuilding cold", region.name, e)
                increment_counter("scan_cache_recovered")
                increment_counter("scan_cache_miss")
                with self._lock:
                    self._entries.pop(region.uid, None)
                self._last.outcome = "full"
                scan = self._full(snap, device, prof)
        else:
            self._last.outcome = "full"
            increment_counter("scan_cache_miss")
            scan = self._full(snap, device, prof)
        entry = _CacheEntry(scan, visible, sst_names, v.schema.version,
                            epoch)
        with self._lock:
            self._entries.pop(region.uid, None)
            self._entries[region.uid] = entry
            self._evict_locked()
        return scan

    def _evict_locked(self) -> None:
        """Drop LRU entries until count and byte budgets hold (whole
        scans only; the most recent entry is never evicted)."""
        while len(self._entries) > max(self.capacity, 1):
            self._entries.pop(next(iter(self._entries)))
        if self.budget_bytes <= 0:
            return
        total = {uid: e.scan.nbytes for uid, e in self._entries.items()}
        used = sum(total.values())
        for uid in list(self._entries):
            if used <= self.budget_bytes or len(self._entries) <= 1:
                break
            self._entries.pop(uid)
            used -= total[uid]

    def cached(self, region) -> bool:
        """Whether this region has a resident entry (any freshness): the
        indexed-point planner prefers a warm cache, and only routes
        around it when the region would be scanned cold."""
        with self._lock:
            return region.uid in self._entries

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.scan.nbytes for e in self._entries.values())

    def configure(self, *, budget_bytes: Optional[int] = None,
                  capacity: Optional[int] = None) -> None:
        with self._lock:
            if budget_bytes is not None:
                self.budget_bytes = int(budget_bytes)
            if capacity is not None:
                self.capacity = int(capacity)
            self._evict_locked()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    @staticmethod
    def _full(snap, device: torch.device,
              prof: Optional[ScanProfile] = None) -> MergedScan:
        t0 = time.perf_counter()
        data = snap.scan()
        t1 = time.perf_counter()
        if data.num_rows:
            kept = merge_dedup_numpy(data.series_ids, data.ts, data.seq,
                                     data.op_types)
            sids = data.series_ids[kept]
            ts = data.ts[kept]
            seq = data.seq[kept]
            fields = {n: (d[kept], vd[kept] if vd is not None else None)
                      for n, (d, vd) in data.fields.items()}
        else:
            sids, ts, seq = data.series_ids, data.ts, data.seq
            fields = data.fields
        base = int(ts.min()) if ts.size else 0
        if prof is not None:
            prof.mark("region_scan", t1 - t0)
            prof.mark("merge", time.perf_counter() - t1)
        return MergedScan(sids.astype(np.int32), ts, fields,
                          data.series_dict, base, device, seq=seq)

    @staticmethod
    def _incremental(region, v, entry: _CacheEntry, visible: int,
                     prof: Optional[ScanProfile] = None) -> MergedScan:
        from ..datatypes.vector import null_column
        t0 = time.perf_counter()
        schema = v.schema
        field_names = [c.name for c in schema.field_columns()]
        lo = entry.visible
        runs = []
        # memtable rows beyond the cached watermark
        for mt in v.memtables.all_memtables():
            ms = mt.snapshot()
            if ms.num_rows == 0:
                continue
            sel = (ms.seq > lo) & (ms.seq <= visible)
            if not sel.any():
                continue
            fields = {}
            for name in field_names:
                if name in ms.fields:
                    d, vd = ms.fields[name]
                    fields[name] = (d[sel],
                                    vd[sel] if vd is not None else None)
                else:
                    fields[name] = null_column(
                        schema.column_schema(name).dtype, int(sel.sum()))
            runs.append((ms.series_ids[sel], ms.ts[sel], ms.seq[sel],
                         ms.op_types[sel], fields))
        # SSTs not yet covered that carry rows beyond the watermark (a
        # fresh flush whose max_sequence <= lo is already in the cache
        # through the memtable: never read)
        for meta in v.ssts.all_files():
            if meta.file_name in entry.sst_names or meta.max_sequence <= lo:
                continue
            sst = region.access_layer.read_sst(meta,
                                               projection=field_names)
            if sst.num_rows == 0:
                continue
            sel = (sst.seq > lo) & (sst.seq <= visible)
            if not sel.any():
                continue
            fields = {n: (d[sel], vd[sel] if vd is not None else None)
                      for n, (d, vd) in sst.fields.items()}
            runs.append((sst.series_ids[sel], sst.ts[sel], sst.seq[sel],
                         sst.op_types[sel], fields))
        t1 = time.perf_counter()
        if prof is not None:
            prof.mark("region_scan", t1 - t0)

        cached = entry.scan
        if not runs:
            return cached
        # sort + dedup the delta alone (small), then splice it into the
        # sorted cached arrays by searchsorted + np.insert: O(delta log +
        # n) copies, no sort over the region
        dsid = np.concatenate([r[0] for r in runs])
        dts = np.concatenate([r[1] for r in runs])
        dseq = np.concatenate([r[2] for r in runs])
        dop = np.concatenate([r[3] for r in runs])
        dorder = np.lexsort((dseq, dts, dsid))
        dsid, dts, dseq, dop = (a[dorder] for a in (dsid, dts, dseq, dop))
        # within-delta dedup: the newest version of each (sid, ts)
        nxt_same = np.concatenate([(dsid[1:] == dsid[:-1]) &
                                   (dts[1:] == dts[:-1]), [False]])
        dkeep0 = ~nxt_same
        dsel = dorder[dkeep0]
        dsid, dts, dseq, dop = (a[dkeep0] for a in (dsid, dts, dseq, dop))

        csid, cts = cached.series_ids, cached.ts
        n_cached = cached.num_rows
        # two-level searchsorted: sid bounds, then ts inside each sid run
        pos = np.empty(len(dsid), dtype=np.int64)
        for s in np.unique(dsid):
            m = dsid == s
            slo = int(np.searchsorted(csid, s, side="left"))
            shi = int(np.searchsorted(csid, s, side="right"))
            pos[m] = slo + np.searchsorted(cts[slo:shi], dts[m], side="left")
        # a delta key that already exists replaces (a put) or deletes the
        # cached row; every delta sequence is newer by construction
        collide = pos < n_cached
        if collide.any():
            pc = np.minimum(pos, n_cached - 1)
            collide &= (csid[pc] == dsid) & (cts[pc] == dts)
        dlive = dop == 0                      # delete tombstones vanish
        ckeep = np.ones(n_cached, dtype=bool)
        ckeep[pos[collide & ~dlive]] = False
        # positions in the kept cached rows: new keys are inserted there,
        # overwritten keys written in place, after the inserts before them
        # (one pass over each column where the reference's splice made two)
        dropped_prefix = np.concatenate([[0], np.cumsum(~ckeep)])
        adj = pos - dropped_prefix[pos]
        ins = dlive & ~collide
        rep = dlive & collide
        ipos = adj[ins]
        rpos = adj[rep] + np.searchsorted(ipos, adj[rep], side="right")
        all_kept = bool(ckeep.all())

        def splice(c: np.ndarray, d: np.ndarray) -> np.ndarray:
            out = np.insert(c if all_kept else c[ckeep], ipos, d[ins])
            out[rpos] = d[rep]
            return out

        sids = splice(csid, dsid).astype(np.int32)
        ts = splice(cts, dts)
        seq = splice(cached.seq if cached.seq is not None
                     else np.zeros(n_cached, np.int64), dseq)
        fields = {}
        for name in field_names:
            cd, cv = cached.fields[name]
            dd = np.concatenate([r[4][name][0] for r in runs])[dsel]
            dvs = [r[4][name][1] for r in runs]
            valid = None
            if cv is not None or any(x is not None for x in dvs):
                dv = np.concatenate([
                    x if x is not None else np.ones(len(r[4][name][0]),
                                                    dtype=bool)
                    for x, r in zip(dvs, runs)])[dsel]
                valid = splice(cv if cv is not None
                               else np.ones(n_cached, bool), dv)
            fields[name] = (splice(cd, dd), valid)
        if prof is not None:
            prof.mark("merge", time.perf_counter() - t1)
        base = int(ts.min()) if ts.size else 0
        return MergedScan(sids, ts, fields, cached.series_dict, base,
                          cached.torch_device, seq=seq)


SCAN_CACHE = _ScanCache()


# ---------------------------------------------------------------------------
# concurrent scan fusion: single-flight over identical resident scans
# ---------------------------------------------------------------------------

#: SET scan_fusion toggles; single-slot swap (no lock needed for a read)
_FUSION_ENABLED = [env_flag("GREPTIME_SCAN_FUSION", True)]
#: bounded park for a follower on the leader's pass: a dead leader
#: degrades to a solo scan, never a hang
_FUSION_WAIT_TIMEOUT_S = 30.0


def configure_scan_fusion(*, enabled: Optional[bool] = None) -> None:
    if enabled is not None:
        _FUSION_ENABLED[0] = bool(enabled)


class _FlightEntry:
    """One in-flight region reduction shared by its cohort."""

    __slots__ = ("done", "frame", "failed")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.frame: Optional[pd.DataFrame] = None
        self.failed = False


class _ScanFlightMap:
    """Single-flight map keyed on (region identity, visible data state,
    plan fingerprint): concurrent identical-shape scans of the same
    region fuse into one shared pass — the leader reduces, the cohort
    adopts its moment frame. The data-state part of the key (committed
    sequence + retraction epoch, sampled at request start) keeps
    read-your-writes: a scan that begins after a write is acked never
    fuses onto a pass that predates the write."""

    def __init__(self) -> None:
        from ..common.locks import TrackedLock
        from ..common.tracking import tracked_state
        self._lock = TrackedLock("query.scan_fusion")
        self._inflight: Dict[tuple, _FlightEntry] = tracked_state(
            {}, "query.scan_fusion.inflight")

    def execute(self, region, table, plan: "TpuPlan", device):
        if not _FUSION_ENABLED[0]:
            # checked BEFORE fingerprinting: the opt-out must not pay the
            # plan serialization on every region of every scan
            return _execute_region(region, table, plan, device)
        key = self._key(region, plan)
        if key is None:
            return _execute_region(region, table, plan, device)
        with self._lock:
            entry = self._inflight.get(key)
            leader = entry is None
            if leader:
                entry = _FlightEntry()
                self._inflight[key] = entry
        if leader:
            try:
                entry.frame = _execute_region(region, table, plan, device)
            except BaseException:
                # the cohort falls back to solo scans: the leader's
                # failure may be its own (a KILL on its statement)
                entry.failed = True
                raise
            finally:
                entry.done.set()
                with self._lock:
                    self._inflight.pop(key, None)
            increment_counter("scan_fusion_leader")
            return entry.frame
        # follower: bounded park on the leader's shared pass
        t0 = time.perf_counter()
        deadline = time.monotonic() + _FUSION_WAIT_TIMEOUT_S
        while not entry.done.wait(timeout=0.05):
            process_list.check_cancelled()    # killed mid-wait: bail out
            if time.monotonic() > deadline:
                break
        if not entry.done.is_set() or entry.failed:
            return _execute_region(region, table, plan, device)
        increment_counter("scan_fusion_follower")
        exec_stats.record(
            "fused-follower",
            rows=0 if entry.frame is None else len(entry.frame),
            elapsed_s=time.perf_counter() - t0, region=region.name)
        # a copy: the cohort's downstream folds never share mutable frames
        return None if entry.frame is None else entry.frame.copy()

    @staticmethod
    def _key(region, plan: "TpuPlan") -> Optional[tuple]:
        vc = getattr(region, "version_control", None)
        if vc is None:
            return None
        # fingerprint once per plan object, not once per region
        fp = getattr(plan, "_fusion_fp", None)
        if fp is None:
            try:
                from .plan_codec import plan_to_dict
                fp = json.dumps(plan_to_dict(plan), sort_keys=True,
                                default=str)
            except Exception:  # noqa: BLE001 — unshippable: no fusion
                increment_counter("scan_fusion_unfingerprintable")
                fp = False
            plan._fusion_fp = fp
        if fp is False:
            return None
        return (region.uid, vc.committed_sequence,
                getattr(region, "retraction_epoch", 0), fp)


SCAN_FLIGHTS = _ScanFlightMap()


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclass
class TagGroup:
    name: str                         # tag column name
    tag_index: int


@dataclass
class BucketGroup:
    stride_ms: int
    origin: int
    expr_key: str                     # expr_name of the bucket expression


@dataclass
class FieldFilter:
    column: str
    op: str                           # eq/ne/lt/le/gt/ge
    value: float


@dataclass
class Moment:
    op: str                           # kernel op
    column: Optional[str]             # field name; None = row count
    slot: str


#: moment ops whose per-run partial is an encoded sketch (bytes), not a
#: number — built on the host, merged by _finalize through the codec
SKETCH_MOMENT_OPS = frozenset({"distinct", "tdigest"})

#: numeric moment ops only the host reducer implements (no device
#: kernel): `reset_corr` is PromQL's counter-reset correction — the sum
#: of the pre-reset value over adjacent valid sample pairs within a run
#: where the later sample is smaller (ops/window.py rate kernel:
#: `where(pair_ok & (val < prev), prev, 0)`), so
#: increase = last - first + reset_corr folds like any other moment
HOST_ONLY_MOMENT_OPS = frozenset({"reset_corr"})


@dataclass
class TpuPlan:
    tag_groups: List[TagGroup]
    bucket: Optional[BucketGroup]
    moments: List[Moment]
    finals: List[Tuple[str, str, List[str]]]  # (slot, final op, moment slots)
    time_lo: Optional[int]
    time_hi: Optional[int]
    tag_predicates: List[Expr]
    field_filters: List[FieldFilter]
    #: arithmetic agg-arg expressions keyed by their moment "column"
    #: name (expr_name): `sum(a*b)` moments over a virtual column that
    #: each region evaluates from its stored fields before momenting
    field_exprs: Dict[str, Expr] = field(default_factory=dict)
    #: literal extras per final slot (approx_percentile's p)
    agg_params: Dict[str, tuple] = field(default_factory=dict)

    def describe(self) -> str:
        gs = [t.name for t in self.tag_groups]
        if self.bucket:
            gs.append(f"time_bucket({self.bucket.stride_ms}ms)")
        ops = [f"{op}" for _, op, _ in self.finals]
        return f"groups=[{', '.join(gs)}] aggs=[{', '.join(ops)}]"


def plan_needs_host(plan: "TpuPlan") -> bool:
    """Whether this plan's moments must reduce on the host: sketch
    partials (distinct/t-digest have no device kernel) and virtual
    expression columns both do. The partial-frame ALGEBRA is unchanged —
    host partials fold exactly like device partials."""
    return bool(plan.field_exprs) or \
        any(m.op in SKETCH_MOMENT_OPS or m.op in HOST_ONLY_MOMENT_OPS
            for m in plan.moments)


def plan_scan_columns(plan: "TpuPlan", schema) -> List[str]:
    """Base STORED columns a region scan must project for this plan:
    plain moment columns plus every field a virtual expression column
    references (tags ride the series ids, never the projection)."""
    tag_names = set(schema.tag_names())
    cols: set = set()
    for m in plan.moments:
        if m.column is None:
            continue
        if m.column in plan.field_exprs:
            cols |= _refs(plan.field_exprs[m.column])
        elif m.column not in tag_names:
            cols.add(m.column)
    cols |= {ff.column for ff in plan.field_filters}
    return sorted(cols)


def moment_input(m: Moment, plan: TpuPlan, fields: Dict, sids, ts, sd,
                 cache: Optional[dict] = None):
    """(values, validity) for one moment's input: a stored field, the
    time index, a tag column (decoded per row), or a registered
    arithmetic expression evaluated over the stored fields — the ONE
    resolution both host reducers share, so streamed, resident and
    indexed partials cannot disagree about what `sum(a*b)` means."""
    col = m.column
    if cache is not None and col in cache:
        return cache[col]
    if col in plan.field_exprs:
        base = {}
        for name in sorted(_refs(plan.field_exprs[col])):
            d, vd = fields[name]
            if d.dtype == object:
                raise UnsupportedError(
                    f"expression aggregate over non-numeric {name!r}")
            arr = d.astype(np.float64, copy=vd is not None)
            if vd is not None:
                arr[~vd] = np.nan        # pandas null convention, so the
            base[name] = arr             # expr semantics == the fallback
        ev = Evaluator(pd.DataFrame(base))
        v = ev.eval(plan.field_exprs[col])
        vals = v.to_numpy(dtype=np.float64) if isinstance(v, pd.Series) \
            else np.asarray(v, dtype=np.float64)
        if vals.ndim == 0:
            vals = np.full(len(ts), float(vals))
        valid = ~np.isnan(vals)
        out = (vals, None if valid.all() else valid)
    elif col in fields:
        out = fields[col]
    elif sd is not None and col in tuple(getattr(sd, "tag_names", ())):
        idx = tuple(sd.tag_names).index(col)
        out = (sd.decode_tag_column(np.asarray(sids, dtype=np.int32),
                                    idx), None)
    else:
        out = (ts, None)                 # the time index
    if cache is not None:
        cache[col] = out
    return out


def sketch_run_column(op: str, vals: np.ndarray,
                      valid: Optional[np.ndarray],
                      starts: np.ndarray, n: int) -> np.ndarray:
    """Encoded sketch partial per run: object column of codec frames,
    one per (sid [, bucket]) run — the sketch twin of a reduceat."""
    from .sketches import DistinctSketch, TDigest, encode_sketch
    ends = np.append(starts[1:], n)
    out = np.empty(len(starts), dtype=object)
    for i in range(len(starts)):
        seg = slice(int(starts[i]), int(ends[i]))
        v = vals[seg]
        if valid is not None:
            v = v[valid[seg]]
        if op == "distinct":
            sk = DistinctSketch.from_values(v)
        else:
            sk = TDigest.from_values(np.asarray(v, dtype=np.float64)) \
                if v.dtype != object else TDigest.from_values(
                    np.asarray(list(v), dtype=np.float64))
        out[i] = encode_sketch(sk)
    return out


def _conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, BinaryOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _refs(e: Expr) -> set:
    from .planner import _walk_columns
    out: set = set()
    _walk_columns(e, out)
    return out


def _literal_num(e: Expr):
    if isinstance(e, Literal) and isinstance(e.value, (int, float)) and \
            not isinstance(e.value, bool):
        return e.value
    if isinstance(e, UnaryOp) and e.op == "-":
        v = _literal_num(e.operand)
        return -v if v is not None else None
    return None


_ARITH_OPS = frozenset({"+", "-", "*", "/"})


def _is_expr_arg(e: Expr, field_names: set, schema) -> bool:
    """Arithmetic over numeric FIELD columns and numeric literals, with
    at least one operator — the agg-argument shapes each region can
    evaluate into a virtual moment column (`sum(a*b)`, `avg(a/b)`)."""
    if not isinstance(e, (BinaryOp, UnaryOp)):
        return False

    def ok(x: Expr) -> bool:
        if isinstance(x, Column):
            if x.name not in field_names:
                return False
            cs = schema.column_schema(x.name)
            return not (cs.dtype.is_string or cs.dtype.is_binary)
        if isinstance(x, Literal):
            return isinstance(x.value, (int, float)) and \
                not isinstance(x.value, bool)
        if isinstance(x, UnaryOp):
            return x.op == "-" and ok(x.operand)
        if isinstance(x, BinaryOp):
            return x.op in _ARITH_OPS and ok(x.left) and ok(x.right)
        return False

    return ok(e)


def standard_final(op: str, col: Optional[str], moment):
    """(final op, moment slots) for one standard aggregate through the
    `moment(op, column) -> slot` dedupe closure — the one op→moment
    mapping SQL planning (plan_for) and explicit specs (ir.plan_from_specs)
    share. A count moment rides along with sum/min/max so empty groups
    finalize to NULL, not 0."""
    if op == "count":
        return "count", [moment("count", col)]
    if op in ("sum", "avg"):
        return op, [moment("sum", col), moment("count", col)]
    if op in ("min", "max"):
        return op, [moment(op, col), moment("count", col)]
    if op in ("stddev", "variance"):
        return op, [moment("sum", col), moment("sum_sq", col),
                    moment("count", col)]
    if op in ("first", "last"):
        mts = moment("min_ts" if op == "first" else "max_ts", col)
        return op, [moment(op, col), mts]
    return None


def plan_for(table, a: Analysis, query: Query) -> Optional[TpuPlan]:
    """Return a TpuPlan if (table, query) fits the fast-path shape."""
    if table is None or not a.is_aggregate or query.joins:
        return None
    if a.window_calls:
        # window slots evaluate on the post-aggregate frame in the
        # fallback engine (query/window.py); the device plan has no
        # WindowAggExec analogue
        return None
    if not hasattr(table, "regions"):
        return None  # only region-backed tables have the SoA path
    schema = table.schema
    tc = schema.timestamp_column
    tag_names = schema.tag_names()
    field_names = set(schema.field_names())

    # group exprs: tags and at most one time bucket
    tag_groups: List[TagGroup] = []
    bucket: Optional[BucketGroup] = None
    for g in a.group_exprs:
        if isinstance(g, Column) and g.name in tag_names:
            tag_groups.append(TagGroup(g.name, tag_names.index(g.name)))
            continue
        b = _match_bucket(g, tc.name if tc else None)
        if b is not None and bucket is None:
            bucket = b
            continue
        return None

    # aggregates → moments
    from .sketches import exact_distinct_forced
    is_pushdown = hasattr(table, "execute_tpu_plan")
    if is_pushdown and not _PARTIAL_PUSHDOWN[0]:
        # SET dist_partial_agg = 0: no pushdown plan at all, so EXPLAIN
        # (CpuAggregateExec) and execution (raw-row scatter + CPU
        # fallback) render the same decision
        return None
    moments: List[Moment] = []
    finals: List[Tuple[str, str, List[str]]] = []
    field_exprs: Dict[str, Expr] = {}
    agg_params: Dict[str, tuple] = {}
    seen: Dict[tuple, str] = {}

    def moment(op: str, column: Optional[str]) -> str:
        k = (op, column)
        if k in seen:
            return seen[k]
        slot = f"__m{len(moments)}"
        moments.append(Moment(op, column, slot))
        seen[k] = slot
        return slot

    for call in a.agg_calls:
        op = call.op
        if op not in TPU_AGGREGATES and op not in SKETCH_AGGREGATES:
            return None
        if call.distinct and (op != "count" or not is_pushdown or
                              exact_distinct_forced()):
            # distinct rides the sketch partial only where it pays — the
            # distributed pushdown (a standalone table keeps the exact
            # fallback), and never under SET exact_distinct = 1
            return None
        if call.arg is None:
            if op != "count" or call.distinct:
                return None
            finals.append((call.slot, "count", [moment("count", None)]))
            continue
        # distinct sketches take any value type (sets of strings are
        # sets); everything else needs numbers
        sketchy = call.distinct or op == "approx_distinct"
        if isinstance(call.arg, Column):
            col = call.arg.name
            if col == (tc.name if tc else None):
                pass                            # the time index
            elif col in field_names:
                cs = schema.column_schema(col)
                if (cs.dtype.is_string or cs.dtype.is_binary) and \
                        op != "count" and not sketchy:
                    return None
            elif col in tag_names and sketchy:
                pass          # distinct over a tag: decoded per series
            else:
                return None
        else:
            if not _is_expr_arg(call.arg, field_names, schema):
                return None
            col = expr_name(call.arg)
            field_exprs[col] = call.arg
        if call.distinct:                       # count(DISTINCT x)
            finals.append((call.slot, "count_distinct",
                           [moment("distinct", col)]))
            continue
        if op == "approx_distinct":
            finals.append((call.slot, "approx_distinct",
                           [moment("distinct", col)]))
            continue
        if op in ("approx_percentile", "median"):
            if op == "approx_percentile":
                if len(call.params) != 1 or \
                        not isinstance(call.params[0], (int, float)) or \
                        isinstance(call.params[0], bool) or \
                        not 0 <= float(call.params[0]) <= 100:
                    return None     # the fallback raises the typed error
                p = float(call.params[0])
            else:
                p = 50.0
            finals.append((call.slot, "approx_percentile",
                           [moment("tdigest", col)]))
            agg_params[call.slot] = (p,)
            continue
        std = standard_final(op, col, moment)
        if std is None:
            return None
        finals.append((call.slot, std[0], std[1]))

    # WHERE decomposition
    time_lo = time_hi = None
    tag_predicates: List[Expr] = []
    field_filters: List[FieldFilter] = []
    for c in _conjuncts(query.where):
        refs = _refs(c)
        if refs and refs <= set(tag_names):
            tag_predicates.append(c)
            continue
        if tc is not None and refs == {tc.name}:
            rng = _match_time_pred(c, tc.name)
            if rng is None:
                return None
            lo, hi = rng
            if lo is not None:
                time_lo = lo if time_lo is None else max(time_lo, lo)
            if hi is not None:
                time_hi = hi if time_hi is None else min(time_hi, hi)
            continue
        ff = _match_field_pred(c, field_names)
        if ff is None:
            return None
        field_filters.append(ff)

    return TpuPlan(tag_groups, bucket, moments, finals, time_lo, time_hi,
                   tag_predicates, field_filters, field_exprs, agg_params)


def _match_bucket(e: Expr, ts_name: Optional[str]) -> Optional[BucketGroup]:
    """date_bin(INTERVAL, ts [, origin]) / date_trunc('unit', ts)."""
    if ts_name is None or not isinstance(e, FunctionCall):
        return None
    if e.name == "date_bin" and len(e.args) >= 2:
        stride = None
        if isinstance(e.args[0], Interval):
            stride = parse_interval_ms(e.args[0].text)
        elif _literal_num(e.args[0]) is not None:
            stride = int(_literal_num(e.args[0]))
        if stride is None or stride <= 0:
            return None
        if not (isinstance(e.args[1], Column) and e.args[1].name == ts_name):
            return None
        origin = 0
        if len(e.args) >= 3:
            o = _literal_num(e.args[2])
            if o is None:
                return None
            origin = int(o)
        return BucketGroup(stride, origin, expr_name(e))
    if e.name == "date_trunc" and len(e.args) == 2:
        from .functions import _TRUNC_MS, _WEEK_ORIGIN_MS
        if not isinstance(e.args[0], Literal):
            return None
        unit = str(e.args[0].value).lower()
        if unit not in _TRUNC_MS:
            return None
        if not (isinstance(e.args[1], Column) and e.args[1].name == ts_name):
            return None
        origin = _WEEK_ORIGIN_MS if unit == "week" else 0
        return BucketGroup(_TRUNC_MS[unit], origin, expr_name(e))
    return None


def _match_time_pred(e: Expr, ts_name: str):
    import math as _math
    if isinstance(e, Between):
        lo, hi = _literal_num(e.low), _literal_num(e.high)
        if e.negated or lo is None or hi is None:
            return None
        # inclusive range: directional rounding for fractional bounds
        return _math.ceil(lo), _math.floor(hi) + 1
    if not isinstance(e, BinaryOp):
        return None
    op = e.op
    if isinstance(e.left, Column) and e.left.name == ts_name:
        v = _literal_num(e.right)
    elif isinstance(e.right, Column) and e.right.name == ts_name:
        v = _literal_num(e.left)
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    else:
        return None
    if v is None:
        return None
    # timestamps are integral: round fractional bounds toward the predicate
    if op == "<":
        return None, _math.ceil(v)          # ts < 10.5 ≡ ts < 11
    if op == "<=":
        return None, _math.floor(v) + 1
    if op == ">":
        return _math.floor(v) + 1, None     # ts > 10.5 ≡ ts >= 11
    if op == ">=":
        return _math.ceil(v), None
    if op == "=":
        if v != int(v):
            return 0, 0                     # fractional equality: empty
        return int(v), int(v) + 1
    return None


def _match_field_pred(e: Expr, field_names: set) -> Optional[FieldFilter]:
    if not isinstance(e, BinaryOp) or e.op not in _CMP_OPS:
        return None
    if isinstance(e.left, Column) and e.left.name in field_names:
        v = _literal_num(e.right)
        if v is None:
            return None
        return FieldFilter(e.left.name, _CMP_OPS[e.op], float(v))
    if isinstance(e.right, Column) and e.right.name in field_names:
        v = _literal_num(e.left)
        if v is None:
            return None
        op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(
            _CMP_OPS[e.op], _CMP_OPS[e.op])
        return FieldFilter(e.right.name, op, float(v))
    return None


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

#: Below this many estimated rows the CPU columnar path wins: a device
#: query's fixed cost dominates, and the host path keeps float64 precision
#: for DOUBLE columns, which the float32 device mirrors cannot.
TPU_DISPATCH_MIN_ROWS = 131072

#: assumed CPU columnar throughput for break-even estimation
_CPU_ROWS_PER_SEC = 15e6
#: fastest observed device-path query (seconds) — a lower bound on the
#: per-query fixed cost (dispatch chain + transfers + result fetch)
_observed_min_dt = [None]


def _dispatch_min_rows() -> int:
    """Latency-adaptive dispatch floor: the static floor, raised to the
    rows the CPU path would handle in the fastest device-path query seen
    in this process."""
    dt = _observed_min_dt[0]
    if dt is None:
        return TPU_DISPATCH_MIN_ROWS
    return max(TPU_DISPATCH_MIN_ROWS, int(dt * _CPU_ROWS_PER_SEC))


def _note_device_query_time(dt: float) -> None:
    # cap what one observation may contribute: a cold query includes the
    # kernel build and the scan build, and an uncapped floor would route
    # every later mid-size query to the CPU path
    dt = min(dt, 0.5)
    cur = _observed_min_dt[0]
    if cur is None or dt < cur:
        _observed_min_dt[0] = dt


def _estimated_table_rows(table) -> Optional[int]:
    """Cheap upper-bound row estimate from memtable counters + SST metas —
    no SST reads, no merged-scan build."""
    regions = getattr(table, "regions", None)
    if not regions:
        return None
    total = 0
    for region in regions.values():
        vc = getattr(region, "version_control", None)
        if vc is None:
            return None
        v = vc.current
        for mt in v.memtables.all_memtables():
            total += mt.num_rows
        for meta in v.ssts.all_files():
            total += meta.num_rows
    return total


def cached_table_frame(table, device) -> Optional[pd.DataFrame]:
    """Columnar pandas frame for the CPU fallback, memoized per region
    version on the merged-scan cache. Nulls follow the fallback's frame
    conventions: NaN for numerics, None for objects."""
    regions = getattr(table, "regions", None)
    if not regions:
        return None
    schema = table.schema
    ts_name = schema.timestamp_column.name \
        if schema.timestamp_column is not None else None
    frames = []
    for region in regions.values():
        scan = SCAN_CACHE.get(region, device)
        df = scan.mirrors.get("__host_df")
        if df is None:
            cols = {}
            sd = scan.series_dict
            for i, tag in enumerate(sd.tag_names):
                cols[tag] = sd.decode_tag_column(scan.series_ids, i)
            if ts_name is not None:
                cols[ts_name] = scan.ts
            for name, (vals, valid) in scan.fields.items():
                if valid is None:
                    cols[name] = vals
                elif vals.dtype == object:
                    arr = vals.copy()
                    arr[~valid] = None
                    cols[name] = arr
                else:
                    arr = vals.astype(np.float64)
                    arr[~valid] = np.nan
                    cols[name] = arr
            df = pd.DataFrame({n: cols[n] for n in schema.names()
                               if n in cols})
            scan.mirrors["__host_df"] = df
        frames.append(df)
    if not frames:
        return pd.DataFrame()
    return frames[0] if len(frames) == 1 else \
        pd.concat(frames, ignore_index=True)


#: SET dist_partial_agg — kill switch for the distributed partial
#: pushdown: 0 routes aggregate statements over DistTables through the
#: raw-row scatter instead (the differential and an operator's escape
#: hatch)
_PARTIAL_PUSHDOWN = [env_flag("GREPTIME_DIST_PARTIAL_AGG", True)]


def configure_partial_pushdown(*, enabled: Optional[bool] = None) -> None:
    if enabled is not None:
        _PARTIAL_PUSHDOWN[0] = bool(enabled)


def try_execute(table, a: Analysis, query: Query,
                device) -> Optional[pd.DataFrame]:
    plan = plan_for(table, a, query)
    if plan is None:
        return None
    if not hasattr(table, "execute_tpu_plan"):
        # distributed tables always push down (the fallback would pull
        # raw rows over the wire); local tables route small scans to the
        # CPU columnar path, which is faster and float64-exact
        est = _estimated_table_rows(table)
        if est is not None and est < _dispatch_min_rows():
            exec_stats.set_dispatch(
                f"cpu-small-scan (est_rows={est} < "
                f"dispatch_floor={_dispatch_min_rows()})")
            return None
    from .ir import execute_agg_plan
    try:
        return execute_agg_plan(table, plan, device)
    except UnsupportedError:
        return None


#: finals whose result comes out of a sketch partial, not a numeric fold
_SKETCH_FINAL_OPS = frozenset({"count_distinct", "approx_distinct",
                               "approx_percentile"})


def _aggs_desc(plan: TpuPlan) -> str:
    """sketch-vs-exact per aggregate, for the finalize stage detail."""
    return ",".join(
        f"{op}:{'sketch' if op in _SKETCH_FINAL_OPS else 'exact'}"
        for _, op, _ in plan.finals)


def frames_nbytes(frames) -> int:
    """Byte size of partial moment frames — numeric columns by their
    array width, sketch columns by their encoded frame lengths (EXPLAIN
    ANALYZE's partial_bytes; what a datanode would ship)."""
    total = 0
    for f in frames:
        for col in f.columns:
            s = f[col]
            if s.dtype == object:
                total += int(sum(
                    len(v) if isinstance(v, (bytes, bytearray, str))
                    else 8 for v in s))
            else:
                total += int(s.to_numpy().nbytes)
    return total


def dispatch_decision_for_pushdown(table, plan) -> str:
    """The one aggregate-pushdown dispatch string EXPLAIN (query/engine)
    and execution (try_execute) both print. DistTable exposes
    scatter_describe (regions pruned a/b, fan-out=k); other pushdown
    tables get the generic line."""
    describe = getattr(table, "scatter_describe", None)
    if describe is not None:
        try:
            return describe(plan)
        except Exception:  # noqa: BLE001 — describing must never fail a
            # query; fall through to the generic dispatch line
            increment_counter("explain_describe_errors")
    return "aggregate-pushdown (datanodes reduce, frontend folds)"


def local_dispatch_decision(table, regions=None, cold=None,
                            point_sids=None, plan=None) -> str:
    """The resident / streamed / indexed-point / mixed decision string
    for a local region-backed table — the ONE source both EXPLAIN
    (query/engine.py) and execution (region_moment_frames → ExecStats)
    print, so the two views cannot drift. `cold` lets a caller that
    already evaluated region_streams_cold per region pass the answers
    in; `regions` the (possibly pruned) region list those answers
    correspond to; `plan` (or a pre-computed `point_sids` vector) routes
    point/IN tag queries through the SST secondary index."""
    from . import stream_exec
    if regions is None:
        regions = list(table.regions.values())
    if point_sids is None:
        point_sids = [region_point_sids(r, plan) for r in regions] \
            if plan is not None else [None] * len(regions)
    # sketch / expression moments reduce on the host wherever the rows
    # come from — the suffix keeps EXPLAIN honest about the kernel
    suffix = "; host-partial moments (sketch/expr)" \
        if plan is not None and plan_needs_host(plan) else ""
    n_idx = sum(1 for s in point_sids if s is not None)
    if regions and n_idx == len(regions):
        k = max((len(s) for s in point_sids if s is not None), default=0)
        return (f"indexed-point (sst index, {k} candidate series; "
                f"bloom/sid-summary file pruning{suffix})")
    if cold is None:
        cold = [region_streams_cold(r) for r in regions]
    n_stream = sum(1 for c, s in zip(cold, point_sids)
                   if c and s is None)
    if n_idx:
        return (f"mixed ({n_idx}/{len(regions)} regions indexed-point, "
                f"{n_stream} streamed-cold{suffix})")
    if n_stream == 0:
        return f"device-resident (scan cache{suffix})"
    if n_stream == len(regions):
        return (f"streamed-cold (est_rows={_estimated_table_rows(table)}, "
                f"stream_threshold_rows="
                f"{stream_exec.stream_threshold_rows()}{suffix})")
    return (f"mixed ({n_stream}/{len(regions)} regions "
            f"streamed-cold{suffix})")


def region_point_sids(region, plan) -> Optional[np.ndarray]:
    """Sorted candidate series ids for an indexed point/IN scan of this
    region, or None when the resident/streamed paths win.

    Eligible when the plan carries a point (`tag = lit`) or `IN` tag
    conjunct, the sid set is selective (at most max(64, S/16) of the
    region's S series), the index tier is enabled, and the region is not
    already in the scan cache (a warm cache beats any IO). The set is a
    superset: the host reduction re-applies every tag predicate."""
    from ..storage.index import sst_index_enabled
    if plan is None or not plan.tag_predicates or not sst_index_enabled():
        return None
    sd = getattr(region, "series_dict", None)
    if sd is None or not sd.tag_names:
        return None
    from ..mito.engine import sid_candidates_for_filters
    sids = sid_candidates_for_filters(sd, sd.tag_names,
                                      plan.tag_predicates)
    if sids is None:
        return None
    S = sd.num_series
    if S and len(sids) > max(64, S // 16):
        return None                       # not selective: scan normally
    if SCAN_CACHE.cached(region):
        return None
    return sids


def _indexed_point_frames(region, plan: TpuPlan,
                          sids: np.ndarray) -> List[pd.DataFrame]:
    """Partial moment frames of one region through the SST index: scan
    only the files and row groups that may hold the candidate series
    (RegionSnapshot.scan's sid_set), merge-dedup the surviving rows
    (exact MVCC) and reduce them on the host with the streamed path's
    segment arithmetic, so _finalize folds them like any others. Never
    touches the scan cache: a point query on a cold region neither pays
    for nor pins the whole region."""
    from ..common.time import TimestampRange
    from . import stream_exec

    prof = ScanProfile(path="indexed-point")
    t0 = time.perf_counter()
    snap = region.snapshot()
    schema = snap.schema
    tc = schema.timestamp_column
    trange = None
    if tc is not None and (plan.time_lo is not None or
                           plan.time_hi is not None):
        trange = TimestampRange(plan.time_lo, plan.time_hi,
                                tc.dtype.time_unit)
    data = snap.scan(projection=plan_scan_columns(plan, schema),
                     time_range=trange, sid_set=sids)
    prof.rows = data.num_rows
    prof.bump("candidate_sids", len(sids))
    prof.mark("scan", time.perf_counter() - t0)
    frames: List[pd.DataFrame] = []
    if data.num_rows:
        t1 = time.perf_counter()
        kept = stream_exec._slice_dedup(data)
        frame = stream_exec._host_partial_frame(data, kept, plan,
                                                region.series_dict)
        prof.mark("reduce", time.perf_counter() - t1)
        exec_stats.record("reduce", rows=data.num_rows,
                          elapsed_s=prof.stages["reduce"])
        if frame is not None and len(frame):
            frames.append(frame)
    prof.total_s = time.perf_counter() - t0
    region.last_scan_profile = prof
    return frames


def region_streams_cold(region) -> bool:
    """Whether a region takes the streamed-cold path instead of the
    scan cache: more rows than the streaming threshold, or more
    estimated decoded bytes than half the cache budget (a wide region
    busts residency long before the row threshold; the budget never
    evicts the newest entry, so admission is the only guard)."""
    from . import stream_exec
    return stream_exec.region_estimated_rows(region) > \
        stream_exec.stream_threshold_rows() or \
        (SCAN_CACHE.budget_bytes > 0 and
         stream_exec.region_estimated_bytes(region) >
         SCAN_CACHE.budget_bytes // 2)


def region_moment_frames(table, plan: TpuPlan, device,
                         regions: Optional[Sequence[int]] = None
                         ) -> List[pd.DataFrame]:
    """Per-region moment frames of a table's regions (the single-node
    path and a datanode's side of aggregate pushdown). `regions`
    restricts them to a subset of hosted region numbers (the frontend's
    regions left after partition pruning); a region this node does not
    host raises StaleRouteError. Each region takes one path: a selective
    point/IN query on an uncached region the SST index
    (_indexed_point_frames), a region above the streaming bounds the
    sliced cold scan (query/stream_exec.py; it never enters the cache),
    any other the device-resident scan cache, with identical concurrent
    scans fused (SCAN_FLIGHTS). KILL is checked between regions."""
    from . import stream_exec
    if regions is None:
        regions = list(table.regions.values())
    else:
        want = set(regions)
        missing = want - set(table.regions)
        if missing:
            # a pruned aggregate naming regions this node no longer hosts
            # must not silently reduce a partial set: typed, so the
            # caller refreshes its route and retries
            from ..errors import StaleRouteError
            raise StaleRouteError(
                f"region(s) {sorted(missing)} of table "
                f"{table.info.name} are not hosted here")
        regions = [r for rn, r in table.regions.items() if rn in want]
    if not regions:
        return []
    point_sids = [region_point_sids(r, plan) for r in regions]
    cold = [False if s is not None else region_streams_cold(r)
            for r, s in zip(regions, point_sids)]
    exec_stats.set_dispatch(local_dispatch_decision(
        table, regions, cold, point_sids, plan))
    frames = []
    for region, streams, sids in zip(regions, cold, point_sids):
        process_list.check_cancelled()     # per-region batch boundary
        if sids is not None:
            frames.extend(_indexed_point_frames(region, plan, sids))
            continue
        if streams:
            frames.extend(stream_exec.stream_region_moment_frames(
                region, plan, device))
            continue
        part = SCAN_FLIGHTS.execute(region, table, plan, device)
        if part is not None and len(part):
            frames.append(part)
    return frames


def _execute_region(region, table, plan: TpuPlan,
                    device) -> Optional[pd.DataFrame]:
    prof = ScanProfile(path="resident")
    t0 = time.perf_counter()
    with span("region_scan", region=region.name, path="resident"):
        scan = SCAN_CACHE.get(region, device, prof)
        prep = time.perf_counter() - t0
        prof.mark("scan_prep", prep)
        outcome = SCAN_CACHE.last_outcome() or "full"
        prof.bump(f"cache_{outcome}")
        prof.rows = scan.num_rows
        exec_stats.record("scan_prep", rows=scan.num_rows, elapsed_s=prep,
                          cache=outcome)
        out = None
        if scan.num_rows:
            t1 = time.perf_counter()
            out = _moment_frame_for_scan(scan, table.schema, plan, prof)
            exec_stats.record("reduce", rows=scan.num_rows,
                              elapsed_s=time.perf_counter() - t1)
        prof.total_s = time.perf_counter() - t0
        region.last_scan_profile = prof
    return out


@dataclass
class _Launched:
    """An in-flight device reduction: device results + host fold context."""
    results: tuple                    # device tensors, one per moment,
    #                                   then the extra column counts
    counts: torch.Tensor              # device int32 [nruns]
    nruns: int
    run_sids: np.ndarray              # per-run series id [nruns]
    run_buckets: Optional[np.ndarray]
    series_dict: object
    ts_base: int
    #: per plan moment: None, or (the column's narrow dtype, the index in
    #: `results` of the column's count, or None)
    narrow: list


def _moment_frame_for_scan(scan: MergedScan, schema, plan: TpuPlan,
                           prof: ScanProfile) -> Optional[pd.DataFrame]:
    if plan_needs_host(plan):
        # sketch / expression moments: reduce the resident merged scan
        # on the host with the streamed path's segment arithmetic (its
        # rows are already sorted and MVCC-deduped), so the partial
        # frame folds like any other
        from .stream_exec import _host_partial_frame
        t0 = time.perf_counter()
        out = _host_partial_frame(scan, None, plan, scan.series_dict)
        prof.mark("host_reduce", time.perf_counter() - t0)
        return out
    launched = _launch_scan_kernel(scan, schema, plan, prof)
    if launched is None:
        return None
    t0 = time.perf_counter()
    ((counts, res_np),) = _fetch_launched([launched], plan, pinned=False)
    prof.mark("fetch", time.perf_counter() - t0)
    t1 = time.perf_counter()
    out = _collect_moment_frame(launched, plan, counts, res_np)
    prof.mark("collect", time.perf_counter() - t1)
    return out


def _fetch_launched(launched: List["_Launched"], plan: TpuPlan,
                    pinned: bool = True
                    ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
    """(counts, per-moment results in the reference's dtypes) of each
    launch, in one device-to-host copy: every moment and count is a
    4-byte value, so all of them are flattened as int32 words into one
    device buffer, copied once (into pinned memory when `pinned`: the
    streamed path's many small launches) and split on the host."""
    words = torch.cat([w for ln in launched for w in
                       [r.view(torch.int32) for r in ln.results] +
                       [ln.counts]])
    if words.device.type != "cuda":
        host = words.numpy()
    elif pinned:
        buf = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
        buf.copy_(words, non_blocking=True)
        torch.cuda.current_stream(words.device).synchronize()
        host = buf.numpy()
    else:
        host = words.cpu().numpy()
    out, pos = [], 0
    for ln in launched:
        k = len(ln.results) + 1
        w = host[pos:pos + k * ln.nruns].reshape(k, ln.nruns)
        pos += k * ln.nruns
        res_np = [x.view(np.dtype(str(r.dtype).replace("torch.", "")))
                  for x, r in zip(w[:-1], ln.results)]
        out.append((w[-1], _narrow_results(res_np, plan, ln.narrow)))
    return out


def _run_context(scan: MergedScan, plan: TpuPlan):
    """(nruns, run_starts, buckets, device run ends) for the plan's
    grouping, cached per scan: dashboards repeat the same grouping over a
    warm region, and the flags/nonzero sweep is O(n) host work."""
    n = scan.num_rows
    sids = scan.series_ids
    if plan.bucket is not None:
        b = plan.bucket
        run_key = f"__runs:{b.stride_ms}:{b.origin}"
    elif plan.tag_groups:
        run_key = "__runs:series"
    else:
        run_key = "__runs:all"
    ctx = scan.mirrors.get(run_key)
    if ctx is not None:
        return ctx
    if plan.bucket is not None:
        b = plan.bucket
        buckets = ((scan.ts - b.origin) // b.stride_ms).astype(np.int64)
        flags = np.empty(n, dtype=bool)
        flags[0] = True
        np.not_equal(sids[1:], sids[:-1], out=flags[1:])
        flags[1:] |= buckets[1:] != buckets[:-1]
    else:
        buckets = None
        flags = np.zeros(n, dtype=bool)
        flags[0] = True
        if plan.tag_groups:
            np.not_equal(sids[1:], sids[:-1], out=flags[1:])
    run_starts = np.nonzero(flags)[0]
    nruns = len(run_starts)
    run_ends = np.empty(nruns, dtype=np.int32)
    run_ends[:-1] = run_starts[1:]
    run_ends[-1] = n
    ctx = (nruns, run_starts, buckets, scan.to_device(run_ends))
    scan.mirrors[run_key] = ctx
    # bound the per-scan run-context cache: each distinct bucket spec
    # holds O(n) host arrays
    stale = [k for k in scan.mirrors if k.startswith("__runs:")][:-4]
    for k in stale:
        scan.mirrors.pop(k, None)
    return ctx


def _launch_scan_kernel(scan: MergedScan, schema, plan: TpuPlan,
                        prof: ScanProfile) -> Optional[_Launched]:
    n = scan.num_rows
    if n == 0:
        return None
    tag_names = schema.tag_names()
    sids = scan.series_ids

    # ---- host: runs over (series [, bucket]) ----
    t0 = time.perf_counter()
    nruns, run_starts, buckets, d_ends = _run_context(scan, plan)
    prof.mark("runs", time.perf_counter() - t0)

    # ---- host: per-series tag predicate → row mask ----
    t1 = time.perf_counter()
    base_mask = None
    if plan.tag_predicates:
        sd = scan.series_dict
        S = sd.num_series
        tag_cols = {}
        for i, tname in enumerate(tag_names):
            tag_cols[tname] = sd.decode_tag_column(
                np.arange(S, dtype=np.int32), i)
        ev = Evaluator(pd.DataFrame(tag_cols))
        smask = np.ones(S, dtype=bool)
        for p in plan.tag_predicates:
            m = ev.eval(p)
            m = m.fillna(False).astype(bool).to_numpy() \
                if isinstance(m, pd.Series) else np.full(S, bool(m))
            smask &= m
        if not smask.any():
            return None
        base_mask = smask[sids]

    # ---- row mask (host; skipped for the unfiltered case, which reuses
    # the resident all-true mask) ----
    mask = None
    if base_mask is not None or plan.time_lo is not None or \
            plan.time_hi is not None or plan.field_filters:
        mask = base_mask if base_mask is not None \
            else np.ones(n, dtype=bool)
        if plan.time_lo is not None:
            mask &= scan.ts >= plan.time_lo
        if plan.time_hi is not None:
            mask &= scan.ts < plan.time_hi
        for ff in plan.field_filters:
            vals, valid = scan.fields[ff.column]
            if vals.dtype == object:
                raise UnsupportedError(
                    f"filter on non-numeric {ff.column}")
            v = vals.astype(np.float64)
            cmp = {"eq": v == ff.value, "ne": v != ff.value,
                   "lt": v < ff.value, "le": v <= ff.value,
                   "gt": v > ff.value, "ge": v >= ff.value}[ff.op]
            if valid is not None:
                cmp &= valid
            mask &= cmp
        if not mask.any():
            return None
    prof.mark("masks", time.perf_counter() - t1)

    # ---- device inputs: resident mirrors, this query's mask ----
    t2 = time.perf_counter()
    d_ts = scan.device_ts()
    d_mask = scan.device_valid_all() if mask is None \
        else scan.to_device(mask)
    values = []
    col_masks = []
    ops = []
    narrow: list = []
    for m in plan.moments:
        fix = None
        if m.op in ("min_ts", "max_ts"):
            values.append(d_ts)
            col_masks.append(scan.device_valid(m.column))
            ops.append("min" if m.op == "min_ts" else "max")
        elif m.column is None:
            values.append(d_ts)   # dummy; count reads only the masks
            col_masks.append(scan.device_valid_all())
            ops.append("count")
        else:
            cs = schema.column_schema(m.column)
            dt = scan.fields[m.column][0].dtype
            if cs.dtype.is_string or cs.dtype.is_binary:
                values.append(d_ts)
            elif m.op == "sum_sq" and dt == np.uint32:
                values.append(scan.device_field_f32(m.column))
            else:
                values.append(scan.device_field(m.column))
                if m.op not in ("count", "sum_sq") and (
                        dt in _NARROW_INTS or dt == np.uint32):
                    fix = (dt, None)
            col_masks.append(scan.device_valid(m.column))
            ops.append(m.op)
        narrow.append(fix)
    # a uint32 sum is recovered from its biased sum and the column's
    # count, and an empty first/last from the count too: launch the
    # count when the plan does not ask for it
    count_at = {m.column: i for i, m in enumerate(plan.moments)
                if m.op == "count"}
    for i, m in enumerate(plan.moments):
        fix = narrow[i]
        if fix is None or fix[0] != np.uint32 or \
                m.op not in ("sum", "first", "last"):
            continue
        if m.column not in count_at:
            count_at[m.column] = len(ops)
            values.append(d_ts)
            col_masks.append(scan.device_valid(m.column))
            ops.append("count")
        narrow[i] = (fix[0], count_at[m.column])
    prof.mark("h2d", time.perf_counter() - t2)

    # ---- the kernel: every moment in one launch over the host run ends
    # (no shape-bucket padding: the port compiles nothing per shape) ----
    t3 = time.perf_counter()
    results, counts = sorted_grouped_aggregate(
        None, d_mask, d_ts, tuple(values), tuple(col_masks),
        num_groups=nruns, ops=tuple(ops), has_col_masks=True, ends=d_ends)
    prof.mark("launch", time.perf_counter() - t3)
    return _Launched(tuple(results), counts, nruns, sids[run_starts],
                     buckets[run_starts] if buckets is not None else None,
                     scan.series_dict, scan.ts_base, narrow)


def _narrow_results(res_np: List[np.ndarray], plan: TpuPlan,
                    narrow: list) -> List[np.ndarray]:
    """Each plan moment's fetched result in the reference's dtype.

    int8/int16/uint8/uint16 columns: sums narrow to the column's dtype
    (the kernel's int32 sum wraps mod 2^32, the cast mod 2^8 / 2^16, as
    the reference's `.astype(fdt)`); min/max clip the int32 identities to
    the dtype's. uint32 columns: values are un-biased (+2^31), so the
    int32 identities become uint32 max/min; a sum is (biased sum +
    count * 2^31) mod 2^32; a first/last with no valid row is 0, as the
    reference's. The extra counts behind the plan's moments are
    dropped."""
    out = []
    for r, m, fix in zip(res_np, plan.moments, narrow):
        if fix is None:
            out.append(r)
            continue
        dt, ci = fix
        if dt == np.uint32:
            r64 = r.astype(np.int64)
            if m.op == "sum":
                u = r64 + res_np[ci].astype(np.int64) * _U32_BIAS
            elif m.op in ("first", "last"):
                u = np.where(res_np[ci] > 0, r64 + _U32_BIAS, 0)
            else:
                u = r64 + _U32_BIAS
            out.append((u % (1 << 32)).astype(np.uint32))
        elif m.op == "sum":
            out.append(r.astype(dt))
        else:
            info = np.iinfo(dt)
            out.append(np.clip(r, info.min, info.max).astype(dt))
    return out


def _collect_moment_frame(launched: _Launched, plan: TpuPlan,
                          counts: np.ndarray,
                          res_np: List[np.ndarray]) -> Optional[pd.DataFrame]:
    # ---- host: fold runs into final groups ----
    live = counts > 0
    if not live.any():
        return None
    frame: Dict[str, Any] = {}
    run_sids = launched.run_sids
    sd = launched.series_dict
    for tg in plan.tag_groups:
        frame[_group_slot(tg.name)] = sd.decode_tag_column(
            run_sids, tg.tag_index)
    if plan.bucket is not None:
        frame[_group_slot(plan.bucket.expr_key)] = \
            launched.run_buckets * plan.bucket.stride_ms + \
            plan.bucket.origin
    for m, r in zip(plan.moments, res_np):
        if m.op in ("min_ts", "max_ts"):
            # device ts is region-relative (ts - ts_base, base differs per
            # region); rebase to absolute so cross-region first/last merge
            # in _finalize compares comparable timestamps
            r = r.astype(np.int64) + launched.ts_base
        frame[m.slot] = r
    frame["__rowcount"] = counts
    return pd.DataFrame(frame)[live]


def _nan_if_none(v):
    return np.nan if v is None else v


def _merge_sketch_cells(cells) -> Optional[bytes]:
    """Fold encoded sketch partials (bytes) into ONE re-encoded partial.
    Decode errors raise SketchCodecError — try_execute degrades the
    statement to the raw-row path rather than answer wrong."""
    from .sketches import decode_sketch, encode_sketch
    merged = None
    for c in cells:
        if c is None or (isinstance(c, float) and np.isnan(c)):
            continue
        sk = decode_sketch(c)
        merged = sk if merged is None else merged.merge(sk)
    return None if merged is None else encode_sketch(merged)


def _finalize(df: pd.DataFrame, plan: TpuPlan) -> pd.DataFrame:
    key_cols = [_group_slot(t.name) for t in plan.tag_groups]
    if plan.bucket is not None:
        key_cols.append(_group_slot(plan.bucket.expr_key))

    moment_cols = {m.slot: m for m in plan.moments}

    def _ts_slot_for(m: Moment, kind: str) -> str:
        return next(s for s, mm in moment_cols.items()
                    if mm.op == kind and mm.column == m.column)

    def merge(group: pd.DataFrame) -> pd.Series:
        out = {}
        for slot, m in moment_cols.items():
            v = group[slot]
            if m.op in SKETCH_MOMENT_OPS:
                out[slot] = _merge_sketch_cells(v)
            elif m.op in ("sum", "sum_sq", "count"):
                out[slot] = v.sum()
            elif m.op in ("min", "min_ts"):
                out[slot] = v.min()
            elif m.op in ("max", "max_ts"):
                out[slot] = v.max()
            elif m.op in ("first", "last"):
                # partial with a valid value whose ts is extreme wins
                kind = "min_ts" if m.op == "first" else "max_ts"
                ts_slot = _ts_slot_for(m, kind)
                nn = group[group[slot].notna()]
                if not len(nn):
                    out[slot] = None
                elif m.op == "first":
                    out[slot] = nn.loc[nn[ts_slot].idxmin(), slot]
                else:
                    out[slot] = nn.loc[nn[ts_slot].idxmax(), slot]
            elif m.op == "reset_corr":
                # partials are time-disjoint slices of one series run:
                # total correction = per-slice corrections + each slice
                # boundary that itself crosses a counter reset
                # (first-of-next < last-of-prev contributes the prev)
                g = group.sort_values(_ts_slot_for(m, "min_ts"),
                                      kind="stable")
                prev = g[_ts_slot_for(m, "last")].shift()
                cur = g[_ts_slot_for(m, "first")]
                cross = (cur < prev) & cur.notna() & prev.notna()
                out[slot] = g[slot].sum() + \
                    prev.where(cross, 0.0).fillna(0.0).sum()
        return pd.Series(out)

    if key_cols:
        if df[key_cols + list(moment_cols)].duplicated(key_cols).any():
            # vectorized fold: one groupby.agg for the decomposable
            # moments (a per-group Python merge costs seconds at 10k+
            # groups — slice streaming produces one partial per group
            # per slice), plus a sort+first/last pass for ts-extremes
            gb = df.groupby(key_cols, dropna=False, sort=False)
            aggs = {}
            extremes = []
            sketches = []
            resets = []
            for slot, m in moment_cols.items():
                if m.op in SKETCH_MOMENT_OPS:
                    sketches.append(slot)
                elif m.op == "reset_corr":
                    resets.append((slot, m))
                elif m.op in ("sum", "sum_sq", "count"):
                    aggs[slot] = "sum"
                elif m.op in ("min", "min_ts"):
                    aggs[slot] = "min"
                elif m.op in ("max", "max_ts"):
                    aggs[slot] = "max"
                else:
                    extremes.append((slot, m))
            aggs["__rowcount"] = "sum"      # a plan of only sketch
            merged = gb.agg(aggs)           # moments still needs keys
            for slot, m in extremes:
                # groupby.first()/.last() take the first/last NON-NULL
                # value in frame order; sorting by the companion ts makes
                # that "valid partial with extreme ts" exactly
                kind = "min_ts" if m.op == "first" else "max_ts"
                ts_slot = _ts_slot_for(m, kind)
                srt = df.sort_values(ts_slot, kind="stable")
                gs = srt.groupby(key_cols, dropna=False, sort=False)[slot]
                merged[slot] = gs.first() if m.op == "first" else gs.last()
            for slot in sketches:
                # fold encoded partials per group through the codec
                # (bytes in, bytes out — pandas treats bytes as scalars)
                merged[slot] = gb[slot].agg(_merge_sketch_cells)
            for slot, m in resets:
                # per-group partials sorted by slice start: corrections
                # add, plus the prev-last where a slice boundary itself
                # crosses a reset (first-of-next < last-of-prev)
                srt = df.sort_values(_ts_slot_for(m, "min_ts"),
                                     kind="stable")
                gs = srt.groupby(key_cols, dropna=False, sort=False)
                prev = gs[_ts_slot_for(m, "last")].shift()
                cur = srt[_ts_slot_for(m, "first")]
                cross = (cur < prev) & cur.notna() & prev.notna()
                bonus = prev.where(cross, 0.0).fillna(0.0)
                merged[slot] = gs[slot].sum() + bonus.groupby(
                    [srt[k] for k in key_cols], dropna=False,
                    sort=False).sum()
            merged = merged.reset_index()
        else:
            merged = df
    else:
        merged = merge(df).to_frame().T

    # finalize ops from moments
    out = merged[key_cols].copy() if key_cols else pd.DataFrame(
        index=merged.index)
    for slot, op, mslots in plan.finals:
        if op in ("sum", "min", "max", "first", "last", "moment"):
            # "moment": raw merged-moment passthrough — PromQL's rate
            # finalization reads min_ts/max_ts/reset_corr directly
            out[slot] = merged[mslots[0]]
        elif op == "count":
            out[slot] = merged[mslots[0]].astype(np.int64)
        elif op in ("count_distinct", "approx_distinct"):
            from .sketches import decode_sketch
            out[slot] = merged[mslots[0]].map(
                lambda b: 0 if b is None
                else decode_sketch(b).result()).astype(np.int64)
        elif op == "approx_percentile":
            from .sketches import decode_sketch
            p = plan.agg_params.get(slot, (50.0,))[0]
            out[slot] = merged[mslots[0]].map(
                lambda b: np.nan if b is None
                else _nan_if_none(decode_sketch(b).quantile(p))
            ).astype(np.float64)
        elif op == "avg":
            s, c = merged[mslots[0]], merged[mslots[1]]
            out[slot] = np.where(c > 0, s / np.maximum(c, 1), np.nan)
        elif op in ("stddev", "variance"):
            s, sq, c = (merged[m] for m in mslots)
            cc = np.maximum(c, 1)
            # sample variance (ddof=1) to match DataFusion; <2 rows → NULL;
            # s/cc promotes to float BEFORE the square — s*s wraps int cols
            var = np.maximum(sq - (s / cc) * s, 0.0) / np.maximum(c - 1, 1)
            var = np.where(c >= 2, var, np.nan)
            out[slot] = np.sqrt(var) if op == "stddev" else var
    # null out empty-count aggregates (kernel yields NaN already for floats)
    for slot, op, mslots in plan.finals:
        if op in ("sum", "min", "max", "first", "last", "avg"):
            cnt = None
            for ms in mslots:
                if moment_cols[ms].op == "count":
                    cnt = merged[ms]
            if cnt is not None:
                out.loc[cnt == 0, slot] = np.nan
    return out.reset_index(drop=True)
