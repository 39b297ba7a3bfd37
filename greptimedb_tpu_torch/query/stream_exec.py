"""Block-streamed cold scan: aggregate regions too large for the scan cache.

Reference: greptimedb_tpu/query/stream_exec.py. The cached fast path
(tpu_exec.SCAN_CACHE) keeps a region's merged scan in host memory with
device mirrors: right for regions that fit, not for a region above half
the cache budget. Such a region streams instead:

1. its key domain is cut into contiguous slices sized by parquet row-group
   statistics (a row budget per slice): on TIME where the chunks are
   time-disjoint (flushes, bulk loads), on SERIES id inside an oversized
   overlapping pile (`_plan_jobs`);
2. each slice is read with row-group pruning (memtables + SSTs clipped to
   the slice), then merged and MVCC-deduped exactly: a (series, ts) key
   lives in exactly one slice on either axis. A slice whose files prove
   dup-free, delete-free and key-disjoint skips the merge, and, fully
   covered, reduces straight from the arrow batches (`_lean_chunk_frames`);
3. each slice reduces to a partial moment frame, on the host by default
   (`cold_reduce="host"`: a vectorized reduceat, `_host_partial_frame`)
   or on the card (`"device"`: one `segment_moments` launch per non-empty
   slice), and tpu_exec._finalize folds the partials as it folds regions;
4. slices decode two deep on a prefetch pool while the coordinator
   reduces or launches the current one.

The device side differs from the reference's. A slice is launched over
exactly its rows (no shape-bucket padding: nothing compiles per shape).
The prefetch worker packs the slice's mirrors — in MergedScan's device
dtypes (tpu_exec.mirror_values) — into a pinned host buffer it reuses
across slices and queries, copies them to the card in one non_blocking
copy on a side stream and records an event; the coordinator makes its
stream wait on that event before the launch. Every launched slice's
moments and counts are fetched together: one device buffer of int32
words, one copy into pinned memory, one synchronize.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..common import exec_stats, failpoint, process_list
from ..common.locks import TrackedLock
from ..common.runtime import transient_executor
from ..common.telemetry import increment_counter, propagate, span
from ..common.time import TimestampRange
from ..common.tracking import tracked_state
from ..errors import UnsupportedError
from ..ops.kernels import OP_PUT, merge_dedup_numpy
from ..storage.region import ScanProfile

# per-slice boundary of the streamed cold scan: delay(ms) makes a scan
# deterministically slow for the KILL-cancellation tests
failpoint.register("stream_slice")

#: stream (instead of caching) any region estimated above this many rows
_STREAM_THRESHOLD_ROWS = tracked_state([64_000_000],
                                       "query.stream_exec.threshold_rows")
#: target rows per streamed slice (soft: slices track row-group edges)
_SLICE_ROWS = tracked_state([16_000_000], "query.stream_exec.slice_rows")
#: the smallest slice worth its own reduction at a clean break
_ROW_BUCKET_MIN = 1 << 20
#: where a cold slice's reduction runs: "host" (a vectorized reduceat
#: over the just-decoded columns, where the bytes already are) or
#: "device" (one segment_moments launch per slice)
_COLD_REDUCE = tracked_state(["host"], "query.stream_exec.cold_reduce")
#: guards the knobs above (configure_streaming writes them while scans
#: read them) and the pool of stagers (_STAGERS, below)
_STAGERS_LOCK = TrackedLock("query.stream_exec.stagers")


def configure_streaming(threshold_rows: Optional[int] = None,
                        slice_rows: Optional[int] = None,
                        cold_reduce: Optional[str] = None) -> None:
    """Tune the cold-scan streaming knobs (TOML [query] section)."""
    if cold_reduce is not None and cold_reduce not in ("host", "device"):
        raise ValueError(f"cold_reduce {cold_reduce!r}")
    with _STAGERS_LOCK:
        if threshold_rows is not None:
            _STREAM_THRESHOLD_ROWS[0] = int(threshold_rows)
        if slice_rows is not None:
            _SLICE_ROWS[0] = int(slice_rows)
        if cold_reduce is not None:
            _COLD_REDUCE[0] = cold_reduce


def stream_threshold_rows() -> int:
    with _STAGERS_LOCK:
        return _STREAM_THRESHOLD_ROWS[0]


def region_estimated_rows(region) -> int:
    """Upper-bound row estimate from memtable counters + SST metas."""
    vc = getattr(region, "version_control", None)
    if vc is None:
        return 0
    v = vc.current
    total = 0
    for mt in v.memtables.all_memtables():
        total += mt.num_rows
    for meta in v.ssts.all_files():
        total += meta.num_rows
    return total


def region_estimated_bytes(region) -> int:
    """Estimated DECODED residency of a fully-cached scan: rows × the
    schema's in-memory row width (ts + sid + every field column and its
    validity), in the scan-cache budget's units (parquet file sizes
    understate it: compression and column pruning)."""
    vc = getattr(region, "version_control", None)
    if vc is None:
        return 0
    schema = vc.current.schema
    width = 12                        # int64 ts + int32 sid
    for c in schema.field_columns():
        np_dtype = c.dtype.np_dtype
        width += (np.dtype(np_dtype).itemsize
                  if np_dtype is not None else 16) + 1
    return region_estimated_rows(region) * width


def region_time_span(region) -> int:
    """Inclusive width of a region's time domain in its native unit, from
    SST metas + memtable counters alone (no reads)."""
    vc = getattr(region, "version_control", None)
    if vc is None:
        return 0
    lo = hi = None
    v = vc.current
    for meta in v.ssts.all_files():
        flo, fhi = meta.time_range
        lo = flo if lo is None else min(lo, flo)
        hi = fhi if hi is None else max(hi, fhi)
    for mt in v.memtables.all_memtables():
        ms = mt.snapshot()
        if ms.num_rows:
            lo = int(ms.ts.min()) if lo is None \
                else min(lo, int(ms.ts.min()))
            hi = int(ms.ts.max()) if hi is None \
                else max(hi, int(ms.ts.max()))
    return 0 if lo is None else int(hi - lo + 1)


def region_stat_entries(regions) -> tuple:
    """(per-region stat dicts, total_rows, total_bytes) for an iterable
    of Region objects: rows, estimated decoded bytes, series count, time
    span and the committed (or, on a standby, replicated) sequence."""
    entries, total_rows, total_bytes = [], 0, 0
    for region in sorted(regions, key=lambda r: r.name):
        rows = int(region_estimated_rows(region))
        size = int(region_estimated_bytes(region))
        sd = getattr(region, "series_dict", None)
        total_rows += rows
        total_bytes += size
        entry = {"region": region.name, "rows": rows,
                 "size_bytes": size,
                 "series": int(getattr(sd, "num_series", 0) or 0),
                 "time_span": region_time_span(region)}
        vc = getattr(region, "version_control", None)
        committed = int(vc.committed_sequence) if vc is not None else 0
        if getattr(region, "standby", False):
            entry["standby"] = True
            entry["replicated_seq"] = committed
        else:
            entry["committed_seq"] = committed
        entries.append(entry)
    return entries, total_rows, total_bytes


def _plan_slices(stats: List[Tuple[int, int, int]], budget: int,
                 clip_lo: Optional[int], clip_hi: Optional[int]
                 ) -> List[Tuple[int, int]]:
    """Choose contiguous half-open slices [t0, t1) covering every row.

    `stats` are (min, max_inclusive, rows) per storage chunk (parquet row
    group or memtable). Two kinds of cuts, both on chunk edges:

    - clean breaks: gaps where no chunk spans the boundary, so a slice
      covers whole sorted runs and its reader skips the merge sort; taken
      once a slice holds enough rows to deserve its own reduction;
    - budget cuts: inside an overlapping run of chunks, accumulate to the
      row budget (those slices still merge-sort, but stay bounded).

    Slices are exact partitions of the domain whatever the cut quality;
    the stats only balance sizes."""
    clipped = []
    for lo, hi, rows in stats:
        if clip_lo is not None and hi < clip_lo:
            continue
        if clip_hi is not None and lo >= clip_hi:
            continue
        clipped.append((lo, hi, rows))
    if not clipped:
        return []
    tmin = min(lo for lo, _, _ in clipped)
    tmax = max(hi for _, hi, _ in clipped)
    if clip_lo is not None:
        tmin = max(tmin, clip_lo)
    if clip_hi is not None:
        tmax = min(tmax, clip_hi - 1)
    if tmin > tmax:
        return []
    # connected components of overlapping chunks: (lo, hi, rows, chunks)
    comps: List[list] = []
    for lo, hi, rows in sorted(clipped, key=lambda s: (s[0], s[1])):
        if comps and lo <= comps[-1][1]:
            c = comps[-1]
            c[1] = max(c[1], hi)
            c[2] += rows
            c[3].append((lo, hi, rows))
        else:
            comps.append([lo, hi, rows, [(lo, hi, rows)]])

    min_clean = max(_ROW_BUCKET_MIN, budget // 8)
    cuts: set = set()
    acc = 0
    prev_hi: Optional[int] = None
    for clo, chi, crows, chunks in comps:
        # close the running slice at the gap when it is big enough, when
        # the next component would bust the budget, or when an
        # oversized component follows (its inner cuts stay its own)
        if prev_hi is not None and acc and (acc >= min_clean
                                            or acc + crows > budget
                                            or crows > budget):
            cuts.add(prev_hi + 1)
            acc = 0
        if crows > budget:
            # oversized overlapping pile: budget cuts inside it
            inner = 0
            for lo, hi, rows in sorted(chunks, key=lambda s: (s[1], s[0])):
                inner += rows
                if inner >= budget and hi < chi:
                    cuts.add(hi + 1)
                    inner = 0
            acc = budget            # force a cut before whatever follows
        else:
            acc += crows
        prev_hi = chi
    bounds = [tmin] + sorted(c for c in cuts if tmin < c <= tmax) \
        + [tmax + 1]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
            if bounds[i] < bounds[i + 1]]


def _region_slice_stats(region, snap
                        ) -> List[Tuple[int, int, int, int, int]]:
    """(min_ts, max_ts, min_sid, max_sid, rows) per chunk: SST row
    groups + memtables."""
    v = snap._version
    stats: List[Tuple[int, int, int, int, int]] = []
    for meta in v.ssts.all_files():
        rg = region.access_layer.row_group_stats(meta)
        if rg:
            stats.extend(rg)
        else:  # no stats: the whole file is one chunk
            lo, hi = meta.time_range
            stats.append((lo, hi, 0, 1 << 30, meta.num_rows))
    for mt in v.memtables.all_memtables():
        ms = mt.snapshot()
        if ms.num_rows:
            stats.append((int(ms.ts.min()), int(ms.ts.max()),
                          int(ms.series_ids.min()),
                          int(ms.series_ids.max()), ms.num_rows))
    return stats


def _plan_jobs(stats: List[Tuple[int, int, int, int, int]], budget: int,
               time_lo: Optional[int], time_hi: Optional[int], unit
               ) -> List[Tuple[str, int, int, Optional[TimestampRange]]]:
    """Per-component hybrid slice plan: (dim, lo, hi, time_clip) jobs.

    Merge-freedom beats pruning tightness (the cold scan's largest host
    cost is the (sid, ts) merge sort, which vanishes when a slice covers
    whole sorted runs). So chains of time-disjoint components (in-order
    flushes, bulk loads) become TIME slices on their gaps, and an
    oversized overlapping component is sliced on SERIES id within its
    time range: SSTs sort by series first, so series row-group stats are
    tight there, and a series slice of one file is one sorted run."""
    clipped = []
    for tlo, thi, slo, shi, rows in stats:
        if time_lo is not None and thi < time_lo:
            continue
        if time_hi is not None and tlo >= time_hi:
            continue
        clipped.append((tlo, thi, slo, shi, rows))
    if not clipped:
        return []
    # connected components over time: [lo, hi, rows, chunks]
    comps: List[list] = []
    for ch in sorted(clipped):
        if comps and ch[0] <= comps[-1][1]:
            c = comps[-1]
            c[1] = max(c[1], ch[1])
            c[2] += ch[4]
            c[3].append(ch)
        else:
            comps.append([ch[0], ch[1], ch[4], [ch]])

    def clamp(lo: int, end: int) -> Tuple[int, int]:
        if time_lo is not None:
            lo = max(lo, time_lo)
        if time_hi is not None:
            end = min(end, time_hi)
        return lo, end

    jobs: List[Tuple[str, int, int, Optional[TimestampRange]]] = []
    min_clean = max(_ROW_BUCKET_MIN, budget // 8)
    pend_lo: Optional[int] = None
    pend_rows = 0
    prev_hi: Optional[int] = None

    def flush_pending() -> None:
        nonlocal pend_lo, pend_rows
        if pend_lo is not None:
            lo, end = clamp(pend_lo, prev_hi + 1)
            if lo < end:
                jobs.append(("time", lo, end, None))
        pend_lo = None
        pend_rows = 0

    for clo, chi, crows, chunks in comps:
        if crows > budget:
            flush_pending()
            lo, end = clamp(clo, chi + 1)
            clip = TimestampRange(lo, end, unit)
            sstats = [(c[2], c[3], c[4]) for c in chunks]
            sslices = _plan_slices(sstats, budget, None, None)
            if len(sslices) > 1:
                for slo, shi in sslices:
                    jobs.append(("series", slo, shi, clip))
            else:
                # the series axis cannot subdivide: time budget cuts
                # (those slices merge-sort, but stay bounded)
                tstats = [(c[0], c[1], c[4]) for c in chunks]
                for tlo2, thi2 in _plan_slices(tstats, budget, lo, end):
                    jobs.append(("time", tlo2, thi2, None))
        else:
            if pend_lo is not None and (pend_rows >= min_clean
                                        or pend_rows + crows > budget):
                flush_pending()
            if pend_lo is None:
                pend_lo = clo
            pend_rows += crows
        prev_hi = chi
    flush_pending()
    return jobs


def _plan_needs_ts(plan) -> bool:
    """Whether the aggregate ever consults row times: time bucketing,
    time filtering, or a moment whose fold is keyed by time."""
    if plan.bucket is not None or plan.time_lo is not None \
            or plan.time_hi is not None:
        return True
    return any(m.op in ("min_ts", "max_ts", "first", "last")
               for m in plan.moments if m.column is not None)


def _slice_lean_proof(snap, dim: str, lo: int, hi: int, unit,
                      time_range: Optional[TimestampRange]
                      ) -> Tuple[bool, bool, list]:
    """(skip_dedup, fully_covered, files) for one slice, from file
    metadata alone.

    skip_dedup: no (series, ts) key in the slice can have two versions —
    every file is dup-free (num_dup_keys == 0) and delete-free, the
    files' key rectangles are pairwise disjoint, and no memtable rows
    exist; files that predate num_dup_keys report None and fail.
    fully_covered: every candidate file's time range lies inside the
    slice's clip, so no per-row time mask can trigger. `files` is the
    candidate list the proof certified; the lean reader consumes exactly
    this list."""
    v = snap._version
    if any(mt.num_rows for mt in v.memtables.all_memtables()):
        return False, False, []
    if dim == "time":
        clip_lo, clip_hi = lo, hi
        files = v.ssts.files_in_range(TimestampRange(lo, hi, unit))
    else:
        clip_lo = time_range.start if time_range is not None else None
        clip_hi = time_range.end if time_range is not None else None
        files = [f for f in v.ssts.files_in_range(time_range)
                 if f.sid_range is None or
                 (f.sid_range[1] >= lo and f.sid_range[0] < hi)]
    covered = all(
        (clip_lo is None or f.time_range[0] >= clip_lo) and
        (clip_hi is None or f.time_range[1] < clip_hi)
        for f in files)
    for f in files:
        if f.num_dup_keys != 0 or f.num_deletes != 0:
            return False, covered, files
    if len(files) > 64:
        # the pairwise check is O(F^2): past this bound decline the proof
        # (the general merge path is always correct)
        return False, covered, files
    for i in range(len(files)):
        for j in range(i + 1, len(files)):
            if files[i].keys_overlap(files[j]):
                return False, covered, files
    return True, covered, files


class _LeanChunk:
    """ScanData stand-in for one parquet record batch: numpy views over
    the arrow buffers (zero-copy for null-free numeric columns), just
    enough surface for _host_partial_frame. seq/op_types are 0-stride
    placeholders: the lean proof guarantees nothing needs MVCC values."""

    __slots__ = ("series_ids", "ts", "seq", "op_types", "fields")

    def __init__(self, series_ids, ts, fields):
        n = len(series_ids)
        self.series_ids = series_ids
        self.ts = ts
        self.seq = np.broadcast_to(np.int64(0), (n,))
        self.op_types = np.broadcast_to(np.int8(0), (n,))
        self.fields = fields


def _lean_chunk_frames(snap, access, files, dim: str, lo: int, hi: int,
                       needed_fields, plan, sd, need_ts: bool,
                       sid_keys: bool = False,
                       sid_set: Optional[np.ndarray] = None):
    """Decode→reduce fast path for a fully-covered, dedup-free slice:
    each SST's row groups stream as arrow record batches, each reduced
    straight into a partial moment frame over zero-copy column views (no
    ScanData assembly, no concatenation). Every batch is (sid, ts)-sorted
    and partial frames fold by group key downstream, so exactness holds.

    Returns (frames, rows_read), or None when a precondition fails and
    the caller must take the general scan path."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t0 = time.perf_counter()
    rows_read = 0
    bytes_read = 0
    reduce_s = 0.0
    schema = snap._version.schema
    ts_name = schema.timestamp_column.name
    if dim == "series":
        # every file must be sid-contained too: row groups of a
        # straddling file would leak rows into the neighbour slice
        if any(f.sid_range is None or f.sid_range[0] < lo or
               f.sid_range[1] >= hi for f in files):
            return None
    sid_idxes = {}
    if sid_set is not None:
        # drop whole certified files (and then row groups) through the
        # index tier: a pruned file's rows would all be masked out by the
        # tag predicates anyway, so the lean proof holds on the subset
        from ..storage.index import prune_files
        files = prune_files(access.load_index, files, sid_set)[0]
        for meta in files:
            idx = access.load_index(meta)
            if idx is not None:
                sid_idxes[meta.file_name] = idx
    cols = list(needed_fields) + ["__series_id"]
    if need_ts:
        cols.append(ts_name)
    want_types = {}
    for name in needed_fields:
        cs = schema.column_schema(name)
        if cs.dtype.pa_type is None or cs.dtype.np_dtype is None:
            return None                      # non-numeric moment column
        want_types[name] = cs.dtype.pa_type
    frames = []
    for meta in files:
        key = access._key(meta.file_name)
        path = access.store.local_path(key)
        src = path if path is not None \
            else pa.BufferReader(access.store.read(key))
        pf = pq.ParquetFile(src)
        present = set(pf.schema_arrow.names)
        if any(c not in present for c in cols):
            return None                      # pre-ALTER file: general path
        sidx = sid_idxes.get(meta.file_name)
        # as read_sst: a sidecar whose group count disagrees with the
        # parquet layout degrades to reading every group
        gk = sidx.row_groups_for(sid_set) \
            if sidx is not None and \
            len(sidx.rg_lo) == pf.metadata.num_row_groups else None
        for g in range(pf.metadata.num_row_groups):
            if gk is not None and not gk[g]:
                continue                     # no candidate sid in group
            # one row group at a time: the decode high-water mark stays
            # one group per prefetch worker
            table = pf.read_row_groups([g], columns=cols,
                                       use_threads=True)
            for batch in table.to_batches():
                nb = batch.num_rows
                if nb == 0:
                    continue
                rows_read += nb
                bytes_read += batch.nbytes
                data = _lean_batch(batch, schema, needed_fields,
                                   want_types, ts_name, need_ts, nb)
                if data is None:
                    return None
                tr = time.perf_counter()
                f = _host_partial_frame(data, None, plan, sd,
                                        sid_keys=sid_keys)
                reduce_s += time.perf_counter() - tr
                if f is not None and len(f):
                    frames.append(f)
    # the lean reader bypasses read_sst, so it reports its own decode
    exec_stats.record("decode", rows=rows_read, files=len(files),
                      bytes=bytes_read, stream_rows=rows_read,
                      elapsed_s=time.perf_counter() - t0 - reduce_s)
    exec_stats.record("reduce", rows=rows_read, elapsed_s=reduce_s)
    return frames, rows_read


def _lean_batch(batch, schema, needed_fields, want_types, ts_name: str,
                need_ts: bool, nb: int) -> Optional[_LeanChunk]:
    """numpy views over one record batch; None when a column can't be
    viewed losslessly and the slice must fall back."""
    import pyarrow as pa

    names = batch.schema.names
    idx = {nm: i for i, nm in enumerate(names)}
    sids = np.asarray(batch.column(idx["__series_id"]))
    if need_ts:
        tcol = batch.column(idx[ts_name])
        if pa.types.is_timestamp(tcol.type):
            tcol = tcol.view(pa.int64())     # zero-copy reinterpret
        elif tcol.type != pa.int64():
            return None
        ts = np.asarray(tcol)
    else:
        ts = np.broadcast_to(np.int64(0), (nb,))
    fields = {}
    for name in needed_fields:
        col = batch.column(idx[name])
        if col.type != want_types[name]:
            return None
        if col.null_count:
            from ..datatypes import Vector
            vec = Vector.from_arrow(col)
            fields[name] = (vec.data, vec.validity)
        else:
            fields[name] = (np.asarray(col), None)
    return _LeanChunk(sids, ts, fields)


#: moment ops whose partials fold with a plain groupby sum/min/max —
#: first/last need their ts-companion logic and stay label-keyed
_FOLDABLE_OPS = {"sum", "sum_sq", "count", "min", "max", "min_ts", "max_ts"}


def _sid_keyed(plan) -> bool:
    """Whether this region stream can key partials by series id and
    decode tag labels once after the fold, instead of per batch."""
    return bool(plan.tag_groups) and all(
        m.column is None or m.op in _FOLDABLE_OPS for m in plan.moments)


def _fold_sid_frames(frames: List[pd.DataFrame], plan, sd
                     ) -> List[pd.DataFrame]:
    """Intra-region fold of __sid-keyed partials (one groupby over dense
    ints), then one tag decode over the folded groups; the output
    carries the standard label columns, so the cross-region fold is
    unchanged."""
    from .planner import _group_slot

    df = pd.concat(frames, ignore_index=True) if len(frames) > 1 \
        else frames[0]
    keys = ["__sid"]
    if plan.bucket is not None:
        keys.append(_group_slot(plan.bucket.expr_key))
    aggs = {}
    for m in plan.moments:
        if m.column is None or m.op in ("sum", "sum_sq", "count"):
            aggs[m.slot] = "sum"
        elif m.op in ("min", "min_ts"):
            aggs[m.slot] = "min"
        else:
            aggs[m.slot] = "max"
    aggs["__rowcount"] = "sum"
    folded = df.groupby(keys, sort=False, as_index=False).agg(aggs)
    sids = folded["__sid"].to_numpy().astype(np.int32, copy=False)
    for tg in plan.tag_groups:
        folded[_group_slot(tg.name)] = sd.decode_tag_column(
            sids, tg.tag_index)
    return [folded.drop(columns=["__sid"])]


def _slice_dedup(data) -> Optional[np.ndarray]:
    """Kept-row indices for a slice, or None when every row survives
    (append-only data), so the caller skips the per-column gathers.
    Skips the sort when the concatenated runs are already
    (sid, ts, seq)-sorted (one SST covers the slice): dedup is then one
    vectorized adjacency scan."""
    s, t, q = data.series_ids, data.ts, data.seq
    n = len(s)
    if n > 1:
        s_up = s[1:] > s[:-1]
        s_eq = s[1:] == s[:-1]
        t_up = t[1:] > t[:-1]
        t_eq = t[1:] == t[:-1]
        sorted_ok = bool(np.all(
            s_up | (s_eq & (t_up | (t_eq & (q[1:] >= q[:-1]))))))
        if sorted_ok:
            dup = s_eq & t_eq
            deletes = data.op_types != OP_PUT
            if not dup.any() and not deletes.any():
                return None                  # keep everything, zero copies
            nxt_same = np.concatenate([dup, [False]])
            keep = ~nxt_same & ~deletes
            return np.nonzero(keep)[0]
    return merge_dedup_numpy(s, t, q, data.op_types)


def _host_partial_frame(data, kept: Optional[np.ndarray], plan, sd,
                        sid_keys: bool = False
                        ) -> Optional[pd.DataFrame]:
    """One-pass vectorized host reduction of a sorted slice into the
    partial moment frame `tpu_exec._collect_moment_frame` emits, so
    `_finalize` folds host and device partials alike: segment arithmetic
    over the (sid [, bucket]) run starts, `np.<ufunc>.reduceat` per
    moment, masks folded into the identity. Runs are (sid, ts)-sorted,
    so first/last are the min/max valid row index per run."""
    from .planner import _group_slot
    from .tpu_exec import SKETCH_MOMENT_OPS, moment_input, sketch_run_column

    sids, ts = data.series_ids, data.ts
    fields = data.fields
    n = len(ts)
    if n == 0:
        return None

    # ---- base row mask (dedup + tag predicates + time/field filters) ----
    mask: Optional[np.ndarray] = None

    def and_mask(m: np.ndarray) -> None:
        nonlocal mask
        mask = m if mask is None else mask & m

    if kept is not None:
        if len(kept) > 1 and not bool(np.all(kept[1:] > kept[:-1])):
            # merge-dedup order: `kept` is in (sid, ts) sort order, so
            # the arrays are gathered before run detection
            sids = sids[kept]
            ts = ts[kept]
            fields = {nm: (d[kept], vd[kept] if vd is not None else None)
                      for nm, (d, vd) in fields.items()}
            n = len(ts)
        else:
            km = np.zeros(n, dtype=bool)
            km[kept] = True
            and_mask(km)
    if plan.tag_predicates:
        from .expr import Evaluator
        S = sd.num_series
        tag_cols = {}
        for i, tname in enumerate(sd.tag_names):
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
        and_mask(smask[sids])
    if plan.time_lo is not None:
        and_mask(ts >= plan.time_lo)
    if plan.time_hi is not None:
        and_mask(ts < plan.time_hi)
    for ff in plan.field_filters:
        vals, valid = fields[ff.column]
        if vals.dtype == object:
            raise UnsupportedError(f"filter on non-numeric {ff.column}")
        v = vals.astype(np.float64, copy=False)
        cmp = {"eq": v == ff.value, "ne": v != ff.value,
               "lt": v < ff.value, "le": v <= ff.value,
               "gt": v > ff.value, "ge": v >= ff.value}[ff.op]
        if valid is not None:
            cmp &= valid
        and_mask(cmp)
    if mask is not None and not mask.any():
        return None

    # ---- run boundaries over (sid [, bucket]) ----
    buckets = None
    if plan.bucket is not None:
        b = plan.bucket
        buckets = (ts - b.origin) // b.stride_ms
        flags = np.empty(n, dtype=bool)
        flags[0] = True
        np.not_equal(sids[1:], sids[:-1], out=flags[1:])
        flags[1:] |= buckets[1:] != buckets[:-1]
        starts = np.nonzero(flags)[0]
    elif plan.tag_groups:
        flags = np.empty(n, dtype=bool)
        flags[0] = True
        np.not_equal(sids[1:], sids[:-1], out=flags[1:])
        starts = np.nonzero(flags)[0]
    else:
        starts = np.zeros(1, dtype=np.int64)

    if mask is None:
        counts = np.diff(starts, append=n).astype(np.int64)
    else:
        counts = np.add.reduceat(mask.astype(np.int64), starts)
    live = counts > 0
    if not live.any():
        return None

    f64max = np.finfo(np.float64).max
    i64max = np.iinfo(np.int64).max
    frame: Dict[str, np.ndarray] = {}
    if sid_keys:
        frame["__sid"] = sids[starts]
    else:
        for tg in plan.tag_groups:
            frame[_group_slot(tg.name)] = sd.decode_tag_column(
                sids[starts], tg.tag_index)
    if plan.bucket is not None:
        frame[_group_slot(plan.bucket.expr_key)] = \
            buckets[starts] * plan.bucket.stride_ms + plan.bucket.origin

    arange = None
    mcache: Dict[str, tuple] = {}
    for m in plan.moments:
        if m.column is None:             # plain row count
            frame[m.slot] = counts
            continue
        d, vd = moment_input(m, plan, fields, sids, ts, sd, cache=mcache)
        valid = vd if mask is None else (
            mask if vd is None else (vd & mask))
        if m.op in SKETCH_MOMENT_OPS:
            # per-run encoded sketch partials (distinct set / t-digest):
            # the bytes fold downstream through the codec exactly like
            # numeric moments fold through sums
            frame[m.slot] = sketch_run_column(m.op, d, valid, starts, n)
            continue
        if m.op in ("min_ts", "max_ts"):
            tsv = ts if valid is None else np.where(valid, ts, i64max
                                                    if m.op == "min_ts"
                                                    else -i64max)
            r = (np.minimum if m.op == "min_ts"
                 else np.maximum).reduceat(tsv, starts)
        elif m.op == "count":
            r = counts if valid is None or valid is mask else \
                np.add.reduceat(valid.astype(np.int64), starts)
        elif m.op in ("first", "last"):
            if arange is None:
                arange = np.arange(n, dtype=np.int64)
            if m.op == "first":
                idx = np.minimum.reduceat(
                    arange if valid is None
                    else np.where(valid, arange, n), starts)
                empty = idx >= n
            else:
                idx = np.maximum.reduceat(
                    arange if valid is None
                    else np.where(valid, arange, -1), starts)
                empty = idx < 0
            vals = d[np.clip(idx, 0, n - 1)].astype(np.float64, copy=False)
            if empty.any():
                vals = vals.copy()
                vals[empty] = np.nan
            r = vals
        elif m.op in ("sum", "sum_sq", "min", "max", "reset_corr"):
            dv = d.astype(np.float64, copy=False)
            if m.op == "sum":
                r = np.add.reduceat(
                    dv if valid is None else np.where(valid, dv, 0.0),
                    starts)
            elif m.op == "sum_sq":
                sq = dv * dv
                r = np.add.reduceat(
                    sq if valid is None else np.where(valid, sq, 0.0),
                    starts)
            elif m.op == "min":
                r = np.minimum.reduceat(
                    dv if valid is None else np.where(valid, dv, f64max),
                    starts)
            elif m.op == "max":
                r = np.maximum.reduceat(
                    dv if valid is None else np.where(valid, dv, -f64max),
                    starts)
            else:
                # PromQL counter-reset correction: for each adjacent
                # VALID sample pair within a run where the later value
                # is smaller, the pre-reset value contributes
                # (ops/window.py: `where(pair_ok & (v < prev), prev, 0)`)
                if arange is None:
                    arange = np.arange(n, dtype=np.int64)
                runid = np.repeat(np.arange(len(starts), dtype=np.int64),
                                  np.diff(starts, append=n))
                idx = arange if valid is None else np.nonzero(valid)[0]
                drop = np.zeros(n, dtype=np.float64)
                if len(idx) > 1:
                    prev_i, cur_i = idx[:-1], idx[1:]
                    hit = (runid[cur_i] == runid[prev_i]) & \
                        (dv[cur_i] < dv[prev_i])
                    drop[cur_i] = np.where(hit, dv[prev_i], 0.0)
                r = np.add.reduceat(drop, starts)
        else:  # pragma: no cover — the planner emits only the ops above
            raise UnsupportedError(f"host moment op {m.op!r}")
        frame[m.slot] = r
    frame["__rowcount"] = counts
    df = pd.DataFrame(frame)[live]
    return df if len(df) else None


# ---------------------------------------------------------------------------
# staging a slice on the card
# ---------------------------------------------------------------------------

_ALIGN = 256                          # device offsets: any dtype's alignment


class _Stager:
    """A pinned host buffer and a side stream of one device: a slice's
    mirrors are packed into the buffer, copied to the card in one
    non_blocking copy on the side stream, and an event marks the copy's
    end. The buffer is refilled only after that event (the copy reads
    it), and grows, never shrinks: cudaHostAlloc is slow, so stagers are
    pooled across slices and queries (`_STAGERS`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.host: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None

    def stage(self, items: List[Tuple[str, np.ndarray, np.dtype]]):
        """({key: device tensor}, device buffer, event) for `items`
        (key, host array, device dtype): each array converted into the
        pinned buffer, one copy to the card."""
        offs, total = [], 0
        for _, a, dt in items:
            offs.append(total)
            total += -(-len(a) * np.dtype(dt).itemsize // _ALIGN) * _ALIGN
        if self.event is not None:
            self.event.synchronize()     # the last copy out of the buffer
        if self.host is None or self.host.numel() < total:
            self.host = None
            self.host = torch.empty(total + total // 4, dtype=torch.uint8,
                                    pin_memory=True)
        hb = self.host.numpy()
        for (_, a, dt), off in zip(items, offs):
            dst = hb[off:off + len(a) * np.dtype(dt).itemsize].view(dt)
            np.copyto(dst, a, casting="unsafe")
        with torch.cuda.stream(self.stream):
            buf = torch.empty(total, dtype=torch.uint8, device=self.device)
            buf.copy_(self.host[:total], non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)
        views = {}
        for (key, a, dt), off in zip(items, offs):
            nb = len(a) * np.dtype(dt).itemsize
            views[key] = buf[off:off + nb].view(_TORCH_DTYPES[np.dtype(dt)])
        return views, buf, self.event


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}
_STAGERS: List[_Stager] = tracked_state([], "query.stream_exec.stagers")


def _stage_slice(scan, plan, schema) -> Tuple[torch.Tensor, object]:
    """Upload the mirrors `tpu_exec._launch_scan_kernel` reads for this
    plan (ts, all-valid mask, each moment column in its device dtype and
    its validity) into `scan.mirrors`; returns (device buffer, event) for
    the launching stream to wait on."""
    from .tpu_exec import mirror_values
    n = scan.num_rows
    items = [("__ts", scan.host_ts(), np.int32),
             ("__all_valid", np.ones(n, dtype=bool), np.bool_)]
    seen = set()
    for m in plan.moments:
        col = m.column
        if col is None:
            continue
        vals, valid = scan.fields[col]
        if m.op == "sum_sq" and vals.dtype == np.uint32:
            if f"f32:{col}" not in seen:
                items.append((f"f32:{col}", vals, np.float32))
                seen.add(f"f32:{col}")
        elif not (schema.column_schema(col).dtype.is_string or
                  schema.column_schema(col).dtype.is_binary) and \
                m.op not in ("min_ts", "max_ts") and f"f:{col}" not in seen:
            v = vals if vals.dtype == np.float64 else mirror_values(vals)
            items.append((f"f:{col}", v,
                          np.float32 if v.dtype == np.float64 else v.dtype))
            seen.add(f"f:{col}")
        if valid is not None and f"v:{col}" not in seen:
            items.append((f"v:{col}", valid, np.bool_))
            seen.add(f"v:{col}")
    with _STAGERS_LOCK:
        st = next((s for s in _STAGERS if s.device == scan.torch_device),
                  None)
        if st is not None:
            _STAGERS.remove(st)
    if st is None:
        st = _Stager(scan.torch_device)
    try:
        views, buf, event = st.stage(items)
    finally:
        with _STAGERS_LOCK:
            _STAGERS.append(st)
    scan.mirrors.update(views)
    return buf, event


def _load_slice(snap, dim: str, lo: int, hi: int, unit, needed_fields,
                series_dict, time_range: Optional[TimestampRange],
                plan, reduce: str, device, sid_keys: bool = False,
                sid_set: Optional[np.ndarray] = None):
    """Read + merge + dedup one slice; reduce it on the host (partial
    moment frames) or prepare it for the kernel (a transient MergedScan
    with its mirrors staged on the card).

    Returns None for an empty slice, else ``(kind, payload, info)``:
    kind "frames" (lean path), "frame" (host-reduced general path) or
    "scan" (payload: the MergedScan and its staging (device buffer,
    event), or None when the mirrors upload at launch); `info` carries
    rows and the lean_slices / merged_slices / dedup_skip_slices facts.

    `dim` selects the partition axis: "time" slices [lo, hi) on the time
    index, "series" on __series_id (the query's time filter still prunes
    files and row groups). Before reading anything the slice is tested
    against its file metadata (_slice_lean_proof): when no key can have
    two versions the merge-dedup is skipped, and when besides the plan
    never consults row times and every file sits inside the slice, the
    ts column is never decoded."""
    from .tpu_exec import MergedScan

    skip_dedup = covered = False
    lean_files: list = []
    if reduce == "host":
        skip_dedup, covered, lean_files = _slice_lean_proof(
            snap, dim, lo, hi, unit, time_range)
    need_ts = True
    if skip_dedup:
        need_ts = _plan_needs_ts(plan) or not covered
        if covered:
            lean = _lean_chunk_frames(
                snap, snap._region.access_layer, lean_files, dim, lo, hi,
                needed_fields, plan, series_dict, need_ts,
                sid_keys=sid_keys, sid_set=sid_set)
            if lean is not None:
                frames, rows_read = lean
                return ("frames", frames,
                        {"rows": rows_read, "lean_slices": 1,
                         "dedup_skip_slices": 1})
    if dim == "series":
        data = snap.scan(projection=needed_fields, series_range=(lo, hi),
                         time_range=time_range, sid_set=sid_set,
                         synthetic_seq=True,
                         need_ts=need_ts, need_mvcc=not skip_dedup)
    else:
        data = snap.scan(projection=needed_fields,
                         time_range=TimestampRange(lo, hi, unit),
                         sid_set=sid_set, synthetic_seq=True,
                         need_ts=need_ts, need_mvcc=not skip_dedup)
    if data.num_rows == 0:
        return None
    # the dedup-skip proof guarantees every row survives, not that the
    # concatenated runs are (sid, ts)-sorted (two key-disjoint files may
    # share a boundary sid): first/last are positional, so they still go
    # through _slice_dedup's sortedness check
    positional = any(m.op in ("first", "last")
                     for m in plan.moments if m.column is not None)
    kept = None if (skip_dedup and not positional) else _slice_dedup(data)
    info = {"rows": data.num_rows,
            "merged_slices": 0 if skip_dedup else 1,
            "dedup_skip_slices": int(skip_dedup)}
    if reduce == "host":
        return ("frame",
                _host_partial_frame(data, kept, plan, series_dict,
                                    sid_keys=sid_keys), info)
    if kept is not None and len(kept) == 0:
        return None

    def take(a):
        return a if kept is None else a[kept]

    ts = take(data.ts)
    fields = {name: (take(d), None if vd is None
                     else _all_or_none(take(vd)))
              for name, (d, vd) in data.fields.items()}
    scan = MergedScan(take(data.series_ids).astype(np.int32, copy=False),
                      ts, fields, series_dict, int(ts.min()),
                      torch.device(device))
    staged = None
    if scan.torch_device.type == "cuda":
        try:
            staged = _stage_slice(scan, plan, snap.schema)
        except Exception:  # noqa: BLE001 — the mirrors then upload at
            # launch, still to the card; chip_smoke.py requires 0 here
            increment_counter("stream_device_stage_errors")
            scan.mirrors.clear()
    return ("scan", (scan, staged), info)


def _all_or_none(valid: np.ndarray) -> Optional[np.ndarray]:
    """A slice field's validity, or None when every row is valid (the
    column then shares the one all-valid device mask)."""
    return None if valid.all() else valid


def stream_region_moment_frames(region, plan,
                                device) -> List[pd.DataFrame]:
    """Partial moment frames of one region by slice streaming, in the
    frame shape tpu_exec._execute_region produces, so tpu_exec._finalize
    folds slices as it folds regions.

    Slices decode two deep on a prefetch pool while this thread reduces
    or launches the current one. In "device" mode each non-empty slice
    launches segment_moments once over its staged mirrors; every launch's
    results come back in one device-to-host copy at the end. Publishes
    the stages (slice_plan, decode_reduce, fold, device_fetch) and
    counters (slices, lean_slices, merged_slices, dedup_skip_slices,
    device_slices) to `region.last_scan_profile` and ExecStats."""
    from .tpu_exec import (_collect_moment_frame, _fetch_launched,
                           _launch_scan_kernel, plan_needs_host,
                           plan_scan_columns)

    prof = ScanProfile(path="streamed")
    t_start = time.perf_counter()
    snap = region.snapshot()
    schema = snap.schema
    tc = schema.timestamp_column
    unit = tc.dtype.time_unit if tc is not None else None
    stats = _region_slice_stats(region, snap)
    with _STAGERS_LOCK:
        slice_rows, cold_reduce = _SLICE_ROWS[0], _COLD_REDUCE[0]
    jobs = _plan_jobs(stats, slice_rows, plan.time_lo, plan.time_hi,
                      unit) if stats else []
    prof.mark("slice_plan", time.perf_counter() - t_start)
    prof.bump("slices", len(jobs))
    exec_stats.record("slice_plan", elapsed_s=prof.stages["slice_plan"],
                      slices=len(jobs))

    def done(frames: List[pd.DataFrame]) -> List[pd.DataFrame]:
        prof.total_s = time.perf_counter() - t_start
        region.last_scan_profile = prof
        return frames

    if not jobs:
        return done([])
    needed = plan_scan_columns(plan, schema)
    sd = region.series_dict

    # point/IN tag conjuncts resolve to a candidate sid set, so every
    # slice prunes SSTs through their index sidecars before decoding
    sid_set = None
    if plan.tag_predicates and sd is not None and sd.tag_names:
        from ..storage.index import sst_index_enabled
        if sst_index_enabled():
            from ..mito.engine import sid_candidates_for_filters
            sid_set = sid_candidates_for_filters(sd, sd.tag_names,
                                                 plan.tag_predicates)
            if sid_set is not None and len(sid_set) == 0:
                return done([])          # the predicate matches no series

    mode = "host" if plan_needs_host(plan) else cold_reduce
    sid_keys = mode == "host" and _sid_keyed(plan)
    launched = []
    frames: List[pd.DataFrame] = []
    depth = 2
    t_stream = time.perf_counter()
    load = propagate(_load_slice)

    def submit(pool, job):
        dim, lo, hi, clip = job
        return pool.submit(load, snap, dim, lo, hi, unit, needed, sd, clip,
                           plan, mode, device, sid_keys, sid_set)

    with span("stream_scan", region=region.name, slices=len(jobs),
              mode=mode), \
            transient_executor(depth, "stream-scan") as pool:
        futs = [submit(pool, job) for job in jobs[:depth]]
        try:
            for i in range(len(jobs)):
                # cooperative KILL at the slice boundary: prefetched
                # slices are cancelled below, so a killed scan releases
                # its workers within one slice
                process_list.check_cancelled()
                failpoint.fail_point("stream_slice")
                res = futs[i].result()
                if i + depth < len(jobs):
                    futs.append(submit(pool, jobs[i + depth]))
                futs[i] = None               # free the slice as we go
                if res is None:
                    prof.bump("empty_slices")
                    continue
                kind, payload, info = res
                prof.rows += info.get("rows", 0)
                for k in ("lean_slices", "merged_slices",
                          "dedup_skip_slices"):
                    if info.get(k):
                        prof.bump(k, info[k])
                if kind == "frames":
                    frames.extend(payload)
                    continue
                if kind == "frame":
                    if payload is not None and len(payload):
                        frames.append(payload)
                    continue
                prof.bump("device_slices")
                scan, staged = payload
                if staged is not None:
                    # the launch reads what the side stream copied
                    buf, event = staged
                    cur = torch.cuda.current_stream(buf.device)
                    cur.wait_event(event)
                    buf.record_stream(cur)
                ln = _launch_scan_kernel(scan, schema, plan, prof)
                if ln is not None:
                    launched.append(ln)
                del payload, res, scan, staged
        finally:
            # a raise (KILL, a failed slice) must not leave prefetched
            # slices occupying the pool: unstarted futures cancel now
            for f in futs:
                if f is not None:
                    f.cancel()
    prof.mark("decode_reduce", time.perf_counter() - t_stream)
    _publish_stream_stats(prof)
    if sid_keys and frames:
        t_fold = time.perf_counter()
        frames = _fold_sid_frames(frames, plan, sd)
        prof.mark("fold", time.perf_counter() - t_fold)
        exec_stats.record("fold", elapsed_s=prof.stages["fold"])
    if not launched:
        return done(frames)
    t_fetch = time.perf_counter()
    for ln, (counts, res_np, live) in zip(launched,
                                          _fetch_launched(launched, plan)):
        part = _collect_moment_frame(ln, plan, counts, res_np, live)
        if part is not None and len(part):
            frames.append(part)
    prof.mark("device_fetch", time.perf_counter() - t_fetch)
    exec_stats.record("device_fetch", elapsed_s=prof.stages["device_fetch"])
    return done(frames)


def _publish_stream_stats(prof) -> None:
    """Mirror a streamed region's profile into the ExecStats collector
    (stream_scan row) and the Prometheus counters."""
    exec_stats.record(
        "stream_scan", rows=prof.rows,
        elapsed_s=prof.stages.get("decode_reduce", 0.0),
        **{k: v for k, v in prof.counters.items() if v})
    for k in ("lean_slices", "merged_slices", "dedup_skip_slices"):
        n = prof.counters.get(k, 0)
        if n:
            increment_counter(f"stream_{k}", n)
