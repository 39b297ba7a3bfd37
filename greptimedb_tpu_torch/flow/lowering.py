"""Flow folds lowered onto the columnar plan IR (query/ir.py).

Reference behavior: GreptimeDB's flow engine plans its continuous
aggregates through the same query engine as ad-hoc SQL. Here a
FlowSpec's aggregates compile into the same `TpuPlan` SQL and PromQL
lower into, so folds ride every fast path the IR executor owns:

- **region-backed sources** fold through the device sorted-segment
  reducer (storage/downsample.py) with sequence watermarks — the
  device rollup path — or, for a region past the streaming threshold,
  through a window-bounded host fold (fold_region_cold);
- **distributed sources** (DistTables) ship the TpuPlan through
  `execute_tpu_plan`: datanodes reduce their regions and the frontend
  folds *moment frames*, never raw samples, riding cost-based scatter
  and per-SST pruning. Shapes the scatter declines (cost-based
  raw-pull, version-skewed datanodes) degrade to a raw scan + host
  reduce — slower, never wrong.

This module is the ONE place under flow/ that touches storage regions,
the device scan cache or raw scan_batches; FlowManager (manager.py) owns
lifecycle/watermark policy and delegates every data access here.

Ported from greptimedb_tpu/flow/lowering.py. Every fold reduces on the
device the FlowManager passes in; a source without local regions (a
DistTable) folds through fold_generic / _ir_fold, whose plan the
datanodes reduce.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np

from ..common.time import TimestampRange

logger = logging.getLogger(__name__)

#: the bucket expression key flow plans use (any stable name works; it
#: only namespaces the finalized frame's bucket column)
FLOW_BUCKET_KEY = "__flow_bucket"


def set_wm(spec, key: str, val: dict) -> None:
    """Atomic watermark update: readers (SHOW FLOWS, metrics) iterate
    spec.watermarks without the fold lock, so mutate by swapping in a
    fresh dict instead of inserting into the live one."""
    spec.watermarks = {**spec.watermarks, key: val}


def source_counters(src):
    """The source's storage regions when sequence counters exist
    locally, else None (DistTables / non-region tables)."""
    if src is None:
        return None
    regions = getattr(src, "regions", None)
    if not regions or any(
            getattr(r, "version_control", None) is None
            for r in regions.values()):
        return None
    return regions


def source_lagging(spec, regions) -> bool:
    """Sequence-counter freshness probe over a region-backed source."""
    for region in regions.values():
        wm = spec.watermarks.get(region.name, {})
        if region.version_control.committed_sequence > \
                wm.get("seq", -1):
            return True
    return False


def fold_source(spec, src, dst, device) -> Tuple[int, int]:
    """Route one fold to the right executor: local region-backed
    sources take the sequence-watermarked device fold; everything else
    (DistTables) lowers onto the IR. Returns (buckets written,
    source rows folded)."""
    regions = getattr(src, "regions", None)
    local = bool(regions) and all(
        hasattr(r, "snapshot") and hasattr(r, "series_dict")
        for r in regions.values())
    if local:
        return fold_local(spec, src, dst, device)
    return fold_generic(spec, src, dst, device)


# ---------------------------------------------------------------------------
# local region-backed fold (device rollup)
# ---------------------------------------------------------------------------

def fold_local(spec, src, dst, device) -> Tuple[int, int]:
    """Region-backed source: sequence-watermarked incremental fold via
    the device sorted-segment reducer. Regions past the streaming
    threshold never enter the scan cache — they take a window-bounded
    host fold instead (fold_region_cold), the same residency rule the
    query path applies."""
    import time

    from ..query.tpu_exec import SCAN_CACHE, region_streams_cold
    from ..storage.downsample import downsample_region
    from ..storage.region import ScanProfile
    agg_specs = [(a.dest, a.op, a.column) for a in spec.aggs]
    written = new_total = 0
    for region in src.regions.values():
        snap = region.snapshot()
        visible = snap.visible_sequence
        wm = spec.watermarks.get(region.name, {})
        wm_seq = wm.get("seq", -1)
        if visible <= wm_seq:
            continue                   # nothing committed since last fold
        if region_streams_cold(region):
            w, n = fold_region_cold(spec, region, snap, dst, wm)
            written += w
            new_total += n
            continue
        prof = ScanProfile(path="flow-fold")
        t0 = time.perf_counter()
        scan = SCAN_CACHE.get(region, device, prof)
        prof.bump(f"cache_{SCAN_CACHE.last_outcome()}")
        prof.mark("scan_prep", time.perf_counter() - t0)
        prof.total_s = time.perf_counter() - t0
        if scan.num_rows == 0:
            if wm.get("rows"):
                # everything this region ever folded was deleted:
                # drop its sink rows (ghost buckets would diverge
                # from the raw scan)
                retract_stale_sink_rows(spec, region, dst, scan)
            set_wm(spec, region.name, {
                "seq": int(visible), "ts": wm.get("ts"), "rows": 0})
            continue
        retracted = False
        if scan.seq is not None and wm_seq >= 0:
            new = scan.seq > wm_seq
            n_new = int(new.sum())
            # retraction probe: the count of still-live rows at or
            # below the watermark must match what the last fold saw —
            # a shrink means a DELETE (or in-place overwrite) removed
            # already-folded rows, possibly in buckets older than any
            # new row (tombstones vanish in the merged scan, so the
            # seq filter alone cannot see them)
            expected_old = wm.get("rows")
            retracted = expected_old is not None and \
                scan.num_rows - n_new != expected_old
            if n_new == 0 and not retracted:
                set_wm(spec, region.name, {
                    "seq": int(visible), "ts": wm.get("ts"),
                    "rows": int(scan.num_rows)})
                continue
            if n_new:
                ts_max = int(scan.ts[new].max())
            else:
                ts_max = wm.get("ts")
            if retracted:
                # re-fold the whole region so retracted buckets
                # correct themselves; fully-emptied buckets are
                # deleted from the sink below
                from ..common.telemetry import increment_counter
                increment_counter("flow_retraction_refolds")
                rng = None
            else:
                ts_min = int(scan.ts[new].min())
                # re-fold from the boundary of the earliest touched
                # bucket: a partially-folded top-of-bucket is
                # overwritten in place
                lo = ((ts_min - spec.origin_ms) // spec.stride_ms) \
                    * spec.stride_ms + spec.origin_ms
                rng = TimestampRange(lo, None)
        else:
            # first fold (or no sequence column): fold everything
            n_new = scan.num_rows
            ts_max = int(scan.ts.max())
            rng = None
        written += downsample_region(
            region, dst, stride_ms=spec.stride_ms,
            aggs=agg_specs, time_range=rng,
            origin_ms=spec.origin_ms, device=device, prof=prof)
        if retracted:
            retract_stale_sink_rows(spec, region, dst, scan)
        prev_ts = wm.get("ts")
        if ts_max is None:
            ts_max = prev_ts
        set_wm(spec, region.name, {
            "seq": int(visible),
            "ts": max(ts_max, prev_ts)
            if prev_ts is not None and ts_max is not None else ts_max,
            "rows": int(scan.num_rows)})
        new_total += n_new
    return written, new_total


def retract_stale_sink_rows(spec, region, dst, scan) -> None:
    """Full-bucket DELETE retraction: remove sink rows owned by this
    region's series whose bucket no longer holds any live source row
    — a refold alone cannot emit them, so ghost buckets would make
    rollup answers diverge from the raw scan. The sink is rollup-
    sized (stride× smaller), so the scan here is cheap relative to
    the retraction refold that triggered it."""
    sd = region.series_dict
    tag_names = list(sd.tag_names)
    nt = len(tag_names)
    if scan.num_rows:
        buckets = ((scan.ts - spec.origin_ms) // spec.stride_ms) \
            * spec.stride_ms + spec.origin_ms
        live_cols = [sd.decode_tag_column(scan.series_ids, i)
                     for i in range(nt)]
        live = set(zip(*live_cols, buckets.tolist()))
    else:
        live = set()
    # ownership filter: every series this region has ever encoded —
    # a multi-region (tag-partitioned) source must never delete a
    # sibling region's sink rows
    ids = np.arange(sd.num_series, dtype=np.int32)
    own_cols = [sd.decode_tag_column(ids, i) for i in range(nt)]
    owned = set(zip(*own_cols)) if nt else {()}
    need = tag_names + [spec.ts_column]
    to_del: Dict[str, list] = {c: [] for c in need}
    for b in dst.scan_batches(projection=need):
        d = b.to_pydict()
        for vals in zip(*(d[c] for c in need)):
            tags_t = tuple(vals[:nt])
            if tags_t not in owned:
                continue
            if tags_t + (vals[nt],) not in live:
                for c, v in zip(need, vals):
                    to_del[c].append(v)
    n = len(to_del[spec.ts_column])
    if n:
        dst.delete(to_del)
        from ..common.telemetry import increment_counter
        increment_counter("flow_sink_rows_retracted", n)
        logger.info("flow %s: retracted %d emptied bucket row(s) "
                    "from %s", spec.key, n, spec.sink)


def fold_region_cold(spec, region, snap, dst, wm: dict) -> Tuple[int, int]:
    """Host fold of one over-threshold region: a merged read bounded
    to the refold window (the data tail past the ts watermark), never
    touching the scan cache or device memory. Timestamp-watermarked,
    so it shares fold_generic's documented out-of-order limit and
    has no retraction probe ("rows" stays unset)."""
    import time

    import pandas as pd

    from ..storage.region import ScanProfile
    prof = ScanProfile(path="flow-fold-cold")
    t0 = time.perf_counter()
    visible = snap.visible_sequence
    wm_ts = wm.get("ts")
    rng = None
    if wm_ts is not None:
        lo = ((wm_ts - spec.origin_ms) // spec.stride_ms) \
            * spec.stride_ms + spec.origin_ms
        rng = TimestampRange(lo, None)
    need = sorted({a.column for a in spec.aggs
                   if a.column is not None})
    data = snap.read_merged(projection=need, time_range=rng)
    prof.rows = data.num_rows
    t1 = time.perf_counter()
    prof.mark("read_merged", t1 - t0)
    if data.num_rows == 0:
        set_wm(spec, region.name,
               {"seq": int(visible), "ts": wm_ts})
        prof.total_s = time.perf_counter() - t0
        region.last_scan_profile = prof
        return 0, 0
    cols = {}
    sd = data.series_dict
    for i, tag in enumerate(sd.tag_names):
        cols[tag] = sd.decode_tag_column(data.series_ids, i)
    cols[spec.ts_column] = data.ts
    for name, (vals, valid) in data.fields.items():
        if valid is None:
            cols[name] = vals
        elif vals.dtype == object:     # count over a string column
            arr = vals.copy()
            arr[~valid] = None
            cols[name] = arr
        else:
            arr = vals.astype(np.float64)
            arr[~valid] = np.nan
            cols[name] = arr
    df = pd.DataFrame(cols)
    out_cols = reduce_frame(spec, df)
    t2 = time.perf_counter()
    prof.mark("reduce", t2 - t1)
    dst.insert(out_cols)
    prof.mark("sink_write", time.perf_counter() - t2)
    prof.total_s = time.perf_counter() - t0
    region.last_scan_profile = prof
    ts_max = int(data.ts.max())
    set_wm(spec, region.name, {
        "seq": int(visible),
        "ts": max(ts_max, wm_ts) if wm_ts is not None else ts_max})
    n_buckets = len(out_cols[spec.ts_column])
    return n_buckets, int(data.num_rows)


# ---------------------------------------------------------------------------
# generic fold (DistTables): moment frames first, raw rows as fallback
# ---------------------------------------------------------------------------

def fold_plan(spec, schema, lo_ms: Optional[int]):
    """Compile the FlowSpec's aggregates into the IR aggregate node —
    the same TpuPlan SQL and PromQL lower into. A hidden count(*)
    rides along so the fold can report rows folded without a second
    scan."""
    from ..query import ir
    aggs = [("__rows", "count", None)] + \
        [(a.dest, a.op, a.column) for a in spec.aggs]
    return ir.plan_from_specs(
        schema, aggs, group_tags=list(spec.tags),
        bucket=ir.BucketGroup(spec.stride_ms, spec.origin_ms,
                              FLOW_BUCKET_KEY),
        time_lo=lo_ms)


def _ir_fold(spec, src, dst, lo_ms: Optional[int], device
             ) -> Tuple[int, int, Optional[int]]:
    """One IR fold: datanodes reduce, the frontend folds moment frames
    and writes finalized buckets to the sink. Raises UnsupportedError
    when the plan should degrade to the raw path."""
    from ..query import ir
    from ..query.planner import _group_slot
    plan = fold_plan(spec, src.schema, lo_ms)
    df = ir.execute_agg_plan(src, plan, device)
    rows = df["__rows"].to_numpy() if "__rows" in df else np.array([])
    df = df[rows > 0] if len(df) else df
    if not len(df):
        return 0, 0, None
    cols: Dict[str, object] = {
        t: df[_group_slot(t)].tolist() for t in spec.tags}
    buckets = df[_group_slot(FLOW_BUCKET_KEY)].astype(np.int64).to_numpy()
    cols[spec.ts_column] = buckets
    for a in spec.aggs:
        vals = df[a.dest].astype(np.float64)
        nan = vals.isna()
        cols[a.dest] = [None if m else float(v)
                        for v, m in zip(vals, nan)] \
            if nan.any() else vals.to_numpy()
    dst.insert(cols)
    n_new = int(df["__rows"].sum())
    # the watermark only ever rounds DOWN to its bucket boundary, so
    # the max bucket start is as good as the max raw timestamp
    return len(buckets), n_new, int(buckets.max())


def fold_generic(spec, src, dst, device) -> Tuple[int, int]:
    """Fold a source without local storage regions (distributed
    frontends). Lowerable specs ride the IR: the plan scatters through
    `execute_tpu_plan` and only moment frames cross the wire. When the
    scatter declines (cost-based raw-pull, version-skewed datanode,
    `SET dist_partial_agg = 0`) the fold degrades to scan_batches over
    the refold window + a host reduce — same answer, more bytes.

    Known limit of the ts watermark: with no per-row sequence to
    consult, a row arriving LATER than the watermark bucket (out of
    order by more than one stride) is not re-folded — the sink keeps
    the earlier fold for that bucket until a wider refold. The local
    region path does not have this gap (its watermark is the
    committed sequence)."""
    import pandas as pd

    from ..errors import UnsupportedError
    wm = spec.watermarks.get("__table__", {})
    wm_ts = wm.get("ts")
    lo = None
    if wm_ts is not None:
        lo = ((wm_ts - spec.origin_ms) // spec.stride_ms) \
            * spec.stride_ms + spec.origin_ms
    if hasattr(src, "execute_tpu_plan"):
        try:
            written, n_new, ts_max = _ir_fold(spec, src, dst, lo, device)
            if ts_max is None:
                return 0, 0
            prev = wm.get("ts")
            set_wm(spec, "__table__", {
                "seq": -1, "ts": max(ts_max, prev)
                if prev is not None else ts_max})
            return written, n_new
        except UnsupportedError as e:
            from ..common.telemetry import increment_counter
            increment_counter("flow_ir_fold_degrades")
            logger.info("flow %s: IR fold degraded to raw scan (%s)",
                        spec.key, e)
    rng = TimestampRange(lo, None) if lo is not None else None
    need = list(spec.tags) + [spec.ts_column] + sorted(
        {a.column for a in spec.aggs if a.column is not None})
    batches = src.scan_batches(projection=need, time_range=rng)
    frames = [pd.DataFrame(b.to_pydict()) for b in batches
              if b.num_rows]
    if not frames:
        return 0, 0
    df = pd.concat(frames, ignore_index=True)
    n_new = len(df)
    cols = reduce_frame(spec, df)
    dst.insert(cols)
    ts_max = int(df[spec.ts_column].max())
    prev = wm.get("ts")
    set_wm(spec, "__table__", {
        "seq": -1, "ts": max(ts_max, prev) if prev is not None
        else ts_max})
    return len(cols[spec.ts_column]), n_new


def reduce_frame(spec, df) -> Dict[str, object]:
    """Host twin of the device fold: bucket + groupby over a frame of
    raw rows, returning the sink column dict (shared by the generic
    and cold-region fold paths)."""
    import pandas as pd
    bucket = ((df[spec.ts_column].astype(np.int64) - spec.origin_ms)
              // spec.stride_ms) * spec.stride_ms + spec.origin_ms
    df = df.assign(__bucket=bucket)
    df = df.sort_values(spec.ts_column, kind="stable")
    keys = list(spec.tags) + ["__bucket"]
    gb = df.groupby(keys, dropna=False, sort=False)
    res = {}
    for a in spec.aggs:
        if a.column is None:
            res[a.dest] = gb.size().astype(np.float64)
            continue
        s = gb[a.column]
        if a.op == "sum":
            r = s.sum(min_count=1)
        elif a.op == "avg":
            r = s.mean()
        elif a.op == "count":
            r = s.count().astype(np.float64)
        elif a.op == "min":
            r = s.min()
        elif a.op == "max":
            r = s.max()
        elif a.op == "first":
            r = s.first()
        else:
            r = s.last()
        res[a.dest] = r
    out = pd.DataFrame(res).reset_index()
    cols: Dict[str, object] = {t: out[t].tolist() for t in spec.tags}
    cols[spec.ts_column] = out["__bucket"].astype(np.int64).to_numpy()
    for a in spec.aggs:
        vals = out[a.dest].astype(np.float64)
        nan = vals.isna()
        cols[a.dest] = [None if m else float(v)
                        for v, m in zip(vals, nan)] \
            if nan.any() else vals.to_numpy()
    return cols
