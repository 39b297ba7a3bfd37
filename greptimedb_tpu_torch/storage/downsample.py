"""Downsampling: aggregate a region's rows into coarser time buckets.

Ported from greptimedb_tpu/storage/downsample.py. The maintenance job of
BASELINE config 5 (1 s → 1 m downsample): every (series, bucket) group of
a region is reduced with the sorted-segment moment kernel
(ops/kernels.py `sorted_grouped_aggregate`, csrc/segment_moments.cu) and
written into a destination whose time index carries the bucket
timestamps. The continuous-flow subsystem (flow/manager.py) drives the
same reducer incrementally from a per-flow watermark.

The job rides the same merged-scan cache the query path uses
(`query/tpu_exec.SCAN_CACHE`): on a region that has been queried (or
downsampled) before, the sorted and deduplicated columns and their
device mirrors are already resident, and the job ships only the row
mask of a time range and the run ends. The run ends are found on the
host and the kernel reads each run's bounds from them, so it launches
over exactly the region's runs (no shape-bucket padding, no run-id
upload: first/last order by ts inside a run's bounds). The runs the
mask keeps a row of are known on the host too; the launch is
asynchronous, the tag decode of their destination rows overlaps it,
and one device-to-host copy brings their results back.

Field mirrors are the query path's (`tpu_exec.mirror_values`): float32,
int32 for BIGINT that fits and the narrow integers; a uint32 column's
mirror is biased by -2^31, so its sum and avg read the float32 mirror
and its min/max/first/last are un-biased on the host.

Each call leaves its stages on `src.last_scan_profile` (path
"flow-fold"): scan_prep (the cache lookup, or the merged scan it
builds), runs (host run ends and the time-range mask), launch (mirrors,
uploads and the kernel call's host time), tags (destination keys, while
the device computes), fetch (the one device-to-host copy, which waits
for the kernel) and sink_write (the destination insert).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.kernels import sorted_grouped_aggregate

logger = logging.getLogger(__name__)

_SUPPORTED = ("avg", "sum", "min", "max", "count", "first", "last")

#: one output column: (destination column name, op, source field or None).
#: A None source means count-rows — the op must be "count" (count(*)).
AggSpec = Tuple[str, str, Optional[str]]

#: uint32 mirrors ride as int32 values v - 2^31 (query/tpu_exec.py)
_U32_BIAS = 1 << 31


def _normalize_aggs(src_schema, aggs: Union[None, Dict[str, str],
                                            Sequence[AggSpec]]
                    ) -> List[AggSpec]:
    """Accept the legacy field→op dict (dest column = field name) or the
    flow-style (dest, op, src) triples; default to avg of every numeric
    field."""
    if aggs is None:
        fields = [c.name for c in src_schema.field_columns()
                  if not src_schema.column_schema(c.name).dtype.is_string]
        return [(f, "avg", f) for f in fields]
    if isinstance(aggs, dict):
        return [(f, op, f) for f, op in aggs.items()]
    return [tuple(a) for a in aggs]


def downsample_region(src, dst, *, stride_ms: int,
                      aggs: Union[None, Dict[str, str],
                                  Sequence[AggSpec]] = None,
                      time_range=None, origin_ms: int = 0,
                      device="cuda", prof=None) -> int:
    """Aggregate `src` rows into `stride_ms` buckets and write to `dst`,
    reducing on `device` ("cuda" unless the caller asks for "cpu").

    `dst` may be a Region (direct WriteBatch) or a Table — a partitioned
    table routes destination rows through its partition rule
    (partition/splitter.py), so multi-region rollup tables work.
    Re-running over an already-folded window is idempotent: bucket rows
    carry the same (tags, bucket_ts) key, so MVCC dedup keeps the newest
    fold. Returns the number of bucket rows written. `prof` (a
    ScanProfile) takes this call's stages on top of the caller's."""
    from ..query.tpu_exec import SCAN_CACHE
    from .region import ScanProfile
    from .write_batch import WriteBatch

    schema = src.schema
    agg_specs = _normalize_aggs(schema, aggs)
    for dest, op, col in agg_specs:
        if op not in _SUPPORTED:
            raise ValueError(f"unsupported downsample op {op}")
        if col is None and op != "count":
            raise ValueError(f"{op} needs a source column")

    if prof is None:
        prof = ScanProfile(path="flow-fold")
    t0 = time.perf_counter()
    # merged + MVCC-deduped view, sorted by (series, ts); PUT rows only
    # (tombstones are dropped by the merge). Device mirrors of ts/fields
    # are cached per region version and shared with the query path.
    scan = SCAN_CACHE.get(src, device, prof)
    prof.bump(f"cache_{SCAN_CACHE.last_outcome()}")
    n = scan.num_rows
    prof.rows = n
    t1 = time.perf_counter()
    prof.mark("scan_prep", t1 - t0)
    if n == 0:
        return _done(src, prof, t0, 0)
    sids, ts = scan.series_ids, scan.ts

    mask_np = None
    if time_range is not None:
        mask_np = np.ones(n, dtype=bool)
        if time_range.start is not None:
            mask_np &= ts >= time_range.start
        if time_range.end is not None:
            mask_np &= ts < time_range.end
        if not mask_np.any():
            return _done(src, prof, t0, 0)

    # runs over (series, bucket): rows are sorted by (series, ts), so
    # pair changes are run boundaries — a vectorized host pass, and the
    # run ends ship with the call
    buckets = (ts - origin_ms) // stride_ms
    flags = np.empty(n, dtype=bool)
    flags[0] = True
    np.not_equal(sids[1:], sids[:-1], out=flags[1:])
    flags[1:] |= buckets[1:] != buckets[:-1]
    run_starts = np.nonzero(flags)[0]
    nruns = len(run_starts)
    run_ends = np.empty(nruns, dtype=np.int32)
    run_ends[:-1] = run_starts[1:]
    run_ends[-1] = n
    # a run is written when the mask keeps a row of it (the kernel's row
    # count > 0), known here before the launch
    live = np.logical_or.reduceat(mask_np, run_starts) \
        if mask_np is not None else np.ones(nruns, dtype=bool)
    t2 = time.perf_counter()
    prof.mark("runs", t2 - t1)

    d_mask = scan.to_device(mask_np) if mask_np is not None \
        else scan.device_valid_all()
    d_ts = scan.device_ts()
    values, col_masks, ops, slots, unbias = [], [], [], [], []
    for dest, op, col in agg_specs:
        u32 = False
        if col is None:
            values.append(d_ts)            # count(*): mask-only reduce
            col_masks.append(scan.device_valid_all())
        else:
            if op == "count":
                values.append(d_ts)
            elif scan.fields[col][0].dtype == np.uint32:
                # sums read un-biased float32; order picks un-bias after
                u32 = op in ("min", "max", "first", "last")
                values.append(scan.device_field(col) if u32
                              else scan.device_field_f32(col))
            else:
                values.append(scan.device_field(col))
            col_masks.append(scan.device_valid(col))
        ops.append(op)
        slots.append(dest)
        unbias.append(u32)
    results, _ = sorted_grouped_aggregate(
        None, d_mask, d_ts, tuple(values), tuple(col_masks),
        num_groups=nruns, ops=tuple(ops), has_col_masks=True,
        ends=scan.to_device(run_ends))
    # one device-to-host copy of the live runs' results (int32 moments
    # are exact in float64)
    d_live = scan.to_device(np.nonzero(live)[0]) \
        if mask_np is not None else None
    stacked = torch.stack([r.to(torch.float64) for r in results])
    if d_live is not None:
        stacked = stacked[:, d_live]
    t3 = time.perf_counter()
    prof.mark("launch", t3 - t2)

    # destination keys while the device computes; the fetch below is the
    # only synchronization point
    out_sids = sids[run_starts[live]]
    cols: Dict[str, object] = {}
    sd = src.series_dict
    for i, tag in enumerate(sd.tag_names):
        cols[tag] = sd.decode_tag_column(out_sids, i)
    ts_name = dst.schema.timestamp_column.name
    cols[ts_name] = buckets[run_starts[live]] * stride_ms + origin_ms
    t4 = time.perf_counter()
    prof.mark("tags", t4 - t3)
    host = stacked.cpu().numpy()
    t5 = time.perf_counter()
    prof.mark("fetch", t5 - t4)

    n_out = len(out_sids)
    for k, (dest, u32) in enumerate(zip(slots, unbias)):
        vals = host[k]
        if u32:
            vals = vals + _U32_BIAS
        nan = np.isnan(vals)
        cols[dest] = vals if not nan.any() else \
            [None if m else float(v) for v, m in zip(vals, nan)]

    if hasattr(dst, "regions"):
        # table destination: insert() splits rows per the partition rule
        dst.insert(cols)
    else:
        wb = WriteBatch(dst.schema)
        wb.put(cols)
        dst.write(wb)
    prof.mark("sink_write", time.perf_counter() - t5)
    logger.info("downsampled %s -> %s: %d rows into %d buckets (stride %dms)",
                src.name, getattr(dst, "name", dst.info.name
                                  if hasattr(dst, "info") else "?"),
                n, n_out, stride_ms)
    return _done(src, prof, t0, n_out)


def _done(src, prof, t0: float, n_out: int) -> int:
    prof.total_s += time.perf_counter() - t0
    prof.bump("buckets", n_out)
    src.last_scan_profile = prof
    return n_out
