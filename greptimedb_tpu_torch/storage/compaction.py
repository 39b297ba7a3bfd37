"""Time-window compaction with TTL expiry.

Reference behavior: src/storage/src/compaction/ — `SimplePicker` selects a
region's L0 files and expired files (TTL, picker.rs:57-90);
`SimpleTimeWindowStrategy` buckets them by an inferred time window
(strategy.rs:36-120); `CompactionTaskImpl` merges each bucket through the
region's reader into L1 outputs and commits one RegionEdit.

Deltas (as in greptimedb_tpu/storage/compaction.py): inputs are read as
SoA columns and merged with the sort-based merge/dedup (one sort +
keep-mask, ops.kernels.merge_dedup_numpy — the same merge the scan path
runs) instead of the reference's heap-based k-way MergeReader; each
time-window bucket is written as one L1 Parquet file whose rows stay
(series, ts, seq)-sorted so scans consume them directly.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.kernels import merge_dedup_numpy
from .sst import FileMeta

logger = logging.getLogger(__name__)

# window candidates (seconds), smallest that covers the span is chosen
# (reference: strategy.rs TIME_BUCKETS)
TIME_BUCKETS_S = [3600, 2 * 3600, 12 * 3600, 24 * 3600, 7 * 24 * 3600]


def infer_time_bucket_ms(span_ms: int) -> int:
    for b in TIME_BUCKETS_S:
        if span_ms <= b * 1000:
            return b * 1000
    return TIME_BUCKETS_S[-1] * 1000


@dataclass
class CompactionPlan:
    inputs: List[FileMeta]            # files merged into L1
    expired: List[FileMeta]           # dropped wholesale (TTL)
    window_ms: int


def pick_compaction(ssts, *, ttl_ms: Optional[int] = None,
                    now_ms: Optional[int] = None,
                    min_l0_files: int = 1,
                    time_window_ms: Optional[int] = None
                    ) -> Optional[CompactionPlan]:
    """Select L0 files (and TTL-expired files at any level) for one
    compaction run. Returns None when there is nothing to do."""
    now_ms = int(time.time() * 1000) if now_ms is None else now_ms
    expired: List[FileMeta] = []
    if ttl_ms is not None:
        cutoff = now_ms - ttl_ms
        expired = [f for f in ssts.all_files() if f.time_range[1] < cutoff]
    expired_names = {f.file_name for f in expired}
    l0 = [f for f in ssts.levels[0] if f.file_name not in expired_names]
    if len(l0) < min_l0_files and not expired:
        return None
    if not l0 and not expired:
        return None
    window = time_window_ms
    if window is None:
        if l0:
            lo = min(f.time_range[0] for f in l0)
            hi = max(f.time_range[1] for f in l0)
            window = infer_time_bucket_ms(hi - lo + 1)
        else:
            window = TIME_BUCKETS_S[0] * 1000
    return CompactionPlan(inputs=l0, expired=expired, window_ms=window)


def run_compaction(region, plan: CompactionPlan,
                   *, ttl_ms: Optional[int] = None,
                   now_ms: Optional[int] = None) -> List[FileMeta]:
    """Merge the plan's input files into per-window L1 SSTs and commit the
    edit. Returns the new files. Safe to run while writes continue: inputs
    are immutable SSTs; the version/manifest swap happens under the region
    writer lock."""
    if not plan.inputs and not plan.expired:
        return []
    from ..common import background_jobs
    from ..common.telemetry import increment_counter, span, timer
    with background_jobs.job("compaction", region=region.name,
                             inputs=len(plan.inputs),
                             expired=len(plan.expired)), \
            span("compaction", region=region.name,
                 inputs=len(plan.inputs), expired=len(plan.expired)), \
            timer("compaction"):
        out = _run_compaction_inner(region, plan, ttl_ms=ttl_ms,
                                    now_ms=now_ms)
    increment_counter("compaction_runs")
    increment_counter("compaction_files_in", len(plan.inputs))
    increment_counter("compaction_files_out", len(out))
    return out


def _run_compaction_inner(region, plan: CompactionPlan,
                          *, ttl_ms: Optional[int] = None,
                          now_ms: Optional[int] = None) -> List[FileMeta]:
    now_ms = int(time.time() * 1000) if now_ms is None else now_ms
    al = region.access_layer
    schema = region.schema
    field_names = [c.name for c in schema.field_columns()]

    # trivial move (RocksDB-style): time-disjoint L0 files cannot hold
    # competing versions of any (series, ts) key, so re-levelling them is
    # a metadata-only edit — no read, no merge, no rewrite. This is the
    # common case for in-order telemetry (every flush/bulk-load covers a
    # fresh window) and keeps sustained ingest from paying a full region
    # rewrite every max_l0_files batches.
    if plan.inputs and not plan.expired and ttl_ms is None:
        from dataclasses import replace as _dc_replace
        by_lo = sorted(plan.inputs, key=lambda f: f.time_range[0])
        disjoint = all(
            not by_lo[i].keys_overlap(by_lo[j])
            for i in range(len(by_lo)) for j in range(i + 1, len(by_lo)))
        if disjoint:
            moved = [_dc_replace(f, level=1) for f in by_lo]
            region.commit_compaction(
                removed=[f.file_name for f in by_lo], added=moved,
                purge=False)
            logger.info("region %s trivially moved %d disjoint L0 files "
                        "to L1", region.name, len(moved))
            return moved

    retracts = bool(plan.expired)
    new_files: List[FileMeta] = []
    if plan.inputs:
        # overlap input decode: parquet reads drop the GIL, so concurrent
        # readers hide IO + decompression behind each other (reference's
        # parallel compaction readers, strategy.rs:36-120)
        from ..common.runtime import parallel_map
        datas = [d for d in parallel_map(al.read_sst, plan.inputs)
                 if d.num_rows]
        if datas:
            sids = np.concatenate([d.series_ids for d in datas])
            ts = np.concatenate([d.ts for d in datas])
            seq = np.concatenate([d.seq for d in datas])
            op = np.concatenate([d.op_types for d in datas])
            fields: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
            for name in field_names:
                cols = [d.fields[name] for d in datas]
                data = np.concatenate([c[0] for c in cols])
                if any(c[1] is not None for c in cols):
                    valid = np.concatenate([
                        c[1] if c[1] is not None
                        else np.ones(len(c[0]), dtype=bool) for c in cols])
                else:
                    valid = None
                fields[name] = (data, valid)
            # L1 collapses MVCC history: keep the newest row per (series, ts)
            # (delete tombstones survive as rows — older L1 files may still
            # hold versions of the key they must shadow)
            kept = merge_dedup_numpy(sids, ts, seq, op, keep_deletes=True)
            sids, ts, seq, op = sids[kept], ts[kept], seq[kept], op[kept]
            fields = {n: (d[kept], v[kept] if v is not None else None)
                      for n, (d, v) in fields.items()}
            if ttl_ms is not None:
                live = ts >= (now_ms - ttl_ms)
                if not live.all():
                    retracts = True
                    sids, ts, seq, op = (a[live] for a in (sids, ts, seq, op))
                    fields = {n: (d[live], v[live] if v is not None else None)
                              for n, (d, v) in fields.items()}
            if len(ts):
                # bucket rows by time window → one sorted L1 file per bucket;
                # encode+write buckets concurrently (zstd/parquet encode
                # drops the GIL) so output IO overlaps encoding
                buckets = ts // plan.window_ms

                def _write_bucket(b):
                    m = buckets == b
                    bs, bt, bq, bo = sids[m], ts[m], seq[m], op[m]
                    bf = {n: (d[m], v[m] if v is not None else None)
                          for n, (d, v) in fields.items()}
                    tag_cols = {
                        name: region.series_dict.decode_tag_column(bs, i)
                        for i, name in
                        enumerate(region.series_dict.tag_names)}
                    return al.write_sst(level=1, series_ids=bs, ts=bt,
                                        seq=bq, op_types=bo, fields=bf,
                                        tag_columns=tag_cols, schema=schema)

                from ..common.runtime import parallel_map
                metas = parallel_map(_write_bucket, np.unique(buckets))
                new_files.extend(m for m in metas if m is not None)

    removed = [f.file_name for f in plan.inputs] + \
        [f.file_name for f in plan.expired]
    region.commit_compaction(removed=removed, added=new_files,
                             retracts=retracts)
    logger.info("region %s compacted %d inputs (+%d expired) -> %d L1 files",
                region.name, len(plan.inputs), len(plan.expired),
                len(new_files))
    return new_files
