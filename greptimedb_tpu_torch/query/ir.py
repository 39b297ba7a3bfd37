"""One columnar plan IR: the lowering target of the front ends.

Reference behavior: src/query — the reference plans SQL and PromQL into
one DataFusion LogicalPlan. Here (as in greptimedb_tpu/query/ir.py):

- `TpuPlan` (query/tpu_exec.py) — the aggregate node: time range, tag
  predicates, group keys (tags + one time bucket) and moment specs. SQL
  lowers into it through `plan_for`, other front ends through
  `plan_from_specs`; `execute_agg_plan` below is the one executor:
  a distributed table (frontend/distributed.py) scatters the plan through
  `DistTable.execute_tpu_plan` (the datanodes reduce their surviving
  regions on their devices), a local table's regions reduce on the
  engine's device (tpu_exec.region_moment_frames); `_finalize` folds the
  moment frames either way.
- `RawScan` — the scan leaf for statements that do not lower: a projected,
  filtered, time-bounded `scan_batches` (`execute_raw_scan`) that still
  rides region pruning and wire filter pushdown on distributed tables.

query/plan_codec.py is the wire codec for the aggregate node (the
frontend→datanode boundary).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from ..common import exec_stats
from ..common.telemetry import increment_counter, span, timer
from ..errors import SketchCodecError, UnsupportedError
from .tpu_exec import (
    BucketGroup,
    Moment,
    TagGroup,
    TpuPlan,
    _aggs_desc,
    _finalize,
    _note_device_query_time,
    dispatch_decision_for_pushdown,
    frames_nbytes,
    region_moment_frames,
    standard_final,
)

__all__ = [
    "BucketGroup", "Moment", "RawScan", "TagGroup", "TpuPlan",
    "execute_agg_plan", "execute_raw_scan", "group_key_columns",
    "plan_from_specs",
]


def group_key_columns(plan: TpuPlan) -> List[str]:
    """The finalized frame's key column names, in key order."""
    from .planner import _group_slot
    cols = [_group_slot(t.name) for t in plan.tag_groups]
    if plan.bucket is not None:
        cols.append(_group_slot(plan.bucket.expr_key))
    return cols


# ---------------------------------------------------------------------------
# raw-scan leaf
# ---------------------------------------------------------------------------

@dataclass
class RawScan:
    """The row-path scan leaf: what a non-lowerable statement still
    pushes down — a projection, conjunctive filters and a half-open
    time range. `DistTable.scan_batches` prunes regions and ships the
    pushable filter subset over the wire; local tables serve it from
    their region scans."""

    projection: Optional[List[str]] = None
    time_range: Optional[Tuple[Optional[int], Optional[int]]] = None
    filters: List = field(default_factory=list)
    limit: Optional[int] = None

    def describe(self) -> str:
        proj = "*" if self.projection is None \
            else ", ".join(self.projection)
        parts = [f"project=[{proj}]"]
        if self.time_range is not None:
            parts.append(f"time=[{self.time_range[0]}, "
                         f"{self.time_range[1]})")
        if self.filters:
            parts.append(f"filters={len(self.filters)}")
        if self.limit is not None:
            parts.append(f"limit={self.limit}")
        return f"RawScan: {' '.join(parts)}"


def execute_raw_scan(table, scan: RawScan) -> list:
    """Run the scan leaf against any table shape (local mito table or
    DistTable — both speak the scan_batches protocol)."""
    return table.scan_batches(projection=scan.projection,
                              time_range=scan.time_range,
                              limit=scan.limit,
                              filters=scan.filters or None)


# ---------------------------------------------------------------------------
# building the aggregate node from explicit specs (non-SQL front ends)
# ---------------------------------------------------------------------------

def plan_from_specs(schema, aggs: Sequence[Tuple[str, str, Optional[str]]],
                    *, group_tags: Sequence[str] = (),
                    bucket: Optional[BucketGroup] = None,
                    time_lo: Optional[int] = None,
                    time_hi: Optional[int] = None,
                    tag_predicates: Sequence = (),
                    moment_specs: Sequence[Tuple[str, str, Optional[str]]]
                    = ()) -> TpuPlan:
    """Build a TpuPlan from explicit (dest, op, column) aggregate specs
    (SQL goes through `plan_for`, which maps the AST onto the same
    `standard_final`, so the lowerings cannot drift).

    `aggs` ops use the standard vocabulary (sum/avg/min/max/count/
    first/last/stddev/variance); `moment_specs` requests raw merged
    moments (dest, moment op, column) finalized via passthrough.
    Moments are deduped across both lists."""
    tag_names = schema.tag_names()
    for t in group_tags:
        if t not in tag_names:
            raise UnsupportedError(f"unknown group tag {t!r}")
    tag_groups = [TagGroup(t, tag_names.index(t)) for t in group_tags]

    moments: List[Moment] = []
    seen: Dict[tuple, str] = {}

    def moment(op: str, column: Optional[str]) -> str:
        k = (op, column)
        if k in seen:
            return seen[k]
        slot = f"__m{len(moments)}"
        moments.append(Moment(op, column, slot))
        seen[k] = slot
        return slot

    finals: List[Tuple[str, str, List[str]]] = []
    for dest, op, col in aggs:
        std = standard_final(op, col, moment)
        if std is None:
            raise UnsupportedError(
                f"aggregate {op!r} has no moment decomposition")
        finals.append((dest, std[0], std[1]))
    for dest, mop, col in moment_specs:
        finals.append((dest, "moment", [moment(mop, col)]))
    return TpuPlan(tag_groups, bucket, moments, finals, time_lo, time_hi,
                   list(tag_predicates), [], {}, {})


# ---------------------------------------------------------------------------
# the aggregate-node executor
# ---------------------------------------------------------------------------

def execute_agg_plan(table, plan: TpuPlan, device) -> pd.DataFrame:
    """Execute the IR aggregate node and return the finalized frame
    (group key columns + final slots). A distributed table scatters the
    plan through its cost-based `_plan_scatter` (the datanodes reduce on
    their own devices, the frontend folds moment frames); a local table's
    regions reduce on `device` through the resident, streamed or
    indexed-point path (tpu_exec.region_moment_frames). Raises
    UnsupportedError when the statement should degrade to the raw-row
    path — cost-based dispatch chose raw-pull, a datanode rejected a plan
    it cannot fold, or a sketch partial failed to decode — never a wrong
    answer."""
    if hasattr(table, "execute_tpu_plan"):
        # distributed: aggregate pushdown. The table names its own
        # scatter (pruning + fan-out), so EXPLAIN and execution print the
        # same decision
        exec_stats.set_dispatch(dispatch_decision_for_pushdown(table, plan))
        with span("tpu_pushdown", table=table.name), timer("tpu_pushdown"):
            frames = [f for f in table.execute_tpu_plan(plan)
                      if f is not None and len(f)]
    else:
        t0 = time.perf_counter()
        with span("tpu_execute", table=table.name), timer("tpu_execute"):
            frames = region_moment_frames(table, plan, device)
        _note_device_query_time(time.perf_counter() - t0)
    if not frames:
        cols = group_key_columns(plan)
        if cols:
            return pd.DataFrame(columns=cols +
                                [slot for slot, _, _ in plan.finals])
        # global aggregate over zero rows still yields one row
        row = {slot: (0 if op in ("count", "count_distinct",
                                  "approx_distinct") else np.nan)
               for slot, op, _ in plan.finals}
        return pd.DataFrame([row])
    with exec_stats.stage("finalize", partial_frames=len(frames),
                          partial_bytes=frames_nbytes(frames),
                          aggs=_aggs_desc(plan)):
        merged = pd.concat(frames, ignore_index=True)
        try:
            out = _finalize(merged, plan)
        except SketchCodecError as e:
            # a corrupt/truncated sketch partial must never become a
            # wrong answer: count the degrade and fall back to the
            # raw-row path (the caller re-runs this statement as a
            # plain scan + CPU aggregate)
            increment_counter("sketch_degrade")
            exec_stats.record("sketch_degrade", error=str(e)[:120])
            logging.getLogger(__name__).warning(
                "sketch partial failed to decode (%s); retrying %s via "
                "the raw-row path", e, table.name)
            raise UnsupportedError(
                f"sketch partial failed to decode: {e}") from e
    exec_stats.record("finalize", rows=len(out))
    return out
