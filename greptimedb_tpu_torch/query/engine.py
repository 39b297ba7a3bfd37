"""QueryEngine: statement dispatch, CPU fallback executor, GPU fast path.

Reference behavior: src/query/src/datafusion.rs — the engine optimizes and
executes logical plans, streaming record batches. Here (as in
greptimedb_tpu/query/engine.py) `execute` dispatches on statement type;
SELECTs try the device aggregate path first (tpu_exec.try_execute, on the
engine's device, or the datanodes' for a distributed table) and otherwise
run the pandas columnar fallback, which threads the WHERE conjuncts and a
safe LIMIT into a distributed table's scan.

Ported: SELECT (with joins, UNION, uncorrelated subqueries and window
functions, which run in pandas), EXPLAIN / EXPLAIN ANALYZE, SHOW,
DESCRIBE, information_schema and the flow rollup rewrite (flow/rewrite.py:
a compatible `GROUP BY date_bin` is re-targeted at a flow's rollup sink
after a refresh fold, and EXPLAIN names it as the `rollup-rewrite`
dispatch).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd
import torch

from ..catalog import CatalogManager
from ..common import exec_stats
from ..common.telemetry import span
from ..common.time import TimeUnit
from ..datatypes import data_type as dt
from ..datatypes.data_type import parse_type_name
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import ColumnSchema, Schema
from ..errors import (
    ColumnNotFoundError, PlanError, TableNotFoundError, UnsupportedError)
from ..session import QueryContext
from ..sql.ast import (
    Column, DescribeTable, Explain, Expr, FunctionCall, InList, Literal,
    Query, SetQuery, ShowCreateTable, ShowDatabases, ShowProcessList,
    ShowTables, ShowVariable, Star, Statement, TableRef, WindowSpec)
from ..table.table import Table
from .expr import Evaluator, expr_name
from .functions import AGGREGATE_FUNCTIONS
from .output import Output
from .planner import (Analysis, analyze, convert_time_literals,
                      _group_slot)
from . import show as show_impl
from . import tpu_exec


class QueryEngine:
    """Executes read statements against the catalog on `device` ("cuda"
    unless the caller asks for "cpu")."""

    def __init__(self, catalog: CatalogManager, device="cuda"):
        self.catalog = catalog
        self.device = torch.device(device)
        #: ExecStats of the most recent top-level query this thread ran —
        #: the slow-query log and EXPLAIN ANALYZE read it (diagnostic only;
        #: a concurrent server sees the latest finished query's stats)
        self.last_exec_stats: Optional[exec_stats.ExecStats] = None
        #: set by the hosting instance when flows exist; enables the
        #: transparent rollup rewrite (flow/rewrite.py)
        self.flow_manager = None

    # ---- dispatch ----
    def execute(self, stmt: Statement, ctx: Optional[QueryContext] = None
                ) -> Output:
        ctx = ctx or QueryContext()
        if isinstance(stmt, Query):
            return self.execute_query(stmt, ctx)
        if isinstance(stmt, SetQuery):
            return self.execute_set_query(stmt, ctx)
        if isinstance(stmt, ShowDatabases):
            return show_impl.show_databases(self, stmt, ctx)
        if isinstance(stmt, ShowTables):
            return show_impl.show_tables(self, stmt, ctx)
        if isinstance(stmt, ShowCreateTable):
            return show_impl.show_create_table(self, stmt, ctx)
        if isinstance(stmt, ShowVariable):
            return show_impl.show_variable(self, stmt, ctx)
        if isinstance(stmt, ShowProcessList):
            return show_impl.show_processlist(self, stmt, ctx)
        if isinstance(stmt, DescribeTable):
            return show_impl.describe_table(self, stmt, ctx)
        if isinstance(stmt, Explain):
            return self.explain(stmt, ctx)
        raise UnsupportedError(
            f"query engine cannot execute {type(stmt).__name__}")

    def resolve_table(self, ref, ctx: QueryContext) -> Table:
        if isinstance(ref, TableRef):
            ref = ref.name
        catalog, schema, name = ctx.resolve(ref)
        if schema.lower() == "information_schema":
            from ..catalog.information_schema import (
                information_schema_table)
            virtual = information_schema_table(self.catalog, catalog, name)
            if virtual is not None:
                return virtual
        table = self.catalog.table(catalog, schema, name)
        if table is None:
            raise TableNotFoundError(
                f"table {catalog}.{schema}.{name} not found")
        return table

    # ---- EXPLAIN ----
    def explain(self, stmt: Explain, ctx: QueryContext) -> Output:
        inner = stmt.statement
        lines: List[str] = []
        if isinstance(inner, Query):
            a = analyze(inner)
            table = None
            if inner.from_ is not None and inner.from_.name is not None:
                table = self.resolve_table(inner.from_, ctx)
            # rollup rewrite first (no fold on plain EXPLAIN): the plan
            # below then describes the statement actually executed —
            # against the flow sink — with the rewrite as the dispatch.
            # `inner` stays the original so EXPLAIN ANALYZE re-enters the
            # execution path (which rewrites again, with a refresh fold).
            pq, rollup_note = inner, None
            if table is not None:
                # same literal→timestamp coercion the execution path
                # applies, so the explained dispatch (incl. the rewrite's
                # aligned-time-range check) matches the executed one
                inner.where = convert_time_literals(inner.where,
                                                    table.schema)
                rw = self._maybe_rollup_rewrite(table, a, inner, ctx,
                                                refresh=False)
                if rw is not None:
                    table, pq, a, rollup_note = rw
            plan = tpu_exec.plan_for(table, a, pq) if table else None
            if plan is not None:
                # pin the dispatch decision (sqlness explain goldens):
                # pushdown / cpu-small-scan / streamed-cold / resident.
                # Uses the STATIC dispatch floor, not the latency-adaptive
                # one (_dispatch_min_rows), so the plan text is
                # deterministic across processes and runs.
                est = tpu_exec._estimated_table_rows(table)
                if hasattr(table, "execute_tpu_plan"):
                    lines.append("TpuAggregateExec: " + plan.describe())
                    lines.append(
                        "  Dispatch: " +
                        tpu_exec.dispatch_decision_for_pushdown(table,
                                                                plan))
                elif est is not None and \
                        est < tpu_exec.TPU_DISPATCH_MIN_ROWS:
                    lines.append("CpuAggregateExec: " + plan.describe())
                    lines.append(
                        f"  Dispatch: cpu-small-scan (est_rows={est} < "
                        f"dispatch_floor={tpu_exec.TPU_DISPATCH_MIN_ROWS})")
                else:
                    # mirror execution exactly: the decision string is
                    # built by the same helper region_moment_frames
                    # records into ExecStats (per-REGION decision, on
                    # rows OR decoded-bytes vs the scan-cache budget)
                    lines.append("TpuAggregateExec: " + plan.describe())
                    lines.append("  Dispatch: " +
                                 tpu_exec.local_dispatch_decision(
                                     table, plan=plan))
            elif a.is_aggregate:
                lines.append("CpuAggregateExec: groups=" + ", ".join(
                    expr_name(g) for g in a.group_exprs))
            else:
                lines.append("CpuProjectionExec")
            if rollup_note is not None:
                # the rewrite is the outermost dispatch decision; the
                # underlying device/CPU decision for the sink follows
                lines.insert(1, f"  Dispatch: rollup-rewrite "
                                f"({rollup_note})")
            if pq.where is not None:
                lines.append("  Filter: " + expr_name(pq.where))
            if table is not None:
                lines.append(f"  TableScan: {table.name}")
        else:
            lines.append(type(inner).__name__)
        if stmt.analyze:
            return self._explain_analyze(inner, lines, ctx)
        schema = Schema([ColumnSchema("plan_type", dt.STRING),
                         ColumnSchema("plan", dt.STRING)])
        rb = RecordBatch.from_pydict(schema, {
            "plan_type": ["logical_plan"], "plan": ["\n".join(lines)]})
        return Output.record_batches([rb])

    def _explain_analyze(self, inner, plan_lines: List[str],
                         ctx: QueryContext) -> Output:
        """EXPLAIN ANALYZE: actually execute the statement under an
        ExecStats collector and render the per-stage breakdown — stage,
        rows, files, elapsed ms, and the path facts (dispatch decision,
        lean/dedup-skip vs merged slices, cache hit) under the same
        stage names the storage profilers use, so this table, the
        tracing spans and Region.last_scan_profile agree (reference:
        DataFusion's EXPLAIN ANALYZE over operator metrics)."""
        stats = exec_stats.ExecStats()
        out_rows = 0
        with exec_stats.collect(stats):
            if isinstance(inner, Query):
                out = self._execute_query_inner(inner, ctx)
                out_rows = out.num_rows or 0
        self.last_exec_stats = stats
        cols = stats.rows_table()
        # lead with the plan so the dispatch line stays next to the plan
        # shape it annotates
        cols["stage"].insert(0, "plan")
        cols["rows"].insert(0, out_rows)
        cols["files"].insert(0, 0)
        cols["elapsed_ms"].insert(0, 0.0)
        cols["detail"].insert(0, "\n".join(plan_lines))
        schema = Schema([ColumnSchema("stage", dt.STRING),
                         ColumnSchema("rows", dt.INT64),
                         ColumnSchema("files", dt.INT64),
                         ColumnSchema("elapsed_ms", dt.FLOAT64),
                         ColumnSchema("detail", dt.STRING)])
        rb = RecordBatch.from_pydict(schema, cols)
        return Output.record_batches([rb], schema)

    # ---- SELECT ----
    def execute_query(self, query: Query, ctx: QueryContext) -> Output:
        """Top-level entry installs an ExecStats collector (nested calls —
        subqueries, UNION arms, join sides — record into the active one),
        so every statement leaves a per-stage breakdown behind for the
        slow-query log and EXPLAIN ANALYZE."""
        if exec_stats.current() is not None:
            return self._execute_query_inner(query, ctx)
        with exec_stats.collect() as st:
            out = self._execute_query_inner(query, ctx)
        self.last_exec_stats = st
        return out

    def _execute_query_inner(self, query: Query, ctx: QueryContext
                             ) -> Output:
        from ..common import process_list
        process_list.check_cancelled()     # KILL between sub-statements
        if isinstance(query, SetQuery):     # e.g. a UNION-bodied CTE /
            return self.execute_set_query(query, ctx)  # derived table
        self._rewrite_query_subqueries(query, ctx)
        a = analyze(query)
        if query.joins:
            return self._execute_join(query, a, ctx)

        table: Optional[Table] = None
        if query.from_ is not None:
            if query.from_.subquery is not None:
                inner = self.execute_query(query.from_.subquery, ctx)
                df = _batches_to_df(inner.batches)
                return self._run_on_frame(df, a, query, None)
            table = self.resolve_table(query.from_, ctx)

        if table is None:
            df = pd.DataFrame(index=[0])
            return self._run_on_frame(df, a, query, None)

        # literal→timestamp coercion needs the table schema, so it runs
        # post-resolution (reference: TypeConversionRule, optimizer.rs:33)
        query.where = convert_time_literals(query.where, table.schema)

        # transparent rollup rewrite: a compatible GROUP BY date_bin is
        # re-targeted at a flow's rollup sink (after an incremental
        # refresh fold, so answers equal the raw scan); the rewritten
        # statement then takes the normal dispatch chain below
        rw = self._maybe_rollup_rewrite(table, a, query, ctx, refresh=True)
        if rw is not None:
            table, query, a, _ = rw

        # device fast path; HAVING, the projection, ORDER BY, LIMIT and
        # the answer's batch over its frame are the `project` span
        result = tpu_exec.try_execute(table, a, query, self.device)
        if result is not None:
            with span("project"):
                return self._finish_aggregate_frame(result, a, query, table)

        # CPU fallback: the per-version cached frame when the table is
        # region-backed (repeat queries skip scan+convert entirely),
        # else scan the needed columns
        exec_stats.set_dispatch("cpu-fallback")
        cached = True
        with exec_stats.stage("scan"):
            df = tpu_exec.cached_table_frame(table, self.device)
            if df is None:
                cached = False
                needed = None
                if a.column_refs and not self._needs_all(a, query):
                    refs = set(a.column_refs)
                    if any(c.op in ("first", "last")
                           for c in a.agg_calls):
                        # _aggregate sorts by the time index so
                        # first/last are time-ordered — keep it in the
                        # projection even when the query doesn't
                        # reference it
                        tc = table.schema.timestamp_column
                        if tc is not None:
                            refs.add(tc.name)
                    needed = [c for c in table.schema.names()
                              if c in refs]
                if getattr(table, "supports_filter_pushdown", False):
                    # distributed tables: thread the WHERE conjuncts in
                    # (region pruning + wire-side tag filtering) and the
                    # LIMIT when no later stage can change which rows
                    # qualify (_run_on_frame still re-filters/limits —
                    # pushdown only sheds rows, never decides)
                    conj = tpu_exec._conjuncts(query.where)
                    push_limit = None
                    if query.limit is not None and not query.order_by \
                            and not query.distinct and not a.is_aggregate \
                            and not a.window_calls and not query.offset:
                        push_limit = query.limit
                    batches = table.scan_batches(
                        projection=needed, filters=conj or None,
                        limit=push_limit)
                else:
                    batches = table.scan_batches(projection=needed)
                df = _batches_to_df(batches)
        exec_stats.record("scan", rows=len(df), cached=cached)
        return self._run_on_frame(df, a, query, table)

    # ---- rollup rewrite (flows) ----
    def _maybe_rollup_rewrite(self, table, a: Analysis, query: Query,
                              ctx: QueryContext, *, refresh: bool):
        """(table, query, analysis, note) for a flow-sink rewrite of this
        statement, or None. refresh=True first folds source rows past the
        flow's watermark into the sink (skipped for plain EXPLAIN)."""
        manager = self.flow_manager
        if manager is None:
            return None
        import logging

        from ..flow import rewrite as flow_rewrite
        try:
            rw = flow_rewrite.try_rewrite(manager, table, a, query, ctx)
        except Exception:  # noqa: BLE001 — the rewrite must never break
            logging.getLogger(__name__).exception(  # a query; fall back
                "rollup rewrite failed")            # to raw
            return None
        if rw is None:
            return None
        if refresh:
            try:
                manager.refresh(rw.flow)
            except Exception:  # noqa: BLE001 — a sink that cannot catch
                logging.getLogger(__name__).exception(  # up may be
                    "flow %s refresh failed; serving the raw scan",
                    rw.flow.name)     # arbitrarily wrong (even empty):
                return None           # answer from the raw table
        try:
            sink_table = self.resolve_table(rw.query.from_, ctx)
        except TableNotFoundError:
            # sink dropped while the flow still exists: the raw scan
            # must keep answering (fold_flow skips the same way)
            return None
        exec_stats.set_dispatch(f"rollup-rewrite ({rw.note})")
        exec_stats.record("rollup_rewrite", flow=rw.flow.name,
                          sink=rw.sink)
        return sink_table, rw.query, analyze(rw.query), rw.note

    # ---- UNION [ALL] ----
    def execute_set_query(self, sq: SetQuery, ctx: QueryContext) -> Output:
        """Same collector discipline as execute_query: a top-level UNION
        installs one ExecStats for the whole statement so both arms
        record into it."""
        if exec_stats.current() is not None:
            return self._execute_set_query_inner(sq, ctx)
        with exec_stats.collect() as st:
            out = self._execute_set_query_inner(sq, ctx)
        self.last_exec_stats = st
        return out

    def _execute_set_query_inner(self, sq: SetQuery, ctx: QueryContext
                                 ) -> Output:
        left = self.execute(sq.left, ctx)
        right = self.execute(sq.right, ctx)
        if not (left.is_batches and right.is_batches):
            raise PlanError("UNION operands must be queries")
        lb, rb = left.batches, right.batches
        lschema = lb[0].schema if lb else None
        ldf = _batches_to_df(lb)
        rdf = _batches_to_df(rb)
        if len(ldf.columns) != len(rdf.columns):
            raise PlanError(
                f"UNION operands have {len(ldf.columns)} vs "
                f"{len(rdf.columns)} columns")
        rdf.columns = ldf.columns        # names come from the left side
        df = pd.concat([ldf, rdf], ignore_index=True)
        if not sq.all:
            df = df.drop_duplicates()
        if sq.order_by:
            ev = Evaluator(df)
            keys, ascs = [], []
            frame = df.copy()
            for i, (e, asc) in enumerate(sq.order_by):
                name = expr_name(e)
                if name not in frame.columns:
                    v = ev.eval(e)
                    name = f"__uord{i}"
                    frame[name] = v
                keys.append(name)
                ascs.append(asc)
            nulls_spec = getattr(sq, "order_nulls", [])
            sort_cols, sort_asc = [], []
            for i, (name, asc) in enumerate(zip(keys, ascs)):
                nf = nulls_spec[i] if i < len(nulls_spec) else None
                if nf is None:
                    nf = not asc     # Postgres default (see Query sort)
                frame[f"__unull{i}"] = frame[name].isna()
                sort_cols += [f"__unull{i}", name]
                sort_asc += [not nf, asc]
            frame = frame.sort_values(sort_cols, ascending=sort_asc,
                                      kind="stable")
            df = df.loc[frame.index]
        if sq.offset:
            df = df.iloc[sq.offset:]
        if sq.limit is not None:
            df = df.iloc[:sq.limit]
        schema = lschema if lschema is not None and all(
            df[c].dtype == ldf[c].dtype for c in df.columns) else \
            _infer_schema(df, None, {})
        return Output.record_batches([_df_to_batch(df, schema)], schema)

    # ---- joins (CPU fallback; reference delegates to DataFusion's
    # hash joins, src/query/src/datafusion.rs) ----
    def _execute_join(self, query: Query, a: Analysis,
                      ctx: QueryContext) -> Output:
        from ..sql.ast import BinaryOp as B

        sources = [query.from_] + [j.table for j in query.joins]
        frames: List[pd.DataFrame] = []
        aliases: List[str] = []
        for ref in sources:
            if ref.subquery is not None:
                inner = self.execute_query(ref.subquery, ctx)
                df = _batches_to_df(inner.batches)
                alias = ref.alias or f"_sub{len(aliases)}"
            else:
                table = self.resolve_table(ref, ctx)
                df = _batches_to_df(table.scan_batches())
                alias = ref.alias or ref.name.table
            frames.append(df.rename(
                columns={c: f"{alias}.{c}" for c in df.columns}))
            aliases.append(alias)

        def resolve_label(col: Column, columns) -> str:
            if col.table is not None:
                cand = f"{col.table}.{col.name}"
                if cand in columns:
                    return cand
                raise PlanError(f"column {cand!r} not found in join")
            matches = [c for c in columns if c.endswith(f".{col.name}")]
            if len(matches) == 1:
                return matches[0]
            if not matches:
                raise PlanError(f"column {col.name!r} not found in join")
            raise PlanError(f"column {col.name!r} is ambiguous: {matches}")

        joined = frames[0]
        for j, right in zip(query.joins, frames[1:]):
            if j.kind == "cross" or j.on is None:
                if j.kind != "cross" and j.on is None:
                    raise PlanError(f"{j.kind} JOIN requires ON")
                joined = joined.merge(right, how="cross")
                continue
            left_on, right_on, residual = [], [], []
            for c in _conjunct_list(j.on):
                ok = (isinstance(c, B) and c.op == "=" and
                      isinstance(c.left, Column) and
                      isinstance(c.right, Column))
                if ok:
                    l, r = c.left, c.right
                    try:
                        ll = resolve_label(l, joined.columns)
                        rl = resolve_label(r, right.columns)
                    except PlanError:
                        ll = resolve_label(r, joined.columns)
                        rl = resolve_label(l, right.columns)
                    left_on.append(ll)
                    right_on.append(rl)
                else:
                    residual.append(c)
            if not left_on:
                raise UnsupportedError(
                    "JOIN ON must contain at least one equality between "
                    "the joined tables")
            if residual and j.kind != "inner":
                raise UnsupportedError(
                    "non-equi conditions are only supported on INNER JOIN")
            # SQL semantics: NULL = NULL is not true, but pandas merge
            # matches NaN keys to each other. Null-keyed rows are removed
            # from any side whose rows must *match* to survive, and for
            # preserved sides re-enter as unmatched rows.
            lnull = joined[left_on].isna().any(axis=1)
            rnull = right[right_on].isna().any(axis=1)
            if j.kind == "full":
                merged = joined[~lnull].merge(
                    right[~rnull], how="outer", left_on=left_on,
                    right_on=right_on)
                joined = pd.concat(
                    [merged, joined[lnull], right[rnull]],
                    ignore_index=True)
            else:
                lkeys = joined[~lnull] if j.kind in ("inner", "right") \
                    else joined
                rkeys = right[~rnull] if j.kind in ("inner", "left") \
                    else right
                joined = lkeys.merge(rkeys, how=j.kind, left_on=left_on,
                                     right_on=right_on)
            for c in residual:
                ev = Evaluator(joined)
                mask = ev.eval(_qualify_columns(c, joined.columns))
                if isinstance(mask, pd.Series):
                    joined = joined[mask.fillna(False).astype(bool)]
                elif not mask:
                    joined = joined.iloc[0:0]

        # plain names for columns unique across sources (SELECT host, ...)
        plain_counts: Dict[str, int] = {}
        for c in joined.columns:
            plain = c.split(".", 1)[1] if "." in c else c
            plain_counts[plain] = plain_counts.get(plain, 0) + 1
        renames = {c: c.split(".", 1)[1] for c in joined.columns
                   if "." in c and plain_counts[c.split(".", 1)[1]] == 1}
        joined = joined.rename(columns=renames)
        return self._run_on_frame(joined, a, query, None)

    def _needs_all(self, a: Analysis, query: Query) -> bool:
        return any(isinstance(p.expr, Star) for p in query.projections)

    # ---- expression subqueries (IN / EXISTS / scalar) ----
    def _rewrite_query_subqueries(self, query: Query,
                                  ctx: QueryContext) -> None:
        """Execute uncorrelated expression subqueries up front and
        substitute their results as literals. The reference gets these
        from DataFusion's subquery decorrelation; the literal form also
        lets the TPU plan see IN lists as ordinary tag predicates."""
        if query.where is not None:
            query.where = self._rewrite_subqueries(query.where, ctx)
        if query.having is not None:
            query.having = self._rewrite_subqueries(query.having, ctx)
        for item in query.projections:
            item.expr = self._rewrite_subqueries(item.expr, ctx)
        query.group_by = [self._rewrite_subqueries(e, ctx)
                          for e in query.group_by]
        query.order_by = [(self._rewrite_subqueries(e, ctx), asc)
                          for e, asc in query.order_by]

    def _rewrite_subqueries(self, e, ctx: QueryContext):
        from ..sql.ast import Subquery
        if e is None or isinstance(e, (Literal, Column, Star)):
            return e
        if isinstance(e, Subquery):        # scalar subquery
            vals = self._subquery_values(e.query, ctx, what="scalar")
            if len(vals) > 1:
                raise PlanError(
                    "more than one row returned by a scalar subquery")
            return Literal(vals[0] if vals else None)
        if isinstance(e, InList) and any(
                isinstance(i, Subquery) for i in e.items):
            # expand every subquery item in place, keeping literal items
            items: list = []
            has_null = False
            for i in e.items:
                if isinstance(i, Subquery):
                    for v in self._subquery_values(i.query, ctx, what="IN"):
                        if v is None:
                            has_null = True
                        else:
                            items.append(Literal(v))
                else:
                    items.append(self._rewrite_subqueries(i, ctx))
            e.expr = self._rewrite_subqueries(e.expr, ctx)
            if not items and not has_null:
                # IN (empty) is FALSE, NOT IN (empty) is TRUE
                return Literal(bool(e.negated))
            if has_null:
                # three-valued logic: a NULL in the list means "no match"
                # is UNKNOWN, never FALSE — so IN is TRUE-or-NULL and
                # NOT IN is FALSE-or-NULL (kills the whole NOT IN filter)
                from ..sql.ast import Case
                match = InList(e.expr, items, negated=False) if items \
                    else Literal(False)
                hit = Literal(not e.negated)
                return Case(operand=None, whens=[(match, hit)],
                            else_=Literal(None))
            e.items = items
            return e
        if isinstance(e, FunctionCall) and e.name == "exists" and \
                e.args and isinstance(e.args[0], Subquery):
            import copy as _copy
            q = _copy.deepcopy(e.args[0].query)
            self._reject_correlated(q, "EXISTS")
            if isinstance(q, Query) and q.limit is None:
                q.limit = 1                # existence needs one row, but
            try:                           # honor an explicit LIMIT 0
                out = self.execute_query(q, ctx)
            except ColumnNotFoundError as err:
                # an unqualified outer-column reference slipped past the
                # qualified-name check — but this also catches plain
                # typos, so keep the original diagnostic visible
                raise UnsupportedError(
                    "correlated EXISTS subqueries are not supported "
                    f"(if the column is not an outer reference: {err})"
                ) from err
            return Literal(out.num_rows > 0)
        for name, v in vars(e).items():
            if isinstance(v, Expr):
                setattr(e, name, self._rewrite_subqueries(v, ctx))
            elif isinstance(v, WindowSpec):
                v.partition_by = [self._rewrite_subqueries(x, ctx)
                                  for x in v.partition_by]
                v.order_by = [(self._rewrite_subqueries(x, ctx), asc)
                              for x, asc in v.order_by]
            elif isinstance(v, list):
                setattr(e, name, [
                    self._rewrite_subqueries(x, ctx) if isinstance(x, Expr)
                    else tuple(self._rewrite_subqueries(y, ctx)
                               if isinstance(y, Expr) else y for y in x)
                    if isinstance(x, tuple) else x
                    for x in v])
        return e

    def _reject_correlated(self, q, what: str) -> None:
        """Refuse subqueries whose qualified column refs name a table or
        alias not defined inside the subquery itself — those are outer
        references, and running them against inner scope silently drops
        the correlation (the bare-name case resolves innermost-first,
        which matches SQL scoping and needs no check)."""
        defined: set = set()
        quals: set = set()

        def walk_expr(e) -> None:
            if e is None or isinstance(e, (Literal, Star)):
                return
            if isinstance(e, Column):
                if e.table:
                    quals.add(e.table.lower())
                return
            from ..sql.ast import Subquery
            if isinstance(e, Subquery):
                walk_query(e.query)
                return
            for v in vars(e).values():
                if isinstance(v, Expr):
                    walk_expr(v)
                elif isinstance(v, WindowSpec):
                    for x in v.partition_by:
                        walk_expr(x)
                    for x, _ in v.order_by:
                        walk_expr(x)
                elif isinstance(v, list):
                    for x in v:
                        if isinstance(x, Expr):
                            walk_expr(x)
                        elif isinstance(x, tuple):
                            for y in x:
                                if isinstance(y, Expr):
                                    walk_expr(y)

        def walk_query(node) -> None:
            if isinstance(node, SetQuery):
                walk_query(node.left)
                walk_query(node.right)
                for e, _ in node.order_by:
                    walk_expr(e)
                return
            if not isinstance(node, Query):
                return
            for ref in [node.from_] + [j.table for j in node.joins]:
                if ref is None:
                    continue
                if ref.alias:
                    defined.add(ref.alias.lower())
                if ref.name is not None:
                    defined.add(ref.name.table.lower())
                if ref.subquery is not None:
                    walk_query(ref.subquery)
            for item in node.projections:
                walk_expr(item.expr)
            for e in (node.where, node.having):
                walk_expr(e)
            for e in node.group_by:
                walk_expr(e)
            for e, _ in node.order_by:
                walk_expr(e)
            for j in node.joins:
                walk_expr(j.on)

        walk_query(q)
        outer = quals - defined
        if outer:
            raise UnsupportedError(
                f"correlated {what} subqueries are not supported "
                f"(outer reference{'s' if len(outer) > 1 else ''}: "
                f"{', '.join(sorted(outer))})")

    def _subquery_values(self, q: Query, ctx: QueryContext,
                         what: str) -> list:
        """Run an uncorrelated subquery, returning its single column."""
        self._reject_correlated(q, what)
        try:
            out = self.execute_query(q, ctx)
        except ColumnNotFoundError as err:
            raise UnsupportedError(
                f"correlated {what} subqueries are not supported "
                f"(if the column is not an outer reference: {err})"
            ) from err
        cols = out.batches[0].columns if out.batches else []
        if out.batches and len(cols) != 1:
            raise PlanError(
                f"{what} subquery must return exactly one column, "
                f"got {len(cols)}")
        vals: list = []
        for rb in out.batches:
            vals.extend(rb.columns[0].to_pylist())
        return vals

    # ---- fallback execution over a DataFrame ----
    def _run_on_frame(self, df: pd.DataFrame, a: Analysis, query: Query,
                      table: Optional[Table]) -> Output:
        if query.where is not None:
            with exec_stats.stage("filter", rows_in=len(df)):
                ev = Evaluator(df)
                mask = ev.eval(query.where)
                if not isinstance(mask, pd.Series):
                    mask = pd.Series([bool(mask)] * len(df),
                                     index=df.index)
                df = df[mask.fillna(False).astype(bool)]
            exec_stats.record("filter", rows=len(df))

        if a.is_aggregate:
            with exec_stats.stage("aggregate", rows_in=len(df)):
                grouped = self._aggregate(df, a, table)
            exec_stats.record("aggregate", rows=len(grouped))
            return self._finish_aggregate_frame(grouped, a, query, table)

        return self._project_and_finish(df, a, query, table)

    def _aggregate(self, df: pd.DataFrame, a: Analysis,
                   table: Optional[Table]) -> pd.DataFrame:
        ev = Evaluator(df)
        # order rows by time index so first/last are time-ordered
        ts_col = None
        if table is not None:
            tc = table.schema.timestamp_column
            ts_col = tc.name if tc is not None else None
        if ts_col and ts_col in df.columns:
            df = df.sort_values(ts_col, kind="stable")
            ev = Evaluator(df)

        key_cols = []
        for g in a.group_exprs:
            name = _group_slot(expr_name(g))
            df = df.assign(**{name: ev.eval(g)})
            key_cols.append(name)
        ev = Evaluator(df)

        arg_cols = []
        for i, call in enumerate(a.agg_calls):
            cname = f"__arg{i}"
            if call.arg is None:
                df = df.assign(**{cname: np.ones(len(df))})
            else:
                df = df.assign(**{cname: ev.eval(call.arg)})
            arg_cols.append(cname)
            ev = Evaluator(df)

        def compute(group: pd.DataFrame) -> pd.Series:
            out = {}
            for i, call in enumerate(a.agg_calls):
                vals = group[f"__arg{i}"]
                if call.op == "count" and call.arg is None:
                    out[call.slot] = len(group)
                elif call.distinct and call.op == "count":
                    out[call.slot] = int(vals.dropna().nunique())
                elif call.op == "first":
                    nn = vals.dropna()
                    out[call.slot] = nn.iloc[0] if len(nn) else None
                elif call.op == "last":
                    nn = vals.dropna()
                    out[call.slot] = nn.iloc[-1] if len(nn) else None
                else:
                    fn = AGGREGATE_FUNCTIONS.get(call.op)
                    if fn is None:
                        raise UnsupportedError(f"aggregate {call.op!r}")
                    v = vals.dropna() if call.distinct else vals
                    if call.distinct:
                        v = v.drop_duplicates()
                    out[call.slot] = fn(v.to_numpy(), *call.params)
            return pd.Series(out)

        if key_cols:
            if len(df) == 0:
                return pd.DataFrame(columns=key_cols +
                                    [c.slot for c in a.agg_calls])
            fast = self._vectorized_aggregate(df, a, key_cols, arg_cols)
            if fast is not None:
                return fast
            grouped = df.groupby(key_cols, dropna=False, sort=False) \
                .apply(compute, include_groups=False).reset_index()
        else:
            grouped = compute(df).to_frame().T
        return grouped

    #: ops pandas can run as vectorized groupby reductions with matching
    #: NULL semantics (sum over all-null = NULL via min_count, sample
    #: stddev/variance via ddof=1, first/last skip nulls in row order)
    _FAST_GROUP_OPS = frozenset(
        {"count", "sum", "avg", "min", "max", "stddev", "variance",
         "first", "last"})
    _NUMERIC_ONLY_OPS = frozenset({"sum", "avg", "stddev", "variance"})

    def _vectorized_aggregate(self, df: pd.DataFrame, a: Analysis,
                              key_cols, arg_cols) -> Optional[pd.DataFrame]:
        """Vectorized twin of the per-group compute() closure: the
        groupby.apply Python loop dominates small-query latency
        (BASELINE config 1), so the common op set reduces through
        pandas' cython paths instead."""
        for i, call in enumerate(a.agg_calls):
            if call.distinct or call.params or \
                    call.op not in self._FAST_GROUP_OPS:
                return None
            if call.op in self._NUMERIC_ONLY_OPS and not call.is_count_star \
                    and not pd.api.types.is_numeric_dtype(df[f"__arg{i}"]):
                return None
        gb = df.groupby(key_cols, dropna=False, sort=False)
        res = {}
        for i, call in enumerate(a.agg_calls):
            if call.is_count_star:
                res[call.slot] = gb.size()
                continue
            s = gb[f"__arg{i}"]
            op = call.op
            if op == "count":
                r = s.count()
            elif op == "sum":
                r = s.sum(min_count=1)
            elif op == "avg":
                r = s.mean()
            elif op == "min":
                r = s.min()
            elif op == "max":
                r = s.max()
            elif op == "stddev":
                r = s.std(ddof=1)
            elif op == "variance":
                r = s.var(ddof=1)
            elif op == "first":
                r = s.first()
            else:
                r = s.last()
            res[call.slot] = r
        if not res:
            return None
        return pd.DataFrame(res).reset_index()

    def _finish_aggregate_frame(self, grouped: pd.DataFrame, a: Analysis,
                                query: Query, table: Optional[Table]
                                ) -> Output:
        ev = Evaluator(grouped)
        if a.having is not None:
            mask = ev.eval(a.having)
            if isinstance(mask, pd.Series):
                grouped = grouped[mask.fillna(False).astype(bool)]
            elif not mask:
                grouped = grouped.iloc[0:0]
            ev = Evaluator(grouped)
        return self._project_and_finish(grouped, a, query, table,
                                        aggregated=True)

    def _project_and_finish(self, df: pd.DataFrame, a: Analysis, query: Query,
                            table: Optional[Table], aggregated: bool = False
                            ) -> Output:
        if a.window_calls:
            from .window import compute_windows
            # windows over non-aggregate queries follow the time index so
            # unordered specs still see rows in scan order
            ts_col = None
            if not aggregated and table is not None:
                tc = table.schema.timestamp_column
                if tc is not None and tc.name in df.columns:
                    ts_col = tc.name
            if ts_col is not None:
                df = df.sort_values(ts_col, kind="stable")
            df = compute_windows(df, a)
        ev = Evaluator(df)
        out_cols: Dict[str, Any] = {}
        out_names: List[str] = []
        source_cols: Dict[str, Optional[str]] = {}
        dtype_overrides: Dict[str, dt.ConcreteDataType] = {}
        for item in (a.projections if aggregated or a.is_aggregate
                     or a.window_calls else query.projections):
            if isinstance(item.expr, Star):
                cols = list(df.columns) if table is None else \
                    [c for c in table.schema.names() if c in df.columns]
                for c in cols:
                    out_cols[c] = df[c]
                    out_names.append(c)
                    source_cols[c] = c
                continue
            name = item.alias or expr_name(item.expr)
            if aggregated and isinstance(item.expr, Column) and \
                    item.expr.name.startswith("__key__"):
                name = item.alias or item.expr.name[len("__key__"):]
            if name in out_cols:
                # self-join shape: SELECT l.host, r.host — qualify the
                # collision (pandas frames cannot carry duplicate labels)
                qualified = str(item.expr)
                name = qualified if qualified not in out_cols \
                    else f"{name}_{len(out_names)}"
            override = _result_dtype_override(item.expr, a, table)
            if override is not None:
                dtype_overrides[name] = override
            v = ev.eval(item.expr)
            if isinstance(v, pd.Series):
                out_cols[name] = v
            elif isinstance(v, np.ndarray) and v.ndim == 1 and \
                    len(v) == len(df):
                # vectorized evaluators (CAST over a column) may return a
                # bare ndarray — one value per row, not a scalar
                out_cols[name] = pd.Series(v, index=df.index)
            else:
                out_cols[name] = pd.Series([v] * len(df), index=df.index)
            out_names.append(name)
            src = None
            if isinstance(item.expr, Column):
                src = item.expr.name
                if aggregated and src.startswith("__key__"):
                    src = None
            source_cols[name] = src

        proj = pd.DataFrame(out_cols, index=df.index if len(df) else None)
        proj = proj[out_names] if out_names else proj

        if query.distinct:
            proj = proj.drop_duplicates()

        # ORDER BY over the result frame (may reference hidden columns,
        # which are evaluated against the pre-projection frame)
        if query.order_by:
            pairs = a.order_by if (aggregated or a.is_aggregate
                                   or a.window_calls) else query.order_by
            sort_frame = proj.copy()
            keys: List[str] = []
            ascs: List[bool] = []
            base_ev = Evaluator(df)
            for i, (e, asc) in enumerate(pairs):
                target = None
                if isinstance(e, Column) and e.name in proj.columns:
                    target = e.name
                elif expr_name(e) in proj.columns:
                    target = expr_name(e)
                if target is None:
                    target = f"__ord{i}"
                    v = base_ev.eval(e)
                    sort_frame[target] = v if isinstance(v, pd.Series) \
                        else pd.Series([v] * len(sort_frame),
                                       index=sort_frame.index)
                keys.append(target)
                ascs.append(asc)
            if keys and len(sort_frame):
                # per-key NULL placement (pandas has one global
                # na_position): an isna flag key ahead of each value key.
                # Default is the Postgres rule — NULLS LAST for ASC,
                # NULLS FIRST for DESC — overridden by NULLS FIRST/LAST.
                nulls_spec = getattr(query, "order_nulls", [])
                sort_cols: List[str] = []
                sort_asc: List[bool] = []
                for i, (target, asc) in enumerate(zip(keys, ascs)):
                    nf = nulls_spec[i] if i < len(nulls_spec) else None
                    if nf is None:
                        nf = not asc
                    flag = f"__nullord{i}"
                    sort_frame[flag] = sort_frame[target].isna()
                    sort_cols += [flag, target]
                    sort_asc += [not nf, asc]
                sort_frame = sort_frame.sort_values(sort_cols,
                                                    ascending=sort_asc,
                                                    kind="stable")
                proj = proj.loc[sort_frame.index]

        if query.offset:
            proj = proj.iloc[query.offset:]
        if query.limit is not None:
            proj = proj.iloc[:query.limit]

        schema = _infer_schema(proj, table, source_cols, dtype_overrides)
        exec_stats.record("project", rows=len(proj))
        return Output.record_batches([_df_to_batch(proj, schema)], schema)


def _conjunct_list(e):
    from ..sql.ast import BinaryOp
    if isinstance(e, BinaryOp) and e.op == "and":
        return _conjunct_list(e.left) + _conjunct_list(e.right)
    return [e]


def _qualify_columns(e, columns):
    """Rewrite unqualified Columns to the (unique) qualified join label so
    residual ON conditions evaluate against the merged frame."""
    import dataclasses

    from ..sql.ast import Between, BinaryOp, FunctionCall, InList, UnaryOp
    if isinstance(e, Column):
        if e.table is not None:
            return Column(f"{e.table}.{e.name}") \
                if f"{e.table}.{e.name}" in columns else e
        matches = [c for c in columns if c.endswith(f".{e.name}")]
        if len(matches) == 1:
            return Column(matches[0])
        if len(matches) > 1:
            raise PlanError(f"column {e.name!r} is ambiguous: {matches}")
        return e
    if isinstance(e, BinaryOp):
        return dataclasses.replace(
            e, left=_qualify_columns(e.left, columns),
            right=_qualify_columns(e.right, columns))
    if isinstance(e, UnaryOp):
        return dataclasses.replace(
            e, operand=_qualify_columns(e.operand, columns))
    if isinstance(e, FunctionCall):
        return dataclasses.replace(
            e, args=[_qualify_columns(x, columns) for x in e.args])
    if isinstance(e, Between):
        return dataclasses.replace(
            e, expr=_qualify_columns(e.expr, columns),
            low=_qualify_columns(e.low, columns),
            high=_qualify_columns(e.high, columns))
    if isinstance(e, InList):
        return dataclasses.replace(
            e, expr=_qualify_columns(e.expr, columns),
            items=[_qualify_columns(x, columns) for x in e.items])
    return e


# ---------------------------------------------------------------------------
# frame <-> batch conversion
# ---------------------------------------------------------------------------

def _batches_to_df(batches: Optional[List[RecordBatch]]) -> pd.DataFrame:
    if not batches:
        return pd.DataFrame()
    frames = []
    for b in batches:
        df = pd.DataFrame(b.to_pydict())
        if not len(df):
            # an empty pylist column defaults to float64, and a later
            # WHERE re-filter would then compare float64 vs str (pushed
            # tag filters can legitimately empty every batch) — pin
            # string/binary columns to object dtype from the schema
            for cs in b.schema.column_schemas:
                if (cs.dtype.is_string or cs.dtype.is_binary) and \
                        cs.name in df.columns:
                    df[cs.name] = df[cs.name].astype(object)
        frames.append(df)
    df = pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
    return df


def _infer_schema(df: pd.DataFrame, table: Optional[Table],
                  source_cols: Dict[str, Optional[str]],
                  dtype_overrides: Optional[Dict[str, object]] = None
                  ) -> Schema:
    cols = []
    for name in df.columns:
        if dtype_overrides and name in dtype_overrides:
            cols.append(ColumnSchema(name, dtype_overrides[name],
                                     nullable=True))
            continue
        src = source_cols.get(name)
        if table is not None and src is not None and \
                table.schema.contains(src):
            # keep the source dtype but not storage semantics: result sets
            # are not storage tables (a nullable TIME INDEX is invalid)
            cs = table.schema.column_schema(src)
            cols.append(ColumnSchema(name, cs.dtype, nullable=True))
            continue
        cols.append(ColumnSchema(name, _np_to_type(df[name])))
    return Schema(cols)


def _np_to_type(s: pd.Series):
    kind = s.dtype.kind
    if kind == "b":
        return dt.BOOLEAN
    if kind == "i":
        return dt.INT64
    if kind == "u":
        return dt.UINT64
    if kind == "f":
        return dt.FLOAT64
    if kind == "M":
        return dt.TIMESTAMP_MILLISECOND
    return dt.STRING


def _df_to_batch(df: pd.DataFrame, schema: Schema) -> RecordBatch:
    # column-at-a-time vectorized conversion: per-value python loops here
    # used to cost more than the whole streamed fold on wide group-bys
    # (0.37s at 136k output rows)
    from ..datatypes.vector import Vector
    cols = []
    for cs in schema.column_schemas:
        s = df[cs.name]
        if cs.dtype.is_string:
            vals = [None if v is None or (isinstance(v, float) and np.isnan(v))
                    else str(v) if not isinstance(v, str) else v
                    for v in s.tolist()]
            cols.append(Vector.from_pylist(vals, cs.dtype))
        elif s.dtype.kind == "M":
            cols.append(Vector(
                cs.dtype,
                np.ascontiguousarray(s.to_numpy(np.int64) // 1_000_000,
                                     dtype=cs.dtype.np_dtype)))
        elif s.dtype.kind == "f":
            a = s.to_numpy()
            nan = np.isnan(a)
            has_nan = bool(nan.any())
            if cs.dtype.np_dtype.kind in "iu" or cs.dtype.is_timestamp:
                # declared integral (int aggregate / time bucket) but the
                # accumulator ran in float: cast back, NaN -> NULL
                ints = np.round(np.where(nan, 0.0, a)).astype(
                    cs.dtype.np_dtype if cs.dtype.np_dtype is not None
                    else np.int64)
                cols.append(Vector(cs.dtype, ints,
                                   ~nan if has_nan else None))
            else:
                # SQL convention (as in pandas-backed systems): NaN is NULL
                cols.append(Vector(
                    cs.dtype,
                    np.ascontiguousarray(a, dtype=cs.dtype.np_dtype),
                    ~nan if has_nan else None))
        elif s.dtype == object:
            cols.append(Vector.from_pylist(s.tolist(), cs.dtype))
        else:
            cols.append(Vector(
                cs.dtype,
                np.ascontiguousarray(s.to_numpy(), dtype=cs.dtype.np_dtype)))
    return RecordBatch(schema, cols)


_INT_TYPE_NAMES = {"Int8", "Int16", "Int32", "Int64",
                   "UInt8", "UInt16", "UInt32", "UInt64"}


def _result_dtype_override(expr, a: Analysis, table: Optional[Table]):
    """Result types that must not decay to float64 (reference: DataFusion
    keeps integer sums as Int64, min/max/first/last as the source type,
    and date_bin/date_trunc results as timestamps)."""
    if isinstance(expr, Column) and expr.name.startswith("__key__"):
        target = expr.name[len("__key__"):]
        for g in a.group_exprs:
            if expr_name(g) == target:
                expr = g
                break
    if isinstance(expr, Column) and table is not None:
        for call in a.agg_calls:
            if call.slot != expr.name:
                continue
            if call.op in ("count", "approx_distinct"):
                # distinct counts are cardinalities: Int64 even when the
                # per-group fallback frame decayed to float (a mixed
                # int/float agg row upcasts under groupby.apply)
                return dt.INT64
            if call.op in ("sum", "min", "max", "first", "last") and \
                    isinstance(call.arg, Column) and \
                    table.schema.contains(call.arg.name):
                src = table.schema.column_schema(call.arg.name).dtype
                if src.is_timestamp:
                    return src
                if src.name in _INT_TYPE_NAMES:
                    return dt.INT64 if call.op == "sum" else src
            return None
        return None
    if isinstance(expr, FunctionCall) and \
            expr.name.lower() in ("date_bin", "date_trunc"):
        for argx in expr.args:
            if isinstance(argx, Column) and table is not None and \
                    table.schema.contains(argx.name):
                src = table.schema.column_schema(argx.name).dtype
                if src.is_timestamp and \
                        src.time_unit == TimeUnit.MILLISECOND:
                    return src
    from ..sql.ast import Cast
    if isinstance(expr, Cast):
        # the projection carries the CAST target type, not whatever
        # dtype the value plane decayed to (NULL-bearing ints run as
        # float there)
        tn = expr.type_name.strip().lower()
        if tn in ("date", "timestamp", "datetime"):
            return dt.TIMESTAMP_MILLISECOND
        try:
            return parse_type_name(expr.type_name)
        except Exception:  # noqa: BLE001 — unknown alias: keep inference
            return None
    return None
