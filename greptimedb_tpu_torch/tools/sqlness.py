"""The port's sqlness golden runner: `.sql` cases through the port's
standalone or distributed frontend, each output byte-compared with its
`.result` golden.

    python3 -m greptimedb_tpu_torch.tools.sqlness [--device cuda|cpu]
        [--cases DIR] [filter ...]

Reference behavior: tests/runner/src/{main,env,util}.rs — a case file's
statements run against a freshly started standalone server and the
rendered outputs (`Affected Rows: N` / ASCII tables / `Error: ...`) are
diffed against the committed `.result` file. This is the same statement
splitter, comment stripping, volatile-column and detail normalisation and
rendering as the JAX package's tests/sqlness/runner.py, over the port's
own `RecordBatch` and `pretty_print`; it reads the cases by path and
imports nothing of the JAX package. Without `--cases` it runs the
in-scope cases: `IN_SCOPE` of the repo's tests/sqlness/cases/standalone/
and `DIST_IN_SCOPE` of tests/sqlness/cases/distributed/. Each case gets a
fresh data home and a fresh frontend: a standalone case
`build_standalone(DatanodeOptions(device=...))`, a case under a
`distributed` directory `DistEnv` (two datanodes on one shared object
store under an in-process meta, the twin of the JAX package's runner's
`_DistEnv`), whose flows fold and whose self-monitor scrapes only when a
statement asks (no background tick, as under the test suite); the
failpoint registry, the background-job registry and the trace and
profiler knobs are reset first, as a fresh server's would be. A statement's `'/tmp/sqlness_`
paths (the copy/* cases' files) run as files under the case's own data
home, so two runs of one case never share a file; the output echoes the
statement as written. The device is "cuda" unless `--device cpu` asks
for the CPU; without CUDA a run on "cuda" raises instead of answering.
`filter` keeps the cases whose path (relative to the cases directory,
`distributed/...` for the distributed ones) contains one of the
substrings. Exit code 0 when every case matched, 1
otherwise (the diffs are printed), 2 when nothing matched.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

#: the standalone golden cases, beside the JAX package's runner
CASES_DIR = Path(__file__).resolve().parents[2] / "tests" / "sqlness" / \
    "cases" / "standalone"

#: the cases the port byte-matches (the test suite on the CPU and the
#: smoke script on the card both run these)
IN_SCOPE = (
    "admin/show_profile", "admin/show_trace",
    "aggregate/aggregate", "alter/alter", "basic/basic", "cast/cast",
    "copy/copy", "copy/copy_compressed", "create/create", "cte/cte",
    "delete/delete", "explain/dispatch",
    "explain/rollup", "flow/create_flow", "functions/functions",
    "insert/default_values", "insert/insert", "insert/insert_invalid",
    "insert/insert_select", "join/join", "limit/limit",
    "order/null_ordering", "order/order_by", "schema/schema", "show/show",
    "subquery/subquery", "system/background_jobs", "system/cluster_info",
    "system/failpoints", "system/information_schema",
    "system/runtime_metrics",
    "timestamp/time_units", "timestamp/timestamp", "tql/explain",
    "tql/operators", "tql/range_functions", "tql/tql", "union/union",
    "window/window",
)
#: cases of the same surface that wait for a later module: case -> module
WAITING: dict = {}

#: the distributed golden cases, beside the standalone ones
DIST_CASES_DIR = CASES_DIR.parent / "distributed"

#: the distributed cases the port byte-matches; the others, explain/*,
#: are red on the JAX package itself
DIST_IN_SCOPE = (
    "admin/migrate_region", "alter/alter", "common/basic",
    "common/groupby", "common/window", "cte/cte", "show/show",
    "subquery/subquery", "system/cluster_info", "system/region_peers",
)


def split_statements(text: str) -> List[str]:
    """Split a .sql file into ';'-terminated statements, respecting
    single-quoted strings and line comments."""
    statements, buf = [], []
    in_str = False
    in_comment = False
    for ch in text:
        if in_comment:
            buf.append(ch)
            if ch == "\n":
                in_comment = False
            continue
        if ch == "'":
            in_str = not in_str
            buf.append(ch)
            continue
        if not in_str and ch == "-" and buf and buf[-1] == "-":
            in_comment = True
            buf.append(ch)
            continue
        if ch == ";" and not in_str:
            stmt = "".join(buf).strip()
            if stmt:
                statements.append(stmt + ";")
            buf = []
            continue
        buf.append(ch)
    tail = "".join(buf).strip()
    if tail:
        statements.append(tail)
    return statements


def strip_comment_lines(stmt: str) -> str:
    lines = [ln for ln in stmt.splitlines()
             if not ln.lstrip().startswith("--")]
    return "\n".join(lines).strip()


#: column name -> placeholder: wall-clock or wall-advancing columns whose
#: values cannot byte-compare across runs
VOLATILE_COLUMNS = {"elapsed_ms": "<elapsed>", "watermark": "<watermark>",
                    "last_seen_ms": "<last_seen>", "peer_addr": "<addr>",
                    "op_id": "<op_id>",
                    "duration_ms": "<ms>", "self_ms": "<ms>",
                    "start_offset_ms": "<ms>", "start_ms": "<ms>",
                    "trace_id": "<trace>", "span_id": "<span>",
                    "parent_span_id": "<span>",
                    "self_samples": "<n>", "total_samples": "<n>",
                    "stack_id": "<stack>"}

#: wall-clock fragments inside EXPLAIN ANALYZE detail strings
VOLATILE_DETAIL = [
    (re.compile(r"slowest_node_ms=[0-9.]+"), "slowest_node_ms=<ms>"),
    (re.compile(r"node_ms=[0-9A-Za-z:./#-]+"), "node_ms=<ms>"),
    (re.compile(r"network_ms=[0-9.]+"), "network_ms=<ms>"),
]


def _scrub_detail(v: str) -> str:
    for pattern, repl in VOLATILE_DETAIL:
        v = pattern.sub(repl, v)
    return v


def normalize_timings(out):
    """Replace volatile columns with fixed placeholders (retyped to
    STRING, so the table renders the same widths every run) and scrub
    the wall-clock fragments of `detail` strings."""
    from ..datatypes import data_type as dt
    from ..datatypes.record_batch import RecordBatch
    from ..datatypes.schema import ColumnSchema, Schema
    from ..query.output import Output

    if not out.is_batches or not out.batches:
        return out
    if not any(set(b.schema.names()) & (set(VOLATILE_COLUMNS) | {"detail"})
               for b in out.batches):
        return out
    batches = []
    for b in out.batches:
        data = b.to_pydict()
        cols = []
        for cs in b.schema.column_schemas:
            if cs.name in VOLATILE_COLUMNS:
                data[cs.name] = [VOLATILE_COLUMNS[cs.name]] * b.num_rows
                cols.append(ColumnSchema(cs.name, dt.STRING))
            else:
                if cs.name == "detail":
                    data[cs.name] = [
                        _scrub_detail(v) if isinstance(v, str) else v
                        for v in data[cs.name]]
                cols.append(cs)
        schema = Schema(cols)
        batches.append(RecordBatch.from_pydict(schema, data))
    return Output.record_batches(batches, batches[0].schema)


def render_output(out) -> str:
    from ..datatypes.record_batch import pretty_print
    out = normalize_timings(out)
    if out.is_batches:
        if not out.batches or all(b.num_rows == 0 for b in out.batches):
            names = out.batches[0].schema.names() if out.batches else []
            if names:
                return pretty_print(out.batches)
            return "(empty)"
        return pretty_print(out.batches)
    return f"Affected Rows: {out.affected_rows or 0}"


#: the fixed file prefix the copy/* cases write and read
TMP_PREFIX = "'/tmp/sqlness_"


def run_case(sql_text: str, frontend, files_dir: Optional[str] = None
             ) -> str:
    """Execute a case file's statements; return the .result content.
    With `files_dir`, each statement runs with its `'/tmp/sqlness_`
    paths moved into that directory."""
    from ..session import QueryContext

    ctx = QueryContext()
    blocks: List[str] = []
    for stmt in split_statements(sql_text):
        body = strip_comment_lines(stmt)
        if not body:
            continue
        blocks.append(stmt)
        if files_dir is not None:
            body = body.replace(
                TMP_PREFIX, "'" + os.path.join(files_dir, "sqlness_"))
        blocks.append(_answer(frontend, body, ctx))
    return "\n\n".join(blocks) + "\n"


def _answer(frontend, body: str, ctx) -> str:
    """One statement's rendered output, or its error as the golden
    records it."""
    from ..errors import GreptimeError
    try:
        return render_output(frontend.do_query(body, ctx)[-1])
    except GreptimeError as e:
        return f"Error: {e}"
    except Exception as e:  # noqa: BLE001 — parser/planner crashes
        return f"Error: {type(e).__name__}: {e}"


def case_files(filters: List[str], cases_dir: Path = CASES_DIR
               ) -> List[Path]:
    files = sorted(cases_dir.rglob("*.sql"))
    if filters:
        files = [f for f in files
                 if any(flt in str(f.relative_to(cases_dir))
                        for flt in filters)]
    return files


class DistEnv:
    """Two-datanode cluster frontend for the distributed cases: meta over
    a MemKv, both datanodes on one shared object store (their WAL and
    control state stay node-scoped), a DistInstance over
    LocalDatanodeClients, all on `device`. After each statement the
    balancer operations it queued (ADMIN MIGRATE / SPLIT / REBALANCE /
    ADD or REMOVE REPLICA) are pumped to completion, as the reference's
    runner does, so placement in the goldens is settled."""

    def __init__(self, data_home: str, device: str):
        from ..client import LocalDatanodeClient
        from ..datanode import DatanodeInstance, DatanodeOptions
        from ..frontend.distributed import DistInstance
        from ..meta import MemKv, MetaClient, MetaSrv, Peer
        from ..storage.object_store import FsObjectStore
        self.datanodes = []
        self.srv = MetaSrv(MemKv())
        meta = MetaClient(self.srv)
        clients = {}
        shared = FsObjectStore(os.path.join(data_home, "shared"))
        try:
            for i in (1, 2):
                dn = DatanodeInstance(DatanodeOptions(
                    data_home=os.path.join(data_home, f"dn{i}"),
                    node_id=i, register_numbers_table=False,
                    flow_tick_interval_s=0, self_monitor_interval_s=0,
                    device=device), store=shared)
                self.datanodes.append(dn)
                dn.start()
                dn.attach_meta(meta)
                clients[i] = LocalDatanodeClient(dn)
                self.srv.register_datanode(Peer(i, f"dn{i}"))
                self.srv.handle_heartbeat(i)
            self.fe = DistInstance(meta, clients, device=device)
        except Exception:
            self.shutdown()
            raise

    def do_query(self, sql: str, ctx=None):
        outs = self.fe.do_query(sql, ctx)
        self._pump_balancer()
        return outs

    def _pump_balancer(self):
        """Drive the queued balancer operations to completion: the
        cooperative stand-in for the background tick and heartbeats."""
        for _ in range(24):
            if not self.srv.balancer.ops():
                return
            self.srv.balancer.tick()
            for dn in self.datanodes:
                resp = self.srv.handle_heartbeat(dn.opts.node_id)
                for msg in resp.mailbox:
                    dn._handle_mailbox(msg)

    def shutdown(self):
        if getattr(self, "fe", None) is not None:
            self.fe.shutdown()
        for dn in self.datanodes:
            dn.shutdown()


def in_scope_files(filters: List[str]) -> List[Path]:
    """The in-scope standalone cases, then the distributed ones, kept by
    `filters` as `case_files` keeps them."""
    files = [CASES_DIR / f"{c}.sql" for c in IN_SCOPE] + \
        [DIST_CASES_DIR / f"{c}.sql" for c in DIST_IN_SCOPE]
    if filters:
        files = [f for f in files
                 if any(flt in _case_name(f) for flt in filters)]
    return files


def _case_name(path: Path) -> str:
    """A case's path relative to the cases directory it lives in:
    `distributed/...` for a distributed case."""
    if DIST_CASES_DIR in path.parents:
        return "distributed/" + str(path.relative_to(DIST_CASES_DIR))
    if CASES_DIR in path.parents:
        return str(path.relative_to(CASES_DIR))
    return str(path)


def run_one(sql_path: Path, device: str = "cuda") -> Optional[str]:
    """Run one case on a fresh frontend (a DistEnv for a case under a
    `distributed` directory, else a standalone one); None when its
    output byte-matches the golden, else the unified diff."""
    from ..common import background_jobs, failpoint, profiler, trace_store
    from ..datanode import DatanodeOptions
    from ..frontend import build_standalone

    # failpoint state, the job registry and the trace and profiler knobs
    # are process-global; a case sees them as a fresh server would
    failpoint.reset()
    background_jobs.reset()
    trace_store.configure(sample_ratio=0.01)
    profiler.configure(enabled=False, hz=19.0,
                       retention_ms=24 * 3600 * 1000)
    distributed = "distributed" in sql_path.resolve().parent.parts
    with tempfile.TemporaryDirectory() as home:
        if distributed:
            fe = DistEnv(home, device)
        else:
            fe = build_standalone(DatanodeOptions(
                data_home=home, register_numbers_table=True,
                flow_tick_interval_s=0, self_monitor_interval_s=0,
                device=device))
        try:
            got = run_case(sql_path.read_text(), fe,
                           files_dir=os.path.join(home, "files"))
        finally:
            fe.shutdown()
    result_path = sql_path.with_suffix(".result")
    if not result_path.exists():
        return f"{sql_path}: missing .result"
    want = result_path.read_text()
    if got == want:
        return None
    diff = "\n".join(difflib.unified_diff(
        want.splitlines(), got.splitlines(), fromfile=str(result_path),
        tofile="actual", lineterm=""))
    return f"{sql_path}:\n{diff}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="the query engine's device (cuda or cpu)")
    parser.add_argument("--cases", type=Path, default=None,
                        help="directory of .sql/.result cases (default: "
                             "the in-scope standalone and distributed "
                             "cases)")
    parser.add_argument("filters", nargs="*",
                        help="substring filters on case paths")
    args = parser.parse_args(argv)
    if args.cases is None:
        files = in_scope_files(args.filters)
    else:
        files = case_files(args.filters, args.cases)
    if not files:
        print("no cases matched", file=sys.stderr)
        return 2
    failures = []
    for f in files:
        err = run_one(f, args.device)
        name = _case_name(f) if args.cases is None \
            else f.relative_to(args.cases)
        print(f"[{'FAIL' if err else 'PASS'}] {name}")
        if err:
            failures.append(err)
    if failures:
        print("\n" + "\n\n".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
