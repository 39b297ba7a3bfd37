"""Per-query execution statistics: the machinery behind EXPLAIN ANALYZE.

Reference behavior: DataFusion's `ExecutionPlan::metrics()` — every
physical operator accumulates row counts and elapsed time, and
`EXPLAIN ANALYZE` renders the annotated plan (the reference surfaces it
through src/query's DataFusion integration). Here an `ExecStats`
collector rides a thread-local during execution; each layer records its
stage with the SAME stage names the storage profilers use
(`Region.last_ingest_profile` / `Region.last_scan_profile`), so traces,
metrics, EXPLAIN ANALYZE and the profilers all tell one story.

Stage vocabulary (shared with the scan/ingest profilers):

- dispatch decision: ``cpu-small-scan`` / ``cpu-fallback`` /
  ``device-resident`` / ``streamed-cold`` / ``aggregate-pushdown``
- streamed scan: ``plan``, ``decode_reduce``, ``device_fetch``,
  ``fold`` (+ counters lean_slices / merged_slices / dedup_skip_slices)
- resident scan: ``scan_prep``, ``reduce``
- CPU fallback: ``scan``, ``filter``, ``aggregate``, ``project``
- shared tail: ``finalize``

The collector is installed per top-level query (`collect()`), is
thread-safe (streamed slices report from pool workers), and a missing
collector makes every record call a no-op, so hot paths pay only a
thread-local read when nobody is watching.

Cluster-wide (ISSUE 6): datanode-side stats cross the RPC boundary —
the Flight datanode server runs each scan/moments/write under its own
collector and ships `to_dict()` back in the response; the frontend's
per-RPC sub-collector `absorb()`s it, and `record_node()` hangs the
whole sub-collector off the statement's collector. `rows_table()` then
renders a per-node, per-stage tree under the dist_scatter line — each
node row naming its actual dispatch plus node-elapsed vs network time —
so a distributed EXPLAIN ANALYZE no longer collapses everything behind
the wire into one number.

In the port, each kernel wrapper also counts its launch on the active
collector (`count_launch`); `to_dict()` ships the counts when a kernel
launched, and a node row of the tree ends with `launches=<kernel>:<n>`
when its node launched one (a CPU node's rows keep the reference's
text).
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

_tls = threading.local()

#: wire key for datanode-side ExecStats riding a Flight response (stream
#: schema metadata on do_get, the JSON ack on do_put) — one definition
#: shared by both sides of the protocol so they cannot drift
EXEC_STATS_WIRE_KEY = b"gdb.exec_stats"


@dataclass
class StageStat:
    stage: str
    rows: int = 0
    files: int = 0
    elapsed_s: float = 0.0
    detail: Dict[str, object] = field(default_factory=dict)

    def detail_str(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.detail.items())


class ExecStats:
    """Accumulates per-stage counters for one statement execution."""

    def __init__(self):
        self._lock = threading.Lock()
        self.stages: "OrderedDict[str, StageStat]" = OrderedDict()
        self.dispatch: Optional[str] = None
        self.total_s: float = 0.0
        #: node label -> {"stats": ExecStats, "wall_ms": float} — one
        #: sub-collector per datanode RPC (DistTable._scatter)
        self.nodes: "OrderedDict[str, dict]" = OrderedDict()
        #: sum of remote-reported totals absorbed into THIS collector
        #: (wall - remote_total = wire/serialization cost)
        self.remote_total_ms: float = 0.0
        #: hand-written kernel launches by kernel name, counted where
        #: each wrapper counts its own; they cross the wire with the
        #: rest, so a client reads a datanode process's launches
        self.launches: Dict[str, int] = {}

    # ---- recording ----
    def record(self, stage: str, *, rows: int = 0, files: int = 0,
               elapsed_s: float = 0.0, **detail) -> None:
        with self._lock:
            st = self.stages.get(stage)
            if st is None:
                st = self.stages[stage] = StageStat(stage)
            st.rows += int(rows)
            st.files += int(files)
            st.elapsed_s += float(elapsed_s)
            for k, v in detail.items():
                old = st.detail.get(k)
                # numeric details accumulate across regions/slices so a
                # multi-region query reports totals, not the last region
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and isinstance(old, (int, float)) \
                        and not isinstance(old, bool):
                    st.detail[k] = old + v
                else:
                    st.detail[k] = v

    @contextlib.contextmanager
    def stage(self, name: str, **detail) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, elapsed_s=time.perf_counter() - t0, **detail)

    def count_launch(self, kernel: str) -> None:
        with self._lock:
            self.launches[kernel] = self.launches.get(kernel, 0) + 1

    def set_dispatch(self, decision: str) -> None:
        """First decision wins: nested subqueries must not overwrite the
        top-level statement's dispatch line."""
        with self._lock:
            if self.dispatch is None:
                self.dispatch = decision

    def record_node(self, label: str, stats: "ExecStats",
                    wall_ms: float) -> None:
        """Attach one datanode RPC's sub-collector. `wall_ms` is the
        frontend-observed round trip; the node's own total (remote or
        summed stage time) subtracts out to the network share. A second
        scatter in the same statement reusing a label gets `#n`."""
        with self._lock:
            base, n = label, 1
            while label in self.nodes:
                n += 1
                label = f"{base}#{n}"
            self.nodes[label] = {"stats": stats, "wall_ms": float(wall_ms)}

    # ---- wire codec ----
    def to_dict(self) -> Dict:
        """JSON-safe snapshot for shipping over an RPC response (the
        reference's keys; `launches` only when a kernel launched)."""
        with self._lock:
            out = {
                "dispatch": self.dispatch,
                "total_ms": round(self.total_s * 1e3, 3),
                "stages": [{
                    "stage": st.stage, "rows": st.rows, "files": st.files,
                    "elapsed_ms": round(st.elapsed_s * 1e3, 3),
                    "detail": {k: _json_safe(v)
                               for k, v in st.detail.items()},
                } for st in self.stages.values()],
            }
            if self.launches:
                out["launches"] = dict(self.launches)
            return out

    def absorb(self, d: Dict) -> None:
        """Replay a remote collector's to_dict() into this one (the
        frontend-side twin of the datanode's recording)."""
        if d.get("dispatch"):
            self.set_dispatch(d["dispatch"])
        for st in d.get("stages", ()):
            self.record(st.get("stage", "?"), rows=st.get("rows", 0),
                        files=st.get("files", 0),
                        elapsed_s=float(st.get("elapsed_ms", 0.0)) / 1e3,
                        **(st.get("detail") or {}))
        with self._lock:
            self.remote_total_ms += float(d.get("total_ms", 0.0))
            for k, n in (d.get("launches") or {}).items():
                self.launches[k] = self.launches.get(k, 0) + int(n)

    #: stages whose `rows` mean "rows scanned from storage". The three
    #: are mutually exclusive per region (cpu fallback / resident /
    #: streamed), so summing them never double-counts; `decode` is a
    #: sub-stage of stream_scan and stays out.
    _SCAN_STAGES = frozenset({"scan", "scan_prep", "stream_scan"})

    def totals(self) -> Dict[str, int]:
        """Running resource totals for the process list: rows scanned,
        bytes read off storage, datanode RPCs consumed. Accumulates as
        stages record — a live query reports its progress so far, not
        just a final number — and folds per-node sub-collectors in (a
        distributed scan's rows live on the node blocks)."""
        resident = streamed = streamed_live = 0
        io_bytes = decode_bytes = rpcs = 0
        partial_bytes = partial_wire = 0
        with self._lock:
            for st in self.stages.values():
                if st.stage == "stream_scan":
                    streamed += st.rows
                elif st.stage in self._SCAN_STAGES:
                    resident += st.rows
                if st.stage == "io_read":
                    io_bytes += int(st.detail.get("bytes", 0))
                if st.stage == "finalize":
                    # partial-aggregate frame bytes folded by this
                    # statement (the wire cost aggregate pushdown pays
                    # instead of raw rows), recorded when the fold runs
                    partial_bytes += int(st.detail.get("partial_bytes",
                                                       0))
                if st.stage == "partial_wire":
                    # per-RPC serialized partial bytes, recorded AS each
                    # Flight stream drains — the live floor while the
                    # statement still gathers (finalize lands at the end)
                    partial_wire += int(st.detail.get("bytes", 0))
                if st.stage == "decode":
                    # stream_rows = the streamed share of the decode
                    # rows (the lean reader tags them; the resident
                    # path's read_sst decode rows carry no tag and are
                    # already counted by scan/scan_prep)
                    streamed_live = int(st.detail.get("stream_rows", 0))
                    decode_bytes += int(st.detail.get("bytes", 0))
                rpcs += int(st.detail.get("rpcs", 0))
            nodes = [entry["stats"] for entry in self.nodes.values()]
        # while a streamed scan RUNS, its rows land on `decode` slice by
        # slice and `stream_scan` is only published at the end — the
        # live floor makes a long scan's progress visible in the
        # processes view instead of reading 0 until it finishes, and a
        # mixed resident+cold statement keeps counting its resident
        # rows while the cold region streams
        rows = resident + max(streamed, streamed_live)
        # io_read (object-store bytes) and decode (decoded batch bytes)
        # describe the SAME data at two stages — summing both would
        # double-bill a cold scan. Prefer the storage-side number;
        # decoded bytes stand in for cache-resident scans that never
        # touch the store.
        bytes_read = io_bytes if io_bytes else decode_bytes
        for ns in nodes:
            sub = ns.totals()
            rows += sub["rows_scanned"]
            bytes_read += sub["bytes_read"]
            rpcs += sub["rpcs"]
            # node sub-collectors carry the partial_wire stages their
            # RPCs recorded — the in-flight share of the partial bytes
            partial_wire += sub.get("partial_bytes", 0)
        # finalize (frontend-measured, complete) and partial_wire
        # (per-hop, live) describe the SAME frames at two moments —
        # take the larger, never the sum, so the processes view counts
        # partials while the gather runs without double-billing after
        return {"rows_scanned": rows, "bytes_read": bytes_read,
                "rpcs": rpcs,
                "partial_bytes": max(partial_bytes, partial_wire)}

    def node_elapsed_ms(self, wall_ms: float = 0.0) -> float:
        """The node-side share of a sub-collector: the remote-reported
        total when the stats crossed a wire; for an in-process RPC the
        round trip IS node work (no network), so the wall time itself.
        (Summing stage timings would double-count — a wrapper stage like
        'scan' overlaps the 'decode'/'prune' stages recorded inside its
        window.)"""
        with self._lock:
            if self.remote_total_ms > 0:
                return self.remote_total_ms
        return wall_ms

    # ---- rendering ----
    def summary(self) -> str:
        """One-line digest for the slow-query log."""
        with self._lock:
            parts = [f"dispatch={self.dispatch or 'n/a'}"]
            for st in self.stages.values():
                bit = f"{st.stage}={st.elapsed_s * 1e3:.1f}ms"
                if st.rows:
                    bit += f"/{st.rows}r"
                parts.append(bit)
            if self.nodes:
                parts.append("nodes=" + ",".join(
                    f"{k}:{v['wall_ms']:.1f}ms"
                    for k, v in sorted(self.nodes.items(),
                                       key=lambda kv: node_sort_key(
                                           kv[0]))))
            parts.append(f"total={self.total_s * 1e3:.1f}ms")
        return " ".join(parts)

    def rows_table(self) -> Dict[str, List]:
        """Column dict for the EXPLAIN ANALYZE per-stage batch."""
        cols: Dict[str, List] = {"stage": [], "rows": [], "files": [],
                                 "elapsed_ms": [], "detail": []}

        def add(stage: str, rows: int, files: int, elapsed_ms: float,
                detail: object) -> None:
            cols["stage"].append(stage)
            cols["rows"].append(int(rows))
            cols["files"].append(int(files))
            cols["elapsed_ms"].append(float(elapsed_ms))
            cols["detail"].append(detail)

        with self._lock:
            add("dispatch", 0, 0, 0.0, self.dispatch or "n/a")
            # node blocks sorted by label: gather completion order is
            # nondeterministic, golden files must not be
            node_items = sorted(self.nodes.items(),
                                key=lambda kv: node_sort_key(kv[0]))
            nodes_emitted = False
            for st in self.stages.values():
                add(st.stage, st.rows, st.files, st.elapsed_s * 1e3,
                    st.detail_str())
                if st.stage == "dist_scatter" and not nodes_emitted:
                    nodes_emitted = True
                    _add_node_rows(add, node_items)
            if node_items and not nodes_emitted:
                _add_node_rows(add, node_items)
            add("total", 0, 0, self.total_s * 1e3, "")
        return cols


def node_sort_key(label: str) -> List[object]:
    """Natural order for node labels: dn2 before dn10 (a lexicographic
    sort misorders clusters with 10+ datanodes). Shared by the ANALYZE
    tree, the slow-query nodes= digest, and the node_ms vector."""
    return [int(part) if part.isdigit() else part
            for part in re.split(r"(\d+)", label)]


def _json_safe(v: object) -> object:
    """Detail values may be numpy scalars (row counts summed by storage
    code); coerce to plain JSON types for the wire."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # noqa: BLE001 — non-scalar .item(): fall back
            return str(v)
    return str(v)


def _add_node_rows(add: "Callable", node_items: "list") -> None:
    """Per-node blocks of the EXPLAIN ANALYZE tree: a header row naming
    the node's actual dispatch + node-vs-network split (and, when the
    node launched a kernel, its launches by kernel), then its stage rows
    indented underneath."""
    for label, entry in node_items:
        ns: "ExecStats" = entry["stats"]
        wall_ms = entry["wall_ms"]
        node_ms = ns.node_elapsed_ms(wall_ms)
        net_ms = max(0.0, wall_ms - node_ms)
        with ns._lock:
            stages = list(ns.stages.values())
            dispatch = ns.dispatch
            launches = sorted(ns.launches.items())
        rows = max((st.rows for st in stages), default=0)
        files = sum(st.files for st in stages)
        header = (f"dispatch={dispatch or 'n/a'}; node_ms={node_ms:.2f} "
                  f"network_ms={net_ms:.2f}")
        if launches:
            header += "; launches=" + ",".join(
                f"{k}:{n}" for k, n in launches)
        add(f"  {label}", rows, files, wall_ms, header)
        for st in stages:
            add(f"    {st.stage}", st.rows, st.files, st.elapsed_s * 1e3,
                st.detail_str())


# ---------------------------------------------------------------------------
# thread-local collector plumbing
# ---------------------------------------------------------------------------

def current() -> Optional[ExecStats]:
    return getattr(_tls, "stats", None)


@contextlib.contextmanager
def collect(stats: Optional[ExecStats] = None) -> Iterator[ExecStats]:
    """Install a collector for the duration of one statement."""
    prev = getattr(_tls, "stats", None)
    s = stats if stats is not None else ExecStats()
    _tls.stats = s
    # publish to the process-list entry (if this statement is tracked):
    # the processes view reads live rows-scanned/bytes/RPC totals off
    # the collector WHILE the query runs
    from . import process_list as _pl
    entry = _pl.current()
    if entry is not None and entry.stats is None:
        entry.stats = s
    t0 = time.perf_counter()
    try:
        yield s
    finally:
        s.total_s += time.perf_counter() - t0
        _tls.stats = prev


@contextlib.contextmanager
def collect_into(stats: Optional[ExecStats]) -> Iterator[None]:
    """Install an EXISTING collector (possibly None) on this thread — no
    timing, no creation. Used by telemetry.propagate to carry the
    query's collector into pool workers."""
    prev = getattr(_tls, "stats", None)
    _tls.stats = stats
    try:
        yield
    finally:
        _tls.stats = prev


def record(stage: str, **kwargs) -> None:
    s = current()
    if s is not None:
        s.record(stage, **kwargs)


def absorb_remote(d) -> None:
    """Replay a remote to_dict() into the active collector, if any —
    what a wire client calls after parsing the response's stats."""
    s = current()
    if s is not None and d:
        s.absorb(d)


def count_launch(kernel: str) -> None:
    """One launch of a hand-written kernel, on the active collector."""
    s = current()
    if s is not None:
        s.count_launch(kernel)


def set_dispatch(decision: str) -> None:
    s = current()
    if s is not None:
        s.set_dispatch(decision)


@contextlib.contextmanager
def stage(name: str, **detail) -> Iterator[None]:
    s = current()
    if s is None:
        yield
        return
    with s.stage(name, **detail):
        yield
