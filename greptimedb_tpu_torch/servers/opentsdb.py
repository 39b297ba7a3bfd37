"""OpenTSDB ingestion: telnet `put` lines and the HTTP /api/put JSON body.

Reference behavior: src/servers/src/opentsdb/codec.rs:291 — a DataPoint
(metric, ts, value, tags) stored as table=metric, tags→tags,
greptime_timestamp/greptime_value columns — and opentsdb.rs:60-120, the
line-based TCP listener on its own port (`OpentsdbServer` below).
"""

from __future__ import annotations

import socketserver
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..errors import InvalidArgumentsError

GREPTIME_TIMESTAMP = "greptime_timestamp"
GREPTIME_VALUE = "greptime_value"


@dataclass
class DataPoint:
    metric: str
    ts_ms: int
    value: float
    tags: Dict[str, str] = field(default_factory=dict)


def parse_telnet_put(line: str) -> DataPoint:
    """`put <metric> <timestamp> <value> <tagk=tagv> [...]`"""
    parts = line.strip().split()
    if not parts or parts[0] != "put":
        raise InvalidArgumentsError(
            "unknown command (expected 'put')" if parts else "empty line")
    if len(parts) < 4:
        raise InvalidArgumentsError(f"bad put line: {line!r}")
    metric = parts[1]
    ts = int(parts[2])
    # seconds vs milliseconds heuristic (OpenTSDB convention)
    ts_ms = ts * 1000 if ts < 10_000_000_000 else ts
    value = float(parts[3])
    tags = {}
    for kv in parts[4:]:
        k, sep, v = kv.partition("=")
        if not sep or not k:
            raise InvalidArgumentsError(f"bad tag {kv!r}")
        tags[k] = v
    return DataPoint(metric, ts_ms, value, tags)


def parse_http_put(body) -> List[DataPoint]:
    items = body if isinstance(body, list) else [body]
    out = []
    for it in items:
        try:
            ts = int(it["timestamp"])
            out.append(DataPoint(
                str(it["metric"]),
                ts * 1000 if ts < 10_000_000_000 else ts,
                float(it["value"]),
                {str(k): str(v) for k, v in (it.get("tags") or {}).items()}))
        except (KeyError, TypeError, ValueError) as e:
            raise InvalidArgumentsError(f"bad datapoint: {it!r}") from e
    return out


class OpentsdbServer:
    """Telnet-style TCP listener: one `put` line per data point.

    Reference behavior: src/servers/src/opentsdb.rs:60-120 — accept
    connections, read lines, insert each `put`, answer errors as text
    lines (classic OpenTSDB only replies on error), close on `exit`/
    `quit`, answer `version`.
    """

    def __init__(self, instance, host: str = "127.0.0.1", port: int = 0):
        self.instance = instance
        server_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    raw = self.rfile.readline()
                    if not raw:
                        return
                    try:
                        line = raw.decode("utf-8").strip()
                    except UnicodeDecodeError:
                        self.wfile.write(b"error: invalid utf-8\n")
                        continue
                    if not line:
                        continue
                    cmd = line.split(None, 1)[0].lower()
                    if cmd in ("exit", "quit"):
                        return
                    if cmd == "version":
                        self.wfile.write(b"net.opentsdb tsd built from "
                                         b"greptimedb-tpu\n")
                        continue
                    try:
                        server_self._ingest_line(line)
                    # the error IS the response: telnet clients get the
                    # first line back as text
                    except Exception as e:  # greptlint: disable=GL01
                        msg = str(e).split("\n")[0][:200]
                        self.wfile.write(f"error: {msg}\n".encode())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.port = self._tcp.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _ingest_line(self, line: str) -> None:
        from ..session import Channel, QueryContext
        point = parse_telnet_put(line)
        inserts, tag_cols = points_to_inserts([point])
        ctx = QueryContext(channel=Channel.OPENTSDB)
        for table, cols in inserts.items():
            self.instance.handle_row_insert(
                table, cols, tag_columns=tag_cols[table],
                timestamp_column=GREPTIME_TIMESTAMP, ctx=ctx)

    def serve_in_background(self) -> threading.Thread:
        from ..common.runtime import new_thread
        self._thread = new_thread(self._tcp.serve_forever, daemon=True,
                                  name="opentsdb-server",
                                  propagate_context=False)
        self._thread.start()
        return self._thread

    start = serve_in_background

    @property
    def host(self) -> str:
        return self._tcp.server_address[0]

    def shutdown(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()


def points_to_inserts(points: List[DataPoint]):
    """Group per metric into aligned column dicts."""
    by_metric: Dict[str, List[DataPoint]] = {}
    for p in points:
        by_metric.setdefault(p.metric, []).append(p)
    result = {}
    tag_cols = {}
    for metric, pts in by_metric.items():
        tag_names = sorted({k for p in pts for k in p.tags})
        cols: Dict[str, list] = {GREPTIME_TIMESTAMP: [],
                                 GREPTIME_VALUE: []}
        for t in tag_names:
            cols[t] = []
        for p in pts:
            cols[GREPTIME_TIMESTAMP].append(p.ts_ms)
            cols[GREPTIME_VALUE].append(p.value)
            for t in tag_names:
                cols[t].append(p.tags.get(t, ""))
        result[metric] = cols
        tag_cols[metric] = tag_names
    return result, tag_cols
