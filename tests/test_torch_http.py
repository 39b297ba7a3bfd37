"""The HTTP server family: the port's `servers/http.py` over its standalone
frontend against the JAX package's server over its own, on the CPU.

Each package runs its `HttpServer` on port 0 over a frontend with its own
data home (the reference's `FrontendInstance(DatanodeInstance(...))`, the
port's `build_standalone(DatanodeOptions(..., device="cpu"))`), and the
same list of requests goes to both over real sockets, in order: ingest
(Prometheus remote write, InfluxDB v1 and v2 with `u`/`p`, `Token` and
basic credentials, OpenTSDB HTTP and telnet puts), `/v1/sql` (DDL,
INSERT, aggregates with and without `date_bin`, errors), `/v1/promql`,
the Prometheus API (`query_range` on the row path and, with `SET
tpu_dispatch_min_rows = 0`, on the lowered path and with `explain=1`,
`query`, `labels`, `series`, `label/{name}/values`, `buildinfo`,
`metadata`), remote read, the admin routes (flush, compact, downsample,
failpoints) and `/health`.

Comparisons: status codes and JSON bodies equal once `execution_time_ms`
is dropped; floats in SQL answers within the SQL float32 bound of
tests/test_torch_sql.py (|port - ref| <= 1e-5 |ref| + 8 eps32 P, P the
sum of |x| over the table), Prometheus API values (6 significant digits)
within rtol 1e-5 on the row path and 2e-5 on the lowered one, as
tests/test_torch_promql.py and tests/test_torch_promql_lowering.py hold
them; everything else exact. The remote-read payloads are byte-equal
after snappy decompress, series order included; `/status` has the same
keys.

Then what only the port is asked here: 401 without credentials under a
`StaticUserProvider`; the admission gate's 429 with `Retry-After` on
`/v1/sql` and on ingest, and `SET admission_*` / `SET ingest_coalesce*`
taking effect; concurrent same-shape InfluxDB bodies coalescing with
every row landing; a recording `SqlQueryInterceptor` plugin seeing the
same calls in the same order in both packages; `/metrics` serving the
port's own registry; the routes whose modules are not ported answering
the `UnsupportedError` envelope; an HTTPS server with a `tls.py` context.
"""

import base64
import json
import math
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.common import admission as ref_admission
from greptimedb_tpu.common import failpoint as ref_failpoint
from greptimedb_tpu.common import telemetry as ref_telemetry
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.servers import coalesce as ref_coalesce
from greptimedb_tpu.servers import interceptor as ref_interceptor
from greptimedb_tpu.servers.http import HttpServer as RefHttpServer
from greptimedb_tpu.servers.opentsdb import OpentsdbServer as RefTsdbServer
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu_torch.common import admission, failpoint, process_list
from greptimedb_tpu_torch.common import telemetry
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.errors import StatusCode
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.servers import coalesce, interceptor, prometheus
from greptimedb_tpu_torch.servers import tls
from greptimedb_tpu_torch.servers.auth import StaticUserProvider
from greptimedb_tpu_torch.servers.http import HttpServer
from greptimedb_tpu_torch.servers.opentsdb import OpentsdbServer
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils import snappy

EPS32 = 2.0 ** -24
T0 = 1_700_000_000_000
HOSTS, SAMPLES, STEP_MS = 6, 90, 10_000          # 15 minutes a series
START_S, END_S = T0 // 1000, T0 // 1000 + 840
TIMEOUT_S = 10


# ---------------------------------------------------------------------------
# the data, from a seed
# ---------------------------------------------------------------------------

def _prom_series():
    """A gauge and a counter (with one reset) per host, in the Prometheus
    remote-write shape."""
    rng = np.random.default_rng(21)
    ts = T0 + np.arange(SAMPLES, dtype=np.int64) * STEP_MS
    out = []
    for h in range(HOSTS):
        labels = {"hostname": f"h{h}", "region": f"r{h % 3}"}
        gauge = np.round(rng.normal(50, 15, SAMPLES) * 8) / 8
        inc = np.round(rng.uniform(0, 40, SAMPLES) * 4) / 4
        ctr = np.cumsum(inc)
        if h == 2:
            ctr[40:] -= ctr[39]                   # a counter reset
        for name, vals in (("node_cpu", gauge),
                           ("http_requests_total", ctr)):
            out.append(prometheus.TimeSeries(
                labels={"__name__": name, **labels},
                samples=[(float(v), int(t)) for v, t in zip(vals, ts)]))
    return out


SERIES = _prom_series()
#: sum of |x| of the largest table, for the float32 bound
P_ABS = max(sum(abs(v) for s in SERIES if s.labels["__name__"] == n
                for v, _ in s.samples)
            for n in ("node_cpu", "http_requests_total"))


def _monitor_values():
    rng = np.random.default_rng(7)
    rows = []
    for i in range(48):
        rows.append(f"('host{i % 4}', {T0 + i * 15_000}, "
                    f"{rng.normal(40, 10):.3f}, {rng.uniform(0, 1e3):.1f})")
    return ", ".join(rows)


def _form(stmt):
    return (urllib.parse.urlencode({"sql": stmt}).encode(),
            {"Content-Type": "application/x-www-form-urlencoded"})


def _read_request(matchers, start_ms, end_ms):
    q = pw.field_varint(1, start_ms) + pw.field_varint(2, end_ms)
    for mt, name, value in matchers:
        q += pw.field_bytes(3, pw.field_varint(1, mt) +
                            pw.field_bytes(2, name.encode()) +
                            pw.field_bytes(3, value.encode()))
    return snappy.compress(bytes(pw.field_bytes(1, q)))


def _basic(user, pwd):
    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{pwd}".encode()).decode()}


INFLUX_V1 = (b"weather,location=us-midwest temperature=82.5,humidity=32i,"
             b"ok=t,note=\"dry, hot\" 1700000000000\n"
             b"weather,location=us\\ east temperature=75,humidity=30i,ok=f,"
             b"note=\"wet\" 1700000001000\n")
INFLUX_V2 = b"disk,host=a used=12.5,free=100i 1700000002\n" \
            b"disk,host=b used=7.25,free=80i 1700000003\n"
INFLUX_BASIC = b"disk,host=c used=1.5,free=5i 1700000004000000\n"
TSDB_PUT = json.dumps([
    {"metric": "sys.cpu", "timestamp": 1700000000, "value": 18.0,
     "tags": {"host": "web01"}},
    {"metric": "sys.cpu", "timestamp": 1700000001500, "value": 19.5,
     "tags": {"host": "web02"}}]).encode()
TELNET = (b"put tsd.cpu 1700000000 41.5 host=web01 dc=east\n"
          b"put tsd.cpu 1700000001 43.0 host=web02 dc=west\n")

SQL, PROM, EXACT, READ, KEYS = "sql", "prom", "exact", "read", "keys"
#: the failpoint list: the armed point's entry (which other points are
#: registered depends on the code each process has run)
ARMED = "armed"

#: (label, method, path, params, body, headers, comparison), sent to both
#: servers in this order
STEPS = [
    ("remote write", "POST", "/v1/prometheus/write", None,
     prometheus.encode_write_request(SERIES), None, EXACT),
    ("influx v1 u/p", "POST", "/v1/influxdb/write",
     {"db": "public", "precision": "ms", "u": "greptime", "p": "x"},
     INFLUX_V1, None, EXACT),
    ("influx v2 token", "POST", "/v1/influxdb/api/v2/write",
     {"bucket": "public", "precision": "s"}, INFLUX_V2,
     {"Authorization": "Token greptime:x"}, EXACT),
    ("influx basic", "POST", "/v1/influxdb/write", {"precision": "ns"},
     INFLUX_BASIC, _basic("greptime", "x"), EXACT),
    ("influx bad line", "POST", "/v1/influxdb/write", None,
     b"weather temperature=\n", None, EXACT),
    ("opentsdb put", "POST", "/v1/opentsdb/api/put", None, TSDB_PUT,
     {"Content-Type": "application/json"}, EXACT),
    ("opentsdb bad put", "POST", "/v1/opentsdb/api/put", None,
     b'[{"metric": "m"}]', None, EXACT),
    ("create table", "POST", "/v1/sql", None,
     *_form("CREATE TABLE monitor (host STRING, ts TIMESTAMP TIME INDEX, "
            "cpu DOUBLE, mem DOUBLE, PRIMARY KEY(host))"), EXACT),
    ("insert", "GET", "/v1/sql",
     {"sql": "INSERT INTO monitor VALUES " + _monitor_values()}, None, None,
     EXACT),
    ("aggregate", "POST", "/v1/sql", None,
     *_form("SELECT host, avg(cpu), max(mem), min(cpu), count(*) FROM "
            "monitor GROUP BY host ORDER BY host"), SQL),
    ("date_bin aggregate", "POST", "/v1/sql", None,
     *_form("SELECT host, date_bin(INTERVAL '5 minutes', ts) AS b, "
            "sum(cpu), avg(mem) FROM monitor GROUP BY host, b ORDER BY "
            "host, b"), SQL),
    ("json body", "POST", "/v1/sql", None,
     json.dumps({"sql": "SELECT count(*) FROM monitor"}).encode(),
     {"Content-Type": "application/json"}, EXACT),
    ("sql error", "POST", "/v1/sql", None,
     *_form("SELECT * FROM no_such_table"), EXACT),
    ("sql parse error", "GET", "/v1/sql", {"sql": "SELEC 1"}, None, None,
     EXACT),
    ("missing sql", "GET", "/v1/sql", None, None, None, EXACT),
    ("remote-written rows", "GET", "/v1/sql",
     {"sql": "SELECT hostname, region, count(*), avg(greptime_value), "
             "max(greptime_value) FROM node_cpu GROUP BY hostname, region "
             "ORDER BY hostname"}, None, None, SQL),
    ("counter rows", "GET", "/v1/sql",
     {"sql": "SELECT * FROM http_requests_total WHERE hostname = 'h2' "
             "ORDER BY greptime_timestamp LIMIT 50"}, None, None, EXACT),
    ("influx rows", "GET", "/v1/sql",
     {"sql": "SELECT * FROM weather ORDER BY location; SELECT * FROM disk "
             "ORDER BY host"}, None, None, EXACT),
    ("opentsdb rows", "GET", "/v1/sql",
     {"sql": 'SELECT * FROM "sys.cpu" ORDER BY host; SELECT * FROM '
             '"tsd.cpu" ORDER BY host'}, None, None, EXACT),
    ("promql", "POST", "/v1/promql",
     {"query": "sum by (region) (rate(http_requests_total[1m]))",
      "start": str(START_S), "end": str(END_S), "step": "30s"}, None, None,
     SQL),
    ("promql missing step", "GET", "/v1/promql",
     {"query": "node_cpu", "start": "0", "end": "10"}, None, None, EXACT),
    ("query_range row path", "GET", "/api/v1/query_range",
     {"query": "sum by (region) (rate(http_requests_total[5m]))",
      "start": str(START_S), "end": str(END_S), "step": "30"}, None, None,
     PROM),
    ("query_range per series", "POST", "/api/v1/query_range", None,
     urllib.parse.urlencode({
         "query": "irate(http_requests_total[2m])",
         "start": str(START_S), "end": str(END_S), "step": "60s"}).encode(),
     {"Content-Type": "application/x-www-form-urlencoded"}, PROM),
    ("query_range explain row path", "GET", "/api/v1/query_range",
     {"query": "sum by (region) (rate(http_requests_total[5m]))",
      "start": str(START_S), "end": str(END_S), "step": "30", "explain": "1"},
     None, None, EXACT),
    ("query", "GET", "/api/v1/query",
     {"query": "avg by (region) (node_cpu)", "time": str(END_S - 5)}, None,
     None, PROM),
    ("query_range bad", "GET", "/api/v1/query_range",
     {"query": "sum(", "start": "0", "end": "10", "step": "1"}, None, None,
     EXACT),
    ("query_range missing", "GET", "/api/v1/query_range",
     {"query": "node_cpu", "start": "0"}, None, None, EXACT),
    ("labels", "GET", "/api/v1/labels", None, None, None, EXACT),
    ("labels matched", "GET", "/api/v1/labels", {"match[]": "weather"},
     None, None, EXACT),
    ("series", "GET", "/api/v1/series", {"match[]": "node_cpu{region='r1'}"},
     None, None, EXACT),
    ("label values", "GET", "/api/v1/label/region/values",
     {"match[]": ["node_cpu", "disk"]}, None, None, EXACT),
    ("metric names", "GET", "/api/v1/label/__name__/values", None, None,
     None, EXACT),
    ("buildinfo", "GET", "/api/v1/status/buildinfo", None, None, None,
     EXACT),
    ("metadata", "GET", "/api/v1/metadata", None, None, None, EXACT),
    ("lowered floor", "GET", "/v1/sql",
     {"sql": "SET tpu_dispatch_min_rows = 0"}, None, None, EXACT),
    ("query_range lowered", "GET", "/api/v1/query_range",
     {"query": "avg by (region) (avg_over_time(node_cpu[1m]))",
      "start": str(START_S), "end": str(END_S), "step": "60s"}, None, None,
     "lowered"),
    ("query_range explain lowered", "GET", "/api/v1/query_range",
     {"query": "avg by (region) (avg_over_time(node_cpu[1m]))",
      "start": str(START_S), "end": str(END_S), "step": "60s",
      "explain": "true"}, None, None, EXACT),
    ("device aggregate", "POST", "/v1/sql", None,
     *_form("SET tpu_dispatch_min_rows = 0; SELECT hostname, "
            "avg(greptime_value), count(greptime_value) FROM node_cpu GROUP "
            "BY hostname ORDER BY hostname"), SQL),
    ("remote read", "POST", "/v1/prometheus/read", None,
     _read_request([(0, "__name__", "node_cpu"), (0, "hostname", "h1")],
                   T0 + 100_000, T0 + 400_000), None, READ),
    ("remote read regex", "POST", "/v1/prometheus/read", None,
     _read_request([(0, "__name__", "http_requests_total"),
                    (2, "region", "r[02]"), (1, "hostname", "h3")],
                   T0, T0 + 900_000), None, READ),
    ("remote read unknown", "POST", "/v1/prometheus/read", None,
     _read_request([(0, "__name__", "nope")], 0, T0), None, READ),
    ("flush", "POST", "/v1/admin/flush", {"table": "monitor"}, None, None,
     EXACT),
    ("compact", "POST", "/v1/admin/compact", {"table": "monitor"}, None,
     None, EXACT),
    ("after flush", "GET", "/v1/sql",
     {"sql": "SELECT host, count(*) FROM monitor GROUP BY host ORDER BY "
             "host"}, None, None, EXACT),
    ("rollup table", "POST", "/v1/sql", None,
     *_form("CREATE TABLE node_cpu_1m (hostname STRING, region STRING, "
            "greptime_timestamp TIMESTAMP TIME INDEX, greptime_value "
            "DOUBLE, PRIMARY KEY(hostname, region))"), EXACT),
    ("downsample", "POST", "/v1/admin/downsample",
     {"src": "node_cpu", "dst": "node_cpu_1m", "stride": "60s",
      "agg": "max"}, None, None, EXACT),
    ("downsample bad stride", "POST", "/v1/admin/downsample",
     {"src": "node_cpu", "dst": "node_cpu_1m", "stride": "soon"}, None,
     None, EXACT),
    ("downsampled rows", "GET", "/v1/sql",
     {"sql": "SELECT * FROM node_cpu_1m ORDER BY hostname, "
             "greptime_timestamp"}, None, None, EXACT),
    ("failpoint arm", "POST", "/v1/admin/failpoints",
     {"name": "torch_http_probe", "action": "1x1000*delay(1)"}, None, None,
     EXACT),
    ("failpoint bad action", "POST", "/v1/admin/failpoints",
     {"name": "torch_http_probe", "action": "explode"}, None, None, EXACT),
    ("failpoint missing action", "POST", "/v1/admin/failpoints",
     {"name": "torch_http_probe"}, None, None, EXACT),
    ("failpoint list", "GET", "/v1/admin/failpoints", None, None, None,
     ARMED),
    ("failpoint disarm", "DELETE", "/v1/admin/failpoints",
     {"name": "torch_http_probe"}, None, None, EXACT),
    ("health", "GET", "/health", None, None, None, EXACT),
    ("influx health", "GET", "/v1/influxdb/health", None, None, None,
     EXACT),
    ("status", "GET", "/status", None, None, None, KEYS),
    ("telnet rows", "GET", "/v1/sql",
     {"sql": 'SELECT host, dc, greptime_value FROM "tsd.cpu" ORDER BY '
             "host"}, None, None, EXACT),
]


def req(port, path, method="GET", body=None, headers=None, params=None,
        scheme="http", context=None):
    url = f"{scheme}://127.0.0.1:{port}{path}"
    if params:
        url += "?" + urllib.parse.urlencode(params, doseq=True)
    r = urllib.request.Request(url, data=body, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=TIMEOUT_S,
                                    context=context) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _telnet(port, payload):
    """OpenTSDB telnet puts, then `version` (its answer proves the puts
    were read) and `exit`."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=TIMEOUT_S) as s:
        f = s.makefile("rwb")
        f.write(payload + b"version\n")
        f.flush()
        line = f.readline()
        f.write(b"exit\n")
        f.flush()
    return line


class Side:
    """One package's frontend, HTTP server and OpenTSDB telnet listener."""

    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(data_home=str(home),
                                                       device="cpu"))
            self.srv = HttpServer(self.fe, addr="127.0.0.1:0")
            self.tsdb = OpentsdbServer(self.fe)
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
            self.srv = RefHttpServer(self.fe, addr="127.0.0.1:0")
            self.tsdb = RefTsdbServer(self.fe)
        self.srv.start()
        self.tsdb.start()

    def close(self):
        try:
            self.tsdb.shutdown()
            self.srv.shutdown()
        finally:
            self.fe.shutdown()


def _knobs():
    """The module state SET and the admin routes change, in both
    packages: the dispatch floors, the admission gates, the coalescers."""
    return [(ex, "TPU_DISPATCH_MIN_ROWS", ex.TPU_DISPATCH_MIN_ROWS)
            for ex in (ref_exec, tpu_exec)] + \
        [(ex, "_observed_min_dt", list(ex._observed_min_dt))
         for ex in (ref_exec, tpu_exec)] + \
        [(g, a, getattr(g, a)) for g in (ref_admission.GATE, admission.GATE)
         for a in ("max_inflight", "max_queued_bytes", "retry_after_s")] + \
        [(c, a, list(getattr(c, a))) for c in (ref_coalesce, coalesce)
         for a in ("_ENABLED", "_WINDOW_MS")]


def _restore(saved):
    for obj, attr, value in saved:
        if isinstance(value, list):
            getattr(obj, attr)[:] = value
        else:
            setattr(obj, attr, value)


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    """Every step sent to the reference's server, then to the port's:
    label -> {"ref": (status, body, headers), "port": ...}."""
    saved = _knobs()
    sides = {}
    out = {}
    try:
        sides["ref"] = Side(False, tmp_path_factory.mktemp("ref"))
        sides["port"] = Side(True, tmp_path_factory.mktemp("port"))
        out["telnet version"] = {k: _telnet(s.tsdb.port, TELNET)
                                 for k, s in sides.items()}
        for label, method, path, params, body, headers, _ in STEPS:
            out[label] = {k: req(s.srv.port, path, method, body, headers,
                                 params) for k, s in sides.items()}
    finally:
        for s in sides.values():
            s.close()
        _restore(saved)
        for fp in (ref_failpoint, failpoint):
            fp.clear_all()
    return out


def _json(body):
    doc = json.loads(body)
    if isinstance(doc, dict):
        doc.pop("execution_time_ms", None)
    return doc


def _close(got, want, where, num):
    """Equal structure; `num(g, w)` for numbers (and numeric strings, as
    the Prometheus API renders values); everything else exact."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}", num)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]", num)
    elif isinstance(want, float) or (isinstance(want, str) and
                                     _numeric(want) and _numeric(got)):
        assert type(got) is type(want), where
        assert num(float(got), float(want)), f"{where}: {got} != {want}"
    else:
        assert type(got) is type(want) and got == want, \
            f"{where}: {got!r} != {want!r}"


def _numeric(s):
    try:
        float(s)
    except (TypeError, ValueError):
        return False
    return isinstance(s, str)


def _rtol(rtol):
    def num(g, w):
        if math.isnan(w) or math.isinf(w):
            return g == w or (math.isnan(g) and math.isnan(w))
        return math.isclose(g, w, rel_tol=rtol, abs_tol=0.0)
    return num


def _sql_bound(g, w):
    if math.isnan(w):
        return math.isnan(g)
    return abs(g - w) <= 1e-5 * abs(w) + 8 * EPS32 * P_ABS


def _decode_read_response(body):
    """ReadResponse → [[(labels, samples)] per query]."""
    out = []
    for _, _, qr in pw.iter_fields(memoryview(snappy.decompress(body))):
        series = []
        for _, _, ts in pw.iter_fields(qr):
            labels, samples = [], []
            for f, _, v in pw.iter_fields(ts):
                fields = {f2: v2 for f2, _, v2 in pw.iter_fields(v)}
                if f == 1:
                    labels.append((bytes(fields[1]).decode(),
                                   bytes(fields[2]).decode()))
                else:
                    samples.append((pw.decode_double(fields[1]),
                                    pw.decode_sint64(fields[2])))
            series.append((labels, samples))
        out.append(series)
    return out


@pytest.mark.parametrize("label", ["telnet version"] +
                         [s[0] for s in STEPS])
def test_port_answers_as_the_reference(exchange, label):
    kind = {s[0]: s[-1] for s in STEPS}.get(label, EXACT)
    if label == "telnet version":
        got, want = exchange[label]["port"], exchange[label]["ref"]
        assert got == want and got.startswith(b"net.opentsdb")
        return
    (gs, gb, gh), (ws, wb, wh) = exchange[label]["port"], \
        exchange[label]["ref"]
    assert gs == ws, (gb, wb)
    assert gh.get("Content-Type") == wh.get("Content-Type")
    if kind == READ:
        assert gs == 200 and gh.get("Content-Encoding") == "snappy"
        assert snappy.decompress(gb) == snappy.decompress(wb)
        return
    if not wb:
        assert gb == wb
        return
    got, want = _json(gb), _json(wb)
    if kind == KEYS:
        assert sorted(got) == sorted(want)
        return
    if kind == ARMED:
        got["failpoints"], want["failpoints"] = (
            [p for p in doc["failpoints"] if p["name"] == "torch_http_probe"]
            for doc in (got, want))
        assert len(want["failpoints"]) == 1
    num = {SQL: _sql_bound, PROM: _rtol(1e-5), "lowered": _rtol(2e-5)}.get(
        kind, lambda g, w: g == w)
    _close(got, want, label, num)


def test_exchange_reached_every_path(exchange):
    """The steps did what they are there for: rows landed, the Prometheus
    API answered on both routes, errors came back as errors, remote read
    found the written samples."""
    def port(label):
        return exchange[label]["port"]

    assert port("remote write")[0] == 204
    assert port("influx bad line")[0] == 400
    assert port("sql error")[0] == 400
    rows = _json(port("remote-written rows")[1])["output"][0]["records"][
        "rows"]
    assert [r[2] for r in rows] == [SAMPLES] * HOSTS
    doc = _json(port("query_range row path")[1])
    assert doc["status"] == "success" and len(doc["data"]["result"]) == 3
    lines = _json(port("query_range explain lowered")[1])["data"]["result"]
    assert any("TpuAggregateExec" in ln for ln in lines), lines
    lines = _json(port("query_range explain row path")[1])["data"]["result"]
    assert not any("TpuAggregateExec" in ln for ln in lines), lines
    (res,) = _decode_read_response(port("remote read")[1])
    (labels, samples), = res
    assert dict(labels) == {"__name__": "node_cpu", "hostname": "h1",
                            "region": "r1"}
    want = [s for s in SERIES if s.labels["__name__"] == "node_cpu" and
            s.labels["hostname"] == "h1"][0].samples
    assert samples == [(v, t) for v, t in want
                       if T0 + 100_000 <= t <= T0 + 400_000]
    (res,) = _decode_read_response(port("remote read regex")[1])
    assert sorted(dict(labels)["hostname"] for labels, _ in res) == \
        ["h0", "h2", "h5"]                      # region r0 or r2, not h3
    assert all(len(samples) == SAMPLES for _, samples in res)
    minutes = {(T0 + i * STEP_MS) // 60_000 for i in range(SAMPLES)}
    assert _json(port("downsample")[1])["rows_written"] == \
        HOSTS * len(minutes)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

@pytest.fixture
def port_server(tmp_path):
    """The port's server over a fresh standalone frontend on the CPU;
    the knobs SET changes are restored after the test."""
    saved = _knobs()
    fe = build_standalone(DatanodeOptions(data_home=str(tmp_path / "home"),
                                          device="cpu"))
    servers = []

    def start(**kw):
        srv = HttpServer(fe, addr="127.0.0.1:0", **kw)
        srv.start()
        servers.append(srv)
        return srv

    try:
        yield fe, start
    finally:
        for srv in servers:
            srv.shutdown()
        fe.shutdown()
        _restore(saved)


def _sql(srv, stmt, headers=None):
    body, h = _form(stmt)
    return req(srv.port, "/v1/sql", "POST", body, {**h, **(headers or {})})


def test_static_user_provider_requires_credentials(port_server):
    _, start = port_server
    srv = start(user_provider=StaticUserProvider({"admin": "pwd123"}))
    status, body, _ = _sql(srv, "SELECT 1")
    assert status == 401
    assert json.loads(body)["code"] == int(StatusCode.USER_PASSWORD_MISMATCH)
    assert _sql(srv, "SELECT 1", _basic("admin", "wrong"))[0] == 401
    assert _sql(srv, "SELECT 1", _basic("admin", "pwd123"))[0] == 200
    assert req(srv.port, "/v1/influxdb/write", "POST", b"m v=1 1",
               params={"u": "admin", "p": "no"})[0] == 401
    assert req(srv.port, "/v1/influxdb/write", "POST", b"m v=1 1",
               {"Authorization": "Token admin:pwd123"})[0] == 204


def test_admission_rejects_statements_past_the_limit(port_server):
    fe, start = port_server
    srv = start()
    assert _sql(srv, "SET admission_max_inflight = 1")[0] == 200
    assert admission.GATE.max_inflight == 1
    # one statement in flight (the registry the gate reads), so the next
    # is past the limit; SET is exempt: the operator's way out
    with process_list.track("SELECT held", protocol="http"):
        status, body, headers = _sql(srv, "SELECT 1")
        assert status == 429 and headers["Retry-After"] == "1"
        doc = json.loads(body)
        assert doc["code"] == int(StatusCode.RATE_LIMITED) == 6001
        assert "admission_max_inflight=1" in doc["error"]
        assert _sql(srv, "SET admission_retry_after_s = 3")[0] == 200
        status, _, headers = _sql(srv, "SELECT 1")
        assert status == 429 and headers["Retry-After"] == "3"
        assert _sql(srv, "SET admission_max_inflight = 0")[0] == 200
        assert _sql(srv, "SELECT 1")[0] == 200
    status, body, _ = req(srv.port, "/status")
    assert json.loads(body)["admission"]["rejected_total"] >= 2
    assert _sql(srv, "SET admission_max_inflight = -1")[0] == 400


def test_admission_rejects_ingest_past_the_byte_budget(port_server):
    fe, start = port_server
    srv = start()
    assert _sql(srv, "SET admission_max_queued_bytes = 64")[0] == 200
    body = b"m,host=a v=1 1700000000000\n" * 4          # 108 bytes
    # an idle gate admits one body larger than the budget
    assert req(srv.port, "/v1/influxdb/write", "POST", body,
               params={"precision": "ms"})[0] == 204
    with admission.GATE.admit_ingest(10):             # bytes in flight
        for path, payload in (("/v1/influxdb/write", body),
                              ("/v1/prometheus/write",
                               prometheus.encode_write_request(SERIES[:2])),
                              ("/v1/opentsdb/api/put", TSDB_PUT)):
            status, out, headers = req(srv.port, path, "POST", payload)
            assert status == 429 and "Retry-After" in headers, path
            assert json.loads(out)["code"] == 6001
    assert admission.GATE.snapshot()["queued_bytes"] == 0
    assert _sql(srv, "SET admission_max_queued_bytes = 0")[0] == 200
    assert req(srv.port, "/v1/influxdb/write", "POST", body * 40,
               params={"precision": "ms"})[0] == 204


def test_concurrent_influx_bodies_coalesce(port_server):
    fe, start = port_server
    srv = start()
    assert _sql(srv, "SET ingest_coalesce = 1")[0] == 200
    assert _sql(srv, "SET ingest_coalesce_window_ms = 500")[0] == 200
    assert coalesce.coalescer_settings() == (True, 500.0)
    reg = telemetry.registry()

    def counter(name):
        return reg.get_sample_value(f"greptime_{name}_total") or 0.0

    before = {n: counter(n) for n in ("ingest_coalesce_batches",
                                      "ingest_coalesce_merged_requests",
                                      "ingest_coalesce_follower_acks")}
    senders, rows = 8, 25
    gate = threading.Barrier(senders)
    results = [None] * senders

    def send(i):
        body = "".join(f"co,host=h{i} v={j}.5,n={j}i {T0 + j * 1000}\n"
                       for j in range(rows)).encode()
        gate.wait(timeout=TIMEOUT_S)
        results[i] = req(srv.port, "/v1/influxdb/write", "POST", body,
                         params={"precision": "ms"})[0]

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(senders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == [204] * senders
    moved = {n: counter(n) - v for n, v in before.items()}
    assert moved["ingest_coalesce_merged_requests"] >= 1, moved
    assert moved["ingest_coalesce_batches"] + \
        moved["ingest_coalesce_merged_requests"] == senders, moved
    assert moved["ingest_coalesce_follower_acks"] == \
        moved["ingest_coalesce_merged_requests"]
    (out,) = fe.do_query("SELECT host, count(*), sum(n) FROM co GROUP BY "
                         "host ORDER BY host")
    assert [tuple(r) for b in out.batches for r in b.rows()] == \
        [(f"h{i}", rows, rows * (rows - 1) // 2) for i in range(senders)]
    assert _sql(srv, "SET ingest_coalesce_window_ms = -1")[0] == 400
    assert _sql(srv, "SET ingest_coalesce = 0")[0] == 200
    assert coalesce.coalescer_settings()[0] is False


def _recorder(base):
    class Recording(base):
        def __init__(self):
            self.calls = []

        def pre_parsing(self, sql, ctx):
            self.calls.append(("pre_parsing", sql))
            return sql.replace("__TABLE__", "t")

        def post_parsing(self, statements, ctx):
            self.calls.append(("post_parsing",
                               [type(s).__name__ for s in statements]))
            return statements

        def pre_execute(self, statement, ctx):
            self.calls.append(("pre_execute", type(statement).__name__))
            if "forbidden" in repr(statement):
                raise PermissionError("rejected by the interceptor")

        def post_execute(self, output, ctx):
            self.calls.append(("post_execute", output.is_batches))
            return output
    return Recording()


def test_interceptor_plugin_sees_the_same_calls(tmp_path):
    script = ["CREATE TABLE __TABLE__ (h STRING, ts TIMESTAMP TIME INDEX, "
              "v DOUBLE, PRIMARY KEY(h))",
              "INSERT INTO __TABLE__ VALUES ('a', 1, 1.5); SELECT h, v FROM "
              "__TABLE__",
              "SET admission_max_inflight = 0; SELECT 'forbidden'"]
    seen, rows = {}, {}
    for side in ("ref", "port"):
        if side == "port":
            fe = build_standalone(DatanodeOptions(
                data_home=str(tmp_path / side), device="cpu"))
            rec, ctx = _recorder(interceptor.SqlQueryInterceptor), \
                QueryContext()
        else:
            fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(tmp_path / side))))
            fe.start()
            rec, ctx = _recorder(ref_interceptor.SqlQueryInterceptor), \
                RefCtx()
        try:
            fe.plugins.insert(rec)
            assert fe._interceptor() is rec
            fe.do_query(script[0], ctx)
            out = fe.do_query(script[1], ctx)[-1]
            rows[side] = [tuple(r) for b in out.batches for r in b.rows()]
            with pytest.raises(PermissionError, match="interceptor"):
                fe.do_query(script[2], ctx)
            seen[side] = rec.calls
        finally:
            fe.shutdown()
    assert seen["port"] == seen["ref"]
    assert rows["port"] == rows["ref"] == [("a", 1.5)]
    assert [c[0] for c in seen["port"][:4]] == [
        "pre_parsing", "post_parsing", "pre_execute", "post_execute"]


def test_metrics_serve_the_ports_registry(port_server):
    fe, start = port_server
    srv = start()
    telemetry.increment_counter("torch_http_port_only")
    ref_telemetry.increment_counter("torch_http_reference_only")
    assert _sql(srv, "SELECT 1")[0] == 200
    status, body, headers = req(srv.port, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = body.decode()
    assert "greptime_torch_http_port_only_total 1.0" in text
    assert "torch_http_reference_only" not in text
    assert 'greptime_http_request_seconds_bucket{le="' in text


@pytest.mark.parametrize("method, path, module", [
    ("GET", "/v1/trace/last", "common/trace_store.py"),
    ("GET", "/debug/prof/cpu", "common/profiler.py"),
    ("POST", "/v1/scripts?name=s", "script/"),
    ("POST", "/v1/run-script?name=s", "script/"),
])
def test_unported_routes_answer_the_error_envelope(port_server, method,
                                                   path, module):
    _, start = port_server
    srv = start()
    status, body, headers = req(srv.port, path, method,
                                b"" if method == "POST" else None)
    assert status == 400 and headers["Content-Type"].startswith(
        "application/json")
    doc = json.loads(body)
    assert doc["code"] == int(StatusCode.UNSUPPORTED)
    assert module in doc["error"] and "not ported yet" in doc["error"]
    assert sorted(doc) == ["code", "error", "execution_time_ms"]


def test_https_server_answers_health(port_server, tmp_path):
    pytest.importorskip("cryptography")
    _, start = port_server
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    tls.make_self_signed(cert, key)
    opt = tls.TlsOption.from_config({"mode": "require", "cert_path": cert,
                                     "key_path": key})
    srv = start(ssl_context=opt.setup())
    client = ssl.create_default_context()
    client.check_hostname = False
    client.verify_mode = ssl.CERT_NONE
    status, body, _ = req(srv.port, "/health", scheme="https",
                          context=client)
    assert (status, json.loads(body)) == (200, {})
    assert tls.TlsOption().setup() is None
    with pytest.raises(ValueError, match="cert_path"):
        tls.TlsOption(mode="prefer").setup()
