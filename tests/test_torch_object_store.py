"""Differential tests of the port's S3 object store and LRU disk cache.

greptimedb_tpu_torch/storage/{s3,cache}.py against the reference's
greptimedb_tpu/storage/{s3,cache}.py, and `build_object_store` /
`RetryingObjectStore` in both packages. Both packages' stores talk to the
same mock S3 endpoint (a copy of the reference tests' handler, with
paged ListObjectsV2, forced statuses and a request log), get the same
operations and must give the same bytes, key lists, request headers
(the clock frozen in both modules), error types, retries, cache hits,
misses and eviction order, recovery after a restart and corrupt-blob
fallback. A table created, written, flushed and reopened with a fresh
cache on S3 answers the same in both packages, over bucket layouts that
differ only in SST file names.
"""

import datetime
import http.server
import json
import os
import re
import subprocess
import sys
import threading
import types
import urllib.parse

import pytest

from greptimedb_tpu.common import failpoint as ref_fp
from greptimedb_tpu.common import telemetry as ref_tel
from greptimedb_tpu.storage import cache as ref_cache
from greptimedb_tpu.storage import object_store as ref_os
from greptimedb_tpu.storage import retry as ref_retry
from greptimedb_tpu.storage import s3 as ref_s3
from greptimedb_tpu_torch.common import failpoint as port_fp
from greptimedb_tpu_torch.common import telemetry as port_tel
from greptimedb_tpu_torch.storage import cache as port_cache
from greptimedb_tpu_torch.storage import object_store as port_os
from greptimedb_tpu_torch.storage import retry as port_retry
from greptimedb_tpu_torch.storage import s3 as port_s3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "reference": types.SimpleNamespace(
        s3=ref_s3, cache=ref_cache, os=ref_os, retry=ref_retry, fp=ref_fp,
        tel=ref_tel),
    "port": types.SimpleNamespace(
        s3=port_s3, cache=port_cache, os=port_os, retry=port_retry,
        fp=port_fp, tel=port_tel),
}


def make_handler(state):
    """S3 REST semantics over `state.objects` (full key "bucket/key" ->
    bytes): PUT, GET, HEAD, DELETE and ListObjectsV2 paged by
    `state.page` keys. `state.status` forces a status per method
    ("LIST" for listings); every request is logged with its headers."""

    class MockS3Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _key(self):
            return urllib.parse.unquote(self.path.split("?")[0].lstrip("/"))

        def _log(self, method):
            state.requests.append((method, self.path, {
                k.lower(): v for k, v in self.headers.items()}))

        def _forced(self, method):
            status = state.status.get(method)
            if status is None:
                return False
            body = b"<Error><Code>Forced</Code></Error>"
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(body)
            return True

        def _reply(self, status, payload=b""):
            self.send_response(status)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_PUT(self):
            self._log("PUT")
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if self._forced("PUT"):
                return
            state.objects[self._key()] = data
            self._reply(200)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            query = urllib.parse.parse_qs(parsed.query)
            if "list-type" in query:
                self._log("LIST")
                if self._forced("LIST"):
                    return
                bucket = parsed.path.lstrip("/")
                prefix = query.get("prefix", [""])[0]
                after = query.get("continuation-token", [""])[0]
                keys = sorted(k[len(bucket) + 1:] for k in state.objects
                              if k.startswith(f"{bucket}/{prefix}"))
                keys = [k for k in keys if k > after]
                page, more = keys[:state.page], len(keys) > state.page
                body = "<ListBucketResult>" + "".join(
                    f"<Contents><Key>{k}</Key></Contents>" for k in page)
                body += f"<IsTruncated>{'true' if more else 'false'}" \
                    "</IsTruncated>"
                if more:
                    body += f"<NextContinuationToken>{page[-1]}" \
                        "</NextContinuationToken>"
                self._reply(200, (body + "</ListBucketResult>").encode())
                return
            self._log("GET")
            if self._forced("GET"):
                return
            data = state.objects.get(self._key())
            if data is None:
                self._reply(404)
                return
            self._reply(200, data)

        def do_HEAD(self):
            self._log("HEAD")
            if self._forced("HEAD"):
                return
            self.send_response(200 if self._key() in state.objects else 404)
            self.end_headers()

        def do_DELETE(self):
            self._log("DELETE")
            if self._forced("DELETE"):
                return
            state.objects.pop(self._key(), None)
            self._reply(204)

    return MockS3Handler


@pytest.fixture()
def mock_s3():
    state = types.SimpleNamespace(objects={}, requests=[], status={},
                                  page=1000)
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                             make_handler(state))
    # a short poll, so that shutdown() does not wait half a second
    thread = threading.Thread(target=server.serve_forever, args=(0.01,),
                              daemon=True)
    thread.start()
    state.endpoint = f"http://127.0.0.1:{server.server_address[1]}"

    def reset():
        state.objects.clear()
        state.requests.clear()
        state.status.clear()
    state.reset = reset
    yield state
    server.shutdown()
    server.server_close()


def s3_store(side, endpoint, root="greptime", bucket="bucket"):
    s3 = SIDES[side].s3
    return s3.S3ObjectStore(s3.S3Config(
        bucket=bucket, root=root, endpoint=endpoint, access_key_id="ak",
        secret_access_key="sk"))


@pytest.fixture()
def fast_retry(monkeypatch):
    """Both packages' retry knobs: 3 retries, 1 ms first backoff."""
    for side in SIDES.values():
        monkeypatch.setattr(side.retry, "_max_retries", [3])
        monkeypatch.setattr(side.retry, "_base_ms", [1])


def counter(side, name):
    tel = SIDES[side].tel
    c = tel._counters.get(tel._sanitize(name))
    return 0 if c is None else c._value.get()


def outcome(fn):
    """What an operation gave: its value, or its error's type, whether
    it is transient and its message."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error is the answer
        transient = any(isinstance(e, s.s3.S3TransientError)
                        for s in SIDES.values())
        return (type(e).__name__, transient, str(e))


def store_ops(store):
    """One sequence over the ObjectStore surface; every answer."""
    out = []
    for i in range(5):
        store.write(f"d/{i}", f"v{i}".encode() * (i + 1))
    store.write("e/x", b"")
    store.write("sp ace/ü", b"unicode")
    out.append(store.read("d/3"))
    out.append(store.read("e/x"))
    out.append(store.read("sp ace/ü"))
    out.append(store.list("d/"))
    out.append(store.list(""))
    out.append((store.exists("d/0"), store.exists("nope")))
    out.append(outcome(lambda: store.read("nope")))
    store.delete("d/0")
    store.delete("d/0")
    out.append(store.list("d/"))
    store.delete_dir("d")
    out.append(store.list("d/"))
    out.append(store.local_path("e/x"))
    return out


@pytest.mark.parametrize("page", [1, 2, 1000])
def test_store_operations_equal(mock_s3, page):
    """The same operations give the same answers and leave the same
    objects, with listings paged by 1, 2 and 1000 keys."""
    mock_s3.page = page
    got = {}
    for side in SIDES:
        mock_s3.reset()
        got[side] = (store_ops(s3_store(side, mock_s3.endpoint)),
                     dict(mock_s3.objects),
                     [(m, p) for m, p, _ in mock_s3.requests])
    assert got["port"] == got["reference"]
    assert got["port"][0][4] == ["d/0", "d/1", "d/2", "d/3", "d/4", "e/x",
                                 "sp ace/ü"]


def _frozen_datetime(now):
    class Frozen(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return now
    return types.SimpleNamespace(datetime=Frozen,
                                 timezone=datetime.timezone)


def test_authorization_headers_equal_under_frozen_clock(mock_s3,
                                                        monkeypatch):
    """SigV4: with the clock frozen in both modules, every request of
    the sequence carries byte-identical signed headers."""
    now = datetime.datetime(2026, 3, 1, 12, 34, 56,
                            tzinfo=datetime.timezone.utc)
    for side in SIDES.values():
        monkeypatch.setattr(side.s3, "datetime", _frozen_datetime(now))
    mock_s3.page = 2
    heads = {}
    for side in SIDES:
        mock_s3.reset()
        store_ops(s3_store(side, mock_s3.endpoint))
        heads[side] = [(m, p, {k: h[k] for k in (
            "authorization", "x-amz-date", "x-amz-content-sha256",
            "host")}) for m, p, h in mock_s3.requests]
    assert heads["port"] == heads["reference"]
    assert heads["port"][0][2]["x-amz-date"] == "20260301T123456Z"
    assert heads["port"][0][2]["authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=ak/20260301/us-east-1/s3/aws4_request"
        ", SignedHeaders=host;x-amz-content-sha256;x-amz-date, Signature=")


def test_sign_is_identical():
    """`_sign` on the same request and instant, with an AWS endpoint (no
    `endpoint` given) and a region of its own."""
    now = datetime.datetime(2016, 1, 1)
    got = {}
    for side, m in SIDES.items():
        store = m.s3.S3ObjectStore(m.s3.S3Config(
            bucket="b", root="/r/", region="eu-west-1",
            access_key_id="AKID", secret_access_key="SECRET"))
        got[side] = (store._host, store._secure, store._root,
                     store._sign("PUT", "/b/r/k%20x", "a=1&b=2",
                                 ref_s3._sha256(b"body"), now))
    assert got["port"] == got["reference"]


OPS = {
    "read": lambda s: s.read("k"),
    "write": lambda s: s.write("k", b"v"),
    "delete": lambda s: s.delete("k"),
    "exists": lambda s: s.exists("k"),
    "list": lambda s: s.list("p/"),
}
METHOD = {"read": "GET", "write": "PUT", "delete": "DELETE",
          "exists": "HEAD", "list": "LIST"}


@pytest.mark.parametrize("status", [200, 204, 400, 403, 404, 409, 429, 500,
                                    502, 503, 504, 509])
@pytest.mark.parametrize("op", list(OPS))
def test_status_maps_to_the_same_error(mock_s3, op, status):
    """The status → error table: which statuses each operation accepts,
    which are terminal (S3Error) and which transient (S3TransientError),
    with the same messages."""
    got = {}
    for side in SIDES:
        mock_s3.reset()
        mock_s3.objects["bucket/greptime/k"] = b"v"
        mock_s3.status[METHOD[op]] = status
        got[side] = outcome(lambda: OPS[op](s3_store(side,
                                                     mock_s3.endpoint)))
    assert got["port"] == got["reference"]
    if status in ref_s3._TRANSIENT_STATUSES:
        assert got["port"][:2] == ("S3TransientError", True)
    assert port_s3._TRANSIENT_STATUSES == ref_s3._TRANSIENT_STATUSES


def test_socket_error_is_transient():
    """No status line (a closed port): S3TransientError in both."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = {side: outcome(lambda: s3_store(
        side, f"http://127.0.0.1:{port}").read("k"))[:2] for side in SIDES}
    assert got == {"reference": ("S3TransientError", True),
                   "port": ("S3TransientError", True)}


@pytest.mark.parametrize("spec,status", [
    ("2x4*err(transient)", None), ("4x5*err(transient)", None),
    ("err", None), (None, 503), (None, 403)])
def test_retries_equal(mock_s3, fast_retry, spec, status):
    """RetryingObjectStore over S3: an armed `objstore_request`
    failpoint (transient twice then through; past the retry budget;
    terminal) and forced statuses retry the same number of times, with
    the same counters and the same outcome."""
    got = {}
    for side, m in SIDES.items():
        mock_s3.reset()
        mock_s3.objects["bucket/greptime/k"] = b"v"
        if status is not None:
            mock_s3.status["GET"] = status
        store = m.retry.RetryingObjectStore(s3_store(side, mock_s3.endpoint))
        before = (counter(side, "objstore_retry"),
                  counter(side, "objstore_retry_giveup"))
        if spec is not None:
            with m.fp.cfg("objstore_request", spec):
                res = outcome(lambda: store.read("k"))
        else:
            res = outcome(lambda: store.read("k"))
        got[side] = (res[:2], len(mock_s3.requests),
                     counter(side, "objstore_retry") - before[0],
                     counter(side, "objstore_retry_giveup") - before[1])
    assert got["port"] == got["reference"]


def test_s3_transient_error_is_transient():
    """`is_transient` knows the S3 taxonomy in both packages."""
    for side, m in SIDES.items():
        assert m.retry.is_transient(m.s3.S3TransientError("x")), side
        assert not m.retry.is_transient(m.s3.S3Error("x")), side


def cache_ops(layer, cache_dir):
    """One sequence over the cache layer (capacity 64 bytes); a snapshot
    of hits, misses, the LRU order with sizes, the byte total and the
    cache directory after each step."""
    snaps = []

    def snap(what, value=None):
        snaps.append((what, value, layer.hits, layer.misses,
                      list(layer._entries.items()), layer._size,
                      sorted(os.listdir(cache_dir))))

    for i in range(4):
        layer.write(f"k{i}", bytes([65 + i]) * (10 * (i + 1)))
        snap(f"write k{i}")
    for k in ("k0", "k1", "k0", "k2", "k3", "k1", "k0"):
        snap(f"read {k}", layer.read(k))
    snap("exists k3", layer.exists("k3"))
    layer.write("k0", b"z" * 5)                  # invalidates k0
    snap("rewrite k0")
    snap("read k0", layer.read("k0"))
    layer.write("big", b"B" * 100)
    snap("read big", layer.read("big"))          # over capacity: kept alone
    layer.delete("big")
    snap("delete big")
    layer.write("dir/a", b"a" * 3)
    layer.write("dir/b", b"b" * 4)
    snap("read dir/a", layer.read("dir/a"))
    snap("read dir/b", layer.read("dir/b"))
    layer.delete_dir("dir")
    snap("delete_dir", layer.list("dir/"))
    snap("local_path k2", os.path.basename(layer.local_path("k2")))
    snap("local_path nope", layer.local_path("nope"))
    snap("hit_ratio", layer.hit_ratio())
    return snaps


def test_cache_hits_misses_and_eviction_order(mock_s3, tmp_path):
    """LRU by total bytes, at least one entry kept, invalidation on write
    and delete, `local_path` pulling through: step for step the same."""
    got = {}
    for side, m in SIDES.items():
        mock_s3.reset()
        d = str(tmp_path / side)
        layer = m.cache.LruCacheLayer(
            s3_store(side, mock_s3.endpoint), d, capacity_bytes=64)
        got[side] = cache_ops(layer, d)
    assert got["port"] == got["reference"]
    kinds = [s[0] for s in got["port"]]
    assert "read big" in kinds


def test_cache_recovers_after_restart(mock_s3, tmp_path):
    """A new layer on the cache directory rebuilds the same index
    (`_recover`) and serves hits without touching S3."""
    got = {}
    for side, m in SIDES.items():
        mock_s3.reset()
        d = str(tmp_path / side)
        first = m.cache.LruCacheLayer(s3_store(side, mock_s3.endpoint), d,
                                      capacity_bytes=1000)
        for i in range(5):
            first.write(f"r/{i}", bytes([48 + i]) * (7 + i))
            first.read(f"r/{i}")
        with open(os.path.join(d, "stray"), "wb") as f:
            f.write(b"not an entry")
        again = m.cache.LruCacheLayer(s3_store(side, mock_s3.endpoint), d,
                                      capacity_bytes=1000)
        n = len(mock_s3.requests)
        reads = [again.read(f"r/{i}") for i in range(5)]
        got[side] = (list(again._entries.items()), again._size, reads,
                     again.hits, again.misses, len(mock_s3.requests) - n)
    assert got["port"] == got["reference"]
    assert got["port"][3:] == (5, 0, 0)


@pytest.mark.parametrize("damage", ["truncate", "remove", "failpoint"])
def test_corrupt_blob_falls_back(mock_s3, tmp_path, damage):
    """A truncated blob or one failing the `cache_read` failpoint is
    dropped and read cold (`read_cache_corrupt`); a missing blob is a
    miss. Same answers, counters and index in both packages."""
    names = ("read_cache_hit", "read_cache_miss", "read_cache_corrupt")
    got = {}
    for side, m in SIDES.items():
        mock_s3.reset()
        d = str(tmp_path / side)
        layer = m.cache.LruCacheLayer(s3_store(side, mock_s3.endpoint), d)
        layer.write("k", b"payload")
        layer.read("k")
        blob = layer._cache_path("k")
        before = [counter(side, n) for n in names]
        if damage == "truncate":
            with open(blob, "wb") as f:
                f.write(b"pay")
            data = layer.read("k")
        elif damage == "remove":
            os.unlink(blob)
            data = layer.read("k")
        else:
            with m.fp.cfg("cache_read", "err"):
                data = layer.read("k")
        got[side] = (data, layer.hits, layer.misses,
                     list(layer._entries.items()),
                     [counter(side, n) - b for n, b in zip(names, before)],
                     layer.read("k"), layer.hits)
    assert got["port"] == got["reference"]
    assert got["port"][0] == b"payload"


CONFIGS = {
    "file": {"type": "File"},
    "file+cache": {"type": "File", "cache_path": "{tmp}/c1",
                   "cache_capacity": 4096},
    "s3": {"type": "S3", "bucket": "b", "root": "r", "endpoint": "{ep}",
           "access_key_id": "ak", "secret_access_key": "sk",
           "region": "eu-central-1"},
    "s3+cache": {"type": "S3", "bucket": "b", "endpoint": "{ep}",
                 "cache_path": "{tmp}/c2"},
    "unknown": {"type": "Oss"},
}


def layering(store):
    out = []
    while store is not None:
        desc = [type(store).__name__]
        if hasattr(store, "capacity_bytes"):
            desc.append(store.capacity_bytes)
        if hasattr(store, "config"):
            c = store.config
            desc += [c.bucket, c.root, c.endpoint, c.region,
                     c.access_key_id]
        out.append(tuple(desc))
        store = getattr(store, "inner", None)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_build_object_store_layering(mock_s3, tmp_path, name):
    """`build_object_store`: the backend inside RetryingObjectStore, the
    LRU cache on top when `cache_path` is set (512 MiB by default)."""
    cfg = {k: v.format(tmp=tmp_path, ep=mock_s3.endpoint)
           if isinstance(v, str) else v for k, v in CONFIGS[name].items()}
    got = {}
    for side, m in SIDES.items():
        res = outcome(lambda: layering(m.os.build_object_store(
            dict(cfg), str(tmp_path / "home"))))
        got[side] = res
    assert got["port"] == got["reference"]
    if name == "s3+cache":
        assert got["port"][1][0] == ("LruCacheLayer", 512 * 1024 * 1024)
        assert [d[0] for d in got["port"][1]] == [
            "LruCacheLayer", "RetryingObjectStore", "S3ObjectStore"]


# ---------------------------------------------------------------------------
# a table on S3 behind the cache, in both packages
# ---------------------------------------------------------------------------

def open_frontend(side, home, store):
    if side == "reference":
        from greptimedb_tpu.datanode.instance import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu.frontend.instance import FrontendInstance
        dn = DatanodeInstance(DatanodeOptions(
            data_home=home, register_numbers_table=False), store=store)
    else:
        from greptimedb_tpu_torch.datanode import (
            DatanodeInstance, DatanodeOptions)
        from greptimedb_tpu_torch.frontend import FrontendInstance
        dn = DatanodeInstance(DatanodeOptions(
            data_home=home, register_numbers_table=False, device="cpu"),
            store=store)
    fe = FrontendInstance(dn)
    fe.start()
    return fe


def rows(fe, sql):
    (out,) = fe.do_query(sql)
    if not out.is_batches:
        return out.affected_rows
    return [tuple(r) for b in out.batches for r in b.rows()]


STATEMENTS = (
    "CREATE TABLE cpu (host STRING, dc STRING, ts TIMESTAMP TIME INDEX, "
    "u DOUBLE, s BIGINT, PRIMARY KEY(host, dc))",
    "INSERT INTO cpu VALUES ('h0', 'a', 1000, 1.5, 7), ('h1', 'b', 1000, "
    "2.25, 8), ('h0', 'a', 2000, 3.0, NULL), ('h2', 'a', 3000, -1.0, 9)",
    "ADMIN FLUSH TABLE cpu",
    "INSERT INTO cpu VALUES ('h1', 'b', 2000, 4.5, 1), ('h0', 'a', 1000, "
    "9.5, 2)",
    "ADMIN FLUSH TABLE cpu",
)
QUERIES = (
    "SELECT host, dc, ts, u, s FROM cpu ORDER BY host, ts",
    "SELECT host, count(*), sum(u), max(u), min(s) FROM cpu GROUP BY host "
    "ORDER BY host",
    "SELECT count(*) FROM cpu WHERE dc = 'a'",
)

#: SST and index file names are random ids
_FILE_ID = re.compile(r"[0-9a-f]{8}-?[0-9a-f]{4}-?[0-9a-f]{4}-?[0-9a-f]{4}-?"
                      r"[0-9a-f]{12}")


def test_table_on_s3_behind_the_cache(mock_s3, tmp_path):
    """CREATE, INSERT, FLUSH, more writes and a second flush on S3 with
    the cache; shutdown; reopen on the same bucket with a fresh, empty
    cache: the catalog and manifests come back from S3, the SSTs are
    read through the cache (misses first, hits after), and the answers
    equal the reference's, before and after the reopen. The two
    packages' bucket layouts differ only in file ids."""
    got, layouts = {}, {}
    for side, m in SIDES.items():
        home = str(tmp_path / side / "home")

        def store(cache):
            return m.cache.LruCacheLayer(m.retry.RetryingObjectStore(
                s3_store(side, mock_s3.endpoint, root=side)),
                str(tmp_path / side / cache))
        fe = open_frontend(side, home, store("cache1"))
        try:
            written = [rows(fe, s) for s in STATEMENTS]
            before = [rows(fe, q) for q in QUERIES]
        finally:
            fe.shutdown()
        layer = store("cache2")
        fe = open_frontend(side, home, layer)
        try:
            misses0 = layer.misses
            first = [rows(fe, q) for q in QUERIES]
            pulled = layer.misses - misses0
            again = [rows(fe, q) for q in QUERIES]
            cached = sorted(layer._entries)
        finally:
            fe.shutdown()
        got[side] = (written, before, first, again)
        assert before == first == again, side
        assert pulled > 0 and any(k.endswith(".parquet") for k in cached)
        layouts[side] = sorted(_FILE_ID.sub(
            "<id>", k[len(f"bucket/{side}/"):]) for k in mock_s3.objects
            if k.startswith(f"bucket/{side}/"))
    assert got["port"] == got["reference"]
    assert layouts["port"] == layouts["reference"]
    assert any(k.endswith(".parquet") for k in layouts["port"])


_FAILPOINTS_PROBE = r"""
import json, sys, tempfile
pkg = sys.argv[1]
fe_mod = __import__(pkg + ".frontend.instance", fromlist=["x"])
fp = __import__(pkg + ".common.failpoint", fromlist=["x"])
os_mod = __import__(pkg + ".storage.object_store", fromlist=["x"])
dn_mod = __import__(pkg + ".datanode.instance", fromlist=["x"])
with tempfile.TemporaryDirectory() as home:
    kw = {"device": "cpu"} if pkg.endswith("torch") else {}
    dn = dn_mod.DatanodeInstance(dn_mod.DatanodeOptions(
        data_home=home, register_numbers_table=False, **kw))
    fe = fe_mod.FrontendInstance(dn)
    fe.start()
    fe.do_query("CREATE TABLE t (h STRING, ts TIMESTAMP TIME INDEX, "
                "v DOUBLE, PRIMARY KEY(h))")
    fe.do_query("INSERT INTO t VALUES ('a', 1, 1.0)")
    fe.do_query("ADMIN FLUSH TABLE t")
    before = sorted(p["name"] for p in fp.list_points())
    fe.shutdown()
    os_mod.build_object_store({"type": "S3", "bucket": "b",
                               "endpoint": "http://127.0.0.1:9",
                               "cache_path": home + "/c"}, home)
    after = sorted(p["name"] for p in fp.list_points())
print(json.dumps([before, after]))
"""


def test_failpoints_register_when_the_reference_does():
    """In a fresh process the failpoint registry lists the same names as
    the reference's: without `objstore_request` and `cache_read` until an
    S3 store with a cache is built, with both after."""
    got = {}
    for pkg in ("greptimedb_tpu", "greptimedb_tpu_torch"):
        out = subprocess.run(
            [sys.executable, "-c", _FAILPOINTS_PROBE, pkg], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-2000:]
        got[pkg] = json.loads(out.stdout.strip().splitlines()[-1])
    new = ("objstore_request", "cache_read")
    for pkg, (before, after) in got.items():
        assert [n in before for n in new] == [False, False], pkg
        assert [n in after for n in new] == [True, True], pkg
    # the names the port registers are the reference's (the reference
    # also has the distributed plane's, which the port has not)
    for i in (0, 1):
        assert set(got["greptimedb_tpu_torch"][i]) <= \
            set(got["greptimedb_tpu"][i])
