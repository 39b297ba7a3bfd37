"""Protocol codecs and parsers: the port's against the JAX package's, on
the CPU, exact.

- Snappy (`utils/snappy.py`, `native/snappy.cpp`): the port's native
  compression is byte-identical to the reference's on seeded random,
  repetitive, empty and over-64-KiB buffers; each package decompresses
  the other's output; the pure-Python codecs (literal-only encoder, full
  decoder) agree too, and corrupt input raises `ValueError` in both.
- `utils/protowire.py` and the Prometheus write request, read request
  and read response (`servers/prometheus.py`): byte-identical encodings
  and equal decodes.
- InfluxDB line protocol (`servers/influxdb.py`): `parse_lines` and
  `body_to_inserts` over a corpus with escapes, every precision,
  integer, boolean and string fields give equal results; malformed lines
  raise errors of the same class with the same message.
- OpenTSDB (`servers/opentsdb.py`): `parse_telnet_put`, `parse_http_put`
  and `points_to_inserts` the same.

The reference builds its snappy library into one temporary path from
every process, so test processes that start together can collide in
that build (as with its native WAL, tests/test_torch_storage.py);
`_reference_snappy` loads it under a lock that every process shares, and
a library that really does not build still fails the native cases.
"""

import fcntl
import os
import shutil
import struct
import tempfile
import time

import numpy as np
import pytest

from greptimedb_tpu.errors import GreptimeError as RefGreptimeError
from greptimedb_tpu.servers import influxdb as ref_influx
from greptimedb_tpu.servers import opentsdb as ref_tsdb
from greptimedb_tpu.servers import prometheus as ref_prom
from greptimedb_tpu.utils import protowire as ref_pw
from greptimedb_tpu.utils import snappy as ref_snappy
from greptimedb_tpu_torch.errors import GreptimeError
from greptimedb_tpu_torch.servers import influxdb, opentsdb, prometheus
from greptimedb_tpu_torch.utils import protowire as pw
from greptimedb_tpu_torch.utils import snappy

NEEDS_GXX = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="both native snappy codecs build with g++, which this machine "
           "lacks")


def _buffers():
    rng = np.random.default_rng(12)
    words = [b"cpu", b"usage_user", b"host_", b"region=eu-west-1",
             b"\x00\x01", b"greptime_value"]
    mixed = b"".join(words[i] + str(i * 7).encode()
                     for i in rng.integers(0, len(words), 40_000))
    return {
        "empty": b"",
        "one byte": b"a",
        "sixty bytes": bytes(rng.integers(0, 256, 60, dtype=np.uint8)),
        "sixty-one bytes": bytes(rng.integers(0, 256, 61, dtype=np.uint8)),
        "random 4 KiB": bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        "repetitive": b"hello world " * 1000,
        "byte ramp": bytes(range(256)) * 300,
        "one run": b"\x07" * 70_000,
        "random 200 KiB": bytes(rng.integers(0, 256, 200_000,
                                             dtype=np.uint8)),
        "mixed over 64 KiB": mixed,
        "floats": np.cumsum(rng.normal(size=30_000)).astype("<f8")
        .tobytes(),
    }


BUFFERS = _buffers()


def _reference_snappy():
    """The reference's native snappy, loaded under an exclusive lock that
    every test process shares: its first build in each process compiles
    into one shared temporary file and renames it into place, so builds
    that overlap can collide and latch `_lib_failed`. Under the lock the
    latch is cleared and the load tried again a few times."""
    lock = os.path.join(tempfile.gettempdir(),
                        "greptimedb_tpu-libgdbsnappy.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for _ in range(5):
                ref_snappy._lib_failed = False
                try:
                    if ref_snappy._load() is not None:
                        break
                except OSError:
                    pass        # another process is still writing it
                time.sleep(0.5)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    assert ref_snappy._lib is not None, "the reference's snappy did not load"
    assert snappy._load() is not None, "the port's snappy did not load"
    assert snappy._lib._name != ref_snappy._lib._name


@NEEDS_GXX
@pytest.mark.parametrize("name", list(BUFFERS))
def test_native_compression_is_byte_identical(name):
    _reference_snappy()
    data = BUFFERS[name]
    got, want = snappy.compress(data), ref_snappy.compress(data)
    assert got == want
    if len(data) > 1000 and name.startswith(("repetitive", "byte", "one",
                                             "mixed")):
        assert len(got) < len(data) // 2     # the hash-match encoder ran


@NEEDS_GXX
@pytest.mark.parametrize("name", list(BUFFERS))
def test_each_package_decompresses_the_others(name):
    _reference_snappy()
    data = BUFFERS[name]
    assert snappy.decompress(ref_snappy.compress(data)) == data
    assert ref_snappy.decompress(snappy.compress(data)) == data
    # the literal-only encodings too
    assert snappy.decompress(ref_snappy._py_compress(data)) == data
    assert ref_snappy.decompress(snappy._py_compress(data)) == data


@pytest.mark.parametrize("name", list(BUFFERS))
def test_python_codecs_agree(name):
    """The host fallbacks: literal-only encodings byte-identical, and the
    pure-Python decoders equal on literal and hash-matched input (the
    latter from the port's codec, native where it built)."""
    data = BUFFERS[name]
    lit = snappy._py_compress(data)
    assert lit == ref_snappy._py_compress(data)
    assert snappy._py_decompress(lit) == ref_snappy._py_decompress(lit) \
        == data
    if data:
        packed = snappy.compress(data)
        assert snappy._py_decompress(packed) == \
            ref_snappy._py_decompress(packed) == data


CORRUPT = {
    "truncated literal": b"\x0a\x24abc",
    "bad copy offset": b"\x08\x01\x00",
    "length mismatch": b"\x05\x00a",
    "truncated varint": b"\xff\xff",
}


@pytest.mark.parametrize("native", [False, pytest.param(True,
                                                        marks=NEEDS_GXX)])
@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_input_raises_in_both(name, native):
    if native:
        _reference_snappy()
        port_fn, ref_fn = snappy.decompress, ref_snappy.decompress
    else:
        port_fn, ref_fn = snappy._py_decompress, ref_snappy._py_decompress
    data = CORRUPT[name]
    with pytest.raises(ValueError) as got:
        port_fn(data)
    with pytest.raises(ValueError) as want:
        ref_fn(data)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# protobuf wire format and the Prometheus messages
# ---------------------------------------------------------------------------

def test_protowire_is_byte_identical():
    rng = np.random.default_rng(3)
    ints = [0, 1, 127, 128, 300, 2 ** 31, 2 ** 63 - 1, 2 ** 64 - 1] + \
        [int(x) for x in rng.integers(0, 2 ** 62, 200)]
    for n in ints:
        assert pw.write_varint(n) == ref_pw.write_varint(n)
        assert pw.read_varint(memoryview(pw.write_varint(n)), 0) == \
            ref_pw.read_varint(memoryview(ref_pw.write_varint(n)), 0)
    signed = [-1, -2 ** 63, 2 ** 63 - 1, -1_700_000_000_000] + \
        [int(x) for x in rng.integers(-2 ** 62, 2 ** 62, 100)]
    for n in signed:
        assert pw.field_varint(3, n) == ref_pw.field_varint(3, n)
        v, _ = pw.read_varint(memoryview(pw.field_varint(3, n)), 1)
        assert pw.decode_sint64(v) == ref_pw.decode_sint64(v) == n
        assert pw.zigzag_decode(abs(n)) == ref_pw.zigzag_decode(abs(n))
    for x in list(rng.normal(size=50)) + [0.0, -0.0, float("inf"), 1e308]:
        assert pw.field_double(2, x) == ref_pw.field_double(2, x)
        assert pw.decode_double(struct.pack("<d", x)) == x
    msg = (pw.field_varint(1, 5) + pw.field_double(2, 1.5) +
           pw.field_bytes(3, b"abc") + b"\x25" + struct.pack("<I", 7))
    got = [(f, w, bytes(v) if isinstance(v, memoryview) else v)
           for f, w, v in pw.iter_fields(memoryview(msg))]
    want = [(f, w, bytes(v) if isinstance(v, memoryview) else v)
            for f, w, v in ref_pw.iter_fields(memoryview(msg))]
    assert got == want and len(got) == 4
    for mod in (pw, ref_pw):
        with pytest.raises(ValueError, match="wire type"):
            list(mod.iter_fields(memoryview(b"\x0b")))


def _series(mod, seed=5, n_series=12, n_samples=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        labels = {"__name__": ["cpu_usage_user", "up"][i % 2],
                  "hostname": f"host_{i}", "region": f"r{i % 3}"}
        if i % 4 == 0:
            labels["job"] = "node"
        ts = 1_451_606_400_000 + np.sort(rng.choice(
            600_000, n_samples, replace=False)).astype(np.int64)
        vals = rng.normal(50, 20, n_samples)
        vals[::7] = -vals[::7]
        out.append(mod.TimeSeries(labels=labels, samples=[
            (float(v), int(t)) for v, t in zip(vals, ts)]))
    # a series without a metric name is dropped by the decoder's grouping
    out.append(mod.TimeSeries(labels={"hostname": "stray"},
                              samples=[(1.0, 1000)]))
    return out


@NEEDS_GXX
def test_prometheus_write_request_round_trip():
    _reference_snappy()
    body = prometheus.encode_write_request(_series(prometheus))
    assert body == ref_prom.encode_write_request(_series(ref_prom))
    got = prometheus.decode_write_request(body)
    want = ref_prom.decode_write_request(body)
    assert [(s.labels, s.samples) for s in got] == \
        [(s.labels, s.samples) for s in want]
    assert prometheus.write_request_to_inserts(body) == \
        ref_prom.write_request_to_inserts(body)
    inserts, tags = prometheus.write_request_to_inserts(body)
    assert sorted(inserts) == ["cpu_usage_user", "up"]
    assert tags["cpu_usage_user"] == ["hostname", "job", "region"]


def _read_request(mod, matchers, start=0, end=10_000_000_000_000):
    q = mod.pw.field_varint(1, start) + mod.pw.field_varint(2, end)
    for mt, name, value in matchers:
        q += mod.pw.field_bytes(3, mod.pw.field_varint(1, mt) +
                                mod.pw.field_bytes(2, name.encode()) +
                                mod.pw.field_bytes(3, value.encode()))
    return mod.pw.field_bytes(1, q)


@pytest.mark.parametrize("matchers", [
    [(0, "__name__", "up")],
    [(0, "__name__", "cpu_usage_user"), (1, "hostname", "host_3"),
     (2, "region", "r[01]"), (3, "job", "no.*")],
    [(2, "__name__", "up")],            # no equality on the name: no metric
])
def test_prometheus_read_request_decodes_alike(matchers):
    raw = ref_snappy._py_compress(bytes(_read_request(ref_prom, matchers)) +
                                  bytes(_read_request(ref_prom, matchers,
                                                      start=5, end=9)))
    assert bytes(_read_request(prometheus, matchers)) == \
        bytes(_read_request(ref_prom, matchers))
    got = prometheus.decode_read_request(raw)
    want = ref_prom.decode_read_request(raw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.start_ms, g.end_ms, g.metric_name()) == \
            (w.start_ms, w.end_ms, w.metric_name())
        assert [(m.type, m.name, m.value) for m in g.matchers] == \
            [(m.type, m.name, m.value) for m in w.matchers]
        for value in ("host_3", "host_4", "r0", "r2", "node", ""):
            assert [m.matches(value) for m in g.matchers] == \
                [m.matches(value) for m in w.matchers]


@NEEDS_GXX
def test_prometheus_read_response_is_byte_identical():
    _reference_snappy()
    got = prometheus.encode_read_response(
        [_series(prometheus, seed=1), [], _series(prometheus, seed=2)[:3]])
    want = ref_prom.encode_read_response(
        [_series(ref_prom, seed=1), [], _series(ref_prom, seed=2)[:3]])
    assert got == want


# ---------------------------------------------------------------------------
# InfluxDB line protocol
# ---------------------------------------------------------------------------

INFLUX_CORPUS = [
    "weather,location=us-midwest temperature=82 1465839830100400200",
    "weather,location=us\\ east,zone=a\\,b temperature=75.5,humidity=32i "
    "1465839830100400200",
    'msg,host=a text="hello, world",ok=t,bad=F,n=-12i,u=7u 1700000000',
    'msg,host=b text="say \\"hi\\"",ok=true,flag=FALSE 1700000001',
    "cpu\\,x,host=web\\=01 usage=1e3,idle=-0.5 1700000000000",
    "# a comment line",
    "",
    "m1 v=1 1700000000",
    "m2,tag=only v=+3i 42",
]
PRECISIONS = ["n", "ns", "u", "us", "ms", "s", "m", "h"]


def _parsed_equal(got, want):
    assert got == want
    assert [tuple(type(v) for v in f.values()) for _, _, f, _ in got] == \
        [tuple(type(v) for v in f.values()) for _, _, f, _ in want]


@pytest.mark.parametrize("precision", PRECISIONS)
def test_influx_parse_lines_matches(precision):
    body = "\n".join(INFLUX_CORPUS)
    if precision in ("m", "h"):
        body = "\n".join(ln.rsplit(" ", 1)[0] + " 1700" if ln and
                         not ln.startswith("#") else ln
                         for ln in INFLUX_CORPUS)
    _parsed_equal(influxdb.parse_lines(body, precision),
                  ref_influx.parse_lines(body, precision))
    got = influxdb.body_to_inserts(body, precision)
    assert got == ref_influx.body_to_inserts(body, precision)
    assert sorted(got[0]) == ["cpu", "m1", "m2", "msg", "weather"]


INFLUX_BAD = [
    ("ns", "justmeasurement"),
    ("ns", ",tag=a v=1 1"),
    ("ns", "m v= 1"),
    ("ns", "m =1 1"),
    ("ns", "m v=abc 1"),
    ("ns", "m v=1 notanumber"),
    ("ms", "m v=1 1\nm w=2i 2\nbroken"),
    ("fortnight", "m v=1 1"),
]


@pytest.mark.parametrize("precision, body", INFLUX_BAD)
def test_influx_malformed_lines_raise_alike(precision, body):
    got = want = None
    try:
        influxdb.parse_lines(body, precision)
    except (GreptimeError, ValueError) as e:
        got = e
    try:
        ref_influx.parse_lines(body, precision)
    except (RefGreptimeError, ValueError) as e:
        want = e
    assert got is not None and want is not None
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


def test_influx_missing_timestamp_takes_the_clock():
    t0 = int(time.time() * 1000)
    (got,) = influxdb.parse_lines("m v=1")
    (want,) = ref_influx.parse_lines("m v=1")
    assert got[:3] == want[:3]
    assert t0 <= got[3] <= int(time.time() * 1000)


# ---------------------------------------------------------------------------
# OpenTSDB
# ---------------------------------------------------------------------------

TELNET = [
    "put sys.cpu.user 1356998400 42.5 host=webserver01 cpu=0",
    "put sys.cpu.user 1356998400500 -1 host=a",
    "  put m 9999999999 1e3  ",
    "put m 10000000000 0 k=v=w",
]
TELNET_BAD = ["", "get m 1 1", "put m 1", "put m x 1 a=b", "put m 1 y a=b",
              "put m 1 1 novalue", "put m 1 1 =v"]


@pytest.mark.parametrize("line", TELNET)
def test_opentsdb_telnet_put_matches(line):
    got, want = opentsdb.parse_telnet_put(line), \
        ref_tsdb.parse_telnet_put(line)
    assert (got.metric, got.ts_ms, got.value, got.tags) == \
        (want.metric, want.ts_ms, want.value, want.tags)


@pytest.mark.parametrize("line", TELNET_BAD)
def test_opentsdb_bad_telnet_put_raises_alike(line):
    got = want = None
    try:
        opentsdb.parse_telnet_put(line)
    except (GreptimeError, ValueError) as e:
        got = e
    try:
        ref_tsdb.parse_telnet_put(line)
    except (RefGreptimeError, ValueError) as e:
        want = e
    assert got is not None and want is not None
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


HTTP_PUTS = [
    {"metric": "sys.cpu", "timestamp": 1700000000, "value": 18.0,
     "tags": {"host": "web01"}},
    [{"metric": "sys.cpu", "timestamp": 1700000000123, "value": 19.5,
      "tags": {"host": "web02", "dc": 3}},
     {"metric": "sys.mem", "timestamp": "1700000001", "value": "7",
      "tags": None},
     {"metric": "sys.cpu", "timestamp": 1700000002, "value": 1}],
]
HTTP_BAD = [{"metric": "m", "value": 1}, [{"timestamp": 1, "value": 1}],
            [{"metric": "m", "timestamp": "x", "value": 1}], ["not a dict"]]


@pytest.mark.parametrize("body", HTTP_PUTS)
def test_opentsdb_http_put_matches(body):
    got, want = opentsdb.parse_http_put(body), ref_tsdb.parse_http_put(body)
    assert [(p.metric, p.ts_ms, p.value, p.tags) for p in got] == \
        [(p.metric, p.ts_ms, p.value, p.tags) for p in want]
    assert opentsdb.points_to_inserts(got) == \
        ref_tsdb.points_to_inserts(want)


@pytest.mark.parametrize("body", HTTP_BAD)
def test_opentsdb_bad_http_put_raises_alike(body):
    with pytest.raises(GreptimeError) as got:
        opentsdb.parse_http_put(body)
    with pytest.raises(RefGreptimeError) as want:
        ref_tsdb.parse_http_put(body)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
