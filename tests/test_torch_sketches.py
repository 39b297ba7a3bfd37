"""Sketch and expression aggregates, the JAX package against the port, on
the CPU.

- The sketch module (query/sketches.py) is numpy only, so the port's must
  be bit-identical: hash64 over int, float and string arrays, the
  HyperLogLog registers, DistinctSketch below and above its exact-set
  bound, the t-digest centroids and every encoded frame; a truncated or
  corrupt frame raises the port's SketchCodecError; merges are
  associative.
- The SQL surface: count(DISTINCT), approx_distinct, approx_percentile,
  median and aggregates over arithmetic expressions, through both
  packages' standalone frontends over the same rows (several SSTs and a
  live memtable; NULLs in `req`), on the resident path (`SET
  tpu_dispatch_min_rows = 0`), the streamed path (`SET
  stream_threshold_rows`), the indexed-point path (a point query on an
  uncached region) and a table partitioned into 4 regions, and under
  `SET approx_error_target`. Sketch results are equal, expression sums
  within 8 eps64 sum|x|, dispatch strings and EXPLAIN text byte-equal.
  `SET exact_distinct` acts only on the distributed pushdown: the port
  (which has none yet) refuses it, and the reference's standalone
  answers under it equal the port's without it.
- The `sketch_codec` failpoint degrades the statement to the raw-row
  answer and counts `sketch_degrade`.
- Two concurrent statements that differ only in the expression, or only
  in the percentile, never fuse into one scan and keep their own answers.

Sketch and expression moments reduce on the host in both packages, so
this file compiles no JAX program.
"""

import threading
import time

import numpy as np
import pandas as pd
import pytest

from greptimedb_tpu.common import failpoint as ref_failpoint
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.errors import SketchCodecError as RefCodecError
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import sketches as ref_sk
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu_torch.common import failpoint, telemetry
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.errors import SketchCodecError, UnsupportedError
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import sketches as sk
from greptimedb_tpu_torch.query import stream_exec, tpu_exec
from greptimedb_tpu_torch.session import QueryContext

EPS64 = 2.0 ** -52
T0 = 1_700_000_000_000
STEP = 10_000
HOSTS = 24
STEPS = 500


# ---------------------------------------------------------------------------
# the sketch module
# ---------------------------------------------------------------------------

def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "int64": rng.integers(-2**62, 2**62, 3000),
        "int32": rng.integers(-2**31, 2**31, 3000).astype(np.int32),
        "uint8": rng.integers(0, 256, 3000).astype(np.uint8),
        "float64": np.concatenate([rng.normal(0, 1e6, 2990),
                                   [0.0, -0.0, np.inf, -np.inf, 1e-300,
                                    np.nan, 5e-324, 1.5, -1.5, 2.0]]),
        "float32": rng.random(3000).astype(np.float32),
        "str": np.array([f"host_{i}" for i in rng.integers(0, 5000, 3000)]
                        + ["", "ünïcödé", "a b", "日本"], dtype=object),
    }


@pytest.mark.parametrize("kind", list(_arrays(0)))
def test_hash64_bit_equal(kind):
    a = _arrays(1)[kind]
    np.testing.assert_array_equal(sk.hash64(a), ref_sk.hash64(a))
    assert sk.hash64(a).dtype == np.uint64


@pytest.mark.parametrize("p", [6, 10, 14, 16])
def test_hll_registers_equal(p):
    h = sk.hash64(_arrays(2)["int64"])
    port, ref = sk.HyperLogLog(p), ref_sk.HyperLogLog(p)
    port.add_hashes(h)
    ref.add_hashes(h)
    np.testing.assert_array_equal(port.registers, ref.registers)
    assert port.estimate() == ref.estimate()
    assert port.result() == ref.result()


@pytest.mark.parametrize("n", [0, 1, 100, 4096, 4097, 20_000])
@pytest.mark.parametrize("kind", ["int64", "float64", "str"])
def test_distinct_sketch_equal(n, kind):
    """Below the bound the exact value set, above it the HLL registers,
    and the encoded frame, are the reference's."""
    rng = np.random.default_rng(n)
    if kind == "str":
        vals = np.array([f"v{i}" for i in range(n)], dtype=object)
    elif kind == "int64":
        vals = rng.permutation(n).astype(np.int64) * 7919
    else:
        vals = rng.random(n)
    vals = np.concatenate([vals, vals[: n // 3]])     # duplicates
    port, ref = sk.DistinctSketch.from_values(vals), \
        ref_sk.DistinctSketch.from_values(vals)
    assert port.exact == ref.exact == (n <= sk.EXACT_SET_LIMIT)
    if port.exact:
        np.testing.assert_array_equal(np.asarray(port.values, object),
                                      np.asarray(ref.values, object))
    else:
        np.testing.assert_array_equal(port.hll.registers, ref.hll.registers)
    assert port.result() == ref.result()
    assert sk.encode_sketch(port) == ref_sk.encode_sketch(ref)


@pytest.mark.parametrize("n", [1, 50, 5000, 60_000])
def test_tdigest_centroids_equal(n):
    x = np.random.default_rng(n).lognormal(0, 2, n)
    port, ref = sk.TDigest.from_values(x), ref_sk.TDigest.from_values(x)
    np.testing.assert_array_equal(port.means, ref.means)
    np.testing.assert_array_equal(port.weights, ref.weights)
    for q in (0, 1, 50, 95, 99.9, 100):
        assert port.quantile(q) == ref.quantile(q)
    assert sk.encode_sketch(port) == ref_sk.encode_sketch(ref)


def _frames():
    rng = np.random.default_rng(5)
    return [sk.encode_sketch(sk.DistinctSketch.from_values(rng.random(300))),
            sk.encode_sketch(sk.DistinctSketch.from_values(
                np.array(["a", "b", "c"], dtype=object))),
            sk.encode_sketch(sk.DistinctSketch.from_values(rng.random(9000))),
            sk.encode_sketch(sk.TDigest.from_values(rng.random(9000)))]


@pytest.mark.parametrize("i", range(4))
def test_frames_round_trip_across_packages(i):
    """Each package decodes the other's frames to the same sketch."""
    frame = _frames()[i]
    a, b = sk.decode_sketch(frame), ref_sk.decode_sketch(frame)
    assert sk.encode_sketch(a) == ref_sk.encode_sketch(b) == frame


@pytest.mark.parametrize("i", range(4))
def test_corrupt_frames_raise_typed_error(i):
    frame = _frames()[i]
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x40
    bad_magic = b"XSK" + frame[3:-4]
    import struct
    import zlib
    bad_magic += struct.pack("<I", zlib.crc32(bad_magic) & 0xFFFFFFFF)
    for bad in (frame[:5], frame[:-1], frame[:len(frame) // 2],
                bytes(flipped), bad_magic, "not bytes"):
        with pytest.raises(SketchCodecError):
            sk.decode_sketch(bad)
        with pytest.raises(RefCodecError):
            ref_sk.decode_sketch(bad)
    assert not issubclass(SketchCodecError, RefCodecError)


@pytest.mark.parametrize("sizes", [(100, 200, 300), (3000, 1500, 10),
                                   (5000, 7000, 100)])
def test_distinct_merge_associative(sizes):
    """(a+b)+c and a+(b+c) give the same frame, in both packages, exact
    sets and HLL alike."""
    rng = np.random.default_rng(sum(sizes))
    parts = [rng.integers(0, 50_000, n) for n in sizes]

    def fold(mod, order):
        s = [mod.DistinctSketch.from_values(p) for p in parts]
        if order == "left":
            return mod.encode_sketch(s[0].merge(s[1]).merge(s[2]))
        return mod.encode_sketch(s[0].merge(s[1].merge(s[2])))
    frames = {fold(m, o) for m in (sk, ref_sk) for o in ("left", "right")}
    assert len(frames) == 1
    whole = sk.DistinctSketch.from_values(np.concatenate(parts))
    assert sk.decode_sketch(frames.pop()).result() == whole.result()


def test_tdigest_merge_associative():
    """t-digest merges fold the same total weight either way, each order
    equal to the reference's, quantiles within 1 % rank of each other."""
    rng = np.random.default_rng(9)
    parts = [rng.normal(i, 1 + i, 4000) for i in range(3)]
    allv = np.sort(np.concatenate(parts))

    def fold(mod, order):
        d = [mod.TDigest.from_values(p) for p in parts]
        return d[0].merge(d[1]).merge(d[2]) if order == "left" \
            else d[0].merge(d[1].merge(d[2]))
    for order in ("left", "right"):
        a, b = fold(sk, order), fold(ref_sk, order)
        assert sk.encode_sketch(a) == ref_sk.encode_sketch(b)
    left, right = fold(sk, "left"), fold(sk, "right")
    assert left.count == right.count == len(allv)
    for q in (5, 50, 95):
        r = [np.searchsorted(allv, d.quantile(q)) / len(allv)
             for d in (left, right)]
        assert abs(r[0] - r[1]) <= 0.01 and abs(r[0] - q / 100) <= 0.01


def test_configure_matches_reference(monkeypatch):
    for mod in (sk, ref_sk):
        for name in ("_ERROR_TARGET", "_HLL_P", "_TDIGEST_DELTA"):
            monkeypatch.setattr(mod, name, list(getattr(mod, name)))
    for t in (0.001, 0.003, 0.01, 0.05, 0.25):
        sk.configure(error_target=t)
        ref_sk.configure(error_target=t)
        assert (sk.hll_precision(), sk.tdigest_delta()) == \
            (ref_sk.hll_precision(), ref_sk.tdigest_delta())
    from greptimedb_tpu_torch.errors import InvalidArgumentsError
    with pytest.raises(InvalidArgumentsError):
        sk.configure(error_target=0.5)


# ---------------------------------------------------------------------------
# the SQL surface through both frontends
# ---------------------------------------------------------------------------

DDL = ("CREATE TABLE {name} (host STRING, region STRING, ts TIMESTAMP TIME "
       "INDEX, usage_user DOUBLE, usage_system DOUBLE, req BIGINT, "
       "PRIMARY KEY(host, region)){part}")
PART = (" PARTITION BY RANGE COLUMNS (host) (PARTITION p0 VALUES LESS THAN "
        "('h06'), PARTITION p1 VALUES LESS THAN ('h12'), PARTITION p2 VALUES "
        "LESS THAN ('h18'), PARTITION p3 VALUES LESS THAN (MAXVALUE))")


def _batches():
    """Four write batches of HOSTS hosts x STEPS steps, the rows of a host
    in one region tag; `req` has NULLs and repeats, usage_* are distinct
    per row (so a region's approx_distinct degrades past the exact set)."""
    rng = np.random.default_rng(11)
    out = []
    for part in range(4):
        k = np.arange(part * STEPS // 4, (part + 1) * STEPS // 4)
        h = np.repeat(np.arange(HOSTS), len(k))
        kk = np.tile(k, HOSTS)
        n = len(h)
        req = rng.integers(0, 400, n).astype(object)
        req[rng.random(n) < 0.05] = None
        out.append({
            "host": [f"h{i:02d}" for i in h],
            "region": [f"r{i % 4}" for i in h],
            "ts": (T0 + kk * STEP).tolist(),
            "usage_user": np.round(rng.random(n) * 100, 6).tolist(),
            "usage_system": np.round(rng.normal(30, 10, n), 6).tolist(),
            "req": req.tolist(),
        })
    return out


class Side:
    """One package's standalone frontend over the shared rows: `cpu`
    (three SSTs and a memtable) and `cpu_p` (4 regions)."""

    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), register_numbers_table=False,
                device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home), register_numbers_table=False)))
            self.fe.start()
        self.exec = tpu_exec if port else ref_exec
        self.ctx = QueryContext() if port else RefCtx()
        self.sql(DDL.format(name="cpu", part=""))
        self.sql(DDL.format(name="cpu_p", part=PART))
        batches = _batches()
        for i, b in enumerate(batches):
            for t in ("cpu", "cpu_p"):
                self.fe.handle_row_insert(
                    t, b, tag_columns=["host", "region"],
                    timestamp_column="ts", ctx=self.ctx)
                if i < len(batches) - 1:
                    self.sql(f"ADMIN FLUSH TABLE {t}")
        # the compactions the flushes set off, done before any read
        self.fe.datanode.storage.scheduler.wait_idle(timeout=60)

    def sql(self, text):
        return self.fe.do_query(text, self.ctx)[-1]

    def frame(self, text):
        out = self.sql(text)
        frames = [pd.DataFrame(b.to_pydict()) for b in out.batches]
        return pd.concat(frames, ignore_index=True)

    def query(self, text, setup=("SET tpu_dispatch_min_rows = 0",)):
        """(frame, dispatch, EXPLAIN text) of one statement after `setup`
        (re-run before each: the dispatch floor is latency-adaptive)."""
        for s in setup:
            self.sql(s)
        explain = self.frame("EXPLAIN " + text)["plan"].iloc[0]
        for s in setup:
            self.sql(s)
        df = self.frame(text)
        return df, self.fe.query_engine.last_exec_stats.dispatch, explain

    def clear_cache(self):
        cache = self.exec.SCAN_CACHE
        with cache._lock:                # the reference has no clear()
            cache._entries.clear()

    def close(self):
        self.fe.shutdown()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    ref = Side(False, tmp_path_factory.mktemp("ref"))
    port = Side(True, tmp_path_factory.mktemp("port"))
    yield ref, port
    ref.close()
    port.close()


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch):
    """SET statements change module state in both packages: restore it."""
    for ex, st, s in ((ref_exec, ref_stream, ref_sk),
                      (tpu_exec, stream_exec, sk)):
        monkeypatch.setattr(ex, "TPU_DISPATCH_MIN_ROWS",
                            ex.TPU_DISPATCH_MIN_ROWS)
        monkeypatch.setattr(ex, "_observed_min_dt", [None])
        monkeypatch.setattr(st, "_STREAM_THRESHOLD_ROWS",
                            list(st._STREAM_THRESHOLD_ROWS))
        for name in ("_ERROR_TARGET", "_HLL_P", "_TDIGEST_DELTA"):
            monkeypatch.setattr(s, name, list(getattr(s, name)))
    monkeypatch.setattr(ref_sk, "_EXACT_DISTINCT",
                        list(ref_sk._EXACT_DISTINCT))
    yield


SKETCH_Q = {
    "by-region":
        "SELECT region, approx_distinct(usage_user), "
        "approx_percentile(usage_user, 95), median(usage_system) FROM {t} "
        "GROUP BY region ORDER BY region",
    "distinct":
        "SELECT region, count(DISTINCT host), count(DISTINCT req), "
        "count(*) FROM {t} GROUP BY region ORDER BY region",
    "by-host-window":
        f"SELECT host, approx_distinct(req), approx_percentile(req, 50), "
        f"approx_percentile(usage_user, 5), count(*) FROM {{t}} WHERE "
        f"ts >= {T0 + 40 * STEP} AND ts < {T0 + 400 * STEP} GROUP BY host "
        f"ORDER BY host",
    "global":
        "SELECT approx_distinct(host), approx_distinct(region), "
        "approx_distinct(usage_user), approx_percentile(usage_system, 99), "
        "median(req) FROM {t}",
    "bucketed":
        "SELECT region, date_bin(INTERVAL '20 minutes', ts) AS b, "
        "approx_percentile(usage_user, 90), approx_distinct(req) FROM {t} "
        "GROUP BY region, b ORDER BY region, b",
    "expr-by-host":
        "SELECT host, avg(usage_user + usage_system), sum(usage_user * 2), "
        "min(usage_user - usage_system), max(usage_user / 4) FROM {t} "
        "GROUP BY host ORDER BY host",
    "expr-mixed":
        "SELECT region, sum(usage_user * usage_system), avg(usage_user), "
        "approx_percentile(usage_user + 1, 50), count(req) FROM {t} "
        "WHERE usage_user > 10 GROUP BY region ORDER BY region",
}
#: point statements for the indexed-point path
POINT_Q = {
    "point":
        "SELECT host, approx_distinct(usage_user), median(usage_user), "
        "sum(usage_user * 2) FROM {t} WHERE host = 'h05' GROUP BY host",
    "in-list":
        "SELECT host, approx_percentile(usage_system, 75), "
        "avg(usage_user - 1) FROM {t} WHERE host IN ('h01', 'h17') "
        "GROUP BY host ORDER BY host",
}


def _abs_bound():
    """An upper bound on sum|x| over the rows for every expression of
    the statements here: sum of 4|u| + 2|s| + |u s| + 2."""
    u = np.concatenate([b["usage_user"] for b in _batches()])
    s = np.concatenate([b["usage_system"] for b in _batches()])
    return float(np.sum(4 * np.abs(u) + 2 * np.abs(s) + np.abs(u * s) + 2))


ABS = _abs_bound()


def _same(got, want, sql, tol_sum=None):
    """Equal frames: keys, counts and sketch results exactly; the sums
    and averages of expressions within 8 eps64 sum|x| (they are the
    same float64 host reduction in both packages)."""
    assert list(got.columns) == list(want.columns), sql
    assert len(got) == len(want) > 0, sql
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if c.startswith(("sum(", "avg(")) and tol_sum is not None:
            g64, w64 = g.astype(np.float64), w.astype(np.float64)
            np.testing.assert_array_equal(np.isnan(g64), np.isnan(w64))
            ok = ~np.isnan(w64)
            assert (np.abs(g64 - w64)[ok] <= 8 * EPS64 * tol_sum).all(), \
                f"{c}: {sql}"
        else:
            np.testing.assert_array_equal(g.astype(object), w.astype(object),
                                          err_msg=f"{c}: {sql}")


def _check(ref, port, sql, setup, want_prefix):
    """The statement through both sides: EXPLAIN text and the executed
    dispatch byte-equal, the answers `_same`. A standalone count(DISTINCT)
    is not lowered in either package (the exact raw-row path); every
    other statement here reduces host partials on `want_prefix`'s path."""
    want, ref_dispatch, ref_explain = ref.query(sql, setup)
    got, dispatch, explain = port.query(sql, setup)
    assert explain == ref_explain, sql
    assert dispatch == ref_dispatch, sql
    if "DISTINCT" in sql:
        assert dispatch == "cpu-fallback", dispatch
        assert explain.startswith("CpuAggregateExec: groups="), explain
    else:
        assert dispatch.startswith(want_prefix), dispatch
        assert dispatch.endswith("; host-partial moments (sketch/expr))"), \
            dispatch
        assert explain.startswith("TpuAggregateExec: groups=["), explain
    _same(got, want, sql, tol_sum=ABS)
    return got


@pytest.mark.parametrize("name", list(SKETCH_Q))
def test_resident_matches_reference(sides, name):
    ref, port = sides
    sql = SKETCH_Q[name].format(t="cpu")
    got = _check(ref, port, sql, ("SET tpu_dispatch_min_rows = 0",),
                 "device-resident (scan cache")
    if name == "global":
        # past the exact-set bound: the HyperLogLog estimate, within 3
        # standard errors of the exact count
        exact = len(np.unique(np.concatenate(
            [b["usage_user"] for b in _batches()])))
        assert exact > sk.EXACT_SET_LIMIT
        est = got["approx_distinct(usage_user)"].iloc[0]
        assert est != exact and \
            abs(est - exact) <= 3 * 1.04 / 2 ** 7 * exact


@pytest.mark.parametrize("name", list(SKETCH_Q))
def test_streamed_matches_reference(sides, name):
    ref, port = sides
    sql = SKETCH_Q[name].format(t="cpu")
    _check(ref, port, sql, ("SET tpu_dispatch_min_rows = 0",
                            "SET stream_threshold_rows = 1000"),
           "streamed-cold (")


@pytest.mark.parametrize("name", list(POINT_Q))
def test_indexed_point_matches_reference(sides, name):
    ref, port = sides
    sql = POINT_Q[name].format(t="cpu")
    for side in (ref, port):
        side.clear_cache()
    want, ref_dispatch, ref_explain = ref.query(sql)
    for side in (ref, port):
        side.clear_cache()
    got, dispatch, explain = port.query(sql)
    assert dispatch == ref_dispatch and explain == ref_explain
    assert dispatch.startswith("indexed-point (") and \
        dispatch.endswith("; host-partial moments (sketch/expr))")
    _same(got, want, sql, tol_sum=ABS)


@pytest.mark.parametrize("name", list(SKETCH_Q))
def test_partitioned_matches_reference(sides, name):
    """4 regions: per-region host partials fold across regions in
    _finalize, through the codec, equal to the reference's; the sketch
    answers equal those of the unpartitioned table."""
    ref, port = sides
    sql = SKETCH_Q[name].format(t="cpu_p")
    got = _check(ref, port, sql, ("SET tpu_dispatch_min_rows = 0",),
                 "device-resident (scan cache")
    whole, _, _ = port.query(SKETCH_Q[name].format(t="cpu"))
    # keys, counts and distinct counts fold exactly (exact sets union,
    # HLL registers take their max); t-digests depend on the fold order
    for c in got.columns:
        if c in ("region", "host", "b") or \
                c.startswith(("count(", "approx_distinct(")):
            np.testing.assert_array_equal(got[c].to_numpy(),
                                          whole[c].to_numpy(), err_msg=c)


@pytest.mark.parametrize("knob", ["SET exact_distinct = 1",
                                  "SET approx_error_target = 0.05",
                                  "SET approx_error_target = 0.002"])
def test_sketch_knobs_match_reference(sides, knob):
    """SET approx_error_target reaches both packages' sketch modules and
    the answers and dispatch stay the reference's. SET exact_distinct acts
    only on the distributed pushdown, so the port refuses it, naming that
    module; the reference's standalone answers under it (a standalone
    count(DISTINCT) keeps its exact raw-row path) equal the port's
    without it."""
    ref, port = sides
    exact = "exact_distinct" in knob
    if exact:
        with pytest.raises(UnsupportedError,
                           match="the distributed frontend is not ported"):
            port.sql(knob)
    for name in ("by-region", "distinct", "global"):
        sql = SKETCH_Q[name].format(t="cpu")
        setup = (knob, "SET tpu_dispatch_min_rows = 0")
        want, ref_dispatch, ref_explain = ref.query(sql, setup)
        got, dispatch, explain = port.query(sql, setup[1:] if exact
                                            else setup)
        assert (dispatch, explain) == (ref_dispatch, ref_explain)
        _same(got, want, sql)
    if exact:
        assert ref_sk.exact_distinct_forced()
    else:
        assert sk.hll_precision() == ref_sk.hll_precision() != 14


def _counter(name):
    return sum(v for n, _, v, _ in telemetry.registry_snapshot()
               if n == f"greptime_{name}_total")


def test_sketch_codec_failpoint_degrades_to_raw_rows(sides):
    """An injected corrupt partial: the statement answers by the raw-row
    path (the reference's answer, which degrades the same way), counts
    sketch_degrade and records it in ExecStats."""
    ref, port = sides
    sql = SKETCH_Q["by-region"].format(t="cpu_p")
    clean, _, _ = port.query(sql)
    before = _counter("sketch_degrade")
    try:
        for side in (ref, port):
            side.sql("SET failpoint_sketch_codec = 'err'")
        want, _, _ = ref.query(sql)
        got, dispatch, _ = port.query(sql)
    finally:
        for side in (ref, port):
            side.sql("SET failpoint_sketch_codec = 'off'")
        failpoint.reset()
        ref_failpoint.reset()
    assert _counter("sketch_degrade") > before
    stats = port.fe.query_engine.last_exec_stats
    assert "sketch_degrade" in stats.rows_table()["stage"]
    _same(got, want, sql)
    # distinct counts are the sketch path's: exact sets below the bound,
    # the same HLL registers above it
    for c in ("region", "approx_distinct(usage_user)"):
        np.testing.assert_array_equal(got[c].to_numpy(), clean[c].to_numpy())


def _fused_pair(port, monkeypatch, a, b):
    """Run statements a and b at once on the port with a slowed region
    pass (so the two overlap); returns their frames and the passes."""
    passes = []
    orig = tpu_exec._execute_region

    def slow(*args, **kw):
        passes.append(1)
        time.sleep(0.5)
        return orig(*args, **kw)
    monkeypatch.setattr(tpu_exec, "_execute_region", slow)
    frames = [None, None]
    barrier = threading.Barrier(2)

    def run(i, sql):
        ctx = QueryContext()
        barrier.wait()
        out = port.fe.do_query(sql, ctx)[-1]
        frames[i] = pd.concat([pd.DataFrame(x.to_pydict())
                               for x in out.batches], ignore_index=True)
    port.sql("SET tpu_dispatch_min_rows = 0")
    ts = [threading.Thread(target=run, args=(i, s))
          for i, s in enumerate((a, b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    monkeypatch.setattr(tpu_exec, "_execute_region", orig)
    return frames, len(passes)


@pytest.mark.parametrize("a,b", [
    ("sum(usage_user * 2)", "sum(usage_user + 2)"),
    ("approx_percentile(usage_user, 95)", "approx_percentile(usage_user, 50)"),
], ids=["expression", "percentile"])
def test_fused_statements_keep_their_own_answers(sides, monkeypatch, a, b):
    """Scan fusion fingerprints plans through plan_to_dict: two
    statements that differ only in the expression or the percentile
    have different keys, each scans its own pass (4 regions x 2) and
    keeps its solo answer; two identical statements fuse (4 passes)."""
    _, port = sides
    q = "SELECT region, {} AS v FROM cpu_p GROUP BY region ORDER BY region"
    sa, sb = q.format(a), q.format(b)
    solo_a, _, _ = port.query(sa)
    solo_b, _, _ = port.query(sb)
    assert not solo_a["v"].equals(solo_b["v"])
    (fa, fb), passes = _fused_pair(port, monkeypatch, sa, sb)
    assert passes == 8
    pd.testing.assert_frame_equal(fa, solo_a)
    pd.testing.assert_frame_equal(fb, solo_b)
    (fa, fa2), passes = _fused_pair(port, monkeypatch, sa, sa)
    assert passes == 4
    pd.testing.assert_frame_equal(fa, solo_a)
    pd.testing.assert_frame_equal(fa2, solo_a)


def test_plan_codec_carries_expressions_and_params(sides, monkeypatch):
    """plan_to_dict of the port's sketch and expression plans is
    byte-identical to the reference's (field_exprs and agg_params
    included), round-trips, and tells apart plans that differ only in
    the expression or the percentile (the scan-fusion fingerprint)."""
    import json

    from greptimedb_tpu.query import plan_codec as ref_codec
    from greptimedb_tpu_torch.query import plan_codec
    ref, port = sides
    plans = {"ref": [], "port": []}
    for key, ex in (("ref", ref_exec), ("port", tpu_exec)):
        orig = ex.plan_for

        def spy(*a, _orig=orig, _key=key, **k):
            p = _orig(*a, **k)
            if p is not None:
                plans[_key].append(p)
            return p
        monkeypatch.setattr(ex, "plan_for", spy)
    sqls = [q.format(t="cpu") for q in SKETCH_Q.values()
            if "DISTINCT" not in q] + [
        "SELECT region, sum(usage_user + 2) FROM cpu GROUP BY region",
        "SELECT region, approx_percentile(usage_user, 50) FROM cpu GROUP "
        "BY region"]
    for sql in sqls:
        ref.query(sql)
        port.query(sql)
    assert len(plans["port"]) == len(plans["ref"]) >= 2 * len(sqls)
    fps = set()
    for p, r in zip(plans["port"], plans["ref"]):
        got = json.dumps(plan_codec.plan_to_dict(p), sort_keys=True)
        assert got == json.dumps(ref_codec.plan_to_dict(r), sort_keys=True)
        back = plan_codec.plan_from_dict(json.loads(got))
        assert json.dumps(plan_codec.plan_to_dict(back),
                          sort_keys=True) == got
        assert back.field_exprs.keys() == p.field_exprs.keys()
        assert back.agg_params == p.agg_params
        fps.add(got)
    # each statement is explained and then run: two plans, one print
    assert len(fps) == len(sqls)
