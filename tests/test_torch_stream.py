"""The cold SQL scan paths, the JAX package against the port, on the CPU.

The same write batches go through both packages' storage engines: a
region of several overlapping SSTs with overwrites, deletes, NULLs and a
live memtable (the shape of tests/test_stream_exec.py's `make_world`),
each under its own package's mito table and QueryEngine. Then:

- the streamed cold scan (query/stream_exec.py) in its default "host"
  mode: the port's answers EXACTLY the reference's (both the same float64
  numpy reduction);
- the port's streamed "device" mode (segment_moments' plain version on
  the CPU, float32 mirrors) against the reference's streamed answers:
  keys and counts exact, min/max/first/last equal to the float32
  rounding of the reference's, sums, averages and standard deviations
  within tests/test_torch_sql.py's bounds;
- the slice planners on seeded random chunk statistics, identical;
- the lean (merge-free, arrow-batch) path on a clean bulk-loaded region,
  engaged in both packages with equal counters;
- point and IN queries on an uncached multi-SST region: `indexed-point`
  in both packages, the same decision string, exact frames;
- the scan cache's incremental merge against a full rebuild (and against
  the reference's merge), exactly, over memtable rows, a flush of
  covered sequences, new SST rows, deletes and the failpoint's fallback;
  TTL retraction and a schema change rebuild in full;
- scan fusion under threads (one leader, equal frames) and the plan
  codec's output, byte-identical to the reference's;
- a KILL during a slowed streamed scan stops it within one slice.

The reference's streamed and indexed paths reduce on the host, so this
file compiles no JAX program.
"""

import json
import threading
import time

import numpy as np
import pandas as pd
import pytest

from greptimedb_tpu.catalog import MemoryCatalogManager as RefCatalog
from greptimedb_tpu.common import exec_stats as ref_stats
from greptimedb_tpu.datatypes import data_type as ref_dt
from greptimedb_tpu.datatypes.schema import (ColumnSchema as RefColumn,
                                             Schema as RefSchema,
                                             SemanticType as RefSemantic)
from greptimedb_tpu.mito import MitoEngine as RefMito
from greptimedb_tpu.query import QueryEngine as RefEngine
from greptimedb_tpu.query import plan_codec as ref_codec
from greptimedb_tpu.query import stream_exec as ref_stream
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu.sql import parse_sql as ref_parse
from greptimedb_tpu.storage.engine import EngineConfig as RefConfig
from greptimedb_tpu.storage.engine import StorageEngine as RefStorage
from greptimedb_tpu.storage.write_batch import WriteBatch as RefBatch
from greptimedb_tpu.table import CreateTableRequest as RefCreate
from greptimedb_tpu_torch.catalog import MemoryCatalogManager
from greptimedb_tpu_torch.common import exec_stats, failpoint, process_list
from greptimedb_tpu_torch.datatypes import data_type as dt
from greptimedb_tpu_torch.datatypes.schema import (ColumnSchema, Schema,
                                                   SemanticType)
from greptimedb_tpu_torch.errors import QueryCancelledError
from greptimedb_tpu_torch.mito import MitoEngine
from greptimedb_tpu_torch.query import QueryEngine, plan_codec
from greptimedb_tpu_torch.query import stream_exec, tpu_exec
from greptimedb_tpu_torch.session import QueryContext
from greptimedb_tpu_torch.sql import parse_sql
from greptimedb_tpu_torch.storage.engine import EngineConfig, StorageEngine
from greptimedb_tpu_torch.storage.write_batch import WriteBatch
from greptimedb_tpu_torch.table import CreateTableRequest

EPS32 = 2.0 ** -24
#: tests/test_stream_exec.py's statements (first/last are the reference's
#: aliases of first_value/last_value)
QUERIES = [
    "SELECT host, count(*), sum(cpu), avg(cpu) FROM m GROUP BY host "
    "ORDER BY host",
    "SELECT host, min(cpu), max(cpu), stddev(cpu) FROM m GROUP BY host "
    "ORDER BY host",
    "SELECT host, count(mem), avg(mem) FROM m GROUP BY host ORDER BY host",
    "SELECT host, first(cpu), last(cpu) FROM m GROUP BY host ORDER BY host",
    "SELECT host, date_bin(INTERVAL '30 seconds', ts) AS b, avg(cpu) "
    "FROM m GROUP BY host, b ORDER BY host, b LIMIT 50",
    "SELECT count(*), avg(cpu) FROM m",
    "SELECT host, avg(cpu) FROM m WHERE ts >= 40000 AND ts < 180000 "
    "GROUP BY host ORDER BY host",
    "SELECT host, count(*) FROM m WHERE cpu > 0.5 GROUP BY host "
    "ORDER BY host",
    "SELECT host, avg(cpu) FROM m WHERE host != 'h3' GROUP BY host "
    "ORDER BY host",
]
#: point and IN statements for the indexed-point path
POINT_QUERIES = [
    "SELECT host, count(*), sum(cpu), min(mem), max(cpu) FROM m WHERE "
    "host = 'h2' GROUP BY host",
    "SELECT host, date_bin(INTERVAL '1 minute', ts) AS b, max(cpu), "
    "count(mem) FROM m WHERE host IN ('h1', 'h5') AND ts < 150000 "
    "GROUP BY host, b ORDER BY host, b",
    "SELECT first_value(cpu), last_value(mem), count(*) FROM m WHERE "
    "host IN ('h0', 'h6', 'nope')",
]


class World:
    """One package's storage engine, mito table `m` and QueryEngine."""

    def __init__(self, port: bool, path):
        if port:
            D, Col, Sch, Sem = dt, ColumnSchema, Schema, SemanticType
            self.storage = StorageEngine(EngineConfig(data_home=str(path)))
            mito, cm = MitoEngine(self.storage), MemoryCatalogManager()
            create, self.Batch = CreateTableRequest, WriteBatch
        else:
            D, Col, Sch, Sem = ref_dt, RefColumn, RefSchema, RefSemantic
            self.storage = RefStorage(RefConfig(data_home=str(path)))
            mito, cm = RefMito(self.storage), RefCatalog()
            create, self.Batch = RefCreate, RefBatch
        self.port = port
        self.schema = Sch([
            Col("host", D.STRING, nullable=False,
                semantic_type=Sem.TAG),
            Col("ts", D.TIMESTAMP_MILLISECOND, nullable=False,
                semantic_type=Sem.TIMESTAMP),
            Col("cpu", D.FLOAT64),
            Col("mem", D.FLOAT64),
        ])
        self.table = mito.create_table(create("m", self.schema,
                                              primary_key_indices=[0]))
        cm.register_table("greptime", "public", "m", self.table)
        self.region = next(iter(self.table.regions.values()))
        self.engine = QueryEngine(cm, device="cpu") if port \
            else RefEngine(cm)
        self.exec = tpu_exec if port else ref_exec
        self.stream = stream_exec if port else ref_stream

    def put(self, cols):
        wb = self.Batch(self.schema)
        wb.put(cols)
        self.region.write(wb)

    def delete(self, cols):
        wb = self.Batch(self.schema)
        wb.delete(cols)
        self.region.write(wb)

    def query(self, sql):
        """(frame, dispatch decision, the region's scan profile)."""
        self.region.last_scan_profile = None
        stats = exec_stats if self.port else ref_stats
        parse = parse_sql if self.port else ref_parse
        ctx = QueryContext() if self.port else RefCtx()
        with stats.collect() as st:
            out = self.engine.execute(parse(sql), ctx)
        frames = [pd.DataFrame(b.to_pydict()) for b in out.batches]
        df = pd.concat(frames, ignore_index=True) if frames \
            else pd.DataFrame()
        return df, st.dispatch, self.region.last_scan_profile


def make_worlds(tmp_path, *, n=6000, seed=3, flushes=4):
    """Both packages' `m`, written by the same batches: overlapping time
    ranges across flushes (overlapping SSTs, overwrites across files),
    deletes, NULLs in `mem`, the last batch left in the memtable."""
    ref, port = World(False, tmp_path / "ref"), World(True, tmp_path / "port")
    rng = np.random.default_rng(seed)
    chunk = n // (flushes + 1)
    for part in range(flushes + 1):
        hosts = [f"h{int(h)}" for h in rng.integers(0, 7, chunk)]
        ts = rng.integers(0, n * 40, chunk).astype(np.int64).tolist()
        cpu = rng.random(chunk).round(4).tolist()
        mem = [None if i % 13 == 0 else float(i % 50)
               for i in range(chunk)]
        dels = None
        if part % 2 == 1:
            k = int(rng.integers(1, 40))
            dels = {"host": [f"h{int(h)}" for h in rng.integers(0, 7, k)],
                    "ts": rng.integers(0, n * 40, k).tolist()}
        for w in (ref, port):
            w.put({"host": hosts, "ts": ts, "cpu": cpu, "mem": mem})
            if dels is not None:
                w.delete(dels)
            if part < flushes:
                w.region.flush()
    for w in (ref, port):
        # the compaction the flushes set off, done in both packages
        w.storage.scheduler.wait_idle(timeout=60)
    return ref, port


@pytest.fixture(autouse=True)
def _pinned_knobs(monkeypatch):
    """Both packages: the device path at any size, the streaming knobs
    of tests/test_stream_exec.py, "host" reduction, empty caches."""
    for ex, st in ((ref_exec, ref_stream), (tpu_exec, stream_exec)):
        monkeypatch.setattr(ex, "TPU_DISPATCH_MIN_ROWS", 0)
        monkeypatch.setattr(ex, "_dispatch_min_rows", lambda: 0)
        monkeypatch.setattr(st, "_SLICE_ROWS", [700])
        monkeypatch.setattr(st, "_ROW_BUCKET_MIN", 256)
        monkeypatch.setattr(st, "_COLD_REDUCE", ["host"])
    _clear_caches()
    yield
    _clear_caches()


def _clear_caches():
    with ref_exec.SCAN_CACHE._lock:          # the reference has no clear()
        ref_exec.SCAN_CACHE._entries.clear()
    tpu_exec.SCAN_CACHE.clear()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ref, port = make_worlds(tmp_path_factory.mktemp("worlds"))
    yield ref, port
    ref.storage.close()
    port.storage.close()


def _streaming(monkeypatch):
    monkeypatch.setattr(ref_stream, "_STREAM_THRESHOLD_ROWS", [0])
    monkeypatch.setattr(stream_exec, "_STREAM_THRESHOLD_ROWS", [0])


def _exact(got, want, sql):
    assert list(got.columns) == list(want.columns), sql
    assert len(got) == len(want) > 0, sql
    for c in want.columns:
        np.testing.assert_array_equal(got[c].to_numpy().astype(object),
                                      want[c].to_numpy().astype(object),
                                      err_msg=f"{c}: {sql}")


def _within_float32(got, want, sql, data):
    """tests/test_torch_sql.py's bounds: keys and counts exact; min, max,
    first and last the float32 rounding of the float64 answer; sums and
    averages within 1e-5 |ref| + 8 eps32 P / c (P: the column's sum of
    |x|, c: the group's count), standard deviations within 1e-3
    relative."""
    assert list(got.columns) == list(want.columns), sql
    assert len(got) == len(want) > 0, sql
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        lc = c.lower()
        if lc.startswith(("sum(", "avg(", "stddev(")):
            g64, w64 = g.astype(np.float64), w.astype(np.float64)
            np.testing.assert_array_equal(np.isnan(g64), np.isnan(w64))
            ok = ~np.isnan(w64)
            if lc.startswith("stddev("):
                tol = 1e-3 * np.abs(w64) + 1e-4
            else:
                P = data[lc[lc.index("(") + 1:lc.index(")")]]
                cnt = [k for k in want.columns
                       if k.lower().startswith("count(")]
                cc = want[cnt[0]].to_numpy(np.float64) \
                    if lc.startswith("avg(") and cnt else 1.0
                tol = 1e-5 * np.abs(w64) + 8 * EPS32 * P / np.maximum(cc, 1)
            err = np.abs(g64 - w64)
            assert (err[ok] <= np.broadcast_to(tol, err.shape)[ok]).all(), \
                f"{c}: max err {err[ok].max()}: {sql}"
        elif w.dtype.kind == "f":
            w32 = w.astype(np.float32).astype(np.float64)
            np.testing.assert_array_equal(g.astype(np.float64), w32,
                                          err_msg=f"{c}: {sql}")
        else:
            np.testing.assert_array_equal(g.astype(object), w.astype(object),
                                          err_msg=f"{c}: {sql}")


def _abs_sums(world):
    data = world.region.snapshot().read_merged()
    out = {}
    for name, (v, m) in data.fields.items():
        x = v if m is None else v[m]
        out[name] = float(np.nansum(np.abs(x.astype(np.float64))))
    return out


@pytest.mark.parametrize("sql", QUERIES)
def test_streamed_host_matches_reference(worlds, monkeypatch, sql):
    ref, port = worlds
    _streaming(monkeypatch)
    want, ref_dispatch, ref_prof = ref.query(sql)
    got, dispatch, prof = port.query(sql)
    assert ref_prof.path == prof.path == "streamed", sql
    assert dispatch == ref_dispatch and dispatch.startswith("streamed-cold")
    assert prof.counters == ref_prof.counters, sql
    _exact(got, want, sql)
    assert not tpu_exec.SCAN_CACHE.cached(port.region)


@pytest.mark.parametrize("sql", QUERIES)
def test_streamed_device_matches_reference(worlds, monkeypatch, sql):
    ref, port = worlds
    _streaming(monkeypatch)
    want, _, _ = ref.query(sql)
    monkeypatch.setattr(stream_exec, "_COLD_REDUCE", ["device"])
    got, _, prof = port.query(sql)
    assert prof.path == "streamed"
    assert prof.counters.get("device_slices", 0) > 0, prof.counters
    assert not prof.counters.get("lean_slices"), prof.counters
    _within_float32(got, want, sql, _abs_sums(port))


@pytest.mark.parametrize("seed", range(6))
def test_slice_planners_match_reference(seed):
    """_plan_slices and _plan_jobs on random chunk statistics (disjoint
    runs, overlapping piles, sid-contained files) give the reference's
    slices, at several budgets and clips."""
    rng = np.random.default_rng(seed)
    stats = []
    t = 0
    for _ in range(int(rng.integers(3, 30))):
        if rng.random() < 0.5:
            t += int(rng.integers(1, 5000))          # a gap: clean break
        lo = t - int(rng.integers(0, 2000))          # may overlap
        hi = lo + int(rng.integers(0, 4000))
        slo = int(rng.integers(0, 200))
        shi = slo + int(rng.integers(0, 200))
        stats.append((lo, hi, slo, shi, int(rng.integers(1, 3000))))
        t = max(t, hi)
    for budget in (500, 2000, 10_000):
        for clip in ((None, None), (1000, None), (None, t // 2),
                     (t // 4, 3 * t // 4)):
            s3 = [(a, b, r) for a, b, _, _, r in stats]
            assert stream_exec._plan_slices(s3, budget, *clip) == \
                ref_stream._plan_slices(s3, budget, *clip)

            def norm(jobs):
                return [(d, lo, hi, None if c is None else
                         (c.start, c.end)) for d, lo, hi, c in jobs]
            got = stream_exec._plan_jobs(stats, budget, *clip, "ms")
            want = ref_stream._plan_jobs(stats, budget, *clip, "ms")
            assert norm(got) == norm(want), (budget, clip)


def test_lean_path_engages_in_both(tmp_path, monkeypatch):
    """A bulk-loaded region (dup-free, delete-free, key-disjoint files,
    no memtable rows) takes the lean arrow-batch path in both packages,
    with the same counters and exactly the same answers."""
    rng = np.random.default_rng(11)
    ref, port = World(False, tmp_path / "ref"), World(True, tmp_path / "p")
    hosts, per = 5, 400
    for batch_no in range(3):                   # 3 time-disjoint files
        ts = np.tile(np.arange(per, dtype=np.int64) * 100
                     + batch_no * per * 100, hosts)
        host = np.repeat(np.array([f"h{i}" for i in range(hosts)]),
                         per).astype(object)
        cols = {"host": host, "ts": ts,
                "cpu": rng.random(len(ts)).round(4),
                "mem": rng.random(len(ts)).round(2)}
        ref.table.bulk_load(cols)
        port.table.bulk_load(cols)
    _streaming(monkeypatch)
    for st in (ref_stream, stream_exec):
        monkeypatch.setattr(st, "_SLICE_ROWS", [per * hosts])
    lean = {"ref": [], "port": []}
    for key, st in (("ref", ref_stream), ("port", stream_exec)):
        orig = st._lean_chunk_frames

        def spy(*a, _orig=orig, _key=key, **k):
            r = _orig(*a, **k)
            lean[_key].append(r is not None)
            return r
        monkeypatch.setattr(st, "_lean_chunk_frames", spy)
    try:
        for sql in ("SELECT host, count(*), avg(cpu), max(mem) FROM m "
                    "GROUP BY host ORDER BY host",
                    "SELECT host, date_bin(INTERVAL '30 seconds', ts) AS b, "
                    "min(cpu), sum(mem) FROM m GROUP BY host, b "
                    "ORDER BY host, b LIMIT 40",
                    "SELECT count(*), min(cpu) FROM m WHERE ts >= 5000"):
            want, _, ref_prof = ref.query(sql)
            got, _, prof = port.query(sql)
            _exact(got, want, sql)
            assert prof.counters == ref_prof.counters, sql
        assert lean["port"] == lean["ref"] and lean["port"] \
            and all(lean["port"]), lean
        assert prof.counters.get("lean_slices", 0) > 0
    finally:
        ref.storage.close()
        port.storage.close()


@pytest.mark.parametrize("sql", POINT_QUERIES)
def test_indexed_point_matches_reference(worlds, sql):
    """Point and IN queries on the uncached multi-SST region take the SST
    index in both packages: the same decision string, exact frames, and
    the scan cache left empty."""
    ref, port = worlds
    want, ref_dispatch, ref_prof = ref.query(sql)
    got, dispatch, prof = port.query(sql)
    assert ref_prof.path == prof.path == "indexed-point", sql
    assert dispatch == ref_dispatch and \
        dispatch.startswith("indexed-point"), dispatch
    _exact(got, want, sql)
    assert not tpu_exec.SCAN_CACHE.cached(port.region)


def test_warm_cache_routes_points_resident(worlds):
    """A region already in the scan cache answers point queries resident
    (the reference's rule: a warm cache beats any IO)."""
    ref, port = worlds
    tpu_exec.SCAN_CACHE.get(port.region, "cpu")
    ref_exec.SCAN_CACHE.get(ref.region)
    assert tpu_exec.region_point_sids(port.region, None) is None
    sql = POINT_QUERIES[0]
    _, dispatch, prof = port.query(sql)
    assert prof.path == "resident"
    assert dispatch == "device-resident (scan cache)"
    assert ref_exec.local_dispatch_decision(ref.table) == dispatch == \
        tpu_exec.local_dispatch_decision(port.table, [port.region],
                                         [False], [None])


def _same_scan(a, b, label):
    """Two merged scans hold the same rows: sids, ts, every field's
    values and validity (None = all valid)."""
    np.testing.assert_array_equal(a.series_ids, b.series_ids, label)
    np.testing.assert_array_equal(a.ts, b.ts, label)
    assert set(a.fields) == set(b.fields), label
    for name, (v, m) in b.fields.items():
        av, am = a.fields[name]
        np.testing.assert_array_equal(av, v, f"{label}: {name}")
        ma = np.ones(len(av), bool) if am is None else am
        mb = np.ones(len(v), bool) if m is None else m
        np.testing.assert_array_equal(ma, mb, f"{label}: {name} validity")


def test_incremental_merge_matches_full_rebuild(tmp_path):
    ref, port = make_worlds(tmp_path, n=2400, flushes=3)
    cache = tpu_exec.SCAN_CACHE
    rng = np.random.default_rng(5)

    def step(label, outcome, same_object=False, ref_outcome=None):
        before = cache._entries.get(port.region.uid)
        got = cache.get(port.region, "cpu")
        assert cache.last_outcome() == outcome, label
        if same_object:
            assert got is before.scan, label
        _same_scan(got, tpu_exec._ScanCache().get(port.region, "cpu"),
                   f"{label}: against a full rebuild")
        _same_scan(got, ref_exec.SCAN_CACHE.get(ref.region),
                   f"{label}: against the reference")
        assert ref_exec.SCAN_CACHE.last_outcome() == \
            (ref_outcome or outcome), label
        return got

    def rows(k):
        """k rows: half overwrite keys the region holds (five with a new
        key just before them, spliced in at the same position), the rest
        new (some of new series)."""
        scan = cache.get(port.region, "cpu")
        names = port.region.series_dict.decode_tag_column(
            scan.series_ids, 0)
        old = rng.choice(scan.num_rows, k // 2, replace=False)
        new = k - k // 2 - 5
        return {"host": [str(names[i]) for i in old] +
                [str(names[i]) for i in old[:5]] +
                [f"h{int(h)}" for h in rng.integers(0, 9, new)],
                "ts": [int(scan.ts[i]) for i in old] +
                [int(scan.ts[i]) - 1 for i in old[:5]] +
                rng.integers(0, 96_000, new).tolist(),
                "cpu": rng.random(k).round(3).tolist(),
                "mem": [None if i % 3 == 0 else float(i) for i in range(k)]}

    try:
        step("cold", "full")
        batch = rows(60)                    # overwrites and new keys
        cache.get(port.region, "cpu")       # (rows() read it: still a hit)
        assert cache.last_outcome() == "hit"
        for w in (ref, port):
            w.put(batch)
        step("memtable rows", "incremental")
        for w in (ref, port):               # covered sequences: no read
            w.region.flush()
        step("flush of covered rows", "incremental", same_object=True)
        batch = rows(40)
        for w in (ref, port):               # rows that reach an SST
            w.put(batch)
            w.region.flush()
        step("new SST rows", "incremental")
        dels = {k: v[:15] for k, v in batch.items() if k in ("host", "ts")}
        for w in (ref, port):
            w.delete(dels)
        scan = step("deletes", "incremental")
        assert scan.num_rows < cache.get(port.region, "cpu").num_rows + 1
        batch = rows(10)
        for w in (ref, port):
            w.put(batch)
        with failpoint.cfg("scan_cache_incremental", "err"):
            # (the port's failpoint: the reference merges its delta)
            step("failpoint", "full", ref_outcome="incremental")
        # TTL retraction: the oldest SST expires
        for w in (ref, port):
            files = w.region.version_control.current.ssts.all_files()
            w.region.ttl_ms = 1
            assert w.region.apply_ttl(
                now_ms=min(f.time_range[1] for f in files) + 2) >= 1
        step("TTL retraction", "full")
        # a schema change
        port.region.alter(Schema(
            list(port.region.schema.column_schemas) +
            [ColumnSchema("extra", dt.FLOAT64)]))
        ref.region.alter(RefSchema(
            list(ref.region.schema.column_schemas) +
            [RefColumn("extra", ref_dt.FLOAT64)]))
        step("schema change", "full")
    finally:
        ref.storage.close()
        port.storage.close()


def test_scan_fusion_one_leader(worlds, monkeypatch):
    """Eight threads run the same resident query: one region pass (the
    leader's), seven followers, eight equal frames; with SET scan_fusion
    off each thread scans alone."""
    _, port = worlds
    sql = QUERIES[1]
    passes = []
    orig = tpu_exec._execute_region

    def slow(*a, **k):
        passes.append(1)
        time.sleep(1.0)                 # the cohort arrives meanwhile
        return orig(*a, **k)
    monkeypatch.setattr(tpu_exec, "_execute_region", slow)

    def run_all(n=8):
        barrier = threading.Barrier(n)
        frames = [None] * n

        def run(i):
            barrier.wait()
            frames[i] = port.query(sql)[0]
        ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        return frames

    frames = run_all()
    assert len(passes) == 1, passes
    assert all(f is not None and f.equals(frames[0]) for f in frames)
    passes.clear()
    tpu_exec.configure_scan_fusion(enabled=False)
    try:
        solo = run_all(3)
    finally:
        tpu_exec.configure_scan_fusion(enabled=True)
    assert len(passes) == 3
    assert all(f.equals(frames[0]) for f in solo)


def test_plan_codec_matches_reference(worlds, monkeypatch):
    """plan_to_dict of the port's plans is byte-identical to the
    reference's for the same statements, and round-trips."""
    ref, port = worlds
    _streaming(monkeypatch)
    plans = {"ref": [], "port": []}
    for key, ex in (("ref", ref_exec), ("port", tpu_exec)):
        orig = ex.plan_for

        def spy(*a, _orig=orig, _key=key, **k):
            p = _orig(*a, **k)
            plans[_key].append(p)
            return p
        monkeypatch.setattr(ex, "plan_for", spy)
    for sql in QUERIES + POINT_QUERIES:
        ref.query(sql)
        port.query(sql)
    assert len(plans["port"]) == len(plans["ref"]) == \
        len(QUERIES) + len(POINT_QUERIES)
    for p, r in zip(plans["port"], plans["ref"]):
        got = json.dumps(plan_codec.plan_to_dict(p), sort_keys=True)
        assert got == json.dumps(ref_codec.plan_to_dict(r), sort_keys=True)
        back = plan_codec.plan_from_dict(json.loads(got))
        assert json.dumps(plan_codec.plan_to_dict(back),
                          sort_keys=True) == got


def test_kill_stops_streamed_scan_within_one_slice(tmp_path, monkeypatch):
    """A streamed scan of ten time-disjoint bulk loads, slowed to 150 ms
    per slice boundary (failpoint `stream_slice`), stops with
    QueryCancelledError within about one slice of its KILL, far short of
    its full run."""
    port = World(True, tmp_path)
    per = 2000
    for chunk in range(10):
        port.table.bulk_load({
            "host": np.repeat(np.array([f"h{i}" for i in range(20)]),
                              per // 20).astype(object),
            "ts": np.arange(per, dtype=np.int64) * 1000 + chunk * per * 1000,
            "cpu": np.random.default_rng(chunk).random(per),
            "mem": np.ones(per)})
    _streaming(monkeypatch)
    monkeypatch.setattr(stream_exec, "_SLICE_ROWS", [1000])
    entry = process_list.REGISTRY.register("SELECT ... streamed", "http",
                                           "greptime", "public", None)
    outcome = []

    def run():
        with process_list.install(entry):
            try:
                port.query(QUERIES[0])
                outcome.append("completed")
            except QueryCancelledError:
                outcome.append("cancelled")

    try:
        with failpoint.cfg("stream_slice", "delay(150)"):
            t = threading.Thread(target=run)
            t.start()
            time.sleep(0.5)                     # a few slices in
            t0 = time.perf_counter()
            process_list.REGISTRY.kill(entry.id)
            t.join(timeout=30)
            elapsed = time.perf_counter() - t0
    finally:
        process_list.REGISTRY.deregister(entry)
        port.storage.close()
    assert outcome == ["cancelled"], outcome
    assert port.region.last_scan_profile is None
    assert elapsed < 2.0, f"{elapsed:.2f}s after KILL"


def test_region_stats_match_reference(worlds):
    """The streaming bounds' inputs (estimated rows and decoded bytes,
    the time span) and the stat entries built from them are the
    reference's."""
    ref, port = worlds
    for fn in ("region_estimated_rows", "region_estimated_bytes",
               "region_time_span"):
        assert getattr(stream_exec, fn)(port.region) == \
            getattr(ref_stream, fn)(ref.region), fn
    (got,), rows, nbytes = stream_exec.region_stat_entries([port.region])
    (want,), ref_rows, ref_bytes = ref_stream.region_stat_entries(
        [ref.region])
    assert (rows, nbytes) == (ref_rows, ref_bytes)
    assert {k: v for k, v in got.items() if k != "region"} == \
        {k: v for k, v in want.items() if k != "region"}
    assert tpu_exec.region_streams_cold(port.region) == \
        ref_exec.region_streams_cold(ref.region) is False


def test_cache_residency_and_budget(worlds):
    """resident_bytes counts the entries' host arrays and mirrors;
    configure() applies a new budget at once, and the newest entry stays
    even when it alone exceeds it."""
    _, port = worlds
    cache = tpu_exec.SCAN_CACHE
    scan = cache.get(port.region, "cpu")
    scan.device_ts()
    assert cache.resident_bytes() == scan.nbytes > scan.ts.nbytes
    saved = cache.budget_bytes
    try:
        cache.configure(budget_bytes=1)
        assert cache.cached(port.region)
        cache.configure(capacity=0)
        assert cache.cached(port.region)
    finally:
        cache.configure(budget_bytes=saved, capacity=16)
