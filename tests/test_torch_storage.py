"""Storage differential tests: the JAX package's StorageEngine and the
port's, side by side on the CPU, each in its own data home.

The same sequence of writes goes through both (WriteBatch puts with
nulls, an overwrite of an existing key, a DELETE, a flush, puts left in
the memtable, a bulk_ingest, a compaction, more puts left unflushed),
and after every step the two regions' `snapshot().scan()` and
`read_merged()` must be exactly equal: series ids, timestamps,
sequences, op types, field values and validity, and the series
dictionary. Then both engines close and reopen, and the WAL replay of the
unflushed rows plus the manifest recovery must again give equal scans.
Both WAL backends run (the Python one and the native group-commit one
built with g++). The reference builds its native library into one
temporary path from every process, so test processes that start together
can collide in that build; `_load_reference_native_wal` loads it under a
lock shared by all processes and recovers from a build that lost such a
race, while a library that really does not build or load still fails the
native cases.

The cross-read case holds the on-disk format: the port opens a region
directory the reference wrote (Parquet SSTs, manifest, series
dictionary, WAL records, `.parquet.idx` sidecars) and must scan exactly
what the reference scans. No tolerance anywhere: storage is exact.
"""

import fcntl
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

from greptimedb_tpu import storage as ref_storage
from greptimedb_tpu.storage import native_wal as ref_native_wal
from greptimedb_tpu.datatypes import data_type as ref_dt
from greptimedb_tpu.datatypes import schema as ref_schema
from greptimedb_tpu_torch import storage as port_storage
from greptimedb_tpu_torch.datatypes import data_type as port_dt
from greptimedb_tpu_torch.datatypes import schema as port_schema

T0 = 1_700_000_000_000
BACKENDS = [
    "python",
    pytest.param("native", marks=pytest.mark.skipif(
        shutil.which("g++") is None,
        reason="the native WAL builds with g++, which this machine lacks")),
]
#: one family of (package modules) per side
SIDES = {"ref": (ref_storage, ref_dt, ref_schema),
         "port": (port_storage, port_dt, port_schema)}


def _schema(side):
    _, dt, sch = SIDES[side]
    tag, fld = sch.SemanticType.TAG, sch.SemanticType.FIELD
    return sch.Schema([
        sch.ColumnSchema("host", dt.STRING, semantic_type=tag),
        sch.ColumnSchema("dc", dt.STRING, semantic_type=tag),
        sch.ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                         semantic_type=sch.SemanticType.TIMESTAMP),
        sch.ColumnSchema("d", dt.FLOAT64, semantic_type=fld),
        sch.ColumnSchema("b", dt.INT64, semantic_type=fld),
        sch.ColumnSchema("s", dt.INT16, semantic_type=fld),
        sch.ColumnSchema("u", dt.UINT32, semantic_type=fld)])


def _load_reference_native_wal():
    """Load the reference's native WAL library under an exclusive lock
    that every test process shares.

    The reference's first build in each process compiles into one shared
    temporary file and renames it into place, so builds that overlap can
    collide: a process whose rename finds the file gone latches
    `_lib_failed` and falls back for its whole life, and one that loads
    while another build still writes the library gets an OSError ("file
    too short"). Under the lock the latch is cleared and the library
    loaded, built again if it must be, a few times over. A library that
    never builds or loads leaves the latch set, and the native case fails
    in `make_wal`, as it must when the native WAL is really broken."""
    lock = os.path.join(tempfile.gettempdir(),
                        "greptimedb_tpu-libgdbwal.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for _ in range(5):
                ref_native_wal._lib_failed = False
                try:
                    if ref_native_wal.load_library() is not None:
                        return
                except OSError:
                    pass        # another process is still writing it
                time.sleep(0.5)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@pytest.fixture
def engines():
    """open(side, data_home, backend) → a StorageEngine; every engine
    opened through it is closed at the end of the test."""
    opened = []

    def open_engine(side, data_home, backend="python"):
        if side == "ref" and backend == "native":
            _load_reference_native_wal()
        st = SIDES[side][0]
        eng = st.StorageEngine(st.EngineConfig(data_home=str(data_home),
                                               wal_backend=backend))
        opened.append(eng)
        return eng

    yield open_engine
    for eng in opened:
        eng.close()


def _rows(rng, hosts, ts, null_every=0):
    """Put columns as lists: nulls where (row % null_every) hits."""
    n = len(ts)
    cols = {"host": [f"h{h}" for h in hosts],
            "dc": [f"dc{h % 2}" for h in hosts],
            "ts": [int(t) for t in ts],
            "d": [float(x) for x in rng.normal(50, 20, n)],
            "b": [int(x) for x in rng.integers(-2**40, 2**40, n)],
            "s": [int(x) for x in rng.integers(20000, 30000, n)],
            "u": [int(x) for x in rng.integers(2**31, 2**32, n)]}
    if null_every:
        for k, name in enumerate(("d", "b", "s", "u")):
            for i in range(k, n, null_every):
                cols[name][i] = None
    return cols


def _apply(region, side, rng_seed, step):
    """One step of the shared sequence on one side's region."""
    st = SIDES[side][0]
    rng = np.random.default_rng(rng_seed)

    def put(cols):
        wb = st.WriteBatch(region.schema)
        wb.put(cols)
        region.write(wb)

    if step == "puts":
        for k in range(3):
            hosts = np.repeat(np.arange(3 * k, 3 * k + 3), 20)
            ts = np.tile(T0 + np.arange(20) * 1000, 3)
            put(_rows(rng, hosts, ts, null_every=7))
    elif step == "overwrite":
        put(_rows(rng, [4], [T0 + 5000]))
    elif step == "delete":
        wb = st.WriteBatch(region.schema)
        wb.delete({"host": ["h7"], "dc": ["dc1"], "ts": [T0 + 9000]})
        region.write(wb)
    elif step == "flush":
        region.flush()
    elif step == "memtable":
        put(_rows(rng, np.repeat([1, 10], 15),
                  np.tile(T0 + 500 + np.arange(15) * 1000, 2),
                  null_every=5))
    elif step == "bulk":
        hosts = np.repeat(np.arange(6, 14), 50)
        n = len(hosts)
        region.bulk_ingest({
            "host": np.array([f"h{h}" for h in hosts], dtype=object),
            "dc": np.array([f"dc{h % 2}" for h in hosts], dtype=object),
            "ts": np.tile(T0 + 30_000 + np.arange(50) * 1000, 8),
            "d": rng.normal(0, 1, n),
            "b": rng.integers(-10**12, 10**12, n),
            "s": rng.integers(-30000, 30000, n).astype(np.int16),
            "u": rng.integers(0, 2**32, n).astype(np.uint32)})
    elif step == "compact":
        region.compact()
    elif step == "tail":
        put(_rows(rng, [2, 2, 11], [T0 + 1000, T0 + 90_000, T0 + 2000],
                  null_every=2))
    else:
        raise ValueError(step)


STEPS = ["puts", "overwrite", "delete", "flush", "memtable", "bulk",
         "compact", "tail"]


def _assert_scans_equal(want, got, what):
    assert got.num_rows == want.num_rows, what
    for name in ("series_ids", "ts", "seq", "op_types"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype, f"{what}: {name} dtype"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")
    assert list(got.fields) == list(want.fields), what
    for name, (wv, wm) in want.fields.items():
        gv, gm = got.fields[name]
        assert gv.dtype == wv.dtype, f"{what}: {name} dtype"
        np.testing.assert_array_equal(gv, wv, err_msg=f"{what}: {name}")
        assert (gm is None) == (wm is None), f"{what}: {name} validity"
        if wm is not None:
            np.testing.assert_array_equal(gm, wm,
                                          err_msg=f"{what}: {name} valid")
    assert got.series_dict.to_dict() == want.series_dict.to_dict(), what


def _assert_regions_equal(ref_region, port_region, what):
    rs, ps = ref_region.snapshot(), port_region.snapshot()
    assert ps.visible_sequence == rs.visible_sequence, what
    _assert_scans_equal(rs.scan(), ps.scan(), f"{what}: scan")
    _assert_scans_equal(rs.read_merged(), ps.read_merged(),
                        f"{what}: read_merged")


@pytest.mark.parametrize("backend", BACKENDS)
def test_write_flush_compact_reopen_match_reference(engines, tmp_path,
                                                    backend):
    homes = {side: tmp_path / side for side in SIDES}
    eng = {side: engines(side, homes[side], backend) for side in SIDES}
    reg = {side: eng[side].create_region("t_0", _schema(side))
           for side in SIDES}
    for k, step in enumerate(STEPS):
        for side in SIDES:
            _apply(reg[side], side, 100 + k, step)
        _assert_regions_equal(reg["ref"], reg["port"], step)
    port = reg["port"]
    assert len(port.version_control.current.ssts.levels[0]) == 0
    assert port.version_control.current.memtables.mutable.num_rows == 3
    if backend == "native":
        assert type(port.wal).__name__ == "NativeWal"
    for side in SIDES:
        eng[side].close()
    eng = {side: engines(side, homes[side], backend) for side in SIDES}
    reg = {side: eng[side].open_region("t_0") for side in SIDES}
    assert reg["port"].version_control.current.memtables.mutable \
        .num_rows == 3                             # replayed from the WAL
    _assert_regions_equal(reg["ref"], reg["port"], "reopen")


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_reads_reference_region_directory(engines, tmp_path,
                                               backend):
    home = tmp_path / "shared"
    ref_eng = engines("ref", home, backend)
    ref_region = ref_eng.create_region("t_0", _schema("ref"))
    for k, step in enumerate(STEPS):
        _apply(ref_region, "ref", 200 + k, step)
    # more L0 files beside the compacted L1 ones, each with its index
    # sidecar
    _apply(ref_region, "ref", 300, "memtable")
    ref_region.flush()
    _apply(ref_region, "ref", 301, "tail")
    ref_eng.close()
    ref_eng = engines("ref", home, backend)
    want = ref_eng.open_region("t_0")
    files = want.version_control.current.ssts.all_files()
    assert files and all(f.index_file for f in files)
    snap = want.snapshot()
    want_scan, want_merged = snap.scan(), snap.read_merged()
    sids = np.array([1, 7], dtype=np.int32)
    want_point = snap.scan(sid_set=sids)
    ref_eng.close()

    port_eng = engines("port", home, backend)
    got = port_eng.open_region("t_0")
    assert got.version_control.current.memtables.mutable.num_rows == 3
    snap = got.snapshot()
    _assert_scans_equal(want_scan, snap.scan(), "scan")
    _assert_scans_equal(want_merged, snap.read_merged(), "read_merged")
    # the sid_set scan prunes through the reference's index sidecars
    _assert_scans_equal(want_point, snap.scan(sid_set=sids), "sid_set")
