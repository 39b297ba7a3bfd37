"""Integer fields on the raw-row path: the JAX package against the port,
on the CPU.

Both packages' standalone frontends (`build_standalone(DatanodeOptions(
device="cpu"))` and the reference's FrontendInstance) get the same
table of INT, BIGINT and BIGINT UNSIGNED fields: one copy whose rows
stay in the memtable, one flushed to an SST by `ADMIN FLUSH TABLE`.
The statements below take the pandas raw-row path (the dispatch floor
raised above the table), where a field that carries a validity array is
read as float64: `i + 1` is Float64, `max(u)` over BIGINT UNSIGNED above
2^63 and `count(DISTINCT b)` over 2^53 and 2^53 + 1 see the float64
values. Every value and every column type must equal the reference's.

Then one pin on the device path (`SET tpu_dispatch_min_rows = 0`):
`sum(u)` / `max(u)` over BIGINT UNSIGNED 5000000000 and 7. The port's
float32 mirror answers within the float32 bound of the exact answer; the
reference keeps the low 32 bits of each value on the device (705032711 /
705032704), which the port deliberately does not copy.
"""

import math

import pytest

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import tpu_exec as ref_exec
from greptimedb_tpu.session import QueryContext as RefCtx
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.session import QueryContext

EPS32 = 2.0 ** -24
B53 = 2 ** 53
U_BIG = 2 ** 63 + 11

#: table name -> whether its rows are flushed to an SST
TABLES = {"t_mem": False, "t_sst": True}


def _script(name, flush):
    out = [
        f"CREATE TABLE {name} (k STRING, ts TIMESTAMP TIME INDEX, i INT, "
        f"b BIGINT, u BIGINT UNSIGNED, PRIMARY KEY(k))",
        f"INSERT INTO {name} VALUES ('a', 1000, 5, {B53}, {U_BIG}), "
        f"('b', 2000, -3, {B53 + 1}, 7)",
    ]
    if flush:
        out.append(f"ADMIN FLUSH TABLE {name}")
    return out


class Side:
    def __init__(self, port: bool, home):
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
        self.exec = tpu_exec if port else ref_exec
        self.ctx = QueryContext() if port else RefCtx()
        for name, flush in TABLES.items():
            for sql in _script(name, flush):
                self.fe.do_query(sql, self.ctx)
        self.fe.datanode.storage.scheduler.wait_idle(timeout=60)
        # the flushed copy holds no memtable rows
        region = next(iter(self.fe.catalog.table(
            "greptime", "public", "t_sst").regions.values()))
        assert all(m.num_rows == 0 for m in
                   region.version_control.current.memtables.all_memtables())

    def run(self, sql):
        """(column type names, column values) of the statement's last
        output."""
        out = self.fe.do_query(sql, self.ctx)[-1]
        b = out.batches[0]
        return [c.dtype.name for c in b.schema.column_schemas], \
            b.to_pydict()

    def clear_cache(self):
        cache = self.exec.SCAN_CACHE
        with cache._lock:                # the reference has no clear()
            cache._entries.clear()


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    ref = Side(False, tmp_path_factory.mktemp("ref"))
    port = Side(True, tmp_path_factory.mktemp("port"))
    yield ref, port
    ref.fe.shutdown()
    port.fe.shutdown()


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch, sides):
    """SET tpu_dispatch_min_rows changes module state in both packages:
    restore it, and start each statement with empty scan caches."""
    for ex in (ref_exec, tpu_exec):
        monkeypatch.setattr(ex, "TPU_DISPATCH_MIN_ROWS",
                            ex.TPU_DISPATCH_MIN_ROWS)
        monkeypatch.setattr(ex, "_observed_min_dt", [None])
    for side in sides:
        side.clear_cache()
    yield


#: raw-row statements; {t} is the table
RAW_ROW = {
    "int-arith": "SELECT i + 1, i * 2, i % 3, abs(i) FROM {t} ORDER BY ts",
    "bigint-arith": "SELECT b + 1, b % 10 FROM {t} ORDER BY ts",
    "ubig-max": "SELECT max(u) FROM {t}",
    "ubig-mod": "SELECT u % 7 FROM {t} ORDER BY ts",
    "bigint-distinct": "SELECT count(DISTINCT b) FROM {t}",
}


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("shape", list(RAW_ROW))
def test_raw_row_integer_fields_match_reference(sides, shape, table):
    sql = RAW_ROW[shape].format(t=table)
    got = []
    for side in sides:
        side.fe.do_query("SET tpu_dispatch_min_rows = 100000000",
                         side.ctx)
        got.append(side.run(sql))
    (ref_types, ref_vals), (port_types, port_vals) = got
    assert port_types == ref_types, sql
    assert port_vals == ref_vals, sql
    # the values the reference gives over memtable rows, so that a
    # change on both sides shows too (an SST read alone carries no
    # validity array for a BIGINT field, so its values stay exact there
    # in both packages)
    if TABLES[table]:
        return
    want = {
        "int-arith": {"i + 1": [6.0, -2.0], "i * 2": [10.0, -6.0],
                      "i % 3": [2.0, 0.0], "abs(i)": [5.0, 3.0]},
        "ubig-max": {"max(u)": [2 ** 63]},
        "ubig-mod": {"u % 7": [1.0, 0.0]},
        "bigint-distinct": {"count(DISTINCT b)": [1]},
    }.get(shape)
    if want is not None:
        assert port_vals == want, sql


@pytest.mark.parametrize("table", list(TABLES))
def test_unsigned_device_path_keeps_width(sides, tmp_path, table):
    """BIGINT UNSIGNED 5000000000 and 7 on the device path: the port
    answers within the float32 bound of the exact sum and max; the
    reference's device mirror keeps the low 32 bits."""
    name = f"w_{table}"
    exact_sum, exact_max = 5_000_000_007, 5_000_000_000
    answers = []
    for side in sides:
        side.fe.do_query(
            f"CREATE TABLE IF NOT EXISTS {name} (k STRING, ts TIMESTAMP "
            f"TIME INDEX, u BIGINT UNSIGNED, PRIMARY KEY(k))", side.ctx)
        side.fe.do_query(f"INSERT INTO {name} VALUES ('a', 1000, "
                         f"5000000000), ('b', 2000, 7)", side.ctx)
        if TABLES[table]:
            side.fe.do_query(f"ADMIN FLUSH TABLE {name}", side.ctx)
        side.fe.do_query("SET tpu_dispatch_min_rows = 0", side.ctx)
        answers.append(side.run(f"SELECT sum(u), max(u) FROM {name}")[1])
        side.fe.do_query(f"DROP TABLE {name}", side.ctx)
    ref, port = answers
    # the reference's low-32-bit answer, which the port does not copy
    low32 = 5_000_000_000 % 2 ** 32
    assert (ref["sum(u)"][0], ref["max(u)"][0]) == (low32 + 7, low32)
    bound = 8 * EPS32 * (5_000_000_000 + 7)
    assert abs(port["sum(u)"][0] - exact_sum) <= bound
    assert abs(port["max(u)"][0] - exact_max) <= bound
    assert not math.isclose(port["sum(u)"][0], ref["sum(u)"][0])


def test_incremental_merge_keeps_integer_types(sides):
    """A cached scan that takes in new memtable rows (the incremental
    merge), and then the same rows after a flush that reuses the cached
    entry: types and values equal the reference's at each step."""
    steps = [
        "INSERT INTO t_inc VALUES ('a', 1000, 5, {b}, {u})".format(
            b=B53, u=U_BIG),
        None,
        "INSERT INTO t_inc VALUES ('b', 2000, -3, {b}, 7)".format(
            b=B53 + 1),
        None,
        "ADMIN FLUSH TABLE t_inc",
        None,
    ]
    sql = ("SELECT i + 1, b % 10, u % 7, abs(i) FROM t_inc ORDER BY ts")
    seen = {}
    for k, side in enumerate(sides):
        side.fe.do_query(
            "CREATE TABLE t_inc (k STRING, ts TIMESTAMP TIME INDEX, i INT, "
            "b BIGINT, u BIGINT UNSIGNED, PRIMARY KEY(k))", side.ctx)
        side.fe.do_query("SET tpu_dispatch_min_rows = 100000000", side.ctx)
        try:
            for i, step in enumerate(steps):
                if step is not None:
                    side.fe.do_query(step, side.ctx)
                    continue
                seen.setdefault(i, []).append(side.run(sql))
                outcome = side.exec.SCAN_CACHE._last.outcome
                seen[i].append(outcome)
        finally:
            side.fe.do_query("DROP TABLE t_inc", side.ctx)
    for i, (ref, ref_outcome, port, port_outcome) in seen.items():
        assert port == ref, steps[i - 1]
        assert port_outcome == ref_outcome
    # the second read merged the new row into the cached scan
    assert seen[3][1] == "incremental"
    assert seen[5][0][0] == ["Float64"] * 4
