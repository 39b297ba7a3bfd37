"""PromQL over distributed tables, the JAX package against the port, on the
CPU.

A DistTable's PromQL takes one of two routes in both packages
(promql/lowering.py): an aggregate over a selector lowers to a plan that
scatters through the aggregate pushdown (the datanodes reduce their
regions' moments, the frontend folds them), and everything else, or
everything under `SET dist_partial_agg = 0`, takes the row path, whose
selector reads remote datanodes by a wire RawScan (`_wire_scan_selection`)
and evaluates on the frontend.

Each pairing of a frontend package with a datanode package runs the same
script: two datanodes behind their package's FlightDatanodeServer, meta
in process, a DistInstance over FlightDatanodeClients (the port's on
"cpu"), the counter `ctr` of tests/test_plan_ir.py (six hosts, gaps,
resets) split over two regions by host, and a two-field table `mf`. The
script sends TQL EVAL on the row path (the matchers =, !=, =~ and !~, a
matcher on a missing tag, an empty selection, the multi-field table),
on the lowered path, and with `SET dist_partial_agg = 0`, and TQL EXPLAIN
and TQL ANALYZE on both routes. Every pairing must answer as the
reference's frontend over the reference's datanodes: label columns and
timestamps exactly, values within rtol 1e-5 on the row path (the float32
bound of tests/test_torch_promql.py) and 2e-5 on the lowered path (the
reference's own lowered-vs-row bound, tests/test_plan_ir.py); EXPLAIN
byte-equal; ANALYZE with the same stages and rows, walls masked.

The port labels the wire scan's rows run by run (`_label_wire_batches`);
it is held to the reference's per-row `_wire_scan_selection` on the same
batches, rows in random order and by series: labels, their order, and
the SeriesMatrix exactly. The shapes
are tests/test_plan_ir.py's, so the reference compiles few programs.
"""

from __future__ import annotations

import re
import types

import numpy as np
import pytest

from test_plan_ir import _seed_rows
from test_torch_distributed import SIDES, Cluster

SPAN = (0, 790, "60s")
CTR = ("CREATE TABLE ctr (host STRING, dc STRING, ts TIMESTAMP TIME INDEX, "
       "val DOUBLE, PRIMARY KEY(host, dc)) PARTITION BY RANGE COLUMNS "
       "(host) (PARTITION r0 VALUES LESS THAN ('h3'), PARTITION r1 VALUES "
       "LESS THAN (MAXVALUE))")
MF = ("CREATE TABLE mf (host STRING, ts TIMESTAMP TIME INDEX, a DOUBLE, "
      "b DOUBLE, PRIMARY KEY(host)) PARTITION BY RANGE COLUMNS (host) "
      "(PARTITION r0 VALUES LESS THAN ('h3'), PARTITION r1 VALUES LESS "
      "THAN (MAXVALUE))")


def _mf_rows():
    rng = np.random.default_rng(19)
    rows = []
    for h in range(5):
        for i in range(60):
            a = float(rng.integers(0, 64)) / 4.0
            b = "NULL" if rng.random() < 0.1 else \
                repr(float(rng.integers(0, 64)) / 8.0)
            rows.append(f"('h{h}', {i * 15_000}, {a}, {b})")
    return rows


ROW_QUERIES = [
    "rate(ctr[1m])",
    "ctr{host='h1'}",
    "ctr{host!='h1'}",
    "ctr{host=~'h[12]'}",
    "ctr{host!~'h[12]'}",
    "ctr{nosuch='x'}",
    "ctr{nosuch=''}",
    "ctr{host='zz'}",
    "mf",
    "mf{__field__='b'}",
    "sum by (host) (rate(mf[1m]))",
    "topk(2, ctr)",
]
LOWERED = [
    "sum by (host) (rate(ctr[1m]))",
    "sum by (dc) (increase(ctr[1m]))",
    "avg by (host) (ctr)",
    "max by (host) (max_over_time(ctr{dc='dc0'}[1m]))",
]
EXPLAINED = ["sum by (host) (rate(ctr[1m]))", "rate(ctr{host=~'h[12]'}[1m])"]


def _tql(verb, q):
    return f"TQL {verb} ({SPAN[0]}, {SPAN[1]}, '{SPAN[2]}') {q}"


def _answer(fe, sql):
    """(column names, rows) of a statement, or ('error', class name)."""
    try:
        out = fe.do_query(sql)[-1]
    except Exception as e:  # noqa: BLE001 — each package's own class
        return ("error", type(e).__name__)
    names = out.schema.names() if out.schema is not None else \
        out.batches[0].schema.names()
    rows = [tuple(r) for b in out.batches for r in b.rows()]
    return (tuple(names), rows)


def _run(front, back, home):
    m = SIDES[front]
    saved = list(m.tpu_exec._PARTIAL_PUSHDOWN)
    c = Cluster(front, back, home, nodes=2, transport="flight")
    out = {}
    try:
        c.beat()
        fe = c.fe
        fe.do_query(CTR)
        fe.do_query("INSERT INTO ctr VALUES " + _seed_rows())
        fe.do_query(MF)
        fe.do_query("INSERT INTO mf VALUES " + ", ".join(_mf_rows()))
        for q in ROW_QUERIES + LOWERED:
            out[f"eval {q}"] = _answer(fe, _tql("EVAL", q))
        for q in EXPLAINED:
            out[f"explain {q}"] = _answer(fe, _tql("EXPLAIN", q))
            out[f"analyze {q}"] = _answer(fe, _tql("ANALYZE", q))
        fe.do_query("SET dist_partial_agg = 0")
        for q in LOWERED:
            out[f"nopush {q}"] = _answer(fe, _tql("EVAL", q))
        out[f"nopush explain {EXPLAINED[0]}"] = _answer(
            fe, _tql("EXPLAIN", EXPLAINED[0]))
    finally:
        m.tpu_exec._PARTIAL_PUSHDOWN[:] = saved
        if front == "port":
            c.fe.shutdown()
        c.close()
    return out


PAIRINGS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    out = {}
    for front, back in [("ref", "ref")] + PAIRINGS:
        out[(front, back)] = _run(front, back, str(
            tmp_path_factory.mktemp(f"{front}-{back}")))
    return out


_WALL = re.compile(r"(elapsed(?:_ms)?[=:] ?)[0-9.e+-]+(ms)?")
_NODE_MS = re.compile(r"(node_ms|slowest_node_ms|network_ms)="
                      r"[0-9A-Za-z:./#-]+")


def _masked(value):
    if isinstance(value, str):
        return _NODE_MS.sub(r"\1=<ms>", _WALL.sub(r"\1<ms>", value))
    if isinstance(value, float):
        return "<float>"
    return value


def _same_rows(got, want, rtol, what):
    assert got[0] == want[0], (what, got, want)
    if got[0] == "error":
        return
    g, w = got[1], want[1]
    assert len(g) == len(w), (what, len(g), len(w))
    for rg, rw in zip(g, w):
        assert len(rg) == len(rw), what
        for x, y in zip(rg, rw):
            if isinstance(y, float) and isinstance(x, float):
                assert (np.isnan(x) and np.isnan(y)) or \
                    np.isclose(x, y, rtol=rtol, atol=1e-9), (what, rg, rw)
            else:
                assert x == y, (what, rg, rw)


STEPS = ([f"eval {q}" for q in ROW_QUERIES + LOWERED] +
         [f"{verb} {q}" for q in EXPLAINED
          for verb in ("explain", "analyze")] +
         [f"nopush {q}" for q in LOWERED] +
         [f"nopush explain {EXPLAINED[0]}"])


@pytest.mark.parametrize("pairing", PAIRINGS,
                         ids=[f"{f}-fe-{b}-dn" for f, b in PAIRINGS])
@pytest.mark.parametrize("step", STEPS)
def test_step_answers_as_reference(answers, pairing, step):
    got, want = answers[pairing][step], answers[("ref", "ref")][step]
    if step.startswith(("explain", "nopush explain")):
        assert got == want, (step, got, want)
    elif step.startswith("analyze"):
        assert got[0] == want[0], step
        assert [tuple(_masked(v) for v in r) for r in got[1]] == \
            [tuple(_masked(v) for v in r) for r in want[1]], step
    else:
        lowered = step.startswith("eval") and step[5:] in LOWERED
        _same_rows(got, want, 2e-5 if lowered else 1e-5, step)


def test_script_took_both_routes(answers):
    """The lowered queries planned the pushdown and the row queries did
    not; `SET dist_partial_agg = 0` sent the lowered shapes to the row
    path, whose answers equal the lowered ones within 2e-5; the matcher
    cases selected what they name."""
    for key, a in answers.items():
        plan = "\n".join(str(v) for r in a[f"explain {EXPLAINED[0]}"][1]
                         for v in r)
        assert "aggregate-pushdown" in plan, (key, plan)
        row_plan = "\n".join(str(v) for r in a[f"explain {EXPLAINED[1]}"][1]
                             for v in r)
        assert "aggregate-pushdown" not in row_plan, (key, row_plan)
        nopush = "\n".join(str(v) for r in
                           a[f"nopush explain {EXPLAINED[0]}"][1]
                           for v in r)
        assert "aggregate-pushdown" not in nopush, (key, nopush)
        for q in LOWERED:
            _same_rows(a[f"nopush {q}"], a[f"eval {q}"], 2e-5, (key, q))
        assert a["eval ctr{host='zz'}"][1] == []
        assert a["eval ctr{nosuch='x'}"][1] == []
        assert len(a["eval ctr{nosuch=''}"][1]) == \
            len(a["eval ctr{host='h1'}"][1]) + \
            len(a["eval ctr{host!='h1'}"][1]) > 0
        assert a["eval mf"][1] and a["eval mf{__field__='b'}"][1]


# ---------------------------------------------------------------------------
# the column-wise labelling against the reference's per-row loop
# ---------------------------------------------------------------------------

def _batches(side, parts, multi_field):
    """`parts` (dicts of python lists) as RecordBatches of `side`."""
    pkg = "greptimedb_tpu" if side == "ref" else "greptimedb_tpu_torch"
    rb_mod = __import__(f"{pkg}.datatypes.record_batch",
                        fromlist=["RecordBatch"])
    sch = __import__(f"{pkg}.datatypes.schema", fromlist=["Schema"])
    dt = __import__(f"{pkg}.datatypes.data_type", fromlist=["STRING"])
    tag, ts = sch.SemanticType.TAG, sch.SemanticType.TIMESTAMP
    cols = [sch.ColumnSchema("host", dt.STRING, semantic_type=tag),
            sch.ColumnSchema("dc", dt.STRING, semantic_type=tag),
            sch.ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                             semantic_type=ts)]
    cols += [sch.ColumnSchema(f, dt.FLOAT64, nullable=True)
             for f in (("a", "b") if multi_field else ("a",))]
    schema = sch.Schema(cols)
    return schema, [rb_mod.RecordBatch.from_pydict(schema, p) for p in parts]


def _label_parts(seed, multi_field, by_series):
    """Three batches as a scatter returns them: a host that repeats
    across batches, NULL and empty tags, NULL values, an empty batch;
    rows in random order, or `by_series` (as a region scans them: long
    runs of one tag tuple, time ascending within each)."""
    rng = np.random.default_rng(seed)
    parts = []
    for n in (40, 0, 55):
        hosts = rng.choice(["h1", "h2", "h10", "", None], n).tolist()
        dcs = rng.choice(["x", "y", None], n).tolist()
        ts = rng.integers(0, 120, n).astype(int) * 1000
        part = {"host": hosts, "dc": dcs, "ts": ts.tolist()}
        for f in (("a", "b") if multi_field else ("a",)):
            v = (rng.integers(0, 50, n) / 4.0).tolist()
            part[f] = [None if rng.random() < 0.15 else x for x in v]
        if by_series:
            order = sorted(range(n), key=lambda i: (
                str(part["host"][i]), str(part["dc"][i]), part["ts"][i]))
            part = {k: [v[i] for i in order] for k, v in part.items()}
        parts.append(part)
    return parts


@pytest.mark.parametrize("by_series", [False, True],
                         ids=["random-rows", "by-series"])
@pytest.mark.parametrize("multi_field", [False, True],
                         ids=["one-field", "multi-field"])
@pytest.mark.parametrize("matchers", [
    "", "{host='h1'}", "{host!='h1'}", "{host=~'h1.*'}", "{host!~'h1.*'}",
    "{dc=''}", "{nosuch='x'}", "{nosuch=''}", "{host='zz'}"])
def test_vectorised_labelling_matches_reference(multi_field, matchers,
                                                by_series):
    from greptimedb_tpu.promql import lowering as ref_low
    from greptimedb_tpu.promql.parser import parse_promql as ref_parse
    from greptimedb_tpu_torch.promql import lowering
    from greptimedb_tpu_torch.promql.parser import parse_promql

    parts = _label_parts(7, multi_field, by_series)
    fields = ["a", "b"] if multi_field else ["a"]
    lo, hi = 5_000, 100_000
    ref_schema, ref_batches = _batches("ref", parts, multi_field)
    _, port_batches = _batches("port", parts, multi_field)
    table = types.SimpleNamespace(
        schema=ref_schema,
        scan_batches=lambda **kw: ref_batches)
    want = ref_low._wire_scan_selection(
        table, ref_parse("m" + matchers), "m", ["host", "dc"], fields,
        multi_field, lo, hi)
    got = lowering._label_wire_batches(
        port_batches, parse_promql("m" + matchers), "m", ["host", "dc"],
        "ts", fields, multi_field, lo, hi)
    assert got.labels == want.labels
    if want.matrix is None:
        assert got.matrix is None
        return
    assert (got.data_min, got.data_max) == (want.data_min, want.data_max)
    for attr in ("ts", "values", "lengths"):
        g, w = getattr(got.matrix, attr), getattr(want.matrix, attr)
        assert g.dtype == w.dtype, attr
        np.testing.assert_array_equal(g, w, err_msg=attr)
