"""count(DISTINCT) over a distributed table, the JAX package against the
port, on the CPU.

Over a DistTable both packages lower `count(DISTINCT x)` to a sketch
partial (query/tpu_exec.py `plan_for`, final op `count_distinct`): each
datanode ships one DistinctSketch frame per group (query/sketches.py),
exact up to EXACT_SET_LIMIT (4096) values and a HyperLogLog beyond it,
and the frontend merges and decodes them. `SET exact_distinct = 1`
refuses the sketch, and the statement takes the exact raw-row scatter.

Each package runs its own cluster (tests/test_torch_distributed.py's
`Cluster`: in-process meta, datanodes behind LocalDatanodeClients, the
port on "cpu") over the same bulk-loaded rows from one numpy seed, at two
and at four datanodes. Every answer must be bit-equal to the reference's
(counts are integers; the HLL estimate is the same registers decoded the
same way), EXPLAIN's text byte-equal, below and above the 4096-value
bound, global and grouped, over a tag, a BIGINT and a DOUBLE field.
Above the bound the sketch answer is held to the exact raw-row answer
within the sketch's stated error (1.04/sqrt(2^14) relative, four
standard errors). The pushdown and its EXPLAIN are checked against
`SET dist_partial_agg = 0` too. Sketch moments reduce on the host in both
packages, so no JAX program compiles here.
"""

from __future__ import annotations

import numpy as np
import pytest

import greptimedb_tpu.query.sketches as ref_sk
import greptimedb_tpu_torch.query.sketches as port_sk
from test_torch_distributed import SIDES, Cluster, answer_of

SKETCHES = {"ref": ref_sk, "port": port_sk}

T0 = 1_700_000_000_000
HOSTS = [f"h{i:02d}" for i in range(12)]
ROWS_PER_HOST = 900
DDL = ("CREATE TABLE dd (host STRING, ts TIMESTAMP TIME INDEX, n BIGINT, "
       "x DOUBLE, PRIMARY KEY(host)) PARTITION BY HASH (host) PARTITIONS 4")


def _rows():
    rng = np.random.default_rng(19)
    host = np.repeat(np.array(HOSTS, dtype=object), ROWS_PER_HOST)
    ts = np.tile(T0 + np.arange(ROWS_PER_HOST, dtype=np.int64) * 1000,
                 len(HOSTS))
    n = len(ts)
    # `wide` spans ~8000 distinct values over the table (past the exact
    # set), a few hundred per host (inside it); `narrow` 37 values
    wide = rng.integers(0, 8000, n).astype(np.int64)
    x = rng.integers(0, 37, n) / 4.0
    return {"host": host, "ts": ts, "n": wide, "x": x}


ROWS = _rows()
HLL_REL = 4 * 1.04 / np.sqrt(2 ** 14)

QUERIES = {
    "tag": "SELECT count(DISTINCT host) AS c FROM dd",
    "wide": "SELECT count(DISTINCT n) AS c FROM dd",
    "narrow": "SELECT count(DISTINCT x) AS c FROM dd",
    "wide_by_host": "SELECT host, count(DISTINCT n) AS c FROM dd "
                    "GROUP BY host ORDER BY host",
    "mixed": "SELECT host, count(DISTINCT x) AS d, count(*) AS k, "
             "sum(n) AS s FROM dd GROUP BY host ORDER BY host",
    "filtered": f"SELECT count(DISTINCT n) AS c FROM dd WHERE host = "
                f"'{HOSTS[3]}'",
}


def _run(side, home, nodes):
    """Every answer and EXPLAIN of the script on one package's cluster."""
    m, sk = SIDES[side], SKETCHES[side]
    saved = (list(m.tpu_exec._PARTIAL_PUSHDOWN), list(sk._EXACT_DISTINCT))
    c = Cluster(side, side, home, nodes=nodes)
    out = {}
    try:
        c.beat()
        c.fe.do_query(DDL)
        c.fe.handle_bulk_load("dd", {k: v.copy() for k, v in ROWS.items()},
                              tag_columns=["host"], timestamp_column="ts")
        for name, sql in QUERIES.items():
            out[name] = answer_of(c.fe, sql)
            out[f"explain_{name}"] = answer_of(c.fe, "EXPLAIN " + sql)
        answer_of(c.fe, "SET exact_distinct = 1")
        for name in ("wide", "wide_by_host", "tag"):
            out[f"exact_{name}"] = answer_of(c.fe, QUERIES[name])
            out[f"exact_explain_{name}"] = answer_of(
                c.fe, "EXPLAIN " + QUERIES[name])
        answer_of(c.fe, "SET exact_distinct = 0")
        answer_of(c.fe, "SET dist_partial_agg = 0")
        out["nopush_wide"] = answer_of(c.fe, QUERIES["wide"])
        out["nopush_explain_wide"] = answer_of(c.fe,
                                               "EXPLAIN " + QUERIES["wide"])
        answer_of(c.fe, "SET dist_partial_agg = 1")
    finally:
        m.tpu_exec._PARTIAL_PUSHDOWN[:] = saved[0]
        sk._EXACT_DISTINCT[:] = saved[1]
        if side == "port":
            c.fe.shutdown()
        c.close()
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2dn", "4dn"])
def answers(request, tmp_path_factory):
    return {side: _run(side, str(tmp_path_factory.mktemp(
        f"{side}{request.param}")), request.param) for side in SIDES}


STEPS = [name for name in QUERIES] + \
    [f"explain_{name}" for name in QUERIES] + \
    [f"exact_{n}" for n in ("wide", "wide_by_host", "tag")] + \
    [f"exact_explain_{n}" for n in ("wide", "wide_by_host", "tag")] + \
    ["nopush_wide", "nopush_explain_wide"]


def _frame(result):
    kind, value = result
    assert kind == "ok", result
    return value


@pytest.mark.parametrize("step", STEPS)
def test_step_is_bit_equal_to_reference(answers, step):
    got, want = answers["port"][step], answers["ref"][step]
    assert got[0] == want[0] == "ok", (step, got, want)
    (gnames, gdf), (wnames, wdf) = got[1], want[1]
    assert gnames == wnames, step
    assert gdf.to_dict("list") == wdf.to_dict("list"), step


def test_distinct_lowers_to_the_sketch_partial(answers):
    """The sketch path ran where the reference runs it, and only there."""
    for side in SIDES:
        a = answers[side]
        for name in QUERIES:
            plan = _frame(a[f"explain_{name}"])[1]["plan"][0]
            assert plan.startswith("TpuAggregateExec"), (side, name, plan)
        for name in ("wide", "wide_by_host", "tag"):
            plan = _frame(a[f"exact_explain_{name}"])[1]["plan"][0]
            assert plan.startswith("CpuAggregateExec"), (side, name, plan)
        assert _frame(a["nopush_explain_wide"])[1]["plan"][0].startswith(
            "CpuAggregateExec")


def test_sketch_answers_against_exact(answers):
    """Below 4096 values the sketch is an exact set; above it the HLL
    estimate stays within its stated error of the exact answer."""
    port = answers["port"]
    assert _frame(port["tag"])[1]["c"].tolist() == [len(HOSTS)]
    assert _frame(port["narrow"])[1]["c"].tolist() == \
        [len(np.unique(ROWS["x"]))]
    exact = len(np.unique(ROWS["n"]))
    assert exact > 4096
    assert _frame(port["exact_wide"])[1]["c"].tolist() == [exact]
    assert _frame(port["nopush_wide"])[1]["c"].tolist() == [exact]
    est = _frame(port["wide"])[1]["c"].iloc[0]
    assert abs(est - exact) <= HLL_REL * exact, (est, exact)
    # per host: a few hundred values each, inside the exact set
    by_host = _frame(port["wide_by_host"])[1]
    want = [len(np.unique(ROWS["n"][ROWS["host"] == h])) for h in HOSTS]
    assert by_host["c"].tolist() == want
    assert _frame(port["exact_wide_by_host"])[1]["c"].tolist() == want
    assert _frame(port["filtered"])[1]["c"].tolist() == [want[3]]

