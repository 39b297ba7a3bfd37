"""The region reduce's live-run compaction, on the CPU.

`tpu_exec._fetch_launched` copies each launch's live runs alone (those
with a row), with their run indices, and `_collect_moment_frame` builds
the partial moment frame from them. Here every statement's frame is held
to the frame of the order the collect had before the compaction: decode
every launched run's tags, build a frame over every run, then keep the
live rows. Columns, dtypes, values and row order are equal.

A standalone frontend on the CPU holds `t` (HOSTS hosts x SAMPLES
samples; DOUBLE, INT UNSIGNED and SMALLINT fields with NULLs) and `nt`,
with a BIGINT UNSIGNED tag that holds a value past int64. A dispatch
floor of 0 rows sends their GROUP BYs down the device path. A series
dictionary of Python ints past int64, whose live values alone would
infer another dtype than those of every run, is held to the old order
on its own.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import tpu_exec
from greptimedb_tpu_torch.query.planner import _group_slot
from greptimedb_tpu_torch.storage.series import SeriesDict

T0 = 1_700_000_000_000
HOSTS, SAMPLES = 8, 40


def _lit(v):
    return "NULL" if v is None else repr(v)


def _t_rows():
    rng = np.random.default_rng(11)
    rows = []
    for k in range(SAMPLES):
        for h in range(HOSTS):
            v = None if rng.random() < 0.1 else \
                float(np.round(rng.normal(50, 20), 3))
            u = None if rng.random() < 0.1 else \
                int(rng.integers(0, 2**32))
            s = None if rng.random() < 0.1 else \
                int(rng.integers(-2**15, 2**15))
            rows.append(f"('h{h}', {T0 + k * 5000}, {_lit(v)}, {_lit(u)}, "
                        f"{_lit(s)})")
    return ", ".join(rows)


#: `nt`'s series: (host, big)
NT_SERIES = [("a", 1), ("b", 2**63 + 5), ("c", 7), ("d", 3)]


def _nt_rows():
    return ", ".join(
        f"('{host}', {big}, {T0 + k * 1000}, {float(k + i)})"
        for k in range(6) for i, (host, big) in enumerate(NT_SERIES))


@pytest.fixture(scope="module")
def fe(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(tpu_exec, "_dispatch_min_rows", lambda: 0)
    f = build_standalone(DatanodeOptions(
        data_home=str(tmp_path_factory.mktemp("live_runs")), device="cpu"))
    try:
        f.do_query("CREATE TABLE t (host STRING, ts TIMESTAMP TIME INDEX, "
                   "v DOUBLE, u INT UNSIGNED, s SMALLINT, PRIMARY KEY(host))")
        f.do_query("INSERT INTO t VALUES " + _t_rows())
        f.do_query("CREATE TABLE nt (host STRING, big BIGINT UNSIGNED, "
                   "ts TIMESTAMP TIME INDEX, v DOUBLE, "
                   "PRIMARY KEY(host, big))")
        f.do_query("INSERT INTO nt VALUES " + _nt_rows())
        # whole-table statements fill the scan cache: point and IN
        # statements then take the resident path too
        for table in ("t", "nt"):
            f.do_query(f"SELECT count(v) FROM {table}")
        yield f
    finally:
        f.shutdown()
        mp.undo()


@pytest.fixture
def collected(monkeypatch):
    """Each collect's (launch, plan, frame), the collect left as it is."""
    seen = []
    collect = tpu_exec._collect_moment_frame

    def spy(launched, plan, counts, res_np, live):
        out = collect(launched, plan, counts, res_np, live)
        seen.append((launched, plan, out))
        return out

    monkeypatch.setattr(tpu_exec, "_collect_moment_frame", spy)
    return seen


def _old_order_frame(ln, plan):
    """The collect's frame before the compaction, from the launch's full
    results: every run's tags decoded, a frame over every run, then the
    live rows; None where no run is live."""
    res_np = tpu_exec._narrow_results([r.numpy() for r in ln.results], plan,
                                      ln.narrow)
    counts = ln.counts.numpy()
    live = counts > 0
    if not live.any():
        return None
    run_sids = ln.series_ids[ln.run_starts]
    frame = {}
    for tg in plan.tag_groups:
        frame[_group_slot(tg.name)] = ln.series_dict.decode_tag_column(
            run_sids, tg.tag_index)
    if plan.bucket is not None:
        frame[_group_slot(plan.bucket.expr_key)] = \
            ln.buckets[ln.run_starts] * plan.bucket.stride_ms + \
            plan.bucket.origin
    for m, r in zip(plan.moments, res_np):
        if m.op in ("min_ts", "max_ts"):
            r = r.astype(np.int64) + ln.ts_base
        frame[m.slot] = r
    frame["__rowcount"] = counts
    return pd.DataFrame(frame)[live]


def _assert_same_frame(got, want):
    """Equal columns in order, dtypes, values and rows in order (the old
    frame kept its rows' positions among every run as its index)."""
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    pd.testing.assert_frame_equal(got, want.reset_index(drop=True),
                                  check_exact=True)


#: (statement, its live runs of all launched)
PLANS = {
    "avg": ("SELECT host, avg(v) FROM t GROUP BY host", "all"),
    "max-min": ("SELECT host, max(v), min(v) FROM t "
                "WHERE host IN ('h1', 'h5') GROUP BY host", "some"),
    "first-last": ("SELECT host, first_value(v), last_value(v) FROM t "
                   f"WHERE ts >= {T0 + 60_000} AND host != 'h4' "
                   "GROUP BY host", "some"),
    "uint32": ("SELECT host, sum(u), max(u), first_value(u), last_value(u) "
               "FROM t WHERE host IN ('h0', 'h2', 'h7') GROUP BY host",
               "some"),
    "int16": ("SELECT host, date_bin(INTERVAL '30 seconds', ts) AS b, "
              "sum(s), min(s), max(s) FROM t WHERE host != 'h3' "
              "GROUP BY host, b", "some"),
    "single": ("SELECT host, avg(v), count(*) FROM t "
               f"WHERE host = 'h6' AND ts = {T0 + 35_000} GROUP BY host",
               "one"),
    "uint64-tag": ("SELECT big, sum(v) FROM nt WHERE host IN ('a', 'c') "
                   "GROUP BY big", "some"),
    "uint64-tag-one": ("SELECT host, big, count(v) FROM nt "
                       "WHERE host = 'b' GROUP BY host, big", "one"),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_compacted_frame_is_the_old_orders(fe, collected, name):
    """The partial frame from the live runs alone equals the frame of
    decode, frame over every run, filter, from the same launch."""
    sql, liveness = PLANS[name]
    fe.do_query(sql)
    (ln, plan, got), = collected
    want = _old_order_frame(ln, plan)
    live = int((ln.counts > 0).sum())
    assert {"all": live == ln.nruns, "some": 1 < live < ln.nruns,
            "one": live == 1}[liveness], (live, ln.nruns)
    _assert_same_frame(got, want)


def test_zero_live_runs_copy_an_empty_index(fe, collected, monkeypatch):
    """A launch without a live run copies no column and collects to None,
    as the old order; beside launches with live runs, one
    synchronisation learns every launch's size."""
    fe.do_query(PLANS["max-min"][0])
    (ln, plan, _), = collected
    dead = dataclasses.replace(ln, counts=torch.zeros_like(ln.counts))
    assert _old_order_frame(dead, plan) is None
    syncs = []
    to_host = tpu_exec._sizes_to_host

    def spy(sizes):
        syncs.append(sizes.tolist())
        return to_host(sizes)

    monkeypatch.setattr(tpu_exec, "_sizes_to_host", spy)
    fetched = tpu_exec._fetch_launched([ln, dead, ln], plan)
    assert syncs == [[2, 0, 2]]
    (_, _, live0), (counts, res_np, live), (_, _, live2) = fetched
    assert len(live) == len(counts) == 0 and all(len(r) == 0 for r in res_np)
    assert tpu_exec._collect_moment_frame(dead, plan, counts, res_np,
                                          live) is None
    assert list(live0) == list(live2) == list(np.nonzero(
        ln.counts.numpy() > 0)[0])


def test_tag_past_int64_keeps_every_runs_dtype():
    """Python int tag values with one past int64: a column of every run's
    values infers uint64, one of the live runs' values alone int64. The
    live column keeps every run's dtype, as the old order's frame."""
    sd = SeriesDict(["big"])
    sids = sd.encode_rows([[1, 2**63 + 5, 7]])
    assert not sd.subset_infers_alike(0)
    counts = np.array([2, 0, 1], dtype=np.int32)
    ln = tpu_exec._Launched(
        results=(), counts=torch.from_numpy(counts), nruns=3,
        run_starts=np.arange(3), series_ids=sids, buckets=None,
        series_dict=sd, ts_base=0, narrow=[])
    live = np.nonzero(counts > 0)[0].astype(np.int32)
    got = pd.DataFrame({"big": tpu_exec._live_tag_column(
        ln, 0, ln.run_starts[live], live)})
    want = pd.DataFrame({"big": sd.decode_tag_column(sids, 0)})[counts > 0]
    _assert_same_frame(got, want)
    assert got["big"].dtype == np.uint64
