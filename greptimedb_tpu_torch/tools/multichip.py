"""The port's graft entry: a one-device query step and a multi-rank dry
run (the twin of the JAX package's __graft_entry__.py).

    python3 -m greptimedb_tpu_torch.tools.multichip [--ranks N]
        [--device cpu|cuda]

`entry()` returns the query step (time-range filter, (host x bucket)
group ids, fused avg / max / count through the grouped-moments kernel)
with example inputs on the device. `dryrun_multichip(n)` runs the
reference's four checks over a mesh of n ranks: the distributed grouped
aggregate against the single-device one; series-sharded windows over
epoch-millisecond int64 timestamps against range_aggregate_cumsum on the
rebased arrays, on the raw ones and against a numpy brute force;
time-blocked windows against numpy; and the distributed plane (DDL,
split inserts, aggregate pushdown) over a DistInstance and in-process
datanodes. Inside a process group of n ranks (torch.distributed already
initialised) the mesh checks run in it, collectively; otherwise n ranks
are spawned (gloo for "cpu", NCCL with a GPU each for "cuda"). Every
call runs on "cuda" unless asked for the CPU, and raises without CUDA.
"""

from __future__ import annotations

import argparse
import math
import shutil
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

HOSTS = 8
BUCKETS = 16
NUM_GROUPS = HOSTS * BUCKETS


def _forward(gids, ts, cpu, mem, t_lo, t_hi):
    """One query step: time-range filter, (host x bucket) group ids, fused
    avg(cpu), max(mem), count aggregation."""
    from ..ops.kernels import (combine_group_ids, grouped_aggregate,
                               time_bucket_ids)
    mask = (ts >= t_lo) & (ts < t_hi)
    buckets = time_bucket_ids(ts, 0, 60_000, BUCKETS)
    full_gids = combine_group_ids(gids, buckets, BUCKETS)
    (avg_cpu, max_mem, cnt), counts = grouped_aggregate(
        full_gids, mask, ts, (cpu, mem, cpu), num_groups=NUM_GROUPS,
        ops=("avg", "max", "count"))
    return avg_cpu, max_mem, cnt, counts


def entry(device: str = "cuda"):
    """Return (fn, example_args): the query step and its inputs, as
    tensors on `device`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: CUDA is not available (pass "
                           "device='cpu' for the plain versions)")
    rng = np.random.default_rng(0)
    n = 4096
    gids = rng.integers(0, HOSTS, n).astype(np.int32)
    ts = rng.integers(0, BUCKETS * 60_000, n).astype(np.int32)
    cpu = rng.random(n).astype(np.float32)
    mem = rng.random(n).astype(np.float32)
    args = tuple(torch.from_numpy(a).to(dev) for a in (gids, ts, cpu, mem))
    return _forward, args + (0, BUCKETS * 60_000)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _dryrun_impl(mesh, payload=None) -> dict:
    """The mesh checks, collective over `mesh` (a rank function of
    run_ranks; `payload` unused); returns what they ran."""
    from ..ops.kernels import combine_group_ids, grouped_aggregate
    from ..ops.window import SeriesMatrix, range_aggregate_cumsum
    from ..parallel import (distributed_grouped_aggregate,
                            series_sharded_range_aggregate,
                            time_blocked_window_sum)

    dev = mesh.device
    rng = np.random.default_rng(1)

    # --- distributed fused group-by aggregate (rows over the mesh) ---
    n = 8 * 1024
    gids = rng.integers(0, HOSTS, n).astype(np.int32)
    ts = rng.integers(0, BUCKETS * 60_000, n).astype(np.int32)
    cpu = rng.random(n).astype(np.float32)
    mem = rng.random(n).astype(np.float32)
    mask = (ts >= 0) & (ts < BUCKETS * 60_000)
    full_gids = _np(combine_group_ids(
        torch.from_numpy(gids), torch.from_numpy(
            (ts // 60_000).clip(0, BUCKETS - 1).astype(np.int32)), BUCKETS))
    ops = ("avg", "max", "count", "sum", "min")
    vals = (cpu, mem, cpu, mem, cpu)
    got, counts = distributed_grouped_aggregate(
        full_gids, mask, ts, vals, num_groups=NUM_GROUPS, ops=ops, mesh=mesh)
    want, want_counts = grouped_aggregate(
        full_gids, mask, ts, vals, num_groups=NUM_GROUPS, ops=ops,
        device=dev)
    np.testing.assert_array_equal(_np(counts), _np(want_counts))
    for op, g, w in zip(ops, got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=3e-4, atol=1e-4,
                                   err_msg=op)

    # --- series-sharded window evaluation ---
    # Epoch-millisecond timestamps on purpose: they exceed int32, so this
    # path only works if every layer rebases rather than narrowing them
    EPOCH = 1_700_000_000_000
    S, per = 24, 40
    sids = np.repeat(np.arange(S), per).astype(np.int32)
    wts = (EPOCH + np.tile(np.arange(per) * 10_000, S)).astype(np.int64)
    wvals = np.abs(rng.normal(size=S * per)).astype(np.float32)
    m = SeriesMatrix.build(sids, wts, wvals, S)
    out, ok = series_sharded_range_aggregate(
        m.ts, m.values, m.lengths, EPOCH + 60_000, 30_000, 60_000,
        op="avg_over_time", nsteps=8, mesh=mesh)
    out, ok = _np(out), _np(ok)
    # oracle 1: the canonical rebase path (SeriesMatrix.device_arrays)
    rts, rvals, rlens, base = m.device_arrays()
    w_out, w_ok = (_np(x) for x in range_aggregate_cumsum(
        *(torch.from_numpy(a).to(dev) for a in (rts, rvals, rlens)),
        EPOCH + 60_000 - base, 30_000, 60_000, op="avg_over_time", nsteps=8))
    np.testing.assert_array_equal(ok, w_ok)
    np.testing.assert_allclose(out[ok], w_out[w_ok], rtol=1e-4)
    # oracle 2: raw int64 through the host-validating wrapper
    r_out, r_ok = (_np(x) for x in range_aggregate_cumsum(
        m.ts, torch.from_numpy(m.values).to(dev), m.lengths, EPOCH + 60_000,
        30_000, 60_000, op="avg_over_time", nsteps=8))
    np.testing.assert_array_equal(r_ok, w_ok)
    np.testing.assert_allclose(r_out[r_ok], w_out[w_ok], rtol=1e-4)
    # numpy brute force: windows (end-60s, end] per series, plain averages
    ends = EPOCH + 60_000 + np.arange(8) * 30_000
    for s in range(0, S, 7):
        ss, vv = wts[sids == s], wvals[sids == s]
        for j, e in enumerate(ends):
            inw = (ss > e - 60_000) & (ss <= e)
            if inw.any():
                assert ok[s, j], (s, j)
                np.testing.assert_allclose(out[s, j], vv[inw].mean(),
                                           rtol=1e-4)
            else:
                assert not ok[s, j], (s, j)

    # --- time-blocked window reduce with a point-to-point halo ---
    grid = rng.random((4, 8 * max(1, mesh.shape["block"]))).astype(
        np.float32)
    win = 3
    blocked = _np(time_blocked_window_sum(grid, window=win, mesh=mesh))
    for t in range(grid.shape[1]):
        want_col = grid[:, max(0, t - win + 1):t + 1].sum(axis=1)
        np.testing.assert_allclose(blocked[:, t], want_col, rtol=1e-4,
                                   atol=1e-5)
    return {"shape": dict(mesh.shape), "device": str(dev),
            "aggregate_rows": n, "series": S, "grid": list(grid.shape)}


def _dryrun_distributed_query(n_datanodes: int, device: str) -> int:
    """DDL, split inserts and an aggregate pushed down to N in-process
    datanodes (meta routes and region placement), the reference's
    MockDistributedInstance topology. Returns the rows checked."""
    from ..client import LocalDatanodeClient
    from ..datanode import DatanodeInstance, DatanodeOptions
    from ..frontend.distributed import DistInstance
    from ..meta import MemKv, MetaClient, MetaSrv, Peer

    n_datanodes = max(2, n_datanodes)
    tmp = tempfile.mkdtemp(prefix="multichip_dryrun_")
    datanodes, clients = {}, {}
    srv = MetaSrv(MemKv())
    meta = MetaClient(srv)
    fe = None
    try:
        for i in range(1, n_datanodes + 1):
            dn = DatanodeInstance(DatanodeOptions(
                data_home=f"{tmp}/dn{i}", node_id=i, device=device,
                register_numbers_table=False))
            dn.start()
            datanodes[i] = dn
            clients[i] = LocalDatanodeClient(dn)
            srv.register_datanode(Peer(i, f"dn{i}"))
            srv.handle_heartbeat(i)
        fe = DistInstance(meta, clients, device=device)
        fe.do_query("""
            CREATE TABLE dist (host STRING, ts TIMESTAMP TIME INDEX,
                               cpu DOUBLE, PRIMARY KEY(host))
            PARTITION BY RANGE COLUMNS (host) (
              PARTITION r0 VALUES LESS THAN ('h4'),
              PARTITION r1 VALUES LESS THAN ('h8'),
              PARTITION r2 VALUES LESS THAN (MAXVALUE))""")
        vals = ", ".join(f"('h{h}', {i * 1000}, {float(h * 10 + i)})"
                         for h in range(12) for i in range(8))
        fe.do_query(f"INSERT INTO dist VALUES {vals}")
        out = fe.do_query("SELECT host, avg(cpu) AS a, count(*) AS c "
                          "FROM dist GROUP BY host ORDER BY host")[-1]
        rows = out.batches[0].to_pylist()
        assert len(rows) == 12, rows
        for r in rows:
            h = int(r["host"][1:])
            assert r["c"] == 8
            assert math.isclose(r["a"], h * 10 + 3.5, rel_tol=1e-5), r
        route = srv.table_route("greptime.public.dist")
        assert len({rr.leader.id for rr in route.region_routes}) >= 2, \
            "regions not spread across datanodes"
        return len(rows)
    finally:
        if fe is not None:
            fe.shutdown()
        for dn in datanodes.values():
            dn.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The four checks over an n-rank mesh (see the module's docstring).
    Returns what ran: the mesh's shape and device, and the distributed
    query's rows."""
    import torch.distributed as dist

    from ..parallel import make_mesh
    from ..parallel.launch import run_ranks
    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA is not available (pass "
                           "device='cpu' for gloo ranks)")
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        mesh = make_mesh(device=device)
        info = _dryrun_impl(mesh)
        if mesh.rank != 0:
            return info
    elif n_devices == 1:
        info = _dryrun_impl(make_mesh(device=device))
    else:
        info = run_ranks(n_devices, _dryrun_impl, None, device=device)
    info["distributed_query_rows"] = _dryrun_distributed_query(n_devices,
                                                               device)
    print(f"dryrun_multichip: OK on {info['shape']} mesh ({n_devices} "
          f"ranks, {info['device']})", flush=True)
    return info


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="mesh size (default: the GPU count on 'cuda', 8 "
                    "on 'cpu')")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    avg_cpu, max_mem, cnt, counts = fn(*ex)
    if args.device == "cuda":
        torch.cuda.synchronize()
    print(f"entry: ran on {args.device}: {int(counts.sum())} rows in "
          f"{NUM_GROUPS} groups", flush=True)
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                       else 8)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
