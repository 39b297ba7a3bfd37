"""Race hammer: the port's concurrent paths under its race detector.

    GREPTIME_RACE_CHECK=1 python3 -m greptimedb_tpu_torch.tools.race_hammer
        [--device cpu|cuda] [--seconds S]

The twin of the JAX package's hammer (tests/test_greptsan.py
`TestHammer`): concurrent ingest, flush, compaction, distributed
scatter, balancer ticks and self-monitor scrapes over an in-process
cluster of two datanodes on one shared object store (meta in process,
a DistInstance over LocalDatanodeClients), for `--seconds`. The port's
own concurrent paths ride along:

- the scatter's aggregates push down to the datanodes, whose regions
  take the device-resident route (the scan cache, fused concurrent
  scans through SCAN_FLIGHTS, `segment_moments`) or, while the stream
  thread has the streaming threshold lowered, the streamed cold route
  with `cold_reduce="device"` (mirrors staged on a side stream, one
  `segment_moments` launch per slice);
- a PromQL range query (TQL EVAL of rate()) scans the table over the
  wire and counts its windows with K1 (`counts_leq_grid`).

First the hammer plants one race of its own, two threads writing one
tracked dict with no lock, so that a detector that is dead cannot pass.
The last line of the output is one JSON object: the races seen in the
workload, those the suppression baseline does not cover, the tracked
accesses recorded, whether the seeded race was reported, and kernel
launches by kernel (0 on the CPU, where the wrappers run their plain
versions). Exit code 1 on any unsuppressed race, a seeded race that
went unreported, a workload thread's error or no tracked access; 2 when
the detector is off. Runs on "cuda" unless asked for the CPU, and
raises without CUDA.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List

logger = logging.getLogger(__name__)

#: the structure of the seeded race
SEEDED = "tools.race_hammer.seeded"
#: the streaming threshold while the stream thread has it lowered: every
#: region past it takes the streamed cold route
COLD_ROWS = 256
DDL = ("CREATE TABLE hammer (host STRING, ts TIMESTAMP TIME INDEX, "
       "v DOUBLE, PRIMARY KEY(host)) PARTITION BY HASH (host) PARTITIONS 4")
ROWS_PER_INSERT = 50
HOSTS = 8


def seed_race() -> bool:
    """Two threads write one tracked dict with no common lock; True when
    the detector reported it."""
    from ..common.runtime import new_thread
    from ..common.tracking import tracked_state
    from ..devtools.greptsan import detector

    shared = tracked_state({}, SEEDED)
    barrier = threading.Barrier(2)

    def bump() -> None:
        barrier.wait()
        for _ in range(50):
            shared["n"] = shared.get("n", 0) + 1

    ts = [new_thread(bump, name=f"hammer-seed-{i}", daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return any(r.state == SEEDED for r in detector.drain_races())


class Cluster:
    """Meta, two datanodes over one shared object store, and a
    DistInstance over LocalDatanodeClients."""

    def __init__(self, root: str, device: str, nodes=(1, 2)) -> None:
        from ..client import LocalDatanodeClient
        from ..datanode.instance import DatanodeInstance, DatanodeOptions
        from ..frontend.distributed import DistInstance
        from ..meta import MetaClient, MetaSrv, Peer
        from ..meta.kv import MemKv
        from ..storage.object_store import FsObjectStore

        self.shared = FsObjectStore(os.path.join(root, "shared_store"))
        self.srv = MetaSrv(MemKv(), datanode_lease_secs=3600.0)
        self.srv.balancer.resend_interval_s = 0.0
        self.meta = MetaClient(self.srv)
        self.datanodes: Dict[int, object] = {}
        self.clients: Dict[int, object] = {}
        for i in nodes:
            dn = DatanodeInstance(DatanodeOptions(
                data_home=os.path.join(root, f"dn{i}"), node_id=i,
                register_numbers_table=False, flow_tick_interval_s=0,
                self_monitor_interval_s=0, device=device),
                store=self.shared)
            dn.start()
            dn.attach_meta(self.meta)
            self.datanodes[i] = dn
            self.clients[i] = LocalDatanodeClient(dn)
            self.srv.register_datanode(Peer(i, f"dn{i}"))
            self.srv.handle_heartbeat(i)
        self.fe = DistInstance(self.meta, self.clients, device=device)

    def shutdown(self) -> None:
        self.fe.shutdown()
        for dn in self.datanodes.values():
            dn.shutdown()


def _launch_counts() -> Dict[str, int]:
    from ..ops import kernels, pallas_window
    return {"counts_leq": pallas_window.counts_leq.launches,
            "counts_leq_grid": pallas_window.counts_leq_grid.launches,
            "segment_moments": kernels.segment_moments.launches,
            "grouped_moments": kernels.grouped_moments.launches}


def _reset_launch_counts() -> None:
    from ..ops import kernels, pallas_window
    pallas_window.counts_leq.launches = 0
    pallas_window.counts_leq_grid.launches = 0
    kernels.segment_moments.launches = 0
    kernels.grouped_moments.launches = 0


def hammer(c: Cluster, seconds: float) -> List[BaseException]:
    """The workload's threads for `seconds`; the errors they raised."""
    from ..common.runtime import new_thread
    from ..query import stream_exec

    stop = threading.Event()
    errors: List[BaseException] = []
    t0_ms = 1_700_000_000_000

    def guard(fn: Callable[[], None]) -> Callable[[], None]:
        def run() -> None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the run's verdict
                logger.exception("race_hammer: %s raised", fn.__name__)
                errors.append(e)
                stop.set()
        return run

    def ingest() -> None:
        i = 0
        while not stop.is_set():
            vals = ", ".join(
                f"('h{j % HOSTS}', {t0_ms + (i * ROWS_PER_INSERT + j) * 1000}"
                f", {float(j)})" for j in range(ROWS_PER_INSERT))
            c.fe.do_query(f"INSERT INTO hammer VALUES {vals}")
            i += 1

    def scatter() -> None:
        while not stop.is_set():
            c.fe.do_query("SELECT host, count(*), max(v), avg(v) FROM "
                          "hammer GROUP BY host")
            c.fe.do_query("SELECT count(*) FROM hammer WHERE host = 'h3'")

    def promql() -> None:
        lo = t0_ms // 1000
        while not stop.is_set():
            c.fe.do_query(f"TQL EVAL ({lo}, {lo + 600}, '15s') "
                          f"rate(hammer[1m])")

    def stream() -> None:
        default = stream_exec.stream_threshold_rows()
        try:
            while not stop.is_set():
                stream_exec.configure_streaming(threshold_rows=COLD_ROWS)
                stop.wait(0.2)
                stream_exec.configure_streaming(threshold_rows=default)
                stop.wait(0.1)
        finally:
            stream_exec.configure_streaming(threshold_rows=default)

    def flush_compact() -> None:
        while not stop.is_set():
            for dn in list(c.datanodes.values()):
                for region in dn.storage.list_regions().values():
                    region.flush()
                    region.schedule_compaction()
            stop.wait(0.01)

    def balancer_pump() -> None:
        while not stop.is_set():
            c.srv.balancer.tick()
            for i in list(c.datanodes):
                resp = c.srv.handle_heartbeat(i)
                for msg in resp.mailbox:
                    c.datanodes[i]._handle_mailbox(msg)
            c.srv.cluster_info()
            c.srv.region_heat()
            stop.wait(0.005)

    def monitor() -> None:
        while not stop.is_set():
            c.fe.self_monitor.tick()
            stop.wait(0.02)

    ts = [new_thread(guard(f), name=f"hammer-{f.__name__}", daemon=True)
          for f in (ingest, scatter, promql, stream, flush_compact,
                    balancer_pump, monitor)]
    for t in ts:
        t.start()
    stop.wait(seconds)
    stop.set()
    for t in ts:
        t.join(timeout=120)
    errors.extend(RuntimeError(f"{t.name} still running after 120 s")
                  for t in ts if t.is_alive())
    return errors


def run(device: str = "cuda", seconds: float = 5.0) -> dict:
    """Seed the planted race, then hammer a fresh cluster; the summary
    the last line prints."""
    from ..devtools.greptsan import detector
    from ..query import stream_exec

    if not detector.enabled():
        raise RuntimeError("the race detector is off: set "
                           "GREPTIME_RACE_CHECK=1 before the port is "
                           "imported")
    t_start = time.perf_counter()
    detector.reset()
    seeded = seed_race()
    root = tempfile.mkdtemp(prefix="race-hammer-")
    c = None
    try:
        c = Cluster(root, device)
        c.fe.do_query(DDL)
        detector.drain_races()
        detector.new_generation()
        stream_exec.configure_streaming(cold_reduce="device")
        _reset_launch_counts()
        errors = hammer(c, seconds)
        launches = _launch_counts()
    finally:
        stream_exec.configure_streaming(cold_reduce="host")
        if c is not None:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    reports = detector.drain_races()
    fresh = detector.unsuppressed(reports)
    for r in fresh:
        print(r.render(), file=sys.stderr)
    acc = detector.accesses()
    return {"device": device, "seconds": seconds,
            "wall_s": time.perf_counter() - t_start,
            "races": len(reports), "unsuppressed": len(fresh),
            "seeded_reported": seeded,
            "accesses": sum(acc.values()) - acc.get(SEEDED, 0),
            "states": sorted(k for k in acc if k != SEEDED),
            "errors": [repr(e) for e in errors], "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    # the detector decides at import: set it before any port module loads
    os.environ.setdefault("GREPTIME_RACE_CHECK", "1")
    from ..devtools.greptsan import detector
    if not detector.enabled():
        print("race_hammer: GREPTIME_RACE_CHECK is set to a false value; "
              "the hammer needs the race detector on", file=sys.stderr)
        return 2
    out = run(args.device, args.seconds)
    print(json.dumps(out), flush=True)
    ok = out["seeded_reported"] and not out["unsuppressed"] and \
        not out["errors"] and out["accesses"] > 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
