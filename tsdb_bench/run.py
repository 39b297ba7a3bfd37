"""The benchmark's harness: one run of one cell.

    python -m tsdb_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration file (`configs/<name>.json`), its traffic mix
(`mixes/<traffic>.json`, read by `traffic.py`) and one reader for each
metric (`metrics/<metric>.py`, a function `read(window)`). A run:

1. set-up (timed as `setup_s`, from the process's start): the client
   processes start; the table's values are made on the device from the
   seed; the configuration's `query` options are applied as the
   standalone applies its `[query]` section; `build_standalone` opens the
   program on a data home under TMPDIR; CREATE TABLE and
   `handle_bulk_load` write the table and its compactions are waited out;
   the harness drops its own copy of the values; the Flight server
   starts; the writer, if the mix has one, sends its first batch; one
   statement of every type goes over Flight (the first fills the scan
   cache);
2. the window: every client sends from t0 to t1 in a closed loop; the
   program's scan fusion counters are read at both ends, and with
   `--trace 1` the profiler and a span tee run over it;
3. after the window: the clients' records come back, the device's peak
   memory is read, the program is shut down and its data home removed;
   the metrics are read; the sampled answers are held against the plain
   reference (`reference.py`), with the table and every acknowledged
   batch made again from the seed.

The command's process keeps to all but the last two of the CPUs it may
use, and the clients to those two, so that the clients do not take the
server's cores.

The last line of standard output is the result, as JSON; the numbers
compared for `correct` are also the last lines of standard error. A
machine without CUDA, or with fewer cards than the cell asks for, gets
no result and the exit code 3; a process that holds JAX or the JAX
package after the window, the exit code 4.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import traffic, tsbs

FORBIDDEN = ("jax", "jaxlib", "flax", "greptimedb_tpu")
#: the limits of the numbers compared for `correct` (PERF.md gives the
#: readings each was set from)
LIMITS = {"failed": 0, "exact_mismatches": 0, "avg_err_over_bound": 100.0}
MIN_COMPARED = 5
#: the program's counters that a run reads at the window's ends
COUNTERS = ("scan_fusion_leader", "scan_fusion_follower")
#: how long the clients may take, after the window, to finish what is in
#: flight and hand their records back
DRAIN_S = 120.0


def bench_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and the
    metric entries that it reports."""

    def __init__(self, root: str, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.root = root
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = traffic.load_json(root, conf["file"])
        self.mix = traffic.load_mix(root, self.entry["traffic"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def metric_reader(root: str, name: str) -> Callable:
    path = os.path.join(root, "tsdb_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"tsdb_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    """What the metric readers read: the window's bounds, the clients'
    records, the program's spans (traced runs), the device trace (traced
    runs) and the cell's configuration and mix."""

    def __init__(self, t0, t1, setup_s, records, batches, spans, device,
                 cfg, mix, counters=None):
        self.t0, self.t1, self.seconds = t0, t1, t1 - t0
        self.setup_s = setup_s
        self.records = records
        #: statements answered without error whose answer came inside
        #: the window
        self.done = [r for r in records if r["error"] is None and
                     t0 <= r["recv"] <= t1]
        self.batches = batches
        #: (name, start, end) of every span the program closed while the
        #: tee was on (traced runs), else None
        self.spans = spans
        self.device = device
        #: growth of the program's counters (`COUNTERS`) from the window's
        #: start until the clients had drained
        self.counters = counters or {}
        self.cfg, self.mix = cfg, mix

    def share(self, a: float, b: float) -> float:
        """Seconds of [a, b] inside the window."""
        return max(0.0, min(b, self.t1) - max(a, self.t0))

    def prorated(self, items, start: str, end: str) -> float:
        """How many of `items` (records without error) the window holds:
        each counts by the share of its own time that lies inside it, so
        that a statement in flight at either end counts in part."""
        n = 0.0
        for r in items:
            if r["error"] is None and r[end] > r[start]:
                n += self.share(r[start], r[end]) / (r[end] - r[start])
        return n

    def span_seconds(self, name: str) -> float:
        """Seconds of the spans called `name` inside the window, summed
        over threads."""
        return sum(self.share(a, b) for n, a, b in self.spans if n == name)

    def client_seconds(self) -> float:
        """Seconds of the statements' client walls inside the window."""
        return sum(self.share(r["send"], r["recv"]) for r in self.records
                   if r["error"] is None)


def split_cpus() -> Tuple[Optional[List[int]], Optional[List[int]]]:
    """(the server's CPUs, the clients' CPUs): the last two of the CPUs
    this process may use go to the clients, where there are eight or
    more; (None, None) where there are fewer."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 8:
        return None, None
    return cpus[:-2], cpus[-2:]


def counter_values() -> Dict[str, float]:
    """The program's counters of `COUNTERS`, as they stand."""
    from greptimedb_tpu_torch.common import telemetry
    reg = telemetry.registry()
    return {c: (reg.get_sample_value(f"greptime_{c}_total") or 0.0)
            if reg is not None else 0.0 for c in COUNTERS}


def spawn_clients(root: str, work: str, n: int) -> List[subprocess.Popen]:
    procs = []
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for i in range(n):
        err = open(os.path.join(work, f"client{i}.err"), "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tsdb_bench.client"], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            env=env))
        err.close()
    return procs


def apply_query_options(opts: dict) -> None:
    """A configuration's `query` options, as the standalone applies its
    `[query]` section (`cmd/main.py` `build_servers`); the one that a
    configuration states is the scan cache's budget."""
    unknown = set(opts) - {"scan_cache_budget_mb"}
    if unknown:
        raise ValueError(f"unknown query options {sorted(unknown)}")
    if "scan_cache_budget_mb" in opts:
        from greptimedb_tpu_torch.query.tpu_exec import SCAN_CACHE
        SCAN_CACHE.configure(
            budget_bytes=int(opts["scan_cache_budget_mb"]) << 20)


def client_error(work: str, i: int) -> str:
    with open(os.path.join(work, f"client{i}.err"), "rb") as f:
        return f.read()[-2000:].decode(errors="replace")


def wait_ready(work: str, procs) -> None:
    for i, p in enumerate(procs):
        line = p.stdout.readline()
        if line.strip() != b"ready":
            raise RuntimeError(f"client {i} did not start: {line!r}\n"
                               f"{client_error(work, i)}")


def tree_bytes(path: str) -> int:
    """Bytes of the files under `path` (the data home the program wrote)."""
    total = 0
    for d, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return total


def load_table(fe, cfg: dict, ts, tags, vals) -> int:
    """The table's rows into its regions' SSTs. One region: the
    frontend's `handle_bulk_load`. Several: the rows of each region's
    hosts by `MitoTable.write_region(..., op="bulk")`, as the distributed
    frontend routes a bulk load, each host's region found by the table's
    own rule (`handle_bulk_load` would evaluate the rule row by row)."""
    import numpy as np
    from greptimedb_tpu_torch.partition import split_rows

    from . import datagen
    if cfg.get("regions", 1) == 1:
        cols = datagen.load_columns(ts, tags, vals, cfg["fields"],
                                    tsbs.TSBS_TAGS)
        return fe.handle_bulk_load(cfg["table"], cols,
                                   tag_columns=tsbs.TSBS_TAGS,
                                   timestamp_column="ts")
    table = fe.catalog.table("greptime", "public", cfg["table"])
    names = np.asarray([tg[0] for tg in tags], dtype=object)
    loaded = 0
    for rn, hosts in sorted(split_rows(table.partition_rule,
                                       {"hostname": names},
                                       len(names)).items()):
        cols = datagen.load_columns(ts, [tags[h] for h in hosts],
                                    vals[:, :, hosts], cfg["fields"],
                                    tsbs.TSBS_TAGS)
        loaded += table.write_region(rn, cols, op="bulk")
    return loaded


def live_values(seed: int, vals, acked: int):
    """The table's values followed by the writer's `acked` batches,
    [fields, n + acked, hosts]."""
    import numpy as np
    if acked == 0:
        return vals
    walk = tsbs.LiveWalk(seed, {i: vals[i, -1] for i in range(len(vals))})
    extra = np.empty((vals.shape[0], acked, vals.shape[2]))
    for k in range(acked):
        step = walk.next()
        for i in range(len(vals)):
            extra[i, k] = step[i]
    return np.concatenate([vals, extra], axis=1)


def check_answers(cell: Cell, seed: int, outs: List[dict], acked: int,
                  device: str) -> dict:
    """The sampled answers against the plain reference, over the table's
    values made again from the seed."""
    from . import datagen, reference
    cfg = cell.cfg
    _, vals = datagen.table_arrays(seed, cfg, device)
    data = reference.Data(live_values(seed, vals, acked), cfg["fields"],
                          cfg["start_ms"], cfg["interval_ms"])
    worst, mism, compared = 0.0, 0.0, 0
    for out in outs:
        if out["role"] != "reader":
            continue
        by_index = {r["stmt"]["index"]: r["stmt"] for r in out["records"]}
        for idx, got in sorted(out["answers"].items()):
            stmt = by_index[idx]
            c = reference.compare(got, reference.answer(data, stmt),
                                  stmt["agg"])
            if c["mismatches"] or c["worst"] > LIMITS["avg_err_over_bound"]:
                log(f"answer of reader {out['reader']} statement {idx} "
                    f"({stmt['type']}, [{stmt['a']}, {stmt['b']}), acked "
                    f"{stmt['acked']}): {c}")
            worst = max(worst, c["worst"])
            mism += c["mismatches"]
            compared += 1
    return {"worst": worst, "mismatches": mism, "compared": compared}


def run_cell(root: str, cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             prepare: Optional[Callable] = None,
             client_cpus: Optional[List[int]] = None) -> dict:
    """One run; returns the result object. `prepare(fe)`, if given, runs
    after the set-up and before the window (the tests plant faults with
    it); `client_cpus`, if given, are the CPUs the clients keep to."""
    t_start = time.monotonic() if t_start is None else t_start
    import numpy as np
    import torch
    from greptimedb_tpu_torch.client.flight import Database
    from greptimedb_tpu_torch.datanode import DatanodeOptions
    from greptimedb_tpu_torch.frontend.instance import build_standalone
    from greptimedb_tpu_torch.servers.grpc import GrpcServer

    from . import datagen, devtrace
    from .client import AckFile, wait_until

    cfg, mix = cell.cfg, cell.mix
    writer = bool(mix.get("writer"))
    n_clients = mix["readers"] + int(writer)
    stages: Dict[str, float] = {}
    mark = [time.monotonic()]

    def stage(name: str) -> None:
        now = time.monotonic()
        stages[name] = round(now - mark[0], 3)
        mark[0] = now

    work = tempfile.mkdtemp(prefix="tsdb_bench-")
    procs = spawn_clients(root, work, n_clients)
    fe = srv = rec = None
    cuda = device.startswith("cuda")
    try:
        ts, vals = datagen.table_arrays(seed, cfg, device)
        tags = tsbs.host_tags(seed, cfg["hosts"])
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        stage("values")
        apply_query_options(cfg.get("query", {}))
        fe = build_standalone(DatanodeOptions(
            data_home=os.path.join(work, "data"), device=device,
            **cfg["datanode"]))
        regions = cfg.get("regions", 1)
        partition = tsbs.range_partition(cfg["hosts"], regions) \
            if regions > 1 else ""
        fe.do_query(tsbs.sql_ddl(cfg["table"],
                                 {f: "DOUBLE" for f in cfg["fields"]},
                                 partition))
        stage("open")
        loaded = load_table(fe, cfg, ts, tags, vals)
        if loaded != vals.shape[1] * vals.shape[2]:
            raise RuntimeError(f"the load wrote {loaded} rows")
        stage("load")
        fe.datanode.storage.scheduler.wait_idle(timeout=600)
        stage("compaction")
        srv = GrpcServer(fe, addr="127.0.0.1:0")
        srv.start()
        address = f"grpc://127.0.0.1:{srv.port}"
        ack_file = os.path.join(work, "acked")
        AckFile(ack_file, create=True).close()
        for i, p in enumerate(procs):
            spec = {"role": "writer" if writer and i == 0 else "reader",
                    "reader": i - int(writer), "address": address,
                    "seed": seed, "mix": mix, "config": cfg,
                    "ack_file": ack_file, "cpus": client_cpus}
            if spec["role"] == "writer":
                spec["last"] = {f: vals[k, -1].tolist()
                                for k, f in enumerate(cfg["fields"])}
            p.stdin.write((json.dumps(spec) + "\n").encode())
            p.stdin.flush()
        # the reference makes the values again from the seed, so that
        # nothing the program did to the arrays it was handed reaches it
        del ts, vals, tags
        gc.collect()
        wait_ready(work, procs)
        stage("clients")
        ack = AckFile(ack_file)
        db = Database(address)
        for st in traffic.warm_statements(mix, cfg, seed, ack.read()):
            db.sql(traffic.sql(st, cfg["table"]))
        db.close()
        ack.close()
        stage("warm")
        if prepare is not None:
            prepare(fe)
        if trace:
            rec = devtrace.Recorder(work)
            rec.start()
        before = counter_values()
        t0 = time.monotonic() + 0.5
        t1 = t0 + seconds
        for p in procs:
            p.stdin.write(f"go {t0!r} {t1!r}\n".encode())
            p.stdin.flush()
        setup_s = t0 - t_start
        wait_until(t1)
        outs = []
        for i, p in enumerate(procs):
            try:
                outs.append(pickle.load(p.stdout))
            except EOFError:
                raise RuntimeError(f"client {i} failed:\n"
                                   f"{client_error(work, i)}") from None
            p.wait(timeout=DRAIN_S)
        after = counter_values()
        # the tee stays on until the clients have drained, so that a span
        # open at the window's end is kept
        dev = rec.stop(t0, t1) if rec is not None else None
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        written = tree_bytes(os.path.join(work, "data"))
        srv.shutdown()
        srv = None
        fe.shutdown()
        fe = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        if rec is not None:
            rec.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if srv is not None:
            srv.shutdown()
        if fe is not None:
            fe.shutdown()
        shutil.rmtree(work, ignore_errors=True)

    records = [r for o in outs if o["role"] == "reader"
               for r in o["records"]]
    batches = [r for o in outs if o["role"] == "writer"
               for r in o["records"]]
    acked = max([o["acked"] for o in outs if o["role"] == "writer"],
                default=0)
    win = Window(t0, t1, setup_s, records, batches,
                 dev.spans if dev is not None else None, dev, cfg, mix,
                 {c: after[c] - before[c] for c in COUNTERS})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(cell.root, m["name"])(win)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    sent = [r for r in records if t0 <= r["send"] < t1]
    sent_b = [b for b in batches if t0 <= b["send"] < t1]
    errors = [r for r in records if r["error"] is not None] + \
        [b for b in batches if b["error"] is not None]
    for e in errors[:5]:
        log(f"failed: {e.get('stmt', {}).get('type', 'batch')}: "
            f"{e['error']}")
    got = check_answers(cell, seed, outs, acked, device)
    checks = {
        "failed": {"value": len(errors), "limit": LIMITS["failed"],
                   "must_be": "<="},
        "exact_mismatches": {"value": got["mismatches"],
                             "limit": LIMITS["exact_mismatches"],
                             "must_be": "<="},
        "avg_err_over_bound": {"value": got["worst"],
                               "limit": LIMITS["avg_err_over_bound"],
                               "must_be": "<="},
        "answers_compared": {"value": got["compared"],
                             "limit": MIN_COMPARED, "must_be": ">="},
    }
    correct = all(c["value"] <= c["limit"] if c["must_be"] == "<=" else
                  c["value"] >= c["limit"] for c in checks.values())
    by_type: Dict[str, list] = {}
    for r in win.done:
        by_type.setdefault(r["stmt"]["type"], []).append(r["recv"] -
                                                         r["send"])
    log("run: " + json.dumps({
        "cell": cell.name, "seed": seed, "seconds": seconds,
        "stages_s": stages, "setup_s": setup_s,
        "statements": {t: [len(v), float(np.mean(v))]
                       for t, v in sorted(by_type.items())},
        "batches_in_window": len(sent_b), "acked": acked,
        "counters": win.counters,
        "data_home_bytes": written,
        "busy_s": dev.busy_s if dev is not None else None}))
    result = {"correct": bool(correct),
              "attempted": len(sent) + len(sent_b),
              "failed": len([r for r in sent + sent_b
                             if r["error"] is not None]),
              "metrics": metrics,
              "device": device_info(torch, cuda, peak, dev)}
    if dev is not None:
        result["breakdown"] = dev.breakdown()
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']} {c['must_be']} {c['limit']}")
    return result


def device_info(torch, cuda: bool, peak: int, dev) -> dict:
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": peak}
    if dev is not None:
        info["busy_s"] = dev.busy_s
        info["window_s"] = dev.window_s
    return info


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tsdb_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = bench_root()
    if importlib.util.find_spec("greptimedb_tpu_torch") is None:
        log("greptimedb_tpu_torch is not in this checkout")
        return 2
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = Cell(root, bench, args.workload)
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    server_cpus, client_cpus = split_cpus()
    if server_cpus is not None:
        os.sched_setaffinity(0, server_cpus)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(root, cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start, client_cpus=client_cpus)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds {bad} after the window")
        return 4
    print(json.dumps(result), flush=True)
    return 0
