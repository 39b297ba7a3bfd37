#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (greptimedb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--phases LIST]

Phases (none of them catches a failure; any failed check exits non-zero).
With no `--phases` every phase runs; `--phases 12` (a comma-separated
list) runs the phases named and those they stand on (phases 1 and 2
always; 12 needs 5, 6 and 7, and runs 12b only with 9), and names them
in its last two lines:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and whether pandas, pyarrow, prometheus_client, aiohttp (phase 11's
   server) and cryptography import here;
2. builds both kernels from greptimedb_tpu_torch/csrc, the window-bounds
   kernel and the segment-moments kernel, one nvcc (sm_90a) each, started
   together, into the package's git-ignored build directory, and prints
   ptxas's registers, shared memory and spills;
3. holds both entries of the kernel, counts_leq (buckets in) and
   counts_leq_grid (timestamps in, bucketed in its loads), against their
   plain PyTorch versions (exact int32 equality) at the reference's test
   shapes, unsorted rows, one-bin and all-pad rows, unaligned and ragged
   rows, step grids wider than 48 KB of bins and than a shared-memory
   tile, bucketing edge cases of the fused entry, and the main-path
   shape; times both entries, the unfused step_buckets + counts_leq path,
   the plain versions and the one-call yardstick torch.searchsorted with
   CUDA events around back-to-back calls, and both entries again on a
   30-day grid at a 1 h step, where the fused entry divides in 64 bits;
4. serves PromQL range queries through PromqlEngine.query_to_prom_json on
   the GPU over the TSBS cpu-only devops data set (4000 hosts, 10 s
   interval, 24 h), with each window-bounds launch's device time, wrapper
   host time and SM clock; splits one query's device eval + fetch into
   the engine's stages, checks 64 sampled series at every step against a
   float64 numpy brute force, and runs the gather-path functions at a
   reduced size;
5. holds the segment-moments kernel against its plain PyTorch version at
   the reference's test shapes (tests/test_kernels.py) and at the edges
   of its design (empty, single-row and block-edge runs, all rows masked,
   one run of 5 M rows, 2.88 M runs of 6 rows, columns and masks that are
   not 16-byte aligned, dead row tiles beside live ones, runs ending on
   tile edges and one row past the one-run-per-lane limit, 10 and 11
   distinct column masks, 33 moments and none), float32 and int32 columns, column nulls, unsorted ts with ties;
   two launches bit-equal (the cases are
   greptimedb_tpu_torch/tools/segment_moments_bench.py's `edge_cases`);
6. serves SQL on the GPU through the port's standalone frontend:
   build_standalone(DatanodeOptions(data_home=<temporary>, device="cuda"))
   and FrontendInstance.do_query. CREATE TABLE cpu (TSBS cpu-only: 4000
   hosts, 10 tags, 10 fields, 10 s, 12 h: 17.28 M rows), the load by
   handle_bulk_load (MitoTable.bulk_load → Region.bulk_ingest: Parquet
   SSTs + manifest; its background compaction waited out), then the
   write path: overwrites and a new key by handle_row_insert, ADMIN FLUSH
   TABLE and ADMIN COMPACT TABLE, an overwrite by INSERT and a delete of
   that new key by MitoTable.delete (where a SQL DELETE ends), left in
   the memtable; prints the ingest profile and the SSTs. Four TSBS queries and two that reach every op, each cold (scan
   cache empty: the SSTs decoded and merged with the memtable) and warm,
   with the wall, what do_query adds beyond QueryEngine.execute, the
   dispatch decision, the engine's stages, the kernel's device time and
   peak device memory (the launch fenced behind a spin kernel), then warm
   again unfenced; Q3 and Q4 (8 hosts) take the SST index cold
   (indexed-point, no launch), and a whole-table query fills the cache
   before their warm runs; checks every group against a float64 brute
   force with the same edits (planted wrong answers must fail its
   bounds). Then `SET stream_threshold_rows` streams the table: Q1 and Q5
   with the streamed path's device reduction (one launch per slice),
   equal to the resident frames. Then shutdown() with
   the last batch unflushed, build_standalone on the same data home
   (catalog replay, table open, WAL replay) timed, and Q5 again, which
   must equal the frame before the shutdown bit for bit; a small
   handle_row_insert and Q5 again over the scan cache's incremental
   merge, bit-equal to Q5 over a full rebuild. Then a table
   range-partitioned on hostname into 4 regions (400 hosts, 1.728 M rows),
   a SQL INSERT and DELETE on it, and Q1, Q5, Q6 and Q5's moments per
   hour with one launch per region, merged across regions (Q6 and the
   hourly moments fold every group from all four regions) and checked
   against the brute force; 8 threads then run the same cold Q5 on it at
   once, fused into one pass per region (4 launches, equal frames).
   Then a table of TINYINT / SMALLINT / INT UNSIGNED / SMALLINT UNSIGNED
   fields: count, sum, min, max, first_value and last_value by host and
   over the whole table, exactly against numpy with sums wrapped to each
   type. Then times the kernel at the Q1, Q4 and Q6 inputs against its
   plain version and torch.segment_reduce (bound and yardstick from the
   timing tool, whose own Q1/Q4/Q6 inputs must match these).
7. the streamed cold path: table cpu_24h, TSBS cpu-only at 24 h (4000
   hosts x 8640 samples = 34.56 M rows) by one handle_bulk_load; its
   estimated decoded size is over half the scan-cache budget, so it
   streams (the byte rule) and never enters the cache. Q1-Q6 with TSBS's
   spans, each cold in the default "host" mode (Q3 and Q4: indexed-point),
   Q1, Q5 and Q6 again in "device" mode, one segment_moments launch per
   non-empty slice: the dispatch decision, stages, slice counters,
   launches and peak device memory of each, every answer against the
   float64 brute force; stream_device_stage_errors must read 0.
8. the rest of the SQL surface, on the same frontend and tables, with
   segment_moments' launch count set to 0 before and read after: EXPLAIN of
   Q1 on cpu (its TpuAggregateExec and Dispatch lines) and EXPLAIN ANALYZE
   of Q1 cold (one launch, the plan row first, its dispatch line the one
   the statement ran); approx_distinct, approx_percentile(p95) and median
   over the first hour by region on cpu (resident host partials), cpu_24h
   (streamed) and cpu_p (4 regions folded), each against numpy (distinct
   counts within 3 HyperLogLog standard errors, percentiles at their rank
   within 1 %); count(DISTINCT hostname) by region, exact (the raw-row
   path); SET exact_distinct refused (it waits for the distributed
   frontend); avg(usage_user + usage_system) and sum(usage_user * 2) by
   host on cpu and cpu_24h within 8 eps64 sum|x| of exact sums; rank() over
   avg by host (the CPU fallback, as in the reference), exact ranks; SHOW
   TABLES, DESCRIBE TABLE, SHOW CREATE TABLE and information_schema.columns
   against the TSBS DDL; the 32 non-TQL in-scope standalone sqlness goldens
   through greptimedb_tpu_torch/tools/sqlness.py on the card, byte-equal to
   their .result files (the 4 tql/* cases run in phase 9), launching
   segment_moments only in flow/create_flow's two refresh folds. The phase
   launches segment_moments three times (EXPLAIN ANALYZE and the two
   folds). Each statement's wall is printed.
9. PromQL over the port's own regions: phase 6-8's frontend shut down,
   build_standalone(DatanodeOptions(data_home=<temporary>, device="cuda"))
   again, tables cpu_usage_user and cpu_seconds_total in GreptimeDB's
   Prometheus remote-write layout (hostname, region, datacenter as the
   primary key, greptime_timestamp, greptime_value), each loaded with
   phase 4's series (4000 hosts x 8640 samples = 34.56 M rows, 24 h) by
   handle_bulk_load, then ADMIN FLUSH TABLE. Through
   promql_engine().query_to_prom_json: phase 4's rate (cold) and sum by
   (region) of rate (cold and warm) on the row path (the region-backed
   select, K1 on the window bounds), equal to phase 4's answers to one
   unit in the 6th significant digit and inside its float64 bound; the
   lowered shapes (range == step == 60 s: sum of rate, with the host-only
   reset_corr moment; avg of avg_over_time and max of max_over_time, one
   segment_moments launch each; avg of the instant selector), cold and
   warm, within rtol 2e-5 of a float64 brute force, and again on the row
   path (the dispatch floor above the table's rows: rate at 24 h within
   the row path's float32 bound, the gauge queries over 1 h within rtol
   2e-5, the instant one at 24 h); a select through the streamed cold read
   (its samples the loaded values exactly) and a query over it; an
   equality matcher through the SST index; TQL EVAL of the avg query over
   the first hour on both routes, equal to the JSON answers, TQL EXPLAIN
   (TpuAggregateExec, device-resident), TQL ANALYZE with its stages, and
   the tql/* goldens on the card. Each
   statement prints its wall, its stages (select / device eval + fetch /
   JSON shaping, or lowered frame / finalize / rebuild), the dispatch,
   each launch's device time and the peak device memory.
10. continuous rollup flows, on phase 6-8's frontend and tables (run
   right after phase 8; the datanode's background tick is off, so each
   fold is FlowManager.tick()): CREATE FLOW cpu_1m (the ten tags, 1
   minute, sum, count and max of the ten fields) and its first fold with
   the scan cache cold, on the device route with one segment_moments
   launch, its wall split into the fold's stages (scan_prep, runs,
   launch, tags, fetch, sink_write) and the launch's device time; every
   sink row (2.88 M) against a float64 brute force of the edited rows
   (counts exact, max the float32 max, sums within 8 eps32 sum|x|, the
   ten tags those of the host). The fold's launch is then held against
   the plain version on its own inputs and timed beside
   torch.segment_reduce and its byte bound. Q1-Q4 through the rollup
   rewrite (EXPLAIN and ExecStats name `rollup-rewrite`), each against
   `SET rollup_rewrite = 0` and the brute force, their warm walls printed
   rewritten and raw; Q5 and Q6 not rewritten. 10 more minutes for every
   host (240 000 rows by handle_row_insert) and the incremental fold:
   exactly those rows folded, the watermark at the last new ts, the new
   buckets against the brute force. A flow on cpu_p under `SET
   stream_threshold_rows = 100000`: every region folds on the host
   (fold_region_cold), no launch, no scan-cache entry, the sink against
   the brute force. SHOW FLOWS, information_schema.flows and the flow
   gauges; ADMIN FLUSH TABLE of the sinks, shutdown() and
   build_standalone on the same data home (the time to recover), the
   flows back with their watermarks and a tick that folds nothing.
11. the HTTP front door, on phase 9's frontend and tables (run right
   after phase 9's checks, its launch counts set to 0 before and read
   after): HttpServer(fe, addr="127.0.0.1:0").start() (servers/http.py,
   aiohttp), every request over a real socket with urllib, the native
   snappy codec loaded. /health, /status (the two tables' regions, a
   resident scan cache), buildinfo, /api/v1/labels, the 4000 hostname
   values and series. Through /api/v1/query_range at 24 h and a 60 s
   step, warm, each beside the direct query_to_prom_json call of the same
   query run back to back (their difference is the front door's own
   cost): the row path's sum by (region) of rate (one K1 launch) and the
   lowered avg by (region) of avg_over_time (one segment_moments launch),
   each equal to phase 9's answer; both again with explain=1, equal to
   TQL EXPLAIN; /api/v1/query of avg(cpu_usage_user) at the end of the
   range against the float64 brute force; /v1/promql over the first hour,
   equal to phase 9's TQL EVAL answer. /v1/sql with `SET
   tpu_dispatch_min_rows = 0` and an aggregate by region (one launch),
   equal to output_to_json of do_query's Output. Prometheus remote write
   of 10 more minutes of phase 4's generator for every host on both
   metrics (480 000 samples) in requests of 2000 samples, the
   remote-write queue's default, from 8 concurrent senders: the wall, the
   samples per second and the ingest_coalesce_* counters; count(*) of
   each table through /v1/sql; the row path's rate over the last hour,
   written minutes included, against the float64 brute force; remote read
   of one host's written minutes, exactly the written samples. One minute
   of TSBS cpu-only as InfluxDB lines (24 000 lines, 10 tags, 10 fields)
   through /v1/influxdb/write from 8 senders, and avg(usage_user) by
   hostname through /v1/sql against the brute force; one OpenTSDB telnet
   put and one HTTP put read back. `SET admission_max_inflight = 1` and 8
   concurrent /v1/sql aggregates: at least one 429 with Retry-After and
   code 6001, counted by /status; /v1/scripts and /debug/prof/cpu answer
   the error envelope naming their module; /metrics carries the
   greptime_http_request latency series. Then the server shuts down.
12. the MySQL and Postgres wire servers (servers/mysql.py,
   servers/postgres.py), every statement over a real socket through a
   minimal client of each protocol; its launches set to 0 before and
   read after. 12a, inside phase 6's run after phase 10, on phase 6's
   frontend and tables: MysqlServer(fe) and PostgresServer(fe) on port
   0; Q1-Q6 on cpu warm through do_query, then over MySQL and over
   Postgres, each column's name and wire type and each value's text
   equal to the servers' encoding of do_query's Output, the three walls
   printed (the static dispatch floor pinned before each, so the three
   take one route); SELECT 1 x 50 in turns over each wire and through
   do_query (the wires' own cost). KILL: Q1 on cpu_24h streamed ("host"
   mode) run to its end through do_query (its wall over its slices, two
   in flight, is one slice's time), then again over MySQL; SHOW FULL
   PROCESSLIST over Postgres lists it, KILL <id> over Postgres ends it,
   and the MySQL client gets errno 1105 "query <id> was killed" within
   one slice's time; that connection then answers SELECT 1, and
   COM_PROCESS_KILL of an unknown id answers errno 1094. COPY on cpu_p:
   TO a parquet file under the data home's object store; FROM it into
   cpu_copy (cpu_p's DDL, four regions, bulk_load) over MySQL, count(*)
   exact, Q5 on cpu_copy within its bound of the float64 brute force and
   within twice it of Q5 on cpu_p; the first hour (cpu_1h, loaded from
   the same generator) TO and FROM csv.gz and json.zst, counts by host
   exact and sums by host within 8 eps32 sum|x|; CREATE EXTERNAL TABLE
   over the parquet file (inferred schema), count(*) and max(usage_user)
   by region on it equal to cpu_p's (the max at float32). 12b, right
   after phase 11 on phase 9's frontend: TQL EVAL over the first hour of
   sum by (region) (rate(cpu_seconds_total[5m])) (the row path: one K1
   launch) through do_query, MySQL and Postgres, equal as above.

Before the last line come two JSON objects: the numbers of the bucket
entry, which the main paths do not launch, then the kernel table of the
main paths (PromQL's window bounds, SQL's, the flow folds', the HTTP
front door's and the wires' segment moments), each with its launches by
phase; the last line is {"ok": true, "device": {...}}. A run of chosen
phases lists only the kernels it launched, and both lines carry
"phases": the list of those that ran.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: the card the script drives (a rehearsal on the CPU may swap it)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
#: H100 SXM peak outside the tensor cores (float32; the table gives no
#: separate int32 rate), for the kernel's integer compare-adds
SCALAR_OPS_PER_S = 67e12
U32 = 2.0 ** -24                   # float32 unit roundoff
U64 = 2.0 ** -53                   # float64 unit roundoff
QUANT = 1e-5                       # the engine prints 6 significant digits
PAD32 = np.iinfo(np.int32).max     # the rebased timestamps' pad

# TSBS devops: pkg/data/usecases/devops/host.go regions and datacenters
TSBS_REGIONS = {
    "us-east-1": ["us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"],
    "us-west-1": ["us-west-1a", "us-west-1b"],
    "us-west-2": ["us-west-2a", "us-west-2b", "us-west-2c"],
    "eu-west-1": ["eu-west-1a", "eu-west-1b", "eu-west-1c"],
    "eu-central-1": ["eu-central-1a", "eu-central-1b"],
    "ap-southeast-1": ["ap-southeast-1a", "ap-southeast-1b"],
    "ap-southeast-2": ["ap-southeast-2a", "ap-southeast-2b"],
    "ap-northeast-1": ["ap-northeast-1a", "ap-northeast-1c"],
    "sa-east-1": ["sa-east-1a", "sa-east-1b", "sa-east-1c"],
}
TSBS_START_MS = 1_451_606_400_000          # 2016-01-01T00:00:00Z
INTERVAL_MS = 10_000
HOSTS = 4000                               # TSBS --scale
HOURS = 24
STEP_MS = 60_000
RANGE_MS = 300_000


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_machine(torch) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    for mod in ("pandas", "pyarrow", "prometheus_client", "aiohttp",
                "cryptography"):
        r = subprocess.run([sys.executable, "-c", f"import {mod}"],
                           capture_output=True, text=True)
        log(f"import {mod}: {'ok' if r.returncode == 0 else 'missing'}")


# ---------------------------------------------------------------------------
# phase 2 + 3: the kernel
# ---------------------------------------------------------------------------

def median_ms(torch, fn, launches: int = 20, runs: int = 5) -> float:
    """Device time of one call: CUDA events around `launches` back-to-back
    calls over their count (the host enqueues ahead of the card, so the
    wrapper's host time stays out), median of `runs` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def phase_kernel_build():
    """Both kernels' libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from greptimedb_tpu_torch.ops import cuda_build
    names = ("counts_leq", "segment_moments")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        paths = dict(zip(names, ex.map(cuda_build.build, names)))
    log(f"build: {time.perf_counter() - t0:.2f}s for {len(names)} kernels "
        f"in parallel")
    for name in names:
        info = cuda_build.build_info[name]
        how = f"built in {info['seconds']:.2f}s" if info["seconds"] \
            else "reused"
        log(f"  {name}: {how} ({os.path.relpath(paths[name], HERE)})")
        for line in info["log"].splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                log(f"    {line.strip()}")


def bound(S: int, L: int, T: int):
    """The least time the card could take for either entry: each input
    read once, each output written once (bytes), against one compare-add
    per sample and one add per step (operations)."""
    nbytes = (S * L + S * T) * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (S * L + S * T) / SCALAR_OPS_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes, ops_ms


def same(torch, name: str, got, want) -> int:
    """Exact int32 equality of a kernel's output with its plain version;
    returns the max |difference| (0)."""
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    check(torch.equal(got, want), f"{name}: kernel != plain (max |err| {err})")
    log(f"  {name}: kernel == plain")
    return err


def phase_kernel_check(torch, main_ts, main_t0: int, main_T: int):
    """Both entries of the window-bounds kernel against their plain
    versions (exact int32 equality), then timed at the main-path shape.
    Returns the two rows of the kernel table (fused entry first)."""
    from greptimedb_tpu_torch.ops import pallas_window as pw

    def grid_plain(ts, t0, step, T):
        return pw.counts_leq_plain(pw.step_buckets(ts, t0, step, T), T)

    def dev(a):
        return torch.as_tensor(a, device=DEVICE)

    err = {"counts_leq": 0, "counts_leq_grid": 0}

    def both(name, b, ts, t0, step, T):
        err["counts_leq"] = max(err["counts_leq"], same(
            torch, f"counts_leq {name}", pw.counts_leq(b, T),
            pw.counts_leq_plain(b, T)))
        grid(name, ts, t0, step, T)

    def grid(name, ts, t0, step, T):
        err["counts_leq_grid"] = max(err["counts_leq_grid"], same(
            torch, f"counts_leq_grid {name}",
            pw.counts_leq_grid(ts, t0, step, T), grid_plain(ts, t0, step, T)))

    rng = np.random.default_rng(1234)
    st = 1000
    log("both entries (timestamps: step 1000 ms from t0 = 0, 10 % pads)")
    for name, shape, T, srt in [
        ("test_pallas (8,512) T=128", (8, 512), 128, True),
        ("test_pallas (20,300) T=97", (20, 300), 97, True),
        ("test_pallas (1,1) T=1", (1, 1), 1, True),
        ("test_pallas (130,1030) T=200", (130, 1030), 200, True),
        ("unsorted rows (257,1000) T=300", (257, 1000), 300, False),
        ("T=20000 (78 KB of bins)", (64, 4096), 20_000, True),
        ("T=70000 (two bin tiles)", (16, 8192), 70_000, False),
        ("L=65536 (rows past 32768 samples) T=2053", (16, 65_536), 2053,
         True),
        ("L=1023 (not a multiple of 4) T=77", (33, 1023), 77, True),
    ]:
        b = rng.integers(-2, T + 2, shape).astype(np.int32)
        ts = rng.integers(-2 * st, (T + 2) * st, shape).astype(np.int32)
        ts[rng.random(shape) < 0.1] = PAD32
        if srt:
            b, ts = np.sort(b, axis=1), np.sort(ts, axis=1)
        both(name, dev(b), dev(ts), 0, st, T)
    shape = (257, 4096)
    both("every sample of a row in one bin (257,4096) T=300",
         dev(np.full(shape, 5, np.int32)),
         dev(rng.integers(4 * st + 1, 5 * st + 1, shape).astype(np.int32)),
         0, st, 300)
    shape = (64, 2048)
    both("all-pad rows (64,2048) T=300", dev(np.full(shape, 300, np.int32)),
         dev(np.full(shape, PAD32, np.int32)), 0, st, 300)
    # a contiguous view 4 bytes into its buffer: a row start that is not
    # 16-byte aligned, and L not a multiple of 4
    S, L, T = 9, 1023, 50
    bb = dev(rng.integers(-2, T + 2, 1 + S * L).astype(np.int32))
    tb = dev(rng.integers(-2 * st, (T + 2) * st, 1 + S * L).astype(np.int32))
    both("unaligned data_ptr (9,1023) T=50", bb[1:].view(S, L),
         tb[1:].view(S, L), 0, st, T)

    log("fused entry: bucketing edge cases")
    T = 64
    on_grid = 7000 + st * np.arange(-3, T + 3, dtype=np.int32)
    rows = np.tile(on_grid, (16, 1))
    rows[8:] = rng.permuted(rows[8:], axis=1)
    grid("timestamps on grid points, q = 0 at k = 0 (16,70) T=64",
         dev(rows), 7000, st, T)
    grid("q = 0 everywhere (8,300) T=97",
         dev(np.full((8, 300), 123_456, np.int32)), 123_456, 60_000, 97)
    wide = rng.integers(-2**31, 2**31 - 1, (64, 1000)).astype(np.int32)
    grid("samples far below t0, negative t0 (64,1000) T=100", dev(wide),
         -5_000_000, 60_000, 100)
    big = dev(rng.integers(0, 2**31 - 2, (64, 1000)).astype(np.int32))
    grid("t0 = -2^40 (the 64-bit division) (64,1000) T=4096", big,
         -2**40, 2**20, 4096)
    grid("step near 2^31 (the widest 32-bit division) (64,1000) T=3", big,
         0, 1_500_000_007, 3)
    grid("step = 1 (32,1000) T=3000",
         dev(rng.integers(0, 3200, (32, 1000)).astype(np.int32)), 100, 1,
         3000)
    grid("step wider than the span (32,1000) T=5",
         dev(rng.integers(0, 10**6, (32, 1000)).astype(np.int32)), 0,
         10**9, 5)
    mid = np.sort(rng.integers(0, 300 * st, (64, 2048)), axis=1)
    mid[rng.random(mid.shape) < 0.2] = PAD32
    grid("pads in the middle of rows (64,2048) T=300",
         dev(mid.astype(np.int32)), 0, st, 300)

    # ---- the main-path shape ----
    S, L = main_ts.shape
    T, t0 = main_T, main_t0
    main_b = pw.step_buckets(main_ts, t0, STEP_MS, T)
    want = pw.counts_leq_plain(main_b, T)
    ks = torch.arange(T, dtype=torch.int32, device=DEVICE)[None, :] \
        .expand(S, -1).contiguous()
    ends = (torch.arange(T, dtype=torch.int64, device=DEVICE) * STEP_MS + t0)
    check(int(ends[-1]) < PAD32, "main-path grid ends exceed int32")
    ends = ends.to(torch.int32)[None, :].expand(S, -1).contiguous()
    err["counts_leq"] = max(err["counts_leq"], same(
        torch, f"counts_leq main-path shape ({S}, {L}) T={T}",
        pw.counts_leq(main_b, T), want))
    err["counts_leq_grid"] = max(err["counts_leq_grid"], same(
        torch, f"counts_leq_grid main-path shape ({S}, {L}) T={T}",
        pw.counts_leq_grid(main_ts, t0, STEP_MS, T), want))
    check(torch.equal(want.long(),
                      torch.searchsorted(main_b, ks, right=True)) and
          torch.equal(want.long(),
                      torch.searchsorted(main_ts, ends, right=True)),
          "window counts != searchsorted at the main-path shape")
    log("  == torch.searchsorted over the buckets and over the timestamps")

    ms = {
        "counts_leq_grid": lambda: pw.counts_leq_grid(main_ts, t0, STEP_MS, T),
        "counts_leq": lambda: pw.counts_leq(main_b, T),
        "step_buckets + counts_leq (unfused)":
            lambda: pw.counts_leq(pw.step_buckets(main_ts, t0, STEP_MS, T), T),
        "counts_leq_grid plain": lambda: grid_plain(main_ts, t0, STEP_MS, T),
        "counts_leq plain": lambda: pw.counts_leq_plain(main_b, T),
        "searchsorted over the timestamps":
            lambda: torch.searchsorted(main_ts, ends, right=True),
        "searchsorted over the buckets":
            lambda: torch.searchsorted(main_b, ks, right=True),
    }
    ms = {k: median_ms(torch, fn) for k, fn in ms.items()}
    bound_ms, bound_by, nbytes, ops_ms = bound(S, L, T)
    log(f"main shape ({S}, {L}) T={T}, CUDA events around 20 back-to-back "
        f"calls, median of 5:")
    for k, v in ms.items():
        log(f"  {k}: {v:.4f} ms ({bound_ms / v * 100:.1f}% of the bound)")
    log(f"  bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB at "
        f"3.35 TB/s; operations {ops_ms:.4f} ms)")
    # the other side of the fused entry's division: a 30-day grid at a 1 h
    # step ending with the data, whose quotients pass 2^31 (the 64-bit
    # division), against the bucket entry on the same buckets
    Tw, stepw = 30 * 24 + 1, 3_600_000
    t0w = HOURS * 3_600_000 - (Tw - 1) * stepw
    bw = pw.step_buckets(main_ts, t0w, stepw, Tw)
    same(torch, f"counts_leq_grid 30-day grid at 1 h ({S}, {L}) T={Tw}",
         pw.counts_leq_grid(main_ts, t0w, stepw, Tw),
         pw.counts_leq_plain(bw, Tw))
    wide = {"counts_leq_grid": lambda: pw.counts_leq_grid(main_ts, t0w,
                                                          stepw, Tw),
            "counts_leq on the same buckets": lambda: pw.counts_leq(bw, Tw)}
    bound_w = bound(S, L, Tw)[0]
    log(f"30-day grid at 1 h (t0 = {t0w}, the 64-bit division), ({S}, {L}) "
        f"T={Tw}, bound {bound_w:.4f} ms:")
    for k, fn in wide.items():
        v = median_ms(torch, fn)
        log(f"  {k}: {v:.4f} ms ({bound_w / v * 100:.1f}% of the bound)")
    del bw
    # the same bytes with other bucket patterns: no atomics at all (pads),
    # all lanes of a warp on one bin, rows in no order
    shuffled = main_b[:, torch.randperm(L, device=DEVICE)].contiguous()
    for name, b in [("rows of pads only", torch.full_like(main_b, T)),
                    ("every sample in one bin", torch.full_like(main_b, 5)),
                    ("the main rows shuffled", shuffled)]:
        same(torch, f"counts_leq {name}", pw.counts_leq(b, T),
             pw.counts_leq_plain(b, T))
        log(f"  counts_leq on {name}: "
            f"{median_ms(torch, lambda: pw.counts_leq(b, T)):.4f} ms")
    del main_b, shuffled, ks, ends, want

    def row(name, kernel_ms, plain_ms, library_ms):
        return {"name": name, "route": "cuda",
                "source": "greptimedb_tpu_torch/csrc/counts_leq.cu",
                "replaces": "greptimedb_tpu/ops/pallas_window.py:61",
                "max_abs_err": err[name], "ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    return (row("counts_leq_grid", ms["counts_leq_grid"],
                ms["counts_leq_grid plain"],
                ms["searchsorted over the timestamps"]),
            row("counts_leq", ms["counts_leq"], ms["counts_leq plain"],
                ms["searchsorted over the buckets"]))


# ---------------------------------------------------------------------------
# phase 4: the PromQL range path on TSBS cpu-only data
# ---------------------------------------------------------------------------

def tsbs_cpu_only(seed: int, hosts: int = HOSTS, hours: float = HOURS):
    """TSBS `--use-case=cpu-only --log-interval=10s`: per host a
    hostname/region/datacenter, usage_user as TSBS's clamped random walk
    (steps N(0,1), clamped to [0, 100], start U(0, 100)), and a
    cumulative counter of usage_user/100 * 10 s with a reset (a restart
    to 0) in 8 hosts."""
    rng = np.random.default_rng(seed)
    n = int(hours * 3600_000 // INTERVAL_MS)
    ts = TSBS_START_MS + np.arange(n, dtype=np.int64) * INTERVAL_MS
    regions = list(TSBS_REGIONS)
    labels = []
    for h in range(hosts):
        r = regions[rng.integers(len(regions))]
        dcs = TSBS_REGIONS[r]
        labels.append({"hostname": f"host_{h}", "region": r,
                       "datacenter": dcs[rng.integers(len(dcs))]})
    usage = np.empty((hosts, n))
    x = rng.random(hosts) * 100.0
    steps = rng.standard_normal((n, hosts))
    for i in range(n):
        x = np.clip(x + steps[i], 0.0, 100.0)
        usage[:, i] = x
    counter = np.cumsum(usage / 100.0 * (INTERVAL_MS / 1000.0), axis=1)
    for h in rng.choice(hosts, 8, replace=False):
        r = int(rng.integers(n // 10, n - n // 10))
        counter[h, r:] -= counter[h, r]
    return ts, labels, {"cpu_usage_user": usage,
                        "cpu_seconds_total": counter}


def make_engine_class():
    from greptimedb_tpu_torch.ops.window import TS_PAD, SeriesMatrix
    from greptimedb_tpu_torch.promql import engine as eng

    class MemoryPromqlEngine(eng.PromqlEngine):
        """Serves in-memory series through `select`, applying the
        selector's matchers as the reference's select_series does."""

        def __init__(self, ts, labels, metrics, device=DEVICE):
            # a catalog without tables: the lowering finds none, and
            # every query keeps the row path through `select`
            super().__init__(catalog=types.SimpleNamespace(
                table=lambda *a: None), device=device)
            self.ts, self.labels, self.metrics = ts, labels, metrics
            self.label_cols = {k: [lb[k] for lb in labels]
                               for k in labels[0]}
            self.select_s = 0.0

        def select(self, sel, lo_ms, hi_ms, ctx):
            t_start = time.perf_counter()
            metric = sel.metric
            for m in sel.matchers:
                if m.name == "__name__" and m.op == "=":
                    metric = m.value
            vals = self.metrics.get(metric)
            if vals is None:
                return eng._Selection([], None)
            keep = np.ones(len(self.labels), dtype=bool)
            for m in sel.matchers:
                if m.name in ("__name__", "__field__"):
                    continue
                if m.name not in self.label_cols:
                    keep &= eng._matches_empty(m)
                    continue
                keep &= eng._matcher_keep(self.label_cols[m.name], m)
            cols = np.nonzero((self.ts >= lo_ms) & (self.ts <= hi_ms))[0]
            rows = np.nonzero(keep)[0]
            if rows.size == 0 or cols.size == 0:
                return eng._Selection([], None)
            c0, n = int(cols[0]), int(cols.size)
            L = 1 << (n - 1).bit_length() if n > 1 else 1
            ts2d = np.full((rows.size, L), TS_PAD, dtype=np.int64)
            ts2d[:, :n] = self.ts[c0:c0 + n]
            val2d = np.zeros((rows.size, L))
            val2d[:, :n] = vals[rows, c0:c0 + n]
            sm = SeriesMatrix(ts2d, val2d, np.full(rows.size, n, np.int32))
            labels = [{"__name__": metric, **self.labels[r]} for r in rows]
            self.select_s += time.perf_counter() - t_start
            return eng._Selection(labels, sm, int(self.ts[c0]),
                                  int(self.ts[c0 + n - 1]))

    return MemoryPromqlEngine


class K1Timer:
    """Wraps the window module's counts_leq_grid inside the real queries
    (the wrapper still counts each launch). For each launch it reads the
    SM clock (nvidia-smi), the host time of the wrapper call, and the
    kernel's device time: a spin kernel queued first keeps the card busy
    until the wrapper has enqueued its launch, so the events around the
    call time the kernel and not the host work before it."""

    SPIN_CYCLES = 40_000_000        # ~20 ms at 1980 MHz

    def __init__(self, torch, inner):
        self.torch, self.inner = torch, inner
        self.pending, self.shapes, self.launches = [], [], []

    def __call__(self, ts2d, t0, step, nsteps):
        cuda = self.torch.cuda
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        e_spin, e0, e1 = (cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        e_spin.record()
        cuda._sleep(self.SPIN_CYCLES)
        e0.record()
        h1 = time.perf_counter()
        out = self.inner(ts2d, t0, step, nsteps)
        h2 = time.perf_counter()
        e1.record()
        self.pending.append((e_spin, e0, e1, h2 - h0, (h2 - h1) * 1e3, clock))
        self.shapes.append((tuple(ts2d.shape), int(nsteps)))
        return out

    def take(self):
        """[(device ms, wrapper host ms, SM clock)] of the launches since
        the last call. Fails if the host had not enqueued a launch before
        the spin ahead of it ended (its events would then time host work
        too)."""
        self.torch.cuda.synchronize()
        rows = []
        for e_spin, e0, e1, enqueue_s, host_ms, clock in self.pending:
            spin_ms = e_spin.elapsed_time(e0)
            check(enqueue_s * 1e3 < spin_ms, f"the wrapper took "
                  f"{enqueue_s * 1e3:.2f} ms to enqueue, longer than the "
                  f"{spin_ms:.2f} ms spin ahead of it")
            rows.append((e0.elapsed_time(e1), host_ms, clock))
        self.pending = []
        self.launches += rows
        return rows


def brute_windows(ts, steps, range_ms):
    """[T, n] membership of each sample in (t - range, t]."""
    t = steps[:, None]
    return (ts[None, :] > t - range_ms) & (ts[None, :] <= t)


def ref_rate(ts, C, steps, range_ms):
    """Prometheus extrapolatedRate (extrapolate_rate.rs) in float64 for
    every row of counter matrix C [S, n] sharing timestamps ts. Returns
    rate, ok, the float32-error bound of the port's rate, and the raw
    reset-corrected increase."""
    lo = np.searchsorted(ts, steps - range_ms, side="right")
    hi = np.searchsorted(ts, steps, side="right")
    count = hi - lo
    first = np.minimum(lo, len(ts) - 1)
    last = np.maximum(hi - 1, 0)
    prev = np.concatenate([C[:, :1], C[:, :-1]], axis=1)
    contrib = np.where(C < prev, prev, 0.0)
    contrib[:, 0] = 0.0
    cc = np.cumsum(contrib, axis=1)
    raw = C[:, last] - C[:, first] + cc[:, last] - cc[:, first]
    first_t = ts[first].astype(np.float64)[None, :]
    last_t = ts[last].astype(np.float64)[None, :]
    first_v = C[:, first]
    sampled = last_t - first_t
    dur_start = first_t - (steps - range_ms)[None, :]
    dur_end = steps[None, :] - last_t
    avg = sampled / np.maximum(count - 1, 1)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        dz = np.where((raw > 0) & (first_v >= 0),
                      sampled * (first_v / np.where(raw == 0, 1, raw)),
                      np.inf)
    ds = np.minimum(dur_start, dz)
    thr = avg * 1.1
    ext_s = np.where(ds < thr, ds, avg / 2)
    ext_e = np.where(dur_end < thr, dur_end, avg / 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        factor = (sampled + ext_s + ext_e) / np.where(sampled == 0, 1,
                                                      sampled)
    rate = raw * factor / (range_ms / 1000.0)
    ok = np.broadcast_to((count >= 2)[None, :] & (sampled > 0), raw.shape)
    # bound: timestamps are float32 of int32 offsets from the first
    # sample (error <= et each), values and the reset-adjusted counter
    # are float32 (error <= U32 * max|adj|), the reset correction is a
    # float32 prefix sum of k nonzero terms, in any order within
    # (k - 1) * U32 * their sum
    tmax = float(ts[-1] - ts[0] + range_ms)
    et = 2 * U32 * tmax
    vmax = np.abs(C + cc).max(axis=1, keepdims=True)
    k = np.count_nonzero(contrib, axis=1)[:, None]
    err_raw = 4 * U32 * vmax + 2 * np.maximum(k - 1, 0) * U32 * \
        cc[:, -1:] + U32 * np.abs(raw)
    with np.errstate(divide="ignore", invalid="ignore"):
        err_dz = np.where(np.isfinite(dz), dz * (2 * et / sampled + 2 * U32 +
                                                 err_raw / np.abs(raw)), 0.0)
        err_start = 2 * et + np.where(dz < 2 * thr, err_dz, 0.0)
        err_factor = (err_start + 4 * et + factor * 2 * et) / sampled + \
            6 * U32 * factor
        bound = (np.abs(raw) * err_factor + factor * err_raw) / \
            (range_ms / 1000.0) + (3 * U32 + QUANT) * np.abs(rate)
    return rate, ok, np.where(ok, bound, 0.0), raw


def parse_series(result, key_label="hostname"):
    out = {}
    for r in result:
        tv = np.asarray([[float(t), float(v)] for t, v in r["values"]])
        out[r["metric"].get(key_label)] = tv
    return out


def series_values(name, got_map, keys, steps_s, ok):
    """[len(keys), T] values the engine printed (got_map[key] = [[t, v]]),
    NaN where it printed none. The printed steps must be the ok steps."""
    got = np.full(ok.shape, np.nan)
    for i, k in enumerate(keys):
        tv = got_map.get(k)
        got_t = tv[:, 0] if tv is not None else np.zeros(0)
        check(np.array_equal(got_t, steps_s[ok[i]]),
              f"{name}: ok steps differ for {k}")
        if tv is not None:
            got[i, ok[i]] = tv[:, 1]
    return got


def outside(got, want, ok, bound):
    """Mask of the ok points where |got - want| exceeds bound (NaN does)."""
    with np.errstate(invalid="ignore"):
        return ok & ~(np.abs(got - want) <= bound)


def compare(name, got, want, ok, bound, against="float64 brute force"):
    """got/want/ok/bound [K, T]: every ok point within its bound."""
    bad = outside(got, want, ok, bound)
    check(not bad.any(),
          f"{name}: {int(bad.sum())} values outside the bound vs {against}, "
          f"e.g. got {got[bad][:3]} want {want[bad][:3]} bound "
          f"{bound[bad][:3]}")
    err = np.abs(got - want)[ok]
    ratio = err / np.maximum(bound[ok], 1e-300)
    log(f"  check {name}: {ok.shape[0]} series x {ok.shape[1]} steps vs "
        f"{against}; ok masks equal; max |err| "
        f"{err.max() if err.size else 0.0:.3g}, max |err|/bound "
        f"{ratio.max() if ratio.size else 0.0:.3g}")


def moments(P1, P2, lo, hi, c):
    """Windowed mean, E[x^2] and population variance, in float64, from
    prefix sums P [K, n + 1] (P[:, i] = sum of the first i samples) over
    sample ranges [lo, hi) of c = max(hi - lo, 1) samples: the reference's
    algorithm (ops/window.py _op_from_stack)."""
    mean = (P1[:, hi] - P1[:, lo]) / c
    a = (P2[:, hi] - P2[:, lo]) / c
    return mean, a, np.maximum(a - mean * mean, 0.0)


def sqrt_bound(var_err, var):
    """Bound on |sqrt(x) - sqrt(var)| for |x - var| <= var_err, x >= 0."""
    return np.minimum(np.sqrt(var_err),
                      var_err / np.maximum(np.sqrt(var), 1e-300))


def phase_promql(torch, seed, k1):
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.ops import window as win

    t_gen = time.perf_counter()
    ts, labels, metrics = tsbs_cpu_only(seed)
    S, n = metrics["cpu_usage_user"].shape
    log(f"TSBS cpu-only: {S} hosts x {n} samples ({S * n / 1e6:.1f} M per "
        f"metric) in {time.perf_counter() - t_gen:.1f}s (seed {seed})")
    Engine = make_engine_class()
    eng = Engine(ts, labels, metrics, device=DEVICE)
    start = int(ts[0])
    end = start + HOURS * 3600_000
    steps = np.arange(start, end + 1, STEP_MS, dtype=np.int64)

    # the main path's window-bounds input: the engine evaluates the
    # in-range steps (all of them here) padded to a power of two, on the
    # extended grid that starts one range before the first step
    from greptimedb_tpu_torch.promql.parser import parse_promql
    sel = parse_promql("cpu_usage_user[5m]")
    mat = eng.select(sel, start - RANGE_MS + 1, end, None).matrix
    rel, _, _, base = mat.device_arrays()
    n_pad = 1 << (len(steps) - 1).bit_length()
    main_T = n_pad + RANGE_MS // STEP_MS
    main_ts = torch.as_tensor(rel, device=DEVICE)
    kern = phase_kernel_check(torch, main_ts, start - base - RANGE_MS, main_T)
    del main_ts

    queries = [
        "avg_over_time(cpu_usage_user[5m])",
        "rate(cpu_seconds_total[5m])",
        "sum by (region) (rate(cpu_seconds_total[5m]))",
        "stddev_over_time(cpu_usage_user[5m])",
    ]
    win.counts_leq_grid = k1
    pw.counts_leq.launches = pw.counts_leq_grid.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results = {}
    for q in queries:
        eng.select_s = 0.0
        t0 = time.perf_counter()
        res = eng.query_to_prom_json(q, start, end, STEP_MS)
        wall = time.perf_counter() - t0
        k1_rows = k1.take()
        sel_s = eng.select_s
        eng.select_s = 0.0
        t1 = time.perf_counter()
        eng.query_range(q, start, end, STEP_MS)
        eval_wall = time.perf_counter() - t1
        k1_rows += k1.take()
        results[q] = res
        log(f"query {q}: wall {wall * 1e3:.1f} ms, {len(res['result'])} "
            f"series; select {sel_s * 1e3:.1f} ms, device eval + fetch "
            f"{(eval_wall - eng.select_s) * 1e3:.1f} ms, JSON shaping "
            f"{(wall - eval_wall) * 1e3:.1f} ms; K1 per launch (JSON run, "
            f"then eval run): device " +
            " / ".join(f"{d:.4f}" for d, _, _ in k1_rows) + " ms, wrapper "
            "host " + " / ".join(f"{h:.4f}" for _, h, _ in k1_rows) +
            " ms, SM clock " + " / ".join(c for _, _, c in k1_rows))
    launches = pw.counts_leq_grid.launches
    kern[1]["launches"] = pw.counts_leq.launches
    win.counts_leq_grid = k1.inner
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"counts_leq_grid launches during the queries: {launches} "
        f"(counts_leq: {kern[1]['launches']}); shapes "
        f"{sorted(set(k1.shapes))}; peak device memory {peak:.2f} GiB")
    dev = [d for d, _, _ in k1.launches]
    log(f"K1 in the queries: device {min(dev):.4f}-{max(dev):.4f} ms "
        f"(median {statistics.median(dev):.4f}) against "
        f"{kern[0]['ms']:.4f} ms alone at the same shape")
    check(launches > 0, "the main path launched no counts_leq_grid kernel")
    check(((S, mat.max_len), main_T) in set(k1.shapes),
          "the main path did not run the window-bounds kernel at the "
          "shape phase 3 checked")
    kern[0]["launches"] = launches
    phase_breakdown(torch, eng, mat, start, end)

    # ---- checks on 64 sampled hosts at every step ----
    rng = np.random.default_rng(seed + 1)
    idx = np.sort(rng.choice(S, min(64, S), replace=False))
    keys = [labels[i]["hostname"] for i in idx]
    steps_s = steps.astype(np.float64) / 1000.0
    M = brute_windows(ts, steps, RANGE_MS).astype(np.float64)   # [T, n]
    cnt = M.sum(axis=1)
    lo = np.searchsorted(ts, steps - RANGE_MS, side="right")
    hi = np.searchsorted(ts, steps, side="right")
    check(np.array_equal(hi - lo, cnt),
          "window index ranges differ from the brute force")
    ok1 = np.broadcast_to(cnt >= 1, (len(idx), len(steps)))
    c = np.maximum(cnt, 1)[None, :]
    check_moments(torch, results[queries[0]], results[queries[3]], mat,
                  metrics["cpu_usage_user"], idx, keys, steps_s, M, cnt, lo,
                  hi, ok1, c)

    C = metrics["cpu_seconds_total"]
    rate, ok2, bound, raw_ref = ref_rate(ts, C[idx], steps, RANGE_MS)
    # brute-force the sampled rows' counts and reset corrections too
    first = np.argmax(M > 0, axis=1)
    last = M.shape[1] - 1 - np.argmax(M[:, ::-1] > 0, axis=1)
    Ci = C[idx]
    contrib = np.where(Ci[:, 1:] < Ci[:, :-1], Ci[:, :-1], 0.0)
    pair = M[:, 1:] * M[:, :-1]
    raw_bf = Ci[:, last] - Ci[:, first] + contrib @ pair.T
    check(bool((np.isclose(raw_bf, raw_ref, rtol=1e-9, atol=1e-6) |
                ~ok2).all()),
          "the float64 rate reference disagrees with the brute force")
    got = series_values("rate", parse_series(results[queries[1]]["result"]),
                        keys, steps_s, ok2)
    compare("rate", got, rate, ok2, bound)

    # sum by (region): the float64 reference over all hosts
    rate_all, ok_all, bound_all, _ = ref_rate(ts, C, steps, RANGE_MS)
    rate_ok = np.where(ok_all, rate_all, 0.0)
    regions = sorted({lb["region"] for lb in labels})
    reg_of = np.asarray([lb["region"] for lb in labels])
    want = np.stack([rate_ok[reg_of == r].sum(axis=0) for r in regions])
    wok = np.stack([ok_all[reg_of == r].any(axis=0) for r in regions])
    wb = np.stack([bound_all[reg_of == r].sum(axis=0) +
                   QUANT * np.abs(rate_ok[reg_of == r]).sum(axis=0)
                   for r in regions])
    got = series_values("sum by (region) (rate)", parse_series(
        results[queries[2]]["result"], "region"), regions, steps_s, wok)
    compare("sum by (region) (rate)", got, want, wok, wb)

    # the window counts themselves, straight from the kernel's bounds
    ext = pw.counts_leq_grid(
        torch.as_tensor(rel[idx], device=DEVICE), start - base - RANGE_MS,
        STEP_MS, main_T).cpu().numpy()
    shift = RANGE_MS // STEP_MS
    kc = ext[:, shift:shift + len(steps)] - ext[:, :len(steps)]
    check(np.array_equal(kc, np.broadcast_to(cnt, kc.shape)),
          "window counts differ from the brute force")
    log(f"  check window counts: {len(idx)} series x {len(steps)} steps "
        f"equal to the brute force")

    # ---- gather path, reduced size ----
    region = "us-east-1"
    red_end = start + 2 * 3600_000
    rsteps = np.arange(start, red_end + 1, STEP_MS, dtype=np.int64)
    rows = np.nonzero(reg_of == region)[0]
    log(f"gather path at a reduced size: cpu_usage_user{{region=\"{region}\"}}"
        f" ({rows.size} series) over 2 h at 60 s steps (maxw = the "
        f"selection's padded length: an O(S*T*L) working set)")
    Mr = brute_windows(ts, rsteps, RANGE_MS)
    rc = Mr.sum(axis=1)
    sub = rng.choice(rows, min(32, rows.size), replace=False)
    G = metrics["cpu_usage_user"][sub]
    gmax = np.abs(G).max(axis=1, keepdims=True)
    for q, fn in [
        (f'max_over_time(cpu_usage_user{{region="{region}"}}[5m])',
         lambda w: w.max()),
        (f'quantile_over_time(0.9, cpu_usage_user{{region="{region}"}}[5m])',
         lambda w: _prom_quantile(np.sort(w), 0.9)),
    ]:
        t0 = time.perf_counter()
        res = eng.query_to_prom_json(q, start, red_end, STEP_MS)
        log(f"query {q}: wall {(time.perf_counter() - t0) * 1e3:.1f} ms, "
            f"{len(res['result'])} series")
        want = np.asarray([[fn(g[Mr[j]]) if rc[j] else np.nan
                            for j in range(len(rsteps))] for g in G])
        okr = np.broadcast_to(rc >= 1, want.shape)
        name = q.split("(")[0]
        got = series_values(name, parse_series(res["result"]),
                            [labels[i]["hostname"] for i in sub],
                            rsteps.astype(np.float64) / 1000.0, okr)
        compare(name, got, want, okr,
                4 * U32 * gmax + QUANT * np.abs(np.nan_to_num(want)))
    # what phase 9 holds the same queries over the tables to
    answers = {q: parse_series(results[q]["result"], key) for q, key in
               ((queries[1], "hostname"), (queries[2], "region"))}
    return kern, types.SimpleNamespace(ts=ts, labels=labels,
                                       metrics=metrics, answers=answers)


def phase_breakdown(torch, eng, mat, start: int, end: int, reps: int = 3):
    """Splits "device eval + fetch" of avg_over_time(cpu_usage_user[5m])
    over the main-path selection into the engine's own stages, each timed
    on the host clock around work that ends in a synchronize (median of
    `reps`): the host rebase, the H2D copies (with the float64 -> float32
    cast the engine makes first), the window-bounds pass, the cumsums and
    the stacked gather, the op epilogue, and the fetch (D2H, then the
    float32 quantisation)."""
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.promql import engine as E
    from greptimedb_tpu_torch.session import QueryContext
    n_eval = len(range(start, end + 1, STEP_MS))
    nsteps = 1 << (n_eval - 1).bit_length()
    shift = RANGE_MS // STEP_MS
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        ev = E._Eval(eng, QueryContext(), start, end, STEP_MS,
                     E.DEFAULT_LOOKBACK_MS)
        ts_host, val2d, lengths, base = stage(
            "host rebase (SeriesMatrix.device_arrays)", mat.device_arrays)
        ts2d, v, lg = stage("H2D copies (float32 cast included)", lambda: (
            ev._to_device(ts_host), ev._to_device(val2d.astype(np.float32)),
            ev._to_device(lengths)))
        t0r = start - base
        ext = stage("window-bounds pass (counts_leq_grid)",
                    lambda: win._ext_counts(ts2d, t0r, step=STEP_MS,
                                            range_ms=RANGE_MS, nsteps=nsteps))
        ga = stage("cumsums + stacked gather (_stack_prefix)",
                   lambda: win._stack_prefix(ts2d, v, lg, ext))
        vals, ok = stage("op epilogue (_op_from_stack)", lambda: (
            win._op_from_stack(ga, None, None, ext[:, :nsteps], ext[:, shift:],
                               t0r, STEP_MS, RANGE_MS, op="avg_over_time",
                               nsteps=nsteps, shift=shift)))
        vh, okh = stage("fetch: D2H", lambda: (vals.cpu().numpy(),
                                               ok.cpu().numpy()))
        stage("fetch: float32 quantisation (_from_device_f32)",
              lambda: E._from_device_f32(vh))
        del ts2d, v, lg, ext, ga, vals, ok
    log(f"device eval + fetch of avg_over_time(cpu_usage_user[5m]) by stage "
        f"({mat.num_series} x {mat.max_len}, {nsteps} steps; host clock "
        f"around synchronized work, median of {reps}):")
    total = 0.0
    for name, ts in times.items():
        med = statistics.median(ts)
        total += med
        log(f"  {name}: {med:.1f} ms (runs "
            f"{' / '.join(f'{t:.1f}' for t in ts)})")
    log(f"  sum of the stages: {total:.1f} ms")


def check_moments(torch, res_avg, res_std, mat, X, idx, keys, steps_s, M,
                  cnt, lo, hi, ok, c):
    """avg_over_time and stddev_over_time on the sampled hosts, in three
    steps, none of which assumes a summation depth:

    1. the reference's algorithm (`moments`) on exact float64 prefixes of
       the float32 values equals the float64 brute force over the window
       matrix M, within the rounding of the values to float32;
    2. the witness: the same algorithm on float32 prefixes made on the
       card by the engine's own torch calls (cumsum of x and of x*x) over
       the same [S, L] float32 matrix the engine holds. The engine must
       match it within the rounding of its last float32 operations, since
       both start from the same prefixes. Planted wrong answers (zero, an
       n - 1 divisor, 5 % off) must fail this check;
    3. those card prefixes lie within the worst-case float32 bound of the
       exact ones, i * u * the sum of the first i terms (i - 1 roundings
       of the sum, one of the square).
       How far they put the algorithm from float64 is printed: it is the
       reference's own float32 error, which the port shares.
    """
    T = len(steps_s)
    X = X[idx]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean64 = (X @ M.T) / cnt
        var64 = np.maximum((X * X) @ M.T / cnt - mean64 ** 2, 0.0)

    # 1. exact prefixes of the float32 values
    x32 = X.astype(np.float32).astype(np.float64)
    z = np.zeros((len(idx), 1))
    Q1 = np.concatenate([z, np.cumsum(x32, axis=1)], axis=1)
    Q2 = np.concatenate([z, np.cumsum(x32 * x32, axis=1)], axis=1)
    mean_x, a_x, var_x = moments(Q1, Q2, lo, hi, c)
    n = X.shape[1]
    absmean = (np.abs(X) @ M.T) / c
    f64 = 2 * n * U64 * (np.abs(Q1[:, -1:]) * (1 + absmean) + Q2[:, -1:]) / c
    bm = U32 * absmean + f64
    bv = 4 * U32 * (a_x + absmean ** 2) + f64
    compare("moments on exact prefixes: mean", mean_x, mean64, ok, bm)
    compare("moments on exact prefixes: variance", var_x, var64, ok, bv)
    check(outside(var_x * c / np.maximum(c - 1, 1), var64, ok, bv).any(),
          "an n - 1 divisor passes the exact-prefix variance check")

    # 2. the card's float32 prefixes, as the engine makes them
    _, val2d, lengths, _ = mat.device_arrays()
    v = torch.as_tensor(val2d.astype(np.float32), device=DEVICE)
    L = v.shape[1]
    valid = torch.arange(L, device=DEVICE)[None, :] < \
        torch.as_tensor(lengths, device=DEVICE)[:, None]
    vz = torch.where(valid, v, 0)
    rows = torch.as_tensor(idx, device=DEVICE)
    P1 = torch.cumsum(vz, dim=1)[rows, :n].double().cpu().numpy()
    P2 = torch.cumsum(vz * vz, dim=1)[rows, :n].double().cpu().numpy()
    del v, valid, vz
    P1 = np.concatenate([z, P1], axis=1)
    P2 = np.concatenate([z, P2], axis=1)
    mean_w, a_w, var_w = moments(P1, P2, lo, hi, c)
    std_w = np.sqrt(var_w)
    # the engine's float32 steps after the prefixes: two differences, two
    # divisions, a square, a subtraction and a square root, each within
    # U32 (8 * U32 * (a + mean^2) for the variance, doubled for margin),
    # then printed to 6 significant digits
    b_mean = (4 * U32 + QUANT) * np.abs(mean_w)
    b_std = sqrt_bound(16 * U32 * (a_w + mean_w ** 2), var_w) + \
        (U32 + QUANT) * std_w
    got_avg = series_values("avg_over_time", parse_series(
        res_avg["result"]), keys, steps_s, ok)
    got_std = series_values("stddev_over_time", parse_series(
        res_std["result"]), keys, steps_s, ok)
    witness = "the float32-prefix witness"
    compare("avg_over_time", got_avg, mean_w, ok, b_mean, witness)
    compare("stddev_over_time", got_std, std_w, ok, b_std, witness)
    planted = {
        "avg_over_time with an n - 1 divisor":
            (got_avg * c / np.maximum(c - 1, 1), mean_w, b_mean),
        "stddev_over_time of 0": (got_std * 0.0, std_w, b_std),
        "stddev_over_time with an n - 1 divisor":
            (got_std * np.sqrt(c / np.maximum(c - 1, 1)), std_w, b_std),
        "stddev_over_time 5 % high": (got_std * 1.05, std_w, b_std),
    }
    for name, (g, w, b) in planted.items():
        nbad = int(outside(g, w, ok, b).sum())
        check(nbad > 0, f"the witness check passes a planted {name}")
        log(f"  planted {name}: fails at {nbad} of {int(ok.sum())} points")

    # 3. the card's prefixes against the worst case, and what they cost
    i = np.arange(n + 1, dtype=np.float64)[None, :]
    for name, P, Q in (("x", P1, Q1), ("x*x", P2, Q2)):
        gamma = i * U32 * 1.01
        bad = np.abs(P - Q) > gamma * np.abs(Q) + 2 * n * U64 * np.abs(Q)
        check(not bad.any(), f"float32 prefixes of {name} on the card "
              f"outside the worst-case summation bound")
        rel = np.abs(P - Q)[:, 1:] / np.maximum(np.abs(Q[:, 1:]), 1e-300)
        log(f"  float32 prefixes of {name} on the card: max relative error "
            f"{rel.max():.3g} (worst case {(n - 1) * U32:.3g})")
    with np.errstate(invalid="ignore"):
        d_mean = np.abs(mean_w - mean64)[ok]
        d_std = np.abs(std_w - np.sqrt(var64))[ok]
        e_avg = np.abs(got_avg - mean64)[ok]
        e_std = np.abs(got_std - np.sqrt(var64))[ok]
    log(f"  float32 prefix error (the reference's algorithm, {T} steps): "
        f"max |witness - float64| mean {d_mean.max():.3g}, stddev "
        f"{d_std.max():.3g}; engine max |err| vs float64: avg_over_time "
        f"{e_avg.max():.3g}, stddev_over_time {e_std.max():.3g}")


def _prom_quantile(sorted_vals, q):
    n = len(sorted_vals)
    rank = q * (n - 1)
    lo = int(np.floor(rank))
    hi = min(lo + 1, n - 1)
    w = rank - lo
    return sorted_vals[lo] * (1 - w) + sorted_vals[hi] * w


# ---------------------------------------------------------------------------
# phase 5: the segment-moments kernel against its plain version
# ---------------------------------------------------------------------------

def phase_moments_check() -> float:
    """The kernel at the reference's test shapes (tests/test_kernels.py)
    and at the edges of its design (the timing tool's list), against its
    plain version."""
    from greptimedb_tpu_torch.tools import segment_moments_bench as smb
    err = 0.0
    log("segment_moments: float32 and int32 columns, column nulls, 15 % "
        "of rows masked")
    for name, build in smb.edge_cases():
        err = max(err, smb.moments_agree(name, build(DEVICE)))
    return err


# ---------------------------------------------------------------------------
# phase 6: SQL through QueryEngine on TSBS cpu-only
# ---------------------------------------------------------------------------

SQL_HOURS = 12                      # TSBS double-groupby span
STREAM_HOURS = 24                   # the streamed table's span
CPU_FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice",
              "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
              "usage_guest", "usage_guest_nice")
TSBS_TAGS = ("hostname", "region", "datacenter", "rack", "os", "arch",
             "team", "service", "service_version", "service_environment")


def tsbs_cpu_table(seed: int, hosts: int = HOSTS, hours: int = SQL_HOURS):
    """TSBS `--use-case=cpu-only --log-interval=10s` as the table `cpu`:
    the ten host tags of pkg/data/usecases/devops/host.go and the ten
    usage_* fields of cpu.go, each a random walk clamped to [0, 100]
    (steps N(0, 1), start U(0, 100)). Returns ts [n], one tag tuple per
    host and {field: float64 [hosts, n]}."""
    rng = np.random.default_rng(seed)
    n = int(hours * 3600_000 // INTERVAL_MS)
    ts = TSBS_START_MS + np.arange(n, dtype=np.int64) * INTERVAL_MS
    regions = list(TSBS_REGIONS)
    tags = []
    for h in range(hosts):
        r = regions[rng.integers(len(regions))]
        dcs = TSBS_REGIONS[r]
        tags.append((
            f"host_{h}", r, dcs[rng.integers(len(dcs))],
            str(rng.integers(100)),
            ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")[
                rng.integers(3)],
            ("x64", "x86")[rng.integers(2)],
            ("SF", "NYC", "LON", "CHI")[rng.integers(4)],
            str(rng.integers(20)), str(rng.integers(2)),
            ("production", "staging", "test")[rng.integers(3)]))
    fields = {}
    for name in CPU_FIELDS:
        x = rng.random(hosts) * 100.0
        walk = np.empty((n, hosts))
        steps = rng.standard_normal((n, hosts))
        for i in range(n):
            x = np.clip(x + steps[i], 0.0, 100.0)
            walk[i] = x
        fields[name] = np.ascontiguousarray(walk.T)
    return ts, tags, fields


def sql_ddl(name, fields, partition=""):
    """CREATE TABLE `name`: the ten TSBS tags as the primary key, ts the
    time index, then `fields` ({name: SQL type}) as fields; `partition`
    is an optional PARTITION BY clause."""
    cols = [f"{t} STRING" for t in TSBS_TAGS] + ["ts TIMESTAMP TIME INDEX"] + \
        [f"{f} {t}" for f, t in fields.items()]
    return (f"CREATE TABLE {name} ({', '.join(cols)}, PRIMARY KEY("
            f"{', '.join(TSBS_TAGS)})){partition}")


def sql_columns(ts, tags, fields):
    """The table's rows as a TSBS loader sends them, time-major (every
    host at one instant, then the next)."""
    H, n = next(iter(fields.values())).shape
    cols = {t: np.tile(np.array([tg[i] for tg in tags], dtype=object), n)
            for i, t in enumerate(TSBS_TAGS)}
    cols["ts"] = np.repeat(ts, H)
    for f, x in fields.items():
        cols[f] = x.T.ravel()
    return cols


def sst_summary(table):
    files = [f for r in table.regions.values()
             for f in r.version_control.current.ssts.all_files()]
    per = [sum(f.level == lv for f in files) for lv in (0, 1)]
    return (f"{len(files)} SSTs (L0 {per[0]}, L1 {per[1]}), "
            f"{sum(f.file_size for f in files) / 1e6:.1f} MB, "
            f"{sum(f.num_rows for f in files)} rows")


def sql_bulk_load(fe, name, ts, tags, fields):
    """The rows through FrontendInstance.handle_bulk_load (MitoTable.
    bulk_load → Region.bulk_ingest in each region the partition rule
    routes rows to: Parquet SSTs + one manifest edit), then any compaction
    it set off waited out, so that no later query races a version change.
    Returns the table."""
    cols = sql_columns(ts, tags, fields)
    t0 = time.perf_counter()
    written = fe.handle_bulk_load(name, cols, tag_columns=TSBS_TAGS,
                                  timestamp_column="ts")
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe.datanode.storage.scheduler.wait_idle(timeout=600)
    wait_s = time.perf_counter() - t0
    table = fe.catalog.table("greptime", "public", name)
    profiles = [r.last_ingest_profile for r in table.regions.values()]
    N = len(cols["ts"])
    check(type(table).__name__ == "MitoTable" and written == N and
          sum(p.rows for p in profiles) == N,
          f"{name}: handle_bulk_load wrote {written} rows through "
          f"{type(table).__name__}, the regions' bulk_ingest "
          f"{[p.rows for p in profiles]}, of {N}")
    log(f"{name}: handle_bulk_load of {N} rows into {len(profiles)} "
        f"region(s) in {ingest_s:.2f}s ({N / ingest_s / 1e6:.2f} Mrows/s), "
        f"then {wait_s:.2f}s waiting out background compaction; "
        f"{sst_summary(table)}")
    for rn, p in zip(table.regions, profiles):
        log(f"  region {rn} bulk_ingest: {p.describe()}")
    return table


def sql_edits(fe, table, ts, tags, fields, host_sids, eight, seed):
    """The write path after the load, through the frontend. Batch 1, by
    handle_row_insert (the protocol ingest path: WAL and memtable),
    overwrites three existing keys (the first host's first sample, two of
    Q3/Q4's hosts in the first hour) and puts one new key one interval
    past a spare host's last sample; ADMIN FLUSH TABLE writes it to an L0
    SST and ADMIN COMPACT TABLE compacts it into L1. Batch 2: one more
    overwrite by INSERT INTO ... VALUES, and a delete of batch 1's new key
    by MitoTable.delete, the call a SQL DELETE ends in (the SQL DELETE's
    key scan turns the key columns of every row into Python lists, about
    a minute at this size; the partitioned table runs it through SQL);
    both stay in the memtable, through the queries and the restart (WAL
    replay). Every overwrite
    sets all ten fields; `fields`, the brute force's copy, takes the same
    values, and the deleted key was never in it, so the row count and
    every run's length stay the load's. Returns the memtable's rows."""
    (region,) = table.regions.values()
    H, n = fields[CPU_FIELDS[0]].shape
    rng = np.random.default_rng(seed)
    first_h = int(np.argmin(host_sids))
    spare = [h for h in range(H) if h not in eight and h != first_h]
    extra = (spare[1], n)

    def key(h, j):
        k = {t: [tags[h][i]] for i, t in enumerate(TSBS_TAGS)}
        k["ts"] = [int(ts[j]) if j < n else int(ts[-1]) + INTERVAL_MS]
        return k

    def rows(keys):
        cols = {}
        for h, j in keys:
            row = key(h, j)
            new = rng.random(len(CPU_FIELDS)) * 100.0
            for f, v in zip(CPU_FIELDS, new):
                row[f] = [float(v)]
                if j < n:
                    fields[f][h, j] = v
            for c, v in row.items():
                cols.setdefault(c, []).extend(v)
        return cols

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    batch1 = rows([(first_h, 0), (int(eight[0]), 3), (int(eight[1]), 100),
                   extra])
    written, write_ms = timed(lambda: fe.handle_row_insert(
        table.info.name, batch1, tag_columns=TSBS_TAGS,
        timestamp_column="ts"))
    check(written == 4, f"handle_row_insert wrote {written} rows")
    def files():
        return {f.file_name: f for f in
                region.version_control.current.ssts.all_files()}

    before = files()
    _, flush_ms = timed(lambda: fe.do_query("ADMIN FLUSH TABLE cpu"))
    flushed = [f for k, f in files().items() if k not in before]
    check(len(flushed) == 1 and flushed[0].level == 0 and
          flushed[0].num_rows == written, f"the flush wrote {flushed}")
    _, compact_ms = timed(lambda: fe.do_query("ADMIN COMPACT TABLE cpu"))
    check(not region.version_control.current.ssts.levels[0],
          "the compaction left L0 files")
    batch2 = rows([(spare[0], 2000)])
    insert = (f"INSERT INTO cpu ({', '.join(batch2)}) VALUES "
              f"({', '.join(repr(v[0]) for v in batch2.values())})")
    (out,), insert_ms = timed(lambda: fe.do_query(insert))
    check(out.affected_rows == 1, f"INSERT affected {out.affected_rows}")
    deleted, delete_ms = timed(lambda: table.delete(key(*extra)))
    check(deleted == 1, f"MitoTable.delete deleted {deleted} rows")
    mem = region.version_control.current.memtables.mutable.num_rows
    check(mem == 2, f"the memtable holds {mem} rows after batch 2")
    log(f"write path: batch 1 ({written} rows: 3 overwrites, 1 new key) "
        f"through handle_row_insert in {write_ms:.1f} ms, ADMIN FLUSH "
        f"TABLE {flush_ms:.1f} ms, ADMIN COMPACT TABLE {compact_ms:.1f} ms; "
        f"batch 2: INSERT INTO cpu (1 overwrite) {insert_ms:.1f} ms, "
        f"MitoTable.delete of batch 1's new key {delete_ms:.1f} ms, both "
        f"left in the memtable; {sst_summary(table)}")
    return mem


class MomentsTimer:
    """Times each segment-moments launch inside the real statements and
    keeps each call's inputs. It hooks the sorted_grouped_aggregate of
    tpu_exec and of storage/downsample (the flow fold), whose arguments
    (the kernel's own) it keeps in `calls`, and the
    kernel's C launch entry (a function of the ctypes library that
    ops/cuda_build.py loads), which it fences behind a spin kernel queued
    after everything the Python wrapper does first: the wrapper's first
    allocations at a new size may synchronise the device (they did at
    34.56 M rows), so a spin queued before the wrapper could end before
    the launch. The CUDA events around the C call time the kernel alone.
    With `fenced` off the launches run as they are, untimed and unkept."""

    #: ~20 ms at 1980 MHz: covers one call. The first launch in a process
    #: loads the kernel's module and waits for the device, which no spin
    #: covers; phase 5 launches segment_moments before the SQL phases
    SPIN_CYCLES = 40_000_000
    #: a streamed slice's launch competes for the GIL with the prefetch
    #: workers' decode (33 ms seen at Q1 with the fence ahead of the
    #: Python wrapper)
    STREAM_SPIN_CYCLES = 240_000_000    # ~120 ms

    def __init__(self, torch):
        from greptimedb_tpu_torch.ops import kernels as K
        from greptimedb_tpu_torch.query import tpu_exec
        from greptimedb_tpu_torch.storage import downsample
        self.torch, self.lib = torch, K._lib()
        self.aggregate = tpu_exec.sorted_grouped_aggregate
        check(downsample.sorted_grouped_aggregate is self.aggregate,
              "the flow fold and the SQL path call different wrappers")
        self.entry = self.lib.segment_moments_launch
        self.pending, self.calls = [], []
        self.spin_cycles, self.fenced = self.SPIN_CYCLES, True

        def keep(gids, mask, ts, values, col_masks=(), **kw):
            if self.fenced:
                self.calls.append((kw["ends"], mask, ts, list(values),
                                   list(col_masks), list(kw["ops"])))
            return self.aggregate(gids, mask, ts, values, col_masks, **kw)

        def fence(*args):
            if not self.fenced:
                return self.entry(*args)
            cuda = self.torch.cuda
            e_spin, e0, e1 = (cuda.Event(enable_timing=True)
                              for _ in range(3))
            h0 = time.perf_counter()
            e_spin.record()
            cuda._sleep(self.spin_cycles)
            e0.record()
            out = self.entry(*args)
            e1.record()
            self.pending.append((e_spin, e0, e1, time.perf_counter() - h0))
            return out

        # the wrapper reads its entry's types (set by K._lib()) to know
        # they are set
        fence.argtypes, fence.restype = self.entry.argtypes, \
            self.entry.restype
        tpu_exec.sorted_grouped_aggregate = keep
        downsample.sorted_grouped_aggregate = keep
        self.lib.segment_moments_launch = fence

    def close(self):
        from greptimedb_tpu_torch.query import tpu_exec
        from greptimedb_tpu_torch.storage import downsample
        tpu_exec.sorted_grouped_aggregate = self.aggregate
        downsample.sorted_grouped_aggregate = self.aggregate
        self.lib.segment_moments_launch = self.entry

    def take(self):
        """(device ms of each launch since the last call, ms of the spins
        ahead of them)."""
        self.torch.cuda.synchronize()
        rows, spins = [], 0.0
        for e_spin, e0, e1, enqueue_s in self.pending:
            spin_ms = e_spin.elapsed_time(e0)
            check(enqueue_s * 1e3 < spin_ms, f"the launch took "
                  f"{enqueue_s * 1e3:.2f} ms to enqueue, longer than the "
                  f"{spin_ms:.2f} ms spin ahead of it")
            rows.append(e0.elapsed_time(e1))
            spins += spin_ms
        self.pending = []
        return rows, spins


def sql_queries(rng, hosts: int):
    """Q1-Q6: four TSBS queries and two shapes that reach every op."""
    t0 = TSBS_START_MS
    h = 3600_000
    eight = sorted(rng.choice(hosts, min(8, hosts), replace=False))
    inl = ", ".join(f"'host_{i}'" for i in eight)
    avg_all = ", ".join(f"avg({f})" for f in CPU_FIELDS)
    max_all = ", ".join(f"max({f})" for f in CPU_FIELDS)
    max5 = ", ".join(f"max({f})" for f in CPU_FIELDS[:5])
    return eight, {
        "Q1 double-groupby-all":
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{avg_all} FROM cpu WHERE ts >= {t0} AND ts < "
            f"{t0 + SQL_HOURS * h} GROUP BY hour, hostname ORDER BY hour, "
            f"hostname",
        "Q2 double-groupby-1":
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"avg(usage_user) FROM cpu WHERE ts >= {t0} AND ts < "
            f"{t0 + SQL_HOURS * h} GROUP BY hour, hostname ORDER BY hour, "
            f"hostname",
        "Q3 cpu-max-all-8":
            f"SELECT date_bin(INTERVAL '1 hour', ts) AS hour, hostname, "
            f"{max_all} FROM cpu WHERE hostname IN ({inl}) AND ts >= {t0} "
            f"AND ts < {t0 + 8 * h} GROUP BY hour, hostname ORDER BY hour, "
            f"hostname",
        "Q4 single-groupby-5-8-1":
            f"SELECT date_bin(INTERVAL '1 minute', ts) AS minute, hostname, "
            f"{max5} FROM cpu WHERE hostname IN ({inl}) AND ts >= {t0} AND "
            f"ts < {t0 + h} GROUP BY minute, hostname ORDER BY minute, "
            f"hostname",
        "Q5 per-host moments":
            "SELECT hostname, count(*), sum(usage_user), min(usage_user), "
            "max(usage_user), stddev(usage_user), first_value(usage_user), "
            "last_value(usage_user) FROM cpu GROUP BY hostname ORDER BY "
            "hostname",
        "Q6 global aggregate":
            "SELECT max(usage_user), avg(usage_system), "
            "first_value(usage_idle), last_value(usage_idle) FROM cpu",
    }


def sum_bound(S, A, c):
    """Bound on the port's float32 run sum of c float64 values with exact
    sum S and absolute sum A: each value rounds to float32 (u |x|), the
    run accumulates in float64 (c u64 A) and rounds once (u |S|)."""
    return U32 * A + U32 * np.abs(S) + 2 * c * U64 * A


def tie_hosts(table):
    """The hosts whose rows win the ts ties of first_value and last_value
    over all hosts: (first, last of the global fold, last of a grouped
    fold). Within a region rows tie in merged-scan order, which is
    series-id order. Across regions the fold of grouped partials sorts
    them by ts stably and keeps the first region's first and the last
    region's last, while the fold of one global row keeps the first
    region's partial for both (so does the reference's). Every host of a
    TSBS table has a sample at every ts, so these are the first region's
    lowest series id and the highest of the first and of the last
    region."""
    def ends(region):
        sd = region.series_dict
        names = sd.decode_tag_column(
            np.arange(sd.num_series, dtype=np.int32),
            TSBS_TAGS.index("hostname"))
        return int(str(names[0])[5:]), int(str(names[-1])[5:])

    regions = list(table.regions.values())
    (first, last_global), (_, last_grouped) = ends(regions[0]), \
        ends(regions[-1])
    return first, last_global, last_grouped


def sql_expected(name, ts, fields, ties, eight, partials=False):
    """The float64 brute force of one query: (frame of keys, exact
    columns and float columns with their bounds). Hosts sort as strings,
    as ORDER BY hostname does; `ties` is tie_hosts of the table.
    `partials`: the sums fold float32 partial sums of several streamed
    slices of a run, each rounded once more (at most u |x| summed over
    the run: one more U32 * A in each sum's bound)."""
    extra = U32 if partials else 0.0
    import pandas as pd
    H, n = fields["usage_user"].shape
    names = np.asarray([f"host_{i}" for i in range(H)])
    per_h = 3600_000 // INTERVAL_MS
    exact, approx = {}, {}

    def bucketed(hosts, nb, width, fns):
        keys_t = TSBS_START_MS + np.arange(nb, dtype=np.int64) * width * \
            INTERVAL_MS
        frame = {"t": np.repeat(keys_t, len(hosts)),
                 "hostname": np.tile(names[hosts], nb)}
        for col, (f, op) in fns.items():
            blk = fields[f][hosts, :nb * width].reshape(len(hosts), nb,
                                                        width)
            v = {"max": blk.max(axis=2), "avg": blk.mean(axis=2),
                 "sum": blk.sum(axis=2)}[op].T.ravel()
            frame[col] = v
            if op == "avg":
                S = blk.sum(axis=2).T.ravel()
                frame[f"__bound:{col}"] = (sum_bound(S, S, width) +
                                           extra * S) / width + \
                    4 * U64 * np.abs(v)
            else:
                exact[col] = True
        return pd.DataFrame(frame)

    if name.startswith(("Q1", "Q2")):
        fs = CPU_FIELDS if name.startswith("Q1") else CPU_FIELDS[:1]
        df = bucketed(np.arange(H), SQL_HOURS, per_h,
                      {f"avg({f})": (f, "avg") for f in fs})
        df = df.rename(columns={"t": "hour"})
        keys = ["hour", "hostname"]
    elif name.startswith("Q3"):
        df = bucketed(np.asarray(eight), 8, per_h,
                      {f"max({f})": (f, "max") for f in CPU_FIELDS})
        df = df.rename(columns={"t": "hour"})
        keys = ["hour", "hostname"]
    elif name.startswith("Q4"):
        df = bucketed(np.asarray(eight), 60, 6,
                      {f"max({f})": (f, "max") for f in CPU_FIELDS[:5]})
        df = df.rename(columns={"t": "minute"})
        keys = ["minute", "hostname"]
    elif name.startswith(("Q5", "Q7")):
        X = fields["usage_user"]
        if name.startswith("Q5"):
            key = {"hostname": names}
            first, last = X[:, 0], X[:, -1]
        else:
            # one group per hour over every host: its first and last ts
            # tie across hosts
            key = {"hour": TSBS_START_MS + np.arange(SQL_HOURS) * 3600_000}
            first, last = X[ties[0], ::per_h], X[ties[2], per_h - 1::per_h]
            X = X.reshape(H, SQL_HOURS, per_h).transpose(1, 0, 2).reshape(
                SQL_HOURS, H * per_h)
        S = X.sum(axis=1)
        sq = (X * X).sum(axis=1)
        c = X.shape[1]
        var = X.var(axis=1, ddof=1)
        std = np.sqrt(var)
        # the fold: var = (sq - s^2/c) / (c - 1) in float64 from the
        # float32 run sums s and sq (on several regions, the float64 sum
        # of each region's float32 partial: the bounds hold, the values
        # being non-negative)
        es = sum_bound(S, S, c) + extra * S
        # the square's rounding
        esq = sum_bound(sq, sq, c) + U32 * sq + extra * sq
        var_err = (esq + (2 * es * np.abs(S) + es * es) / c) / (c - 1) + \
            8 * U64 * sq / (c - 1)
        df = pd.DataFrame({
            **key, "count(*)": np.full(len(S), c),
            "sum(usage_user)": S, "min(usage_user)": X.min(axis=1),
            "max(usage_user)": X.max(axis=1), "stddev(usage_user)": std,
            "first_value(usage_user)": first,
            "last_value(usage_user)": last})
        for col in ("count(*)", "min(usage_user)", "max(usage_user)",
                    "first_value(usage_user)", "last_value(usage_user)"):
            exact[col] = True
        df["__bound:sum(usage_user)"] = es
        df["__bound:stddev(usage_user)"] = np.minimum(
            np.sqrt(var_err), var_err / np.maximum(std, 1e-300)) + \
            4 * U64 * std
        keys = list(key)
    else:
        # one run of every row: its first and last ts tie across hosts
        first_h, last_h = ties[:2]
        S = fields["usage_system"].sum()
        N = H * n
        df = pd.DataFrame({
            "max(usage_user)": [fields["usage_user"].max()],
            "avg(usage_system)": [S / N],
            "first_value(usage_idle)": [fields["usage_idle"][first_h, 0]],
            "last_value(usage_idle)": [fields["usage_idle"][last_h, -1]]})
        exact.update({c: True for c in df.columns
                      if c != "avg(usage_system)"})
        df["__bound:avg(usage_system)"] = \
            (sum_bound(S, S, N) + extra * S) / N + 4 * U64 * S / N
        keys = []
    if keys:
        df = df.sort_values(keys, kind="stable").reset_index(drop=True)
        for k in keys:
            exact[k] = True
    # each bound travels beside its column through the sort
    for col in [c for c in df.columns if c.startswith("__bound:")]:
        approx[col.split(":", 1)[1]] = df.pop(col).to_numpy()
    return df, exact, approx


def compare_sql(name, got, want, exact, approx, f32=True):
    """Keys and counts exact; min, max, first and last equal to the
    float32 rounding of the float64 answer (to the answer itself when not
    `f32`: the streamed path's host reduction reads the stored float64
    values); sums, averages and stddev within their bounds. Returns the
    largest |err|/bound."""
    check(list(got.columns) == list(want.columns),
          f"{name}: columns {list(got.columns)} != {list(want.columns)}")
    check(len(got) == len(want), f"{name}: {len(got)} rows, want "
          f"{len(want)}")
    worst = 0.0
    for col in want.columns:
        g = got[col].to_numpy()
        w = want[col].to_numpy()
        if col in exact:
            if w.dtype.kind == "f" and f32:
                w = w.astype(np.float32).astype(np.float64)
            check(bool((g == w).all()), f"{name}: {col} differs at "
                  f"{int((g != w).sum())} rows (e.g. {g[g != w][:3]} vs "
                  f"{w[g != w][:3]})")
            continue
        b = np.broadcast_to(approx[col], w.shape)
        d = np.abs(g.astype(np.float64) - w)
        check(bool((d <= b).all()), f"{name}: {col} outside the bound at "
              f"{int((d > b).sum())} rows (max |err|/bound "
              f"{(d / b).max():.3g})")
        worst = max(worst, float((d / b).max()))
    return worst


def planted(name, got, want, approx, fields):
    """Wrong answers that the Q5 bounds must refuse: a sum 1 % high, a sum
    missing its first row, and stddev with divisor n (ddof 0)."""
    X = fields["usage_user"]
    n = X.shape[1]
    s = got["sum(usage_user)"].to_numpy()
    sd = got["stddev(usage_user)"].to_numpy()
    for what, col, v in [
            ("sum 1 % high", "sum(usage_user)", s * 1.01),
            ("sum without its first row", "sum(usage_user)", s - X[:, 0]),
            ("stddev with ddof 0", "stddev(usage_user)",
             sd * np.sqrt((n - 1) / n))]:
        nbad = int((np.abs(v - want[col].to_numpy()) > approx[col]).sum())
        check(nbad > 0, f"{name}: the bound passes a planted {what}")
        log(f"  planted {what}: fails at {nbad} of {len(v)} groups")


def sql_frame(out):
    import pandas as pd
    frames = [pd.DataFrame(b.to_pydict()) for b in out.batches]
    return pd.concat(frames, ignore_index=True)


class SqlFrontend:
    """The port's standalone frontend (build_standalone) over one data
    home, with the hooks phase 6 reads: each segment-moments launch fenced
    behind a spin kernel (MomentsTimer), the engine's fold and projection
    stages, and the wall of QueryEngine.execute inside each do_query (the
    frontend's own cost is the difference)."""

    def __init__(self, torch, data_home):
        from greptimedb_tpu_torch.query import ir
        self.torch, self.data_home = torch, data_home
        self.timer = MomentsTimer(torch)
        self.stage_s = {}
        self._finalize = ir._finalize
        ir._finalize = self._timed("finalize", ir._finalize)
        self.fe = None
        self.open()

    def _timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.stage_s[key] = self.stage_s.get(key, 0.0) + \
                time.perf_counter() - t0
            return out
        return run

    def open(self):
        """build_standalone on the data home; returns its seconds."""
        from greptimedb_tpu_torch.datanode import DatanodeOptions
        from greptimedb_tpu_torch.frontend import build_standalone
        t0 = time.perf_counter()
        # flows fold when phase 10 calls tick(), so that each fold is
        # timed: no background tick
        self.fe = build_standalone(DatanodeOptions(
            data_home=self.data_home, flow_tick_interval_s=0,
            device=DEVICE))
        seconds = time.perf_counter() - t0
        qe = self.fe.query_engine
        qe._finish_aggregate_frame = self._timed(
            "finish", qe._finish_aggregate_frame)
        qe.execute = self._timed("execute", qe.execute)
        return seconds

    def restart(self):
        """shutdown(), then build_standalone on the same data home."""
        self.fe.shutdown()
        self.fe = None
        return self.open()

    def close(self):
        from greptimedb_tpu_torch.query import ir
        self.timer.close()
        ir._finalize = self._finalize
        if self.fe is not None:
            self.fe.shutdown()

    def table(self, name):
        return self.fe.catalog.table("greptime", "public", name)

    def do(self, sql):
        (out,) = self.fe.do_query(sql)
        return out

    def execute(self, name, sql, run, table, path="resident"):
        """One statement through do_query on `table`; its wall, the
        frontend's share, dispatch decision, stages, counters and profile
        logged; every region checked to have taken `path` ("resident",
        "streamed" or "indexed-point") with its launches: one per region
        on the resident path, one per device slice on the streamed path,
        none on the indexed one. Returns the Output; `self.last` keeps
        the dispatch, profiles, launches, device ms, wall and peak."""
        from greptimedb_tpu_torch.common import exec_stats
        from greptimedb_tpu_torch.ops import kernels as K
        from greptimedb_tpu_torch.query import tpu_exec
        torch = self.torch
        if run.startswith("cold"):
            tpu_exec.SCAN_CACHE.clear()
        fenced = "unfenced" not in run
        self.timer.fenced = fenced
        self.timer.spin_cycles = MomentsTimer.STREAM_SPIN_CYCLES \
            if path == "streamed" else MomentsTimer.SPIN_CYCLES
        regions = list(self.table(table).regions.values())
        for r in regions:
            r.last_scan_profile = None
        self.stage_s.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        launched0 = K.segment_moments.launches
        t0 = time.perf_counter()
        with exec_stats.collect() as stats:
            out = self.do(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.segment_moments.launches - launched0
        peak = torch.cuda.max_memory_allocated() / 2**30
        st, cache, counters, profiles = {}, set(), {}, []
        for r in regions:
            p = r.last_scan_profile
            check(p is not None and p.path == path,
                  f"{name}: region {r.name} took "
                  f"{p.path if p is not None else 'no device path'}, "
                  f"not {path}")
            profiles.append(p)
            for k, v in p.stages.items():
                st[k] = st.get(k, 0.0) + v
            for k, v in p.counters.items():
                if k.startswith("cache_"):
                    cache.add(k[6:])
                else:
                    counters[k] = counters.get(k, 0) + v
        want = {"resident": len(regions),
                "streamed": counters.get("device_slices", 0),
                "indexed-point": 0}[path]
        check(launches == want, f"{name}: {launches} segment_moments "
              f"launches on the {path} path, not {want}")
        kernel, dev_ms = "", []
        if fenced:
            dev_ms, spins = self.timer.take()
            check(len(dev_ms) == launches, f"{name}: {len(dev_ms)} fenced "
                  f"launches timed, {launches} counted")
            if dev_ms:
                kernel = " kernel (device) " + (
                    " / ".join(f"{x:.4f}" for x in dev_ms) if
                    len(dev_ms) <= 4 else
                    f"{len(dev_ms)} launches, {min(dev_ms):.4f}-"
                    f"{max(dev_ms):.4f} each, {sum(dev_ms):.4f} in all") + \
                    f" ms behind {spins:.1f} ms of spins;"
        frontend_ms = (wall - self.stage_s.pop("execute")) * 1e3
        st.update(self.stage_s)
        tail = f" counters {counters};" if counters else ""
        log(f"{name} [{run}, {path}" +
            (f", cache {','.join(sorted(cache))}" if cache else "") +
            f"]: dispatch {stats.dispatch!r}; wall {wall * 1e3:.1f} ms "
            f"(do_query beyond QueryEngine.execute {frontend_ms:.2f} ms); "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st.items()) +
            f" ms;{kernel}{tail} {out.num_rows} rows; peak device memory "
            f"{peak:.2f} GiB ({peak - held:.2f} above the {held:.2f} held "
            f"before)")
        self.last = types.SimpleNamespace(
            dispatch=stats.dispatch, profiles=profiles, launches=launches,
            dev_ms=dev_ms, wall=wall, peak=peak - held, cache=cache)
        return out

    @contextlib.contextmanager
    def floor_pinned(self):
        """SET tpu_dispatch_min_rows = 0 through the frontend for one
        statement on a table below the adaptive dispatch floor, which each
        device query raises again (as the differential tests pin it), so
        that it runs on the card; the floor restored after."""
        from greptimedb_tpu_torch.query import tpu_exec
        saved = tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0]
        self.do("SET tpu_dispatch_min_rows = 0")
        try:
            yield
        finally:
            tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = \
                saved


@contextlib.contextmanager
def phase_sql(torch, seed):
    """SQL on the GPU through the port's standalone frontend
    (build_standalone → FrontendInstance.do_query) over a temporary data
    home removed at the end: CREATE TABLE, the load by handle_bulk_load,
    the write path (handle_row_insert, ADMIN FLUSH / COMPACT TABLE,
    INSERT, a DELETE), each query cold (scan cache empty), then warm, both
    with the launch fenced, then warm unfenced, with the wall, the
    frontend's share and the stages; results against a float64 brute
    force; then shutdown() with batch 2 unflushed and build_standalone on
    the same data home (catalog replay, table open, WAL replay), Q5
    again; then the partitioned table, the narrow-integer table and phase
    7. Yields, for phases 8, 10 and 12a on the same frontend and tables,
    the frontend (`sql`), the tables' data, the segment-moments launches
    of phases 6 and 7 and the kernel's inputs at Q1, Q4 and Q6."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.ops import kernels as K

    t_gen = time.perf_counter()
    ts, tags, fields = tsbs_cpu_table(seed + 2)
    H, n = fields["usage_user"].shape
    log(f"TSBS cpu-only table cpu: {H} hosts x {n} samples = {H * n} rows, "
        f"10 tags, 10 fields, {SQL_HOURS} h, made in "
        f"{time.perf_counter() - t_gen:.1f}s (seed {seed + 2})")
    data_home = tempfile.mkdtemp(prefix="chip_smoke_sql_")
    sql = None
    try:
        sql = SqlFrontend(torch, data_home)
        log(f"build_standalone(DatanodeOptions(data_home={data_home!r}, "
            f"device={DEVICE!r})); WAL backend of new regions: "
            f"{sql.fe.datanode.storage.config.wal_backend}")
        sql.do(sql_ddl("cpu", {f: "DOUBLE" for f in CPU_FIELDS}))
        table = sql_bulk_load(sql.fe, "cpu", ts, tags, fields)
        (region,) = table.regions.values()
        sd = region.series_dict
        names = sd.decode_tag_column(np.arange(sd.num_series,
                                               dtype=np.int32), 0)
        sid_of = {str(h): s for s, h in enumerate(names)}
        host_sids = np.array([sid_of[f"host_{h}"] for h in range(H)],
                             dtype=np.int32)
        eight, queries = sql_queries(np.random.default_rng(seed + 3), H)
        ties = tie_hosts(table)
        unflushed = sql_edits(sql.fe, table, ts, tags, fields, host_sids,
                              eight, seed + 4)
        host_tags = tags[:2]
        cpu_regions = [tg[1] for tg in tags]

        inputs, frames = {}, {}
        K.segment_moments.launches = 0
        for name, q in queries.items():
            # cold and warm with the launch fenced (its device time), then
            # warm unfenced: the wall and stages without the spin, which
            # the fetch would otherwise wait out. Q3 and Q4 filter 8 hosts:
            # cold (the cache empty) they take the SST index and launch
            # nothing; a whole-table query then fills the cache, as a
            # refreshing dashboard does, and their warm runs go resident
            point = name.startswith(("Q3", "Q4"))
            for run in (("cold", "fill", "warm", "warm unfenced") if point
                        else ("cold", "warm", "warm unfenced")):
                if run == "fill":
                    sql.execute(f"fill the cache before {name.split()[0]}",
                                FILL_CACHE, run, "cpu")
                    continue
                path = "indexed-point" if point and run == "cold" \
                    else "resident"
                out = sql.execute(name, q, run, "cpu", path=path)
                if run == "warm" or path == "indexed-point":
                    got = sql_frame(out)
                    if run == "warm":
                        frames[name] = got
                    want, exact, approx = sql_expected(
                        name, ts, fields, ties, eight)
                    # the indexed path reduces the stored float64 values
                    worst = compare_sql(name, got, want, exact, approx,
                                        f32=path == "resident")
                    log(f"  check {name} ({path}): {len(got)} rows vs the "
                        f"float64 brute force (write-path edits applied); "
                        f"keys, counts, min/max/first/last exact; max "
                        f"|err|/bound {worst:.3g}")
                    if path == "indexed-point":
                        check(sql.last.dispatch.startswith(
                            "indexed-point (sst index, 8 candidate series"),
                            f"{name}: dispatch {sql.last.dispatch!r}")
                    if name.startswith("Q5"):
                        planted(name, got, want, approx, fields)
            inputs[name.split()[0]] = sql.timer.calls[-1]
        streamed = sql_streamed_vs_resident(sql, queries, frames, ts, fields,
                                            ties, eight)
        # phase 8's copy of `cpu`: two fields, the write-path edits in
        # (phase 10 reads all ten)
        cpu = types.SimpleNamespace(
            ts=ts, regions=cpu_regions, usage_user=fields["usage_user"],
            usage_system=fields["usage_system"], extra={})

        # recovery: batch 2 is only in the WAL and the memtable
        open_s = sql.restart()
        (region,) = sql.table("cpu").regions.values()
        replayed = region.version_control.current.memtables.mutable.num_rows
        check(replayed == unflushed, f"the reopened memtable holds "
              f"{replayed} rows, batch 2 had {unflushed}")
        log(f"restart: shutdown(), then build_standalone on the same data "
            f"home (catalog replay, table open: manifest, series "
            f"dictionary, WAL replay of {replayed} rows) in "
            f"{open_s * 1e3:.1f} ms; {sst_summary(sql.table('cpu'))}")
        q5 = next(q for q in queries if q.startswith("Q5"))
        got = sql_frame(sql.execute(q5, queries[q5], "cold, restarted",
                                    "cpu"))
        check(got.equals(frames[q5]), "Q5 after the restart differs from "
              "Q5 before it")
        log(f"  check {q5} after the restart: {len(got)} rows, every value "
            f"bit-equal to the frame before the shutdown")
        cols = sql_incremental(sql, q5, queries[q5], host_tags,
                               int(ts[-1]))
        extra_row = {}
        for i, t in enumerate(cols["ts"]):
            h = int(cols["hostname"][i][5:])
            u, v = cols["usage_user"][i], cols["usage_system"][i]
            if t == ts[0]:
                for f in CPU_FIELDS:
                    fields[f][h, 0] = cols[f][i]
            else:
                cpu.extra[h] = (u, v)
                extra_row = {"host": h, "ts": int(t),
                             **{f: cols[f][i] for f in CPU_FIELDS}}
        cpu_p = sql_partitioned(sql, seed + 6)
        fused = sql_fusion(sql, queries[q5])
        sql_narrow(sql, seed + 5)
        launches_24h, cpu_24h = sql_streamed_24h(sql, seed + 7)
        launches = K.segment_moments.launches
        want = 3 * len(queries) + streamed + 1 + 2 + \
            len(PART_QUERIES) * len(PART_RUNS) * PART_REGIONS + fused + \
            len(NARROW_QUERIES) + launches_24h
        check(launches == want,
              f"the SQL path launched segment_moments {launches} times, "
              f"not {want}")
        log(f"segment_moments launches during phases 6 and 7: {launches} "
            f"({len(queries)} queries x 3 (Q3 and Q4: 2 warm and a fill), "
            f"{streamed} streamed device slices on cpu, Q5 after the "
            f"restart, Q5 incremental and full, {len(PART_QUERIES)} queries "
            f"x {len(PART_RUNS)} runs x {PART_REGIONS} regions on cpu_p, "
            f"{fused} for 8 fused statements, {len(NARROW_QUERIES)} "
            f"narrow-integer queries, {launches_24h} streamed device slices "
            f"on cpu_24h)")
        st = types.SimpleNamespace(
            sql=sql, cpu=cpu, cpu_24h=cpu_24h, cpu_p=cpu_p,
            cpu_full=types.SimpleNamespace(ts=ts, tags=tags, fields=fields,
                                           extra=extra_row),
            queries=queries, ties=ties, eight=eight, launches=launches,
            inputs=inputs)
        # phase 8 alone reads cpu_24h's arrays; the caller drops them
        del cpu_24h
        yield st
    finally:
        if sql is not None:
            sql.close()
        shutil.rmtree(data_home, ignore_errors=True)


#: the whole-table query that warms the scan cache before Q3's and Q4's
#: warm runs
FILL_CACHE = "SELECT count(*) FROM cpu"
#: the queries run streamed on `cpu` and held against its resident
#: frames, with the streaming threshold set below its rows
STREAM_CHECKS = ("Q1 double-groupby-all", "Q5 per-host moments")
STREAM_CHECK_ROWS = 1_000_000


def sql_streamed_vs_resident(sql, queries, frames, ts, fields, ties, eight):
    """On `cpu` (12 h, batch 2 in the memtable): SET stream_threshold_rows
    = 1000000 streams it; Q1 and Q5 run streamed with the device
    reduction, each slice one segment_moments launch. Keys, counts,
    min/max/first/last equal to the resident frames; sums and the rest
    within the float64 brute force's bounds, widened by one float32
    rounding of each slice's partial sum. The threshold goes back to
    what it was. Returns the launches."""
    from greptimedb_tpu_torch.query import stream_exec
    launches = 0
    threshold = stream_exec.stream_threshold_rows()
    sql.do(f"SET stream_threshold_rows = {STREAM_CHECK_ROWS}")
    stream_exec.configure_streaming(cold_reduce="device")
    try:
        for name in STREAM_CHECKS:
            got = sql_frame(sql.execute(f"{name}, streamed", queries[name],
                                        "cold, device", "cpu",
                                        path="streamed"))
            check(sql.last.dispatch.startswith("streamed-cold (est_rows=")
                  and sql.last.launches > 0,
                  f"{name}: {sql.last.dispatch!r}, {sql.last.launches} "
                  f"launches")
            launches += sql.last.launches
            want, exact, approx = sql_expected(name, ts, fields, ties, eight,
                                               partials=True)
            worst = compare_sql(f"{name}, streamed", got, want, exact,
                                approx)
            res = frames[name]
            for col in exact:
                check(bool((got[col].to_numpy() == res[col].to_numpy())
                           .all()), f"{name}: streamed {col} differs from "
                      f"the resident frame")
            log(f"  check {name} streamed: {len(got)} rows, keys, counts, "
                f"min/max/first/last equal to the resident frame; max "
                f"|err|/bound {worst:.3g} against the brute force")
    finally:
        sql.do(f"SET stream_threshold_rows = {threshold}")
        stream_exec.configure_streaming(cold_reduce="host")
    return launches


def sql_incremental(sql, name, q5, host_tags, t_last):
    """The scan cache's incremental merge on the resident `cpu`: one
    handle_row_insert (an overwrite of two hosts' first samples, one new
    sample past the end), then Q5, whose cache entry takes in only the
    delta (outcome "incremental"); then SCAN_CACHE.clear() and Q5 again
    (outcome "full"). The two frames must be bit-equal. Returns the
    rows written."""
    from greptimedb_tpu_torch.query import tpu_exec
    rng = np.random.default_rng(len(host_tags))
    keys = [(host_tags[0], TSBS_START_MS), (host_tags[1], TSBS_START_MS),
            (host_tags[1], t_last + INTERVAL_MS)]
    cols = {}
    for tg, t in keys:
        for i, tag in enumerate(TSBS_TAGS):
            cols.setdefault(tag, []).append(tg[i])
        cols.setdefault("ts", []).append(t)
        for f in CPU_FIELDS:
            cols.setdefault(f, []).append(float(rng.random() * 100.0))
    check(tpu_exec.SCAN_CACHE.cached(sql.table("cpu").regions[0]),
          "cpu is not in the scan cache before the insert")
    written = sql.fe.handle_row_insert("cpu", cols, tag_columns=TSBS_TAGS,
                                       timestamp_column="ts")
    check(written == len(keys), f"handle_row_insert wrote {written} rows")
    inc = sql_frame(sql.execute(f"{name}, incremental", q5, "warm", "cpu"))
    inc_ms = sql.last.profiles[0].stages["scan_prep"] * 1e3
    check(sql.last.cache == {"incremental"},
          f"the scan cache's outcome was {sql.last.cache}")
    full = sql_frame(sql.execute(f"{name}, full rebuild", q5, "cold", "cpu"))
    full_ms = sql.last.profiles[0].stages["scan_prep"] * 1e3
    check(sql.last.cache == {"full"},
          f"the scan cache's outcome was {sql.last.cache}")
    check(inc.equals(full), "Q5 over the incremental merge differs from "
          "Q5 over the full rebuild")
    log(f"  check {name} after handle_row_insert of {written} rows: the "
        f"incremental merge (scan_prep {inc_ms:.1f} ms) and the full "
        f"rebuild (scan_prep {full_ms:.1f} ms) give bit-equal frames")
    return cols


#: the partitioned table: TSBS cpu-only at 400 hosts (its only difference
#: from the main table that matters here is its region count)
PART_HOSTS = 400
PART_REGIONS = 4
PART_QUERIES = ("Q1 double-groupby-all", "Q5 per-host moments",
                "Q6 global aggregate", "Q7 hourly moments")
#: Q5's moments per hour over every host: each group folds the partials
#: of all the regions
HOURLY_MOMENTS = (
    "SELECT date_bin(INTERVAL '1 hour', ts) AS hour, count(*), "
    "sum(usage_user), min(usage_user), max(usage_user), stddev(usage_user), "
    "first_value(usage_user), last_value(usage_user) FROM cpu GROUP BY hour "
    "ORDER BY hour")
PART_RUNS = ("cold", "warm", "warm unfenced")


def sql_partitioned(sql, seed):
    """Table cpu_p: TSBS cpu-only at PART_HOSTS hosts x 12 h,
    PARTITION BY RANGE COLUMNS (hostname) into PART_REGIONS regions of
    about equal host counts, loaded by handle_bulk_load; one key past the
    load put by INSERT and removed by DELETE ... WHERE, both SQL (the
    DELETE's key scan timed); PART_QUERIES cold and warm with the
    launches fenced, then warm unfenced, one segment-moments launch per
    region, the partial moments merged across regions on the host, every
    group against the float64 brute force. Q1 and Q5 group by host, so
    each group lies in one region; Q6 and Q7 fold every group from the
    partials of all the regions, first_value and last_value breaking ts
    ties across them. Returns phase 8's copy of the table: ts, each host's
    region, usage_user and usage_system, and phase 10's: every host's tags
    and every field (the INSERT and DELETE leave the load's rows)."""
    ts, tags, fields = tsbs_cpu_table(seed, hosts=PART_HOSTS)
    H, n = fields["usage_user"].shape
    names = sorted(f"host_{h}" for h in range(H))
    bounds = [f"'{names[k * H // PART_REGIONS]}'"
              for k in range(1, PART_REGIONS)] + ["MAXVALUE"]
    partition = " PARTITION BY RANGE COLUMNS (hostname) (" + ", ".join(
        f"PARTITION r{i} VALUES LESS THAN ({b})"
        for i, b in enumerate(bounds)) + ")"
    log(f"partitioned table cpu_p: {H} hosts x {n} samples = {H * n} rows "
        f"(seed {seed}), {partition.strip()}")
    sql.do(sql_ddl("cpu_p", {f: "DOUBLE" for f in CPU_FIELDS}, partition))
    table = sql_bulk_load(sql.fe, "cpu_p", ts, tags, fields)
    check(len(table.regions) == PART_REGIONS,
          f"cpu_p has {len(table.regions)} regions")
    for rn, r in table.regions.items():
        log(f"  region {rn}: {r.series_dict.num_series} hosts, "
            f"{sum(f.num_rows for f in r.version_control.current.ssts.all_files())}"
            f" rows")
    k = {t: tags[1][i] for i, t in enumerate(TSBS_TAGS)}
    k["ts"] = int(ts[-1]) + INTERVAL_MS
    out = sql.do(f"INSERT INTO cpu_p ({', '.join(k)}, usage_user) VALUES "
                 f"({', '.join(repr(v) for v in k.values())}, 50.0)")
    check(out.affected_rows == 1, f"INSERT affected {out.affected_rows}")
    t0 = time.perf_counter()
    out = sql.do(f"DELETE FROM cpu_p WHERE hostname = '{k['hostname']}' "
                 f"AND ts = {k['ts']}")
    delete_s = time.perf_counter() - t0
    check(out.affected_rows == 1, f"DELETE affected {out.affected_rows}")
    log(f"cpu_p: INSERT of one key past the load, then DELETE ... WHERE "
        f"through SQL in {delete_s:.2f}s (delete_matching_rows scans the "
        f"key columns of all {H * n + 1} rows into Python lists); "
        f"{out.affected_rows} row deleted")
    eight, queries = sql_queries(np.random.default_rng(seed + 1), H)
    queries["Q7 hourly moments"] = HOURLY_MOMENTS
    ties = tie_hosts(table)
    for name in PART_QUERIES:
        q = re.sub(r"\bFROM cpu\b", "FROM cpu_p", queries[name])
        for run in PART_RUNS:
            with sql.floor_pinned():
                out = sql.execute(f"{name} on cpu_p", q, run, "cpu_p")
        got = sql_frame(out)
        want, exact, approx = sql_expected(name, ts, fields, ties, eight)
        worst = compare_sql(f"{name} on cpu_p", got, want, exact, approx)
        log(f"  check {name} on cpu_p: {len(got)} rows merged from "
            f"{PART_REGIONS} regions' moments (one launch each) vs the "
            f"float64 brute force; keys, counts, min/max/first/last exact; "
            f"max |err|/bound {worst:.3g}")
    return types.SimpleNamespace(
        ts=ts, regions=[tg[1] for tg in tags],
        usage_user=fields["usage_user"], usage_system=fields["usage_system"],
        extra={}, tags=tags, fields=fields, partition=partition)


#: statements that run Q5 together on cpu_p for the fusion check
FUSED = 8


def _counter(name):
    """A port Prometheus counter's value (0 before its first bump)."""
    from greptimedb_tpu_torch.common import telemetry
    return sum(v for n, _, v, _ in telemetry.registry_snapshot()
               if n == f"greptime_{name}_total")


def sql_fusion(sql, q5):
    """FUSED threads start the same cold Q5 on cpu_p through do_query at
    once: each region's pass runs once (its leader's), the others adopt
    its moment frame; every frame equal. Returns the launches (one per
    region)."""
    import threading

    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.query import tpu_exec
    q = re.sub(r"\bFROM cpu\b", "FROM cpu_p", q5)
    tpu_exec.SCAN_CACHE.clear()
    sql.timer.fenced = False
    leaders, followers = _counter("scan_fusion_leader"), \
        _counter("scan_fusion_follower")
    launched0 = K.segment_moments.launches
    barrier = threading.Barrier(FUSED)
    frames, errors = [None] * FUSED, []

    def run(i):
        try:
            barrier.wait()
            frames[i] = sql_frame(sql.do(q))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    with sql.floor_pinned():
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(FUSED)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    check(not errors and all(not t.is_alive() for t in threads),
          f"fused statements failed: {errors[:2]}")
    launches = K.segment_moments.launches - launched0
    leaders = _counter("scan_fusion_leader") - leaders
    followers = _counter("scan_fusion_follower") - followers
    check(launches == PART_REGIONS and leaders == PART_REGIONS and
          followers == (FUSED - 1) * PART_REGIONS,
          f"{FUSED} fused Q5 on cpu_p: {launches} launches, {leaders} "
          f"leaders, {followers} followers")
    check(all(f.equals(frames[0]) for f in frames),
          "the fused statements' frames differ")
    log(f"scan fusion: {FUSED} threads ran Q5 on cpu_p cold at once in "
        f"{wall * 1e3:.1f} ms: {launches} segment_moments launches, "
        f"scan_fusion_leader +{leaders}, scan_fusion_follower "
        f"+{followers}; {FUSED} frames of {len(frames[0])} rows equal")
    return launches


#: the 24 h table's queries run again with the streamed device reduction
DEVICE_QUERIES = ("Q1", "Q5", "Q6")


def sql_streamed_24h(sql, seed):
    """Table cpu_24h: TSBS cpu-only at 4000 hosts x 24 h (34.56 M rows),
    `cpu`'s DDL and generator, loaded by one handle_bulk_load. Its
    estimated decoded size is over half the scan-cache budget, so every
    aggregate streams (the byte rule; its rows are under the row
    threshold) and the region never enters the cache. Q1-Q6 with TSBS's
    spans each run cold in the default "host" mode (Q3 and Q4 take the
    SST index), then Q1, Q5 and Q6 in "device" mode (one segment_moments
    launch per non-empty slice); every answer against the float64 brute
    force. Returns the launches and phase 8's copy of the table (ts, each
    host's region, usage_user and usage_system)."""
    from greptimedb_tpu_torch.query import stream_exec, tpu_exec
    log("== phase 7: the streamed cold path on TSBS cpu-only at 24 h")
    # the earlier tables' scans and launch inputs (the timing keeps its
    # three in phase_sql's `inputs`)
    tpu_exec.SCAN_CACHE.clear()
    sql.timer.calls.clear()
    t_gen = time.perf_counter()
    ts, tags, fields = tsbs_cpu_table(seed, hours=STREAM_HOURS)
    H, n = fields["usage_user"].shape
    log(f"TSBS cpu-only table cpu_24h: {H} hosts x {n} samples = {H * n} "
        f"rows, {STREAM_HOURS} h, made in "
        f"{time.perf_counter() - t_gen:.1f}s (seed {seed})")
    sql.do(sql_ddl("cpu_24h", {f: "DOUBLE" for f in CPU_FIELDS}))
    table = sql_bulk_load(sql.fe, "cpu_24h", ts, tags, fields)
    keep = types.SimpleNamespace(
        ts=ts, regions=[tg[1] for tg in tags],
        usage_user=fields["usage_user"], usage_system=fields["usage_system"],
        extra={})
    del tags
    (region,) = table.regions.values()
    rows = stream_exec.region_estimated_rows(region)
    nbytes = stream_exec.region_estimated_bytes(region)
    half = tpu_exec.SCAN_CACHE.budget_bytes // 2
    thr = stream_exec.stream_threshold_rows()
    check(rows == H * n and rows <= thr and nbytes > half and
          tpu_exec.region_streams_cold(region),
          f"cpu_24h: {rows} rows, {nbytes} bytes against {thr} rows and "
          f"{half} bytes")
    log(f"cpu_24h streams by the byte rule: estimated decoded size "
        f"{nbytes / 1e9:.3f} GB > half the scan-cache budget "
        f"{half / 1e9:.3f} GB (rows {rows} <= stream_threshold_rows {thr})")
    eight, queries = sql_queries(np.random.default_rng(seed + 1), H)
    ties = tie_hosts(table)
    launches = 0
    runs = [(name, "host") for name in queries] + \
        [(name, "device") for name in queries
         if name.split()[0] in DEVICE_QUERIES]
    for name, mode in runs:
        point = name.startswith(("Q3", "Q4"))
        q = re.sub(r"\bFROM cpu\b", "FROM cpu_24h", queries[name])
        stream_exec.configure_streaming(cold_reduce=mode)
        try:
            got = sql_frame(sql.execute(
                f"{name} on cpu_24h", q, f"cold, {mode}", "cpu_24h",
                path="indexed-point" if point else "streamed"))
        finally:
            stream_exec.configure_streaming(cold_reduce="host")
        d = sql.last.dispatch
        check(d.startswith("indexed-point (sst index, 8 candidate series")
              if point else d == f"streamed-cold (est_rows={rows}, "
              f"stream_threshold_rows={thr})", f"{name}: dispatch {d!r}")
        if mode == "device":
            check(sql.last.launches > 0, f"{name}: no device slice")
        launches += sql.last.launches
        want, exact, approx = sql_expected(name, ts, fields, ties, eight,
                                           partials=mode == "device")
        ties_note = ""
        if name.startswith("Q6"):
            # every host samples the first and the last ts: the fold of
            # slice partials keeps one of them (the first partial in
            # slice order with the extreme ts), which must be a sample
            # of that ts
            X = fields["usage_idle"]
            for col, cand in (("first_value(usage_idle)", X[:, 0]),
                              ("last_value(usage_idle)", X[:, -1])):
                if mode == "device":
                    cand = cand.astype(np.float32).astype(np.float64)
                g = float(got[col].iloc[0])
                check(bool((cand == g).any()), f"{name}: {col} {g} is no "
                      f"host's sample at that ts")
                want[col] = g
                ties_note += f"; {col}: host_{int(np.argmax(cand == g))}"
        worst = compare_sql(f"{name} on cpu_24h", got, want, exact, approx,
                            f32=mode == "device")
        log(f"  check {name} on cpu_24h ({mode}): {len(got)} rows vs the "
            f"float64 brute force; keys, counts, min/max/first/last exact; "
            f"max |err|/bound {worst:.3g}{ties_note}")
    check(not tpu_exec.SCAN_CACHE.cached(region),
          "cpu_24h entered the scan cache")
    errors = _counter("stream_device_stage_errors")
    check(errors == 0, f"stream_device_stage_errors {errors}")
    log(f"cpu_24h never entered the scan cache; stream_device_stage_errors "
        f"{errors:.0f}; {launches} segment_moments launches")
    return launches, keep


#: the narrow-integer table's fields: SQL type and the range each draws
#: from (SMALLINT near its top and INT UNSIGNED above 2^31 reach the wrap
#: of a sum and the float32 rounding of a value)
NARROW_FIELDS = {"i8": ("TINYINT", -128, 128),
                 "i16": ("SMALLINT", 20000, 30000),
                 "u32": ("INT UNSIGNED", 2**31, 2**32),
                 "u16": ("SMALLINT UNSIGNED", 0, 2**16)}
NARROW_OPS = ("count", "sum", "min", "max", "first_value", "last_value")
NARROW_QUERIES = {
    "by host": ("hostname, ", "GROUP BY hostname ORDER BY hostname"),
    "global": ("", ""),
}


def sql_narrow(sql, seed, hosts=64, samples=4096):
    """Table `nt` (TINYINT, SMALLINT, INT UNSIGNED, SMALLINT UNSIGNED
    fields) by CREATE TABLE and handle_bulk_load, count/sum/min/max/
    first_value/last_value of each, by host and over the whole table,
    held exactly against numpy with the reference's semantics: a sum wraps
    to the column's type within each run (a host here; every row in the
    global statement); first/last take the earliest/latest ts, ties by
    series id."""
    from greptimedb_tpu_torch.datatypes.data_type import parse_type_name
    rng = np.random.default_rng(seed)
    ts = TSBS_START_MS + np.arange(samples, dtype=np.int64) * INTERVAL_MS
    tags = [(f"host_{h}",) + ("x",) * (len(TSBS_TAGS) - 1)
            for h in range(hosts)]
    vals = {f: rng.integers(lo, hi, (hosts, samples)).astype(
        parse_type_name(t).np_dtype) for f, (t, lo, hi) in NARROW_FIELDS.items()}
    sql.do(sql_ddl("nt", {f: t for f, (t, _, _) in NARROW_FIELDS.items()}))
    table = sql_bulk_load(sql.fe, "nt", ts, tags, vals)
    (region,) = table.regions.values()
    sd = region.series_dict
    names = sd.decode_tag_column(np.arange(sd.num_series, dtype=np.int32), 0)
    order = np.argsort(np.array([f"host_{h}" for h in range(hosts)]))
    by_sid = np.array([int(str(h).split("_")[1]) for h in names])
    for q, (sel, group) in NARROW_QUERIES.items():
        aggs = ", ".join(f"{op}({f})" for op in NARROW_OPS
                         for f in NARROW_FIELDS)
        with sql.floor_pinned():
            got = sql_frame(sql.execute(
                f"narrow {q}", f"SELECT {sel}{aggs} FROM nt {group}", "cold",
                "nt"))
        wrapped = 0
        for f, x in vals.items():
            rows = x[order] if q == "by host" else x.reshape(1, -1)
            w = rows.astype(np.int64).sum(axis=1)
            want = {
                "count": np.full(len(rows), rows.shape[1]),
                "sum": w.astype(x.dtype),      # wraps to the type
                "min": rows.min(axis=1), "max": rows.max(axis=1),
                "first_value": x[order, 0] if q == "by host"
                else [x[by_sid[0], 0]],
                "last_value": x[order, -1] if q == "by host"
                else [x[by_sid[-1], -1]]}
            for op in NARROW_OPS:
                g = got[f"{op}({f})"].to_numpy().astype(np.float64)
                e = np.asarray(want[op]).astype(np.float64)
                check(g.shape == e.shape and bool((g == e).all()),
                      f"narrow {q}: {op}({f}) differs at "
                      f"{int((g != e).sum())} groups (e.g. "
                      f"{g[g != e][:2]} vs {e[g != e][:2]})")
            wrapped = max(wrapped, int((w != want["sum"]).sum()))
        check(wrapped > 0, f"narrow {q}: no sum wrapped")
        log(f"  check narrow {q}: {len(got)} rows x "
            f"{len(NARROW_OPS) * len(NARROW_FIELDS)} aggregates exact "
            f"against numpy (sums wrapped to their type in up to "
            f"{wrapped} groups of a column)")


# ---------------------------------------------------------------------------
# phase 8: the rest of the SQL surface
# ---------------------------------------------------------------------------

#: the sketch statements' span: the first hour of each table
SKETCH_SPAN_MS = 3600_000
#: HyperLogLog's standard error at the default precision (p = 14)
HLL_SE = 1.04 / np.sqrt(2.0 ** 14)
SKETCHES = (
    "SELECT region, approx_distinct(usage_user), "
    "approx_percentile(usage_user, 95), median(usage_system) FROM {t} "
    "WHERE ts >= {lo} AND ts < {hi} GROUP BY region ORDER BY region")
DISTINCT = ("SELECT region, count(DISTINCT hostname) FROM {t} WHERE "
            "ts >= {lo} AND ts < {hi} GROUP BY region ORDER BY region")
EXPRESSIONS = (
    "SELECT hostname, avg(usage_user + usage_system), sum(usage_user * 2) "
    "FROM {t} GROUP BY hostname ORDER BY hostname")
WINDOW = ("SELECT hostname, avg(usage_user) AS a, rank() OVER (ORDER BY "
          "avg(usage_user) DESC) AS rk FROM cpu GROUP BY hostname")
HOST_SUFFIX = "; host-partial moments (sketch/expr))"


class Surface:
    """Phase 8's statements through `sql`'s frontend: each one's wall,
    executed dispatch, segment_moments launches and the path its regions
    took, logged and kept in `walls`."""

    def __init__(self, sql):
        self.sql = sql
        self.walls = {}

    def run(self, label, text, table=None, path=None, launches=0):
        from greptimedb_tpu_torch.common import exec_stats
        from greptimedb_tpu_torch.ops import kernels as K
        regions = list(self.sql.table(table).regions.values()) \
            if table else []
        for r in regions:
            r.last_scan_profile = None
        n0 = K.segment_moments.launches
        t0 = time.perf_counter()
        with exec_stats.collect() as stats:
            out = self.sql.do(text)
        self.sql.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = K.segment_moments.launches - n0
        taken = sorted({r.last_scan_profile.path if r.last_scan_profile
                        else "none" for r in regions})
        if path is not None:
            check(taken == [path], f"{label}: regions took {taken}, not "
                  f"{path}")
        check(n == launches, f"{label}: {n} segment_moments launches, not "
              f"{launches}")
        self.walls[label] = wall
        # EXPLAIN ANALYZE collects into an ExecStats of its own, which the
        # engine keeps as its last
        self.dispatch = stats.dispatch
        if text.startswith("EXPLAIN ANALYZE"):
            self.dispatch = self.sql.fe.query_engine.last_exec_stats.dispatch
        log(f"{label}: wall {wall * 1e3:.1f} ms; dispatch "
            f"{self.dispatch!r}; regions {taken}; {n} launches; "
            f"{out.num_rows} rows")
        return out


def _rank_ok(vals_sorted, x, p):
    """Whether x sits at rank p/100 (within 1 %) of the sorted values."""
    n = len(vals_sorted)
    lo = np.searchsorted(vals_sorted, x, side="left") / n
    hi = np.searchsorted(vals_sorted, x, side="right") / n
    q = p / 100.0
    return lo <= q + 0.01 and hi >= q - 0.01, (lo + hi) / 2


def check_sketches(label, got, regions_of, X_user, X_sys, width):
    """Per region: approx_distinct within 3 HLL standard errors of the
    exact distinct count, approx_percentile(usage_user, 95) and
    median(usage_system) at their ranks within 1 %. Returns the worst
    distinct error in standard errors and the worst rank error."""
    names = sorted(set(regions_of))
    check(list(got["region"]) == names, f"{label}: regions "
          f"{list(got['region'])}")
    worst_se, worst_rank = 0.0, 0.0
    for i, r in enumerate(names):
        hosts = np.array([h for h, rr in enumerate(regions_of) if rr == r])
        u = X_user[hosts, :width].ravel()
        s = X_sys[hosts, :width].ravel()
        exact = len(np.unique(u))
        est = int(got["approx_distinct(usage_user)"].iloc[i])
        err = abs(est - exact) / exact / HLL_SE
        check(err <= 3, f"{label}: {r}: approx_distinct {est} vs exact "
              f"{exact} ({err:.2f} standard errors)")
        worst_se = max(worst_se, err)
        for c, vals, p in (("approx_percentile(usage_user, 95)", u, 95),
                           ("median(usage_system)", s, 50)):
            ok, rank = _rank_ok(np.sort(vals), float(got[c].iloc[i]), p)
            check(ok, f"{label}: {r}: {c} {got[c].iloc[i]} sits at rank "
                  f"{rank:.4f}, not {p / 100:.2f} within 0.01")
            worst_rank = max(worst_rank, abs(rank - p / 100))
    return worst_se, worst_rank


def host_sums(t, fn):
    """Per host, in ORDER BY hostname order: (exact sum in long double,
    sum of |x|, count) of x = fn(usage_user, usage_system) over the host's
    rows, `t.extra`'s samples past the end included."""
    H = t.usage_user.shape[0]
    x = fn(t.usage_user, t.usage_system)
    S = x.astype(np.longdouble).sum(axis=1)
    A = np.abs(x).sum(axis=1)
    c = np.full(H, x.shape[1])
    for h, (u, v) in t.extra.items():
        e = fn(np.float64(u), np.float64(v))
        S[h] += e
        A[h] += abs(e)
        c[h] += 1
    order = np.argsort(np.array([f"host_{h}" for h in range(H)]))
    return S[order], A[order], c[order]


def check_expressions(label, got, t):
    """avg(usage_user + usage_system) and sum(usage_user * 2) per host
    against exact sums of the same float64 values (long double), each
    within 8 eps64 sum|x| (over c for the average)."""
    worst = 0.0
    for c, fn in (("avg(usage_user + usage_system)", lambda u, v: u + v),
                  ("sum(usage_user * 2)", lambda u, v: u * 2)):
        S, A, n = host_sums(t, fn)
        if c.startswith("avg"):
            want, b = (S / n).astype(np.float64), 8 * 2 * U64 * A / n
        else:
            want, b = S.astype(np.float64), 8 * 2 * U64 * A
        g = got[c].to_numpy(np.float64)
        d = np.abs(g - want)
        check(bool((d <= b).all()), f"{label}: {c} outside 8 eps64 sum|x| "
              f"at {int((d > b).sum())} hosts (max |err|/bound "
              f"{(d / b).max():.3g})")
        worst = max(worst, float((d / b).max()))
    return worst


#: flow/create_flow's folds: its two rollup-rewritten SELECTs each catch
#: their flow's one-region sink up first (one launch each); the other
#: goldens' tables are under the dispatch floor and launch nothing
GOLDEN_FOLDS = 2


def goldens(cases):
    """The sqlness cases through tools/sqlness.py on the card, each on a
    fresh frontend; the diffs of those that differ from their .result."""
    from greptimedb_tpu_torch.tools import sqlness
    failed = []
    for case in cases:
        err = sqlness.run_one(sqlness.CASES_DIR / f"{case}.sql",
                              device=DEVICE)
        if err is not None:
            failed.append(err)
    return failed


def phase_surface(sql, cpu, cpu_24h, cpu_p):
    """Phase 8 on the tables phases 6 and 7 loaded, through the same
    frontend: EXPLAIN and EXPLAIN ANALYZE of Q1 on cpu; the sketch
    aggregates over the first hour by region on cpu (resident host
    partials), cpu_24h (streamed) and cpu_p (4 regions folded);
    count(DISTINCT hostname) (the exact raw-row path); SET exact_distinct
    refused; the expression aggregates by host on cpu and cpu_24h;
    a window over an aggregate; SHOW / DESCRIBE / SHOW CREATE TABLE /
    information_schema.columns against the TSBS DDL; the standalone
    sqlness goldens on the card. `cpu`, `cpu_24h` and `cpu_p` carry each
    table's ts, its hosts' regions and its usage_user / usage_system
    (edits applied). Returns (segment_moments launches, walls)."""
    import pandas as pd

    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.tools import sqlness
    log("== phase 8: the rest of the SQL surface")
    s = Surface(sql)
    t_phase = time.perf_counter()
    K.segment_moments.launches = 0
    sql.timer.fenced = False

    # EXPLAIN / EXPLAIN ANALYZE of Q1
    H = cpu.usage_user.shape[0]
    q1 = sql_queries(np.random.default_rng(0), H)[1][
        "Q1 double-groupby-all"]
    plan = sql_frame(s.run("EXPLAIN Q1", "EXPLAIN " + q1))["plan"].iloc[0]
    lines = plan.splitlines()
    check(lines[0].startswith("TpuAggregateExec: groups=[hostname, "
                              "time_bucket(3600000ms)] aggs=[avg")
          and lines[1] == "  Dispatch: device-resident (scan cache)",
          f"EXPLAIN Q1: {plan!r}")
    with sql.floor_pinned():
        ana = sql_frame(s.run("EXPLAIN ANALYZE Q1 (cold)",
                              "EXPLAIN ANALYZE " + q1, "cpu", "resident",
                              launches=1))
    stages = list(ana["stage"])
    check(stages[0] == "plan" and ana["detail"].iloc[0] == plan,
          f"EXPLAIN ANALYZE Q1: plan row {ana.iloc[0].to_dict()}")
    executed = ana["detail"].iloc[stages.index("dispatch")]
    check(lines[1] == "  Dispatch: " + executed and
          executed == s.dispatch, f"EXPLAIN says {lines[1]!r}, the "
          f"statement ran {executed!r} / {s.dispatch!r}")
    check(ana["rows"].iloc[0] == H * SQL_HOURS and
          {"scan_prep", "reduce", "finalize", "project"} <= set(stages),
          f"EXPLAIN ANALYZE Q1: {stages}, {ana['rows'].iloc[0]} rows")
    log(f"  EXPLAIN ANALYZE Q1: stages {stages}; the plan row first, "
        f"its dispatch line the executed one")

    # the sketch aggregates over the first hour, by region
    width = SKETCH_SPAN_MS // INTERVAL_MS
    for table, t, path in (("cpu", cpu, "resident"),
                           ("cpu_24h", cpu_24h, "streamed"),
                           ("cpu_p", cpu_p, "resident")):
        lo = int(t.ts[0])
        text = SKETCHES.format(t=table, lo=lo, hi=lo + SKETCH_SPAN_MS)
        with sql.floor_pinned():
            got = sql_frame(s.run(f"sketches on {table}", text, table,
                                  path))
        check(s.dispatch.endswith(HOST_SUFFIX), f"sketches on {table}: "
              f"dispatch {s.dispatch!r}")
        se, rank = check_sketches(f"sketches on {table}", got, t.regions,
                                  t.usage_user, t.usage_system, width)
        log(f"  check sketches on {table}: {len(got)} regions; "
            f"approx_distinct within {se:.2f} standard errors of the exact "
            f"count, percentiles within {rank:.4f} of their ranks")
        if table == "cpu_24h":
            # count(DISTINCT) is not lowered: its raw-row path would pull
            # the streamed table into the scan cache whole
            continue
        text = DISTINCT.format(t=table, lo=lo, hi=lo + SKETCH_SPAN_MS)
        got = sql_frame(s.run(f"count(DISTINCT hostname) on {table}",
                              text))
        want = pd.Series(t.regions).value_counts().sort_index()
        check(s.dispatch == "cpu-fallback" and
              list(got["region"]) == list(want.index) and
              list(got.iloc[:, 1]) == list(want.to_numpy()),
              f"count(DISTINCT hostname) on {table}: {got.to_dict()} "
              f"({s.dispatch!r})")
        log(f"  check count(DISTINCT hostname) on {table}: exact per "
            f"region (the raw-row path, as in the reference)")
    # SET exact_distinct acts only on the distributed pushdown, which the
    # port does not have: it is refused, and the sketches stand
    from greptimedb_tpu_torch.errors import UnsupportedError
    try:
        sql.do("SET exact_distinct = 1")
    except UnsupportedError as e:
        check("the distributed frontend is not ported" in str(e),
              f"SET exact_distinct: {e}")
    else:
        check(False, "SET exact_distinct = 1 was accepted")
    log("  check SET exact_distinct = 1: refused (UnsupportedError: it "
        "waits for the distributed frontend)")

    # expression aggregates by host
    for table, t, path in (("cpu", cpu, "resident"),
                           ("cpu_24h", cpu_24h, "streamed")):
        with sql.floor_pinned():
            got = sql_frame(s.run(f"expressions on {table}",
                                  EXPRESSIONS.format(t=table), table, path))
        check(s.dispatch.endswith(HOST_SUFFIX), f"expressions on {table}: "
              f"dispatch {s.dispatch!r}")
        worst = check_expressions(f"expressions on {table}", got, t)
        log(f"  check expressions on {table}: {len(got)} hosts within 8 "
            f"eps64 sum|x| of exact sums (max |err|/bound {worst:.3g})")

    # a window over an aggregate
    got = sql_frame(s.run("window over avg by host", WINDOW, "cpu"))
    check(s.dispatch == "cpu-fallback", f"window: {s.dispatch!r}")
    got = got.sort_values("hostname", kind="stable").reset_index(drop=True)
    S, A, n = host_sums(cpu, lambda u, v: u)
    want_a = (S / n).astype(np.float64)
    b = 8 * 2 * U64 * A / n
    d = np.abs(got["a"].to_numpy(np.float64) - want_a)
    check(bool((d <= b).all()), f"window: avg outside its bound at "
          f"{int((d > b).sum())} hosts")
    a = got["a"].to_numpy(np.float64)
    want_rk = np.array([(a > v).sum() + 1 for v in a])
    check(bool((got["rk"].to_numpy() == want_rk).all()),
          f"window: ranks differ at {int((got['rk'] != want_rk).sum())} "
          f"hosts")
    log(f"  check window: {len(got)} hosts, avg within 8 eps64 sum|x|/c, "
        f"rank() exactly numpy's min-rank of the returned averages "
        f"(a statement with a window is not lowered: the aggregate runs "
        f"on the CPU fallback, as in the reference)")

    # catalog statements against the TSBS DDL
    shown = set(sql_frame(s.run("SHOW TABLES", "SHOW TABLES"))["Tables"])
    check({"cpu", "cpu_24h", "cpu_p", "nt"} <= shown, f"SHOW TABLES {shown}")
    desc = sql_frame(s.run("DESCRIBE TABLE cpu", "DESCRIBE TABLE cpu"))
    want_cols = list(TSBS_TAGS) + ["ts"] + list(CPU_FIELDS)
    check(list(desc["Column"]) == want_cols and
          list(desc["Semantic Type"]) == ["TAG"] * 10 + ["TIMESTAMP"] +
          ["FIELD"] * 10 and
          list(desc["Type"]) == ["String"] * 10 +
          ["TimestampMillisecond"] + ["Float64"] * 10,
          f"DESCRIBE TABLE cpu: {desc.to_dict('list')}")
    ddl = sql_frame(s.run("SHOW CREATE TABLE cpu",
                          "SHOW CREATE TABLE cpu"))["Create Table"].iloc[0]
    check(ddl.startswith("CREATE TABLE IF NOT EXISTS cpu (") or
          ddl.startswith("CREATE TABLE cpu ("), f"SHOW CREATE: {ddl[:80]}")
    check(f"PRIMARY KEY ({', '.join(TSBS_TAGS)})" in ddl and
          "TIME INDEX (ts)" in ddl and
          all(f"  {c} " in ddl for c in want_cols), f"SHOW CREATE: {ddl}")
    cols = sql_frame(s.run(
        "information_schema.columns of cpu",
        "SELECT column_name, data_type, semantic_type FROM "
        "information_schema.columns WHERE table_name = 'cpu'"))
    check(list(cols["column_name"]) == want_cols and
          list(cols["semantic_type"]) == ["TAG"] * 10 + ["TIMESTAMP"] +
          ["FIELD"] * 10, f"information_schema.columns: "
          f"{cols.to_dict('list')}")
    log(f"  check catalog statements: SHOW TABLES has the four tables, "
        f"DESCRIBE / SHOW CREATE TABLE / information_schema.columns list "
        f"the TSBS DDL's {len(want_cols)} columns")

    # the standalone goldens on the card: tiny tables under the dispatch
    # floor, so none of them launches a kernel
    n0 = K.segment_moments.launches
    t0 = time.perf_counter()
    cases = [c for c in sqlness.IN_SCOPE if not c.startswith("tql/")]
    failed = goldens(cases)
    s.walls["goldens"] = time.perf_counter() - t0
    check(not failed, "goldens differ on the card:\n" + "\n".join(failed))
    n = K.segment_moments.launches - n0
    check(n == GOLDEN_FOLDS, f"the goldens launched segment_moments {n} "
          f"times, not {GOLDEN_FOLDS} (flow/create_flow's refresh folds)")
    log(f"goldens: {len(cases)} standalone sqlness cases (the tql/* ones "
        f"run in phase 9) through tools/sqlness.py on {DEVICE!r} "
        f"byte-equal to their .result in {s.walls['goldens']:.2f}s "
        f"({n} launches: flow/create_flow's refresh folds)")
    launches = K.segment_moments.launches
    check(launches == 1 + GOLDEN_FOLDS, f"phase 8 launched segment_moments "
          f"{launches} times, not {1 + GOLDEN_FOLDS} (EXPLAIN ANALYZE Q1 "
          f"and the goldens' folds)")
    s.walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 8: {launches} segment_moments launches; "
        f"{s.walls['phase']:.1f}s")
    return launches, s.walls


# ---------------------------------------------------------------------------
# phase 10: continuous rollup flows
# ---------------------------------------------------------------------------

#: the flows' stride: BASELINE config 5's 1 s → 1 m downsample and the
#: goldens' stride (a TSBS 10 s interval puts 6 samples in a bucket)
FLOW_STRIDE_MS = 60_000
FLOW_WIDTH = FLOW_STRIDE_MS // INTERVAL_MS
#: the flow's aggregates of every field: sink column suffix -> op
FLOW_AGGS = {"sum": "sum", "cnt": "count", "max": "max"}
#: minutes written to every host after the first fold
FLOW_NEW_MINUTES = 10
#: the cold fold's streaming threshold: each of cpu_p's regions is over it
FLOW_COLD_THRESHOLD = 100_000
#: the queries the rollup rewrite serves, and those it must leave alone
REWRITTEN = ("Q1 double-groupby-all", "Q2 double-groupby-1",
             "Q3 cpu-max-all-8", "Q4 single-groupby-5-8-1")
NOT_REWRITTEN = ("Q5 per-host moments", "Q6 global aggregate")


def flow_ddl(name, source):
    """CREATE FLOW over a TSBS table: every tag, the 1 m bucket, and sum,
    count and max of each field."""
    aggs = ", ".join(f"{op}({f}) AS {f}_{sfx}" for f in CPU_FIELDS
                     for sfx, op in FLOW_AGGS.items())
    tags = ", ".join(TSBS_TAGS)
    return (f"CREATE FLOW {name} AS SELECT {tags}, date_bin(INTERVAL "
            f"'1 minute', ts) AS b, {aggs} FROM {source} GROUP BY {tags}, b")


def flow_brute(fields, tail=None):
    """The float64 brute force of a flow's sink over a TSBS table's
    fields ([H, n], n a whole number of buckets), then `tail` ({field:
    [H, k * FLOW_WIDTH]} of the samples after them, NaN where a host has
    none): {column: [H, buckets]} of each field's sum, count, max and
    sum of |x|, and `present`, where a bucket holds a sample."""
    out = {}
    for f in CPU_FIELDS:
        x = fields[f]
        H = x.shape[0]
        x = x.reshape(H, -1, FLOW_WIDTH)
        if tail is not None:
            x = np.concatenate(
                [x, tail[f].reshape(H, -1, FLOW_WIDTH)], axis=1)
        live = ~np.isnan(x)
        out[f"{f}_cnt"] = live.sum(axis=2).astype(np.float64)
        out[f"{f}_sum"] = np.nansum(x, axis=2)
        out[f"{f}_abs"] = np.nansum(np.abs(x), axis=2)
        out[f"{f}_max"] = np.where(live.any(axis=2),
                                   np.where(live, x, -np.inf).max(axis=2),
                                   np.nan)
        out["present"] = live.any(axis=2)     # the same for every field
    return out


def check_sink(label, table, tags, want, device_fold, min_bucket=0):
    """Every sink row with bucket >= `min_bucket` against the brute
    force: the row set equal, the ten tags those of the row's host,
    counts exact, max equal to the float32 max (the device fold reduces
    float32 mirrors) or to the float64 max (the host fold), sums within
    8 eps32 sum|x|. Returns the rows checked."""
    (region,) = table.regions.values()
    data = region.snapshot().read_merged()
    sd = data.series_dict
    every = np.arange(sd.num_series, dtype=np.int32)
    per_tag = [sd.decode_tag_column(every, i) for i in range(len(TSBS_TAGS))]
    host_of = np.array([int(str(h)[5:]) for h in per_tag[0]], dtype=np.int64)
    for s in range(sd.num_series):
        got = tuple(str(col[s]) for col in per_tag)
        check(got == tuple(tags[host_of[s]]),
              f"{label}: series {s} has tags {got}, its host "
              f"{tags[host_of[s]]}")
    hosts = host_of[data.series_ids]
    b = (data.ts - TSBS_START_MS) // FLOW_STRIDE_MS
    keep = b >= min_bucket
    hosts, b = hosts[keep], b[keep]
    present = want["present"].copy()
    present[:, :min_bucket] = False
    check(bool((b < present.shape[1]).all()) and
          bool(present[hosts, b].all()) and len(b) == int(present.sum()),
          f"{label}: {len(b)} sink rows, the brute force has "
          f"{int(present.sum())} buckets")
    worst = 0.0
    for f in CPU_FIELDS:
        for sfx in FLOW_AGGS:
            vals, valid = data.fields[f"{f}_{sfx}"]
            g = vals[keep].astype(np.float64)
            check(valid is None or bool(valid[keep].all()),
                  f"{label}: {f}_{sfx} has nulls")
            w = want[f"{f}_{sfx}"][hosts, b]
            if sfx == "sum":
                bnd = 8 * U32 * want[f"{f}_abs"][hosts, b]
                d = np.abs(g - w)
                check(bool((d <= bnd).all()), f"{label}: {f}_sum outside "
                      f"8 eps32 sum|x| at {int((d > bnd).sum())} rows")
                worst = max(worst, float((d / np.maximum(bnd, 1e-300))
                                         .max()))
                continue
            if sfx == "max" and device_fold:
                w = w.astype(np.float32).astype(np.float64)
            check(bool((g == w).all()), f"{label}: {f}_{sfx} differs at "
                  f"{int((g != w).sum())} rows (e.g. {g[g != w][:3]} vs "
                  f"{w[g != w][:3]})")
    log(f"  check {label}: {len(b)} sink rows vs the float64 brute force: "
        f"the row set, ten tags, counts and max exact, sums within 8 eps32 "
        f"sum|x| (max |err|/bound {worst:.3g})")
    return len(b)


def fold_log(label, prof, wall, dev_ms):
    """One fold's wall and stages (the region's last_scan_profile)."""
    stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in prof.stages.items())
    kernel = f"; kernel (device) {' / '.join(f'{x:.4f}' for x in dev_ms)} " \
        f"ms" if dev_ms else ""
    log(f"{label}: wall {wall * 1e3:.1f} ms ({prof.path}: {stages} ms; "
        f"counters {prof.counters}){kernel}")


def timed_tick(sql, fenced):
    """FlowManager.tick() with each launch fenced (or not); returns (flow
    key -> buckets written, wall seconds, launches, device ms)."""
    from greptimedb_tpu_torch.ops import kernels as K
    torch = sql.torch
    sql.timer.fenced = fenced
    sql.timer.spin_cycles = MomentsTimer.SPIN_CYCLES
    torch.cuda.synchronize()
    n0 = K.segment_moments.launches
    t0 = time.perf_counter()
    written = sql.fe.datanode.flow_manager.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = sql.timer.take()[0] if fenced else []
    sql.timer.fenced = False
    return written, wall, K.segment_moments.launches - n0, dev_ms


def phase_flows(sql, cpu, cpu_p, queries, ties, eight):
    """Phase 10 on the tables phases 6 and 7 loaded, through the same
    frontend (its flows fold only when tick() is called): CREATE FLOW on
    cpu and its first fold (one segment_moments launch), every sink row
    against the float64 brute force; the rollup rewrite of Q1-Q4 against
    their raw answers and the brute force, Q5 and Q6 left alone; 10 more
    minutes for every host and the incremental fold; a flow on cpu_p
    folded on the host (each region over the streaming threshold); SHOW
    FLOWS, information_schema.flows and the flow gauges; ADMIN FLUSH the
    sinks, a restart, and a tick that folds nothing. `cpu` carries ts,
    every host's tags, every field with the edits, and the one sample
    past the load; `cpu_p` the partitioned table's. Returns the phase's
    launches, walls and the first fold's launch inputs."""
    from greptimedb_tpu_torch.common import exec_stats
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.query import stream_exec, tpu_exec
    log("== phase 10: continuous rollup flows")
    t_phase = time.perf_counter()
    K.segment_moments.launches = 0
    walls = {}
    H, n = cpu.fields[CPU_FIELDS[0]].shape
    key, key_p = "greptime.public.cpu_1m", "greptime.public.cpu_p_1m"

    # 1. CREATE FLOW and the first fold, the scan cache cold
    t0 = time.perf_counter()
    sql.do(flow_ddl("cpu_1m", "cpu"))
    log(f"CREATE FLOW cpu_1m (10 tags, 1 minute, sum/count/max of the 10 "
        f"fields: 30 sink columns) in {(time.perf_counter() - t0) * 1e3:.1f}"
        f" ms")
    fm = sql.fe.datanode.flow_manager
    tpu_exec.SCAN_CACHE.clear()
    (region,) = sql.table("cpu").regions.values()
    check(not tpu_exec.region_streams_cold(region),
          "cpu streams cold: the fold would not take the device route")
    written, wall, launches, dev_ms = timed_tick(sql, fenced=True)
    walls["first fold"] = wall
    fold_inputs = sql.timer.calls[-1]
    fold_log(f"first fold of cpu ({H * n + 1} rows)",
             region.last_scan_profile, wall, dev_ms)
    check(region.last_scan_profile.path == "flow-fold" and launches == 1,
          f"the first fold took {region.last_scan_profile.path} with "
          f"{launches} launches, not the device route with one")
    nb = n // FLOW_WIDTH
    check(written == {key: H * nb + 1}, f"the first fold wrote {written}, "
          f"not {H * nb + 1} buckets")
    spec = fm.flows()[0]
    check(spec.stats["rows_folded"] == H * n + 1,
          f"rows_folded {spec.stats['rows_folded']}, not {H * n + 1}")
    # the sample past the load: host extra["host"], one bucket of its own
    x = cpu.extra
    check(x["ts"] == int(cpu.ts[-1]) + INTERVAL_MS,
          f"the sample past the load is at {x['ts']}")
    tail = {f: np.full((H, FLOW_WIDTH), np.nan) for f in CPU_FIELDS}
    for f in CPU_FIELDS:
        tail[f][x["host"], 0] = x[f]
    want = flow_brute(cpu.fields, tail)
    t0 = time.perf_counter()
    check_sink("first fold", sql.table("cpu_1m"), cpu.tags, want,
               device_fold=True)
    del want
    walls["first fold check"] = time.perf_counter() - t0

    # 3. the rollup rewrite (step 2, the launch against the plain version,
    # runs after the phase on `fold_inputs`). Both sides run with the
    # dispatch floor pinned at 0: the first rewritten statement builds
    # the sink's scan cache, and the adaptive floor it then sets (its
    # time, capped at 0.5 s, at 15 M rows/s: 7.5 M rows) would send the
    # 2.88 M-row sink to the pandas path (8.0 s for Q1 in my first run)
    sink = next(iter(sql.table("cpu_1m").regions.values()))
    for name in REWRITTEN:
        q = queries[name]
        plan = sql_frame(sql.do("EXPLAIN " + q))["plan"][0]
        check("Dispatch: rollup-rewrite (flow cpu_1m: cpu -> cpu_1m, "
              "stride 60000ms -> " in plan and "TableScan: cpu_1m" in plan,
              f"{name}: EXPLAIN {plan!r}")
        runs = {}
        for label, on in (("rewritten", 1), ("raw", 0)):
            sql.do(f"SET rollup_rewrite = {on}")
            read = sink if on else region
            for run in ("first", "warm"):
                read.last_scan_profile = None
                n0 = K.segment_moments.launches
                t0 = time.perf_counter()
                with exec_stats.collect() as st, sql.floor_pinned():
                    out = sql.do(q)
                prof = read.last_scan_profile
                runs[label, run] = (time.perf_counter() - t0,
                                    st.dispatch or "",
                                    K.segment_moments.launches - n0,
                                    prof.path if prof else "cpu")
            rewritten = runs[label, "warm"][1].startswith(
                "rollup-rewrite (flow cpu_1m")
            check(rewritten == bool(on),
                  f"{name} ({label}): dispatch {runs[label, 'warm'][1]!r}")
            got = sql_frame(out)
            want, exact, approx = sql_expected(name, cpu.ts, cpu.fields,
                                               ties, eight,
                                               partials=bool(on))
            worst = compare_sql(f"{name} ({label})", got, want, exact,
                                approx)
            runs[label] = (got, approx, worst)
        sql.do("SET rollup_rewrite = 1")
        (g1, b1, w1), (g0, b0, w0) = runs["rewritten"], runs["raw"]
        for col in g0.columns:
            a, c = g1[col].to_numpy(), g0[col].to_numpy()
            if col in b0:
                d = np.abs(a.astype(np.float64) - c)
                check(bool((d <= b0[col] + b1[col]).all()),
                      f"{name}: {col} rewritten and raw differ by more "
                      f"than their bounds")
            else:
                check(bool((a == c).all()), f"{name}: {col} rewritten and "
                      f"raw differ")
        first, warm, raw = (runs["rewritten", "first"],
                            runs["rewritten", "warm"], runs["raw", "warm"])
        walls[name] = warm[0], raw[0]
        log(f"  {name}: rewritten (dispatch {warm[1]!r}, the sink read "
            f"{first[3]} then {warm[3]}) first {first[0] * 1e3:.1f} ms, warm "
            f"{warm[0] * 1e3:.1f} ms ({warm[2]} launches); raw (dispatch "
            f"{raw[1]!r}, {raw[3]}) warm {raw[0] * 1e3:.1f} ms ({raw[2]} "
            f"launches); {len(g1)} rows equal within both bounds, max "
            f"|err|/bound vs the brute force {w1:.3g} rewritten, {w0:.3g} "
            f"raw")
    for name in NOT_REWRITTEN:
        q = queries[name]
        plan = sql_frame(sql.do("EXPLAIN " + q))["plan"][0]
        with exec_stats.collect() as st:
            sql.do(q)
        check("rollup-rewrite" not in plan and
              not (st.dispatch or "").startswith("rollup-rewrite"),
              f"{name} was rewritten: {st.dispatch!r}")
        log(f"  {name}: no time bucket, not rewritten (dispatch "
            f"{st.dispatch!r})")

    # 4. 10 more minutes for every host, then the incremental fold
    rng = np.random.default_rng(H)
    k = FLOW_NEW_MINUTES * FLOW_WIDTH
    t_new = int(cpu.ts[-1]) + INTERVAL_MS * (2 + np.arange(k))
    new = {f: rng.random((H, k)) * 100.0 for f in CPU_FIELDS}
    cols = {t: np.tile(np.array([tg[i] for tg in cpu.tags], dtype=object), k)
            for i, t in enumerate(TSBS_TAGS)}
    cols["ts"] = np.repeat(t_new, H)
    for f in CPU_FIELDS:
        cols[f] = new[f].T.ravel()
    t0 = time.perf_counter()
    wrote = sql.fe.handle_row_insert("cpu", cols, tag_columns=TSBS_TAGS,
                                     timestamp_column="ts")
    insert_s = time.perf_counter() - t0
    check(wrote == H * k, f"handle_row_insert wrote {wrote} rows")
    del cols
    before = spec.stats["rows_folded"]
    written, wall, launches, dev_ms = timed_tick(sql, fenced=False)
    walls["incremental fold"] = wall
    fold_log(f"incremental fold after handle_row_insert of {wrote} rows "
             f"({insert_s:.2f}s)", region.last_scan_profile, wall, dev_ms)
    grew = spec.stats["rows_folded"] - before
    check(grew == H * k and launches == 1,
          f"the incremental fold folded {grew} rows with {launches} "
          f"launches, not {H * k} with one")
    wm = spec.watermarks[region.name]["ts"]
    check(wm == int(t_new[-1]) and spec.watermark_ts() == wm,
          f"the watermark is {wm}, not the last new ts {int(t_new[-1])}")
    nb_new = -(-(k + 1) // FLOW_WIDTH)
    check(written == {key: H * nb_new},
          f"the incremental fold wrote {written}, not {H * nb_new} buckets")
    tail = {f: np.full((H, nb_new * FLOW_WIDTH), np.nan) for f in CPU_FIELDS}
    for f in CPU_FIELDS:
        tail[f][x["host"], 0] = x[f]
        tail[f][:, 1:k + 1] = new[f]
    want = flow_brute(cpu.fields, tail)
    check_sink("incremental fold, buckets from 12 h", sql.table("cpu_1m"),
               cpu.tags, want, device_fold=True, min_bucket=nb)
    del want, new, tail
    log(f"  the watermark advanced to {wm} (the last new ts); rows_folded "
        f"grew by {grew}")

    # 5. a flow on cpu_p folded on the host: every region streams cold
    saved = stream_exec.stream_threshold_rows()
    sql.do(f"SET stream_threshold_rows = {FLOW_COLD_THRESHOLD}")
    try:
        tpu_exec.SCAN_CACHE.clear()
        sql.do(flow_ddl("cpu_p_1m", "cpu_p"))
        regions_p = list(sql.table("cpu_p").regions.values())
        check(all(tpu_exec.region_streams_cold(r) for r in regions_p),
              "a region of cpu_p does not stream cold")
        written, wall, launches, _ = timed_tick(sql, fenced=False)
        walls["cold fold"] = wall
        Hp, n_p = cpu_p.fields[CPU_FIELDS[0]].shape
        check(launches == 0 and written == {key: 0, key_p:
                                            Hp * n_p // FLOW_WIDTH},
              f"the cold fold wrote {written} with {launches} launches")
        for r in regions_p:
            check(r.last_scan_profile.path == "flow-fold-cold" and
                  not tpu_exec.SCAN_CACHE.cached(r),
                  f"region {r.name} took {r.last_scan_profile.path} or "
                  f"entered the scan cache")
            fold_log(f"  cold fold of region {r.name}", r.last_scan_profile,
                     r.last_scan_profile.total_s, [])
        log(f"cold fold of cpu_p ({Hp * n_p} rows, {len(regions_p)} regions "
            f"over the streaming threshold {FLOW_COLD_THRESHOLD}): wall "
            f"{wall * 1e3:.1f} ms, 0 launches, no scan-cache entry")
        check_sink("cold fold of cpu_p", sql.table("cpu_p_1m"), cpu_p.tags,
                   flow_brute(cpu_p.fields), device_fold=False)
    finally:
        sql.do(f"SET stream_threshold_rows = {saved}")

    # 6. SHOW FLOWS, information_schema.flows, the flow gauges
    specs = {s.name: s for s in fm.flows()}
    shown = sql_frame(sql.do("SHOW FLOWS"))
    info = sql_frame(sql.do("SELECT * FROM information_schema.flows"))
    gauges = sql_frame(sql.do(
        "SELECT metric_name, labels, value FROM "
        "information_schema.runtime_metrics WHERE metric_name IN "
        "('greptime_flow_watermark_ts', 'greptime_flow_rows_folded', "
        "'greptime_flow_buckets_written') ORDER BY labels, metric_name"))
    want_rows = {"cpu_1m": (H * n + 1 + H * k, 2, H * nb + 1 + H * nb_new),
                 "cpu_p_1m": (Hp * n_p, 1, Hp * n_p // FLOW_WIDTH)}
    check(list(shown["flow_name"]) == sorted(want_rows) and
          list(info["flow_name"]) == sorted(want_rows),
          f"SHOW FLOWS {list(shown['flow_name'])}, information_schema."
          f"flows {list(info['flow_name'])}")
    for i, name in enumerate(sorted(want_rows)):
        rows, folds, buckets = want_rows[name]
        s = specs[name]
        src = name[:-3]
        check(shown["source"][i] == src and shown["sink"][i] == name and
              shown["stride_ms"][i] == FLOW_STRIDE_MS and
              shown["watermark"][i] == s.watermark_ts() and
              shown["rows_folded"][i] == rows, f"SHOW FLOWS row "
              f"{shown.iloc[i].to_dict()}")
        check(info["source_table"][i] == src and
              info["folds"][i] == folds and info["rows_folded"][i] == rows
              and info["buckets_written"][i] == buckets,
              f"information_schema.flows row {info.iloc[i].to_dict()}")
        g = gauges[gauges["labels"] == f'{{flow="{name}", source="{src}"}}']
        check(dict(zip(g["metric_name"], g["value"])) == {
            "greptime_flow_buckets_written": float(buckets),
            "greptime_flow_rows_folded": float(rows),
            "greptime_flow_watermark_ts": float(s.watermark_ts())},
            f"flow gauges of {name}: {g.to_dict('list')}")
    log(f"catalog views: SHOW FLOWS, information_schema.flows and the flow "
        f"gauges of runtime_metrics agree with the folds: "
        f"{ {n: r for n, r in want_rows.items()} } (rows folded, folds, "
        f"buckets written)")

    # 7. ADMIN FLUSH the sinks, restart, a tick folds nothing
    for name in sorted(want_rows):
        sql.do(f"ADMIN FLUSH TABLE {name}")
    state = {s.key: (json.dumps(s.watermarks, sort_keys=True), dict(s.stats))
             for s in fm.flows()}
    open_s = sql.restart()
    walls["restart"] = open_s
    fm = sql.fe.datanode.flow_manager
    got = {s.key: (json.dumps(s.watermarks, sort_keys=True), dict(s.stats))
           for s in fm.flows()}
    check(got == state, f"the flows came back as {got}, not {state}")
    written, wall, launches, _ = timed_tick(sql, fenced=False)
    check(written == {key: 0, key_p: 0} and launches == 0 and
          {s.key: dict(s.stats) for s in fm.flows()} ==
          {k_: v[1] for k_, v in state.items()},
          f"the tick after the restart wrote {written} with {launches} "
          f"launches")
    log(f"restart: shutdown(), then build_standalone on the same data home "
        f"in {open_s * 1e3:.1f} ms; both flows recovered with their "
        f"watermarks and counters; a tick ({wall * 1e3:.1f} ms) folds "
        f"nothing")
    launches = K.segment_moments.launches
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 10: {launches} segment_moments launches; "
        f"{walls['phase']:.1f}s")
    return {"launches": launches, "walls": walls,
            "fold_inputs": fold_inputs}


# ---------------------------------------------------------------------------
# phase 9: PromQL over the port's own regions
# ---------------------------------------------------------------------------

#: GreptimeDB's Prometheus remote-write layout (greptimedb_tpu/servers/
#: prometheus.py): the labels as the primary key, one timestamp, one value
PROM_TAGS = ("hostname", "region", "datacenter")
PROM_TS, PROM_VALUE = "greptime_timestamp", "greptime_value"
#: phase 4's per-series and grouped queries, now over the tables, and the
#: label each answer is keyed by
ROW_QUERIES = {"rate(cpu_seconds_total[5m])": "hostname",
               "sum by (region) (rate(cpu_seconds_total[5m]))": "region"}
#: range == step: the shapes the lowering takes, each answer's key label,
#: and the segment_moments launches each makes (rate's reset_corr moment
#: is host-only, so its plan reduces on the host)
LOWERED_QUERIES = {
    "sum by (region) (rate(cpu_seconds_total[1m]))": ("region", 0),
    "avg by (region) (avg_over_time(cpu_usage_user[1m]))": ("region", 1),
    "max by (datacenter) (max_over_time(cpu_usage_user[1m]))":
        ("datacenter", 1),
    "avg(cpu_usage_user)": (None, 1),
}
#: the rtol of a lowered answer against the float64 brute force and
#: against the row path (the reference's lowered-vs-row tolerance)
LOWERED_RTOL = 2e-5
#: the span (hours) over which the lowered gauge queries also run on the
#: row path: max_over_time's gather path holds an O(S*T*L) window tensor,
#: and avg_over_time's float32 prefix sums grow with the span
ROW_CHECK_HOURS = 1
#: the streamed and SST-index reads: the threshold they run under, the
#: streamed query's region and span, the indexed host
COLD_THRESHOLD_ROWS = 1_000_000
STREAM_REGION = "eu-west-1"
STREAM_SPAN_HOURS = 2
INDEX_HOST = "host_7"


def prom_ddl(name):
    tags = ", ".join(f"{t} STRING" for t in PROM_TAGS)
    return (f"CREATE TABLE {name} ({tags}, {PROM_TS} TIMESTAMP TIME INDEX, "
            f"{PROM_VALUE} DOUBLE, PRIMARY KEY({', '.join(PROM_TAGS)}))")


def prom_load(fe, name, ts, labels, values):
    """One metric's series into its table through handle_bulk_load,
    time-major as a remote-write client sends them, then ADMIN FLUSH
    TABLE. Returns the table."""
    H, n = values.shape
    cols = {t: np.tile(np.array([lb[t] for lb in labels], dtype=object), n)
            for t in PROM_TAGS}
    cols[PROM_TS] = np.repeat(ts, H)
    cols[PROM_VALUE] = values.T.ravel()
    t0 = time.perf_counter()
    written = fe.handle_bulk_load(name, cols, tag_columns=PROM_TAGS,
                                  timestamp_column=PROM_TS)
    load_s = time.perf_counter() - t0
    del cols
    fe.datanode.storage.scheduler.wait_idle(timeout=600)
    t1 = time.perf_counter()
    fe.do_query(f"ADMIN FLUSH TABLE {name}")
    flush_ms = (time.perf_counter() - t1) * 1e3
    from greptimedb_tpu_torch.query import stream_exec, tpu_exec
    table = fe.catalog.table("greptime", "public", name)
    check(written == H * n, f"{name}: handle_bulk_load wrote {written} rows "
          f"of {H * n}")
    (region,) = table.regions.values()
    log(f"{name}: handle_bulk_load of {written} rows ({H} series x {n} "
        f"samples, 3 tags) in {load_s:.2f}s ({written / load_s / 1e6:.2f} "
        f"Mrows/s), ADMIN FLUSH TABLE {flush_ms:.1f} ms; "
        f"{sst_summary(table)}; estimated decoded "
        f"{stream_exec.region_estimated_bytes(region) / 1e9:.3f} GB "
        f"(cache budget {tpu_exec.SCAN_CACHE.budget_bytes / 2**30:.0f} "
        f"GiB): "
        f"{'streams' if tpu_exec.region_streams_cold(region) else 'resident'}")
    return table


class PromFrontend:
    """The port's standalone frontend for phase 9 and the hooks its
    statements read where ExecStats has no stage: the engine's select and
    the JSON shaping on the row path; the lowered moment frame (kept in
    `frame`) and the rebuild of the inner vector on the lowered path; each
    window-bounds and segment-moments launch fenced behind a spin kernel
    (K1Timer, MomentsTimer)."""

    def __init__(self, torch, data_home):
        from greptimedb_tpu_torch.datanode import DatanodeOptions
        from greptimedb_tpu_torch.frontend import build_standalone
        from greptimedb_tpu_torch.ops import pallas_window as pw
        from greptimedb_tpu_torch.ops import window as win
        from greptimedb_tpu_torch.promql import engine as E
        from greptimedb_tpu_torch.promql import lowering
        from greptimedb_tpu_torch.query import ir, tpu_exec
        self.torch = torch
        self.fe = build_standalone(DatanodeOptions(data_home=data_home,
                                                   device=DEVICE))
        self.eng = self.fe.promql_engine()
        self.t, self.frame = {}, None
        #: the port's dispatch floor, which each lowered statement sets
        #: again (the latency-adaptive floor re-raises after device queries)
        self.floor = tpu_exec.TPU_DISPATCH_MIN_ROWS
        self.k1 = K1Timer(torch, pw.counts_leq_grid)
        self.moments = MomentsTimer(torch)
        hooks = [(win, "counts_leq_grid", self.k1),
                 (E, "_to_prom_json", self._timed("json", E._to_prom_json)),
                 (lowering, "eval_lowered",
                  self._timed("lowered", lowering.eval_lowered)),
                 (ir, "execute_agg_plan",
                  self._timed("frame", ir.execute_agg_plan, keep=True))]
        self._saved = []
        for mod, attr, repl in hooks:
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, repl)
        self.eng.select = self._timed("select", self.eng.select)

    def _timed(self, key, fn, keep=False):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if keep:
                    self.frame = out
                return out
            finally:
                self.t[key] = self.t.get(key, 0.0) + \
                    time.perf_counter() - t0
        return run

    def close(self):
        for mod, attr, inner in self._saved:
            setattr(mod, attr, inner)
        self.moments.close()
        self.fe.shutdown()

    def do(self, sql):
        (out,) = self.fe.do_query(sql)
        return out

    def query(self, name, q, run, start, end, *, lowered, moments=0,
              window=True, instant=False):
        """One query through promql_engine().query_to_prom_json, cold (the
        scan cache emptied first) or warm; checks the route it took
        (`lowered`, or the row path, whose range functions find their
        window bounds with K1: `window`) and the segment_moments
        launches; logs the wall, the stages, the
        dispatch, the reads, each launch's device time and the peak
        device memory. Returns the JSON answer."""
        from greptimedb_tpu_torch.common import exec_stats
        from greptimedb_tpu_torch.ops import kernels as K
        from greptimedb_tpu_torch.ops import pallas_window as pw
        from greptimedb_tpu_torch.query import tpu_exec
        torch = self.torch
        if run.startswith("cold"):
            tpu_exec.SCAN_CACHE.clear()
        self.t.clear()
        self.frame = None
        self.moments.calls.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        k0, m0 = pw.counts_leq_grid.launches, K.segment_moments.launches
        reads0 = {c: _counter(f"promql_select_{c}")
                  for c in ("resident", "streamed")}
        step = 1 if instant else STEP_MS
        t0 = time.perf_counter()
        with exec_stats.collect() as stats:
            res = self.eng.query_to_prom_json(q, start, end, step,
                                              instant=instant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nk = pw.counts_leq_grid.launches - k0
        nm = K.segment_moments.launches - m0
        k1_rows = self.k1.take()
        m_ms, spins = self.moments.take()
        peak = torch.cuda.max_memory_allocated() / 2**30
        reads = {c: int(_counter(f"promql_select_{c}") - v)
                 for c, v in reads0.items()}
        t = dict(self.t)
        check(("lowered" in t) == lowered, f"{name} [{run}]: took the "
              f"{'lowered' if 'lowered' in t else 'row'} path")
        check(nm == moments, f"{name} [{run}]: {nm} segment_moments "
              f"launches, not {moments}")
        check((nk > 0) == (window and not lowered), f"{name} [{run}]: "
              f"{nk} counts_leq_grid launches on the "
              f"{'lowered' if lowered else 'row'} path")
        if lowered:
            st = {k: v.elapsed_s * 1e3 for k, v in stats.stages.items()}
            stages = (f"lowered frame {t['frame'] * 1e3:.1f} ms: "
                      f"scan_prep {st.get('scan_prep', 0.0):.1f}, reduce "
                      f"{st.get('reduce', 0.0):.1f}, finalize "
                      f"{st.get('finalize', 0.0):.1f} ms; rebuild of "
                      f"the inner vector "
                      f"{(t['lowered'] - t['frame']) * 1e3:.1f} ms, outer "
                      f"aggregate "
                      f"{(wall - t['lowered'] - t['json']) * 1e3:.1f} ms, "
                      f"JSON shaping {t['json'] * 1e3:.1f} ms")
        else:
            stages = (f"select {t['select'] * 1e3:.1f} ms, device eval + "
                      f"fetch {(wall - t['select'] - t['json']) * 1e3:.1f} "
                      f"ms, JSON shaping {t['json'] * 1e3:.1f} ms")
        kern = ""
        if k1_rows:
            kern += (f"; K1 {nk} launch(es), device " +
                     " / ".join(f"{d:.4f}" for d, _, _ in k1_rows) + " ms")
        if m_ms:
            kern += (f"; segment_moments {nm} launch(es), device " +
                     " / ".join(f"{x:.4f}" for x in m_ms) +
                     f" ms behind {spins:.1f} ms of spins")
        n = len(res["result"])
        log(f"{name} [{run}]: wall {wall * 1e3:.1f} ms ({stages}); dispatch "
            f"{stats.dispatch or 'promql-row-path'!r}; select reads "
            f"{reads}{kern}; {n} series; peak device memory {peak:.2f} GiB "
            f"({peak - held:.2f} above the {held:.2f} held before)")
        self.last = types.SimpleNamespace(wall=wall, dispatch=stats.dispatch,
                                          reads=reads, stages=t, stats=stats)
        return res


def series_keys_check(frame):
    """The lowered frame's series keys (eval_lowered's first step on the
    host), rendered as greptimedb_tpu/promql/lowering.py's eval_lowered
    renders them (every row's key values, then the distinct tuples
    sorted) and by the port's _series_keys (each column factorised, each
    distinct value rendered once): the same keys and row indices, each
    timed."""
    from greptimedb_tpu_torch.promql import lowering
    from greptimedb_tpu_torch.query.planner import _group_slot
    df = frame[frame["__n"].to_numpy() > 0]
    cols = [_group_slot(t) for t in PROM_TAGS]
    t0 = time.perf_counter()
    rendered = [[lowering._key_str(v) for v in df[c]] for c in cols]
    keys = list(zip(*rendered))
    uniq = sorted(set(keys))
    sid_of = {k: i for i, k in enumerate(uniq)}
    sids = np.fromiter((sid_of[k] for k in keys), dtype=np.int64,
                       count=len(df))
    t1 = time.perf_counter()
    got_uniq, got_sids = lowering._series_keys(df, cols)
    t2 = time.perf_counter()
    check(got_uniq == uniq and np.array_equal(got_sids, sids),
          "_series_keys differs from the reference's rendering")
    log(f"  series keys of the lowered frame ({len(df)} rows, {len(uniq)} "
        f"series): the reference's per-row rendering {(t1 - t0) * 1e3:.1f} "
        f"ms, the port's _series_keys {(t2 - t1) * 1e3:.1f} ms, equal")


def sig_unit(a, b):
    """One unit in the 6th significant digit of the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b))
    return np.where(m > 0, 10.0 ** (np.floor(np.log10(np.where(
        m > 0, m, 1.0))) - 5), 0.0) * (1 + 1e-9)


def same_as_phase4(name, got, want):
    """got / want: {key: [[t, v]]} of the same query. The same series at
    the same steps, every value within one unit in the 6th significant
    digit."""
    check(sorted(got) == sorted(want), f"{name}: {len(got)} series, "
          f"phase 4 had {len(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        check(np.array_equal(g[:, 0], w[:, 0]), f"{name}: steps of {k} "
              f"differ from phase 4's")
        d = np.abs(g[:, 1] - w[:, 1])
        u = sig_unit(g[:, 1], w[:, 1])
        bad = d > u
        check(not bad.any(), f"{name}: {k} differs from phase 4 by more "
              f"than one unit in the 6th digit: {g[bad][:3]} vs "
              f"{w[bad][:3]}")
        worst = max(worst, float(np.max(d / np.maximum(u, 1e-300),
                                        initial=0.0)))
    log(f"  check {name}: {len(want)} series, every step equal to phase "
        f"4's answer over the in-memory series (max |diff| / unit of the "
        f"6th digit {worst:.3g})")


def window_index(ts, steps, range_ms):
    """[lo, hi) sample indices of each window (t - range, t]."""
    return (np.searchsorted(ts, steps - range_ms, side="right"),
            np.searchsorted(ts, steps, side="right"))


def grouped(x, ok, keys_of, keys, how):
    """Reduce [S, T] host rows into [len(keys), T] by their key label
    (`how`: sum / avg / max over the ok rows; ok where any row is)."""
    out, wok = [], []
    for k in keys:
        rows = keys_of == k
        v = np.where(ok[rows], x[rows], {"sum": 0.0, "avg": 0.0,
                                         "max": -np.inf}[how])
        c = ok[rows].sum(axis=0)
        r = v.max(axis=0) if how == "max" else v.sum(axis=0)
        if how == "avg":
            r = r / np.maximum(c, 1)
        out.append(r)
        wok.append(c > 0)
    return np.stack(out), np.stack(wok)


def lowered_brute(q, ts, labels, metrics, steps):
    """The float64 numpy answer of a lowered query from the arrays the
    tables were loaded from: (keys, values [K, T], ok [K, T])."""
    key = LOWERED_QUERIES[q][0]
    keys_of = np.asarray([lb[key] for lb in labels]) if key \
        else np.zeros(len(labels), dtype=object)
    keys = sorted(set(keys_of.tolist())) if key else [0]
    U = metrics["cpu_usage_user"]
    if q.startswith("sum by (region) (rate"):
        r, ok, _, _ = ref_rate(ts, metrics["cpu_seconds_total"], steps,
                               STEP_MS)
        return keys, *grouped(r, ok, keys_of, keys, "sum")
    lo, hi = window_index(ts, steps, STEP_MS)
    if "avg_over_time" in q:
        P = np.concatenate([np.zeros((len(U), 1)), np.cumsum(U, axis=1)],
                           axis=1)
        c = hi - lo
        x = (P[:, hi] - P[:, lo]) / np.maximum(c, 1)
        ok = np.broadcast_to(c > 0, x.shape)
        return keys, *grouped(x, ok, keys_of, keys, "avg")
    if "max_over_time" in q:
        check(np.array_equal(hi[:-1], lo[1:]) and (hi > lo).all(),
              "the 1 m windows do not tile the samples")
        x = np.maximum.reduceat(U[:, :hi[-1]], lo, axis=1)
        ok = np.ones(x.shape, dtype=bool)
        return keys, *grouped(x, ok, keys_of, keys, "max")
    # avg(instant selector): each series' last sample at or before the
    # step, if it is within the 5 m lookback
    last = hi - 1
    ok1 = (last >= 0) & (ts[np.maximum(last, 0)] >= steps - RANGE_MS)
    x = U[:, np.maximum(last, 0)]
    return keys, *grouped(x, np.broadcast_to(ok1, x.shape), keys_of, keys,
                          "avg")


def json_matrix(name, res, key, keys, steps_s, ok):
    return series_values(name, parse_series(res["result"], key)
                         if key else {0: parse_series(res["result"],
                                                      key)[None]},
                         keys, steps_s, ok)


def prom_reads(pf, p4, start):
    """The streamed cold read and the SST-index read: the threshold set
    below the tables' rows, then restored."""
    from greptimedb_tpu_torch.common import exec_stats
    from greptimedb_tpu_torch.promql import lowering
    from greptimedb_tpu_torch.promql.parser import parse_promql
    from greptimedb_tpu_torch.query import stream_exec, tpu_exec
    from greptimedb_tpu_torch.session import QueryContext
    ts, labels, U = p4.ts, p4.labels, p4.metrics["cpu_usage_user"]
    host_of = {lb["hostname"]: i for i, lb in enumerate(labels)}
    threshold = stream_exec.stream_threshold_rows()
    pf.do(f"SET stream_threshold_rows = {COLD_THRESHOLD_ROWS}")
    (region,) = pf.fe.catalog.table("greptime", "public",
                                    "cpu_usage_user").regions.values()
    try:
        check(tpu_exec.region_streams_cold(region),
              "cpu_usage_user does not stream under the lowered threshold")
        # the selection itself: the window-bounded cold read's samples
        # are the loaded float64 values, exactly
        end = start + STREAM_SPAN_HOURS * 3600_000
        text = f'cpu_usage_user{{region="{STREAM_REGION}"}}'
        tpu_exec.SCAN_CACHE.clear()
        n0 = _counter("promql_select_streamed")
        t0 = time.perf_counter()
        with exec_stats.collect() as stats:
            sel = pf.eng.select(parse_promql(text), start - RANGE_MS + 1,
                                end, QueryContext())
        sel_ms = (time.perf_counter() - t0) * 1e3
        check(_counter("promql_select_streamed") > n0 and
              not tpu_exec.SCAN_CACHE.cached(region),
              "the streamed select did not take the cold read, or left the "
              "region in the scan cache")
        cols = np.nonzero((ts >= start - RANGE_MS + 1) & (ts <= end))[0]
        want_rows = [i for i, lb in enumerate(labels)
                     if lb["region"] == STREAM_REGION]
        got_rows = [host_of[lb["hostname"]] for lb in sel.labels]
        check(sorted(got_rows) == want_rows, f"streamed select: "
              f"{len(got_rows)} series, want {len(want_rows)}")
        m = sel.matrix
        n = len(cols)
        check(bool((m.lengths == n).all()) and
              bool((m.ts[:, :n] == ts[cols]).all()) and
              bool((m.values[:, :n] == U[got_rows][:, cols]).all()),
              "streamed select: samples differ from the loaded values")
        rows = {k: st.rows for k, st in stats.stages.items()}
        log(f"streamed select {text} over {STREAM_SPAN_HOURS} h: "
            f"{len(got_rows)} series x {n} samples in {sel_ms:.1f} ms "
            f"(promql_cold_scan rows {rows.get('promql_cold_scan')}); "
            f"timestamps and values equal to the loaded arrays")
        # and a query over it
        q = f'max_over_time({text}[5m])'
        res = pf.query("streamed max_over_time", q, "cold", start, end,
                       lowered=False)
        check(pf.last.reads["streamed"] > 0, "the query read no streamed "
              "region")
        steps = np.arange(start, end + 1, STEP_MS, dtype=np.int64)
        lo, hi = window_index(ts, steps, RANGE_MS)
        G = U[want_rows]
        want = np.stack([G[:, a:b].max(axis=1) for a, b in zip(lo, hi)],
                        axis=1)
        ok = np.broadcast_to(hi > lo, want.shape)
        got = series_values(q, parse_series(res["result"]),
                            [labels[i]["hostname"] for i in want_rows],
                            steps.astype(np.float64) / 1000.0, ok)
        compare(q, got, want, ok, (U32 + QUANT) * np.abs(want))

        # an equality matcher through the SST index
        t = start + HOURS * 1800_000
        text = f'cpu_usage_user{{hostname="{INDEX_HOST}"}}[5m]'
        sel = parse_promql(text)
        tags = region.series_dict.tag_names
        sids = lowering.matcher_sids(region, tags, [
            mt for mt in sel.matchers if mt.op == "=" and mt.name in tags])
        check(sids is not None and len(sids) == 1,
              f"matcher_sids: {sids}")
        res = pf.query("indexed select", text, "cold", t, t,
                       lowered=False, window=False, instant=True)
        rows = {k: st.rows for k, st in pf.last.stats.stages.items()}
        h = host_of[INDEX_HOST]
        idx = np.nonzero((ts > t - RANGE_MS) & (ts <= t))[0]
        (series,) = res["result"]
        tv = np.asarray([[float(a), float(b)] for a, b in series["values"]])
        check(series["metric"]["hostname"] == INDEX_HOST and
              np.array_equal(tv[:, 0], ts[idx] / 1000.0) and
              np.array_equal(tv[:, 1], U[h, idx]) and
              rows.get("promql_cold_scan", 0) == len(idx),
              f"indexed select: {series['metric']}, {len(tv)} samples, "
              f"cold read rows {rows}")
        log(f"  check indexed select {text} at one instant: one candidate "
            f"series from the SST index, the cold read kept "
            f"{rows['promql_cold_scan']} rows, the {len(idx)} samples equal "
            f"to the loaded values")
    finally:
        pf.do(f"SET stream_threshold_rows = {threshold}")


def tql_frame(out):
    import pandas as pd
    return pd.concat([pd.DataFrame(b.to_pydict()) for b in out.batches],
                     ignore_index=True)


#: the query TQL runs through do_query in phase 9, on both routes
TQL_QUERY = "avg by (region) (avg_over_time(cpu_usage_user[1m]))"


def prom_tql(pf, start_s, end_s, span_end_s, answers):
    """TQL through do_query: TQL_QUERY's EVAL over the first
    ROW_CHECK_HOURS (`start_s` .. `span_end_s`) on each route, equal to
    the JSON answer of the same query on that route (`answers`: route ->
    query_to_prom_json's answer); EXPLAIN over the whole span; ANALYZE
    over the first hours with its stages; then the tql/* goldens."""
    q = TQL_QUERY
    step = f"'{STEP_MS // 1000}s'"
    for route, floor in (("lowered", pf.floor), ("row", 10 ** 9)):
        pf.do(f"SET tpu_dispatch_min_rows = {floor}")
        pf.t.clear()
        t0 = time.perf_counter()
        df = tql_frame(pf.do(f"TQL EVAL ({start_s}, {span_end_s}, {step}) "
                             f"{q}"))
        wall = time.perf_counter() - t0
        pf.k1.take()
        pf.moments.take()
        check(("lowered" in pf.t) == (route == "lowered"),
              f"TQL EVAL {q}: not on the {route} path")
        want = parse_series(answers[route]["result"], "region")
        check(sorted(set(df["region"])) == sorted(want),
              f"TQL EVAL {q} ({route}): regions differ from the JSON answer")
        for r, g in df.groupby("region"):
            tv = np.stack([g["ts"].to_numpy(np.int64) / 1000.0,
                           g["value"].to_numpy(np.float64)], axis=1)
            check(np.array_equal(tv, want[r]), f"TQL EVAL {q} ({route}): "
                  f"{r} differs from the JSON answer")
        log(f"TQL EVAL {q} over {ROW_CHECK_HOURS} h, {route} path: "
            f"{len(df)} rows in {wall * 1e3:.1f} ms, equal to the "
            f"query_to_prom_json answer")
    pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
    plan = tql_frame(pf.do(f"TQL EXPLAIN ({start_s}, {end_s}, {step}) "
                           f"{q}"))["plan"].iloc[0]
    lines = plan.splitlines()
    check("TpuAggregateExec: groups=[hostname, region, datacenter, "
          f"time_bucket({STEP_MS}ms)]" in plan and
          "  Dispatch: device-resident (scan cache)" in lines,
          f"TQL EXPLAIN {q}: {plan!r}")
    log(f"TQL EXPLAIN {q}:\n  " + "\n  ".join(lines))
    pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
    t0 = time.perf_counter()
    ana = tql_frame(pf.do(f"TQL ANALYZE ({start_s}, {span_end_s}, {step}) "
                          f"{q}"))
    wall = time.perf_counter() - t0
    pf.moments.take()
    text = ana["plan"].iloc[1]
    stages = [ln.split(":")[0] for ln in text.splitlines()[1:]]
    check(list(ana["plan_type"]) == ["logical_plan", "analyze"] and
          "TpuAggregateExec" in ana["plan"].iloc[0] and
          {"dispatch", "scan_prep", "reduce"} <= set(stages),
          f"TQL ANALYZE {q}: {ana.to_dict('list')}")
    log(f"TQL ANALYZE {q} in {wall * 1e3:.1f} ms:\n  " +
        "\n  ".join(text.splitlines()))
    from greptimedb_tpu_torch.tools import sqlness
    cases = [c for c in sqlness.IN_SCOPE if c.startswith("tql/")]
    t0 = time.perf_counter()
    failed = goldens(cases)
    check(not failed, "tql goldens differ on the card:\n" +
          "\n".join(failed))
    pf.k1.take()
    log(f"goldens: {len(cases)} tql/* sqlness cases on {DEVICE!r} "
        f"byte-equal to their .result in {time.perf_counter() - t0:.2f}s "
        f"(with phase 8's, {len(sqlness.IN_SCOPE)} in-scope cases)")


@contextlib.contextmanager
def phase_promql_tables(torch, p4):
    """Phase 9: PromQL over the port's own regions through its standalone
    frontend on the card. `p4` carries phase 4's series and answers.
    Yields, for phases 11 and 12b on the same frontend, the frontend
    (`pf`), the range's start, the phase's answers, its K1 and
    segment_moments launches and each device-lowered query's
    segment_moments inputs (24 h, warm)."""
    import shutil
    import tempfile

    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.query import tpu_exec
    log("== phase 9: PromQL over the port's own regions")
    t_phase = time.perf_counter()
    tpu_exec.SCAN_CACHE.clear()
    torch.cuda.empty_cache()
    ts, labels, metrics = p4.ts, p4.labels, p4.metrics
    start, end = int(ts[0]), int(ts[0]) + HOURS * 3600_000
    steps = np.arange(start, end + 1, STEP_MS, dtype=np.int64)
    steps_s = steps.astype(np.float64) / 1000.0
    data_home = tempfile.mkdtemp(prefix="chip_smoke_prom_")
    pf, moment_inputs, lowered_answers = None, {}, {}
    try:
        pf = PromFrontend(torch, data_home)
        log(f"build_standalone(DatanodeOptions(data_home={data_home!r}, "
            f"device={DEVICE!r})); the tables in GreptimeDB's Prometheus "
            f"remote-write layout, phase 4's series (seed as phase 4)")
        for name in ("cpu_usage_user", "cpu_seconds_total"):
            pf.do(prom_ddl(name))
            prom_load(pf.fe, name, ts, labels, metrics[name])
        pw.counts_leq_grid.launches = K.segment_moments.launches = 0

        # ---- the row path at phase 4's grid ----
        pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
        json_answers = {}
        for q, key in ROW_QUERIES.items():
            # the per-series query runs cold only: its warm repeat (21 s
            # on an H100 machine, most of it host JSON shaping) would take
            # the script past 600 s
            runs = ("cold",) if key == "hostname" else ("cold", "warm")
            for run in runs:
                res = pf.query(q, q, run, start, end, lowered=False)
                same_as_phase4(f"{q} [{run}]", parse_series(
                    res["result"], key), p4.answers[q])
            json_answers[q] = res
        rate5, ok5, b5, _ = ref_rate(ts, metrics["cpu_seconds_total"], steps,
                                     RANGE_MS)
        hosts = [lb["hostname"] for lb in labels]
        q = "rate(cpu_seconds_total[5m])"
        compare(q, series_values(q, parse_series(json_answers[q]["result"]),
                                 hosts, steps_s, ok5), rate5, ok5, b5)
        q = "sum by (region) (rate(cpu_seconds_total[5m]))"
        reg_of = np.asarray([lb["region"] for lb in labels])
        regions = sorted(set(reg_of.tolist()))
        want, wok = grouped(rate5, ok5, reg_of, regions, "sum")
        wb, _ = grouped(b5 + QUANT * np.abs(np.where(ok5, rate5, 0.0)), ok5,
                        reg_of, regions, "sum")
        compare(q, series_values(q, parse_series(
            json_answers[q]["result"], "region"), regions, steps_s, wok),
            want, wok, wb)
        del rate5, ok5, b5

        # ---- the lowered path: range == step ----
        for q, (key, nm) in LOWERED_QUERIES.items():
            instant = "[" not in q
            keys, want, wok = lowered_brute(q, ts, labels, metrics, steps)
            for run in ("cold", "warm"):
                pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
                res = pf.query(q, q, run, start, end, lowered=True,
                               moments=nm)
                check(pf.last.dispatch == "device-resident (scan cache" +
                      ("; host-partial moments (sketch/expr))" if nm == 0
                       else ")"), f"{q}: dispatch {pf.last.dispatch!r}")
                got = json_matrix(q, res, key, keys, steps_s, wok)
                compare(f"{q} [{run}]", got, want, wok,
                        LOWERED_RTOL * np.abs(want) + 1e-12)
            lowered_answers[q] = res
            if nm:
                # the warm launch's inputs, for the kernel's check and
                # times at this shape after the phase
                moment_inputs[q] = pf.moments.calls[-1]
            if q == TQL_QUERY:
                series_keys_check(pf.frame)
            # the same query on the row path, above the table's rows
            span_end = end if not q.endswith("_over_time(cpu_usage_user"
                                             "[1m]))") \
                else start + ROW_CHECK_HOURS * 3600_000
            if span_end != end:
                low = pf.query(f"{q} over {ROW_CHECK_HOURS} h", q, "warm",
                               start, span_end, lowered=True, moments=nm)
            else:
                low = res
            pf.do("SET tpu_dispatch_min_rows = 1000000000")
            row = pf.query(f"{q} on the row path", q, "warm", start,
                           span_end, lowered=False, window=not instant)
            pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
            T = (span_end - start) // STEP_MS + 1
            ok = wok[:, :T]
            g_low = json_matrix(q, low, key, keys, steps_s[:T], ok)
            g_row = json_matrix(q, row, key, keys, steps_s[:T], ok)
            if "rate" in q:
                # the row path's float32 rate against the float64 one:
                # phase 4's bound, summed over each region's hosts
                _, ok1, b1, r1 = ref_rate(ts, metrics["cpu_seconds_total"],
                                          steps, STEP_MS)
                reg = np.asarray([lb["region"] for lb in labels])
                bnd, _ = grouped(b1 + QUANT * np.abs(np.where(ok1, r1, 0)),
                                 ok1, reg, keys, "sum")
                bnd = bnd + LOWERED_RTOL * np.abs(g_low)
                what = "the lowered answer (the row path's float32 bound)"
            else:
                bnd = LOWERED_RTOL * np.abs(g_low) + 1e-12
                what = "the lowered answer"
            compare(f"{q} on the row path", g_row, g_low, ok, bnd, what)
            if q == TQL_QUERY:
                tql_answers = {"lowered": low, "row": row}
                tql_end = span_end

        prom_reads(pf, p4, start)
        prom_tql(pf, start // 1000, end // 1000, tql_end // 1000,
                 tql_answers)
        nk, nm = pw.counts_leq_grid.launches, K.segment_moments.launches
        check(nk > 0 and nm > 0, f"phase 9 launched counts_leq_grid {nk} "
              f"and segment_moments {nm} times")
        log(f"phase 9: {nk} counts_leq_grid and {nm} segment_moments "
            f"launches; {time.perf_counter() - t_phase:.1f}s")
        yield types.SimpleNamespace(
            pf=pf, start=start, k1=nk, moments=nm, inputs=moment_inputs,
            answers=types.SimpleNamespace(
                row=json_answers, lowered=lowered_answers, tql=tql_answers,
                tql_end=tql_end))
    finally:
        if pf is not None:
            pf.close()
        tpu_exec.SCAN_CACHE.clear()
        shutil.rmtree(data_home, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: the HTTP front door
# ---------------------------------------------------------------------------

#: Prometheus's remote-write queue_config defaults (its configuration
#: documentation): samples per request and, here, the shards sending them
SAMPLES_PER_SEND = 2000
SHARDS = 8
#: minutes of phase 4's generator written through remote write, and of
#: TSBS cpu-only written as InfluxDB lines, in bodies of this many lines
#: (Telegraf's default metric_batch_size; 5000 TSBS lines, 2.2 MB, exceed
#: the server's 1 MiB request limit, aiohttp's default client_max_size,
#: which the reference's server has too) from SHARDS senders
WRITE_MINUTES = 10
INFLUX_MINUTES = 1
INFLUX_LINES_PER_BODY = 1000
#: concurrent /v1/sql aggregates under `SET admission_max_inflight = 1`
ADMISSION_SENDERS = 8
#: `SELECT 1` over HTTP and through do_query, in turns: the front door's
#: own cost apart from any query
FRONT_DOOR_REPS = 50
HTTP_TIMEOUT_S = 600


class HttpClient:
    """Requests to the phase's server over a real socket (urllib)."""

    def __init__(self, port):
        self.port = port

    def call(self, path, method="GET", body=None, headers=None,
             params=None):
        """(status, body, headers, wall s)."""
        import urllib.error
        import urllib.parse
        import urllib.request
        url = f"http://127.0.0.1:{self.port}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params, doseq=True)
        r = urllib.request.Request(url, data=body, method=method,
                                   headers=headers or {})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(r, timeout=HTTP_TIMEOUT_S) as resp:
                out = resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            out = e.code, e.read(), dict(e.headers)
        return (*out, time.perf_counter() - t0)

    def json(self, path, status=200, **kw):
        code, body, headers, wall = self.call(path, **kw)
        check(code == status, f"{path} {kw.get('params')}: HTTP {code}, not "
              f"{status}: {body[:500]!r}")
        return json.loads(body), headers, wall

    def sql(self, stmt, status=200):
        import urllib.parse
        return self.json("/v1/sql", status=status, method="POST",
                         body=urllib.parse.urlencode({"sql": stmt}).encode(),
                         headers={"Content-Type":
                                  "application/x-www-form-urlencoded"})


def parallel(fns):
    """Run `fns` on threads started together; their results in order."""
    import threading
    out = [None] * len(fns)
    errors = []
    gate = threading.Barrier(len(fns))

    def run(i):
        gate.wait(timeout=HTTP_TIMEOUT_S)
        try:
            out[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), "a sender did not finish")
    if errors:
        raise errors[0]
    return out


def as_json(doc):
    """A Python answer as the server's JSON renders it."""
    return json.loads(json.dumps(doc))


def records(out):
    """{column: [values]} of a /v1/sql output's records."""
    rec = out["records"]
    names = [c["name"] for c in rec["schema"]["column_schemas"]]
    return {n: [r[i] for r in rec["rows"]] for i, n in enumerate(names)}


def continue_series(ts, metrics, seed, minutes):
    """`minutes` more of phase 4's generator for every host: usage_user's
    clamped walk and the counter continue from their last samples."""
    rng = np.random.default_rng(seed + 11)
    n = minutes * 60_000 // INTERVAL_MS
    new_ts = ts[-1] + INTERVAL_MS * np.arange(1, n + 1, dtype=np.int64)
    usage = metrics["cpu_usage_user"]
    x = usage[:, -1].copy()
    walk = np.empty((usage.shape[0], n))
    steps = rng.standard_normal((n, usage.shape[0]))
    for i in range(n):
        x = np.clip(x + steps[i], 0.0, 100.0)
        walk[:, i] = x
    counter = metrics["cpu_seconds_total"][:, -1:] + np.cumsum(
        walk / 100.0 * (INTERVAL_MS / 1000.0), axis=1)
    return new_ts, {"cpu_usage_user": walk, "cpu_seconds_total": counter}


def remote_write_bodies(labels, new_ts, new):
    """Prometheus's sharded send: series spread over SHARDS shards, each
    shard sending its samples in time order, SAMPLES_PER_SEND to a
    request, snappy-compressed prompb.WriteRequests (the port's
    encoder). Returns one list of bodies per shard."""
    from greptimedb_tpu_torch.servers import prometheus as prom
    series = [(name, h) for name in new for h in range(len(labels))]
    shards = []
    for s in range(SHARDS):
        mine = series[s::SHARDS]
        per = max(1, SAMPLES_PER_SEND // len(mine))
        bodies = []
        for j in range(0, len(new_ts), per):
            bodies.append(prom.encode_write_request([prom.TimeSeries(
                labels={"__name__": name, **labels[h]},
                samples=[(float(v), int(t)) for v, t in
                         zip(new[name][h, j:j + per], new_ts[j:j + per])])
                for name, h in mine]))
        shards.append(bodies)
    return shards


def decode_read_response(body):
    """prompb.ReadResponse → [[(labels dict, [(value, ts)])] per query]."""
    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy
    out = []
    for _, _, qr in pw.iter_fields(memoryview(snappy.decompress(body))):
        series = []
        for _, _, msg in pw.iter_fields(qr):
            labels, samples = {}, []
            for f, _, v in pw.iter_fields(msg):
                sub = {f2: v2 for f2, _, v2 in pw.iter_fields(v)}
                if f == 1:
                    labels[bytes(sub[1]).decode()] = bytes(sub[2]).decode()
                else:
                    samples.append((pw.decode_double(sub[1]),
                                    pw.decode_sint64(sub[2])))
            series.append((labels, samples))
        out.append(series)
    return out


def read_request(matchers, start_ms, end_ms):
    from greptimedb_tpu_torch.utils import protowire as pw
    from greptimedb_tpu_torch.utils import snappy
    q = pw.field_varint(1, start_ms) + pw.field_varint(2, end_ms)
    for mt, name, value in matchers:
        q += pw.field_bytes(3, pw.field_varint(1, mt) +
                            pw.field_bytes(2, name.encode()) +
                            pw.field_bytes(3, value.encode()))
    return snappy.compress(bytes(pw.field_bytes(1, q)))


def influx_bodies(ts, tags, fields):
    """TSBS cpu-only as InfluxDB line protocol (measurement `cpu`, the ten
    tags, the ten usage_* fields, ms timestamps), time-major as TSBS
    writes it, INFLUX_LINES_PER_BODY lines to a body."""
    heads = [",".join(["cpu"] + [f"{k}={v}" for k, v in zip(TSBS_TAGS, t)])
             for t in tags]
    lines = []
    for j, t in enumerate(ts):
        for h, head in enumerate(heads):
            kv = ",".join(f"{f}={float(fields[f][h, j])!r}"
                          for f in CPU_FIELDS)
            lines.append(f"{head} {kv} {int(t)}")
    return ["\n".join(lines[i:i + INFLUX_LINES_PER_BODY]).encode()
            for i in range(0, len(lines), INFLUX_LINES_PER_BODY)]


class FrontDoor:
    """Phase 11's requests over phase 9's frontend: each Prometheus API
    request beside the direct query_to_prom_json call of the same query,
    with the launches each made."""

    def __init__(self, torch, pf, http):
        self.torch, self.pf, self.http = torch, pf, http

    def launches(self):
        from greptimedb_tpu_torch.ops import kernels as K
        from greptimedb_tpu_torch.ops import pallas_window as pw
        return pw.counts_leq_grid.launches, K.segment_moments.launches

    def drain(self):
        """Reads the fenced launches' device times and drops the kept
        moment inputs (phase 11 times no kernel of its own)."""
        k1 = [d for d, _, _ in self.pf.k1.take()]
        m_ms, _ = self.pf.moments.take()
        self.pf.moments.calls.clear()
        return k1, m_ms

    def prom(self, name, path, q, start_ms, end_ms, step_ms, *, k1, moments,
             direct=True, instant=False):
        """The request (seconds in its parameters, as Grafana sends them),
        then the same query through query_to_prom_json back to back; both
        answers equal, each making `k1` / `moments` launches. Returns the
        HTTP answer's data."""
        params = {"query": q}
        if instant:
            params["time"] = f"{end_ms / 1000:.3f}"
        else:
            params.update(start=f"{start_ms / 1000:.3f}",
                          end=f"{end_ms / 1000:.3f}",
                          step=f"{step_ms // 1000}s")
        l0 = self.launches()
        doc, _, wall = self.http.json(path, params=params)
        l1 = self.launches()
        self.drain()
        check(doc["status"] == "success", f"{name}: {doc}")
        check((l1[0] - l0[0], l1[1] - l0[1]) == (k1, moments),
              f"{name}: {l1[0] - l0[0]} counts_leq_grid and "
              f"{l1[1] - l0[1]} segment_moments launches over HTTP, not "
              f"{k1} and {moments}")
        line = f"{name}: HTTP {path} {wall * 1e3:.1f} ms"
        if direct:
            t0 = time.perf_counter()
            want = self.pf.eng.query_to_prom_json(
                q, end_ms if instant else start_ms, end_ms,
                1000 if instant else step_ms, instant=instant)
            self.torch.cuda.synchronize()
            d_wall = time.perf_counter() - t0
            l2 = self.launches()
            self.drain()
            check((l2[0] - l1[0], l2[1] - l1[1]) == (k1, moments),
                  f"{name}: the direct call made other launches")
            check(doc["data"] == as_json(want), f"{name}: the HTTP answer "
                  f"differs from query_to_prom_json's")
            line += (f", direct query_to_prom_json {d_wall * 1e3:.1f} ms "
                     f"(the front door's own {(wall - d_wall) * 1e3:.1f} "
                     f"ms), equal answers")
        log(line + f"; {len(doc['data']['result'])} series, launches "
            f"K1 {k1}, segment_moments {moments}")
        return doc["data"]

    def explain(self, q, start_ms, end_ms, lowered):
        """?explain=1 against TQL EXPLAIN of the same query and span."""
        doc, _, _ = self.http.json("/api/v1/query_range", params={
            "query": q, "start": str(start_ms // 1000),
            "end": str(end_ms // 1000), "step": f"{STEP_MS // 1000}s",
            "explain": "1"})
        lines = doc["data"]["result"]
        check(doc["data"]["resultType"] == "explain", f"explain {q}: {doc}")
        plan = tql_frame(self.pf.do(
            f"TQL EXPLAIN ({start_ms // 1000}, {end_ms // 1000}, "
            f"'{STEP_MS // 1000}s') {q}"))["plan"].iloc[0]
        check("\n".join(lines) == plan, f"explain {q}: {lines} differs from "
              f"TQL EXPLAIN's {plan!r}")
        check(("TpuAggregateExec" in plan) == lowered and
              (lowered or "promql-row-path" in plan),
              f"explain {q}: {plan!r}")
        log(f"explain=1 {q}: equal to TQL EXPLAIN ("
            f"{'TpuAggregateExec' if lowered else 'the row path'}): "
            + " | ".join(ln.strip() for ln in lines))


def phase_http(torch, pf, p4, seed, phase9):
    """Phase 11: the port's HTTP server (servers/http.py) over phase 9's
    frontend, every request over a real socket. `phase9` carries phase
    9's answers (row path, lowered, TQL EVAL) of the same queries.
    Returns the phase's K1 and segment_moments launches and its walls."""
    from greptimedb_tpu_torch.common import telemetry
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.servers.http import HttpServer, output_to_json
    from greptimedb_tpu_torch.servers.opentsdb import OpentsdbServer
    from greptimedb_tpu_torch.utils import snappy
    log("== phase 11: the HTTP front door")
    t_phase = time.perf_counter()
    check(snappy._load() is not None and
          snappy._lib._name == snappy._LIB_PATH,
          "the native snappy codec did not load")
    log(f"snappy: the native codec, {snappy._LIB_PATH} built from "
        f"{snappy._SRC}")
    ts, labels, metrics = p4.ts, p4.labels, p4.metrics
    H = len(labels)
    start, end = int(ts[0]), int(ts[0]) + HOURS * 3600_000
    walls = {}
    pf.k1.take()
    pf.moments.take()
    pf.moments.calls.clear()
    pw.counts_leq_grid.launches = K.segment_moments.launches = 0
    srv = HttpServer(pf.fe, addr="127.0.0.1:0")
    srv.start()
    try:
        http = HttpClient(srv.port)
        door = FrontDoor(torch, pf, http)
        log(f"HttpServer(fe, addr='127.0.0.1:0').start(): port {srv.port}")

        # ---- the metadata routes ----
        t0 = time.perf_counter()
        check(http.json("/health")[0] == {}, "/health")
        status, _, _ = http.json("/status")
        tables = [pf.fe.catalog.table("greptime", "public", n) for n in
                  pf.fe.catalog.table_names("greptime", "public")]
        n_regions = sum(len(getattr(t, "regions", {})) for t in tables)
        check(status["region_count"] == n_regions == 2 and
              status["scan_cache_resident_bytes"] > 0,
              f"/status: {status}")
        build = http.json("/api/v1/status/buildinfo")[0]["data"]
        check(build["version"] == "2.45.0", f"buildinfo: {build}")
        got = http.json("/api/v1/labels")[0]["data"]
        check(got == ["__name__", "datacenter", "hostname", "region"],
              f"/api/v1/labels: {got}")
        got = http.json("/api/v1/label/hostname/values")[0]["data"]
        check(got == sorted(lb["hostname"] for lb in labels),
              f"/api/v1/label/hostname/values: {len(got)} values")
        got = http.json("/api/v1/series",
                        params={"match[]": "cpu_usage_user"})[0]["data"]
        want = sorted((("__name__", "cpu_usage_user"),
                       *sorted(lb.items())) for lb in labels)
        check(len(got) == H and sorted(tuple(sorted(e.items()))
                                       for e in got) == want,
              f"/api/v1/series: {len(got)} entries")
        walls["metadata"] = time.perf_counter() - t0
        resident = status["scan_cache_resident_bytes"] / 1e9
        log(f"metadata routes: /health, /status ({status['region_count']} "
            f"regions, scan cache {resident:.3f} GB resident), buildinfo, "
            f"4 labels, {H} hostname values, {H} series in "
            f"{walls['metadata'] * 1e3:.1f} ms")
        via_http, direct = [], []
        for _ in range(FRONT_DOOR_REPS):
            doc, _, wall = http.sql("SELECT 1")
            via_http.append(wall * 1e3)
            t0 = time.perf_counter()
            out = pf.do("SELECT 1")
            direct.append((time.perf_counter() - t0) * 1e3)
        check(doc["output"][0] == as_json(output_to_json(out)),
              f"SELECT 1: {doc}")
        q_h = statistics.quantiles(via_http, n=4)
        q_d = statistics.quantiles(direct, n=4)
        walls["front door ms"] = q_h[1] - q_d[1]
        log(f"the front door's own cost: SELECT 1 x {FRONT_DOOR_REPS} in "
            f"turns, HTTP /v1/sql median {q_h[1]:.3f} ms (quartiles "
            f"{q_h[0]:.3f}-{q_h[2]:.3f}) against do_query {q_d[1]:.3f} ms "
            f"({q_d[0]:.3f}-{q_d[2]:.3f}): {walls['front door ms']:.3f} ms")

        # ---- the Prometheus API at 24 h, 60 s step, warm ----
        row_q = "sum by (region) (rate(cpu_seconds_total[5m]))"
        (region,) = pf.fe.catalog.table("greptime", "public",
                                        "cpu_seconds_total").regions.values()
        if not tpu_exec.SCAN_CACHE.cached(region):
            t0 = time.perf_counter()
            pf.eng.query_to_prom_json(row_q, start, end, STEP_MS)
            door.drain()
            log(f"{row_q}: the table's scan cache filled first (the phase "
                f"reads warm) in {(time.perf_counter() - t0) * 1e3:.1f} ms")
        data = door.prom(f"{row_q} (row path)", "/api/v1/query_range",
                         row_q, start, end, STEP_MS, k1=1, moments=0)
        check(data == as_json(phase9.row[row_q]), f"{row_q}: the HTTP answer "
              f"differs from phase 9's")
        log(f"  check {row_q}: equal to phase 9's answer")
        low_q = TQL_QUERY
        pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
        data = door.prom(f"{low_q} (lowered)", "/api/v1/query_range",
                         low_q, start, end, STEP_MS, k1=0, moments=1)
        check(data == as_json(phase9.lowered[low_q]), f"{low_q}: the HTTP "
              f"answer differs from phase 9's")
        log(f"  check {low_q}: equal to phase 9's answer")
        door.explain(row_q, start, end, lowered=False)
        door.explain(low_q, start, end, lowered=True)
        inst_q = "avg(cpu_usage_user)"
        data = door.prom(inst_q, "/api/v1/query", inst_q, end, end, 1000,
                         k1=0, moments=1, instant=True)
        lo, hi = window_index(ts, np.array([end]), RANGE_MS)
        want = float(np.mean(metrics["cpu_usage_user"][:, hi[0] - 1]))
        (res,) = data["result"]
        got = float(res["value"][1])
        check(data["resultType"] == "vector" and res["metric"] == {} and
              abs(got - want) <= LOWERED_RTOL * abs(want) + QUANT * abs(want),
              f"{inst_q} at the end: {got} against {want}")
        log(f"  check {inst_q} at {end // 1000}: {got} against the float64 "
            f"{want:.9g}")
        pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
        l0 = door.launches()
        doc, _, wall = http.json("/v1/promql", method="POST", params={
            "query": low_q, "start": str(start // 1000),
            "end": str(phase9.tql_end // 1000), "step": "60s"})
        l1 = door.launches()
        door.drain()
        cols = records(doc["output"][0])
        want = parse_series(phase9.tql["lowered"]["result"], "region")
        check(sorted(set(cols["region"])) == sorted(want) and
              l1[1] - l0[1] == 1, f"/v1/promql: {sorted(set(cols['region']))}"
              f", {l1[1] - l0[1]} launches")
        for r in want:
            keep = [i for i, x in enumerate(cols["region"]) if x == r]
            tv = np.array([[cols["ts"][i] / 1000.0, cols["value"][i]]
                           for i in keep])
            check(np.array_equal(tv, want[r]), f"/v1/promql: {r} differs "
                  f"from phase 9's TQL EVAL answer")
        t0 = time.perf_counter()
        pf.do(f"TQL EVAL ({start // 1000}, {phase9.tql_end // 1000}, '60s') "
              f"{low_q}")
        d_wall = time.perf_counter() - t0
        door.drain()
        log(f"/v1/promql {low_q} over {ROW_CHECK_HOURS} h: HTTP "
            f"{wall * 1e3:.1f} ms, direct TQL EVAL through do_query "
            f"{d_wall * 1e3:.1f} ms; {len(cols['region'])} rows equal to "
            f"phase 9's TQL EVAL answer")

        # ---- /v1/sql ----
        agg = ("SELECT region, avg(greptime_value), max(greptime_value) FROM "
               "cpu_usage_user GROUP BY region")
        l0 = door.launches()
        doc, _, wall = http.sql(f"SET tpu_dispatch_min_rows = 0; {agg}")
        l1 = door.launches()
        door.drain()
        pf.do("SET tpu_dispatch_min_rows = 0")
        t0 = time.perf_counter()
        out = pf.do(agg)
        d_wall = time.perf_counter() - t0
        door.drain()
        check(l1[1] - l0[1] == 1 and doc["output"][0] == {"affectedrows": 0}
              and doc["output"][1] == as_json(output_to_json(out)),
              f"/v1/sql {agg}: {l1[1] - l0[1]} launches, {doc['output']}")
        log(f"/v1/sql {agg} (SET tpu_dispatch_min_rows = 0 first): HTTP "
            f"{wall * 1e3:.1f} ms, direct do_query {d_wall * 1e3:.1f} ms; "
            f"one segment_moments launch; output equal to output_to_json of "
            f"do_query's Output ({len(doc['output'][1]['records']['rows'])} "
            f"regions)")
        pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")

        # ---- Prometheus remote write: WRITE_MINUTES more ----
        new_ts, new = continue_series(ts, metrics, seed, WRITE_MINUTES)
        t0 = time.perf_counter()
        shards = remote_write_bodies(labels, new_ts, new)
        enc_s = time.perf_counter() - t0
        n_req = sum(len(b) for b in shards)
        n_samples = H * len(new_ts) * len(new)
        n_bytes = sum(len(x) for b in shards for x in b)
        reg = telemetry.registry()

        def counter(name):
            return reg.get_sample_value(f"greptime_{name}_total") or 0.0

        names = ("ingest_coalesce_batches", "ingest_coalesce_merged_requests",
                 "ingest_coalesce_follower_acks")
        c0 = {n: counter(n) for n in names}

        def shard(bodies):
            def send():
                for b in bodies:
                    code, body, _, _ = http.call("/v1/prometheus/write",
                                                 method="POST", body=b)
                    check(code == 204, f"remote write: HTTP {code} {body!r}")
            return send

        t0 = time.perf_counter()
        parallel([shard(b) for b in shards])
        walls["remote write"] = time.perf_counter() - t0
        moved = {n: int(counter(n) - v) for n, v in c0.items()}
        log(f"remote write: {n_samples} samples ({H} hosts x {len(new_ts)} "
            f"x {len(new)} metrics) in {n_req} requests of <= "
            f"{SAMPLES_PER_SEND} samples ({n_bytes / 1e6:.1f} MB snappy; "
            f"encoded in {enc_s:.2f}s) from {SHARDS} senders: "
            f"{walls['remote write']:.2f}s, "
            f"{n_samples / walls['remote write']:.0f} samples/s; "
            + ", ".join(f"{n} {v}" for n, v in moved.items()))
        for name in new:
            doc, _, wall = http.sql(f"SELECT count(*) FROM {name}")
            n = doc["output"][0]["records"]["rows"][0][0]
            check(n == H * (len(ts) + len(new_ts)),
                  f"count(*) FROM {name}: {n}")
            log(f"/v1/sql SELECT count(*) FROM {name}: {n} in "
                f"{wall * 1e3:.1f} ms")
        door.drain()
        ts2 = np.concatenate([ts, new_ts])
        end2 = int(new_ts[-1]) + INTERVAL_MS
        start2 = end2 - 3600_000
        steps2 = np.arange(start2, end2 + 1, STEP_MS, dtype=np.int64)
        data = door.prom(f"{row_q} over the last hour, written minutes "
                         f"included", "/api/v1/query_range", row_q, start2,
                         end2, STEP_MS, k1=1, moments=0, direct=False)
        C2 = np.concatenate([metrics["cpu_seconds_total"],
                             new["cpu_seconds_total"]], axis=1)
        rate, ok, b, _ = ref_rate(ts2, C2, steps2, RANGE_MS)
        del C2
        reg_of = np.asarray([lb["region"] for lb in labels])
        regions = sorted(set(reg_of.tolist()))
        want, wok = grouped(rate, ok, reg_of, regions, "sum")
        wb, _ = grouped(b + QUANT * np.abs(np.where(ok, rate, 0.0)), ok,
                        reg_of, regions, "sum")
        compare(f"{row_q} over the extended range", series_values(
            row_q, parse_series(data["result"], "region"), regions,
            steps2.astype(np.float64) / 1000.0, wok), want, wok, wb)
        host = labels[0]
        code, body, headers, wall = http.call(
            "/v1/prometheus/read", method="POST", body=read_request(
                [(0, "__name__", "cpu_usage_user"),
                 (0, "hostname", host["hostname"])],
                int(new_ts[0]), int(new_ts[-1])))
        check(code == 200 and headers.get("Content-Encoding") == "snappy",
              f"remote read: HTTP {code}")
        ((got_labels, samples),), = decode_read_response(body)
        check(got_labels == {"__name__": "cpu_usage_user", **host} and
              samples == [(float(v), int(t)) for v, t in
                          zip(new["cpu_usage_user"][0], new_ts)],
              f"remote read: {got_labels}, {len(samples)} samples")
        log(f"/v1/prometheus/read cpu_usage_user{{hostname=\"{host['hostname']}"
            f"\"}} over the written minutes: {len(samples)} samples, exactly "
            f"those written, in {wall * 1e3:.1f} ms")

        # ---- InfluxDB line protocol, OpenTSDB ----
        t0 = time.perf_counter()
        i_ts, i_tags, i_fields = tsbs_cpu_table(seed + 12, H,
                                                INFLUX_MINUTES / 60)
        bodies = influx_bodies(i_ts, i_tags, i_fields)
        gen_s = time.perf_counter() - t0

        def influx(mine):
            def send():
                for b in mine:
                    code, body, _, _ = http.call(
                        "/v1/influxdb/write", method="POST", body=b,
                        params={"precision": "ms"})
                    check(code == 204, f"influx write: HTTP {code} {body!r}")
            return send

        t0 = time.perf_counter()
        parallel([influx(bodies[s::SHARDS]) for s in range(SHARDS)])
        walls["influx"] = time.perf_counter() - t0
        n_lines = H * len(i_ts)
        log(f"/v1/influxdb/write: {n_lines} lines (TSBS cpu-only, "
            f"{INFLUX_MINUTES} min, 10 tags, 10 fields; made in {gen_s:.2f}s) "
            f"in {len(bodies)} bodies of <= {INFLUX_LINES_PER_BODY} lines "
            f"({max(len(b) for b in bodies) / 1e6:.2f} MB at most) from "
            f"{SHARDS} senders: {walls['influx']:.2f}s, "
            f"{n_lines / walls['influx']:.0f} lines/s")
        doc, _, wall = http.sql("SELECT hostname, avg(usage_user), count(*) "
                                "FROM cpu GROUP BY hostname ORDER BY hostname")
        cols = records(doc["output"][0])
        order = sorted(range(H), key=lambda h: i_tags[h][0])
        x = i_fields["usage_user"][order]
        want = x.mean(axis=1)
        got = np.asarray(cols["avg(usage_user)"], dtype=np.float64)
        bound = 1e-5 * np.abs(want) + 8 * U32 * np.abs(x).sum() / x.shape[1]
        check(cols["hostname"] == [i_tags[h][0] for h in order] and
              cols["count(*)"] == [len(i_ts)] * H and
              bool(np.all(np.abs(got - want) <= bound)),
              f"influx avg(usage_user) by hostname: max |err| "
              f"{np.max(np.abs(got - want))}")
        log(f"  check SELECT hostname, avg(usage_user): {H} hosts, max |err| "
            f"{np.max(np.abs(got - want)):.3g} (bound "
            f"{float(bound.min()):.3g}), {wall * 1e3:.1f} ms")
        tsdb = OpentsdbServer(pf.fe)
        tsdb.start()
        try:
            import socket
            with socket.create_connection(("127.0.0.1", tsdb.port),
                                          timeout=HTTP_TIMEOUT_S) as sock:
                f = sock.makefile("rwb")
                f.write(f"put tsdb.telnet {start // 1000} 41.5 host=host_0\n"
                        f"version\n".encode())
                f.flush()
                version = f.readline()
                f.write(b"exit\n")
                f.flush()
        finally:
            tsdb.shutdown()
        put = json.dumps({"metric": "tsdb.http", "timestamp": start,
                          "value": 19.25, "tags": {"host": "host_1"}})
        doc, _, _ = http.json("/v1/opentsdb/api/put", method="POST",
                              body=put.encode())
        got = [records(o) for o in http.sql(
            'SELECT * FROM "tsdb.telnet"; SELECT * FROM "tsdb.http"')[0][
                "output"]]
        check(version.startswith(b"net.opentsdb") and
              doc == {"success": 1, "failed": 0} and got == [
                  {"host": ["host_0"], "greptime_timestamp": [start],
                   "greptime_value": [41.5]},
                  {"host": ["host_1"], "greptime_timestamp": [start],
                   "greptime_value": [19.25]}],
              f"OpenTSDB: {version!r} {doc} {got}")
        log("OpenTSDB: one telnet put and one HTTP put, read back exactly")

        # ---- admission, the routes not ported, /metrics ----
        http.sql("SET tpu_dispatch_min_rows = 0")
        http.sql("SET admission_max_inflight = 1")
        rejected0 = http.json("/status")[0]["admission"]["rejected_total"]

        def aggregate():
            return http.call("/v1/sql", params={"sql": agg})

        t0 = time.perf_counter()
        answers = parallel([aggregate] * ADMISSION_SENDERS)
        walls["admission"] = time.perf_counter() - t0
        http.sql("SET admission_max_inflight = 0")
        door.drain()
        codes = [a[0] for a in answers]
        busy = [a for a in answers if a[0] == 429]
        rejected = http.json("/status")[0]["admission"]["rejected_total"]
        check(busy and 200 in codes and all(
            a[2].get("Retry-After") == "1" and
            json.loads(a[1])["code"] == 6001 for a in busy) and
            rejected - rejected0 == len(busy),
            f"admission: codes {codes}, rejected {rejected - rejected0}")
        log(f"admission: SET admission_max_inflight = 1, {ADMISSION_SENDERS} "
            f"concurrent /v1/sql aggregates: {codes.count(200)} answered, "
            f"{len(busy)} got 429 with Retry-After 1 and code 6001 "
            f"(/status rejected_total +{rejected - rejected0}) in "
            f"{walls['admission'] * 1e3:.1f} ms")
        pf.do(f"SET tpu_dispatch_min_rows = {pf.floor}")
        for path, method, module in (
                ("/v1/scripts?name=s", "POST", "script/"),
                ("/debug/prof/cpu", "GET", "common/profiler.py")):
            doc, _, _ = http.json(path, status=400, method=method,
                                  body=b"" if method == "POST" else None)
            check(doc["code"] == 1001 and module in doc["error"],
                  f"{path}: {doc}")
        code, body, _, _ = http.call("/metrics")
        text = body.decode()
        series = sorted({re.search(r'route="([^"]*)"', ln).group(1)
                         for ln in text.splitlines()
                         if ln.startswith("greptime_http_request_seconds_"
                                          "count{")})
        check(code == 200 and series, "/metrics has no greptime_http_request "
              "latency series")
        log(f"/v1/scripts and /debug/prof/cpu: the UnsupportedError envelope "
            f"naming the module; /metrics: greptime_http_request_seconds for "
            f"{len(series)} routes")
    finally:
        srv.shutdown()
    nk, nm = pw.counts_leq_grid.launches, K.segment_moments.launches
    check(nk > 0 and nm > 0, f"phase 11 launched counts_leq_grid {nk} and "
          f"segment_moments {nm} times")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 11: {nk} counts_leq_grid and {nm} segment_moments launches; "
        f"{walls['phase']:.1f}s")
    return types.SimpleNamespace(k1=nk, moments=nm, walls=walls)


# ---------------------------------------------------------------------------
# phase 12: the MySQL and Postgres wire servers, KILL and COPY
# ---------------------------------------------------------------------------

#: SELECT 1 through each wire and through do_query, in turns: the wires'
#: own cost is the difference of the medians
WIRE_REPS = 50
WIRE_TIMEOUT_S = 600
#: the share of cpu_24h's streamed Q1 after which KILL is sent
KILL_AFTER = 0.3


class WireMysql:
    """A minimal MySQL client over a real socket: HandshakeResponse41
    without a password, COM_QUERY text result sets, COM_PING and
    COM_PROCESS_KILL. An answer is ("ok", affected), ("err", errno,
    message) or ("rows", [(name, MySQL type code)], rows of bytes or
    None)."""

    def __init__(self, port):
        import socket
        from greptimedb_tpu_torch.servers import mysql
        self.m = mysql
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=WIRE_TIMEOUT_S)
        self.io = mysql.PacketIO(self.sock)
        check(self.io.read_packet()[0] == 10, "MySQL: no HandshakeV10")
        caps = (mysql.CLIENT_PROTOCOL_41 | mysql.CLIENT_SECURE_CONNECTION
                | mysql.CLIENT_PLUGIN_AUTH)
        self.io.write_packet(struct.pack("<IIB", caps, 1 << 24, 45)
                             + b"\x00" * 23 + b"greptime\x00\x00"
                             + b"mysql_native_password\x00")
        check(self._simple(self.io.read_packet())[0] == "ok",
              "MySQL: the handshake was refused")

    def _simple(self, p):
        if p[0] == 0xFF:
            return ("err", int.from_bytes(p[1:3], "little"),
                    p[9:].decode(errors="replace"))
        if p[0] == 0x00:
            return ("ok", self.m.read_lenenc_int(p, 1)[0])
        return None

    def _command(self, cmd, payload=b""):
        self.io.reset_seq()
        self.io.write_packet(bytes([cmd]) + payload)

    def ping(self):
        self._command(self.m.COM_PING)
        return self._simple(self.io.read_packet())

    def kill(self, pid):
        self._command(self.m.COM_PROCESS_KILL, struct.pack("<I", pid))
        return self._simple(self.io.read_packet())

    def query(self, sql):
        self._command(self.m.COM_QUERY, sql.encode())
        head = self.io.read_packet()
        simple = self._simple(head)
        if simple is not None:
            return simple
        ncols = self.m.read_lenenc_int(head, 0)[0]
        cols = []
        for _ in range(ncols):
            cd, pos = self.io.read_packet(), 0
            for _ in range(4):               # catalog, schema, table, org
                _, pos = self.m.read_lenenc_str(cd, pos)
            name, _ = self.m.read_lenenc_str(cd, pos)
            cols.append((name.decode(), cd[-6]))
        self.io.read_packet()                # EOF after the columns
        rows = []
        while True:
            p = self.io.read_packet()
            if p[0] == 0xFE and len(p) < 9:
                return ("rows", cols, rows)
            row, pos = [], 0
            for _ in range(ncols):
                if p[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    v, pos = self.m.read_lenenc_str(p, pos)
                    row.append(bytes(v))
            rows.append(row)

    def close(self):
        try:
            self._command(self.m.COM_QUIT)
            self.sock.close()
        except OSError:
            pass


class WirePg:
    """A minimal Postgres v3 client over a real socket: startup without a
    password and the simple query protocol. An answer is ("ok", command
    tag), ("err", SQLSTATE, message) or ("rows", [(name, OID)], rows of
    bytes or None, command tag)."""

    def __init__(self, port):
        import socket
        from greptimedb_tpu_torch.servers import postgres
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=WIRE_TIMEOUT_S)
        self.f = self.sock.makefile("rb")
        body = struct.pack("!I", postgres.PROTOCOL_V3) + \
            b"user\x00greptime\x00database\x00public\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        while True:
            tag, payload = self._read()
            check(tag != "E", f"Postgres: startup refused: {payload!r}")
            if tag == "Z":
                break

    def _read(self):
        head = self.f.read(5)
        check(len(head) == 5, "Postgres: the server closed the connection")
        n = int.from_bytes(head[1:5], "big")
        return chr(head[0]), self.f.read(n - 4)

    def query(self, sql):
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(body) + 4) + body)
        cols, rows, tag, err = None, [], None, None
        while True:
            t, p = self._read()
            if t == "T":
                n, pos, cols = int.from_bytes(p[:2], "big"), 2, []
                for _ in range(n):
                    end = p.index(b"\x00", pos)
                    cols.append((p[pos:end].decode(),
                                 int.from_bytes(p[end + 7:end + 11], "big")))
                    pos = end + 19
            elif t == "D":
                n, pos, row = int.from_bytes(p[:2], "big"), 2, []
                for _ in range(n):
                    ln = int.from_bytes(p[pos:pos + 4], "big", signed=True)
                    pos += 4
                    if ln < 0:
                        row.append(None)
                    else:
                        row.append(p[pos:pos + ln])
                        pos += ln
                rows.append(row)
            elif t == "C":
                tag = p.rstrip(b"\x00").decode()
            elif t == "E":
                fields = {f[:1]: f[1:].decode() for f in p.split(b"\x00")
                          if f}
                err = ("err", fields.get(b"C"), fields.get(b"M"))
            elif t == "Z":
                break
        if err is not None:
            return err
        return ("rows", cols, rows, tag) if cols is not None else \
            ("ok", tag)

    def close(self):
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
            self.sock.close()
        except OSError:
            pass


def wire_expected(out):
    """What each wire must carry for a do_query Output, by the servers'
    own encoders: (MySQL columns, MySQL text rows, Postgres columns,
    Postgres text rows)."""
    from greptimedb_tpu_torch.servers import mysql, postgres
    schema = out.batches[0].schema
    cs = schema.column_schemas
    my_cols = [(c.name, mysql._mysql_type(c.dtype)) for c in cs]
    pg_cols = [(c.name, postgres._pg_oid(c.dtype)) for c in cs]
    my_rows, pg_rows = [], []
    for b in out.batches:
        for row in b.rows():
            my_rows.append([None if v is None else str(v).encode() for v in
                            mysql._Connection._format_row(schema, row)])
            pg_rows.append([postgres._pg_text(v, c.dtype)
                            for v, c in zip(row, cs)])
    return my_cols, my_rows, pg_cols, pg_rows


def wire_same(name, fe, my, pg, sql, walls, pin=lambda: None):
    """One statement through do_query, then over MySQL and over Postgres:
    every column's name and wire type and every value's text equal to the
    Output's as the servers encode it. `pin` runs before each of the
    three. Logs the three walls."""
    pin()
    t0 = time.perf_counter()
    (out,) = fe.do_query(sql)
    direct = time.perf_counter() - t0
    my_cols, my_rows, pg_cols, pg_rows = wire_expected(out)
    pin()
    t0 = time.perf_counter()
    got_my = my.query(sql)
    w_my = time.perf_counter() - t0
    pin()
    t0 = time.perf_counter()
    got_pg = pg.query(sql)
    w_pg = time.perf_counter() - t0
    check(got_my == ("rows", my_cols, my_rows),
          f"{name} over MySQL differs from do_query's Output: "
          f"{str(got_my)[:300]}")
    check(got_pg == ("rows", pg_cols, pg_rows, f"SELECT {len(pg_rows)}"),
          f"{name} over Postgres differs from do_query's Output: "
          f"{str(got_pg)[:300]}")
    walls[name] = {"direct": direct, "mysql": w_my, "postgres": w_pg}
    log(f"  {name}: {len(my_rows)} rows x {len(my_cols)} columns, equal "
        f"on both wires (names, types, every value's text); wall MySQL "
        f"{w_my * 1e3:.1f} ms, Postgres {w_pg * 1e3:.1f} ms, do_query "
        f"{direct * 1e3:.1f} ms")
    return out


def wire_servers(fe):
    from greptimedb_tpu_torch.servers.mysql import MysqlServer
    from greptimedb_tpu_torch.servers.postgres import PostgresServer
    my_srv, pg_srv = MysqlServer(fe), PostgresServer(fe)
    my_srv.start()
    pg_srv.start()
    log(f"MysqlServer(fe).start() on port {my_srv.port}, "
        f"PostgresServer(fe).start() on port {pg_srv.port}")
    return my_srv, pg_srv


def wire_front_cost(fe, my, pg):
    """Medians of SELECT 1 over each wire and through do_query, in
    turns."""
    t = {"mysql": [], "postgres": [], "direct": []}
    for _ in range(WIRE_REPS):
        for key, fn in (("mysql", lambda: my.query("SELECT 1")),
                        ("postgres", lambda: pg.query("SELECT 1")),
                        ("direct", lambda: fe.do_query("SELECT 1"))):
            t0 = time.perf_counter()
            fn()
            t[key].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) * 1e3 for k, v in t.items()}
    log(f"SELECT 1 x {WIRE_REPS} in turns, median: MySQL {med['mysql']:.3f}"
        f" ms, Postgres {med['postgres']:.3f} ms, do_query "
        f"{med['direct']:.3f} ms (the wires' own cost: "
        f"{med['mysql'] - med['direct']:.3f} / "
        f"{med['postgres'] - med['direct']:.3f} ms)")
    return med


def wire_kill(sql, my_srv, pg, q1, pin):
    """Q1 streamed on cpu_24h ("host" mode) over MySQL; SHOW FULL
    PROCESSLIST over Postgres lists it; KILL <id> over Postgres ends it
    and MySQL's client gets the cancel error within one slice's time;
    the MySQL connection then answers; COM_PROCESS_KILL of an unknown id
    is errno 1094. Returns (the kill latency, one slice's time) in s."""
    import threading
    q = re.sub(r"\bFROM cpu\b", "FROM cpu_24h", q1)
    # the statement run to its end first: its wall over its slices (two
    # in flight at a time) is one slice's time
    pin()
    sql.execute("Q1 on cpu_24h, run to its end", q, "cold, host, unfenced",
                "cpu_24h", path="streamed")
    slices = sum(p.counters.get("slices", 0) for p in sql.last.profiles)
    full = sql.last.wall
    slice_s = full * 2 / slices
    victim = WireMysql(my_srv.port)
    done, outcome = [], []

    def run():
        outcome.append(victim.query(q))
        done.append(time.perf_counter())

    pin()
    t_start = time.perf_counter()
    th = threading.Thread(target=run)
    th.start()
    pid = None
    while pid is None and time.perf_counter() - t_start < full:
        ans = pg.query("SHOW FULL PROCESSLIST")
        check(ans[0] == "rows", f"SHOW FULL PROCESSLIST: {ans}")
        names = [c for c, _ in ans[1]]
        for r in ans[2]:
            if r[names.index("Info")] == q.encode():
                pid = int(r[names.index("Id")])
                check(r[names.index("Protocol")] == b"mysql",
                      f"the scan's row: {r}")
    check(pid is not None, "SHOW FULL PROCESSLIST over Postgres never "
          "listed the streamed Q1")
    time.sleep(max(0.0, KILL_AFTER * full - (time.perf_counter() - t_start)))
    t_kill = time.perf_counter()
    killed = pg.query(f"KILL {pid}")
    th.join(timeout=WIRE_TIMEOUT_S)
    check(not th.is_alive(), "the killed statement did not end")
    latency = done[0] - t_kill
    check(killed == ("ok", "KILL"), f"KILL over Postgres: {killed}")
    err = outcome[0]
    check(err[0] == "err" and err[1] == 1105 and
          f"query {pid} was killed" in err[2],
          f"the killed Q1 over MySQL answered {str(err)[:200]}")
    check(latency <= slice_s, f"the cancel error came "
          f"{latency * 1e3:.1f} ms after KILL, more than one slice's "
          f"{slice_s * 1e3:.1f} ms")
    ans = victim.query("SELECT 1")
    check(ans[0] == "rows" and ans[2] == [[b"1"]],
          f"the MySQL connection answers {ans} after the KILL")
    ans = victim.kill(424242)
    check(ans[:2] == ("err", 1094) and "no such running" in ans[2],
          f"COM_PROCESS_KILL of an unknown id: {ans}")
    victim.close()
    log(f"KILL: Q1 on cpu_24h streamed over MySQL (run to its end: "
        f"{full * 1e3:.1f} ms, {slices} slices, two in flight: "
        f"{slice_s * 1e3:.1f} ms a slice); listed by SHOW FULL PROCESSLIST "
        f"over Postgres as id {pid}; KILL {pid} over Postgres "
        f"{(t_kill - t_start) * 1e3:.1f} ms in; the MySQL client got "
        f"errno 1105 '{err[2]}' {latency * 1e3:.1f} ms after the KILL; "
        f"the connection answers SELECT 1; COM_PROCESS_KILL 424242: errno "
        f"1094")
    return latency, slice_s


def wire_copy(sql, my, cpu_p, walls):
    """COPY on cpu_p: TO parquet under the data home's object store, FROM
    it into cpu_copy (cpu_p's DDL) over MySQL, counts exact and Q5 on the
    copy against Q5 on cpu_p and the brute force; the first hour as csv.gz
    and json.zst round-tripped; an external table over the parquet
    file."""
    fe = sql.fe
    root = fe.datanode.store.root
    H, n = cpu_p.fields["usage_user"].shape
    rows = H * n
    pq_path = os.path.join(root, "ext", "cpu_p.parquet")

    def timed(label, stmt, want):
        t0 = time.perf_counter()
        ans = my.query(stmt)
        walls[label] = time.perf_counter() - t0
        check(ans == want, f"{label}: {str(ans)[:300]}, not {want}")
        return walls[label]

    s = timed("COPY cpu_p TO parquet", f"COPY cpu_p TO '{pq_path}' WITH "
              f"(format='parquet')", ("ok", rows))
    log(f"  COPY cpu_p TO '{pq_path}' (parquet, {os.path.getsize(pq_path)} "
        f"bytes): {rows} rows in {s:.2f}s ({rows / s:.0f} rows/s)")
    timed("create cpu_copy", sql_ddl("cpu_copy", {
        f: "DOUBLE" for f in CPU_FIELDS}, cpu_p.partition), ("ok", 0))
    s = timed("COPY cpu_copy FROM parquet", f"COPY cpu_copy FROM "
              f"'{pq_path}' WITH (format='parquet')", ("ok", rows))
    log(f"  COPY cpu_copy FROM the parquet file over MySQL (cpu_p's DDL, "
        f"{len(sql.table('cpu_copy').regions)} regions, bulk_load): {rows} "
        f"rows in {s:.2f}s ({rows / s:.0f} rows/s)")
    got = my.query("SELECT count(*) FROM cpu_copy")
    check(got == ("rows", [("count(*)", 8)], [[str(rows).encode()]]),
          f"count(*) of cpu_copy: {got}")
    # Q5 on both tables on the card
    q5 = sql_queries(np.random.default_rng(0), H)[1]["Q5 per-host moments"]
    frames = {}
    for t in ("cpu_p", "cpu_copy"):
        with sql.floor_pinned():
            frames[t] = sql_frame(sql.execute(
                f"Q5 per-host moments on {t}",
                re.sub(r"\bFROM cpu\b", f"FROM {t}", q5), "unfenced", t))
    ties = tie_hosts(sql.table("cpu_copy"))
    want, exact, approx = sql_expected("Q5 per-host moments", cpu_p.ts,
                                       cpu_p.fields, ties, [])
    worst = compare_sql("Q5 on cpu_copy", frames["cpu_copy"], want, exact,
                        approx)
    # each within its bound of the brute force, so within twice it of
    # each other
    worst2 = compare_sql("Q5 on cpu_copy against cpu_p", frames["cpu_copy"],
                         frames["cpu_p"], exact,
                         {k: 2 * v for k, v in approx.items()}, f32=False)
    log(f"  count(*) of cpu_copy over MySQL: {rows}, exact; Q5 on cpu_copy "
        f"vs the float64 brute force: max |err|/bound {worst:.3g}; vs Q5 on "
        f"cpu_p: max |err|/(2 bound) {worst2:.3g}")

    # the first hour as csv.gz and json.zst
    per_h = 3600_000 // INTERVAL_MS
    sql.do(sql_ddl("cpu_1h", {f: "DOUBLE" for f in CPU_FIELDS}))
    sql_bulk_load(sql.fe, "cpu_1h", cpu_p.ts[:per_h], cpu_p.tags,
                  {f: X[:, :per_h] for f, X in cpu_p.fields.items()})
    hour_rows = H * per_h
    sums = my.query("SELECT hostname, count(*), sum(usage_user) FROM cpu_1h "
                    "GROUP BY hostname ORDER BY hostname")
    for suffix, opts in (("csv.gz", "format='csv'"),
                         ("json.zst", "format='json', compression='zstd'")):
        path = os.path.join(root, "ext", f"cpu_1h.{suffix}")
        t = "cpu_1h_" + suffix.split(".")[0]
        s_to = timed(f"COPY cpu_1h TO {suffix}", f"COPY cpu_1h TO "
                     f"'{path}' WITH ({opts})", ("ok", hour_rows))
        timed(f"create {t}", sql_ddl(t, {f: "DOUBLE" for f in CPU_FIELDS}),
              ("ok", 0))
        s_from = timed(f"COPY {t} FROM {suffix}", f"COPY {t} FROM '{path}' "
                       f"WITH ({opts})", ("ok", hour_rows))
        got = my.query(f"SELECT hostname, count(*), sum(usage_user) FROM {t} "
                       f"GROUP BY hostname ORDER BY hostname")
        check(got[0] == "rows" and len(got[2]) == H and
              [r[:2] for r in got[2]] == [r[:2] for r in sums[2]],
              f"{t}: its hosts and counts differ from cpu_1h's")
        A = np.abs(cpu_p.fields["usage_user"][:, :per_h]).sum(axis=1).max()
        d = max(abs(float(g[2]) - float(w[2]))
                for g, w in zip(got[2], sums[2]))
        check(d <= 8 * U32 * A, f"{t}: sum(usage_user) by host off by {d}")
        log(f"  the first hour ({hour_rows} rows) as {suffix}: COPY TO "
            f"{s_to:.2f}s ({os.path.getsize(path)} bytes), COPY FROM "
            f"{s_from:.2f}s ({hour_rows / s_from:.0f} rows/s); counts by "
            f"host exact, sum(usage_user) by host within {d:.3g} "
            f"(bound {8 * U32 * A:.3g})")

    # an external table over the parquet file
    timed("create external", "CREATE EXTERNAL TABLE cpu_p_ext WITH "
          "(location='ext/cpu_p.parquet')", ("ok", 0))
    agg = ("SELECT region, count(*), max(usage_user) FROM {t} GROUP BY "
           "region ORDER BY region")
    t0 = time.perf_counter()
    ext = my.query(agg.format(t="cpu_p_ext"))
    walls["external aggregate"] = time.perf_counter() - t0
    with sql.floor_pinned():
        src = my.query(agg.format(t="cpu_p"))
    check(ext[0] == src[0] == "rows" and len(ext[2]) == len(src[2]) > 0,
          f"the external table's aggregate: {str(ext)[:200]}")
    for g, w in zip(ext[2], src[2]):
        check(g[:2] == w[:2] and np.float32(float(g[2])) ==
              np.float32(float(w[2])), f"cpu_p_ext {g} != cpu_p {w}")
    log(f"  CREATE EXTERNAL TABLE cpu_p_ext over the parquet file "
        f"(inferred schema); count(*) and max(usage_user) by region over "
        f"MySQL in {walls['external aggregate']:.2f}s, equal to cpu_p's "
        f"(counts exact, max equal at float32)")


def phase_wire_sql(torch, sql, queries, cpu_p):
    """Phase 12a: the MySQL and Postgres servers over phase 6's frontend
    (after phase 10's restart): Q1-Q6 on cpu warm over each wire against
    do_query, the wires' own cost, KILL of a streamed Q1 on cpu_24h, and
    COPY on cpu_p. Returns its segment_moments launches and walls."""
    from greptimedb_tpu_torch.ops import kernels as K
    log("== phase 12a: the MySQL and Postgres wire servers over phase 6's "
        "frontend")
    from greptimedb_tpu_torch.query import tpu_exec
    t_phase = time.perf_counter()
    walls = {}
    sql.timer.fenced = False
    K.segment_moments.launches = 0
    saved = tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0]

    def pin():
        # the static floor, which each device query would otherwise raise
        # (the adaptive floor can send the rollup sink to pandas): one
        # route for the direct and the wire runs of a statement
        tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = \
            saved[0], None

    my_srv, pg_srv = wire_servers(sql.fe)
    my = pg = None
    try:
        my, pg = WireMysql(my_srv.port), WirePg(pg_srv.port)
        for name, q in queries.items():
            # warm: the scan cache filled by the statement's first run
            pin()
            sql.fe.do_query(q)
            wire_same(name, sql.fe, my, pg, q, walls, pin)
        walls["select 1"] = wire_front_cost(sql.fe, my, pg)
        q1 = next(q for n, q in queries.items() if n.startswith("Q1"))
        walls["kill"], walls["slice"] = wire_kill(sql, my_srv, pg, q1,
                                                    pin)
        wire_copy(sql, my, cpu_p, walls)
    finally:
        for c in (my, pg):
            if c is not None:
                c.close()
        my_srv.shutdown()
        pg_srv.shutdown()
        sql.timer.fenced = True
        tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = saved
    launches = K.segment_moments.launches
    check(launches > 0, "phase 12a launched no segment_moments")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 12a: {launches} segment_moments launches; "
        f"{walls['phase']:.1f}s")
    return types.SimpleNamespace(moments=launches, walls=walls)


#: phase 12b's TQL: a range function whose range differs from the step
#: takes the row path, whose window bounds K1 finds
WIRE_TQL = "sum by (region) (rate(cpu_seconds_total[5m]))"


def phase_wire_prom(torch, pf, start_ms):
    """Phase 12b: one TQL EVAL over the first hour through each wire on
    phase 9's frontend, equal to the same statement through do_query; it
    launches K1 on the row path. Returns its launches and walls."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    log("== phase 12b: TQL over the MySQL and Postgres wires on phase 9's "
        "frontend")
    t_phase = time.perf_counter()
    walls = {}
    pf.k1.take()
    pf.moments.take()
    pw.counts_leq_grid.launches = K.segment_moments.launches = 0
    s0 = start_ms // 1000
    tql = f"TQL EVAL ({s0}, {s0 + 3600}, '60s') {WIRE_TQL}"
    my_srv, pg_srv = wire_servers(pf.fe)
    my = pg = None
    try:
        my, pg = WireMysql(my_srv.port), WirePg(pg_srv.port)
        out = wire_same("TQL EVAL over 1 h", pf.fe, my, pg, tql, walls)
        check(out.num_rows > 0, "TQL EVAL answered no rows")
    finally:
        for c in (my, pg):
            if c is not None:
                c.close()
        my_srv.shutdown()
        pg_srv.shutdown()
    k1 = pf.k1.take()
    pf.moments.take()
    nk, nm = pw.counts_leq_grid.launches, K.segment_moments.launches
    check(nk == 3 and len(k1) == nk, f"phase 12b launched counts_leq_grid "
          f"{nk} times ({len(k1)} timed), not once for each of do_query, "
          f"MySQL and Postgres")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 12b: K1 {nk} launches (device " + " / ".join(
        f"{d:.4f}" for d, _, _ in k1) + f" ms), segment_moments {nm}; "
        f"{walls['phase']:.1f}s")
    return types.SimpleNamespace(k1=nk, moments=nm, walls=walls)


def phase_moments_time(torch, inputs, tool=True):
    """segment_moments on the inputs the main path gave it (`inputs`:
    label -> the kernel's arguments), against its plain version and the
    library yardstick. With `tool`, the labels are the timing tool's
    queries (Q1, Q4, Q6), whose inputs must match these in every property
    the kernel's work depends on. Returns label -> the kernel line's
    numbers."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.tools import segment_moments_bench as smb
    rows = {}
    for q, args in inputs.items():
        ends, mask = args[0], args[1]
        if tool:
            want = smb.signature(args)
            got = smb.signature(smb.main_path_inputs(q, DEVICE))
            check(got == want, f"the timing tool's {q} inputs differ from "
                  f"the main path's: {got} != {want}")
        err = smb.moments_agree(f"{q} main-path shape", args, quiet=True)
        lib, nlib = smb.library_moments(args)
        # the kernel and the library calls queued behind a spin kernel
        # (the wrapper's host time exceeds the kernel's at Q4); the plain
        # version synchronises, so it is timed back to back
        ms = smb.median_fenced_ms(lambda: K.segment_moments(*args))
        plain_ms = median_ms(torch, lambda: K.segment_moments_plain(*args),
                             launches=3, runs=3)
        lib_ms = smb.median_fenced_ms(lib, launches=5, runs=3)
        b_ms, b_by, nbytes = smb.moments_bound(args)
        log(f"segment_moments at the {q} shape: {mask.shape[0]} rows, "
            f"{ends.shape[0]} runs, {len(args[5])} moments "
            f"({', '.join(sorted(set(args[5])))}); kernel == plain, two "
            f"launches bit-equal, max |err| {err:.3g}; kernel {ms:.4f} ms "
            f"({b_ms / ms * 100:.1f}% of the bound), plain {plain_ms:.4f} "
            f"ms, torch.segment_reduce x {nlib} {lib_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB)")
        rows[q] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return rows


# ---------------------------------------------------------------------------

#: the phases; `--phases` runs some of them with the phases they stand on
PHASES = tuple(str(i) for i in range(1, 13))
#: what each phase needs run with it (phases 1 and 2 always run): 3 and 4
#: are one call, as are 6 and 7; 5 launches segment_moments before the
#: phases that fence its launches (a process's first launch loads the
#: module); 8, 10 and 12a run on phase 6's frontend and tables, 9
#: compares with phase 4's answers, 11 and 12b run on phase 9's frontend
#: (12b only when 9 runs)
NEEDS = {"3": ("4",), "4": ("3",), "6": ("5", "7"), "7": ("6",),
         "8": ("6",), "9": ("4", "5"), "10": ("6",), "11": ("9",),
         "12": ("6",)}


def resolve_phases(arg: str) -> set:
    want = {p.strip() for p in arg.split(",") if p.strip()}
    unknown = want - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    out = {"1", "2"} | want
    while True:
        more = {d for p in out for d in NEEDS.get(p, ())} - out
        if not more:
            return out
        out |= more


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run with the phases "
                    "they need (default: every phase); a run of chosen "
                    "phases names them in its last two lines")
    args = ap.parse_args()
    phases = resolve_phases(args.phases)
    t_all = time.perf_counter()
    before = set(sys.modules)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port runs on the GPU",
              file=sys.stderr)
        return 1
    import greptimedb_tpu_torch
    pkg_dir = os.path.dirname(os.path.abspath(greptimedb_tpu_torch.__file__))
    check(pkg_dir == os.path.join(HERE, "greptimedb_tpu_torch"),
          f"greptimedb_tpu_torch imported from {pkg_dir}, not this checkout")

    log(f"phases {','.join(sorted(phases, key=int))}")
    log("== phase 1: machine")
    phase_machine(torch)
    log("== phase 2: build")
    phase_kernel_build()
    # each main-path kernel's launches by the phase that made them
    k1_by, moments_by, shapes, walls = {}, {}, {}, {}
    kern = p4 = None
    if "4" in phases:
        log("== phase 3 + 4: kernel checks, then PromQL on TSBS cpu-only")
        from greptimedb_tpu_torch.ops import pallas_window as pw
        k1 = K1Timer(torch, pw.counts_leq_grid)
        kern, p4 = phase_promql(torch, args.seed, k1)
        k1_by["4"] = kern[0]["launches"]
    if "5" in phases:
        log("== phase 5: segment_moments against its plain version")
        phase_moments_check()
    from greptimedb_tpu_torch.tools import segment_moments_bench as smb
    if "6" in phases:
        log("== phase 6: SQL on TSBS cpu-only, then segment_moments at the "
            "main path's shapes")
        with phase_sql(torch, args.seed) as st:
            moments_by["6-7"] = st.launches
            if "8" in phases:
                moments_by["8"], w = phase_surface(st.sql, st.cpu,
                                                   st.cpu_24h, st.cpu_p)
                walls["8"] = w["phase"]
            del st.cpu_24h
            if "10" in phases:
                flows = phase_flows(st.sql, st.cpu_full, st.cpu_p,
                                    st.queries, st.ties, st.eight)
                moments_by["10"] = flows["launches"]
                walls["10"] = flows["walls"]["phase"]
            if "12" in phases:
                wire = phase_wire_sql(torch, st.sql, st.queries, st.cpu_p)
                moments_by["12"] = wire.moments
                walls["12a"] = wire.walls["phase"]
        shapes.update(phase_moments_time(
            torch, {q: st.inputs[q] for q in smb.QUERIES}))
        del st
        if "10" in phases:
            log("== phase 10's fold launch against the plain version")
            shapes.update(phase_moments_time(
                torch, {"phase 10 fold": flows.pop("fold_inputs")},
                tool=False))
        log(f"phase 8 took {walls.get('8', 0.0):.1f}s and phase 10 "
            f"{walls.get('10', 0.0):.1f}s of the script's "
            f"{time.perf_counter() - t_all:.1f}s so far")
    if "9" in phases:
        with phase_promql_tables(torch, p4) as p9:
            k1_by["9"], moments_by["9"] = p9.k1, p9.moments
            if "11" in phases:
                http = phase_http(torch, p9.pf, p4, args.seed, p9.answers)
                k1_by["11"], moments_by["11"] = http.k1, http.moments
            if "12" in phases:
                wire = phase_wire_prom(torch, p9.pf, p9.start)
                k1_by["12"] = wire.k1
                moments_by["12"] = moments_by.get("12", 0) + wire.moments
                walls["12b"] = wire.walls["phase"]
        del p4
        log("== phase 9's segment_moments shapes against the plain version")
        shapes.update(phase_moments_time(
            torch, {f"phase 9 {q}": a for q, a in p9.inputs.items()},
            tool=False))
        del p9
    if "12" in phases:
        log(f"phase 12 took {walls['12a']:.1f}s (12a) + "
            f"{walls.get('12b', 0.0):.1f}s (12b)")
    kernels = []
    if k1_by:
        kernels.append({**kern[0], "launches": sum(k1_by.values()),
                        "launches_by_phase": k1_by})
    if moments_by:
        # Q1 is the kernel's row (a run without phase 6: the first shape
        # timed); every shape's numbers beside it
        row = shapes["Q1"] if "Q1" in shapes else next(iter(shapes.values()))
        kernels.append({
            "name": "segment_moments", "route": "cuda",
            "source": "greptimedb_tpu_torch/csrc/segment_moments.cu",
            "replaces": "greptimedb_tpu/ops/kernels.py:730", **row,
            "by_shape": shapes, "launches": sum(moments_by.values()),
            "launches_by_phase": moments_by})
    new = set(sys.modules) - before
    bad = sorted(m for m in new if m.split(".")[0] in
                 ("jax", "jaxlib", "greptimedb_tpu"))
    check(not bad, f"the port imported {bad[:5]}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    # a run of chosen phases says so in its last two lines
    chosen = {} if phases == set(PHASES) else \
        {"phases": sorted(phases, key=int)}
    # the kernels the main paths launched; the bucket entry, which is off
    # them, gets a line of its own
    if kern is not None:
        print(json.dumps({"entries_off_main_path": [kern[1]]}), flush=True)
    print(json.dumps({"kernels": kernels, **chosen}), flush=True)
    print(json.dumps({"ok": True, **chosen, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
