#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (greptimedb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--phases LIST]

Phases (none of them catches a failure; any failed check exits non-zero).
With no `--phases` every phase runs; `--phases 12` (a comma-separated
list) runs the phases named and those they stand on (phases 1 and 2
always; 12 and 13 need 5, 6 and 7, and 12 runs 12b only with 9; 14,
15 and 19 need none; 16 needs 15, 17 needs 16, 18 needs 17), and names
them in its last two lines:

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and whether pandas, pyarrow, prometheus_client, aiohttp (phase 11's
   server) and cryptography import here;
2. builds the three kernels of greptimedb_tpu_torch/csrc, the
   window-bounds kernel, the segment-moments kernel and the
   grouped-moments kernel, one nvcc (sm_90a) each, started together, into the package's git-ignored build directory, and prints
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
   path); SET exact_distinct accepted, the standalone plan unchanged (it
   steers the distributed sketch partial, phase 18); avg(usage_user + usage_system) and sum(usage_user * 2) by
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
   segment_moments launch each; avg of the instant selector), cold (the
   rate shape warm too), within rtol 2e-5 of a float64 brute force, the
   lowered frame's series keys against the reference's rendering over its
   first 576 400 rows, and again on the row
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
   code 6001, counted by /status; /v1/scripts with a script of no
   coprocessor and /debug/prof/cpu in an unknown format answer the 400
   envelope; /metrics carries the greptime_http_request latency series.
   Then the server shuts down.
12. the MySQL and Postgres wire servers (servers/mysql.py,
   servers/postgres.py), every statement over a real socket through a
   minimal client of each protocol; its launches set to 0 before and
   read after. 12a, inside phase 6's run after phase 10, on phase 6's
   frontend and tables: MysqlServer(fe) and PostgresServer(fe) on port
   0; Q3-Q6 on cpu warm through do_query, then over MySQL and over
   Postgres (Q1's and Q2's 48 000 rows are cut for time: Q3-Q6 take the
   same per-row encoding), each column's name and wire type and each value's
   text equal to the servers' encoding of do_query's Output, the three
   walls printed (the static dispatch floor pinned before each, so the
   three take one route); SELECT 1 x 50 in turns over each wire and
   through do_query (the wires' own cost). KILL: Q1 on cpu_24h streamed
   ("host" mode, whose run to its end in phase 7 gives one slice's time:
   its wall over its slices, two in flight) over MySQL; SHOW FULL
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
13. the trace store, the profiler, the self-monitor and coprocessor
   scripts (common/trace_store.py, common/profiler.py, monitor/,
   script/), inside phase 6's run after phase 12a, on phase 6's frontend
   and `cpu`, with the launch counts set to 0 before and read after.
   13a: Q6 and Q1 warm (the static dispatch floor pinned before each, so
   both launch), five times in turns with tracing and profiling off (SET
   trace_sample_ratio = 0, SET profiling = 0) and on (ratio 1, profiling
   at 250 Hz), the medians printed; ADMIN SHOW TRACE of the last Q1 and
   Q6, whose stored waterfalls must be the reference's (execute_stmt →
   tpu_execute → region_scan on the resident path); after a
   self_monitor.tick(), ADMIN SHOW PROFILE 'last' holds the last Q1's
   samples, frames of the port among them. 13b: three ticks, their walls
   and the system tables' row counts; TQL EVAL of rate() over one
   node_metrics series (the row path: K1) within rtol 1e-5 of the same
   TQL on the CPU; an aggregate over greptime_private.trace_spans with
   the floor at 0 (one segment_moments launch) equal to the pandas path.
   13c: an HttpServer over the frontend; POST /v1/scripts of a
   coprocessor whose sql is Q5 and whose body standardizes the per-host
   stddev in torch on the card (it asserts `.is_cuda`), /v1/run-script,
   and the coprocessor as a SQL UDF over the stored spans' durations,
   each within 8 eps32 sum|x| of numpy. 13d: GET
   /debug/prof/cpu?seconds=1 while Q1 runs on another thread: folded
   stacks with frames of the port's query path. Without phase 4, K1's
   kernel-table row is timed at 13b's inputs.
14. the standalone process as users start it, over an S3 data home with
   the LRU disk cache (storage/{s3,cache}.py, cmd/, servers/flight.py,
   client/), with a data home of its own and its launch counts set to 0
   before and read after. 14a: a mock S3 endpoint in a child process (a
   ThreadingHTTPServer on loopback over a directory: PUT, GET, HEAD,
   DELETE, ListObjectsV2), a TOML in the reference's layout ([storage]
   type S3 with cache_path and a cache_capacity that holds the SSTs,
   [http], [mysql], [postgres], [grpc] on free loopback ports), and
   cmd.main.load_options -> build_servers, every server started. 14b:
   TSBS cpu-only, 4000 hosts x 3 h (4.32 M rows), CREATE TABLE and
   Database.bulk_load over Flight do_put, ADMIN FLUSH TABLE through
   Database.sql; the walls, the bucket's objects and bytes and the PUT
   rate. 14c: Q1, Q5 and Q6 through Database.sql (the dispatch floor
   pinned by SET over Flight before each), each cold and warm (median of
   3), one segment_moments launch each, in three opens of the process:
   the first with the cache empty (the SSTs pulled from S3), a restart on
   the same cache (the index recovered from disk: no SST pulled), a
   restart on a fresh cache (pulled again), the last two with Q1 alone
   (Q5 and Q6 cut for time); each answer against the
   float64 brute force of phase 6 over the same rows, the opens equal
   exactly; in the first open the same queries through do_query (the
   Flight front door's cost) and Q5 and Q6 over /v1/sql and MySQL, equal
   to Flight's rows. 14d: a per-series TQL EVAL of rate() over one host's
   usage_user (the row path: K1) through Database.sql, within rtol 1e-5
   of the same TQL on a device="cpu" build over the bucket opened after
   the card's process is shut down. 14e: `python3 -m
   greptimedb_tpu_torch.cmd.main standalone start -c <toml>` as a child
   process with a fresh cache: its count(*) and Q6 through Database equal
   14c's; nvidia-smi's compute apps gain its row (the card's machine
   reports pids of another namespace) and it holds /dev/nvidia* open;
   `cli attach` prints the count; SIGTERM ends it with 0 within 10 s.
   Without phases 4 and 13, K1's row is timed at 14d's inputs; without
   phase 6, segment_moments' at 14c's first Q1.
15. the datanode as a cluster member (meta/, datanode/, servers/flight.py's
   FlightDatanodeServer, client/), with a data home of its own and its
   launch count set to 0 before and read after. 15a: MetaSrv(MemKv())
   with an in-process MetaClient; two DatanodeInstances (node ids 1 and
   2, device "cuda") on one data home, each behind a FlightDatanodeServer
   and registered by its first heartbeat; create_table_route places a
   table's four regions (TSBS cpu-only's DDL, PARTITION BY RANGE COLUMNS
   (hostname) at cpu_p's boundaries over all 4000 hosts), two on each
   node (load_based), and FlightDatanodeClient.ddl_create_table creates
   each node's own. 15b: TSBS cpu-only, 4000 hosts x 3 h (4.32 M rows),
   each region's rows by write_region(op="bulk") over Flight do_put to
   its node (do_put -> arrow_to_ingest_columns -> bulk_ingest), both
   nodes at once; the wall and rows/s beside each region's bulk_ingest
   profile. 15c: Q1, Q5 and Q6 as region_moments tickets (the plan as
   query/plan_codec.py encodes it) to both nodes at once, cold (scan
   cache cleared) and warm, each beside the same calls through
   LocalDatanodeClient in this process; every launch of the Flight calls
   on a server thread, of the local ones on this one; the Flight frames
   bit-equal to the local ones; the partial_wire bytes; the folded answer
   (_finalize and the statement's projection, as a frontend folds it)
   against phase 6's float64 brute force; `regions=[r]` of a node's own
   region gives that region's frame alone, and a region the other node
   hosts raises StaleRouteError through the Flight client. 15d: a full
   heartbeat from each node (its wall): cluster_info lists two alive
   datanodes whose approximate_rows sum to 4.32 M, region_heat names the
   four regions, and a flush_table mailed to node 2 runs on its next
   beat. 15e: node 2 shut down and reopened with node id 2 on the same
   data home behind a new server (its wall): it hosts its two regions
   and its cold Q1 frames are bit-equal to those before. Then
   segment_moments is timed at the first region Q1 launch's inputs.
16. the cluster's control plane as processes (meta/flight.py,
   meta/replication.py, cmd/main.py's metasrv and datanode start, failover
   adoption), with a data home of its own; its launches are those the
   datanode processes' ExecStats report (each wrapper counts its launch
   on the active collector, which rides the Flight response home), from
   processes that start at 0. 16a: three `python3 -m
   greptimedb_tpu_torch.cmd.main metasrv start --peers a,b,c` children on
   free ports, each with a raft store, `--failover-interval 1
   --datanode-lease-secs 3`, and with them two `datanode start --node-id
   1|2 --metasrv-addr a,b,c --heartbeat-interval 0.5` children on one
   data home, on the card (each waits for a meta leader);
   FailoverFlightMetaClient reaches the leader (cluster_info); the
   datanodes registered by their first beats, pinged through PeerClientRegistry's
   lazily dialled FlightDatanodeClients. 16b: phase 15's table: meta
   places the four regions (two a node) and keeps the table info,
   ddl_create_table, write_region(op="bulk") of the 4.32 M rows to both
   nodes at once and flush_table, all through the registry. 16c: Q1, Q5
   and Q6 as region_moments over Flight, twice each (the first Q1 cold:
   the children's scan caches cannot be cleared from here, so Q5 and Q6
   first read what Q1 cached), one launch a region a call, every region
   on the device-resident route (the nodes' ExecStats), each region's
   frame bit-equal across the two runs, the folded answer against phase
   6's float64 brute force; each datanode holds /dev/nvidia*, no metasrv
   does. 16d: SIGKILL of datanode 2; the times until meta's route moves
   its regions to node 1, until node 1 has adopted them through the
   heartbeat mailbox (describe_table lists all four) and until Q1, Q5 and
   Q6 over all four regions on node 1 equal the answers before the kill
   (each region's frame bit-equal). 16e: SIGKILL of the raft leader; the
   time until FailoverFlightMetaClient reads the route from a new leader,
   equal to the route before, and until node 1's heartbeats show it alive
   in the new leader's cluster_info. 16f: no surviving metasrv holds the
   card; SIGTERM ends node 1 and both metasrv children with 0 within
   10 s.
17. the distributed frontend as a process (frontend/distributed.py,
   cmd/main.py's frontend start), riding phase 16's cluster; its
   launches are those the node blocks of its EXPLAIN ANALYZE answers
   report (the datanodes' ExecStats, carried over Flight) and those of
   the distributed goldens in this process. 17a: a `frontend start
   --metasrv-addr a,b,c` child with HTTP, MySQL and Flight addresses on
   the card, spawned with 16a's metasrv and datanodes (it waits for a
   meta leader: a frontend reads meta's KV when it is built), no
   self-monitor scrape;
   the time from its spawn to its first /v1/sql answer. 17b, between 16c
   and 16d: DESCRIBE TABLE cpu (the table hydrated from meta's route) and
   SHOW TABLES; Q1, Q5 and Q6 over /v1/sql and over Flight (Database),
   equal to each other, within phase 16's bounds of the float64 brute
   force and within twice them of 16c's fold; EXPLAIN ANALYZE Q1 through
   /v1/sql (`aggregate-pushdown (regions pruned 0/4, fan-out=2 ...`, a
   node block for each datanode with its segment_moments launches) and a
   one-host statement pruned to one region (fan-out=1), its count and avg
   against the brute force. 17c: CREATE TABLE cpu_f at cpu_p's boundaries
   over /v1/sql, the first hour of phase 16's rows (1.44 M) by
   Database.bulk_load to the frontend (handle_bulk_load -> _split_write
   -> write_region(op="bulk") on the owners), a 4-row INSERT over MySQL
   with a row in each region, each node's regions holding the rows the
   rule puts there (scans of a region each), Q1 on cpu_f against a
   float64 host fold of the same rows, DROP TABLE. 17d, after 16d's
   adoption: the frontend's next Q1 (its route still names the dead
   node) answers within the bounds through a stale-route retry (its log
   says so), timed from the SIGKILL; EXPLAIN ANALYZE Q1 then scatters to
   node 1 alone. 16f's SIGTERM ends the frontend too. 17e: the ten
   distributed sqlness goldens through tools/sqlness.py's DistEnv (two
   datanodes and a DistInstance in this process) on the card, byte-equal
   to their .result files (admin/migrate_region and
   system/{cluster_info,region_peers} among them).
18. the rest of the distributed plane over phase 16's processes, after
   16e (datanode 2 dead, its regions on node 1; two metasrv alive):
   an in-process DistInstance(meta, PeerClientRegistry, device="cuda"),
   so K1's launches on the frontend's device count here (0 before, read
   after its statements), and one request of each kind through the
   `frontend start` child. 18a: PromQL over the cluster's 4.32 M rows:
   rate(cpu{__field__='usage_user', hostname=~'host_1.*'}[5m]) over the
   span on the row path (the wire RawScan's rows and time, the run-wise
   labelling's time against the reference's row-wise loop on one
   region's batches, with the same labels and matrix), each K1 launch
   against its plain version, K1 timed at this shape; the same through
   the child's /api/v1/query_range; sum by (region) (rate(...[5m])) at
   5 m and an instant avg through the aggregate pushdown, TQL ANALYZE's
   node blocks with the datanodes' segment_moments launches; every
   answer against the same TQL on an in-process standalone instance over
   the same rows, loaded on a thread from the end of 16b (the row path
   bit-equal, the lowered ones within rtol 2e-5). 18b: count(DISTINCT hostname) exact (TpuAggregateExec; the
   child's too) and count(DISTINCT usage_user) (past the 4096-value set)
   within four HLL standard errors of SET exact_distinct = 1's answer,
   which equals numpy's. 18c: `datanode start --node-id 3` (spawned at
   18a's start), SET balancer_enabled = 0, ADMIN MIGRATE REGION onto it
   through the child (while 18b runs) and ADMIN SPLIT REGION at a
   region's median host (while 18e runs and a small table's region gets
   a replica by ADD REPLICA and loses it by REMOVE REPLICA), each timed
   to region_peers showing it done, Q1 bit-equal before and after each.
   18e: at trace ratio 1, ADMIN SHOW TRACE 'last' of a scattered Q1
   lists spans of dn1 and dn3; cluster_info from meta (the child's too).
   18d: ADMIN ADD REPLICA of dn3's region onto dn1; acknowledged
   INSERTs; with SET read_replica = 'follower' reads land on the
   caught-up follower (EXPLAIN ANALYZE's node blocks, with its launch)
   with the same count (the child's too); SIGKILL of dn3 under
   acknowledged ingest: the times until the route names the promoted
   follower and until every acknowledged row reads back exactly once.
19. the grouped-moments kernel and parallel/ on torch.distributed, with
   its launch counts set to 0 before its main path and read after. 19a:
   TSBS cpu-only, 4000 hosts x 12 h (17.28 M rows; the fields' random
   walks made on the card from --seed) in the generator's time-major
   order, group ids host x hour (48 000 groups), about 10 % of rows
   masked; grouped_moments against grouped_moments_plain on the
   card (counts, min, max, first, last exact; float sums within 1 ulp
   plus 8 eps64 sum|x|; two launches) at the timing tool's edge cases
   (greptimedb_tpu_torch/tools/grouped_moments_bench.py: all rows
   masked, empty groups, a wrapping int32 column, column masks, NaN and
   ts ties, ids outside the groups, each side of the small path's
   threshold, Gp and Gp + 1 groups, partitions of one and of many work
   items, empty partitions, 7.5 M groups (partitions counted in
   windows), one group of 2 M rows, 48 000 groups, one group with 90 % of
   2 M rows, 33 moments, no rows, 19a's shape sorted by group and in
   random order, and in random order with NaN, ts ties and column masks
   over two row chunks) and at the
   main path's inputs: grouped_aggregate of Q1's avg over the ten fields
   plus max, min, stddev, first and last of usage_user, itself checked
   against float64 numpy. 19b: init_process_group("nccl") in this
   process (world size 1: NCCL takes one rank per GPU and this process
   drives one): distributed_grouped_aggregate at 19a's shape against
   grouped_aggregate; series_sharded_range_aggregate of rate and
   avg_over_time at phase 4's shape (4000 series x 8640 samples, epoch
   ms rebased) bit for bit against range_aggregate_cumsum (8 series
   against float64 numpy), and max_over_time at phase 4's cut (one
   region's hosts x 2 h) against range_aggregate_gather;
   time_blocked_window_sum over [4000, 1440] at window 5 (sum, avg, min,
   max) against numpy; tools.multichip.dryrun_multichip on "cuda" (its
   distributed query's datanodes launch segment_moments); then
   destroy_process_group. Then grouped_moments is timed at 19a's inputs
   and at the same rows in random order (CUDA events, median of 5 over
   20 calls behind a spin kernel) beside its plain version, one
   index_add_ / scatter_reduce_ per moment, and its byte bound (the
   timing tool's formulas).
20. the race hammer on the card: `python3 -m
   greptimedb_tpu_torch.tools.race_hammer --device cuda` as a child
   process with GREPTIME_RACE_CHECK=1 (the port's race detector on, and
   lock tracking with it). The child first plants a race of its own,
   then runs for RACE_HAMMER_S seconds concurrent ingest, flush,
   compaction, distributed scatter, balancer ticks, self-monitor
   scrapes and PromQL range queries over an in-process cluster of two
   datanodes on the card: aggregates on the device-resident route
   (segment_moments, the scan cache, fused scans) and, while a thread
   lowers the streaming threshold, on the streamed cold route with
   cold_reduce = "device" (staged mirrors on a side stream); TQL EVAL of
   rate() through K1. The phase fails on any unsuppressed race, on no
   tracked access, on an unreported seeded race, or on a route the
   child did not launch; the child's launches join the kernel table.
   Phase 16 spawns its datanodes and frontend with the metasrv children
   and phase 18a's standalone loads on a thread from 16b on: the time
   this phase takes is taken back there.

Before the last line come two JSON objects: the numbers of the bucket
entry, which the main paths do not launch, then the kernel table of the
main paths (PromQL's window bounds, SQL's, the flow folds', the HTTP
front door's, the wires', phase 13's, 14's, 15's, 16's, 17's, 18's,
19's and 20's segment moments, phase 18's window bounds on the
distributed frontend, phase 19's on each rank and phase 20's in the
hammer's child, phase 19's grouped moments), each with its
launches by phase; the last line is {"ok": true, "device": {...}}. A run
of chosen phases lists only the kernels it launched, and both lines
carry "phases": the list of those that ran.
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

def phase_machine(torch) -> str:
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
    return smi


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
    """Every kernel's library, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from greptimedb_tpu_torch.ops import cuda_build
    names = ("counts_leq", "segment_moments", "grouped_moments")
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
    # the queries' span (SQL_HOURS), or the table's if shorter (phase 14)
    hours = min(SQL_HOURS, n // per_h)
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
        df = bucketed(np.arange(H), hours, per_h,
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
            key = {"hour": TSBS_START_MS + np.arange(hours) * 3600_000}
            first, last = X[ties[0], ::per_h], X[ties[2], per_h - 1::per_h]
            X = X.reshape(H, hours, per_h).transpose(1, 0, 2).reshape(
                hours, H * per_h)
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
        # timed, and the self-monitor scrapes when phase 13 ticks it: no
        # background tick of either
        self.fe = build_standalone(DatanodeOptions(
            data_home=self.data_home, flow_tick_interval_s=0,
            self_monitor_interval_s=0, device=DEVICE))
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
        launches_24h, cpu_24h, q1_24h = sql_streamed_24h(sql, seed + 7)
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
            inputs=inputs, q1_24h=q1_24h)
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
    force. Returns the launches, phase 8's copy of the table (ts, each
    host's region, usage_user and usage_system) and Q1's "host" run (its
    wall in s and its slices: phase 12a's KILL is held to one slice's
    time)."""
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
    launches, q1_host = 0, None
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
        elif name.startswith("Q1"):
            q1_host = (sql.last.wall, sum(p.counters.get("slices", 0)
                                          for p in sql.last.profiles))
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
    return launches, keep, q1_host


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
    accepted, the plan unchanged; the expression aggregates by host on cpu and cpu_24h;
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
    # SET exact_distinct acts only on the distributed pushdown's
    # count(DISTINCT) sketch partial (phase 18 drives it): a standalone
    # table keeps the exact raw-row plan either way, as in the reference
    from greptimedb_tpu_torch.query import sketches as sk
    text = DISTINCT.format(t="cpu", lo=int(cpu.ts[0]),
                           hi=int(cpu.ts[0]) + SKETCH_SPAN_MS)
    plans = []
    for v in (1, 0):
        sql.do(f"SET exact_distinct = {v}")
        check(sk.exact_distinct_forced() == bool(v),
              f"SET exact_distinct = {v} did not reach the sketch knob")
        plans.append(sql_frame(sql.do("EXPLAIN " + text))["plan"][0])
    check(all(p.startswith("CpuAggregateExec") for p in plans),
          f"count(DISTINCT) on the standalone cpu: plans {plans}")
    log("  check SET exact_distinct = 1 / 0: accepted; count(DISTINCT) on "
        "the standalone table plans CpuAggregateExec either way")

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
        self.fe = build_standalone(DatanodeOptions(
            data_home=data_home, self_monitor_interval_s=0, device=DEVICE))
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


#: the lowered frame's leading rows series_keys_check renders the
#: reference's way (about 7 us a row in Python: the whole 5.76 M-row frame
#: took 41 s of the script's time limit)
SERIES_KEYS_CHECK_ROWS = 576_400


def series_keys_check(frame):
    """The lowered frame's series keys (eval_lowered's first step on the
    host), rendered as greptimedb_tpu/promql/lowering.py's eval_lowered
    renders them (every row's key values, then the distinct tuples
    sorted) and by the port's _series_keys (each column factorised, each
    distinct value rendered once), over the frame's first
    SERIES_KEYS_CHECK_ROWS rows: the same keys and row indices, each
    timed (eval_lowered runs _series_keys over the whole frame)."""
    from greptimedb_tpu_torch.promql import lowering
    from greptimedb_tpu_torch.query.planner import _group_slot
    df = frame[frame["__n"].to_numpy() > 0].iloc[:SERIES_KEYS_CHECK_ROWS]
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
            # rate's shape runs warm again at 24 h; the launching shapes
            # read warm over 1 h below (the script's time limit)
            for run in ("cold", "warm") if nm == 0 else ("cold",):
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
                # the 24 h launch's inputs, for the kernel's check and
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
        # over HTTP only (the script's time limit): the direct call of the
        # same instant query took as long again (15-16 s), and the answer
        # is held to the float64 brute force below
        data = door.prom(inst_q, "/api/v1/query", inst_q, end, end, 1000,
                         k1=0, moments=1, direct=False, instant=True)
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

        # ---- admission, the script and profiler routes, /metrics ----
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
        # the script and profiler routes' own validation envelopes (phase
        # 13 drives the routes themselves)
        from greptimedb_tpu_torch.errors import StatusCode
        for path, method, error in (
                ("/v1/scripts?name=s", "POST", "defines no @copr"),
                ("/debug/prof/cpu?format=pprof", "GET",
                 "not supported")):
            doc, _, _ = http.json(path, status=400, method=method,
                                  body=b"" if method == "POST" else None)
            check(doc["code"] == int(StatusCode.INVALID_ARGUMENTS) and
                  error in doc["error"], f"{path}: {doc}")
        code, body, _, _ = http.call("/metrics")
        text = body.decode()
        series = sorted({re.search(r'route="([^"]*)"', ln).group(1)
                         for ln in text.splitlines()
                         if ln.startswith("greptime_http_request_seconds_"
                                          "count{")})
        check(code == 200 and series, "/metrics has no greptime_http_request "
              "latency series")
        log(f"/v1/scripts with no @copr and /debug/prof/cpu?format=pprof: "
            f"the 400 envelope; /metrics: greptime_http_request_seconds for "
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
#: the queries phase 12a no longer sends over the wires (the script's time
#: limit): Q1's and Q2's 48 000 rows take the per-row encoding that Q3-Q6
#: still take, and phase 14 sends Q1 over Flight
WIRE_CUT = ("Q1 double-groupby-all", "Q2 double-groupby-1")
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


def wire_kill(sql, my_srv, pg, q1, pin, q1_24h):
    """Q1 streamed on cpu_24h ("host" mode) over MySQL; SHOW FULL
    PROCESSLIST over Postgres lists it; KILL <id> over Postgres ends it
    and MySQL's client gets the cancel error within one slice's time;
    the MySQL connection then answers; COM_PROCESS_KILL of an unknown id
    is errno 1094. `q1_24h` is phase 7's run of the same statement to its
    end: (wall s, slices). Returns (the kill latency, one slice's time)
    in s."""
    import threading
    q = re.sub(r"\bFROM cpu\b", "FROM cpu_24h", q1)
    # phase 7 ran the statement to its end in the same mode: its wall
    # over its slices (two in flight at a time) is one slice's time
    full, slices = q1_24h
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
    log(f"KILL: Q1 on cpu_24h streamed over MySQL (run to its end in "
        f"phase 7: "
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


def phase_wire_sql(torch, sql, queries, cpu_p, q1_24h):
    """Phase 12a: the MySQL and Postgres servers over phase 6's frontend
    (after phase 10's restart): Q2-Q6 on cpu warm over each wire against
    do_query (Q1's 48 000-row answer is cut for time: Q2's 48 000 rows
    take the same encoding), the wires' own cost, KILL of a streamed Q1 on
    cpu_24h (`q1_24h`: phase 7's run of it), and COPY on cpu_p. Returns
    its segment_moments launches and walls."""
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
            if name in WIRE_CUT:
                continue
            # warm: the scan cache filled by the statement's first run
            pin()
            sql.fe.do_query(q)
            wire_same(name, sql.fe, my, pg, q, walls, pin)
        walls["select 1"] = wire_front_cost(sql.fe, my, pg)
        q1 = next(q for n, q in queries.items() if n.startswith("Q1"))
        walls["kill"], walls["slice"] = wire_kill(sql, my_srv, pg, q1,
                                                    pin, q1_24h)
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


# ---------------------------------------------------------------------------
# phase 13: the trace store, the profiler, the self-monitor, scripts
# ---------------------------------------------------------------------------

#: ADMIN SHOW TRACE's waterfall of a device-path aggregate on a resident
#: region, as (span, depth, parent span): what the reference's
#: FrontendInstance renders for the same statement
#: (tests/test_torch_trace_store.py holds the two packages to each other)
DEVICE_WATERFALL = [("execute_stmt", 0, None),
                    ("tpu_execute", 1, "execute_stmt"),
                    ("region_scan", 2, "tpu_execute")]
#: the warm queries run with tracing and profiling off, then on, in turns
OBSERVED = ("Q6 global aggregate", "Q1 double-groupby-all")
OBSERVE_REPS = 5
#: tracing and profiling on: every trace kept, the sampler at its top rate
OBSERVE_ON = ("SET trace_sample_ratio = 1", "SET profiling = 1",
              "SET profile_hz = 250")
OBSERVE_OFF = ("SET trace_sample_ratio = 0", "SET profiling = 0")
MONITOR_TICKS = 3
#: the node_metrics series 13b's TQL reads: every statement counts there
MONITOR_METRIC = "greptime_stmt_query_total"
#: 13b's aggregate over the stored spans
SPANS_AGG = ("SELECT span_name, count(*) AS n, max(duration_ms) AS m, "
             "sum(duration_ms) AS t FROM greptime_private.trace_spans "
             "GROUP BY span_name ORDER BY span_name")
#: 13c's SQL UDF call: the coprocessor over the stored spans' durations
#: (a small table: a UDF runs on the raw-row path, whose pandas frame of
#: `cpu` would take ~25 s to build)
UDF_SQL = ("SELECT span_id, {col} FROM greptime_private.trace_spans "
           "ORDER BY span_id")
BURST_S = 1


def zscore_script(q5):
    """13c's coprocessor: Q5's per-host stddev of usage_user standardized
    in torch, on the card (its body checks where its tensor is)."""
    where = "x.is_cuda" if DEVICE == "cuda" else \
        f"x.device.type == {DEVICE!r}"
    return (f"@copr(args=['stddev(usage_user)'], returns=['z', 'device'],\n"
            f"      sql={q5!r})\n"
            f"def zscore(s):\n"
            f"    x = torch.as_tensor(s)\n"
            f"    assert {where}, f'the body ran on {{x.device}}'\n"
            f"    z = (x - x.mean()) / x.std(unbiased=False)\n"
            f"    return z, x.device.type\n")


def standardize_check(name, got, x):
    """`got` against numpy's standardization of float64 `x`, within
    8 eps32 sum|x| per value."""
    x = np.asarray(x, dtype=np.float64)
    want = (x - x.mean()) / x.std()
    got = np.asarray(got, dtype=np.float64)
    bound = 8 * np.finfo(np.float32).eps * np.abs(x).sum()
    err = float(np.abs(got - want).max())
    check(got.shape == want.shape and err <= bound,
          f"{name}: max |err| {err:.3g} against numpy, bound {bound:.3g}")
    return err, bound


def waterfall_structure(fe, trace_id):
    """(span, depth, parent span) of a stored trace, depth-first."""
    from greptimedb_tpu_torch.common import trace_store
    rows = trace_store.fetch_trace(fe.catalog, trace_id)
    by_id = {r["span_id"]: r for r in rows}
    out = []
    for r in sorted(rows, key=lambda r: (r["ts"], r["span_id"])):
        depth, p = 0, r["parent_span_id"]
        while p in by_id:
            depth, p = depth + 1, by_id[p]["parent_span_id"]
        parent = by_id.get(r["parent_span_id"])
        out.append((r["span_name"], depth,
                    parent["span_name"] if parent else None))
    return sorted(out, key=lambda t: t[1])


def observe_queries(sql, queries, pin):
    """13a: Q6 and Q1 warm, in turns with tracing and profiling off and
    on; the traced statements' waterfalls; the profile of the last one.
    Returns the walls."""
    from greptimedb_tpu_torch.common import profiler, trace_store
    from greptimedb_tpu_torch.ops import kernels as K
    fe, torch = sql.fe, sql.torch
    sink = trace_store.sink()
    walls = {(q, m): [] for q in OBSERVED for m in ("off", "on")}
    traced = {}
    launched = K.segment_moments.launches
    for _ in range(OBSERVE_REPS):
        for mode, knobs in (("off", OBSERVE_OFF), ("on", OBSERVE_ON)):
            for k in knobs:
                sql.do(k)
            if mode == "on":
                # a sampler switched off polls its knob every IDLE_POLL_S:
                # let it wake before the timed runs
                time.sleep(profiler.Profiler.IDLE_POLL_S + 0.05)
            for name in OBSERVED:
                pin()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sql.do(queries[name])
                torch.cuda.synchronize()
                walls[(name, mode)].append(time.perf_counter() - t0)
                if mode == "on":
                    traced[name] = sink.last_retained
    # the sampler stops before the reads, so 'last' stays the last Q1
    profiler.configure(enabled=False)
    time.sleep(0.05)
    launched = K.segment_moments.launches - launched
    check(launched == OBSERVE_REPS * 2 * len(OBSERVED), f"the timed runs "
          f"launched segment_moments {launched} times, not once each")
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    for name in OBSERVED:
        off, on = med[(name, "off")], med[(name, "on")]
        log(f"  {name} warm, median of {OBSERVE_REPS} in turns: tracing "
            f"and profiling off {off:.1f} ms, on (ratio 1, 250 Hz) "
            f"{on:.1f} ms ({(on - off) / off * 100:+.1f} %); all: off "
            + " / ".join(f"{w * 1e3:.1f}" for w in walls[(name, "off")])
            + ", on " + " / ".join(f"{w * 1e3:.1f}"
                                   for w in walls[(name, "on")]))
    last = traced[OBSERVED[-1]]
    check(last == sink.last_retained, "the last traced statement is not "
          "the last retained trace")
    # the last Q1 first: each ADMIN statement is a retained trace too
    for name in reversed(OBSERVED):
        tid = traced[name]
        sql_show = "ADMIN SHOW TRACE 'last'" if tid == last else \
            f"ADMIN SHOW TRACE '{tid}'"
        t0 = time.perf_counter()
        out = sql.do(sql_show)
        wall = time.perf_counter() - t0
        d = out.batches[0].to_pydict()
        got = waterfall_structure(fe, tid)
        check(got == DEVICE_WATERFALL, f"{name}: the stored waterfall is "
              f"{got}, not the reference's {DEVICE_WATERFALL}")
        check([s.strip(" └─") for s in d["span"]] ==
              [n for n, _, _ in DEVICE_WATERFALL] and
              '"path":"resident"' in d["detail"][-1],
              f"{sql_show}: spans {d['span']}, {d['detail']}")
        log(f"  {sql_show} ({name}, {wall * 1e3:.1f} ms): " + "; ".join(
            f"{s.strip()} {dur:.1f} ms (self {own:.1f})" for s, dur, own in
            zip(d["span"], d["duration_ms"], d["self_ms"])) +
            f"; the reference's spans, depths and parents")
    sampled = profiler.sampler().last_query_trace
    check(sampled == last, f"the profiler's last sampled statement is "
          f"{sampled}, not the last Q1 {last}")
    t0 = time.perf_counter()
    ticked = fe.self_monitor.tick()
    tick_s = time.perf_counter() - t0
    out = sql.do("ADMIN SHOW PROFILE 'last'")
    d = out.batches[0].to_pydict()
    check(out.num_rows > 0 and max(d["total_samples"]) >= 1,
          "ADMIN SHOW PROFILE 'last' holds no sample of the last Q1")
    port_frames = [f for f in d["frame"] if "greptimedb_tpu_torch/" in f]
    check(bool(port_frames), "the last Q1's profile holds no frame of the "
          "port")
    top = sorted(zip(d["self_samples"], d["frame"]), reverse=True)[:3]
    log(f"  tick {tick_s * 1e3:.1f} ms ({ticked} rows); ADMIN SHOW PROFILE "
        f"'last' (the last Q1): {out.num_rows} frames, "
        f"{max(d['total_samples'])} samples; top self: " + "; ".join(
            f"{f.strip(' └─')} {n}" for n, f in top))
    return med


def observe_monitor(sql, queries, pin, k1_calls):
    """13b: three ticks; TQL EVAL of rate() over node_metrics on the row
    path (K1), held to the same TQL on the CPU; an aggregate over the
    stored spans on the device path (segment_moments), held to the pandas
    path. Returns the tick walls and the device TQL's last K1 inputs."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.promql.engine import PromqlEngine
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql
    fe = sql.fe
    ticks, stamps = [], []
    for i in range(MONITOR_TICKS):
        if i:
            time.sleep(0.5)
        pin()
        sql.do(queries["Q6 global aggregate"])   # the counter moves
        t0 = time.perf_counter()
        written = fe.self_monitor.tick()
        ticks.append(time.perf_counter() - t0)
        stamps.append(int(time.time() * 1000))
        check(written > 0 and fe.self_monitor.stats["last_error"] is None,
              f"tick {i}: {written} rows, {fe.self_monitor.stats}")
    counts = {t: sql_frame(sql.do(f"SELECT count(*) FROM greptime_private."
                                  f"{t}"))["count(*)"].iloc[0]
              for t in ("node_metrics", "region_heat", "trace_spans",
                        "profile_samples")}
    log(f"  {MONITOR_TICKS} ticks: " + " / ".join(
        f"{w * 1e3:.1f}" for w in ticks) + " ms; rows: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    check(counts["region_heat"] >= MONITOR_TICKS, f"region_heat: {counts}")
    ctx = QueryContext(current_schema="greptime_private")
    tql = (f"TQL EVAL ({stamps[0] // 1000}, {stamps[-1] // 1000 + 1}, "
           f"'1s') rate(node_metrics{{metric_name=\"{MONITOR_METRIC}\"}}"
           f"[1m])")
    k0 = pw.counts_leq_grid.launches
    t0 = time.perf_counter()
    (out,) = fe.do_query(tql, ctx)
    wall = time.perf_counter() - t0
    k1 = pw.counts_leq_grid.launches - k0
    check(k1 > 0 and len(k1_calls) >= k1, f"the TQL over node_metrics "
          f"launched K1 {k1} times")
    k1_inputs = k1_calls[-1]
    got = sql_frame(out)
    t0 = time.perf_counter()
    plain = sql_frame(PromqlEngine(fe.catalog, device="cpu").execute_tql(
        parse_sql(tql), ctx))
    cpu_wall = time.perf_counter() - t0
    check(len(got) > 0 and list(got.columns) == list(plain.columns) and
          got.drop(columns="value").equals(plain.drop(columns="value")),
          f"the TQL over node_metrics: {got} against the CPU's {plain}")
    v, w = got["value"].to_numpy(float), plain["value"].to_numpy(float)
    check(np.isfinite(v).all() and (v >= 0).all() and
          np.allclose(v, w, rtol=1e-5, atol=0),
          f"rate over node_metrics: {v} against the CPU's {w}")
    log(f"  {tql} on the row path: {len(got)} points, K1 {k1} launches, "
        f"{wall * 1e3:.1f} ms; rates {v.min():.4g}-{v.max():.4g}/s, within "
        f"rtol 1e-5 of the same TQL on the CPU ({cpu_wall * 1e3:.1f} ms)")
    (region,) = fe.catalog.table("greptime", "greptime_private",
                                 "trace_spans").regions.values()
    saved = tpu_exec.TPU_DISPATCH_MIN_ROWS
    m0 = K.segment_moments.launches
    try:
        sql.do("SET tpu_dispatch_min_rows = 0")
        region.last_scan_profile = None
        t0 = time.perf_counter()
        dev = sql_frame(sql.do(SPANS_AGG))
        dev_wall = time.perf_counter() - t0
        check(region.last_scan_profile is not None and
              region.last_scan_profile.path == "resident",
              "the aggregate over trace_spans did not take the device")
        launched = K.segment_moments.launches - m0
        sql.do("SET tpu_dispatch_min_rows = 1000000000")
        region.last_scan_profile = None
        t0 = time.perf_counter()
        host = sql_frame(sql.do(SPANS_AGG))
        host_wall = time.perf_counter() - t0
        check(region.last_scan_profile is None,
              "the floor raised, the aggregate still took the device")
    finally:
        sql.do(f"SET tpu_dispatch_min_rows = {saved}")
    eps = np.finfo(np.float32).eps
    check(launched == 1 and dev["span_name"].equals(host["span_name"]) and
          dev["n"].equals(host["n"]) and
          np.allclose(dev["m"], host["m"], rtol=eps, atol=0) and
          (np.abs(dev["t"] - host["t"]) <= 8 * eps * host["t"].abs()).all(),
          f"trace_spans by span name, device {dev} against pandas {host}")
    log(f"  {SPANS_AGG}: {len(dev)} span names, {int(dev['n'].sum())} spans; "
        f"device path (1 segment_moments launch) {dev_wall * 1e3:.1f} ms == "
        f"pandas path {host_wall * 1e3:.1f} ms (counts exact, max and sum "
        f"within float32)")
    return ticks, k1_inputs


def observe_scripts(sql, client, queries, pin):
    """13c: the coprocessor stored over /v1/scripts, run over
    /v1/run-script and as a SQL UDF, each held to numpy. Returns the
    walls."""
    q5 = queries["Q5 per-host moments"]
    walls = {}
    pin()
    x = sql_frame(sql.do(q5))["stddev(usage_user)"].to_numpy(float)
    doc, _, walls["store"] = client.json(
        "/v1/scripts", method="POST", params={"name": "zscore",
                                               "db": "public"},
        body=zscore_script(q5).encode())
    check(doc == {"code": 0}, f"POST /v1/scripts: {doc}")
    pin()
    doc, _, walls["run"] = client.json(
        "/v1/run-script", method="POST", body=b"",
        params={"name": "zscore", "db": "public"})
    got = records(doc["output"][0])
    check(set(got["device"]) == {DEVICE},
          f"the body ran on {set(got['device'])}")
    err, bound = standardize_check("/v1/run-script zscore", got["z"], x)
    log(f"  POST /v1/scripts {walls['store'] * 1e3:.1f} ms; /v1/run-script "
        f"zscore (Q5's {len(x)} stddevs standardized in torch on "
        f"{got['device'][0]}) {walls['run'] * 1e3:.1f} ms; max |err| "
        f"{err:.3g} against numpy, bound {bound:.3g}")
    t0 = time.perf_counter()
    xs = sql_frame(sql.do(UDF_SQL.format(col="duration_ms")))
    plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = sql_frame(sql.do(UDF_SQL.format(col="zscore(duration_ms) AS z")))
    walls["udf"] = time.perf_counter() - t0
    check(out["span_id"].equals(xs["span_id"]), "the UDF's rows differ")
    err, bound = standardize_check("zscore() as a SQL UDF", out["z"],
                                   xs["duration_ms"])
    log(f"  {UDF_SQL.format(col='zscore(duration_ms) AS z')} ({len(xs)} "
        f"rows) through do_query {walls['udf'] * 1e3:.1f} ms (without the "
        f"UDF {plain * 1e3:.1f} ms); max |err| {err:.3g} against numpy, "
        f"bound {bound:.3g}")
    return walls


def observe_burst(sql, client, queries, pin):
    """13d: GET /debug/prof/cpu?seconds=1 while Q1 runs on another
    thread: folded stacks holding the port's query path. Returns the
    burst's wall."""
    import threading
    stop, runs, errors = threading.Event(), [], []

    def busy():
        try:
            while not stop.is_set():
                pin()
                sql.do(queries["Q1 double-groupby-all"])
                runs.append(1)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    th = threading.Thread(target=busy)
    th.start()
    try:
        code, body, headers, wall = client.call(
            "/debug/prof/cpu", params={"seconds": BURST_S})
    finally:
        stop.set()
        th.join(timeout=HTTP_TIMEOUT_S)
    check(not th.is_alive() and not errors, f"Q1 beside the burst: {errors}")
    lines = body.decode().splitlines()
    check(code == 200 and headers["Content-Type"].startswith("text/plain")
          and lines, f"/debug/prof/cpu: HTTP {code}, {body[:300]!r}")
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    query = sum(c for ln, c in zip(lines, counts)
                if "greptimedb_tpu_torch/query/" in ln)
    check(query > 0, "the burst caught no frame of the port's query path")
    log(f"  GET /debug/prof/cpu?seconds={BURST_S} beside {len(runs)} Q1 "
        f"runs: {wall * 1e3:.1f} ms, {len(lines)} stacks, {sum(counts)} "
        f"samples, {query} in greptimedb_tpu_torch/query/")
    return wall


def phase_observe(torch, sql, queries):
    """Phase 13 on phase 6's frontend and `cpu`: tracing and profiling
    over warm Q6 and Q1 (13a), the self-monitor, TQL over its metrics and
    SQL over its spans (13b), a coprocessor over HTTP and as a SQL UDF
    (13c), a CPU burst during Q1 (13d). Returns its launches, K1's inputs
    and the walls."""
    from greptimedb_tpu_torch.common import profiler, trace_store
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.servers.http import HttpServer
    log("== phase 13: the trace store, the profiler, the self-monitor and "
        "scripts over phase 6's frontend")
    t_phase = time.perf_counter()
    fe = sql.fe
    # the goldens' and the restart's frontends installed theirs last: the
    # phase observes phase 6's frontend (one frontend a process, as served)
    trace_store.install(fe.trace_sink)
    profiler.install(fe.profiler)
    floor = tpu_exec.TPU_DISPATCH_MIN_ROWS
    saved = (trace_store.sample_ratio(), profiler.enabled(), profiler.hz())
    grid = win.counts_leq_grid
    k1_calls = []

    def recorded(*args):
        k1_calls.append(args)
        return grid(*args)

    def pin():
        # the static floor, which each device query would otherwise raise
        sql.do(f"SET tpu_dispatch_min_rows = {floor}")

    win.counts_leq_grid = recorded
    sql.timer.fenced = False
    K.segment_moments.launches = pw.counts_leq_grid.launches = 0
    walls = {}
    srv = None
    steps = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps[name] = time.perf_counter() - t0
        log(f"  ({name}: {steps[name]:.1f}s)")
        return out

    try:
        log("-- 13a: traced and profiled warm queries")
        walls["queries"] = step("13a", lambda: observe_queries(
            sql, queries, pin))
        log("-- 13b: the self-monitor")
        walls["ticks"], k1_inputs = step("13b", lambda: observe_monitor(
            sql, queries, pin, k1_calls))
        srv = HttpServer(fe, addr="127.0.0.1:0")
        srv.start()
        client = HttpClient(srv.port)
        log(f"-- 13c: scripts over HttpServer(fe) on port {srv.port}")
        walls["scripts"] = step("13c", lambda: observe_scripts(
            sql, client, queries, pin))
        log("-- 13d: a CPU burst during Q1")
        walls["burst"] = step("13d", lambda: observe_burst(
            sql, client, queries, pin))
    finally:
        if srv is not None:
            srv.shutdown()
        win.counts_leq_grid = grid
        sql.timer.fenced = True
        trace_store.configure(sample_ratio=saved[0])
        profiler.configure(enabled=saved[1], hz=saved[2])
        tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = \
            floor, None
    moments, k1 = K.segment_moments.launches, pw.counts_leq_grid.launches
    check(moments > 0 and k1 > 0, f"phase 13 launched segment_moments "
          f"{moments} and K1 {k1} times")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 13: segment_moments {moments} launches, K1 {k1}; "
        f"{walls['phase']:.1f}s")
    return types.SimpleNamespace(moments=moments, k1=k1, walls=walls,
                                 k1_inputs=k1_inputs)


# ---------------------------------------------------------------------------
# phase 14: the standalone process over S3
# ---------------------------------------------------------------------------

#: TSBS cpu-only, 4000 hosts x 3 h at 10 s: 4.32 M rows (phase 6's 12 h
#: cut to 3 h for the script's time limit; schema, hosts, interval kept)
S3_HOURS = 3
S3_BUCKET = "greptimedb"
S3_ROOT = "data"
#: large enough to hold the region's SSTs (printed after the flush)
S3_CACHE_BYTES = 4 << 30
S3_WARM_RUNS = 3
#: the per-series TQL of 14d: one host's usage_user over the 3 h
S3_TQL = 'rate(cpu{hostname="host_7", __field__="usage_user"}[5m])'
S3_SERVERS = ("http", "mysql", "postgres", "grpc")
CHILD_TIMEOUT_S = 180


def serve_mock_s3(root):
    """A mock S3 endpoint, run in a child process so that its GIL stays
    out of the frontend's scans: a ThreadingHTTPServer on loopback over
    the directory `root` (a bucket a directory, an object a file) with
    the REST semantics of the reference tests' mock (PUT, GET, HEAD,
    DELETE, ListObjectsV2 paged by 1000 keys) and request counters at
    GET /__stats. Prints its port, then serves until terminated."""
    import http.server
    import shutil
    import threading
    import urllib.parse
    stats = {"PUT": 0, "put_bytes": 0, "GET": 0, "get_bytes": 0,
             "HEAD": 0, "DELETE": 0, "LIST": 0}
    lock = threading.Lock()

    def count(kind, nbytes=0, key=None):
        with lock:
            stats[kind] += 1
            if key:
                stats[key] += nbytes

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _path(self):
            key = urllib.parse.unquote(self.path.split("?")[0].lstrip("/"))
            return os.path.join(root, *key.split("/"))

        def _reply(self, status, body=b""):
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_PUT(self):
            path = self._path()
            left = int(self.headers.get("Content-Length", 0))
            count("PUT", left, "put_bytes")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{threading.get_ident()}.part"
            with open(tmp, "wb") as f:
                while left:
                    chunk = self.rfile.read(min(left, 1 << 22))
                    if not chunk:
                        break
                    f.write(chunk)
                    left -= len(chunk)
            os.replace(tmp, path)
            self._reply(200)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/__stats":
                with lock:
                    self._reply(200, json.dumps(stats).encode())
                return
            query = urllib.parse.parse_qs(parsed.query)
            if "list-type" in query:
                count("LIST")
                base = os.path.join(root, parsed.path.strip("/"))
                prefix = query.get("prefix", [""])[0]
                after = query.get("continuation-token", [""])[0]
                keys = []
                for d, _, files in os.walk(base):
                    for f in files:
                        k = os.path.relpath(os.path.join(d, f), base)
                        k = k.replace(os.sep, "/")
                        if not f.endswith(".part") and \
                                k.startswith(prefix) and k > after:
                            keys.append(k)
                keys.sort()
                page, more = keys[:1000], len(keys) > 1000
                body = "<ListBucketResult>" + "".join(
                    f"<Contents><Key>{k}</Key></Contents>" for k in page) + \
                    f"<IsTruncated>{str(more).lower()}</IsTruncated>"
                if more:
                    body += (f"<NextContinuationToken>{page[-1]}"
                             "</NextContinuationToken>")
                self._reply(200, (body + "</ListBucketResult>").encode())
                return
            path = self._path()
            if not os.path.isfile(path):
                self._reply(404)
                return
            size = os.path.getsize(path)
            count("GET", size, "get_bytes")
            self.send_response(200)
            self.send_header("Content-Length", str(size))
            self.end_headers()
            with open(path, "rb") as f:
                shutil.copyfileobj(f, self.wfile, 1 << 22)

        def do_HEAD(self):
            count("HEAD")
            self.send_response(200 if os.path.isfile(self._path()) else 404)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_DELETE(self):
            count("DELETE")
            try:
                os.unlink(self._path())
            except FileNotFoundError:
                pass
            self._reply(204)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    print(srv.server_address[1], flush=True)
    srv.serve_forever()


class MockS3:
    """serve_mock_s3 in a child process (a fresh interpreter: no CUDA
    state is inherited), over a directory of the phase's temporary
    home."""

    def __init__(self, root):
        self.root = root
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; from chip_smoke import "
             "serve_mock_s3; serve_mock_s3(sys.argv[1])", root], cwd=HERE,
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        check(line.strip().isdigit(), f"the mock S3 process sent no port "
              f"(exit {self.proc.poll()})")
        self.port = int(line)
        self.endpoint = f"http://127.0.0.1:{self.port}"

    def stats(self):
        import urllib.request
        with urllib.request.urlopen(f"{self.endpoint}/__stats",
                                    timeout=30) as r:
            return json.loads(r.read())

    def bucket(self):
        """(objects, bytes, SST files, SST bytes) in the bucket now."""
        n = nbytes = ssts = sst_bytes = 0
        for d, _, files in os.walk(os.path.join(self.root, S3_BUCKET)):
            for f in files:
                size = os.path.getsize(os.path.join(d, f))
                n, nbytes = n + 1, nbytes + size
                if f.endswith(".parquet"):
                    ssts, sst_bytes = ssts + 1, sst_bytes + size
        return n, nbytes, ssts, sst_bytes

    def close(self):
        self.proc.terminate()
        self.proc.wait(30)
        self.proc.stdout.close()


def free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def s3_toml(path, data_home, endpoint, cache, ports):
    """A TOML in the reference's layout (cmd/main.py's [storage], [http],
    [mysql], [postgres], [grpc] and [logging] tables)."""
    addrs = "".join(f'\n[{name}]\naddr = "127.0.0.1:{port}"\n'
                    for name, port in zip(S3_SERVERS, ports))
    with open(path, "w") as f:
        f.write(f'''[storage]
type = "S3"
data_home = "{data_home}"
bucket = "{S3_BUCKET}"
root = "{S3_ROOT}"
endpoint = "{endpoint}"
access_key_id = "chip-smoke"
secret_access_key = "chip-smoke-secret"
cache_path = "{cache}"
cache_capacity = {S3_CACHE_BYTES}
{addrs}
[logging]
level = "info"
''')
    return path


def cache_counters():
    from greptimedb_tpu_torch.common import telemetry
    out = {}
    for name in ("read_cache_hit", "read_cache_miss", "read_cache_corrupt"):
        c = telemetry._counters.get(telemetry._sanitize(name))
        out[name] = 0 if c is None else int(c._value.get())
    return out


class S3Process:
    """What `greptime standalone start -c <toml>` builds, in this
    process: cmd.main.load_options → build_servers, every server started;
    a Flight `Database` on its gRPC port; the cache layer's reads that
    went on to S3 recorded."""

    def __init__(self, toml, label, s3):
        from greptimedb_tpu_torch.client.flight import Database
        from greptimedb_tpu_torch.cmd.main import build_servers, load_options
        from greptimedb_tpu_torch.storage.cache import LruCacheLayer
        self.label = label
        got0 = s3.stats()
        t0 = time.perf_counter()
        opts = load_options(argparse.Namespace(config_file=toml))
        check(opts.device == "cuda" and opts.storage["type"] == "S3",
              f"load_options: device {opts.device!r}, storage "
              f"{opts.storage}")
        opts.device = DEVICE          # "cpu" only in a CPU rehearsal
        self.fe, self.servers = build_servers(opts)
        for s in self.servers:
            s.start()
        self.open_s = time.perf_counter() - t0
        got = s3.stats()
        kinds = [type(s).__name__ for s in self.servers]
        check(kinds == ["HttpServer", "MysqlServer", "PostgresServer",
                        "GrpcServer"], f"build_servers built {kinds}")
        self.ports = dict(zip(S3_SERVERS, (s.port for s in self.servers)))
        self.layer = self.fe.datanode.store
        check(isinstance(self.layer, LruCacheLayer) and
              type(self.layer.inner).__name__ == "RetryingObjectStore" and
              type(self.layer.inner.inner).__name__ == "S3ObjectStore",
              f"the object store is {type(self.layer).__name__}")
        self.pulled = []
        read = self.layer.inner.read

        def pulled(key):
            self.pulled.append(key)
            return read(key)

        self.layer.inner.read = pulled
        self.db = Database(f"grpc://127.0.0.1:{self.ports['grpc']}")
        log(f"  {label}: load_options -> build_servers -> start in "
            f"{self.open_s:.2f}s (read from S3: {got['GET'] - got0['GET']}"
            f" objects, {(got['get_bytes'] - got0['get_bytes']) / 1e6:.2f} "
            f"MB, {got['LIST'] - got0['LIST']} listings); "
            f"{', '.join(kinds)} on ports {self.ports}; cache index "
            f"{len(self.layer._entries)} entries, "
            f"{self.layer._size / 1e6:.1f} MB")

    def pin(self):
        # over Flight, as a client would: SET reaches the process's
        # dispatch floor, which each device query raises again
        check(self.db.sql("SET tpu_dispatch_min_rows = 0") == 0,
              "SET over Flight")

    def region(self):
        (r,) = self.fe.catalog.table("greptime", "public",
                                     "cpu").regions.values()
        return r

    def close(self):
        self.db.close()
        for s in self.servers:
            s.shutdown()
        self.fe.shutdown()


def flight_frame(batches):
    import pandas as pd
    return pd.concat([pd.DataFrame(b.to_pydict()) for b in batches],
                     ignore_index=True)


def s3_open_queries(proc, queries, want, direct=False):
    """Q1, Q5 and Q6 through Database.sql, each cold (the scan cache
    cleared: the SSTs read through the disk cache) and warm (median of
    3), on the device path with one launch each. Returns {name: frame},
    the SST keys the first cold query pulled from S3 and its disk-cache
    hits, and the walls."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.query import tpu_exec
    frames, walls = {}, {}
    first = None
    for name, sql in queries.items():
        region = proc.region()
        tpu_exec.SCAN_CACHE.clear()
        proc.pin()
        pulled0, hits0 = len(proc.pulled), proc.layer.hits
        misses0, m0 = proc.layer.misses, K.segment_moments.launches
        region.last_scan_profile = None
        t0 = time.perf_counter()
        batches = proc.db.sql(sql)
        cold = time.perf_counter() - t0
        got = flight_frame(batches)
        launched = K.segment_moments.launches - m0
        p = region.last_scan_profile
        check(p is not None and p.path == "resident" and launched == 1,
              f"{proc.label} {name} cold: path "
              f"{p.path if p is not None else None}, {launched} launches")
        pulled = [k for k in proc.pulled[pulled0:]
                  if k.endswith((".parquet", ".idx"))]
        if first is None:
            first = (pulled, proc.layer.hits - hits0,
                     proc.layer.misses - misses0)
        err = compare_sql(f"{proc.label} {name}", got, *want[name])
        warm = []
        for _ in range(S3_WARM_RUNS):
            proc.pin()
            t0 = time.perf_counter()
            batches = proc.db.sql(sql)
            warm.append(time.perf_counter() - t0)
            again = flight_frame(batches)
            check(again.equals(got), f"{proc.label} {name}: a warm answer "
                  f"differs from the cold one")
        walls[name] = {"cold": cold, "warm": statistics.median(warm)}
        line = (f"  {proc.label} {name}: {len(got)} rows, max |err|/bound "
                f"{err:.3g}; cold {cold * 1e3:.1f} ms ({len(pulled)} SST "
                f"objects pulled from S3, disk cache +"
                f"{proc.layer.hits - hits0} hits +"
                f"{proc.layer.misses - misses0} misses), warm over Flight "
                f"{walls[name]['warm'] * 1e3:.1f} ms")
        if direct:
            # the same statement through do_query in this process: the
            # Flight front door's own cost is the difference
            ds = []
            for _ in range(S3_WARM_RUNS):
                proc.pin()
                t0 = time.perf_counter()
                (out,) = proc.fe.do_query(sql)
                ds.append(time.perf_counter() - t0)
            direct_s = walls[name]["do_query"] = statistics.median(ds)
            check(flight_frame(out.batches).equals(got),
                  f"{name}: do_query differs from Flight")
            line += (f", do_query {direct_s * 1e3:.1f} ms (Flight adds "
                     f"{(walls[name]['warm'] - direct_s) * 1e3:.2f} ms)")
        log(line)
        frames[name] = got
    log(f"  {proc.label}: cache hits {proc.layer.hits}, misses "
        f"{proc.layer.misses}, {len(proc.layer._entries)} entries "
        f"{proc.layer._size / 1e6:.1f} MB; counters {cache_counters()}")
    return frames, first, walls


def s3_other_wires(proc, queries, frames):
    """Q5 and Q6 over /v1/sql and over MySQL on the same process: the
    rows Flight gave, as each server encodes them."""
    from greptimedb_tpu_torch.query.output import Output
    from greptimedb_tpu_torch.servers.http import output_to_json
    http = HttpClient(proc.ports["http"])
    my = WireMysql(proc.ports["mysql"])
    try:
        for name in ("Q5 per-host moments", "Q6 global aggregate"):
            sql = queries[name]
            proc.pin()
            batches = proc.db.sql(sql)
            check(flight_frame(batches).equals(frames[name]),
                  f"{name} over Flight differs from the open's answer")
            out = Output.record_batches(batches)
            proc.pin()
            doc, _, w_http = http.sql(sql)
            check(doc["output"][0] == as_json(output_to_json(out)),
                  f"{name} over /v1/sql differs from Flight's rows")
            my_cols, my_rows, _, _ = wire_expected(out)
            proc.pin()
            t0 = time.perf_counter()
            got = my.query(sql)
            w_my = time.perf_counter() - t0
            check(got == ("rows", my_cols, my_rows),
                  f"{name} over MySQL differs from Flight's rows: "
                  f"{str(got)[:300]}")
            log(f"  {name}: /v1/sql ({w_http * 1e3:.1f} ms) and MySQL "
                f"({w_my * 1e3:.1f} ms) give Flight's {len(my_rows)} rows")
    finally:
        my.close()


def compute_apps():
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr[-300:]}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def opens_card(pid):
    """The device files a process holds open (/proc/<pid>/fd)."""
    fd = f"/proc/{pid}/fd"
    held = set()
    for f in os.listdir(fd):
        try:
            target = os.readlink(os.path.join(fd, f))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            held.add(target)
    return held


def s3_child(home, toml, ports, count, q6, queries):
    """14e: `python3 -m greptimedb_tpu_torch.cmd.main standalone start -c
    <toml>` as a child process over the same bucket with a fresh cache;
    count(*) and Q6 through Database equal to 14c's; the card's compute
    apps list it; `cli attach` prints the count; SIGTERM ends it with 0
    within 10 s. Returns its walls."""
    import signal
    from greptimedb_tpu_torch.client.flight import Database
    apps0 = compute_apps()
    logf = open(os.path.join(home, "child.log"), "w")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main", "standalone",
         "start", "-c", toml], cwd=HERE, stdout=logf,
        stderr=subprocess.STDOUT)
    walls = {}
    db = None

    def tail():
        logf.flush()
        with open(os.path.join(home, "child.log")) as f:
            return f.read()[-3000:]

    try:
        addr = f"grpc://127.0.0.1:{ports['grpc']}"
        while True:
            check(child.poll() is None, f"standalone start exited "
                  f"{child.returncode}: {tail()}")
            check(time.perf_counter() - t0 < CHILD_TIMEOUT_S,
                  f"standalone start answered nothing in {CHILD_TIMEOUT_S}"
                  f" s: {tail()}")
            try:
                db = Database(addr)
                first = flight_frame(db.sql("SELECT 1"))
                break
            except Exception:  # noqa: BLE001 — not serving yet
                if db is not None:
                    db.close()
                    db = None
                time.sleep(0.2)
        walls["first_answer"] = time.perf_counter() - t0
        check(int(first.iloc[0, 0]) == 1, f"the child's SELECT 1: {first}")
        # the floor pinned as in 14c, so that count(*) and Q6 take the
        # device path (each device query raises it again)
        check(db.sql("SET tpu_dispatch_min_rows = 0") == 0, "SET")
        t1 = time.perf_counter()
        got = flight_frame(db.sql("SELECT count(*) FROM cpu"))
        walls["count"] = time.perf_counter() - t1
        check(int(got.iloc[0, 0]) == count, f"the child's count(*) "
              f"{got.iloc[0, 0]} != {count}")
        apps = compute_apps()
        held = opens_card(child.pid)
        listed = str(child.pid) in apps
        check((listed or len(apps) == len(apps0) + 1) and held,
              f"nvidia-smi lists {apps} (before the child: {apps0}); the "
              f"child holds {sorted(held)}")
        log(f"  the child (pid {child.pid}) answered SELECT 1 "
            f"{walls['first_answer']:.2f}s after its spawn, then count(*) "
            f"= {count} (cold, its SSTs pulled from S3 into its fresh "
            f"cache) in {walls['count']:.2f}s; nvidia-smi "
            f"compute apps {apps0} -> {apps} (" + (
                "its pid listed" if listed else
                "one more row; pids read in another namespace") +
            f"), the child holds {len(held)} /dev/nvidia* files")
        check(db.sql("SET tpu_dispatch_min_rows = 0") == 0, "SET")
        t1 = time.perf_counter()
        got6 = flight_frame(db.sql(queries["Q6 global aggregate"]))
        walls["q6"] = time.perf_counter() - t1
        check(got6.equals(q6), f"the child's Q6 {got6.to_dict()} differs "
              f"from 14c's {q6.to_dict()}")
        log(f"  the child's Q6 {walls['q6'] * 1e3:.1f} ms, equal to 14c's")
        t1 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main", "cli",
             "attach", "--grpc-addr", f"127.0.0.1:{ports['grpc']}"],
            cwd=HERE, input="SET tpu_dispatch_min_rows = 0;\n"
            "SELECT count(*) FROM cpu;\n\\q\n",
            capture_output=True, text=True, timeout=120)
        walls["cli"] = time.perf_counter() - t1
        check(cli.returncode == 0 and
              re.search(rf"\|\s*{count}\s*\|", cli.stdout) is not None,
              f"cli attach: exit {cli.returncode}: {cli.stdout[-500:]} "
              f"{cli.stderr[-500:]}")
        log(f"  cli attach printed count(*) = {count} "
            f"({walls['cli']:.2f}s)")
        db.close()
        db = None
        t1 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=10)
        walls["sigterm"] = time.perf_counter() - t1
        check(rc == 0, f"standalone start exited {rc} on SIGTERM: {tail()}")
        for _ in range(50):
            if len(compute_apps()) == len(apps0):
                break
            time.sleep(0.1)
        check(len(compute_apps()) == len(apps0), "the child's row is still "
              "among the card's compute apps")
        log(f"  SIGTERM: the child exited 0 in {walls['sigterm']:.2f}s")
    finally:
        if db is not None:
            db.close()
        if child.poll() is None:
            child.kill()
            child.wait(30)
        logf.close()
    return walls


def phase_s3(torch, seed):
    """Phase 14: the standalone process as users start it, over an S3
    data home (a mock S3 in a child process) with the LRU disk cache,
    through its Flight front door. Returns its launches, the kernels'
    inputs of its first launches and the walls."""
    import shutil
    import tempfile
    from greptimedb_tpu_torch.cmd.main import load_options
    from greptimedb_tpu_torch.datanode import (
        DatanodeInstance, DatanodeOptions)
    from greptimedb_tpu_torch.frontend import FrontendInstance
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.storage.object_store import build_object_store
    log("== phase 14: greptime standalone start over S3 with the disk "
        "cache, through the Flight front door")
    t_phase = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip_smoke_s3_")
    walls, steps = {}, {}
    s3 = proc = None
    grid, aggregate = win.counts_leq_grid, tpu_exec.sorted_grouped_aggregate
    k1_calls, moment_calls = [], []

    def k1_recorded(*args):
        k1_calls.append(args)
        return grid(*args)

    def kept(gids, mask, ts, values, col_masks=(), **kw):
        if not moment_calls:
            moment_calls.append((kw["ends"], mask, ts, list(values),
                                 list(col_masks), list(kw["ops"])))
        return aggregate(gids, mask, ts, values, col_masks, **kw)

    def step(name):
        steps[name] = time.perf_counter()
        log(f"-- 14{name}")

    def done(name):
        steps[name] = time.perf_counter() - steps[name]
        log(f"  (14{name}: {steps[name]:.1f}s)")

    win.counts_leq_grid = k1_recorded
    tpu_exec.sorted_grouped_aggregate = kept
    pw.counts_leq_grid.launches = K.segment_moments.launches = 0
    floor = tpu_exec.TPU_DISPATCH_MIN_ROWS
    try:
        step("a")
        t0 = time.perf_counter()
        ts, tags, fields = tsbs_cpu_table(seed, HOSTS, S3_HOURS)
        cols = sql_columns(ts, tags, fields)
        N = len(cols["ts"])
        log(f"  TSBS cpu-only: {HOSTS} hosts x {S3_HOURS} h at 10 s = {N} "
            f"rows, 10 tags, 10 fields, made in "
            f"{time.perf_counter() - t0:.1f}s")
        s3 = MockS3(os.path.join(home, "s3"))
        ports = free_ports(len(S3_SERVERS))
        data_home = os.path.join(home, "data_home")
        toml = s3_toml(os.path.join(home, "config.toml"), data_home,
                       s3.endpoint, os.path.join(home, "cache1"), ports)
        log(f"  mock S3 (pid {s3.proc.pid}) on {s3.endpoint}; {toml}: "
            f"[storage] type S3, bucket {S3_BUCKET}, root {S3_ROOT}, "
            f"cache_capacity {S3_CACHE_BYTES}; ports {ports}")
        proc = S3Process(toml, "open 1 (empty cache)", s3)
        done("a")

        step("b")
        t0 = time.perf_counter()
        check(proc.db.sql(sql_ddl("cpu", {f: "DOUBLE" for f in CPU_FIELDS}))
              == 0, "CREATE TABLE over Flight")
        put0 = s3.stats()
        t0 = time.perf_counter()
        n = proc.db.bulk_load("cpu", cols, tag_columns=TSBS_TAGS,
                              timestamp_column="ts")
        load = time.perf_counter() - t0
        check(n == N, f"bulk_load wrote {n} rows of {N}")
        t0 = time.perf_counter()
        check(proc.db.sql("ADMIN FLUSH TABLE cpu") == 0, "ADMIN FLUSH TABLE")
        proc.fe.datanode.storage.scheduler.wait_idle(timeout=600)
        flush = time.perf_counter() - t0
        put1 = s3.stats()
        objects, nbytes, ssts, sst_bytes = s3.bucket()
        puts = put1["PUT"] - put0["PUT"]
        put_bytes = put1["put_bytes"] - put0["put_bytes"]
        walls.update(load=load, flush=flush)
        prof = proc.region().last_ingest_profile
        log(f"  Database.bulk_load of {N} rows over Flight do_put "
            f"{load:.2f}s ({N / load / 1e6:.2f} Mrows/s); ADMIN FLUSH TABLE "
            f"{flush:.2f}s")
        log(f"  the region's bulk_ingest: {prof.describe()} (the rest of "
            f"the load: the client's arrow conversion, the do_put stream, "
            f"the server's arrow_to_ingest_columns)")
        log(f"  bucket: {objects} objects, {nbytes / 1e6:.1f} MB; {ssts} "
            f"SSTs {sst_bytes / 1e6:.1f} MB (the cache holds "
            f"{S3_CACHE_BYTES / 1e6:.0f} MB); {puts} PUTs of "
            f"{put_bytes / 1e6:.1f} MB in the load and flush, "
            f"{put_bytes / 1e6 / (load + flush):.1f} MB/s")
        check(ssts > 0 and sst_bytes < S3_CACHE_BYTES,
              f"{ssts} SSTs of {sst_bytes} bytes")
        done("b")

        step("c")
        queries = {k: v for k, v in sql_queries(
            np.random.default_rng(seed), HOSTS)[1].items()
            if k.split()[0] in DEVICE_QUERIES}
        ties = tie_hosts(proc.fe.catalog.table("greptime", "public", "cpu"))
        want = {q: sql_expected(q, ts, fields, ties, None)
                for q in queries}
        del cols
        opens, firsts = [], []
        for label, cache in (("open 1 (empty cache)", None),
                             ("open 2 (same cache)", "cache1"),
                             ("open 3 (fresh cache)", "cache3")):
            if cache is not None:
                proc.close()
                proc = None
                s3_toml(toml, data_home, s3.endpoint,
                        os.path.join(home, cache), ports)
                proc = S3Process(toml, label, s3)
            # opens 2 and 3 run the first query only (the script's time
            # limit): its cold run is the one whose SST reads the cache
            # serves or misses
            frames, first, w = s3_open_queries(
                proc, queries if cache is None else dict(
                    list(queries.items())[:1]), want, direct=cache is None)
            walls[label] = {"open": proc.open_s, **w}
            opens.append(frames)
            firsts.append(first)
            if cache is None:
                s3_other_wires(proc, queries, frames)
        for frames in opens[1:]:
            for q in frames:
                check(frames[q].equals(opens[0][q]),
                      f"{q}: the opens disagree")
        (p1, h1, m1), (p2, h2, m2), (p3, h3, m3) = firsts
        check(p1 and not p2 and sorted(p3) == sorted(p1) and m2 == 0 and
              h2 >= len(p1), f"the first cold query's SST reads: open 1 "
              f"pulled {len(p1)} from S3 ({m1} misses), open 2 {len(p2)} "
              f"({h2} hits, {m2} misses), open 3 {len(p3)} ({m3} misses)")
        log(f"  the three opens agree exactly; the first cold query's SST "
            f"reads: open 1 {m1} misses ({len(p1)} objects pulled), open 2 "
            f"{h2} hits and no miss, open 3 {m3} misses")
        done("c")

        step("d")
        s0 = TSBS_START_MS // 1000
        tql = (f"TQL EVAL ({s0}, {s0 + S3_HOURS * 3600}, '60s') "
               + S3_TQL)
        k0 = pw.counts_leq_grid.launches
        t0 = time.perf_counter()
        got = flight_frame(proc.db.sql(tql))
        walls["tql"] = time.perf_counter() - t0
        check(pw.counts_leq_grid.launches > k0 and len(got) > 0,
              f"the TQL launched K1 {pw.counts_leq_grid.launches - k0} "
              f"times, {len(got)} rows")
        proc.close()
        proc = None
        opts = load_options(argparse.Namespace(config_file=s3_toml(
            toml, data_home, s3.endpoint, os.path.join(home, "cache_cpu"),
            ports)))
        cpu_fe = FrontendInstance(DatanodeInstance(DatanodeOptions(
            data_home=data_home, device="cpu", flow_tick_interval_s=0,
            self_monitor_interval_s=0),
            store=build_object_store(opts.storage, data_home)))
        try:
            cpu_fe.start()
            t0 = time.perf_counter()
            (out,) = cpu_fe.do_query(tql)
            cpu_wall = time.perf_counter() - t0
        finally:
            cpu_fe.shutdown()
        plain = flight_frame(out.batches)
        check(list(got.columns) == list(plain.columns) and
              got.drop(columns="value").equals(plain.drop(columns="value")),
              f"the TQL: {got.head()} against the CPU's {plain.head()}")
        v, w = got["value"].to_numpy(float), plain["value"].to_numpy(float)
        check(np.isfinite(v).all() and np.allclose(v, w, rtol=1e-5, atol=0),
              f"the TQL's rates differ from the CPU's: {v[:5]} {w[:5]}")
        log(f"  {tql} over Flight: {len(got)} points, K1 "
            f"{pw.counts_leq_grid.launches - k0} launches, "
            f"{walls['tql'] * 1e3:.1f} ms; within rtol 1e-5 of the same TQL "
            f"on a device=\"cpu\" build over the bucket "
            f"({cpu_wall * 1e3:.1f} ms)")
        done("d")

        step("e")
        s3_toml(toml, data_home, s3.endpoint, os.path.join(home, "cache5"),
                ports)
        walls["child"] = s3_child(
            home, toml, dict(zip(S3_SERVERS, ports)), N,
            opens[0]["Q6 global aggregate"], queries)
        done("e")
    finally:
        win.counts_leq_grid = grid
        tpu_exec.sorted_grouped_aggregate = aggregate
        tpu_exec.TPU_DISPATCH_MIN_ROWS, tpu_exec._observed_min_dt[0] = \
            floor, None
        if proc is not None:
            proc.close()
        if s3 is not None:
            s3.close()
        shutil.rmtree(home, ignore_errors=True)
    moments, k1 = K.segment_moments.launches, pw.counts_leq_grid.launches
    check(moments > 0 and k1 > 0, f"phase 14 launched segment_moments "
          f"{moments} and K1 {k1} times")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 14: segment_moments {moments} launches, K1 {k1}; "
        + ", ".join(f"14{k} {v:.1f}s" for k, v in steps.items()) +
        f"; {walls['phase']:.1f}s")
    return types.SimpleNamespace(moments=moments, k1=k1, walls=walls,
                                 k1_inputs=k1_calls[-1],
                                 moment_inputs=moment_calls[0])


# ---------------------------------------------------------------------------
# phase 15: the datanode as a cluster member
# ---------------------------------------------------------------------------

CLUSTER_HOURS = 3                   # phase 14's span: 4.32 M rows
CLUSTER_NODES = (1, 2)
CLUSTER_REGIONS = 4
CLUSTER_QUERIES = ("Q1 double-groupby-all", "Q5 per-host moments",
                   "Q6 global aggregate")
CLUSTER_TABLE = ("greptime", "public", "cpu")


def cluster_partition(hosts):
    """cpu_p's PARTITION BY RANGE COLUMNS (hostname) clause over `hosts`
    hosts: CLUSTER_REGIONS regions of equal host counts."""
    names = sorted(f"host_{h}" for h in range(hosts))
    bounds = [f"'{names[k * hosts // CLUSTER_REGIONS]}'"
              for k in range(1, CLUSTER_REGIONS)] + ["MAXVALUE"]
    return " PARTITION BY RANGE COLUMNS (hostname) (" + ", ".join(
        f"PARTITION r{i} VALUES LESS THAN ({b})"
        for i, b in enumerate(bounds)) + ")"


def table_plan(table, sql):
    """(plan, analysis, query) of one aggregate on `table` (a datanode's
    table, or a frontend's view of one that holds no region), as the
    frontend's planner makes them before it ships the plan."""
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.query.planner import (
        analyze, convert_time_literals)
    from greptimedb_tpu_torch.sql import parse_sql
    q = parse_sql(sql)
    q.where = convert_time_literals(q.where, table.schema)
    a = analyze(q)
    plan = tpu_exec.plan_for(table, a, q)
    check(plan is not None, f"no device plan for {sql}")
    return plan, a, q


def cluster_plan(dn, sql):
    return table_plan(dn.catalog.table(*CLUSTER_TABLE), sql)


def fold_frames(engine, table, sql, frames):
    """The frontend's fold of the nodes' moment frames: _finalize, then
    the projection and ORDER BY of the statement."""
    import pandas as pd
    from greptimedb_tpu_torch.query import tpu_exec
    plan, a, q = table_plan(table, sql)
    merged = tpu_exec._finalize(pd.concat(frames, ignore_index=True), plan)
    return sql_frame(engine._finish_aggregate_frame(merged, a, q, table))


def cluster_fold(dn, sql, frames):
    return fold_frames(dn.query_engine, dn.catalog.table(*CLUSTER_TABLE),
                       sql, frames)


def scatter(fns):
    """Run one call per node at once, as a frontend scatters; returns
    their results in order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(fns)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in fns]]


def phase_cluster(torch, seed):
    """Phase 15: two datanodes (node ids 1 and 2) on one data home, each
    behind a FlightDatanodeServer, placed by the in-process meta service
    and reporting to it by heartbeat; TSBS cpu-only at 4000 hosts x 3 h
    range-partitioned into four regions, two on each node, loaded region
    by region over Flight do_put; Q1, Q5 and Q6 as region moments over
    Flight (segment_moments launched on the servers' threads) and through
    LocalDatanodeClient; the stale route, the heartbeat views, a mailed
    flush and node 2's restart. Returns its launches, the first region
    Q1 launch's inputs and the walls."""
    import shutil
    import tempfile
    import threading
    from greptimedb_tpu_torch.client import LocalDatanodeClient
    from greptimedb_tpu_torch.client.flight import FlightDatanodeClient
    from greptimedb_tpu_torch.common import exec_stats
    from greptimedb_tpu_torch.datanode import (
        DatanodeInstance, DatanodeOptions)
    from greptimedb_tpu_torch.errors import StaleRouteError
    from greptimedb_tpu_torch.frontend.statement import (
        build_schema_from_create)
    from greptimedb_tpu_torch.meta import MemKv, MetaClient, MetaSrv, Peer
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.partition.rule import rule_from_partitions
    from greptimedb_tpu_torch.query import tpu_exec
    from greptimedb_tpu_torch.servers.flight import FlightDatanodeServer
    from greptimedb_tpu_torch.sql import parse_sql
    from greptimedb_tpu_torch.table import CreateTableRequest
    log("== phase 15: two datanodes over Arrow Flight, placed by the "
        "in-process meta service, with heartbeats")
    t_phase = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    walls, steps = {}, {}
    aggregate = tpu_exec.sorted_grouped_aggregate
    moment_calls, threads = [], []
    dns, servers, clients = {}, {}, {}
    cat, sch, tname = CLUSTER_TABLE

    def kept(gids, mask, ts, values, col_masks=(), **kw):
        threads.append(threading.current_thread() is threading.main_thread())
        if not moment_calls:
            moment_calls.append((kw["ends"], mask, ts, list(values),
                                 list(col_masks), list(kw["ops"])))
        return aggregate(gids, mask, ts, values, col_masks, **kw)

    def step(name):
        steps[name] = time.perf_counter()
        log(f"-- 15{name}")

    def done(name):
        steps[name] = time.perf_counter() - steps[name]
        log(f"  (15{name}: {steps[name]:.1f}s)")

    def open_node(i):
        dn = DatanodeInstance(DatanodeOptions(
            data_home=home, node_id=i, device=DEVICE,
            register_numbers_table=False, flow_tick_interval_s=0,
            self_monitor_interval_s=0))
        dn.start()
        srv = FlightDatanodeServer(dn)
        srv.serve_in_background()
        client = FlightDatanodeClient(srv.address, i)
        check(client.ping() == i, f"node {i} answers ping")
        return dn, srv, client

    def close_node(i):
        servers.pop(i).shutdown()
        clients.pop(i).close()
        dns.pop(i).shutdown()

    def moments_over(how, sql, regions=None):
        """Each node's frames for `sql` (over Flight at once, or through
        LocalDatanodeClient in turn), the wall, the wire bytes and the
        longest server-side time (the datanode's ExecStats total, which
        rides the stream back)."""
        plan = cluster_plan(dns[1], sql)[0]

        def flight_call(i):
            with exec_stats.collect() as st:
                frames = clients[i].region_moments(
                    cat, sch, tname, plan, regions=regions)
            return (frames, st.stages["partial_wire"].detail["bytes"],
                    st.remote_total_ms)

        t0 = time.perf_counter()
        if how == "flight":
            got = scatter([lambda i=i: flight_call(i)
                           for i in CLUSTER_NODES])
        else:
            got = [(LocalDatanodeClient(dns[i]).region_moments(
                cat, sch, tname, plan, regions=regions), 0, 0.0)
                for i in CLUSTER_NODES]
        wall = time.perf_counter() - t0
        return ({i: g[0] for i, g in zip(CLUSTER_NODES, got)}, wall,
                sum(g[1] for g in got), max(g[2] for g in got))

    def same_frames(label, a, b):
        for i in CLUSTER_NODES:
            check(len(a[i]) == len(b[i]) and
                  all(x.equals(y) and list(x.dtypes) == list(y.dtypes)
                      for x, y in zip(a[i], b[i])),
                  f"{label}: node {i}'s frames differ")

    tpu_exec.sorted_grouped_aggregate = kept
    K.segment_moments.launches = 0
    try:
        step("a")
        t0 = time.perf_counter()
        ts, tags, fields = tsbs_cpu_table(seed, HOSTS, CLUSTER_HOURS)
        cols = sql_columns(ts, tags, fields)
        N = len(cols["ts"])
        log(f"  TSBS cpu-only: {HOSTS} hosts x {CLUSTER_HOURS} h at 10 s = "
            f"{N} rows, made in {time.perf_counter() - t0:.1f}s")
        srv = MetaSrv(MemKv())
        meta = MetaClient(srv)
        t0 = time.perf_counter()
        for i in CLUSTER_NODES:
            dns[i], servers[i], clients[i] = open_node(i)
            meta.register(Peer(i, servers[i].address))
            # the first beat registers the node; later beats are driven
            # below (a beat an hour keeps the task from racing them)
            dns[i].start_heartbeat(meta, interval_s=3600, stats_every=1)
        walls["open"] = time.perf_counter() - t0
        alive = [p.id for p in srv.alive_datanodes()]
        check(alive == list(CLUSTER_NODES), f"alive datanodes {alive}")
        stmt = parse_sql(sql_ddl(tname, {f: "DOUBLE" for f in CPU_FIELDS},
                                 cluster_partition(HOSTS)))
        schema, pk = build_schema_from_create(stmt)
        rule = rule_from_partitions(stmt.partitions)
        route = meta.create_route(".".join(CLUSTER_TABLE),
                                  rule.region_numbers())
        owner = {rr.region_number: rr.leader.id
                 for rr in route.region_routes}
        on = {i: route.regions_on(i) for i in CLUSTER_NODES}
        check(sorted(len(v) for v in on.values()) == [2, 2],
              f"load_based placement {on}")
        for i in CLUSTER_NODES:
            clients[i].ddl_create_table(CreateTableRequest(
                tname, schema, catalog_name=cat, schema_name=sch,
                primary_key_indices=pk, create_if_not_exists=True,
                partitions=stmt.partitions, table_id=route.table_id,
                assigned_region_numbers=on[i]))
            hosted = sorted(dns[i].catalog.table(*CLUSTER_TABLE).regions)
            check(hosted == on[i], f"node {i} hosts {hosted}, not {on[i]}")
        log(f"  meta placed table {route.table_id}'s regions {on} "
            f"(load_based); nodes opened and registered in "
            f"{walls['open']:.2f}s; RANGE COLUMNS (hostname) at cpu_p's "
            f"boundaries over {HOSTS} hosts")
        done("a")

        step("b")
        H = len(tags)
        host_region = np.array([rule.find_region((f"host_{h}",))
                                for h in range(H)])
        row_region = np.tile(host_region, N // H)
        parts = {}
        for rn in sorted(owner):
            idx = np.flatnonzero(row_region == rn)
            parts[rn] = {k: v[idx] for k, v in cols.items()}
        del cols, row_region
        t0 = time.perf_counter()
        wrote = scatter([lambda i=i: sum(
            clients[i].write_region(cat, sch, tname, rn, parts[rn],
                                    op="bulk") for rn in on[i])
            for i in CLUSTER_NODES])
        walls["load"] = time.perf_counter() - t0
        check(sum(wrote) == N, f"write_region wrote {wrote}, want {N}")
        del parts
        log(f"  write_region(op='bulk') of {N} rows over Flight do_put, "
            f"both nodes at once: {walls['load']:.2f}s "
            f"({N / walls['load'] / 1e6:.2f} Mrows/s)")
        for i in CLUSTER_NODES:
            for rn, r in sorted(dns[i].catalog.table(
                    *CLUSTER_TABLE).regions.items()):
                log(f"    node {i} region {rn}: {r.series_dict.num_series} "
                    f"hosts; bulk_ingest {r.last_ingest_profile.describe()}")
        done("b")

        step("c")
        queries = {k: v for k, v in sql_queries(
            np.random.default_rng(seed), HOSTS)[1].items()
            if k in CLUSTER_QUERIES}
        regions = {}
        for i in CLUSTER_NODES:
            regions.update(dns[i].catalog.table(*CLUSTER_TABLE).regions)
        ties = tie_hosts(types.SimpleNamespace(
            regions={rn: regions[rn] for rn in sorted(regions)}))
        cold_q1 = None
        for name, sql in queries.items():
            want = sql_expected(name, ts, fields, ties, None)
            runs = {}
            for how in ("flight", "local"):
                tpu_exec.SCAN_CACHE.clear()
                m0, t0 = K.segment_moments.launches, len(threads)
                cold = moments_over(how, sql)
                warm = moments_over(how, sql)
                on_main = threads[t0:]
                check(K.segment_moments.launches - m0 ==
                      2 * CLUSTER_REGIONS and
                      len(on_main) == 2 * CLUSTER_REGIONS and
                      (not any(on_main) if how == "flight"
                       else all(on_main)),
                      f"{name} {how}: {K.segment_moments.launches - m0} "
                      f"launches, on the main thread {on_main}")
                same_frames(f"{name} {how} cold / warm", cold[0], warm[0])
                runs[how] = (cold, warm)
            same_frames(f"{name} Flight / LocalDatanodeClient",
                        runs["flight"][0][0], runs["local"][0][0])
            frames = runs["flight"][0][0]
            if cold_q1 is None:
                cold_q1 = frames
            got = cluster_fold(dns[1], sql, [f for i in CLUSTER_NODES
                                             for f in frames[i]])
            err = compare_sql(f"phase 15 {name}", got, *want)
            (fc, fw), (lc, lw) = runs["flight"], runs["local"]
            walls[name] = {"flight_cold": fc[1], "flight_warm": fw[1],
                           "local_cold": lc[1], "local_warm": lw[1],
                           "partial_wire": fc[2],
                           "server_warm_ms": fw[3]}
            log(f"  {name}: {len(got)} rows folded from "
                f"{sum(len(f) for f in frames.values())} region frames "
                f"(max |err|/bound {err:.3g}); over Flight cold "
                f"{fc[1] * 1e3:.1f} ms (server-side {fc[3]:.1f} ms), warm "
                f"{fw[1] * 1e3:.1f} ms (server-side {fw[3]:.1f} ms; "
                f"partial_wire {fc[2]} bytes); LocalDatanodeClient cold "
                f"{lc[1] * 1e3:.1f} ms, warm {lw[1] * 1e3:.1f} ms; the "
                f"Flight frames bit-equal to the in-process ones")
        q1 = queries[CLUSTER_QUERIES[0]]
        plan = cluster_plan(dns[1], q1)[0]
        for i in CLUSTER_NODES:
            mine, theirs = on[i][0], on[3 - i][0]
            sub = clients[i].region_moments(cat, sch, tname, plan,
                                            regions=[mine])
            check(len(sub) == 1 and sub[0].equals(
                cold_q1[i][on[i].index(mine)]),
                f"node {i} regions=[{mine}]: {len(sub)} frames")
            try:
                clients[i].region_moments(cat, sch, tname, plan,
                                          regions=[theirs])
            except StaleRouteError as e:
                log(f"  node {i} regions=[{theirs}] (node {3 - i}'s): "
                    f"StaleRouteError through the Flight client: "
                    f"{str(e).splitlines()[0][:100]}")
            else:
                check(False, f"node {i} answered for region {theirs}")
        done("c")

        step("d")
        t0 = time.perf_counter()
        for i in CLUSTER_NODES:
            dns[i]._heartbeat_task.fn()
        walls["heartbeat"] = (time.perf_counter() - t0) / len(CLUSTER_NODES)
        info = {r["peer_id"]: r for r in srv.cluster_info()}
        peers = [r for r in info.values() if r["peer_type"] == "datanode"]
        check(sorted(r["peer_id"] for r in peers) == list(CLUSTER_NODES) and
              all(r["lease_state"] == "alive" for r in peers) and
              sum(r["approximate_rows"] for r in peers) == N and
              all(r["region_count"] == 2 for r in peers),
              f"cluster_info: {peers}")
        heat = srv.region_heat()
        names = {f"{route.table_id}_{rn:010d}" for rn in owner}
        check({h["region"] for h in heat} == names and
              sum(h["rows"] for h in heat) == N, f"region_heat: {heat}")
        table2 = dns[2].catalog.table(*CLUSTER_TABLE)
        flushed = []
        flush = table2.flush
        table2.flush = lambda: (flushed.append(1), flush())[1]
        srv.send_mailbox(2, {"type": "flush_table", "catalog": cat,
                             "schema": sch, "table": tname})
        dns[2]._heartbeat_task.fn()
        table2.flush = flush
        check(flushed == [1], "the mailed flush_table reached node 2")
        log(f"  a full beat from each node: {walls['heartbeat'] * 1e3:.1f} "
            f"ms each; cluster_info: 2 alive datanodes, "
            f"{[r['approximate_rows'] for r in peers]} rows; region_heat "
            f"names {sorted(names)}; a mailed flush_table ran on node 2's "
            f"next beat")
        done("d")

        step("e")
        close_node(2)
        t0 = time.perf_counter()
        dns[2], servers[2], clients[2] = open_node(2)
        walls["restart"] = time.perf_counter() - t0
        hosted = sorted(dns[2].catalog.table(*CLUSTER_TABLE).regions)
        check(hosted == on[2], f"node 2 reopened with {hosted}")
        tpu_exec.SCAN_CACHE.clear()
        again = clients[2].region_moments(cat, sch, tname, plan)
        check(len(again) == len(cold_q1[2]) and
              all(x.equals(y) for x, y in zip(again, cold_q1[2])),
              "node 2's cold Q1 after its restart differs")
        log(f"  node 2 shut down and reopened on the same data home behind "
            f"a new server in {walls['restart']:.2f}s: regions {hosted}, "
            f"cold Q1 frames bit-equal to those before")
        done("e")
    finally:
        tpu_exec.sorted_grouped_aggregate = aggregate
        for i in list(dns):
            close_node(i)
        shutil.rmtree(home, ignore_errors=True)
    moments = K.segment_moments.launches
    check(moments > 0, f"phase 15 launched segment_moments {moments} times")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 15: segment_moments {moments} launches ("
        f"{sum(1 for t in threads if not t)} on the Flight servers' "
        f"threads); " + ", ".join(f"15{k} {v:.1f}s" for k, v in
                                   steps.items()) +
        f"; {walls['phase']:.1f}s")
    return types.SimpleNamespace(moments=moments, walls=walls,
                                 moment_inputs=moment_calls[0])


# ---------------------------------------------------------------------------
# phase 16: the cluster's control plane as processes
# ---------------------------------------------------------------------------

#: how a child process runs the port's `greptime` CLI
CLI = [sys.executable, "-m", "greptimedb_tpu_torch.cmd.main"]
PROCS_METASRV = 3
#: the metasrv children's short timers: a datanode silent for the lease
#: is failed, and the failover runner looks every second
PROCS_LEASE_S = 3
PROCS_FAILOVER_S = 1
PROCS_HEARTBEAT_S = 0.5


class Child:
    """One `greptime` CLI child process with its log."""

    def __init__(self, label, args, home, env=None):
        self.label = label
        self.path = os.path.join(home, f"{label}.log")
        self.log = open(self.path, "w")
        # a child that outstays its SIGTERM gets SIGABRT (term), on which
        # faulthandler writes every thread's stack to its log
        self.proc = subprocess.Popen(
            CLI + args, cwd=HERE, stdout=self.log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONFAULTHANDLER": "1", **(env or {})})

    def text(self):
        """The whole log so far."""
        self.log.flush()
        with open(self.path) as f:
            return f.read()

    def tail(self):
        self.log.flush()
        with open(self.path) as f:
            return f.read()[-3000:]

    def running(self):
        return self.proc.poll() is None

    def kill(self):
        import signal
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(30)

    def term(self):
        """SIGTERM; (exit code, seconds to exit). A child still running
        after 10 s gets SIGABRT, so its log ends with its threads'
        stacks."""
        import signal
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(10)
        except subprocess.TimeoutExpired:
            rc = None
        secs = time.perf_counter() - t0
        if rc is None:
            self.proc.send_signal(signal.SIGABRT)
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                pass
        return rc, secs

    def close(self):
        if self.running():
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()


def wait_for(what, fn, children, timeout=CHILD_TIMEOUT_S):
    """Poll fn() until it returns a true value, every child still up;
    (that value, seconds waited)."""
    t0 = time.perf_counter()
    while True:
        for c in children:
            check(c.running(), f"{what}: {c.label} exited "
                  f"{c.proc.returncode}: {c.tail()}")
        try:
            v = fn()
        except Exception:  # noqa: BLE001 — not there yet
            v = None
        if v:
            return v, time.perf_counter() - t0
        check(time.perf_counter() - t0 < timeout,
              f"{what}: not within {timeout} s")
        time.sleep(0.02)


def region_frames(client, plan, regions):
    """The node's frames of `regions` over Flight, one region a call (so
    each frame is known by its region); (rn -> frame, the launches the
    node's ExecStats report). Each region must take the device-resident
    route."""
    from greptimedb_tpu_torch.common import exec_stats
    frames, launches, routes = {}, 0, set()
    for rn in regions:
        with exec_stats.collect() as st:
            (frames[rn],) = client.region_moments(
                *CLUSTER_TABLE, plan, regions=[rn])
        launches += st.launches.get("segment_moments", 0)
        routes.add(st.dispatch)
    check(routes == {"device-resident (scan cache)"},
          f"node {client.node_id}'s routes: {routes}")
    return frames, launches


# ---------------------------------------------------------------------------
# phase 17: the frontend process over phase 16's cluster
# ---------------------------------------------------------------------------

#: phase 17c's table: cpu_p's DDL and boundaries, loaded with the first
#: hour of phase 16's rows through the frontend
FE_TABLE = "cpu_f"
FE_LOAD_HOURS = 1


def fe_frame(doc):
    """A /v1/sql answer's rows as the frame sql_frame makes of an
    Output."""
    import pandas as pd
    return pd.DataFrame(records(doc["output"][0]))


def node_launches(rows):
    """segment_moments launches in the node blocks of an EXPLAIN ANALYZE
    answer (its `launches=` detail, which each datanode's ExecStats carry
    over Flight); (launches, {node label: launches})."""
    by_node = {}
    for stage, detail in zip(rows["stage"], rows["detail"]):
        if not stage.strip().startswith("dn"):
            continue
        m = re.search(r"launches=([^;]*)", detail or "")
        n = 0
        for part in (m.group(1).split(",") if m else ()):
            kernel, _, count = part.partition(":")
            if kernel.strip() == "segment_moments":
                n += int(count)
        by_node[stage.strip()] = n
    return sum(by_node.values()), by_node


def fe_analyze(http, sql):
    """EXPLAIN ANALYZE of `sql` through /v1/sql: (dispatch line, its rows
    as {column: values}, segment_moments launches of its node blocks,
    {node: launches}, wall s)."""
    doc, _, wall = http.sql("EXPLAIN ANALYZE " + sql)
    rows = records(doc["output"][0])
    dispatch = rows["detail"][rows["stage"].index("dispatch")]
    n, by_node = node_launches(rows)
    return dispatch, rows, n, by_node, wall


def fe_queries(http, db, queries, wants, answers, fields, host_rule):
    """17b: the frontend process's answers over phase 16's `cpu`, which it
    hydrates from meta's route on first use: DESCRIBE TABLE and SHOW
    TABLES; Q1, Q5 and Q6 over /v1/sql and over Flight, each equal to the
    other and held to 16c's bounds; EXPLAIN ANALYZE Q1 (every region,
    both nodes) and a one-host statement that prunes to one region (one
    node), whose node blocks count the datanodes' launches. Returns
    (launches, walls)."""
    walls, launches = {}, 0
    cat, sch, tname = CLUSTER_TABLE
    t0 = time.perf_counter()
    doc, _, _ = http.sql(f"DESCRIBE TABLE {tname}")
    walls["describe_first"] = time.perf_counter() - t0
    desc = records(doc["output"][0])
    check(desc["Column"] == list(TSBS_TAGS) + ["ts"] + list(CPU_FIELDS),
          f"DESCRIBE {tname} through the frontend: {desc['Column']}")
    doc, _, _ = http.sql("SHOW TABLES")
    shown = records(doc["output"][0])["Tables"]
    check(tname in shown, f"SHOW TABLES through the frontend: {shown}")
    log(f"  DESCRIBE TABLE {tname} ({walls['describe_first'] * 1e3:.1f} ms,"
        f" the table hydrated from meta's route) lists its {len(desc['Column'])}"
        f" columns; SHOW TABLES lists {shown}")
    for name, sql in queries.items():
        doc, _, w_http = http.sql(sql)
        got = fe_frame(doc)
        err = compare_sql(f"phase 17 {name} over /v1/sql", got, *wants[name])
        t0 = time.perf_counter()
        flight_got = flight_frame(db.sql(sql))
        w_flight = time.perf_counter() - t0
        check(flight_got.equals(got),
              f"{name}: Flight's rows differ from /v1/sql's")
        compare_sql(f"phase 17 {name} against 16c's fold", got,
                    answers[name], wants[name][1],
                    {c: np.asarray(b) * 2 for c, b in wants[name][2].items()})
        walls[name] = {"http": w_http, "flight": w_flight}
        log(f"  {name}: {len(got)} rows through the frontend process, "
            f"/v1/sql {w_http * 1e3:.1f} ms and Flight {w_flight * 1e3:.1f} "
            f"ms, equal to each other; max |err|/bound {err:.3g}, and "
            f"within twice the bounds of 16c's fold")
    q1 = queries["Q1 double-groupby-all"]
    dispatch, _, n, by_node, wall = fe_analyze(http, q1)
    check(dispatch.startswith("aggregate-pushdown (regions pruned 0/4, "
                              "fan-out=2"),
          f"EXPLAIN ANALYZE Q1's dispatch through the frontend: {dispatch}")
    check(sorted(by_node) == ["dn1", "dn2"],
          f"EXPLAIN ANALYZE Q1's node blocks: {by_node}")
    check(n > 0 or DEVICE != "cuda",
          f"EXPLAIN ANALYZE Q1: the node blocks report {by_node}")
    launches += n
    walls["analyze_q1"] = wall
    log(f"  EXPLAIN ANALYZE Q1 ({wall * 1e3:.1f} ms): {dispatch}; node "
        f"blocks' segment_moments launches {by_node}")
    host = "host_7"
    X = fields["usage_user"][7]
    sql = (f"SELECT hostname, count(*), avg(usage_user) FROM {tname} "
           f"WHERE hostname = '{host}' GROUP BY hostname")
    dispatch, _, n, by_node, wall = fe_analyze(http, sql)
    want_rn = host_rule.find_region((host,))
    check(dispatch.startswith("aggregate-pushdown (regions pruned 3/4, "
                              "fan-out=1"),
          f"the one-host statement's dispatch: {dispatch}")
    check(len(by_node) == 1 and (n > 0 or DEVICE != "cuda"),
          f"the one-host statement's node blocks: {by_node}")
    launches += n
    doc, _, _ = http.sql(sql)
    got = fe_frame(doc)
    S = X.sum()
    bound = sum_bound(S, S, X.size) / X.size + 4 * U64 * abs(S / X.size)
    check(got["hostname"].tolist() == [host] and
          got["count(*)"].tolist() == [X.size] and
          abs(got["avg(usage_user)"][0] - S / X.size) <= bound,
          f"the one-host statement's answer: {got.to_dict('list')}")
    log(f"  WHERE hostname = '{host}' (region {want_rn}): {dispatch}; node "
        f"blocks {by_node}; its count and avg against the brute force")
    return launches, walls


def fe_host_fold_q1(cols):
    """Q1 over `cols` (a table's rows) as a float64 host fold: the keys
    exact, each avg within the bound of a float32 run sum folded in
    float64 (sum_bound over its group)."""
    import pandas as pd
    df = pd.DataFrame({"hour": (cols["ts"] - TSBS_START_MS) // 3600_000 *
                       3600_000 + TSBS_START_MS,
                       "hostname": cols["hostname"],
                       **{f: cols[f] for f in CPU_FIELDS}})
    keys = ["hour", "hostname"]
    S = df.groupby(keys, sort=True).sum()
    A = df.assign(**{f: df[f].abs() for f in CPU_FIELDS}).groupby(
        keys, sort=True).sum()
    c = df.groupby(keys, sort=True).size()
    want = (S[list(CPU_FIELDS)].div(c, axis=0)).reset_index()
    want.columns = ["hour", "hostname"] + [f"avg({f})" for f in CPU_FIELDS]
    approx = {}
    for f in CPU_FIELDS:
        s, a = S[f].to_numpy(), A[f].to_numpy()
        n = c.to_numpy()
        approx[f"avg({f})"] = sum_bound(s, a, n) / n + \
            4 * U64 * np.abs(s / n)
    order = want.sort_values(["hour", "hostname"], kind="stable").index
    want = want.loc[order].reset_index(drop=True)
    approx = {k: v[order] for k, v in approx.items()}
    return want, {"hour": True, "hostname": True}, approx


def fe_table(http, db, my, registry, meta, ts, tags, fields, rule,
             queries):
    """17c: a second table through the frontend process. CREATE TABLE at
    cpu_p's boundaries over /v1/sql; the first hour of phase 16's rows by
    Database.bulk_load (Flight do_put to the frontend: handle_bulk_load ->
    _split_write -> write_region(op="bulk") on the owners); a four-row
    INSERT over MySQL with one row in each region; the rows on each
    node's regions against the rule; Q1 against a float64 host fold of
    the same rows; DROP TABLE. Returns walls."""
    walls = {}
    cat, sch, _ = CLUSTER_TABLE
    full = f"{cat}.{sch}.{FE_TABLE}"
    doc, _, walls["create"] = http.sql(sql_ddl(
        FE_TABLE, {f: "DOUBLE" for f in CPU_FIELDS},
        cluster_partition(HOSTS)))
    check(doc["output"][0] == {"affectedrows": 0},
          f"CREATE TABLE {FE_TABLE}: {doc}")
    per_h = 3600_000 // INTERVAL_MS * FE_LOAD_HOURS
    cols = sql_columns(ts[:per_h], tags,
                       {f: v[:, :per_h] for f, v in fields.items()})
    N = len(cols["ts"])
    t0 = time.perf_counter()
    wrote = db.bulk_load(FE_TABLE, cols, tag_columns=list(TSBS_TAGS),
                         timestamp_column="ts")
    walls["load"] = time.perf_counter() - t0
    check(wrote == N, f"Database.bulk_load wrote {wrote}, want {N}")
    log(f"  CREATE TABLE {FE_TABLE} over /v1/sql; Database.bulk_load of "
        f"{N} rows to the frontend process {walls['load']:.2f}s "
        f"({N / walls['load'] / 1e6:.2f} Mrows/s)")
    # one new row a region, an hour after the load, values exact in
    # float32
    by_region = {}
    for h in range(HOSTS):
        by_region.setdefault(rule.find_region((f"host_{h}",)), h)
    hosts = [by_region[rn] for rn in sorted(by_region)]
    t_new = TSBS_START_MS + FE_LOAD_HOURS * 3600_000
    new = {c: [] for c in cols}
    values = []
    for k, h in enumerate(hosts):
        row = [f"'{v}'" for v in tags[h]] + [str(t_new + k * INTERVAL_MS)]
        vals = [(k * 10 + j + 1) / 8.0 for j in range(len(CPU_FIELDS))]
        values.append("(" + ", ".join(row + [repr(v) for v in vals]) + ")")
        for t, v in zip(TSBS_TAGS, tags[h]):
            new[t].append(v)
        new["ts"].append(t_new + k * INTERVAL_MS)
        for f, v in zip(CPU_FIELDS, vals):
            new[f].append(v)
    t0 = time.perf_counter()
    got = my.query(f"INSERT INTO {FE_TABLE} ({', '.join(cols)}) VALUES "
                   + ", ".join(values))
    walls["insert"] = time.perf_counter() - t0
    check(got == ("ok", len(hosts)), f"INSERT over MySQL: {got}")
    route = meta.route(full)
    owner = {rr.region_number: rr.leader.id for rr in route.region_routes}
    check(sorted(set(owner.values())) == list(CLUSTER_NODES),
          f"meta placed {FE_TABLE}'s regions on {owner}")
    region_of = np.array([rule.find_region((f"host_{h}",))
                          for h in range(HOSTS)])
    for rn, node in sorted(owner.items()):
        want = per_h * int((region_of == rn).sum()) + \
            sum(1 for h in hosts if region_of[h] == rn)
        got = sum(b.num_rows for b in registry[node].scan_batches(
            cat, sch, FE_TABLE, projection=["ts"], regions=[rn]))
        check(got == want, f"{FE_TABLE} region {rn} on node {node}: {got} "
              f"rows, the rule puts {want} there")
    log(f"  INSERT of {len(hosts)} rows over MySQL ({walls['insert'] * 1e3:.1f}"
        f" ms), one in each region; every node's regions {owner} hold the "
        f"rows the rule puts there")
    q1 = queries["Q1 double-groupby-all"].replace(" FROM cpu ",
                                                  f" FROM {FE_TABLE} ")
    allc = {k: np.concatenate([np.asarray(cols[k]), np.asarray(
        new[k], dtype=np.asarray(cols[k]).dtype)]) for k in cols}
    want = fe_host_fold_q1(allc)
    doc, _, walls["q1"] = http.sql(q1)
    got = fe_frame(doc)
    err = compare_sql(f"phase 17 {FE_TABLE} Q1", got, *want)
    log(f"  Q1 on {FE_TABLE}: {len(got)} rows ({walls['q1'] * 1e3:.1f} ms), "
        f"max |err|/bound {err:.3g} against the float64 host fold")
    doc, _, walls["drop"] = http.sql(f"DROP TABLE {FE_TABLE}")
    check(meta.route(full) is None, f"DROP TABLE left the route of {full}")
    return walls


def phase_procs(torch, seed, frontend=True, elastic=False):
    """Phase 16: the cluster's control plane as processes. Three `metasrv
    start --peers` children (a raft-replicated KV over Flight) and two
    `datanode start` children on the card, on one data home; TSBS
    cpu-only at 4000 hosts x 3 h range-partitioned into four regions that
    meta places; Q1, Q5 and Q6 as region moments over Flight; datanode 2
    killed and its regions adopted by node 1; the raft leader killed and
    the routes read back from the new one; SIGTERM to the rest. With
    `frontend`, phase 17 rides this cluster: a `frontend start` child
    spawned with the datanodes (17a), its answers over phase 16's table
    (17b, between 16c and 16d), a second table through it (17c), its
    stale-route retry after 16d's kill (17d), its SIGTERM in 16f, then
    the distributed goldens in this process on the card. With `elastic`
    (which needs `frontend`), phase 18 runs between 16e and 16f. Returns
    the launches the datanodes' ExecStats report (phases 16, 17 and 18),
    phase 18's K1 launches and K1 row, and the walls."""
    import shutil
    import tempfile
    from greptimedb_tpu_torch.client.flight import Database
    from greptimedb_tpu_torch.frontend.statement import (
        build_schema_from_create)
    from greptimedb_tpu_torch.meta.flight import (
        FailoverFlightMetaClient, PeerClientRegistry)
    from greptimedb_tpu_torch.mito.engine import MitoTable, _serialize_rule
    from greptimedb_tpu_torch.partition.rule import rule_from_partitions
    from greptimedb_tpu_torch.query import QueryEngine
    from greptimedb_tpu_torch.sql import parse_sql
    from greptimedb_tpu_torch.storage.series import SeriesDict
    from greptimedb_tpu_torch.table import CreateTableRequest
    from greptimedb_tpu_torch.table.metadata import (
        TableIdent, TableInfo, TableMeta)
    log("== phase 16: three metasrv and two datanode processes (raft over "
        "Flight), a datanode's and the meta leader's failover")
    t_phase = time.perf_counter()
    home = tempfile.mkdtemp(prefix="chip_smoke_procs_")
    walls, steps = {}, {}
    cat, sch, tname = CLUSTER_TABLE
    full = ".".join(CLUSTER_TABLE)
    metas, dns = [], {}
    meta = registry = fe = db = my = standalone = None
    launches = fe_launches = 0
    p18 = None
    # one launch a region a call on the card; none on the CPU, where the
    # wrapper takes the plain version
    per_region = 1 if DEVICE == "cuda" else 0

    def step(name):
        steps[name] = time.perf_counter()
        log(f"-- {name}")

    def done(name):
        steps[name] = time.perf_counter() - steps[name]
        log(f"  ({name}: {steps[name]:.1f}s)")

    def children():
        return [c for c in metas + list(dns.values()) + [fe] if c is not None
                and c.running()]

    try:
        step("16a")
        ports = free_ports(PROCS_METASRV + len(CLUSTER_NODES) + 3)
        fe_ports = dict(zip(("http", "mysql", "grpc"),
                            ports[PROCS_METASRV + len(CLUSTER_NODES):]))
        addrs = [f"127.0.0.1:{p}" for p in ports[:PROCS_METASRV]]
        peers = ",".join(addrs)
        t0 = time.perf_counter()
        for i, addr in enumerate(addrs):
            metas.append(Child(f"metasrv{i}", [
                "metasrv", "start", "--bind-addr", addr, "--peers", peers,
                "--store", os.path.join(home, f"meta{i}"),
                "--failover-interval", str(PROCS_FAILOVER_S),
                "--datanode-lease-secs", str(PROCS_LEASE_S)], home))
        # the datanodes and the frontend start with the metasrv children:
        # `datanode start` and `frontend start` wait for a meta leader
        for i, port in zip(CLUSTER_NODES, ports[PROCS_METASRV:]):
            dns[i] = Child(f"datanode{i}", [
                "datanode", "start", "--node-id", str(i), "--rpc-addr",
                f"127.0.0.1:{port}", "--metasrv-addr", peers,
                "--data-home", os.path.join(home, "data"),
                "--heartbeat-interval", str(PROCS_HEARTBEAT_S)], home)
        if frontend:
            # 17a: the frontend process starts with the datanodes (it waits
            # for a meta leader: its flow recovery reads meta's KV at
            # construction); no self-monitor scrape writes tables of its
            # own into the cluster during the phase
            fe = Child("frontend", [
                "frontend", "start", "--metasrv-addr", peers,
                "--http-addr", f"127.0.0.1:{fe_ports['http']}",
                "--mysql-addr", f"127.0.0.1:{fe_ports['mysql']}",
                "--grpc-addr", f"127.0.0.1:{fe_ports['grpc']}"], home,
                env={"GREPTIME_SELF_MONITOR_INTERVAL_S": "0"})
        meta = FailoverFlightMetaClient([f"grpc://{a}" for a in addrs],
                                        retry_delay=0.1, max_rounds=300)
        quick = meta.advisory()
        info, _ = wait_for("a metasrv leader", quick.cluster_info,
                           children())
        walls["meta_leader"] = time.perf_counter() - t0
        check(info[0]["peer_type"] == "metasrv" and
              info[0]["lease_state"] == "leader",
              f"cluster_info's metasrv row {info[0]}")
        log(f"  metasrv children (pids {[c.proc.pid for c in metas]}) on "
            f"{addrs}: the leader {meta.address} answered cluster_info "
            f"{walls['meta_leader']:.2f}s after the spawn")
        wait_for("both datanodes registered",
                 lambda: [p.id for p in quick.list_datanodes()] ==
                 list(CLUSTER_NODES), children())
        walls["datanodes_registered"] = time.perf_counter() - t0
        registry = PeerClientRegistry(meta)
        check(len(registry) == 0, "PeerClientRegistry dialled early")
        pings = [registry[i].ping() for i in CLUSTER_NODES]
        check(pings == list(CLUSTER_NODES) and len(registry) == 2,
              f"pings {pings}")
        walls["datanodes_first_answer"] = time.perf_counter() - t0
        log(f"  datanode children (pids "
            f"{[c.proc.pid for c in dns.values()]}), spawned with the "
            f"metasrv children, registered with meta "
            f"{walls['datanodes_registered']:.2f}s after the spawn and "
            f"answered ping through PeerClientRegistry's lazily dialled "
            f"FlightDatanodeClients at {walls['datanodes_first_answer']:.2f}"
            f"s")
        if frontend:
            http = HttpClient(fe_ports["http"])
            wait_for("the frontend's first answer",
                     lambda: http.sql("SELECT 1")[0], children())
            walls["frontend_first_answer"] = time.perf_counter() - t0
            db = Database(f"grpc://127.0.0.1:{fe_ports['grpc']}")
            my = WireMysql(fe_ports["mysql"])
            log(f"  17a: the frontend child (pid {fe.proc.pid}), spawned "
                f"with the metasrv children, answered SELECT 1 over /v1/sql "
                f"{walls['frontend_first_answer']:.2f}s after its spawn")
        done("16a")

        step("16b")
        t0 = time.perf_counter()
        ts, tags, fields = tsbs_cpu_table(seed, HOSTS, CLUSTER_HOURS)
        cols = sql_columns(ts, tags, fields)
        N = len(cols["ts"])
        log(f"  TSBS cpu-only: {HOSTS} hosts x {CLUSTER_HOURS} h = {N} rows, "
            f"made in {time.perf_counter() - t0:.1f}s")
        stmt = parse_sql(sql_ddl(tname, {f: "DOUBLE" for f in CPU_FIELDS},
                                 cluster_partition(HOSTS)))
        schema, pk = build_schema_from_create(stmt)
        rule = rule_from_partitions(stmt.partitions)
        numbers = rule.region_numbers()
        route = meta.create_route(full, numbers)
        on = {i: route.regions_on(i) for i in CLUSTER_NODES}
        check(sorted(len(v) for v in on.values()) == [2, 2],
              f"meta placed {on}")
        info = TableInfo(
            ident=TableIdent(route.table_id), name=tname,
            meta=TableMeta(schema=schema, primary_key_indices=pk,
                           engine="mito", region_numbers=list(numbers),
                           next_column_id=len(schema), options={},
                           partition_rule=_serialize_rule(rule)),
            catalog_name=cat, schema_name=sch)
        # the schema rides with the route (the table's global value), so
        # a node that never saw the DDL can adopt its regions
        meta.put_table_info(full, info.to_dict())
        for i in CLUSTER_NODES:
            registry[i].ddl_create_table(CreateTableRequest(
                tname, schema, catalog_name=cat, schema_name=sch,
                primary_key_indices=pk, create_if_not_exists=True,
                partitions=stmt.partitions, table_id=route.table_id,
                assigned_region_numbers=on[i]))
        H = len(tags)
        host_region = np.array([rule.find_region((f"host_{h}",))
                                for h in range(H)])
        row_region = np.tile(host_region, N // H)
        parts = {rn: {k: v[np.flatnonzero(row_region == rn)]
                      for k, v in cols.items()} for rn in numbers}
        del cols, row_region
        # the ts ties of first / last_value follow each region's series
        # ids, which its bulk_ingest assigns from the rows in this order;
        # the first timestamp's rows hold every host of the region once,
        # in the order the whole region first shows them
        ties_of = {}
        for rn in (numbers[0], numbers[-1]):
            first = parts[rn]["ts"] == parts[rn]["ts"][0]
            sd = SeriesDict.for_schema(schema)
            sd.encode_rows([parts[rn][t][first] for t in schema.tag_names()])
            ties_of[rn] = types.SimpleNamespace(series_dict=sd)
        ties = tie_hosts(types.SimpleNamespace(regions=ties_of))
        t0 = time.perf_counter()
        wrote = scatter([lambda i=i: sum(
            registry[i].write_region(cat, sch, tname, rn, parts[rn],
                                     op="bulk") for rn in on[i])
            for i in CLUSTER_NODES])
        walls["load"] = time.perf_counter() - t0
        check(sum(wrote) == N, f"write_region wrote {wrote}, want {N}")
        del parts
        t0 = time.perf_counter()
        scatter([lambda i=i: registry[i].flush_table(cat, sch, tname)
                 for i in CLUSTER_NODES])
        walls["flush"] = time.perf_counter() - t0
        log(f"  meta placed table {route.table_id}'s regions {on}; "
            f"write_region(op='bulk') of {N} rows over Flight do_put to the "
            f"two datanode processes at once {walls['load']:.2f}s "
            f"({N / walls['load'] / 1e6:.2f} Mrows/s); flush_table "
            f"{walls['flush']:.2f}s")
        if elastic:
            standalone = Preloaded(ts, tags, fields)
        done("16b")

        step("16c")
        view = MitoTable(TableInfo.from_dict(meta.table_info(full)), {},
                         rule)
        engine = QueryEngine(None, device=DEVICE)
        queries = {k: v for k, v in sql_queries(
            np.random.default_rng(seed), HOSTS)[1].items()
            if k in CLUSTER_QUERIES}
        before, answers, wants = {}, {}, {}
        for name, sql in queries.items():
            plan = table_plan(view, sql)[0]
            runs = []
            for run in ("first", "again"):
                t0 = time.perf_counter()
                got = scatter([lambda i=i: region_frames(
                    registry[i], plan, on[i]) for i in CLUSTER_NODES])
                runs.append(time.perf_counter() - t0)
                frames = {rn: f for g in got for rn, f in g[0].items()}
                n = sum(g[1] for g in got)
                check(n == per_region * len(numbers),
                      f"{name} {run}: the datanodes report {n} launches")
                launches += n
                if run == "first":
                    before[name] = frames
                else:
                    check(all(frames[rn].equals(before[name][rn])
                              for rn in numbers),
                          f"{name}: the second run's frames differ")
            got = fold_frames(engine, view, sql,
                              [before[name][rn] for rn in numbers])
            wants[name] = sql_expected(name, ts, fields, ties, None)
            err = compare_sql(f"phase 16 {name}", got, *wants[name])
            answers[name] = got
            walls[name] = {"first": runs[0], "again": runs[1]}
            log(f"  {name}: {len(got)} rows folded from {len(numbers)} "
                f"region frames of two processes (max |err|/bound "
                f"{err:.3g}); over Flight first {runs[0] * 1e3:.1f} ms, "
                f"again {runs[1] * 1e3:.1f} ms")
        held = {c.label: sorted(opens_card(c.proc.pid))
                for c in metas + list(dns.values())}
        check(all(held[c.label] for c in dns.values()) and
              not any(held[c.label] for c in metas),
              f"/dev/nvidia* held: {held}")
        log(f"  each datanode process holds {len(held['datanode1'])} "
            f"/dev/nvidia* files; no metasrv process holds one")
        done("16c")

        if frontend:
            step("17b")
            n, walls["17b"] = fe_queries(http, db, queries, wants, answers,
                                         fields, rule)
            fe_launches += n
            done("17b")
            step("17c")
            walls["17c"] = fe_table(http, db, my, registry, meta, ts, tags,
                                    fields, rule, queries)
            done("17c")

        step("16d")
        t0 = time.perf_counter()
        dns[2].kill()
        _, walls["route_moved"] = wait_for(
            "meta moves node 2's regions",
            lambda: all(rr.leader.id == 1 for rr in
                        meta.route(full).region_routes), children())
        wait_for("node 1 adopts them",
                 lambda: sorted(registry[1].describe_table(
                     cat, sch, tname)[0].meta.region_numbers) == numbers,
                 children())
        walls["adopted"] = time.perf_counter() - t0
        for name, sql in queries.items():
            plan = table_plan(view, sql)[0]
            frames, n = region_frames(registry[1], plan, numbers)
            check(n == per_region * len(numbers),
                  f"{name} after the failover: {n} launches")
            launches += n
            check(all(frames[rn].equals(before[name][rn])
                      for rn in numbers),
                  f"{name}: node 1's frames differ from those before")
            got = fold_frames(engine, view, sql,
                              [frames[rn] for rn in numbers])
            check(got.equals(answers[name]),
                  f"{name}: the answer after the failover differs")
        walls["answers"] = time.perf_counter() - t0
        log(f"  SIGKILL of datanode 2: meta's route moved its regions "
            f"{on[2]} to node 1 after {walls['route_moved']:.2f}s, node 1 "
            f"had adopted them (the heartbeat mailbox's open_regions) at "
            f"{walls['adopted']:.2f}s, and Q1, Q5 and Q6 over all four "
            f"regions, all on node 1, equalled the answers before the kill "
            f"(each region's frame bit-equal) at {walls['answers']:.2f}s")
        if frontend:
            # 17d: the frontend still routes regions 1 and 3 to the dead
            # node: its next Q1 retries the refused RPC, refreshes the
            # route from meta and scatters again
            q1 = queries["Q1 double-groupby-all"]
            doc, _, w = http.sql(q1)
            walls["frontend_after_kill"] = time.perf_counter() - t0
            err = compare_sql("phase 17d Q1", fe_frame(doc),
                              *wants["Q1 double-groupby-all"])
            text = fe.text()
            check("hit a stale route" in text and "refreshed route of "
                  f"{full}" in text,
                  f"17d: the frontend's log shows no stale-route retry: "
                  f"{fe.tail()}")
            dispatch, _, n, by_node, _ = fe_analyze(http, q1)
            check(dispatch.startswith("aggregate-pushdown (regions pruned "
                                      "0/4, fan-out=1") and
                  list(by_node) == ["dn1"] and (n > 0 or DEVICE != "cuda"),
                  f"17d: EXPLAIN ANALYZE Q1 after the failover: {dispatch} "
                  f"{by_node}")
            fe_launches += n
            log(f"  17d: the frontend's Q1 after the kill ({w * 1e3:.1f} ms, "
                f"retried through a stale-route refresh: its log) answered "
                f"{walls['frontend_after_kill']:.2f}s after the SIGKILL, "
                f"max |err|/bound {err:.3g}; EXPLAIN ANALYZE Q1 then: "
                f"{dispatch}, node blocks {by_node}")
        done("16d")

        step("16e")
        meta.cluster_info()                  # pins the leader
        leader = meta.address
        li = [f"grpc://{a}" for a in addrs].index(leader)
        before_route = meta.route(full).to_dict()
        t0 = time.perf_counter()
        metas[li].kill()
        got, _ = wait_for("a new meta leader",
                          lambda: meta.route(full), children())
        walls["new_leader"] = time.perf_counter() - t0
        check(meta.address != leader, f"the killed {leader} answered")
        check(got.to_dict() == before_route,
              f"the route changed across the leader's kill: "
              f"{got.to_dict()} != {before_route}")

        def node1_alive():
            rows = {r["peer_id"]: r for r in meta.cluster_info()}
            ok = rows.get(1, {}).get("lease_state") == "alive"
            return rows if ok else None
        rows, _ = wait_for("node 1 alive on the new leader", node1_alive,
                           children())
        walls["cluster_info_alive"] = time.perf_counter() - t0
        check(rows[-1]["lease_state"] == "leader" and
              rows[-1]["peer_addr"] == meta.address,
              f"the metasrv row {rows[-1]}")
        log(f"  SIGKILL of the raft leader {leader}: "
            f"FailoverFlightMetaClient reached the new leader "
            f"{meta.address} with the route unchanged after "
            f"{walls['new_leader']:.2f}s; node 1's heartbeats showed it "
            f"alive there at {walls['cluster_info_alive']:.2f}s (node 2: "
            f"{rows.get(2, {}).get('lease_state')})")
        done("16e")

        if elastic:
            p18 = phase_elastic(torch, types.SimpleNamespace(
                home=home, peers=peers, meta=meta, registry=registry,
                dns=dns, http=http, children=children, ts=ts, tags=tags,
                fields=fields, queries=queries, wants=wants, rule=rule,
                numbers=numbers, standalone=standalone))

        step("16f")
        held = {c.label: sorted(opens_card(c.proc.pid))
                for c in metas if c.running()}
        check(not any(held.values()), f"a metasrv holds {held}")
        if frontend:
            my.close()
            db.close()
        ending = [dns[1]] + ([fe] if frontend else []) + \
            [m for m in metas if m.running()]
        exits = {c.label: c.term() for c in ending}
        check(all(rc == 0 and s < 10 for rc, s in exits.values()),
              f"SIGTERM: {exits}" + "".join(
                  f"\n{c.label}'s log:\n{c.tail()}" for c in ending
                  if exits[c.label][0] is None))
        walls["sigterm"] = max(s for _, s in exits.values())
        log("  SIGTERM: " + ", ".join(
            f"{k} exited {rc} in {s:.2f}s" for k, (rc, s) in exits.items()))
        done("16f")
    finally:
        if standalone is not None:
            standalone.close()
        if registry is not None:
            for client in registry.values():
                client.close()
        if meta is not None:
            meta.close()
        for c in metas + list(dns.values()) + ([fe] if fe else []):
            c.close()
        shutil.rmtree(home, ignore_errors=True)
    check(launches > 0 or DEVICE != "cuda",
          f"phase 16: the datanodes launched segment_moments {launches} "
          f"times")
    if frontend:
        step("17e")
        n = dist_goldens()
        fe_launches += n
        done("17e")
        check(fe_launches > 0 or DEVICE != "cuda",
              f"phase 17: segment_moments launched {fe_launches} times")
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 16: segment_moments {launches} launches in the datanode "
        f"processes (their ExecStats)" + (
            f"; phase 17: {fe_launches} (the frontend's EXPLAIN ANALYZE "
            f"node blocks and the distributed goldens)" if frontend else
            "") + "; " + ", ".join(
            f"{k} {v:.1f}s" for k, v in steps.items()) +
        f"; {walls['phase']:.1f}s")
    return types.SimpleNamespace(moments=launches, moments17=fe_launches,
                                 p18=p18, walls=walls)


# ---------------------------------------------------------------------------
# phase 18: the cluster's elastic and read paths
# ---------------------------------------------------------------------------

#: 18a's PromQL over the cluster's `cpu`, the field named by `__field__`
#: (GreptimeDB's Prometheus view of a multi-field table): the row path (a
#: regex matcher: the wire scan carries every row of the span and the
#: frontend filters), a lowered range query (range == step) and a lowered
#: instant aggregate
ELASTIC_ROW = "rate(cpu{__field__='usage_user', hostname=~'host_1.*'}[5m])"
ELASTIC_RANGE = "sum by (region) (rate(cpu{__field__='usage_user'}[5m]))"
ELASTIC_INSTANT = "avg(cpu{__field__='usage_user'})"
ELASTIC_STEP_S = 60
#: the distinct-count sketch's stated error past its exact set: four HLL
#: standard errors (1.04 / sqrt(2^14)) at the default precision
HLL_REL_BOUND = 4 * 1.04 / 2 ** 7
#: 18d: rows per acknowledged INSERT while the leader is killed, and the
#: acknowledged INSERTs before the kill
INGEST_ROWS = 20
INGEST_BEFORE_KILL = 5
#: 18d's bounded staleness for follower reads
REPLICA_LAG_MS = 10_000


def tql_series(frame):
    """{label tuple: (ts ms int64 [n], value float64 [n])} of a TQL EVAL
    answer; the label tuple is its non-empty label columns, sorted."""
    import pandas as pd
    labels = [c for c in frame.columns if c not in ("ts", "value")]
    ts = frame["ts"]
    ts = (ts.astype("int64") // 1_000_000) \
        if str(ts.dtype).startswith("datetime") else ts.astype("int64")
    frame = frame.assign(ts=ts.to_numpy())
    groups = frame.groupby(labels, sort=False, dropna=False) if labels \
        else [((), frame)]
    out = {}
    for k, g in groups:
        k = k if isinstance(k, tuple) else (k,)
        key = tuple(sorted((c, str(v)) for c, v in zip(labels, k)
                           if not pd.isna(v) and str(v) != ""))
        g = g.sort_values("ts", kind="stable")
        out[key] = (g["ts"].to_numpy(np.int64),
                    g["value"].to_numpy(dtype=float))
    return out


def same_series(name, got, want, rtol, atol=0.0, exact=False):
    """Two tql_series answers: the same series and timestamps, values
    bit-equal (`exact`) or within rtol / atol."""
    check(sorted(got) == sorted(want), f"{name}: {len(got)} series against "
          f"{len(want)}; e.g. {sorted(set(got) ^ set(want))[:2]}")
    worst = 0.0
    for k, (tw, vw) in want.items():
        tg, vg = got[k]
        check(np.array_equal(tg, tw), f"{name} {k}: timestamps differ")
        if exact:
            check(np.array_equal(vg, vw, equal_nan=True),
                  f"{name} {k}: values differ bitwise")
            continue
        b = rtol * np.abs(vw) + atol
        d = np.abs(vg - vw)
        check(bool(((d <= b) | (np.isnan(vg) & np.isnan(vw))).all()),
              f"{name} {k}: outside rtol {rtol} (max |err| "
              f"{np.nanmax(d):.3g})")
        worst = max(worst, float(np.nanmax(d / np.maximum(b, 1e-300))))
    return worst


def prom_json_series(result):
    """tql_series of a /api/v1/query_range matrix."""
    out = {}
    for r in result:
        k = tuple(sorted((a, b) for a, b in r["metric"].items()
                         if a != "__name__" and b != ""))
        ts = np.asarray([int(round(float(t) * 1000)) for t, _ in r["values"]],
                        dtype=np.int64)
        out[k] = (ts, np.asarray([float(v) for _, v in r["values"]]))
    return out


def analyze_launches(text):
    """segment_moments launches in the node blocks of a TQL ANALYZE (or
    EXPLAIN ANALYZE) text: {node label: launches}."""
    by_node = {}
    for line in text.splitlines():
        head = line.strip()
        if not re.match(r"dn\d+:", head):
            continue
        m = re.search(r"launches=([^;\s]*)", head)
        n = 0
        for part in (m.group(1).split(",") if m else ()):
            kernel, _, count = part.partition(":")
            if kernel.strip() == "segment_moments":
                n += int(count)
        by_node[head.split(":")[0]] = by_node.get(head.split(":")[0], 0) + n
    return by_node


def labelling_rowwise(batches, matchers, metric, tag_names, ts_name,
                      fields, multi_field, lo_ms, hi_ms):
    """The JAX package's row-path labelling of a wire scan
    (greptimedb_tpu/promql/lowering.py `_wire_scan_selection`, after its
    scan): a Python loop over every row and field. Kept here to time the
    port's run-wise `_label_wire_batches` against it on the card's
    batches; returns (labels, gids, ts, values) before the matrix."""
    from greptimedb_tpu_torch.promql.engine import (
        _is_sorted, _label_str, _matcher_keep, _matches_empty)
    tagset = set(tag_names)
    key_to_gid, glabels, gid_parts, ts_parts, val_parts = {}, [], [], [], []
    for rb in batches:
        if rb.num_rows == 0:
            continue
        data = rb.to_pydict()
        n = rb.num_rows
        tag_strs = [[_label_str(v) for v in data[t]] for t in tag_names]
        keep = np.ones(n, dtype=bool)
        for m in matchers:
            if m.name in ("__name__", "__field__"):
                continue
            if m.name not in tagset:
                if not _matches_empty(m):
                    keep[:] = False
                continue
            keep &= _matcher_keep(tag_strs[tag_names.index(m.name)], m)
        ts = np.asarray(data[ts_name], dtype=np.int64)
        keep &= (ts >= lo_ms) & (ts <= hi_ms)
        if not keep.any():
            continue
        rows = np.nonzero(keep)[0]
        for fname in fields:
            fcol = data[fname]
            for i in rows:
                fv = fcol[i]
                if fv is None:
                    continue
                lbl_key = tuple(col[i] for col in tag_strs)
                gkey = lbl_key + ((fname,) if multi_field else ())
                gid = key_to_gid.get(gkey)
                if gid is None:
                    gid = len(glabels)
                    key_to_gid[gkey] = gid
                    lbl = {"__name__": metric}
                    for tn, tv in zip(tag_names, lbl_key):
                        if tv != "":
                            lbl[tn] = tv
                    if multi_field:
                        lbl["__field__"] = fname
                    glabels.append(lbl)
                gid_parts.append(gid)
                ts_parts.append(ts[i])
                val_parts.append(float(fv))
    gids = np.asarray(gid_parts, dtype=np.int32)
    tsa = np.asarray(ts_parts, dtype=np.int64)
    vals = np.asarray(val_parts, dtype=np.float64)
    if not _is_sorted(gids, tsa):
        order = np.lexsort((tsa, gids))
        gids, tsa, vals = gids[order], tsa[order], vals[order]
    return glabels, gids, tsa, vals


class Preloaded:
    """18a's in-process standalone instance over phase 16's rows, built
    and bulk-loaded on a thread from the end of 16b, while 16c-16e wait
    on the children. `take()` hands the instance over (its load's
    seconds beside it); `close()` shuts down one never taken and removes
    the data home."""

    def __init__(self, ts, tags, fields):
        import tempfile
        from concurrent.futures import ThreadPoolExecutor
        self.home = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="preload")
        self._future = self._pool.submit(self._load, ts, tags, fields)
        self._taken = False

    def _load(self, ts, tags, fields):
        from greptimedb_tpu_torch.datanode import DatanodeOptions
        from greptimedb_tpu_torch.frontend import build_standalone
        t0 = time.perf_counter()
        sa = build_standalone(DatanodeOptions(
            data_home=self.home, device=DEVICE, flow_tick_interval_s=0,
            self_monitor_interval_s=0))
        try:
            sa.do_query(sql_ddl(CLUSTER_TABLE[2],
                                {f: "DOUBLE" for f in CPU_FIELDS}))
            sa.handle_bulk_load(CLUSTER_TABLE[2],
                                sql_columns(ts, tags, fields),
                                tag_columns=list(TSBS_TAGS),
                                timestamp_column="ts")
        except BaseException:
            sa.shutdown()
            raise
        return sa, time.perf_counter() - t0

    def take(self):
        self._taken = True
        return self._future.result()

    def close(self):
        import shutil
        if not self._taken:
            try:
                self._future.result()[0].shutdown()
            except Exception as e:  # noqa: BLE001 — never masks the phase's
                log(f"  18a's standalone preload failed: {e!r}")
        self._pool.shutdown()
        shutil.rmtree(self.home, ignore_errors=True)


def phase_elastic(torch, c):
    """Phase 18 over phase 16's processes (after 16e: datanode 2 dead, its
    regions adopted by node 1; two metasrv of three alive), driven through
    an in-process DistInstance(meta, PeerClientRegistry, device=DEVICE)
    so the script counts K1's launches on the frontend's device, with one
    request of each kind through the `frontend start` child. 18a PromQL
    over the cluster's 4.32 M rows (the row path by the wire scan into K1,
    held to K1's plain version on its inputs; the lowered range and
    instant shapes through the pushdown; TQL ANALYZE's node blocks), each
    answer held to the same TQL on an in-process standalone instance over
    the same rows; 18b count(DISTINCT) (exact under the sketch's set
    bound, within its stated error past it against SET exact_distinct =
    1); 18c a third datanode process, ADMIN MIGRATE REGION onto it and
    ADMIN SPLIT REGION, Q1 equal before and after each; 18e a scattered
    Q1's trace with spans from both datanode processes, and cluster_info
    from meta; 18d ADMIN ADD / REMOVE REPLICA, a follower read, and the
    SIGKILL of a region's leader under acknowledged ingest, its follower
    promoted with every acknowledged row read back exactly once. Returns
    K1's launches, K1's row at this phase's shape, the datanodes'
    segment_moments launches (from node blocks) and the walls."""
    import threading

    from greptimedb_tpu_torch.common import profiler, trace_store
    from greptimedb_tpu_torch.frontend import distributed as dist
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.promql import lowering
    from greptimedb_tpu_torch.promql.parser import parse_promql
    from greptimedb_tpu_torch.query import ir, sketches
    from greptimedb_tpu_torch.sql.ast import BinaryOp, Column, Literal
    log("== phase 18: the cluster's elastic and read paths (PromQL over "
        "DistTables, count(DISTINCT), migrate, split, read replicas)")
    t_phase = time.perf_counter()
    cat, sch, tname = CLUSTER_TABLE
    full = ".".join(CLUSTER_TABLE)
    walls, steps = {}, {}
    moments = 0
    dfe = sa = None
    grid = win.counts_leq_grid
    k1_calls = []
    saved = (trace_store.sample_ratio(), list(dist._READ_REPLICA),
             list(dist._REPLICA_MAX_LAG_MS), sketches.exact_distinct_forced())

    def recorded(*args):
        k1_calls.append(args)
        return grid(*args)

    def step(name):
        steps[name] = time.perf_counter()
        log(f"-- {name}")

    def done(name):
        steps[name] = time.perf_counter() - steps[name]
        log(f"  ({name}: {steps[name]:.1f}s)")

    def frame(stmt, fe=None):
        return sql_frame((fe or dfe).do_query(stmt)[-1])

    def peers(table=full, view=False):
        """The table's region_peers rows: meta's (what the view serves; the
        polls read them, so no statement of this frontend runs beside
        18e's trace), or through information_schema with `view`."""
        import pandas as pd
        rows = frame("SELECT table_name, region_number, peer_id, is_leader, "
                     "status, replicated_seq, lag_ms, operation FROM "
                     "information_schema.region_peers") if view else \
            pd.DataFrame(c.meta.region_peers())
        return rows[rows["table_name"] == table]

    def watch(cond):
        """Poll cond() on a thread from now on (statements run beside it);
        (the thread, {"s": seconds until cond() held})."""
        t0, out = time.perf_counter(), {}

        def run():
            while time.perf_counter() - t0 < CHILD_TIMEOUT_S:
                try:
                    if cond():
                        out["s"] = time.perf_counter() - t0
                        return
                except Exception:  # noqa: BLE001 — not there yet
                    pass
                time.sleep(0.05)
        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th, out

    def waited(what, watching):
        th, out = watching
        th.join(CHILD_TIMEOUT_S + 5)
        check("s" in out, f"{what}: not within {CHILD_TIMEOUT_S} s")
        return out["s"]

    def settled(region, node, leader=True, table=full, view=False):
        rows = peers(table, view)
        r = rows[(rows["region_number"] == region) &
                 (rows["peer_id"] == node) &
                 (rows["is_leader"] == ("Yes" if leader else "No"))]
        busy = rows["operation"].notna().any()
        return len(r) == 1 and not busy

    s0, s1 = int(c.ts[0]) // 1000, int(c.ts[-1]) // 1000

    def tql(q, a=s0, b=s1, st=f"{ELASTIC_STEP_S}s", verb="EVAL"):
        return f"TQL {verb} ({a}, {b}, '{st}') {q}"

    k1 = 0
    k1_row = None
    try:
        step("18a")
        # the third datanode boots while 18a and 18b run
        port3 = free_ports(1)[0]
        t_spawn3 = time.perf_counter()
        c.dns[3] = Child("datanode3", [
            "datanode", "start", "--node-id", "3", "--rpc-addr",
            f"127.0.0.1:{port3}", "--metasrv-addr", c.peers,
            "--data-home", os.path.join(c.home, "data"),
            "--heartbeat-interval", str(PROCS_HEARTBEAT_S)], c.home)
        t0 = time.perf_counter()
        dfe = dist.DistInstance(c.meta, c.registry, device=DEVICE)
        walls["frontend"] = time.perf_counter() - t0
        # placement below is the statements' alone: no auto split or
        # rebalance onto the empty node
        dfe.do_query("SET balancer_enabled = 0")
        # the row path's wire scan and labelling, timed where they run
        scan = {"rows": 0, "scan_s": 0.0, "label_s": 0.0}
        raw_scan, label = ir.execute_raw_scan, lowering._label_wire_batches

        def timed_scan(*args, **kw):
            t = time.perf_counter()
            out = raw_scan(*args, **kw)
            scan["scan_s"] += time.perf_counter() - t
            scan["rows"] += sum(b.num_rows for b in out)
            return out

        def timed_label(*args, **kw):
            t = time.perf_counter()
            out = label(*args, **kw)
            scan["label_s"] += time.perf_counter() - t
            return out

        win.counts_leq_grid = recorded
        ir.execute_raw_scan = timed_scan
        lowering._label_wire_batches = timed_label
        pw.counts_leq_grid.launches = 0
        try:
            t0 = time.perf_counter()
            row = tql_series(frame(tql(ELASTIC_ROW)))
            walls["row"] = time.perf_counter() - t0
            ir.execute_raw_scan = raw_scan
            lowering._label_wire_batches = label
            k1 = pw.counts_leq_grid.launches
            lowered, low_walls = {}, {}
            for q, a, st in ((ELASTIC_RANGE, s0, "5m"),
                             (ELASTIC_INSTANT, s1, f"{ELASTIC_STEP_S}s")):
                t0 = time.perf_counter()
                lowered[q] = tql_series(frame(tql(q, a, s1, st)))
                low_walls[q] = time.perf_counter() - t0
            text = "\n".join(frame(tql(ELASTIC_INSTANT, s1, s1, "60s",
                                       verb="ANALYZE"))["plan"])
            by_node = analyze_launches(text)
            k1 = pw.counts_leq_grid.launches
        finally:
            win.counts_leq_grid = grid
            ir.execute_raw_scan = raw_scan
            lowering._label_wire_batches = label
        n_an = sum(by_node.values())
        moments += n_an
        check(k1 > 0 or DEVICE != "cuda", f"18a: K1 launched {k1} times on "
              f"the frontend's device for the row path")
        check("aggregate-pushdown" in text and (n_an > 0 or DEVICE != "cuda")
              and len(by_node) >= 1, f"18a: TQL ANALYZE {by_node}: {text}")
        check(len(row) > 0 and scan.get("rows", 0) > 0,
              f"18a: the row path answered {len(row)} series from "
              f"{scan.get('rows')} scanned rows")
        # K1's launches on this path against the plain version
        for i, args in enumerate(k1_calls):
            ts2d, t_0, stp, T = args
            want = pw.counts_leq_plain(pw.step_buckets(ts2d, t_0, stp, T), T)
            same(torch, f"18a K1 launch {i} ({tuple(ts2d.shape)}, T={T})",
                 grid(ts2d, t_0, stp, T), want)
        pw.counts_leq_grid.launches = k1       # the checks are off the path
        if k1_calls:
            log("== K1 at phase 18's row-path shape")
            k1_row = k1_row_at(torch, k1_calls[-1], "phase 18's")
            pw.counts_leq_grid.launches = k1
        log(f"  {ELASTIC_ROW} over {s1 - s0} s at {ELASTIC_STEP_S} s: "
            f"{len(row)} series, {walls['row']:.2f}s; the wire scan "
            f"{scan['rows']} rows in {scan['scan_s']:.2f}s, the labelling "
            f"{scan['label_s']:.3f}s; K1 {k1} launches on the frontend's "
            f"device, each == plain")
        log(f"  lowered: {ELASTIC_RANGE} {low_walls[ELASTIC_RANGE]:.2f}s, "
            f"{ELASTIC_INSTANT} (instant) {low_walls[ELASTIC_INSTANT]:.2f}s; "
            f"TQL ANALYZE's node blocks: segment_moments {by_node}")
        # the reference's row-wise labelling against the port's run-wise
        # one on the same batches (one region's: the row loop takes
        # seconds a million rows)
        table = dfe.catalog.table(cat, sch, tname)
        tag_names = table.schema.tag_names()
        lo_ms, hi_ms = int(c.ts[0]) - 300_000, int(c.ts[-1])
        rscan = ir.RawScan(
            projection=list(tag_names) + ["ts", "usage_user"],
            time_range=(lo_ms, hi_ms + 1),
            filters=[BinaryOp("=", Column("region"), Literal(c.tags[0][1]))])
        batches = ir.execute_raw_scan(table, rscan)
        (sel,) = parse_promql(ELASTIC_ROW).args
        t0 = time.perf_counter()
        port = lowering._label_wire_batches(
            batches, sel, "cpu", tag_names, "ts", ["usage_user"], False,
            lo_ms, hi_ms)
        port_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = labelling_rowwise(batches, sel.matchers, "cpu", tag_names,
                                "ts", ["usage_user"], False, lo_ms, hi_ms)
        ref_s = time.perf_counter() - t0
        nrows = sum(b.num_rows for b in batches)
        check(port.labels == ref[0], "18a: the labels differ from the "
              "row-wise labelling's")
        from greptimedb_tpu_torch.ops.window import SeriesMatrix
        sm = SeriesMatrix.build(ref[1], ref[2], ref[3], len(ref[0]))
        check(all(np.array_equal(getattr(port.matrix, a), getattr(sm, a))
                  for a in ("ts", "values", "lengths")),
              "18a: the SeriesMatrix differs from the row-wise labelling's")
        log(f"  labelling of {nrows} scanned rows (region {c.tags[0][1]!r}, "
            f"{len(port.labels)} series): run-wise {port_s * 1e3:.1f} ms, "
            f"the reference's row-wise loop {ref_s * 1e3:.1f} ms; labels, "
            f"series ids and matrix equal")
        del batches
        # the same row query through the frontend child's Prometheus API,
        # in another process while this one loads the standalone below
        child_doc = []
        child_th = threading.Thread(target=lambda: child_doc.append(
            c.http.json("/api/v1/query_range", params={
                "query": ELASTIC_ROW, "start": s0, "end": s1,
                "step": ELASTIC_STEP_S})), daemon=True)
        child_th.start()
        # the same TQL on an in-process standalone instance over the same
        # rows, loaded on a thread since 16b
        t0 = time.perf_counter()
        sa, walls["standalone_load"] = c.standalone.take()
        walls["standalone_wait"] = time.perf_counter() - t0
        k_sa = pw.counts_leq_grid.launches
        sa_row = tql_series(frame(tql(ELASTIC_ROW), sa))
        same_series("18a row path against the standalone", row, sa_row,
                    0.0, exact=True)
        worst = 0.0
        for q, a, st in ((ELASTIC_RANGE, s0, "5m"),
                         (ELASTIC_INSTANT, s1, f"{ELASTIC_STEP_S}s")):
            want = tql_series(frame(tql(q, a, s1, st), sa))
            worst = max(worst, same_series(
                f"18a {q} against the standalone", lowered[q], want,
                LOWERED_RTOL, 1e-12))
        k_sa = pw.counts_leq_grid.launches - k_sa
        pw.counts_leq_grid.launches = k1
        child_th.join(HTTP_TIMEOUT_S)
        check(len(child_doc) == 1, "18a: the child's /api/v1/query_range "
              "did not answer")
        doc, _, w = child_doc[0]
        child = prom_json_series(doc["data"]["result"])
        err = same_series("18a the child's /api/v1/query_range", child, row,
                          QUANT, 1e-12)
        log(f"  the frontend child's /api/v1/query_range: {len(child)} "
            f"series in {w:.2f}s (beside the standalone's load), within "
            f"the printed 6 digits (max |err|/bound {err:.3g})")
        sa.shutdown()
        sa = None
        # the standalone installed its trace sink and profiler last: the
        # rest of the phase observes the distributed frontend's
        trace_store.install(dfe.trace_sink)
        profiler.install(dfe.profiler)
        log(f"  the standalone instance over the same {HOSTS} hosts x "
            f"{CLUSTER_HOURS} h (loaded in {walls['standalone_load']:.1f}s "
            f"on a thread since 16b; 18a waited "
            f"{walls['standalone_wait']:.2f}s for it): "
            f"the row path bit-equal, the lowered shapes within rtol "
            f"{LOWERED_RTOL} (max |err|/bound {worst:.3g}); its own K1 "
            f"launches ({k_sa}) are off the count")
        done("18a")

        # datanode 3 is up by now (spawned at 18a's start): its region's
        # migration runs while 18b's statements do
        step("18c migrate")
        _, _ = wait_for("datanode 3 registered", lambda: 3 in [
            p.id for p in c.meta.advisory().list_datanodes()], c.children())
        check(c.registry[3].ping() == 3, "datanode 3 does not answer")
        walls["node3"] = time.perf_counter() - t_spawn3
        q1 = c.queries["Q1 double-groupby-all"]
        before = frame(q1)
        compare_sql("phase 18 Q1", before, *c.wants["Q1 double-groupby-all"])
        log(f"  `datanode start --node-id 3` answered ping "
            f"{walls['node3']:.2f}s after its spawn; Q1 before: "
            f"{len(before)} rows within bounds")
        mig, spl = c.numbers[0], c.numbers[1]
        doc, _, _ = c.http.sql(f"ADMIN MIGRATE REGION {tname} {mig} TO 3")
        migrating = watch(lambda: settled(mig, 3))
        op = records(doc["output"][0])
        check(op["kind"] == ["migrate"], f"18c: ADMIN MIGRATE answered {op}")
        done("18c migrate")

        step("18b")
        q = f"SELECT count(DISTINCT hostname) AS c FROM {tname}"
        t0 = time.perf_counter()
        got = frame(q)["c"].tolist()
        walls["distinct_tag"] = time.perf_counter() - t0
        plan = frame("EXPLAIN " + q)["plan"][0]
        check(got == [HOSTS] and plan.startswith("TpuAggregateExec"),
              f"18b: {q} answered {got} with plan {plan[:200]!r}")
        doc, _, w_child = c.http.sql(q)
        check(records(doc["output"][0])["c"] == [HOSTS],
              f"18b: the frontend child answered {doc}")
        qf = f"SELECT count(DISTINCT usage_user) AS c FROM {tname}"
        t0 = time.perf_counter()
        est = int(frame(qf)["c"].iloc[0])
        walls["distinct_sketch"] = time.perf_counter() - t0
        check(frame("EXPLAIN " + qf)["plan"][0].startswith(
            "TpuAggregateExec"), "18b: the field's count(DISTINCT) did not "
            "lower to the sketch partial")
        dfe.do_query("SET exact_distinct = 1")
        t0 = time.perf_counter()
        exact = int(frame(qf)["c"].iloc[0])
        walls["distinct_exact"] = time.perf_counter() - t0
        plan_exact = frame("EXPLAIN " + qf)["plan"][0]
        dfe.do_query("SET exact_distinct = 0")
        truth = len(np.unique(c.fields["usage_user"]))
        check(plan_exact.startswith("CpuAggregateExec") and exact == truth
              and exact > sketches.EXACT_SET_LIMIT and
              abs(est - exact) <= HLL_REL_BOUND * exact,
              f"18b: count(DISTINCT usage_user) sketch {est}, exact {exact} "
              f"({plan_exact[:60]!r}), numpy {truth}")
        log(f"  count(DISTINCT hostname) = {HOSTS}, exact under the "
            f"{sketches.EXACT_SET_LIMIT}-value set (TpuAggregateExec; "
            f"{walls['distinct_tag'] * 1e3:.1f} ms; the child {w_child * 1e3:.1f}"
            f" ms); count(DISTINCT usage_user): the sketch {est} in "
            f"{walls['distinct_sketch']:.2f}s against SET exact_distinct = 1's "
            f"{exact} (numpy's) in {walls['distinct_exact']:.2f}s: "
            f"{abs(est - exact) / exact * 100:.3f} % off, the bound "
            f"{HLL_REL_BOUND * 100:.2f} %")
        done("18b")


        step("18c split")
        walls["migrate"] = waited(f"region {mig} on datanode 3", migrating)
        check(settled(mig, 3, view=True), "18c: information_schema."
              "region_peers does not show the migration")
        check(frame(q1).equals(before), "18c: Q1 after the migration differs")
        # split at the median host of the region's range (the probe's own
        # round trip is the goldens' and the tests')
        names = sorted(f"host_{h}" for h in range(HOSTS))
        at = names[HOSTS // CLUSTER_REGIONS + HOSTS // CLUSTER_REGIONS // 2]
        check(c.rule.find_region((at,)) == spl, f"18c: {at!r} is not in "
              f"region {spl}")
        out = frame(f"ADMIN SPLIT REGION {tname} {spl} AT '{at}'")
        splitting = watch(lambda: spl not in set(peers()["region_number"])
                          and settled(mig, 3))
        check(out["kind"].tolist() == ["split"], f"18c: ADMIN SPLIT {out}")
        log(f"  ADMIN MIGRATE REGION {tname} {mig} TO 3 (through the "
            f"frontend child, beside 18b) to region_peers showing it on "
            f"dn3: {walls['migrate']:.2f}s; Q1 bit-equal after it; ADMIN "
            f"SPLIT REGION {tname} {spl} AT {at!r} issued (18e runs beside "
            f"it)")
        done("18c split")

        step("18e")
        dfe.do_query("SET trace_sample_ratio = 1")
        frame(q1)
        trace = frame("ADMIN SHOW TRACE 'last'")
        dfe.do_query(f"SET trace_sample_ratio = {saved[0]}")
        nodes = sorted(set(trace["node"]))
        check({"dn1", "dn3"} <= set(nodes), f"18e: the trace's nodes {nodes}")
        ci = frame("SELECT peer_id, peer_type, lease_state FROM "
                   "information_schema.cluster_info ORDER BY peer_id")
        kinds = dict(zip(ci["peer_id"], zip(ci["peer_type"],
                                             ci["lease_state"])))
        check(kinds.get(-1, ("", ""))[0] == "metasrv" and
              kinds.get(1) == ("datanode", "alive") and
              kinds.get(3) == ("datanode", "alive"),
              f"18e: cluster_info {kinds}")
        doc, _, _ = c.http.sql("SELECT peer_id, peer_type FROM "
                               "information_schema.cluster_info ORDER BY "
                               "peer_id")
        check(records(doc["output"][0])["peer_id"] == list(ci["peer_id"]),
              f"18e: the child's cluster_info {doc}")
        log(f"  ADMIN SHOW TRACE 'last' of a scattered Q1: {len(trace)} "
            f"spans on {nodes}; cluster_info from meta: {kinds} (the "
            f"child's too); the ten distributed goldens run in 17e")
        done("18e")


        # beside the split (the balancer runs one operation a table): a
        # small table's region gets a replica, which is removed again
        step("18d replica add and remove")
        rr, rr_full = "cpu_rr", f"{cat}.{sch}.cpu_rr"
        dfe.do_query(sql_ddl(rr, {"usage_user": "DOUBLE"},
                             " PARTITION BY RANGE COLUMNS (hostname) ("
                             "PARTITION r0 VALUES LESS THAN ('host_5'), "
                             "PARTITION r1 VALUES LESS THAN (MAXVALUE))"))
        dfe.do_query(f"INSERT INTO {rr} ({', '.join(TSBS_TAGS)}, ts, "
                     f"usage_user) VALUES " + ", ".join(
                         "(" + ", ".join(f"'{v}'" for v in tg) +
                         f", {int(c.ts[0])}, 1.0)" for tg in c.tags[:8]))
        rr_lead = next(rt.leader.id for rt in c.meta.route(
            rr_full).region_routes if rt.region_number == 0)
        rr_to = 4 - rr_lead                  # the other of nodes 1 and 3
        t0 = time.perf_counter()
        frame(f"ADMIN ADD REPLICA {rr} 0 TO {rr_to}")
        wait_for(f"{rr} region 0's follower on dn{rr_to}",
                 lambda: settled(0, rr_to, leader=False, table=rr_full),
                 c.children())
        walls["rr_add_replica"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        frame(f"ADMIN REMOVE REPLICA {rr} 0 FROM {rr_to}")

        def removed():
            rows = peers(rr_full)
            return not ((rows["region_number"] == 0) &
                        (rows["peer_id"] == rr_to)).any() and settled(
                0, rr_lead, table=rr_full)
        wait_for(f"{rr} region 0's follower removed", removed, c.children())
        walls["remove_replica"] = time.perf_counter() - t0
        log(f"  ADMIN ADD REPLICA {rr} 0 TO {rr_to} to done "
            f"{walls['rr_add_replica']:.2f}s; ADMIN REMOVE REPLICA {rr} 0 "
            f"FROM {rr_to} to done {walls['remove_replica']:.2f}s")
        done("18d replica add and remove")

        step("18c split done")
        walls["split"] = waited(f"region {spl} split", splitting)
        split_q1 = frame(q1)
        compare_sql("phase 18 Q1 after the split", split_q1,
                    *c.wants["Q1 double-groupby-all"])
        check(split_q1.equals(before), "18c: Q1 after the split differs")
        regions = sorted(set(peers(view=True)["region_number"]))
        log(f"  ADMIN SPLIT REGION {tname} {spl} AT {at!r} to done: "
            f"{walls['split']:.2f}s; regions now {regions}; Q1 bit-equal")
        done("18c split done")

        step("18d")
        # region `mig` (its leader dn3) gets a follower on dn1
        t0 = time.perf_counter()
        frame(f"ADMIN ADD REPLICA {tname} {mig} TO 1")
        wait_for(f"region {mig}'s follower on dn1",
                 lambda: settled(mig, 1, leader=False), c.children())
        walls["add_replica"] = time.perf_counter() - t0
        check(settled(mig, 1, leader=False, view=True), "18d: information_"
              "schema.region_peers does not show the follower")
        # the hosts of region `mig`, and rows after the loaded span
        rule = c.rule
        hosts = [tg for tg in c.tags if rule.find_region((tg[0],)) == mig]
        next_ts = [int(c.ts[-1]) + INTERVAL_MS]
        acked, failed, lock = [], [], threading.Lock()

        def insert(fe, n):
            # n rows of distinct keys: the region's hosts in turn, each row
            # a millisecond after the last
            with lock:
                t = next_ts[0]
                next_ts[0] += n
            rows = [(hosts[i % len(hosts)], t + i) for i in range(n)]
            vals = ", ".join(
                "(" + ", ".join(f"'{v}'" for v in tg) + f", {ts}, {i}.5)"
                for i, (tg, ts) in enumerate(rows))
            keys = [(tg[0], ts) for tg, ts in rows]
            try:
                fe.do_query(f"INSERT INTO {tname} ({', '.join(TSBS_TAGS)}, "
                            f"ts, usage_user) VALUES {vals}")
            except Exception as e:  # noqa: BLE001 — a refused write
                failed.extend(keys)
                return e
            acked.extend(keys)
            return None

        for _ in range(INGEST_BEFORE_KILL):
            check(insert(dfe, INGEST_ROWS) is None, "18d: an INSERT failed")
        # a read of region `mig` alone (its range on hostname, no point
        # predicate: the resident path, one launch on the node serving it)
        names = sorted(f"host_{h}" for h in range(HOSTS))
        upper = names[HOSTS // CLUSTER_REGIONS]
        check(all(tg[0] < upper for tg in hosts), "18d: region "
              f"{mig}'s hosts do not all sort below {upper!r}")
        want_n = len(acked)
        qr = (f"SELECT count(*) AS n, avg(usage_user) AS a FROM {tname} "
              f"WHERE hostname < '{upper}' AND ts > {int(c.ts[-1])}")
        dfe.do_query("SET read_replica = 'follower'")
        dfe.do_query(f"SET replica_max_lag_ms = {REPLICA_LAG_MS}")

        def caught_up():
            rows = peers(view=True)
            r = rows[(rows["region_number"] == mig)]
            lead = r[r["is_leader"] == "Yes"]["replicated_seq"].tolist()
            fol = r[r["is_leader"] == "No"]
            return len(fol) == 1 and fol["replicated_seq"].tolist() == \
                lead and fol["lag_ms"].iloc[0] is not None and \
                0 <= fol["lag_ms"].iloc[0] <= REPLICA_LAG_MS
        wait_for("the follower caught up (region_peers)", caught_up,
                 c.children())
        served, follower_launches = {}, 0
        for _ in range(6):
            an = frame("EXPLAIN ANALYZE " + qr)
            text = "\n".join(f"{st.strip()}: {d}"
                             for st, d in zip(an["stage"], an["detail"]))
            got = int(frame(qr)["n"].iloc[0])
            check(got == want_n, f"18d: a replica read answered {got}, "
                  f"want {want_n}")
            for node, n in analyze_launches(text).items():
                served[node] = served.get(node, 0) + 1
                if node == "dn1":
                    follower_launches += n
            if "dn1" in served and "dn3" in served:
                break
        moments += follower_launches
        check("dn1" in served and (follower_launches > 0 or
                                   DEVICE != "cuda"),
              f"18d: no read of region {mig} landed on its follower (with "
              f"a launch): {served}, {follower_launches} launches")
        doc, _, _ = c.http.sql("SET read_replica = 'follower'")
        doc, _, _ = c.http.sql(qr)
        check(records(doc["output"][0])["n"] == [want_n],
              f"18d: the child's replica read {doc}")
        c.http.sql("SET read_replica = 'leader'")
        dfe.do_query("SET read_replica = 'leader'")
        log(f"  ADMIN ADD REPLICA {tname} {mig} TO 1 to done "
            f"{walls['add_replica']:.2f}s; "
            f"SET read_replica = 'follower' (lag bound {REPLICA_LAG_MS} "
            f"ms): reads of region {mig} served by {served} (the follower "
            f"dn1's node blocks: {follower_launches} segment_moments "
            f"launches), each counting {want_n} rows; the child's too")
        # SIGKILL of the region's leader under acknowledged ingest
        stop = threading.Event()
        errors = []

        def writer():
            while not stop.is_set():
                e = insert(dfe, INGEST_ROWS)
                if e is not None:
                    # a write re-routes only on a stale-route error, as in
                    # the reference; a refused connection to the dead
                    # leader fails the INSERT. The client reads, and the
                    # read's stale-route retry refreshes the route
                    errors.append(e)
                    try:
                        dfe.do_query(qr)
                    except Exception as e2:  # noqa: BLE001 — still moving
                        errors.append(e2)
                    time.sleep(0.2)
        th = threading.Thread(target=writer, daemon=True)
        th.start()
        time.sleep(0.5)
        t_kill = time.perf_counter()
        c.dns[3].kill()
        wait_for(f"region {mig} promoted on dn1", lambda: next(
            rt.leader.id for rt in c.meta.route(full).region_routes
            if rt.region_number == mig) == 1, c.children())
        walls["kill_to_route"] = time.perf_counter() - t_kill
        n_at_route = len(acked)
        wait_for("acknowledged writes after the promotion",
                 lambda: len(acked) >= n_at_route + 3 * INGEST_ROWS,
                 c.children())
        stop.set()
        th.join(60)
        check(not th.is_alive(), "18d: the writer did not stop")
        keys = frame(f"SELECT hostname, ts FROM {tname} WHERE hostname < "
                     f"'{upper}' AND ts > {int(c.ts[-1])}")
        got = list(zip(keys["hostname"], keys["ts"].astype("int64")
                       if keys["ts"].dtype.kind == "i" else
                       keys["ts"].astype("int64") // 1_000_000))
        walls["kill_to_answer"] = time.perf_counter() - t_kill
        check(len(got) == len(set(got)), "18d: duplicated rows")
        missing = set(acked) - set(got)
        extra = set(got) - set(acked) - set(failed)
        check(not missing and not extra, f"18d: {len(missing)} acknowledged "
              f"rows lost, {len(extra)} rows never written")
        loaded = int(frame(f"SELECT count(*) AS n FROM {tname} WHERE ts <= "
                           f"{int(c.ts[-1])}")["n"].iloc[0])
        check(loaded == len(c.ts) * HOSTS, f"18d: {loaded} rows of the "
              f"loaded span after the promotion, want {len(c.ts) * HOSTS}")
        log(f"  SIGKILL of dn3 (region {mig}'s leader) under acknowledged "
            f"ingest ({INGEST_ROWS} rows an INSERT): the route named the "
            f"promoted dn1 after {walls['kill_to_route']:.2f}s; all "
            f"{len(acked)} acknowledged rows read back exactly once after "
            f"{walls['kill_to_answer']:.2f}s ({len(failed)} rows of "
            f"refused INSERTs, {len(set(got) & set(failed))} of them "
            f"landed); the loaded span's {loaded} rows all there")
        done("18d")
    finally:
        win.counts_leq_grid = grid
        trace_store.configure(sample_ratio=saved[0])
        dist.configure_read_replica(mode=saved[1][0], max_lag_ms=saved[2][0])
        sketches.configure(exact_distinct=saved[3])
        if sa is not None:
            sa.shutdown()
        if dfe is not None:
            dfe.shutdown()
    walls["phase"] = time.perf_counter() - t_phase
    log(f"phase 18: K1 {k1} launches on the frontend's device, "
        f"segment_moments {moments} in the datanode processes' node "
        f"blocks; " + ", ".join(f"{k} {v:.1f}s" for k, v in steps.items()) +
        f"; {walls['phase']:.1f}s")
    return types.SimpleNamespace(k1=k1, k1_row=k1_row, moments=moments,
                                 walls=walls)


def dist_goldens():
    """17e: the seven distributed sqlness goldens the distributed frontend
    answers, through tools/sqlness.py's DistEnv (two datanodes and a
    DistInstance in this process) on the card, byte-equal to their
    .result files. Returns their segment_moments launches (the pushed-
    down aggregates reduce on the datanodes' device: DistTables take no
    dispatch floor)."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.tools import sqlness
    n0 = K.segment_moments.launches
    t0 = time.perf_counter()
    failed = [err for err in (
        sqlness.run_one(sqlness.DIST_CASES_DIR / f"{case}.sql",
                        device=DEVICE) for case in sqlness.DIST_IN_SCOPE)
        if err is not None]
    wall = time.perf_counter() - t0
    check(not failed, "distributed goldens differ on the card:\n" +
          "\n".join(failed))
    n = K.segment_moments.launches - n0
    log(f"  {len(sqlness.DIST_IN_SCOPE)} distributed sqlness cases through "
        f"tools/sqlness.py's DistEnv on {DEVICE!r} byte-equal to their "
        f".result in {wall:.2f}s ({n} segment_moments launches)")
    return n


def k1_row_at(torch, args, label):
    """K1's kernel-table row timed at one main-path call's inputs (a run
    without phase 4, whose row comes from phase 3); `label` names the
    phase that gave them."""
    from greptimedb_tpu_torch.ops import pallas_window as pw
    ts, t0, step, T = args
    S, L = ts.shape
    want = pw.counts_leq_plain(pw.step_buckets(ts, t0, step, T), T)
    err = same(torch, f"counts_leq_grid at {label} shape ({S}, {L}) "
               f"T={T}", pw.counts_leq_grid(ts, t0, step, T), want)
    ends = (torch.arange(T, dtype=torch.int64, device=ts.device) * step +
            t0).to(torch.int32)[None, :].expand(S, -1).contiguous()
    launches = pw.counts_leq_grid.launches
    ms = median_ms(torch, lambda: pw.counts_leq_grid(ts, t0, step, T))
    pw.counts_leq_grid.launches = launches      # timing is off the path
    plain = median_ms(torch, lambda: pw.counts_leq_plain(
        pw.step_buckets(ts, t0, step, T), T))
    lib = median_ms(torch, lambda: torch.searchsorted(ts, ends, right=True))
    bound_ms, bound_by, _, _ = bound(S, L, T)
    log(f"  K1 at ({S}, {L}) T={T}: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"torch.searchsorted {lib:.4f} ms, bound {bound_ms:.5f} ms by "
        f"{bound_by}")
    return {"name": "counts_leq_grid", "route": "cuda",
            "source": "greptimedb_tpu_torch/csrc/counts_leq.cu",
            "replaces": "greptimedb_tpu/ops/pallas_window.py:61",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib}


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
# phase 19: the grouped-moments kernel, then parallel/ over NCCL
# ---------------------------------------------------------------------------

#: 19a: Q1's avg of the ten fields, then max, min, stddev, first and last
#: of usage_user, by host x hour over cpu-only's 12 h (48 000 groups)
GROUPED_HOURS = 12
GROUPED_OPS = ("avg",) * len(CPU_FIELDS) + ("max", "min", "stddev",
                                            "first", "last")
GROUPED_MASKED = 0.1
#: 19b: the time-blocked grid (cpu-only's first 1440 samples, 4 h) and
#: phase 4's cut of the gather path (one region's hosts over 2 h)
BLOCKED_STEPS = 1440
BLOCKED_WINDOW = 5
GATHER_REGION = "us-east-1"
GATHER_HOURS = 2


def grouped_rows(torch, seed):
    """19a's rows in TSBS's generation order (time-major: every host at
    each 10 s tick), so consecutive rows fall in different groups: gid =
    host * 12 + hour, ts the ms offset of the tick, about 10 % of rows
    masked, the ten usage_* fields as float32. The fields are TSBS
    cpu-only's random walks (tsbs_cpu_table's: start U(0, 100), steps
    N(0, 1), clamped to [0, 100], in float64), walked on the device from
    `seed` (a torch generator: other numbers than tsbs_cpu_table's).
    Host numpy arrays."""
    ticks = GROUPED_HOURS * 3600_000 // INTERVAL_MS
    k = len(CPU_FIELDS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    x = torch.rand((k, HOSTS), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 100.0
    steps = torch.randn((ticks, k, HOSTS), generator=gen, device=DEVICE,
                        dtype=torch.float64)
    walk = torch.empty((ticks, k, HOSTS), dtype=torch.float32,
                       device=DEVICE)
    for i in range(ticks):
        x = (x + steps[i]).clamp_(0.0, 100.0)
        walk[i] = x
    cols = [walk[:, j].reshape(-1).cpu().numpy() for j in range(k)]
    del steps, walk
    tick = np.repeat(np.arange(ticks, dtype=np.int64), HOSTS)
    host = np.tile(np.arange(HOSTS, dtype=np.int64), ticks)
    gids = (host * GROUPED_HOURS + tick * INTERVAL_MS // 3600_000).astype(
        np.int32)
    mask = np.random.default_rng(seed + 19).random(gids.shape[0]) >= \
        GROUPED_MASKED
    return gids, mask, (tick * INTERVAL_MS).astype(np.int32), cols


def grouped_brute(name, res, counts, rows, G):
    """The aggregate over the 17.28 M rows against float64 numpy on the
    host: counts, max, min, first and last exact; each avg within 3 units
    of float32 roundoff of the exact mean (the sum and the division each
    round once); stddev within 1e-4 relative plus the square root of the
    float32 cancellation in its shifted moments, 4 u32 (sum d^2 +
    (sum d)^2 / c) / (c - 1), d = x minus the global mean. The rows are
    time-major, one a host a tick, so a group (host, hour) is a [360]
    column of a [12, 360, hosts] view, in tick (= ts) order."""
    gids, mask, ts, cols = rows
    hours, per = GROUPED_HOURS, 3600_000 // INTERVAL_MS

    def by_group(a):
        # [ticks * hosts] -> [hosts * hours, per] in gid order
        return a.reshape(hours, per, HOSTS).transpose(2, 0, 1).reshape(
            HOSTS * hours, per)

    m = by_group(mask)
    n_g = m.sum(axis=1)
    check(G == HOSTS * hours and np.array_equal(
        by_group(gids)[:, 0], np.arange(G, dtype=np.int32)),
        f"{name}: rows not in the time-major layout")
    check(np.array_equal(counts.cpu().numpy(), n_g.astype(np.int32)),
          f"{name}: counts differ from numpy")
    got = [r.cpu().numpy() for r in res]
    for j, f in enumerate(CPU_FIELDS):
        want = np.where(m, by_group(cols[j]).astype(np.float64), 0.0).sum(
            axis=1) / np.maximum(n_g, 1)
        outside = np.abs(got[j] - want) > 3 * U32 * np.abs(want)
        check(not outside.any(), f"{name}: avg({f}) off the float64 mean "
              f"in {int(outside.sum())} groups")
    u = by_group(cols[0]).astype(np.float64)
    k = len(CPU_FIELDS)
    check(np.array_equal(got[k], np.where(m, u, -np.inf).max(axis=1)),
          f"{name}: max(usage_user) differs from numpy")
    check(np.array_equal(got[k + 1], np.where(m, u, np.inf).min(axis=1)),
          f"{name}: min(usage_user) differs from numpy")
    rows_g = np.arange(G)
    first = u[rows_g, m.argmax(axis=1)]
    last = u[rows_g, per - 1 - m[:, ::-1].argmax(axis=1)]
    check(np.array_equal(got[k + 3], first), f"{name}: first differs")
    check(np.array_equal(got[k + 4], last), f"{name}: last differs")
    mean = np.where(m, u, 0.0).sum(axis=1) / n_g
    var = np.where(m, (u - mean[:, None]) ** 2, 0.0).sum(axis=1) / (n_g - 1)
    std = np.sqrt(var)
    d = np.where(m, u - u[m].mean(), 0.0)
    s_d, sq = d.sum(axis=1), (d * d).sum(axis=1)
    lim = 1e-4 * std + np.sqrt(4 * U32 * (sq + s_d * s_d / n_g) / (n_g - 1))
    outside = np.abs(got[k + 2] - std) > lim
    check(not outside.any(), f"{name}: stddev(usage_user) off numpy in "
          f"{int(outside.sum())} groups")
    log(f"  {name}: {G} groups against float64 numpy: counts, max, min, "
        f"first, last exact, ten avgs within 3 u32, stddev within its "
        f"cancellation bound (max |err| "
        f"{float(np.abs(got[k + 2] - std).max()):.3g})")


def same_bits(torch, name, got, want):
    """Two window results bit for bit (NaN where NaN)."""
    torch.cuda.synchronize()
    for label, g, w in zip(("result", "ok"), got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name} {label}: {g.dtype} {tuple(g.shape)} != {w.dtype} "
              f"{tuple(w.shape)}")
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        check(torch.equal(g, w), f"{name} {label}: differs at "
              f"{int((g != w).sum())} of {g.numel()}")


def phase_parallel(torch, seed):
    """Phase 19 (see the module's docstring). Returns its launches by
    kernel, the grouped_moments row of the kernel table, K1's row at
    19b's series-sharded inputs and the walls."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.ops import pallas_window as pw
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.parallel import (
        distributed_grouped_aggregate, make_mesh,
        series_sharded_range_aggregate, time_blocked_window_sum)
    from greptimedb_tpu_torch.tools import grouped_moments_bench as gmb
    from greptimedb_tpu_torch.tools import multichip
    from greptimedb_tpu_torch.tools import segment_moments_bench as smb

    walls = {}
    t_phase = time.perf_counter()
    G = HOSTS * GROUPED_HOURS
    t0 = time.perf_counter()
    rows = grouped_rows(torch, seed)
    gids, mask, rts, cols = rows
    values = cols + [cols[0]] * 5
    walls["data"] = time.perf_counter() - t0
    log(f"19a: TSBS cpu-only {HOSTS} hosts x {GROUPED_HOURS} h walked on "
        f"the device, {gids.shape[0]} rows in generation order, {G} groups "
        f"(host x hour), {int((~mask).sum())} rows masked, in "
        f"{walls['data']:.1f}s")

    # ---- 19a: the kernel against its plain version ----
    err = 0.0
    t0 = time.perf_counter()
    for name, build in gmb.edge_cases(seed):
        e_args, g_n = build(DEVICE)
        err = max(err, gmb.agree(name, e_args, g_n))
        del e_args
    walls["edge cases"] = time.perf_counter() - t0
    args, _ = K.grouped_aggregate_plan(gids, mask, rts, values,
                                       num_groups=G, ops=GROUPED_OPS,
                                       device=DEVICE)
    check(tuple(GROUPED_OPS) == gmb.GROUPED_OPS, "19a's ops differ from "
          "the timing tool's")
    err = max(err, gmb.agree(f"main-path shape ({gids.shape[0]} rows)",
                             args, G))
    launches0 = K.grouped_moments.launches

    # ---- the main path, counted: 19a's aggregate and 19b ----
    K.grouped_moments.launches = 0
    pw.counts_leq_grid.launches = 0
    K.segment_moments.launches = 0
    t0 = time.perf_counter()
    res, counts = K.grouped_aggregate(gids, mask, rts, values, num_groups=G,
                                      ops=GROUPED_OPS, device=DEVICE)
    torch.cuda.synchronize()
    walls["19a aggregate"] = time.perf_counter() - t0
    grouped_brute("grouped_aggregate", res, counts, rows, G)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    n_dev = torch.cuda.device_count()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        log(f"19b: init_process_group('nccl') in this process, world size "
            f"1 ({n_dev} GPU{'s' if n_dev > 1 else ''}): {mesh}")
        t0 = time.perf_counter()
        d_res, d_counts = distributed_grouped_aggregate(
            gids, mask, rts, values, num_groups=G, ops=GROUPED_OPS,
            mesh=mesh)
        torch.cuda.synchronize()
        walls["19b aggregate"] = time.perf_counter() - t0
        check(torch.equal(d_counts, counts), "distributed counts differ")
        for op, g, w in zip(GROUPED_OPS, d_res, res):
            check(g.dtype == w.dtype, f"distributed {op}: {g.dtype}")
            if op in gmb.EXACT:
                ok = (g == w) | (torch.isnan(g) & torch.isnan(w))
            else:
                ok = torch.isclose(g, w, rtol=3e-4, atol=1e-4,
                                   equal_nan=True)
            check(bool(ok.all()), f"distributed {op} differs from "
                  f"grouped_aggregate at {int((~ok).sum())} groups")
        log(f"  distributed_grouped_aggregate == grouped_aggregate at "
            f"{gids.shape[0]} rows x {G} groups ({len(GROUPED_OPS)} ops, "
            f"sums within rtol 3e-4 / atol 1e-4) in "
            f"{walls['19b aggregate']:.2f}s ({walls['19a aggregate']:.2f}s "
            f"on one device)")
        del d_res, res

        # series-sharded windows at phase 4's shape, bit for bit
        ts, labels, metrics = tsbs_cpu_only(seed)
        S, n = metrics["cpu_usage_user"].shape
        L = 1 << (n - 1).bit_length()
        ts2d = np.full((S, L), win.TS_PAD, dtype=np.int64)
        ts2d[:, :n] = ts
        lengths = np.full(S, n, dtype=np.int32)
        start = int(ts[0])
        T = HOURS * 3600_000 // STEP_MS + 1
        steps = start + np.arange(T, dtype=np.int64) * STEP_MS
        for metric, op in (("cpu_seconds_total", "rate"),
                           ("cpu_usage_user", "avg_over_time")):
            val2d = np.zeros((S, L), dtype=np.float32)
            val2d[:, :n] = metrics[metric]
            t0 = time.perf_counter()
            got = series_sharded_range_aggregate(
                ts2d, val2d, lengths, start, STEP_MS, RANGE_MS, op=op,
                nsteps=T, mesh=mesh)
            torch.cuda.synchronize()
            walls[f"19b {op}"] = time.perf_counter() - t0
            want = win.range_aggregate_cumsum(
                ts2d, torch.from_numpy(val2d).to(DEVICE),
                torch.from_numpy(lengths).to(DEVICE), start, STEP_MS,
                RANGE_MS, op=op, nsteps=T)
            same_bits(torch, f"series-sharded {op}", got, want)
            if op == "avg_over_time":
                # 8 series against float64 numpy: windowed sums are
                # differences of float32 prefixes (tests/test_torch_window)
                M = brute_windows(ts, steps, RANGE_MS).astype(np.float64)
                x = metrics[metric][:8].astype(np.float32).astype(np.float64)
                c = M.sum(axis=1, keepdims=True)
                ref = (M @ x.T) / c
                g8 = got[0][:8].cpu().numpy().T
                lim = 8 * 2 * U32 * np.abs(x).sum(axis=1)[None, :] / c + \
                    1e-5 * np.abs(ref)
                check(bool((np.abs(g8 - ref) <= lim).all()),
                      "series-sharded avg_over_time off numpy")
            log(f"  series_sharded_range_aggregate {op} at ({S}, {L}) T={T}"
                f" == range_aggregate_cumsum bit for bit in "
                f"{walls[f'19b {op}']:.2f}s")
        rel, t0_rel = win._rebase_i64_host(ts2d, start, STEP_MS, T, RANGE_MS)
        k1_args = (torch.from_numpy(rel).to(DEVICE), int(t0_rel), STEP_MS, T)
        del val2d, got, want

        # the gather route at phase 4's cut
        hosts = np.array([i for i, lab in enumerate(labels)
                          if lab["region"] == GATHER_REGION])
        n_g = GATHER_HOURS * 3600_000 // INTERVAL_MS
        Lg = 1 << (n_g - 1).bit_length()
        gts = np.full((hosts.size, Lg), win.TS_PAD, dtype=np.int64)
        gts[:, :n_g] = ts[:n_g]
        gval = np.zeros((hosts.size, Lg), dtype=np.float32)
        gval[:, :n_g] = metrics["cpu_usage_user"][hosts, :n_g]
        Tg = GATHER_HOURS * 3600_000 // STEP_MS + 1
        got = series_sharded_range_aggregate(
            gts, gval, np.full(hosts.size, n_g, np.int32), start, STEP_MS,
            RANGE_MS, op="max_over_time", nsteps=Tg, mesh=mesh)
        want = win.range_aggregate_gather(
            gts, torch.from_numpy(gval).to(DEVICE), start, STEP_MS,
            RANGE_MS, op="max_over_time", nsteps=Tg, maxw=128,
            series_block=min(128, hosts.size))
        same_bits(torch, "series-sharded max_over_time", got, want)
        log(f"  series_sharded_range_aggregate max_over_time at "
            f"({hosts.size}, {Lg}) T={Tg} (phase 4's cut) == "
            f"range_aggregate_gather bit for bit")

        # time-blocked windows against numpy
        grid = metrics["cpu_usage_user"][:, :BLOCKED_STEPS].astype(np.float32)
        w = BLOCKED_WINDOW
        padded = {op: np.concatenate([np.full((S, w - 1), fill), grid.astype(
            np.float64)], axis=1) for op, fill in
            (("sum", 0.0), ("min", np.inf), ("max", -np.inf))}
        shifted = {op: np.stack([p[:, k:k + BLOCKED_STEPS] for k in
                                 range(w)]) for op, p in padded.items()}
        brute = {"sum": shifted["sum"].sum(0),
                 "avg": shifted["sum"].sum(0) / w,
                 "min": shifted["min"].min(0), "max": shifted["max"].max(0)}
        # sums are differences of a float32 prefix over the block
        prefix = np.abs(grid.astype(np.float64)).sum(axis=1, keepdims=True)
        for op in ("sum", "avg", "min", "max"):
            got = time_blocked_window_sum(grid, window=w, op=op,
                                          mesh=mesh).cpu().numpy()
            check(got.dtype == np.float32 and got.shape == grid.shape,
                  f"time-blocked {op}: {got.dtype} {got.shape}")
            if op in ("min", "max"):
                check(np.array_equal(got, brute[op]), f"time-blocked {op} "
                      f"differs from numpy")
            else:
                lim = 8 * 2 * U32 * prefix / (w if op == "avg" else 1) + \
                    1e-5 * np.abs(brute[op])
                check(bool((np.abs(got - brute[op]) <= lim).all()),
                      f"time-blocked {op} off numpy")
        log(f"  time_blocked_window_sum over ({S}, {BLOCKED_STEPS}) at "
            f"window {w}: sum / avg within 8 eps32 of the row's prefix, "
            f"min / max exact")
        del grid, padded, shifted, brute, metrics

        t0 = time.perf_counter()
        info = multichip.dryrun_multichip(n_dev, "cuda")
        walls["19b dryrun"] = time.perf_counter() - t0
        log(f"  tools.multichip.dryrun_multichip({n_dev}, 'cuda'): {info} "
            f"in {walls['19b dryrun']:.2f}s")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    grouped = K.grouped_moments.launches
    k1 = pw.counts_leq_grid.launches
    moments = K.segment_moments.launches
    check(grouped > 0 and k1 > 0, f"phase 19 launched grouped_moments "
          f"{grouped} and K1 {k1} times")
    log(f"phase 19's main path: grouped_moments {grouped}, K1 {k1}, "
        f"segment_moments {moments} launches")

    # ---- 19a's row: the kernel timed at the main path's inputs (CUDA
    # events around 20 calls behind a spin kernel), then at the same rows
    # in random order ----
    K.grouped_moments.launches = launches0
    ms = smb.median_fenced_ms(lambda: K.grouped_moments(*args, num_groups=G))
    shuffled = gmb.reorder(args, "random", seed)
    ms_random = smb.median_fenced_ms(
        lambda: K.grouped_moments(*shuffled, num_groups=G))
    del shuffled
    K.grouped_moments.launches = launches0     # timing is off the path
    plain = median_ms(torch, lambda: K.grouped_moments_plain(
        *args, num_groups=G), launches=3, runs=3)
    lib, nlib = gmb.grouped_library(args, G)
    lib_ms = median_ms(torch, lib, launches=3, runs=3)
    b_ms, b_by, nbytes = gmb.grouped_bound(args, G)
    log(f"grouped_moments at the main-path shape: {gids.shape[0]} rows, {G}"
        f" groups, {len(args[5])} moments; kernel {ms:.4f} ms "
        f"({b_ms / ms * 100:.1f}% of the bound), in random order "
        f"{ms_random:.4f} ms ({b_ms / ms_random * 100:.1f}%), plain "
        f"{plain:.4f} ms, index_add_ / scatter_reduce_ x {nlib} "
        f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.1f} MB)")
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "random_order_ms": ms_random}
    walls["phase"] = time.perf_counter() - t_phase
    log("phase 19: " + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items()))
    return types.SimpleNamespace(grouped=grouped, k1=k1, moments=moments,
                                 row=row, k1_args=k1_args, walls=walls)


# ---------------------------------------------------------------------------

#: the phases; `--phases` runs some of them with the phases they stand on
# ---------------------------------------------------------------------------
# phase 20: the race hammer on the card
# ---------------------------------------------------------------------------

#: seconds of the hammer's workload (the child's start and its cluster's
#: set-up come on top)
RACE_HAMMER_S = 5.0


def phase_race_hammer():
    """Phase 20: tools/race_hammer.py on the card in a child process with
    the port's race detector on. Returns its launches by kernel, its
    wall (the child's start included) and its summary."""
    log("== phase 20: the race hammer on the card (the port's race "
        "detector over concurrent ingest, flush, compaction, scatter, "
        "balancer, self-monitor and PromQL)")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.tools.race_hammer",
         "--device", DEVICE, "--seconds", str(RACE_HAMMER_S)], cwd=HERE,
        env=dict(os.environ, GREPTIME_RACE_CHECK="1"), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"race_hammer exited {proc.returncode}:\n{proc.stdout[-2000:]}"
          f"\n{proc.stderr[-6000:]}")
    out = json.loads(lines[-1])
    check(out["seeded_reported"], "race_hammer: its seeded race went "
          "unreported: the detector is dead")
    check(out["unsuppressed"] == 0 and not out["errors"],
          f"race_hammer: {out['unsuppressed']} unsuppressed races, errors "
          f"{out['errors']}:\n{proc.stderr[-6000:]}")
    check(out["accesses"] > 0, "race_hammer recorded no tracked access")
    launches = out["launches"]
    check(launches["segment_moments"] > 0 and
          launches["counts_leq_grid"] > 0,
          f"race_hammer launched {launches}: a route did not reach its "
          f"kernel")
    log(f"  race_hammer --device {DEVICE}: {out['races']} races "
        f"({out['unsuppressed']} unsuppressed), the seeded race reported, "
        f"{out['accesses']} tracked accesses over {len(out['states'])} "
        f"structures in {out['seconds']:.1f}s of workload; launches "
        f"{launches}; the child took {wall:.1f}s, its run "
        f"{out['wall_s']:.1f}s")
    return types.SimpleNamespace(launches=launches, wall=wall, out=out)


def hammer_k1_args(torch):
    """K1's inputs at the hammer's TQL shape (8 series, a sample a
    second over 600 s, steps of 15 s), for a run where phase 20 alone
    launches K1."""
    S, L, step = 8, 600, 15_000
    ts = (torch.arange(L, dtype=torch.int32, device=DEVICE) * 1000)[None]
    return ts.expand(S, -1).contiguous(), 0, step, L * 1000 // step + 1


PHASES = tuple(str(i) for i in range(1, 21))
#: what each phase needs run with it (phases 1 and 2 always run): 3 and 4
#: are one call, as are 6 and 7; 5 launches segment_moments before the
#: phases that fence its launches (a process's first launch loads the
#: module); 8, 10, 12a and 13 run on phase 6's frontend and tables, 9
#: compares with phase 4's answers, 11 and 12b run on phase 9's frontend
#: (12b only when 9 runs); 14 and 15 have data homes of their own and
#: need none; 16 launches in its datanode processes, so phase 15 times the
#: kernel at the region shape they launch at; 17 rides phase 16's cluster
#: and 18 phase 17's frontend child; 19 and 20 need none
NEEDS = {"3": ("4",), "4": ("3",), "6": ("5", "7"), "7": ("6",),
         "8": ("6",), "9": ("4", "5"), "10": ("6",), "11": ("9",),
         "12": ("6",), "13": ("6",), "16": ("15",), "17": ("16",),
         "18": ("17",)}


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
    card = phase_machine(torch)
    log("== phase 2: build")
    phase_kernel_build()
    # each main-path kernel's launches by the phase that made them
    k1_by, moments_by, shapes, walls = {}, {}, {}, {}
    kern = p4 = k1_row = k1_row18 = None
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
                wire = phase_wire_sql(torch, st.sql, st.queries, st.cpu_p,
                                      st.q1_24h)
                moments_by["12"] = wire.moments
                walls["12a"] = wire.walls["phase"]
            if "13" in phases:
                obs = phase_observe(torch, st.sql, st.queries)
                moments_by["13"], k1_by["13"] = obs.moments, obs.k1
                walls["13"] = obs.walls["phase"]
                if kern is None:
                    log("== K1 at phase 13's shape (phase 4 did not run)")
                    k1_row = k1_row_at(torch, obs.k1_inputs, "phase 13's")
                del obs
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
    if "14" in phases:
        s3 = phase_s3(torch, args.seed)
        moments_by["14"], k1_by["14"] = s3.moments, s3.k1
        walls["14"] = s3.walls["phase"]
        if kern is None and k1_row is None:
            log("== K1 at phase 14's shape (phases 4 and 13 did not run)")
            k1_row = k1_row_at(torch, s3.k1_inputs, "phase 14's")
        if not shapes:
            log("== phase 14's Q1 launch against the plain version")
            shapes.update(phase_moments_time(
                torch, {"phase 14 Q1": s3.moment_inputs}, tool=False))
        del s3
    if "15" in phases:
        cluster = phase_cluster(torch, args.seed)
        moments_by["15"] = cluster.moments
        walls["15"] = cluster.walls["phase"]
        log("== phase 15's first region Q1 launch against the plain version")
        shapes.update(phase_moments_time(
            torch, {"phase 15 Q1 region": cluster.moment_inputs},
            tool=False))
        del cluster
    if "16" in phases:
        procs = phase_procs(torch, args.seed, frontend="17" in phases,
                            elastic="18" in phases)
        moments_by["16"] = procs.moments
        if "17" in phases:
            moments_by["17"] = procs.moments17
        if "18" in phases:
            moments_by["18"] = procs.p18.moments
            k1_by["18"] = procs.p18.k1
            walls["18"] = procs.p18.walls["phase"]
            k1_row18 = procs.p18.k1_row
            if kern is None and k1_row is None:
                k1_row = k1_row18
        walls["16"] = procs.walls["phase"]
        del procs
    grouped_by, grouped_row = {}, None
    if "19" in phases:
        log("== phase 19: grouped_moments against its plain version, then "
            "parallel/ over NCCL")
        p19 = phase_parallel(torch, args.seed)
        grouped_by["19"], grouped_row = p19.grouped, p19.row
        k1_by["19"] = p19.k1
        moments_by["19"] = p19.moments
        walls["19"] = p19.walls["phase"]
        if kern is None and k1_row is None:
            log("== K1 at phase 19's series-sharded shape (phases 4, 13, 14 "
                "and 18 did not run)")
            k1_row = k1_row_at(torch, p19.k1_args, "phase 19's")
        del p19
    if "20" in phases:
        p20 = phase_race_hammer()
        k1_by["20"] = p20.launches["counts_leq_grid"]
        moments_by["20"] = p20.launches["segment_moments"]
        walls["20"] = p20.wall
        if kern is None and k1_row is None:
            log("== K1 at phase 20's TQL shape (no phase that times K1 ran)")
            k1_row = k1_row_at(torch, hammer_k1_args(torch), "phase 20's")
    if moments_by and not shapes:
        log("== segment_moments at the timing tool's Q1 inputs (no phase "
            "that times it ran)")
        shapes.update(phase_moments_time(
            torch, {"Q1": smb.main_path_inputs("Q1", DEVICE)}, tool=False))
    if "12" in phases:
        log(f"phase 12 took {walls['12a']:.1f}s (12a) + "
            f"{walls.get('12b', 0.0):.1f}s (12b)")
    if "13" in phases:
        log(f"phase 13 took {walls['13']:.1f}s")
    if "14" in phases:
        log(f"phase 14 took {walls['14']:.1f}s")
    if "15" in phases:
        log(f"phase 15 took {walls['15']:.1f}s")
    if "16" in phases:
        log(f"phase 16{' with 17' if '17' in phases else ''}"
            f"{' and 18' if '18' in phases else ''} took {walls['16']:.1f}s")
    if "18" in phases:
        log(f"phase 18 took {walls['18']:.1f}s")
    if "19" in phases:
        log(f"phase 19 took {walls['19']:.1f}s")
    if "20" in phases:
        log(f"phase 20 took {walls['20']:.1f}s")
    kernels = []
    if k1_by:
        kernels.append({**(kern[0] if kern is not None else k1_row),
                        "launches": sum(k1_by.values()),
                        "launches_by_phase": k1_by,
                        **({"phase_18_shape": k1_row18}
                           if k1_row18 is not None else {})})
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
    if grouped_by:
        kernels.append({
            "name": "grouped_moments", "route": "cuda",
            "source": "greptimedb_tpu_torch/csrc/grouped_moments.cu",
            "replaces": "greptimedb_tpu/ops/kernels.py:90", **grouped_row,
            "launches": sum(grouped_by.values()),
            "launches_by_phase": grouped_by})
    new = set(sys.modules) - before
    bad = sorted(m for m in new if m.split(".")[0] in
                 ("jax", "jaxlib", "greptimedb_tpu"))
    check(not bad, f"the port imported {bad[:5]}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    # the card again beside the numbers below, for a reader of the
    # output's end
    log(card)
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
