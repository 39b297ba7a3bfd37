#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (greptimedb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]

Phases (none of them catches a failure; any failed check exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and whether pandas, pyarrow and prometheus_client import here;
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
6. serves SQL through QueryEngine.execute on the GPU over TSBS cpu-only
   (4000 hosts, 10 tags, 10 fields, 10 s, 12 h: 17.28 M rows): four TSBS
   queries and two that reach every op, each cold (scan cache empty) and
   warm, with the wall, the engine's stages, the kernel's device time and
   peak device memory (the launch fenced behind a spin kernel), then warm
   again unfenced for the wall and stages without the spin; checks every group against a float64 brute force
   (planted wrong answers must fail its bounds); then times the kernel at
   the Q1, Q4 and Q6 inputs against its plain version and
   torch.segment_reduce (bound and yardstick from the timing tool, whose
   own Q1/Q4/Q6 inputs must match these).

Before the last line come two JSON objects: the numbers of the bucket
entry, which the main paths do not launch, then the kernel table of the
main paths (PromQL's window bounds, SQL's segment moments); the last line is {"ok": true, "device": {...}}. Without CUDA,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

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
    for mod in ("pandas", "pyarrow", "prometheus_client"):
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
            super().__init__(catalog=None, device=device)
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
    return kern


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
    n = hours * 3600_000 // INTERVAL_MS
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


class MemRegion:
    """A region to the port's data seam (greptimedb_tpu_torch/query/
    tpu_exec.py) serving one ScanData: the storage engine is not ported
    yet."""

    def __init__(self, uid, data):
        import types
        self.uid, self.name = uid, f"{uid}_0"
        self.series_dict = data.series_dict
        self.last_scan_profile = None
        self._data = data
        mt = types.SimpleNamespace(num_rows=data.num_rows)
        self._version = types.SimpleNamespace(
            schema=data.schema,
            memtables=types.SimpleNamespace(all_memtables=lambda: [mt]),
            ssts=types.SimpleNamespace(all_files=lambda: []))
        self.version_control = types.SimpleNamespace(current=self._version)

    def snapshot(self):
        import types
        return types.SimpleNamespace(
            _version=self._version, scan=lambda: self._data,
            visible_sequence=int(self._data.num_rows))


def sql_catalog(ts, tags, fields):
    """The catalog with table `cpu` (tags as the primary key, ts the time
    index, the fields DOUBLE) over one region whose rows arrive
    time-major, as a TSBS loader writes them; every row a PUT with its
    own sequence. Returns (catalog, region, host series ids)."""
    from greptimedb_tpu_torch.catalog import MemoryCatalogManager
    from greptimedb_tpu_torch.datatypes import data_type as dt
    from greptimedb_tpu_torch.datatypes.schema import (ColumnSchema, Schema,
                                                       SemanticType)
    from greptimedb_tpu_torch.storage import ScanData, SeriesDict
    from greptimedb_tpu_torch.table import (Table, TableIdent, TableInfo,
                                            TableMeta)
    schema = Schema(
        [ColumnSchema(t, dt.STRING, semantic_type=SemanticType.TAG)
         for t in TSBS_TAGS] +
        [ColumnSchema("ts", dt.TIMESTAMP_MILLISECOND, nullable=False,
                      semantic_type=SemanticType.TIMESTAMP)] +
        [ColumnSchema(f, dt.FLOAT64) for f in CPU_FIELDS])
    sd = SeriesDict(list(TSBS_TAGS))
    host_sids = sd.encode_rows([[t[i] for t in tags]
                                for i in range(len(TSBS_TAGS))])
    H, n = fields[CPU_FIELDS[0]].shape
    N = H * n
    data = ScanData(schema, sd, np.tile(host_sids, n), np.repeat(ts, H),
                    np.arange(N, dtype=np.int64), np.zeros(N, np.int8),
                    {f: (fields[f].T.ravel(), None) for f in CPU_FIELDS})
    region = MemRegion("cpu-0", data)
    table = Table(TableInfo(TableIdent(1), "cpu", TableMeta(schema)))
    table.regions = {0: region}
    cat = MemoryCatalogManager()
    cat.register_table("greptime", "public", "cpu", table)
    return cat, region, host_sids


class MomentsTimer:
    """Wraps sorted_grouped_aggregate as the SQL path calls it: a spin
    kernel queued first keeps the card busy until the wrapper has queued
    the segment-moments launch, so CUDA events around the call time the
    kernel and not the host work before it. Keeps each call's inputs."""

    SPIN_CYCLES = 40_000_000        # ~20 ms at 1980 MHz

    def __init__(self, torch, inner):
        self.torch, self.inner = torch, inner
        self.pending, self.calls = [], []

    def __call__(self, gids, mask, ts, values, col_masks=(), **kw):
        cuda = self.torch.cuda
        e_spin, e0, e1 = (cuda.Event(enable_timing=True) for _ in range(3))
        h0 = time.perf_counter()
        e_spin.record()
        cuda._sleep(self.SPIN_CYCLES)
        e0.record()
        out = self.inner(gids, mask, ts, values, col_masks, **kw)
        enqueue_s = time.perf_counter() - h0
        e1.record()
        self.pending.append((e_spin, e0, e1, enqueue_s))
        self.calls.append((kw["ends"], mask, ts, list(values),
                           list(col_masks), list(kw["ops"])))
        return out

    def take(self):
        """Device ms of the launches since the last call."""
        self.torch.cuda.synchronize()
        rows = []
        for e_spin, e0, e1, enqueue_s in self.pending:
            spin_ms = e_spin.elapsed_time(e0)
            check(enqueue_s * 1e3 < spin_ms, f"the wrapper took "
                  f"{enqueue_s * 1e3:.2f} ms to enqueue, longer than the "
                  f"{spin_ms:.2f} ms spin ahead of it")
            rows.append(e0.elapsed_time(e1))
        self.pending = []
        return rows


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


def sql_expected(name, ts, fields, host_sids, eight):
    """The float64 brute force of one query: (frame of keys, exact
    columns and float columns with their bounds). Hosts sort as strings,
    as ORDER BY hostname does."""
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
                frame[f"__bound:{col}"] = sum_bound(S, S, width) / width + \
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
    elif name.startswith("Q5"):
        X = fields["usage_user"]
        S = X.sum(axis=1)
        sq = (X * X).sum(axis=1)
        c = n
        var = X.var(axis=1, ddof=1)
        std = np.sqrt(var)
        # the fold: var = (sq - s^2/c) / (c - 1) in float64 from the
        # float32 run sums s and sq
        es = sum_bound(S, S, c)
        esq = sum_bound(sq, sq, c) + U32 * sq      # the square's rounding
        var_err = (esq + (2 * es * np.abs(S) + es * es) / c) / (c - 1) + \
            8 * U64 * sq / (c - 1)
        df = pd.DataFrame({
            "hostname": names, "count(*)": np.full(H, c),
            "sum(usage_user)": S, "min(usage_user)": X.min(axis=1),
            "max(usage_user)": X.max(axis=1), "stddev(usage_user)": std,
            "first_value(usage_user)": X[:, 0],
            "last_value(usage_user)": X[:, -1]})
        for col in ("count(*)", "min(usage_user)", "max(usage_user)",
                    "first_value(usage_user)", "last_value(usage_user)"):
            exact[col] = True
        df["__bound:sum(usage_user)"] = es
        df["__bound:stddev(usage_user)"] = np.minimum(
            np.sqrt(var_err), var_err / np.maximum(std, 1e-300)) + \
            4 * U64 * std
        keys = ["hostname"]
    else:
        # one run of every row: ts ties across hosts break by position in
        # the merged scan, which is series-id order
        first_h, last_h = int(np.argmin(host_sids)), int(np.argmax(host_sids))
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
            sum_bound(S, S, N) / N + 4 * U64 * S / N
        keys = []
    if keys:
        df = df.sort_values(keys, kind="stable").reset_index(drop=True)
        for k in keys:
            exact[k] = True
    # each bound travels beside its column through the sort
    for col in [c for c in df.columns if c.startswith("__bound:")]:
        approx[col.split(":", 1)[1]] = df.pop(col).to_numpy()
    return df, exact, approx


def compare_sql(name, got, want, exact, approx):
    """Keys and counts exact; min, max, first and last equal to the
    float32 rounding of the float64 answer; sums, averages and stddev
    within their bounds. Returns the largest |err|/bound."""
    check(list(got.columns) == list(want.columns),
          f"{name}: columns {list(got.columns)} != {list(want.columns)}")
    check(len(got) == len(want), f"{name}: {len(got)} rows, want "
          f"{len(want)}")
    worst = 0.0
    for col in want.columns:
        g = got[col].to_numpy()
        w = want[col].to_numpy()
        if col in exact:
            if w.dtype.kind == "f":
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


def phase_sql(torch, seed):
    """SQL through QueryEngine.execute on the GPU: each query cold (scan
    cache empty), then warm, both with the launch fenced, then warm
    unfenced; per-query wall and stages; results against a float64 brute
    force. Returns the segment-moments launches of the run,
    and the kernel's inputs at Q1, Q4 and Q6."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.query import QueryEngine, ir, tpu_exec
    from greptimedb_tpu_torch.session import QueryContext
    from greptimedb_tpu_torch.sql import parse_sql

    t_gen = time.perf_counter()
    ts, tags, fields = tsbs_cpu_table(seed + 2)
    cat, region, host_sids = sql_catalog(ts, tags, fields)
    H, n = fields["usage_user"].shape
    log(f"TSBS cpu-only table cpu: {H} hosts x {n} samples = {H * n} rows, "
        f"10 tags, 10 fields, {SQL_HOURS} h, made in "
        f"{time.perf_counter() - t_gen:.1f}s (seed {seed + 2})")
    eng = QueryEngine(cat, device=DEVICE)
    eight, queries = sql_queries(np.random.default_rng(seed + 3), H)

    timer = MomentsTimer(torch, tpu_exec.sorted_grouped_aggregate)
    tpu_exec.sorted_grouped_aggregate = timer
    stage_s = {}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            stage_s[key] = stage_s.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    finalize, finish = ir._finalize, eng._finish_aggregate_frame
    ir._finalize = timed("finalize", finalize)
    eng._finish_aggregate_frame = timed("finish", finish)
    inputs = {}
    K.segment_moments.launches = 0
    try:
        for name, sql in queries.items():
            # cold and warm with the launch fenced (its device time), then
            # warm unfenced: the wall and stages without the spin, which
            # the fetch would otherwise wait out
            for run in ("cold", "warm", "warm unfenced"):
                if run == "cold":
                    tpu_exec.SCAN_CACHE.clear()
                fenced = run != "warm unfenced"
                tpu_exec.sorted_grouped_aggregate = \
                    timer if fenced else timer.inner
                stage_s.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = eng.execute(parse_sql(sql), QueryContext())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                kernel = ""
                if fenced:
                    dev_ms = timer.take()
                    check(len(dev_ms) == 1,
                          f"{name}: {len(dev_ms)} launches")
                    kernel = f" kernel (device) {dev_ms[0]:.4f} ms;"
                peak = torch.cuda.max_memory_allocated() / 2**30
                p = region.last_scan_profile
                st = dict(p.stages)
                st.update(stage_s)
                log(f"{name} [{run}, cache {p.outcome}]: wall "
                    f"{wall * 1e3:.1f} ms; " + ", ".join(
                        f"{k} {v * 1e3:.1f}" for k, v in st.items()) +
                    f" ms;{kernel} {out.num_rows} rows; peak device "
                    f"memory {peak:.2f} GiB")
                if run == "warm":
                    got = sql_frame(out)
                    want, exact, approx = sql_expected(
                        name, ts, fields, host_sids, eight)
                    worst = compare_sql(name, got, want, exact, approx)
                    log(f"  check {name}: {len(got)} rows vs the float64 "
                        f"brute force; keys, counts, min/max/first/last "
                        f"exact; max |err|/bound {worst:.3g}")
                    if name.startswith("Q5"):
                        planted(name, got, want, approx, fields)
            inputs[name.split()[0]] = timer.calls[-1]
            tpu_exec.sorted_grouped_aggregate = timer
    finally:
        tpu_exec.sorted_grouped_aggregate = timer.inner
        ir._finalize = finalize
    launches = K.segment_moments.launches
    check(launches == 3 * len(queries),
          f"the SQL path launched segment_moments {launches} times")
    log(f"segment_moments launches during the queries: {launches}")
    del fields
    return launches, inputs


def phase_moments_time(torch, inputs):
    """segment_moments at the main path's shapes (Q1, Q4, Q6), against
    its plain version and the library yardstick; Q1 is the table's row.
    The timing tool's own Q1/Q4/Q6 inputs must match these in every
    property the kernel's work depends on."""
    from greptimedb_tpu_torch.ops import kernels as K
    from greptimedb_tpu_torch.tools import segment_moments_bench as smb
    rows = {}
    for q in smb.QUERIES:
        args = inputs[q]
        ends, mask = args[0], args[1]
        want = smb.signature(args)
        got = smb.signature(smb.main_path_inputs(q, DEVICE))
        check(got == want, f"the timing tool's {q} inputs differ from the "
              f"main path's: {got} != {want}")
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
        rows[q] = {"name": "segment_moments", "route": "cuda",
                   "source": "greptimedb_tpu_torch/csrc/segment_moments.cu",
                   "replaces": "greptimedb_tpu/ops/kernels.py:730",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return rows["Q1"]


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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

    log("== phase 1: machine")
    phase_machine(torch)
    log("== phase 2: build")
    phase_kernel_build()
    log("== phase 3 + 4: kernel checks, then PromQL on TSBS cpu-only")
    from greptimedb_tpu_torch.ops import pallas_window as pw
    k1 = K1Timer(torch, pw.counts_leq_grid)
    kern = phase_promql(torch, args.seed, k1)
    log("== phase 5: segment_moments against its plain version")
    phase_moments_check()
    log("== phase 6: SQL on TSBS cpu-only, then segment_moments at the "
        "main path's shapes")
    launches, inputs = phase_sql(torch, args.seed)
    k2 = phase_moments_time(torch, inputs)
    k2["launches"] = launches

    new = set(sys.modules) - before
    bad = sorted(m for m in new if m.split(".")[0] in
                 ("jax", "jaxlib", "greptimedb_tpu"))
    check(not bad, f"the port imported {bad[:5]}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    # the kernels the main paths launched; the bucket entry, which is off
    # them, gets a line of its own
    print(json.dumps({"entries_off_main_path": [kern[1]]}), flush=True)
    print(json.dumps({"kernels": [kern[0], k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
