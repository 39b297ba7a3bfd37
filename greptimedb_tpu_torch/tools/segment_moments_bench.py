"""Kernel-only A/B timing of csrc/segment_moments.cu sources, on one GPU.

    python3 -m greptimedb_tpu_torch.tools.segment_moments_bench \\
        [--source a.cu --source b.cu ...]

Builds each source (default: the committed one) with nvcc and
`cuda_build.NVCC_FLAGS`, all at once, into `csrc/build/`, and prints
ptxas's registers and spills for each. Every source must keep the C
interface of the committed one; each is run through the port's own
wrapper (`ops/kernels.py:segment_moments`), which merges identical
moments and chunks them into launches. To time a design choice, pass a
copy of the committed source changed in that one place beside it.

For each source it holds the kernel against `segment_moments_plain` at
the design's edge cases (`edge_cases`, which `chip_smoke.py`'s phase 5
also runs) and at the SQL main path's Q1, Q4 and Q6 inputs, with two
launches bit-equal. Then it times every source at Q1, Q4 and Q6 in turns
(5 rounds; each time CUDA events around 20 back-to-back calls queued
behind a spin kernel, so that the wrapper's host time, which exceeds the
kernel's at Q4, stays out), with the byte bound (`moments_bound`) and
`torch.segment_reduce`'s time (`library_moments`); `chip_smoke.py` takes
both from here, so one formula gives every bound. The card's name and
power limit come first.

The Q1/Q4/Q6 inputs are made on the card from a fixed seed
(`main_path_inputs`) to match what `chip_smoke.py`'s phase 6 hands the
kernel through QueryEngine over TSBS cpu-only (4000 hosts x 12 h,
17.28 M rows sorted by (series, ts), ts rebased to 10 s steps): the same
row count, run ends, live rows and runs, value types, column masks,
moment list, and which arguments share storage. `chip_smoke.py` asserts
this (`signature`) on every run. The values are uniform in [0, 100), not
TSBS's clamped random walks: no code path of the kernel depends on them.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import kernels as K

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
#: H100 SXM peak outside the tensor cores (float32; the table gives no
#: separate int32 rate), for the kernel's integer compare-adds
SCALAR_OPS_PER_S = 67e12
U32 = 2.0 ** -24                   # float32 unit roundoff
U64 = 2.0 ** -53                   # float64 unit roundoff
#: the kernel's row tile and one-run-per-lane limit (kTile, kShort in
#: csrc/segment_moments.cu), which the edge cases straddle
KTILE = 4096
KSHORT = 32

HOSTS = 4000                       # TSBS --scale
HOURS = 12                         # TSBS double-groupby span
PER_HOUR = 360                     # 10 s samples per host and hour
QUERIES = ("Q1", "Q4", "Q6")
#: the spin kernel ahead of timed calls (~30 ms at 1980 MHz)
SPIN_CYCLES = 60_000_000
MOMENT_CASE_OPS = ("count", "sum", "sum_sq", "min", "max", "first", "last")

Args = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list, list, list]


# ---------------------------------------------------------------------------
# the main path's inputs
# ---------------------------------------------------------------------------

def main_path_inputs(q: str, device="cuda", hosts: int = HOSTS,
                     hours: int = HOURS, seed: int = 0) -> Args:
    """(ends, mask, ts, values, col_masks, ops) as the SQL path hands them
    to `sorted_grouped_aggregate` for Q1 (avg of ten fields by host and
    hour), Q4 (max of five fields by host and minute over 8 hosts and the
    first hour) or Q6 (max, avg, first_value and last_value over every
    row). Rows are host-major, 360 samples per hour."""
    per_host = hours * PER_HOUR
    n = hosts * per_host
    gen = torch.Generator(device=device).manual_seed(seed)
    ts = (torch.arange(per_host, dtype=torch.int32, device=device)
          * 10_000).repeat(hosts)
    # every field is non-null: one all-valid mask serves as each column's
    valid = torch.ones(n, dtype=torch.bool, device=device)

    def field():
        return torch.rand(n, generator=gen, device=device) * 100.0

    def run_ends(length):
        return torch.arange(1, n // length + 1, dtype=torch.int32,
                            device=device) * length

    if q == "Q1":
        fs = [field() for _ in range(10)]
        vals = [f for f in fs for _ in range(2)]
        return (run_ends(PER_HOUR), torch.ones_like(valid), ts, vals,
                [valid] * 20, ["sum", "count"] * 10)
    if q == "Q4":
        fs = [field() for _ in range(5)]
        mask = torch.zeros_like(valid)
        rng = np.random.default_rng(seed)
        for h in rng.choice(hosts, min(8, hosts), replace=False):
            mask[int(h) * per_host:int(h) * per_host + PER_HOUR] = True
        vals = [f for f in fs for _ in range(2)]
        return (run_ends(6), mask, ts, vals, [valid] * 10,
                ["max", "count"] * 5)
    if q == "Q6":
        user, system, idle = field(), field(), field()
        ends = torch.tensor([n], dtype=torch.int32, device=device)
        # first_value / last_value bring the min / max of ts ahead of them
        return (ends, valid, ts, [user, user, system, system, ts, idle, ts,
                                  idle], [valid] * 8,
                ["max", "count", "sum", "count", "min", "first", "max",
                 "last"])
    raise ValueError(f"unknown query {q!r}")


def signature(args: Args) -> dict:
    """What the kernel's work depends on: rows, run lengths, live rows and
    runs, value types, the moment list, whether each column mask is all
    set, and which arguments share storage."""
    ends, mask, ts, vals, cms, ops = args
    e = ends.long()
    lens = torch.diff(e, prepend=e.new_zeros(1))
    ulen, ucnt = torch.unique(lens, return_counts=True)
    csum = torch.cat([e.new_zeros(1), mask.long().cumsum(0)])
    live_per_run = csum[e] - csum[torch.cat([e.new_zeros(1), e[:-1]])]
    labels: dict = {}
    tensors = [mask, ts] + list(vals) + [c for c in cms if c is not None]
    return {
        "rows": int(mask.shape[0]), "runs": int(ends.shape[0]),
        "run_lengths": dict(zip(ulen.tolist(), ucnt.tolist())),
        "live_rows": int(mask.sum()),
        "live_runs": int((live_per_run > 0).sum()),
        "value_types": [str(v.dtype) for v in vals], "ops": list(ops),
        "column_masks_all_set": [None if c is None else bool(c.all())
                                 for c in cms],
        "storage": [labels.setdefault(t.data_ptr(), len(labels))
                    for t in tensors]}


def moments_bound(args: Args):
    """Bytes the function must move: the row mask and the run ends read
    once; each distinct output written once, with moments merged as the
    wrapper merges them (op, value column unless a count, column mask),
    plus the row counts; at the rows this run's row mask lets through
    (a masked-out row needs none of them), each distinct column mask,
    each value column that a sum, sum_sq, min or max reads, and ts for
    first/last, read once; and first/last's value at the chosen row of
    each run. Against one operation per row and output. Returns (ms,
    "bytes" or "operations", bytes)."""
    ends, mask, ts, vals, cms, ops = args
    G = ends.shape[0]
    live = float(mask.float().mean()) if mask.numel() else 0.0
    full = {ends.data_ptr(): ends.numel() * ends.element_size(),
            mask.data_ptr(): mask.numel() * mask.element_size()}
    part, outs, gathers = {}, set(), 0
    for op, v, cm in zip(ops, vals, cms):
        key = (op, None if op == "count" else (v.data_ptr(), v.dtype),
               None if cm is None else cm.data_ptr())
        if key in outs:
            continue
        outs.add(key)
        cols = [] if cm is None else [cm]
        if op in ("first", "last"):
            cols.append(ts)
            gathers += G * v.element_size()
        elif op != "count":
            cols.append(v)
        for t in cols:
            if t.data_ptr() not in full:
                part[t.data_ptr()] = t.numel() * t.element_size()
    nout = len(outs) + 1
    nbytes = sum(full.values()) + live * sum(part.values()) + gathers + \
        nout * G * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = mask.shape[0] * nout / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations", nbytes


def library_moments(args: Args) -> Tuple[Callable[[], None], int]:
    """torch.segment_reduce, one call per moment over the run lengths
    with masked rows filled beforehand (the fill is not timed); no
    library call computes first/last, which are left out. Returns the
    callable that runs them all and the number of calls."""
    ends, mask, ts, vals, cms, ops = args
    lens = torch.diff(ends.long(), prepend=ends.new_zeros(1).long())
    calls = []
    for op, v, cm in zip(list(ops) + ["count"], list(vals) + [vals[0]],
                         list(cms) + [None]):
        m = mask if cm is None else mask & cm
        if op == "count":
            data, red = m.float(), "sum"
        elif op in ("sum", "sum_sq"):
            x = v.float()
            data, red = torch.where(m, x * x if op == "sum_sq" else x,
                                    0.0), "sum"
        elif op in ("min", "max"):
            fill = float("inf") if op == "min" else float("-inf")
            data, red = torch.where(m, v.float(), fill), op
        else:
            continue
        calls.append((data, red))

    def run():
        for data, red in calls:
            torch.segment_reduce(data, red, lengths=lens, unsafe=True)
    return run, len(calls)


# ---------------------------------------------------------------------------
# edge cases of the design
# ---------------------------------------------------------------------------

def _on(a: np.ndarray, device, offset: bool) -> torch.Tensor:
    """a on the device; with `offset`, a view 4 bytes past the start of
    its allocation (so not 16-byte aligned)."""
    t = torch.as_tensor(a, device=device)
    if not offset:
        return t
    pad = 4 // t.element_size()
    buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=device)
    buf[pad:] = t
    return buf[pad:]


def moments_case(lens, seed, device="cuda", all_masked=False, ts_range=None,
                 offset=False, dead_tiles=()) -> Args:
    """Inputs of one segment_moments check: runs of the given lengths, 15 %
    of rows masked (every row of `dead_tiles`' KTILE-row tiles), 10 %
    column nulls on the float column, unsorted ts (with ties when
    ts_range is small), the seven ops over a float32 column and again over
    an int32 column (sums that wrap); with `offset`, the row mask, ts,
    value columns and column mask are views 4 bytes into their
    allocations."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, dtype=np.int64)
    n = int(lens.sum())
    ends = np.cumsum(lens).astype(np.int32)
    mask = rng.random(n) > 0.15
    if all_masked:
        mask[:] = False
    for t in dead_tiles:
        mask[t * KTILE:(t + 1) * KTILE] = False
    ts = rng.integers(0, ts_range or max(n, 1), n).astype(np.int32)
    x = (rng.normal(size=n) * 50).astype(np.float32)
    xi = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    cm = rng.random(n) > 0.1
    x_d, xi_d, cm_d = (_on(a, device, offset) for a in (x, xi, cm))
    return (torch.as_tensor(ends, device=device), _on(mask, device, offset),
            _on(ts, device, offset), [x_d] * 7 + [xi_d] * 7,
            [cm_d] * 7 + [None] * 7, list(MOMENT_CASE_OPS) * 2)


def many_moments_case(n, nmom, seed, device="cuda") -> Args:
    """nmom moments that no merge can join (each over its own column and
    column mask, float32 and int32 in turn, ops in turn) over 300 runs of
    n rows; nmom = 0 leaves the row counts alone."""
    rng = np.random.default_rng(seed)
    lens = rng.multinomial(n, [1 / 300] * 300)
    ends = np.cumsum(lens).astype(np.int32)
    mask = rng.random(n) > 0.15
    ts = rng.integers(0, n, n).astype(np.int32)
    vals, cms = [], []
    for i in range(nmom):
        if i % 2:
            v = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
        else:
            v = (rng.normal(size=n) * 50).astype(np.float32)
        vals.append(torch.as_tensor(v, device=device))
        cms.append(torch.as_tensor(rng.random(n) > 0.1, device=device))
    ops = [MOMENT_CASE_OPS[i % len(MOMENT_CASE_OPS)] for i in range(nmom)]
    return (torch.as_tensor(ends, device=device),
            torch.as_tensor(mask, device=device),
            torch.as_tensor(ts, device=device), vals, cms, ops)


def edge_cases() -> List[Tuple[str, Callable[..., Args]]]:
    """(name, build(device)) for every check at the edges of the design:
    the reference's test shapes (tests/test_kernels.py), run lengths at
    and around the tile and one-run-per-lane limits, masks, alignment,
    moment counts, and the extremes of run length."""
    rng = np.random.default_rng(77)
    t = KTILE
    cases = [
        ("50 000 rows in 97 groups, uniform",
         rng.multinomial(50_000, [1 / 97] * 97), {}),
        ("50 000 rows in 97 groups, zipf-skewed",
         np.bincount(rng.zipf(1.5, 50_000) % 97, minlength=97), {}),
        ("120 000 rows in 9000 groups, one fat run, ts ties",
         np.bincount(np.concatenate([rng.integers(0, 9000, 115_000),
                                     np.full(5000, 1234)]), minlength=9000),
         {"ts_range": 50}),
        ("runs at block edges, empty and single-row runs",
         [1023, 1, 1024, 0, 2046, 3, 0, 2053, 1, 32, 33, 4096, 0, 1], {}),
        ("unsorted ts with ties inside runs (5 runs of 1000)", [1000] * 5,
         {"ts_range": 50}),
        ("all rows masked", [100] * 500, {"all_masked": True}),
        ("one run of every row (5 M rows)", [5_000_000], {}),
        ("2.88 M runs of 6 rows", [6] * 2_880_000, {}),
        ("columns and masks 4 bytes into their allocations (not 16-byte "
         "aligned)", [5, 1000, 37, 4100, 3, 9000, 33, 2000, 0, 7, 12_345],
         {"offset": True}),
        ("dead tiles beside live ones, runs crossing between them",
         [3000] * 5 + [20_000] + [3000] * 5 + [1, 0, 4095],
         {"dead_tiles": (1, 2, 5, 6, 7, 11)}),
        (f"runs ending on {t}-row tile edges, runs of {KSHORT + 1} rows",
         [t, t, KSHORT + 1, t - KSHORT - 1, 2 * t, KSHORT + 1, KSHORT + 1,
          t - 2 * KSHORT - 2, KSHORT + 1, t - KSHORT - 1, 3 * t, 0, KSHORT,
          KSHORT + 1], {}),
    ]
    out = [(name, lambda device, i=i, lens=lens, kw=kw:
            moments_case(lens, i, device, **kw))
           for i, (name, lens, kw) in enumerate(cases)]
    out += [(f"{k} distinct column masks ({k + 1} mask tiles in shared "
             f"memory)", lambda device, k=k: many_moments_case(
                 60_000, k, 93 + k, device)) for k in (10, 11)]
    out += [("33 moments (two launches)",
             lambda device: many_moments_case(60_000, 33, 101, device)),
            ("0 moments (row counts only)",
             lambda device: many_moments_case(60_000, 0, 102, device))]
    return out


def moments_agree(name: str, args: Args, quiet: bool = False) -> float:
    """The kernel (the wrapper, on the arguments' device) against its
    plain version on the same inputs: counts, min, max, first and last
    (and int32 sums) exactly; float sums within 2 u |plain| + 2 n u64
    sum|x| (both accumulate each run in float64 in another order, then
    round once to float32). Then a second launch: the bits must be
    equal. Returns the largest |kernel - plain|."""
    ends, mask, ts, vals, cms, ops = args
    got, gc = K.segment_moments(*args)
    again, gc2 = K.segment_moments(*args)
    want, wc = K.segment_moments_plain(*args)
    if mask.is_cuda:
        torch.cuda.synchronize()

    def check(cond, msg):
        if not cond:
            raise AssertionError(f"{name}: {msg}")

    check(torch.equal(gc, wc), "row counts differ from plain")
    check(torch.equal(gc, gc2), "row counts differ run to run")
    n = mask.shape[0]
    err = 0.0
    for i, (op, g, g2, w) in enumerate(zip(ops, got, again, want)):
        check(torch.equal(g.view(torch.int32), g2.view(torch.int32)),
              f"{op}[{i}] bits differ between two launches")
        if op in ("sum", "sum_sq") and g.dtype == torch.float32:
            x = vals[i].double().abs()
            if op == "sum_sq":
                x = x * x
            (absum,), _ = K.segment_moments_plain(
                ends, mask, ts, [x.float()], [cms[i]], ["sum"],
                with_counts=False)
            d = (g.double() - w.double()).abs()
            tol = 2 * U32 * w.double().abs() + 2 * n * U64 * absum.double()
            check(bool((d <= tol).all()), f"{op}[{i}] outside the bound "
                  f"(max |err| {d.max().item():.3g})")
            err = max(err, d.max().item() if d.numel() else 0.0)
        else:
            check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
                  f"{op}[{i}] kernel != plain")
    if not quiet:
        print(f"  {name}: kernel == plain (sums within the bound, max |err| "
              f"{err:.3g}); two launches bit-equal", flush=True)
    return err


# ---------------------------------------------------------------------------
# build, check, time
# ---------------------------------------------------------------------------

def _build_all(sources: List[str], name: str = "segment_moments"
               ) -> List[ctypes.CDLL]:
    """nvcc for every source at once; the loaded libraries in order."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        so = os.path.join(cuda_build.BUILD_DIR, f"lib{name}_bench_{i}.so")
        procs.append((src, so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for i, (src, so, proc) in enumerate(procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        print(f"source {i}: {src}", flush=True)
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line
                                         or "Compiling" in line):
                print(f"    {line.strip()}", flush=True)
        libs.append(ctypes.CDLL(so))
    return libs


@contextlib.contextmanager
def _kernel_from(lib: ctypes.CDLL, name: str = "segment_moments"):
    """The port's wrapper launching `lib` in place of the committed
    source's library."""
    saved = cuda_build._libs.get(name)
    cuda_build._libs[name] = lib
    try:
        yield
    finally:
        if saved is None:
            cuda_build._libs.pop(name, None)
        else:
            cuda_build._libs[name] = saved


def fenced_ms(fn, launches: int = 20) -> float:
    """Device ms of one call of fn (which must not synchronise): CUDA
    events around `launches` back-to-back calls queued behind a spin
    kernel, so the card runs them back to back only after the host has
    queued them all, and the wrapper's host time stays out even where it
    exceeds the kernel's. Raises if queueing outlasted the spin."""
    fn()
    torch.cuda.synchronize()
    e_spin, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e_spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(launches):
        fn()
    e1.record()
    host_ms = (time.perf_counter() - h0) * 1e3
    e1.synchronize()
    spin_ms = e_spin.elapsed_time(e0)
    if host_ms >= spin_ms:
        raise RuntimeError(f"queueing {launches} calls took {host_ms:.2f} "
                           f"ms, longer than the {spin_ms:.2f} ms spin")
    return e0.elapsed_time(e1) / launches


def median_fenced_ms(fn, launches: int = 20, runs: int = 5) -> float:
    return statistics.median(fenced_ms(fn, launches) for _ in range(runs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a segment_moments.cu to time (repeatable; "
                         "default: the committed source)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segment_moments_bench: CUDA is not available")
    committed = os.path.join(cuda_build.CSRC_DIR, "segment_moments.cu")
    sources = opts.source or [committed]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = _build_all(sources)

    cases = edge_cases()
    for i, lib in enumerate(libs):
        with _kernel_from(lib):
            for name, build in cases:
                moments_agree(name, build("cuda"), quiet=True)
        print(f"source {i}: kernel == plain at {len(cases)} edge cases, two "
              f"launches bit-equal", flush=True)

    results = {}
    for q in QUERIES:
        args = main_path_inputs(q)
        for i, lib in enumerate(libs):
            with _kernel_from(lib):
                moments_agree(f"source {i} at {q}", args, quiet=True)
        b_ms, b_by, nbytes = moments_bound(args)
        lib_fn, nlib = library_moments(args)
        lib_ms = median_fenced_ms(lib_fn, launches=5, runs=3)
        times = [[] for _ in libs]
        for _ in range(5):
            for i, lib in enumerate(libs):
                with _kernel_from(lib):
                    times[i].append(fenced_ms(
                        lambda: K.segment_moments(*args)))
        sig = signature(args)
        print(f"{q}: {sig['rows']} rows, {sig['runs']} runs, "
              f"{sig['live_rows']} live rows, {len(args[5])} moments; "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB); "
              f"torch.segment_reduce x {nlib} {lib_ms:.4f} ms; each source "
              f"== plain, two launches bit-equal", flush=True)
        results[q] = {"bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms, "sources": {}}
        for i, ms in enumerate(times):
            med = statistics.median(ms)
            print(f"  source {i}: median {med:.4f} ms ({b_ms / med * 100:.1f}"
                  f"% of the bound; rounds "
                  f"{' / '.join(f'{m:.4f}' for m in ms)})", flush=True)
            results[q]["sources"][sources[i]] = {
                "ms": med, "rounds": ms}
        del args
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
