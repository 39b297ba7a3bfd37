"""Kernel-only A/B timing of csrc/grouped_moments.cu sources, on one GPU.

    python3 -m greptimedb_tpu_torch.tools.grouped_moments_bench \\
        [--source a.cu --source b.cu ...] [--profile]

Builds each source (default: the committed one) with nvcc and
`cuda_build.NVCC_FLAGS`, all at once, into `csrc/build/`, and prints
ptxas's registers and spills for each. Each source runs through the
port's own wrapper (`ops/kernels.py:grouped_moments`: moment merging,
chunks of 32 moments, the C entry's scratch size), so a source must
keep the committed C interface.

For each source it holds the kernel against `grouped_moments_plain` at
the design's edge cases (`edge_cases`, which `chip_smoke.py`'s phase 19
also runs: both sides of the small path's threshold, Gp and Gp + 1
groups, partitions of one and of many work items, empty partitions,
partitions counted in windows, skew, ids outside the groups, column
masks, NaN, ties, 33 moments, no rows, 19a's rows sorted by group and in
random order, in several row chunks). Then it times every source at the
main path's inputs (`main_path_inputs`: 17.28 M rows, 48 000 groups, the
17 moments of chip_smoke.py's 19a) in TSBS's time-major order, in a
random order and sorted by group, in turns (5 rounds; each CUDA events
around 20 calls queued behind a spin kernel), with the device memory one
call allocates beyond its inputs (outputs and scratch), the byte bound
(`grouped_bound`) and 18 `index_add_` / `scatter_reduce_` calls
(`grouped_library`); `chip_smoke.py` takes both from here, so one
formula gives every bound. With --profile it also prints each kernel's
device time per call (`torch.profiler`, CUDA activity, 5 calls) for
every source and order. The card's name and power limit come first; the
last line is JSON.

The inputs are made on the card from a fixed seed: TSBS cpu-only's
4000 hosts x 12 h at 10 s, group id host x 12 + hour, about 10 % of rows
masked, ten float32 fields uniform in [0, 100) (not TSBS's random walks:
no code path of the kernel depends on the values). chip_smoke.py's 19a
hands the kernel the same rows, groups, moments and storage sharing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import kernels as K
from . import segment_moments_bench as smb

HOSTS = 4000                       # TSBS --scale
HOURS = 12                         # double-groupby's span
PER_HOUR = 360                     # 10 s samples per host and hour
FIELDS = 10                        # cpu-only's usage_* fields
MASKED = 0.1
#: Q1's avg of the ten fields, then max, min, stddev, first and last of
#: usage_user (chip_smoke.py's GROUPED_OPS)
GROUPED_OPS = ("avg",) * FIELDS + ("max", "min", "stddev", "first", "last")
ORDERS = ("time-major", "random", "sorted")
EXACT = ("count", "min", "max", "first", "last", "first_key", "last_key")
U32, U64 = smb.U32, smb.U64

Args = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, list, list, list]


# ---------------------------------------------------------------------------
# the main path's inputs
# ---------------------------------------------------------------------------

def reorder(args: Args, order: str, seed: int = 0) -> Args:
    """The same rows in another order: "time-major" (as given), "random"
    (a permutation from `seed`) or "sorted" (by group id, stable: each
    group's rows together, in their order). Each distinct tensor moves
    once, so arguments that shared storage still do."""
    if order == "time-major":
        return args
    gids, mask, ts, vals, cms, ops = args
    if order == "random":
        gen = torch.Generator(device=gids.device).manual_seed(seed + 7)
        perm = torch.randperm(gids.shape[0], generator=gen,
                              device=gids.device)
    elif order == "sorted":
        perm = torch.sort(gids, stable=True).indices
    else:
        raise ValueError(f"unknown order {order!r}")
    moved = {}

    def move(t):
        if t is None:
            return None
        if t.data_ptr() not in moved:
            moved[t.data_ptr()] = t[perm].contiguous()
        return moved[t.data_ptr()]

    return (move(gids), move(mask), move(ts), [move(v) for v in vals],
            [move(c) for c in cms], list(ops))


def main_path_inputs(order: str = "time-major", device="cuda",
                     hosts: int = HOSTS, hours: int = HOURS,
                     seed: int = 0) -> Tuple[Args, int]:
    """(grouped_moments' arguments, G) as `grouped_aggregate` hands them
    to the kernel for chip_smoke.py's 19a, rows in `order`."""
    ticks = hours * PER_HOUR
    n = ticks * hosts
    gen = torch.Generator(device=device).manual_seed(seed)
    tick = torch.arange(ticks, device=device).repeat_interleave(hosts)
    host = torch.arange(hosts, device=device).repeat(ticks)
    gids = (host * hours + tick // PER_HOUR).to(torch.int32)
    ts = (tick * 10_000).to(torch.int32)
    mask = torch.rand(n, generator=gen, device=device) >= MASKED
    fields = [torch.rand(n, generator=gen, device=device) * 100.0
              for _ in range(FIELDS)]
    del tick, host
    G = hosts * hours
    args, _ = K.grouped_aggregate_plan(
        gids, mask, ts, fields + [fields[0]] * 5, num_groups=G,
        ops=GROUPED_OPS, device=device)
    return reorder(args, order, seed), G


def grouped_bound(args: Args, G: int):
    """Bytes the function must move: the row mask read once; at the rows
    it lets through, the group ids, each distinct column mask, each value
    column a sum, sum_sq, min or max reads and ts for first/last, read
    once; each distinct output and the row counts written once, and
    first/last's value at the chosen row of each group. Against one
    operation per row and moment. Returns (ms, "bytes" or "operations",
    bytes)."""
    gids, mask, ts, vals, cms, ops = args
    n = mask.shape[0]
    live = float(mask.float().mean()) if n else 0.0
    part, gathers = {gids.data_ptr(): 4 * n}, 0
    outs = G * 4
    for op, v, cm in zip(ops, vals, cms):
        cols = [] if cm is None else [cm]
        if op in ("first", "last", "first_key", "last_key"):
            cols.append(ts)
            gathers += G * v.element_size() if op in ("first", "last") else 0
            outs += G * (8 if op.endswith("_key") else v.element_size())
        else:
            if op != "count":
                cols.append(v)
            outs += G * 4
        for t in cols:
            part[t.data_ptr()] = t.numel() * t.element_size()
    nbytes = n + live * sum(part.values()) + outs + gathers
    bytes_ms = nbytes / smb.HBM_BYTES_PER_S * 1e3
    ops_ms = n * max(len(ops), 1) / smb.SCALAR_OPS_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes


def grouped_library(args: Args, G: int) -> Tuple[Callable[[], None], int]:
    """One torch call per moment, as the yardstick: index_add_ for counts
    and sums, scatter_reduce_ (amin / amax) for min, max and the packed
    first/last keys, each over its masked input made beforehand (not
    timed). Returns the callable and the number of calls."""
    gids, mask, ts, vals, cms, ops = args
    live = mask & (gids >= 0) & (gids < G)
    idx = torch.where(live, gids, 0).long()
    row = torch.arange(mask.shape[0], device=mask.device)
    calls = []
    for op, v, cm in zip(list(ops) + ["count"], list(vals) + [vals[0]],
                         list(cms) + [None]):
        m = live if cm is None else live & cm
        if op == "count":
            calls.append((torch.float32, "add", m.float(), 0.0))
        elif op in ("sum", "sum_sq"):
            x = v.float()
            calls.append((torch.float32, "add",
                          torch.where(m, x * x if op == "sum_sq" else x, 0.0),
                          0.0))
        elif op in ("min", "max"):
            fill = float("inf") if op == "min" else float("-inf")
            calls.append((torch.float32, "a" + op,
                          torch.where(m, v.float(), fill), fill))
        else:
            key = K._packed_keys(op, ts, row)
            big = torch.iinfo(torch.int64).max
            calls.append((torch.int64, "amin", torch.where(m, key, big), big))

    def run():
        for dt, red, data, fill in calls:
            out = torch.full((G,), fill, dtype=dt, device=mask.device)
            if red == "add":
                out.index_add_(0, idx, data)
            else:
                out.scatter_reduce_(0, idx, data, red, include_self=True)
    return run, len(calls)


# ---------------------------------------------------------------------------
# edge cases of the design
# ---------------------------------------------------------------------------

def thresholds() -> Tuple[int, int]:
    """(the most groups the small path takes, the most a partition takes)
    for nine moment ops over one float32 column, from the C entry."""
    lib = K._grouped_lib()
    k = len(K.GROUPED_OPS)
    ops, ints = (ctypes.c_int * k)(*range(k)), (ctypes.c_int * k)()
    return (lib.grouped_moments_smem_groups(k, ops, ints),
            lib.grouped_moments_partition_groups(k, ops, ints))


def edge_cases(seed: int = 0
               ) -> List[Tuple[str, Callable[..., Tuple[Args, int]]]]:
    """(name, build(device) -> (args, G)) at the edges of the design and
    of the semantics. Every case but "33 moments", "int32 column" and
    19a's puts all nine moment ops over one float32 column (the row
    counts, a count, sum, sum_sq, min, max, first, last and both keys):
    the small path takes up to `small` groups, a partition `gp`
    (`thresholds`)."""
    every = list(K.GROUPED_OPS)
    small, gp = thresholds()

    def case(i, n, G, ops=every, gid_lo=0, gid_hi=None, masked=0.1,
             ties=False, nan=False, ints=False, cmasks=0, hot=None):
        def build(device):
            rng = np.random.default_rng(seed + 190 + i)
            hi = G if gid_hi is None else gid_hi
            gids = rng.integers(gid_lo, max(hi, gid_lo + 1), n)
            if hot is not None:   # one group takes this share of rows
                gids[rng.random(n) < hot] = G // 3
            mask = rng.random(n) >= masked
            ts = rng.integers(0, 4 if ties else 1 << 30, n)
            if ints:
                x = rng.integers(2**30, 2**31 - 1, n).astype(np.int32)
            else:
                x = rng.normal(size=n).astype(np.float32) * 100
                if nan:
                    x[rng.random(n) < 0.02] = np.nan
            masks = [rng.random(n) >= 0.3 for _ in range(cmasks)]

            def t(a, dt):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       device=device).to(dt)
            xv = t(x, torch.int32 if ints else torch.float32)
            cm = [t(m, torch.bool) for m in masks]
            return (t(gids, torch.int32), t(mask, torch.bool),
                    t(ts, torch.int32), [xv] * len(ops),
                    [cm[j % len(cm)] if cm and j % 3 else None
                     for j in range(len(ops))], list(ops)), G
        return build

    cases = [
        ("all rows masked", case(0, 5000, 100, masked=1.0)),
        ("empty groups", case(1, 20_000, 1000, gid_hi=500)),
        ("int32 column (sums wrap)", case(
            2, 20_000, 64,
            ops=["count", "sum", "sum_sq", "min", "max", "first", "last"],
            ints=True)),
        ("column masks", case(3, 30_000, 77, cmasks=3)),
        ("NaN values, ts ties", case(4, 30_000, 50, nan=True, ties=True)),
        ("ids outside [0, G)", case(5, 10_000, 40, gid_lo=-3, gid_hi=43)),
        (f"{small} groups (the small path's threshold)",
         case(6, 200_000, small)),
        (f"{small + 1} groups (partitions)", case(7, 200_000, small + 1)),
        (f"{gp} groups (one partition of many work items)",
         case(8, 200_000, gp)),
        (f"{gp + 1} groups (a second partition of one group)",
         case(9, 200_000, gp + 1)),
        ("one group, 2 M rows", case(10, 2_000_000, 1)),
        ("48 000 groups", case(11, 1_000_000, 48_000)),
        ("48 000 groups, 100 000 rows (one work item a partition)",
         case(12, 100_000, 48_000)),
        ("one group takes 90 % of 2 M rows among 48 000", case(
            13, 2_000_000, 48_000, hot=0.9)),
        ("40 000 groups, rows in the first 2000 (empty partitions)", case(
            18, 200_000, 40_000, gid_hi=2000)),
        (f"7 500 000 groups ({-(-7_500_000 // gp)} partitions: passes 1-2 "
         f"count them in windows, pass 3 gathers)",
         case(19, 1_000_000, 7_500_000)),
        ("NaN values, ts ties, column masks, partitions", case(
            14, 300_000, 6000, nan=True, ties=True, cmasks=2)),
        ("33 moments (two launches)", case(
            15, 50_000, 300, ops=(every * 4)[:33], cmasks=2)),
        ("no rows", case(16, 0, 10)),
        ("no rows, partition-sized groups", case(17, 0, 48_000)),
        ("19a's rows sorted by group (series-major)", lambda device:
         _reordered("sorted", device, seed)),
        ("19a's rows in random order", lambda device:
         _reordered("random", device, seed)),
        ("19a's rows in random order, NaN values, ts ties within each "
         "group, column masks, 32 moments (copies in two chunks)",
         lambda device: _chunked_nan_ties(device, seed)),
    ]
    return cases


def _reordered(order, device, seed):
    args, G = main_path_inputs("time-major", device, seed=seed)
    return reorder(args, order, seed), G


def _chunked_nan_ties(device, seed):
    """19a's rows in random order, each of the ten fields with 2 % NaN:
    sum, min and max of every field, first and last of the first (32
    moments, one launch), ts cut to the hour (all of a group's rows tie)
    and two column masks: 54 bytes a row to copy, so the kernel copies
    the rows in two chunks."""
    (gids, mask, ts, vals, _, _), G = _reordered("random", device, seed)
    n = gids.shape[0]
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    distinct = {}
    for v in vals:      # the ten fields first, then the shifted column
        distinct.setdefault(v.data_ptr(), v)
    fields = [torch.where(torch.rand(n, generator=gen, device=device)
                          < 0.02, float("nan"), v)
              for v in list(distinct.values())[:FIELDS]]
    cm = [torch.rand(n, generator=gen, device=device) >= 0.3
          for _ in range(2)]
    ops = [op for _ in fields for op in ("sum", "min", "max")] + \
        ["first", "last"]
    xs = [f for f in fields for _ in range(3)] + [fields[0]] * 2
    return (gids, mask, torch.div(ts, 3_600_000, rounding_mode="floor"),
            xs, [cm[j % 2] if j % 3 else None for j in range(len(ops))],
            ops), G


def agree(name: str, args: Args, G: int, quiet: bool = False) -> float:
    """The kernel against its plain version on the same inputs: counts,
    min, max, first, last and the keys exact (NaN where NaN); int32 sums
    exact; float sums within 1 ulp of float32 plus 8 eps64 times the sum
    of |x| (both accumulate in float64 and round once, in different
    orders). Two launches agree the same way. Returns the max |difference|
    of the float sums; raises AssertionError on a disagreement."""
    got, cnt = K.grouped_moments(*args, num_groups=G)
    again, cnt2 = K.grouped_moments(*args, num_groups=G)
    want, want_cnt = K.grouped_moments_plain(*args, num_groups=G)
    gids, mask, ts, vals, cms, ops = args
    mags, _ = K.grouped_moments_plain(
        gids, mask, ts, [v.abs() if v.dtype.is_floating_point else v
                         for v in vals], cms,
        ["sum_sq" if op == "sum_sq" else "sum" for op in ops],
        num_groups=G, with_counts=False)
    if mask.is_cuda:
        torch.cuda.synchronize()

    def check(cond, msg):
        if not cond:
            raise AssertionError(f"grouped_moments {name}: {msg}")

    check(torch.equal(cnt, want_cnt) and torch.equal(cnt2, want_cnt),
          "row counts differ")
    err = 0.0
    for i, op in enumerate(ops):
        for label, g in (("kernel", got[i]), ("second launch", again[i])):
            w = want[i]
            check(g.dtype == w.dtype and g.shape == w.shape,
                  f"{op}: {g.dtype} {tuple(g.shape)} != {w.dtype} "
                  f"{tuple(w.shape)}")
            if op in EXACT or not w.dtype.is_floating_point:
                same = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
                    if w.dtype.is_floating_point else g == w
                check(bool(same.all()), f"{op}: {label} != plain at "
                      f"{int((~same).sum())} groups")
                continue
            both_nan = torch.isnan(g) & torch.isnan(w)
            diff = torch.where(both_nan, 0.0, (g.double() - w.double()).abs())
            lim = U32 * w.double().abs() + 8 * U64 * mags[i].double()
            check(bool((both_nan | (diff <= lim)).all()),
                  f"{op}: {label} off the plain version by "
                  f"{float(diff.max())}")
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
    if not quiet:
        print(f"  {name}: kernel == plain ({len(ops)} moments, {G} groups),"
              f" two launches agree, max |err| {err:.3g}", flush=True)
    return err


# ---------------------------------------------------------------------------
# build, check, time
# ---------------------------------------------------------------------------

def call_bytes(args: Args, G: int) -> int:
    """Device memory one grouped_moments call allocates beyond its inputs
    (its outputs and scratch), measured at the allocator's peak."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = K.grouped_moments(*args, num_groups=G)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - before


def profile_ms(fn, calls: int = 5) -> dict:
    """Each kernel's device ms per call of `fn` under torch.profiler (CUDA
    activity), by kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or \
            getattr(e, "cuda_time_total", 0)
        if t:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            per[name] = per.get(name, 0.0) + t / calls / 1e3
    return dict(sorted(per.items(), key=lambda kv: -kv[1]))


def _kernel_from(lib: ctypes.CDLL):
    """The port's wrapper launching `lib` in place of the committed
    source's library."""
    return smb._kernel_from(lib, "grouped_moments")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=None,
                    help="a grouped_moments.cu to time (repeatable; "
                         "default: the committed source)")
    ap.add_argument("--profile", action="store_true",
                    help="also print each kernel's device time per call")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grouped_moments_bench: CUDA is not available")
    committed = os.path.join(cuda_build.CSRC_DIR, "grouped_moments.cu")
    sources = opts.source or [committed]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = smb._build_all(sources, "grouped_moments")

    for i, lib in enumerate(libs):
        with _kernel_from(lib):
            cases = edge_cases()
            for name, build in cases:
                args, G = build("cuda")
                agree(f"source {i}: {name}", args, G, quiet=True)
                del args
        print(f"source {i}: kernel == plain at {len(cases)} edge cases, two "
              f"launches agree", flush=True)

    results = {}
    for order in ORDERS:
        args, G = main_path_inputs(order)
        mem = []
        for i, lib in enumerate(libs):
            with _kernel_from(lib):
                agree(f"source {i} at 19a {order}", args, G, quiet=True)
                mem.append(call_bytes(args, G))
        b_ms, b_by, nbytes = grouped_bound(args, G)
        lib_fn, nlib = grouped_library(args, G)
        lib_ms = smb.median_fenced_ms(lib_fn, launches=3, runs=3)
        times = [[] for _ in libs]
        for _ in range(5):
            for i, lib in enumerate(libs):
                with _kernel_from(lib):
                    times[i].append(smb.fenced_ms(
                        lambda: K.grouped_moments(*args, num_groups=G)))
        print(f"19a {order}: {args[1].shape[0]} rows, {G} groups, "
              f"{int(args[1].sum())} live rows, {len(args[5])} moments; "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB); "
              f"index_add_ / scatter_reduce_ x {nlib} {lib_ms:.4f} ms; "
              f"each source == plain", flush=True)
        results[order] = {"bound_ms": b_ms, "bound_by": b_by,
                          "library_ms": lib_ms, "sources": {}}
        for i, ms in enumerate(times):
            med = statistics.median(ms)
            print(f"  source {i}: median {med:.4f} ms ({b_ms / med * 100:.1f}"
                  f"% of the bound; rounds "
                  f"{' / '.join(f'{m:.4f}' for m in ms)}); a call "
                  f"allocates {mem[i] / 2**20:.1f} MiB", flush=True)
            row = {"ms": med, "rounds": ms, "call_bytes": mem[i]}
            if opts.profile:
                with _kernel_from(libs[i]):
                    row["profile_ms"] = profile_ms(
                        lambda: K.grouped_moments(*args, num_groups=G))
                print("    per call: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row["profile_ms"].items()),
                      flush=True)
            results[order]["sources"][sources[i]] = row
        del args, lib_fn
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
