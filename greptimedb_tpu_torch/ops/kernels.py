"""Sorted-segment group-by and the host merge/dedup helpers.

The hot loop of the SQL aggregate path: post-merge scan data is sorted by
(series, ts), so (series [, time bucket]) groups are runs of consecutive
rows and a group-by is a segment reduction with no scatter. Reference:
greptimedb_tpu/ops/kernels.py (`sorted_grouped_aggregate`, XLA code
shaped around the TPU's costly gathers).

`segment_moments` computes every moment of a plan (count, sum, sum_sq,
min, max, first, last) over runs given by their ends. On a CUDA tensor it
launches the hand-written Hopper kernel csrc/segment_moments.cu (one
launch, two passes over a row tiling; the source notes its bound and
design) or raises; on a CPU tensor it computes the plain PyTorch version
(`segment_moments_plain`), which is also what the kernel is held against
on the card. `sorted_grouped_aggregate` keeps the reference's API on top:
avg, stddev and variance are built from kernel sums, as the reference
builds them.

`grouped_moments` is the same set of moments (and the packed first/last
keys) over UNSORTED group ids: on a CUDA tensor it launches
csrc/grouped_moments.cu (each group's state in shared memory: every
block holds all groups when they fit, else rows are partitioned by group
range and each partition's work items hold its groups; the C entry
sizes a launch and bounds its scratch, copying scattered rows into
partition order in chunks) or raises; on a CPU tensor it computes
`grouped_moments_plain`.
`grouped_aggregate` keeps the reference's API
(greptimedb_tpu/ops/kernels.py:77, `_grouped_aggregate` :90) on top of
it, as `sorted_grouped_aggregate` does on `segment_moments`; the
mesh-sharded twin in parallel/aggregate.py folds each shard with it.

The merge/dedup helpers (`merge_dedup_numpy`) run on the host, in numpy,
as the reference's do. The reference's other XLA functions, which no
path of either package runs but its graft entry and its tests
(`time_bucket_ids`, `combine_group_ids`, `apply_cmp`,
`sort_merge_dedup`), are torch ops here.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import exec_stats
from . import cuda_build

# op_type values in the storage engine (mirrors reference OpType:
# src/store-api/src/storage/requests.rs — Put/Delete).
OP_PUT = 0
OP_DELETE = 1

AGG_OPS = ("sum", "count", "avg", "min", "max", "first", "last",
           "stddev", "variance")

#: moment ops of the kernel, in the order of its op codes
MOMENT_OPS = ("count", "sum", "sum_sq", "min", "max", "first", "last")

#: the reference's cardinality switch between its two segment-reduction
#: shapes (kept for callers that bucket on it; the port has one shape)
_SEG_HIGH_CARD_THRESHOLD = 8192

_I32 = torch.iinfo(torch.int32)


def shape_bucket(n: int, minimum: int = 1024) -> int:
    """Round n up to a power of two (>= minimum) to bound recompilations."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def seg_len_bucket(max_len: int) -> int:
    """The smallest even k with 2^k >= max_len (the reference's static
    pass count for its shift-doubling kernels; accepted and unused
    here)."""
    return -(-max(max_len - 1, 1).bit_length() // 2) * 2


def pad_axis0(arr: np.ndarray, target: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    if n == target:
        return arr
    pad = np.full((target - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def check_i64_safe(*arrays, what: str = "timestamps") -> None:
    """Guard against silent int64→int32 truncation.

    The device path is 32-bit (int32 timestamps and integer columns, as
    the reference runs with x64 off): int64 values must be rebased (e.g.
    to region-relative offsets) before they reach a kernel. numpy arrays
    and tensors of int64 outside the int32 range raise."""
    lim = np.iinfo(np.int32)
    for a in arrays:
        if isinstance(a, np.ndarray) and a.dtype == np.int64 and a.size:
            mx, mn = int(a.max()), int(a.min())
        elif isinstance(a, torch.Tensor) and a.dtype == torch.int64 \
                and a.numel():
            mx, mn = int(a.max()), int(a.min())
        else:
            continue
        if mx > lim.max or mn < lim.min:
            raise ValueError(
                f"{what} exceed int32 range ({mn}..{mx}): rebase to "
                f"region-relative offsets before device transfer")


# ---------------------------------------------------------------------------
# Sort-based merge + dedup (host)
# ---------------------------------------------------------------------------

def _merge_order(s: np.ndarray, t: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Permutation sorting rows by (series, ts, seq).

    Fast path: pack (sid, ts - ts_min) into ONE uint64 key and radix-sort
    it (np stable argsort on ints) — ~5x faster than the 3-key lexsort on
    multi-million-row slices. Stable order keeps input order within equal
    (sid, ts) keys, so the rare duplicate clusters are re-ordered by seq
    exactly afterwards; wide domains fall back to lexsort."""
    n = len(s)
    if n <= 1:
        return np.arange(n, dtype=np.intp)
    smin = int(s.min())
    sbits = max(int(int(s.max()) - smin).bit_length(), 1)
    tmin = int(t.min())
    tbits = max(int(int(t.max()) - tmin).bit_length(), 1)
    if sbits + tbits > 64:
        return np.lexsort((q, t, s))
    key = ((s.astype(np.int64) - smin).astype(np.uint64)
           << np.uint64(tbits)) | (t - tmin).astype(np.uint64)
    order = np.argsort(key, kind="stable")
    k_sorted = key[order]
    dup = k_sorted[1:] == k_sorted[:-1]
    if dup.any():
        # positions participating in an equal-key cluster (MVCC versions
        # of one (sid, ts)): sort that tiny subset by (key, seq)
        member = np.concatenate([[False], dup]) | \
            np.concatenate([dup, [False]])
        idx = np.nonzero(member)[0]
        sub = order[idx]
        order[idx] = sub[np.lexsort((q[sub], k_sorted[idx]))]
    return order


def merge_dedup_numpy(series_ids: np.ndarray, ts: np.ndarray, seq: np.ndarray,
                      op_types: np.ndarray, *,
                      keep_deletes: bool = False) -> np.ndarray:
    """Kept row indices in (series, ts) order after MVCC dedup: the
    highest sequence of each (series, ts) wins, and a winning DELETE drops
    the key (keep_deletes=True keeps the tombstone)."""
    order = _merge_order(series_ids, ts, seq)
    s, t, o = series_ids[order], ts[order], op_types[order]
    nxt_same = np.concatenate([(s[1:] == s[:-1]) & (t[1:] == t[:-1]), [False]])
    keep = ~nxt_same if keep_deletes else (~nxt_same) & (o == OP_PUT)
    return order[keep]


# ---------------------------------------------------------------------------
# segment moments: the kernel, its plain version, the wrapper
# ---------------------------------------------------------------------------

def segment_moments_plain(ends: torch.Tensor, mask: torch.Tensor,
                          ts: torch.Tensor, values: Sequence[torch.Tensor],
                          col_masks: Sequence[Optional[torch.Tensor]],
                          ops: Sequence[str], *, with_counts: bool = True
                          ) -> Tuple[List[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel (same arguments and results):
    per-row run ids from the run lengths, then one index_add_ or
    scatter_reduce_ per moment. Sums accumulate in float64 and round
    once to float32 (int32 sums wrap mod 2^32); NaN propagates through
    min and max; first/last reduce the key (ts << 32) + row."""
    G = ends.shape[0]
    dev = mask.device
    n = mask.shape[0]
    ends64 = ends.to(torch.int64)
    starts = torch.cat([ends64.new_zeros(1), ends64[:-1]])
    lens = ends64 - starts
    covered = int(ends64[-1]) if G else 0
    rid = torch.repeat_interleave(torch.arange(G, device=dev), lens)
    in_run = torch.zeros(n, dtype=torch.bool, device=dev)
    in_run[:covered] = True
    rid = torch.cat([rid, rid.new_zeros(n - covered)])
    base = mask & in_run
    pos = torch.arange(n, dtype=torch.int64, device=dev)

    def count(m):
        return torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
            0, rid, m.to(torch.int64)).to(torch.int32)

    results: List[torch.Tensor] = []
    for op, x, cm in zip(ops, values, col_masks):
        m = base if cm is None else base & cm
        if op == "count":
            results.append(count(m))
        elif op in ("sum", "sum_sq"):
            if op == "sum" and not x.dtype.is_floating_point:
                s = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                    0, rid, torch.where(m, x.to(torch.int64), 0))
                s = ((s + 2**31) % 2**32 - 2**31).to(torch.int32)
            else:
                xd = x.to(torch.float64)
                if op == "sum_sq":
                    xd = xd * xd
                s = torch.zeros(G, dtype=torch.float64, device=dev) \
                    .index_add_(0, rid, torch.where(m, xd, 0.0)) \
                    .to(torch.float32)
            results.append(s)
        elif op in ("min", "max"):
            red = "amin" if op == "min" else "amax"
            ident = float("inf") if op == "min" else float("-inf")
            xd = torch.where(m, x.to(torch.float64), ident)
            r = torch.full((G,), ident, dtype=torch.float64, device=dev) \
                .scatter_reduce_(0, rid, xd, red, include_self=True)
            nan = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                0, rid, (m & torch.isnan(xd)).to(torch.int64))
            r = torch.where(nan > 0, float("nan"), r)
            if x.dtype.is_floating_point:
                results.append(r.to(x.dtype))
            else:
                hi, lo = _I32.max, _I32.min
                r = torch.where(r == float("inf"), hi, r)
                r = torch.where(r == float("-inf"), lo, r)
                results.append(r.to(x.dtype))
        elif op in ("first", "last"):
            first = op == "first"
            ident = _I32.max if first else _I32.min
            t = ts.to(torch.int64)
            live = m & (t != ident)
            key = t * 2**32 + pos
            none = ident * 2**32 + (2**32 - 1 if first else 0)
            key = torch.where(live, key, none)
            r = torch.full((G,), none, dtype=torch.int64, device=dev) \
                .scatter_reduce_(0, rid, key, "amin" if first else "amax",
                                 include_self=True)
            found = r != none
            at = torch.where(found, r % 2**32, 0)
            val = x[at] if n else torch.zeros(G, dtype=x.dtype, device=dev)
            empty = float("nan") if x.dtype.is_floating_point else 0
            results.append(torch.where(
                found, val, torch.tensor(empty, dtype=x.dtype, device=dev)))
        else:
            raise ValueError(f"unsupported moment op: {op}")
    counts = count(base) if with_counts else None
    return results, counts


def _lib():
    lib = cuda_build.load("segment_moments")
    if lib.segment_moments_launch.argtypes is None:
        P = ctypes.c_void_p
        lib.segment_moments_launch.argtypes = [
            P, ctypes.c_int, ctypes.c_int, P, P, P, ctypes.c_int,
            P, P, P, P, P, P, P]
        lib.segment_moments_launch.restype = ctypes.c_int
        lib.segment_moments_scratch_bytes.argtypes = [ctypes.c_int,
                                                      ctypes.c_int]
        lib.segment_moments_scratch_bytes.restype = ctypes.c_longlong
        lib.segment_moments_max_moments.argtypes = []
        lib.segment_moments_max_moments.restype = ctypes.c_int
        lib.segment_moments_error_string.argtypes = [ctypes.c_int]
        lib.segment_moments_error_string.restype = ctypes.c_char_p
    return lib


def _out_dtype(op: str, x: torch.Tensor) -> torch.dtype:
    if op == "count":
        return torch.int32
    if op == "sum_sq":
        return torch.float32
    return x.dtype


def _launch(ends, mask, ts, values, col_masks, ops, with_counts):
    lib = _lib()
    G, n = ends.shape[0], mask.shape[0]
    dev = mask.device
    counts = torch.empty(G, dtype=torch.int32, device=dev) \
        if with_counts else None
    # identical moments (a count reads no values: every count over one
    # column mask is the same) are computed once and share their output
    uniq, slot = {}, []
    for op, x, cm in zip(ops, values, col_masks):
        key = (op, None if op == "count" else (x.data_ptr(), x.dtype),
               None if cm is None else cm.data_ptr())
        slot.append(uniq.setdefault(key, len(uniq)))
    first = {}
    for i, u in enumerate(slot):
        first.setdefault(u, i)
    order = [first[u] for u in range(len(uniq))]
    outs = [torch.empty(G, dtype=_out_dtype(ops[i], values[i]), device=dev)
            for i in order]
    if G == 0:
        return [outs[u] for u in slot], counts
    per = lib.segment_moments_max_moments()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # more moments than one launch takes: one launch per chunk, the
        # row counts in the first
        for c0 in range(0, max(len(order), 1), per):
            ch = order[c0:c0 + per]
            k = len(ch)
            scratch = torch.empty(
                lib.segment_moments_scratch_bytes(n, k), dtype=torch.uint8,
                device=dev)
            ptrs = (ctypes.c_void_p * max(k, 1))
            ints = (ctypes.c_int * max(k, 1))
            cm = [col_masks[i] for i in ch]
            err = lib.segment_moments_launch(
                ends.data_ptr(), G, n, mask.data_ptr(), ts.data_ptr(),
                counts.data_ptr() if (counts is not None and c0 == 0)
                else None, k,
                ptrs(*[values[i].data_ptr() for i in ch]),
                ptrs(*[c.data_ptr() if c is not None else None for c in cm]),
                ptrs(*[o.data_ptr() for o in outs[c0:c0 + per]]),
                ints(*[MOMENT_OPS.index(ops[i]) for i in ch]),
                ints(*[0 if values[i].dtype == torch.float32 else 1
                       for i in ch]),
                scratch.data_ptr(), stream)
            if err != 0:
                msg = lib.segment_moments_error_string(err).decode()
                raise RuntimeError(f"segment_moments kernel launch failed: "
                                   f"{msg} (cuda error {err})")
            segment_moments.launches += 1
            exec_stats.count_launch("segment_moments")
    return [outs[u] for u in slot], counts


def segment_moments(ends: torch.Tensor, mask: torch.Tensor, ts: torch.Tensor,
                    values: Sequence[torch.Tensor],
                    col_masks: Sequence[Optional[torch.Tensor]],
                    ops: Sequence[str], *, with_counts: bool = True
                    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Per-run moments over rows sorted by run.

    ends: int32 [G], run g = rows [ends[g-1], ends[g]) (non-decreasing,
    <= n); mask: bool [n] row mask; ts: int32 [n] (first/last order);
    values[i]: float32 or int32 [n]; col_masks[i]: bool [n] or None (the
    row mask alone); ops[i] in MOMENT_OPS. Returns ([G] per moment, the
    int32 row count per run, or None without `with_counts`).

    CPU tensors: the plain version. CUDA tensors: the Hopper kernel
    (counted in `segment_moments.launches` and on the active ExecStats,
    whose `launches` a datanode's Flight response carries home), or an
    exception."""
    n = mask.shape[0]
    if not (len(values) == len(col_masks) == len(ops)):
        raise ValueError("segment_moments: values, col_masks and ops "
                         "differ in length")
    for op in ops:
        if op not in MOMENT_OPS:
            raise ValueError(f"unsupported moment op: {op}")
    tensors = [("ends", ends, (torch.int32,)), ("mask", mask, (torch.bool,)),
               ("ts", ts, (torch.int32,))]
    tensors += [(f"values[{i}]", v, (torch.float32, torch.int32))
                for i, v in enumerate(values)]
    tensors += [(f"col_masks[{i}]", c, (torch.bool,))
                for i, c in enumerate(col_masks) if c is not None]
    dev = mask.device
    for name, t, dts in tensors:
        if t.dim() != 1 or t.dtype not in dts:
            raise ValueError(f"segment_moments: {name} must be 1-d "
                             f"{'/'.join(map(str, dts))}, got {t.dtype} "
                             f"shape {tuple(t.shape)}")
        if name != "ends" and t.shape[0] != n:
            raise ValueError(f"segment_moments: {name} has {t.shape[0]} "
                             f"rows, mask {n}")
        if t.device != dev:
            raise ValueError(f"segment_moments: {name} on {t.device}, "
                             f"mask on {dev}")
    if dev.type == "cpu":
        return segment_moments_plain(ends, mask, ts, values, col_masks, ops,
                                     with_counts=with_counts)
    if dev.type != "cuda":
        raise ValueError(f"segment_moments: no kernel for device {dev}")
    if n >= 2**31 - 2**20:
        raise ValueError(f"segment_moments: {n} rows exceed the kernel's "
                         f"int32 row index")
    for name, t, _ in tensors:
        if not t.is_contiguous():
            raise ValueError(f"segment_moments kernel takes contiguous "
                             f"tensors; {name} is not")
    return _launch(ends, mask, ts, list(values), list(col_masks), list(ops),
                   with_counts)


#: kernel launches since the count was last reset (plain-version calls on
#: CPU tensors do not count)
segment_moments.launches = 0


def _as_ends(ends, n: int, device) -> torch.Tensor:
    """int32 run ends on `device`; host ends are checked here (device ends
    are the caller's contract: non-decreasing, within [0, n])."""
    if isinstance(ends, torch.Tensor):
        return ends.to(device=device, dtype=torch.int32).contiguous()
    e = np.asarray(ends)
    if e.size and (int(e.min()) < 0 or int(e.max()) > n or
                   bool((np.diff(e.astype(np.int64)) < 0).any())):
        raise ValueError("run ends must be non-decreasing within [0, n]")
    return torch.as_tensor(e.astype(np.int32), device=device)


def sorted_grouped_aggregate(gids, mask, ts, values, col_masks=(), *,
                             num_groups, ops, has_col_masks=False,
                             ends=None, seg_len_k=None):
    """Fused masked group-by over non-decreasing group ids (the natural
    order of merged LSM scans); the reference's API and semantics.

    gids: int32 [N] non-decreasing (read only when `ends` is None);
    mask: bool [N] row filter; ts: int32 [N]; values: per-op columns;
    col_masks: per-op validity when has_col_masks. `ends` (int32
    [num_groups], numpy or tensor): cumulative row count per group, as
    the scan path knows it on the host; without it, numpy gids take a
    bincount and tensor gids a device searchsorted. seg_len_k is
    accepted for the reference's callers and unused.

    Returns (per-op results [num_groups], int32 row counts). Empty groups
    give 0 for sum/count, NaN for avg, the identity (+-inf, int32
    max/min) for min/max, NaN (or 0 for ints) for first/last; callers
    null them out via the counts. One kernel launch computes every
    moment; avg, stddev and variance are built from its sums here.

    Value columns are float32 or int32 tensors, as the scan path and the
    flow folds hand them over. Other dtypes raise ValueError where the
    reference answers (its sorted twin sums and divides in the column's
    dtype); `grouped_aggregate` takes every dtype the reference does."""
    del seg_len_k
    check_i64_safe(ts, what="sorted_grouped_aggregate ts")
    check_i64_safe(*values, what="sorted_grouped_aggregate values")
    other = sorted({str(v.dtype) for v in values
                    if v.dtype not in (torch.float32, torch.int32)})
    if other:
        raise ValueError(f"sorted_grouped_aggregate takes float32 and "
                         f"int32 value columns, not {', '.join(other)}")
    device = mask.device
    n = mask.shape[0]
    if ends is None:
        if isinstance(gids, np.ndarray):
            hist = np.bincount(gids, minlength=num_groups)[:num_groups]
            ends = np.cumsum(hist, dtype=np.int64).astype(np.int32)
        else:
            ar = torch.arange(num_groups, dtype=gids.dtype,
                              device=gids.device)
            ends = torch.searchsorted(gids, ar, right=True)
    ends = _as_ends(ends, n, device)
    if ends.shape[0] != num_groups:
        raise ValueError(f"ends has {ends.shape[0]} groups, num_groups="
                         f"{num_groups}")

    def cmask(i):
        return col_masks[i] if has_col_masks else None

    # kernel moments, deduplicated: (op, column index, derived column)
    k_ops: List[str] = []
    k_vals: List[torch.Tensor] = []
    k_masks: List[Optional[torch.Tensor]] = []
    seen = {}

    def moment(op, i, col=None, key=None):
        # without column masks every count is the row count: one moment
        k = (op, -1 if op == "count" and not has_col_masks else i, key)
        if k not in seen:
            seen[k] = len(k_ops)
            k_ops.append(op)
            k_vals.append(values[i] if col is None else col)
            k_masks.append(cmask(i))
        return seen[k]

    plan = []
    for i, op in enumerate(ops):
        if op in ("count", "sum", "sum_sq", "min", "max", "first", "last"):
            plan.append((op, moment(op, i)))
        elif op == "avg":
            plan.append((op, moment("sum", i), moment("count", i)))
        elif op in ("stddev", "variance"):
            # shifted one-pass moments, as the reference: center on the
            # column's global mean before squaring
            col = values[i]
            m = mask & col_masks[i] if has_col_masks else mask
            colf = col.to(torch.float32)
            gc = max(int(m.sum()), 1)
            shift = (torch.where(m, colf.to(torch.float64), 0.0).sum() / gc
                     ).to(torch.float32)
            d = torch.where(m, colf - shift, 0.0).contiguous()
            plan.append((op, moment("sum", i, d, "d"),
                         moment("sum_sq", i, d, "d"), moment("count", i)))
        else:
            raise ValueError(f"unsupported agg op: {op}")
    res, counts = segment_moments(ends, mask, ts, k_vals, k_masks, k_ops)
    results = []
    for op, *idx in plan:
        if len(idx) == 1:
            results.append(res[idx[0]])
        elif op == "avg":
            s, c = res[idx[0]], res[idx[1]]
            results.append(torch.where(
                c > 0, s.to(torch.float32) / c.clamp(min=1).to(torch.float32),
                float("nan")))
        else:
            s, sq, c = res[idx[0]], res[idx[1]], res[idx[2]]
            cc = c.clamp(min=1).to(torch.float32)
            # sample variance (ddof=1, DataFusion convention); <2 rows → NaN
            var = (sq - (s / cc) * s).clamp(min=0.0) / \
                (c - 1).clamp(min=1).to(torch.float32)
            var = torch.where(c >= 2, var, float("nan"))
            results.append(var.sqrt() if op == "stddev" else var)
    return tuple(results), counts


# ---------------------------------------------------------------------------
# grouped moments (unsorted group ids): the kernel, its plain version, the
# wrapper, and the reference's grouped_aggregate on top
# ---------------------------------------------------------------------------

#: moment ops of the grouped kernel, in the order of its op codes; the
#: *_key moments are the packed int64 first/last keys (LLONG_MAX: none)
GROUPED_OPS = MOMENT_OPS + ("first_key", "last_key")

_I64_MAX = torch.iinfo(torch.int64).max


def _packed_keys(op: str, ts: torch.Tensor, row: torch.Tensor
                 ) -> torch.Tensor:
    """first: (ts << 32) + row; last: (~ts << 32) + row (the largest ts,
    then the smallest row, is the smallest key). row < 2^32."""
    t = ts.to(torch.int64)
    hi = t if op in ("first", "first_key") else ~t
    return hi * 2**32 + row


def grouped_moments_plain(gids: torch.Tensor, mask: torch.Tensor,
                          ts: torch.Tensor, values: Sequence[torch.Tensor],
                          col_masks: Sequence[Optional[torch.Tensor]],
                          ops: Sequence[str], *, num_groups: int,
                          row_base: int = 0, with_counts: bool = True
                          ) -> Tuple[List[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Plain PyTorch version of the grouped kernel (same arguments and
    results): one index_add_ or scatter_reduce_ per moment over the rows
    whose mask is set and whose group id lies in [0, num_groups). Sums
    accumulate in float64 and round once to float32 (int32 sums wrap mod
    2^32); NaN propagates through min and max; first/last reduce the
    packed (ts, row_base + row) key."""
    G = int(num_groups)
    dev = mask.device
    n = mask.shape[0]
    g64 = gids.to(torch.int64)
    base = mask & (g64 >= 0) & (g64 < G)
    gid = torch.where(base, g64, 0)
    row = torch.arange(n, dtype=torch.int64, device=dev) + int(row_base)

    def count(m):
        return torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
            0, gid, m.to(torch.int64)).to(torch.int32)

    results: List[torch.Tensor] = []
    for op, x, cm in zip(ops, values, col_masks):
        m = base if cm is None else base & cm
        if op == "count":
            results.append(count(m))
        elif op in ("sum", "sum_sq"):
            if op == "sum" and not x.dtype.is_floating_point:
                s = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                    0, gid, torch.where(m, x.to(torch.int64), 0))
                s = ((s + 2**31) % 2**32 - 2**31).to(torch.int32)
            else:
                xd = x.to(torch.float64)
                if op == "sum_sq":
                    xd = xd * xd
                s = torch.zeros(G, dtype=torch.float64, device=dev) \
                    .index_add_(0, gid, torch.where(m, xd, 0.0)) \
                    .to(torch.float32)
            results.append(s)
        elif op in ("min", "max"):
            red = "amin" if op == "min" else "amax"
            ident = float("inf") if op == "min" else float("-inf")
            xd = torch.where(m, x.to(torch.float64), ident)
            r = torch.full((G,), ident, dtype=torch.float64, device=dev) \
                .scatter_reduce_(0, gid, xd, red, include_self=True)
            nan = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                0, gid, (m & torch.isnan(xd)).to(torch.int64))
            r = torch.where(nan > 0, float("nan"), r)
            if not x.dtype.is_floating_point:
                r = torch.where(r == float("inf"), _I32.max, r)
                r = torch.where(r == float("-inf"), _I32.min, r)
            results.append(r.to(x.dtype))
        elif op in ("first", "last", "first_key", "last_key"):
            key = torch.where(m, _packed_keys(op, ts, row), _I64_MAX)
            r = torch.full((G,), _I64_MAX, dtype=torch.int64, device=dev) \
                .scatter_reduce_(0, gid, key, "amin", include_self=True)
            if op.endswith("_key"):
                results.append(r)
                continue
            found = r != _I64_MAX
            at = torch.where(found, r % 2**32 - int(row_base), 0)
            val = x[at] if n else torch.zeros(G, dtype=x.dtype, device=dev)
            empty = float("nan") if x.dtype.is_floating_point else 0
            results.append(torch.where(
                found, val, torch.tensor(empty, dtype=x.dtype, device=dev)))
        else:
            raise ValueError(f"unsupported moment op: {op}")
    counts = count(base) if with_counts else None
    return results, counts


def _grouped_lib():
    lib = cuda_build.load("grouped_moments")
    if lib.grouped_moments_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.grouped_moments_launch.argtypes = [
            P, I, I, P, P, ctypes.c_longlong, P, I, P, P, P, P, P, P,
            ctypes.c_longlong, P]
        lib.grouped_moments_launch.restype = I
        lib.grouped_moments_scratch_bytes.argtypes = [I, I, I, P, P, P, P,
                                                      P]
        lib.grouped_moments_scratch_bytes.restype = ctypes.c_longlong
        for fn in (lib.grouped_moments_smem_groups,
                   lib.grouped_moments_partition_groups):
            fn.argtypes = [I, P, P]
            fn.restype = I
        lib.grouped_moments_max_moments.argtypes = []
        lib.grouped_moments_max_moments.restype = I
        lib.grouped_moments_error_string.argtypes = [I]
        lib.grouped_moments_error_string.restype = ctypes.c_char_p
    return lib


def _grouped_out_dtype(op: str, x: torch.Tensor) -> torch.dtype:
    if op.endswith("_key"):
        return torch.int64
    return _out_dtype(op, x)


def _grouped_launch(gids, mask, ts, values, col_masks, ops, G, row_base,
                    with_counts):
    lib = _grouped_lib()
    n = mask.shape[0]
    dev = mask.device
    counts = torch.empty(G, dtype=torch.int32, device=dev) \
        if with_counts else None
    # identical moments are computed once and share their output
    uniq, slot = {}, []
    for op, x, cm in zip(ops, values, col_masks):
        key = (op, None if op == "count" else (x.data_ptr(), x.dtype),
               None if cm is None else cm.data_ptr())
        slot.append(uniq.setdefault(key, len(uniq)))
    first = {}
    for i, u in enumerate(slot):
        first.setdefault(u, i)
    order = [first[u] for u in range(len(uniq))]
    outs = [torch.empty(G, dtype=_grouped_out_dtype(ops[i], values[i]),
                        device=dev) for i in order]
    if G == 0:
        return [outs[u] for u in slot], counts
    per = lib.grouped_moments_max_moments()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # more moments than one launch takes: one launch per chunk, the
        # row counts in the first
        for c0 in range(0, max(len(order), 1), per):
            ch = order[c0:c0 + per]
            k = len(ch)
            ptrs = (ctypes.c_void_p * max(k, 1))
            ints = (ctypes.c_int * max(k, 1))
            vals = ptrs(*[values[i].data_ptr() for i in ch])
            cms = ptrs(*[None if col_masks[i] is None else
                         col_masks[i].data_ptr() for i in ch])
            kops = ints(*[GROUPED_OPS.index(ops[i]) for i in ch])
            is_int = ints(*[int(values[i].dtype != torch.float32)
                            for i in ch])
            # the C entry sizes the launch (its partitions and row chunks)
            need = lib.grouped_moments_scratch_bytes(
                n, G, k, kops, is_int, vals, cms, ts.data_ptr())
            if need < 0:
                raise ValueError(f"grouped_moments: the kernel refuses "
                                 f"{n} rows, {G} groups, {k} moments")
            scratch = torch.empty((need + 7) // 8, dtype=torch.int64,
                                  device=dev)
            err = lib.grouped_moments_launch(
                gids.data_ptr(), n, G, mask.data_ptr(), ts.data_ptr(),
                int(row_base),
                counts.data_ptr() if (counts is not None and c0 == 0)
                else None, k, vals, cms,
                ptrs(*[o.data_ptr() for o in outs[c0:c0 + per]]),
                kops, is_int, scratch.data_ptr(), need, stream)
            if err != 0:
                msg = lib.grouped_moments_error_string(err).decode()
                raise RuntimeError(f"grouped_moments kernel launch failed: "
                                   f"{msg} (cuda error {err})")
            grouped_moments.launches += 1
            exec_stats.count_launch("grouped_moments")
    return [outs[u] for u in slot], counts


def grouped_moments(gids: torch.Tensor, mask: torch.Tensor,
                    ts: torch.Tensor, values: Sequence[torch.Tensor],
                    col_masks: Sequence[Optional[torch.Tensor]],
                    ops: Sequence[str], *, num_groups: int,
                    row_base: int = 0, with_counts: bool = True
                    ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Per-group moments over rows in any order.

    gids: int32 [n] group per row (rows outside [0, num_groups) count
    nowhere); mask: bool [n]; ts: int32 [n] (first/last order); values[i]:
    float32 or int32 [n]; col_masks[i]: bool [n] or None (the row mask
    alone); ops[i] in GROUPED_OPS. Rows are numbered row_base + i in the
    first/last keys (a shard's offset in its table). Returns ([G] per
    moment, the int32 row count per group, or None without
    `with_counts`).

    CPU tensors: the plain version. CUDA tensors: the Hopper kernel
    (counted in `grouped_moments.launches` and on the active ExecStats),
    or an exception."""
    n = mask.shape[0]
    if not (len(values) == len(col_masks) == len(ops)):
        raise ValueError("grouped_moments: values, col_masks and ops "
                         "differ in length")
    for op in ops:
        if op not in GROUPED_OPS:
            raise ValueError(f"unsupported moment op: {op}")
    if int(num_groups) < 0 or int(row_base) < 0 or \
            int(row_base) + n >= 2**32 - 1:
        raise ValueError(f"grouped_moments: num_groups {num_groups} and "
                         f"rows {row_base}..{int(row_base) + n} out of range")
    tensors = [("gids", gids, (torch.int32,)), ("mask", mask, (torch.bool,)),
               ("ts", ts, (torch.int32,))]
    tensors += [(f"values[{i}]", v, (torch.float32, torch.int32))
                for i, v in enumerate(values)]
    tensors += [(f"col_masks[{i}]", c, (torch.bool,))
                for i, c in enumerate(col_masks) if c is not None]
    dev = mask.device
    for name, t, dts in tensors:
        if t.dim() != 1 or t.dtype not in dts:
            raise ValueError(f"grouped_moments: {name} must be 1-d "
                             f"{'/'.join(map(str, dts))}, got {t.dtype} "
                             f"shape {tuple(t.shape)}")
        if t.shape[0] != n:
            raise ValueError(f"grouped_moments: {name} has {t.shape[0]} "
                             f"rows, mask {n}")
        if t.device != dev:
            raise ValueError(f"grouped_moments: {name} on {t.device}, "
                             f"mask on {dev}")
    if dev.type == "cpu":
        return grouped_moments_plain(gids, mask, ts, values, col_masks, ops,
                                     num_groups=num_groups,
                                     row_base=row_base,
                                     with_counts=with_counts)
    if dev.type != "cuda":
        raise ValueError(f"grouped_moments: no kernel for device {dev}")
    if n >= 2**31 - 2**20:
        raise ValueError(f"grouped_moments: {n} rows exceed the kernel's "
                         f"int32 row index")
    for name, t, _ in tensors:
        if not t.is_contiguous():
            raise ValueError(f"grouped_moments kernel takes contiguous "
                             f"tensors; {name} is not")
    return _grouped_launch(gids, mask, ts, list(values), list(col_masks),
                           list(ops), int(num_groups), int(row_base),
                           with_counts)


#: kernel launches since the count was last reset (plain-version calls on
#: CPU tensors do not count)
grouped_moments.launches = 0


def _device_for(device, *xs) -> torch.device:
    """The device of the first tensor among xs, else `device`, else "cuda"
    (the port's entry points run on the card unless asked for the CPU)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def _narrow_dtype(dtype: torch.dtype) -> torch.dtype:
    """A column's dtype with x64 off, as the reference's device arrays
    have it: float64 → float32, int64 → int32."""
    return {torch.float64: torch.float32,
            torch.int64: torch.int32}.get(dtype, dtype)


def _on(x, device: torch.device, dtype: Optional[torch.dtype] = None
        ) -> torch.Tensor:
    """x (numpy or tensor) on `device`, narrowed as the reference narrows
    it (int64 range-checked by the callers), in `dtype` when given."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.ascontiguousarray(x))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port's kernels run "
                           "on the GPU; pass device='cpu' (or CPU tensors) "
                           "for the plain version")
    x = x.to(device=device, dtype=dtype or _narrow_dtype(x.dtype))
    return x.contiguous()


def _kernel_column(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The kernel's 32-bit view of a value column for moment `op`: floats
    as float32; int8, int16, uint8, uint16 and bool widened to int32;
    uint32 as its bits in an int32 (a sum wraps mod 2^32 alike) or, for
    min and max, as the key x ^ 0x80000000, whose signed order is the
    values' unsigned order. `_from_kernel` maps the moments back."""
    if x.dtype.is_floating_point:
        return x.to(torch.float32)
    if x.dtype == torch.uint32:
        bits = x.view(torch.int32)
        return bits ^ _I32.min if op in ("min", "max") else bits
    return x.to(torch.int32)


def _from_kernel(op: str, r: torch.Tensor, dtype: torch.dtype
                 ) -> torch.Tensor:
    """A kernel moment (sum, min, max, first or last) of a column of
    `dtype`, typed as the reference types it: an integer sum wraps to the
    dtype (the reference sums in it), an empty group's min / max is the
    dtype's own identity, a uint32 moment comes back from its bits or
    key."""
    if dtype.is_floating_point:
        return r.to(dtype)
    if dtype == torch.uint32:
        return (r ^ _I32.min if op in ("min", "max") else r).view(dtype)
    if op in ("min", "max") and dtype not in (torch.int32, torch.bool):
        # the kernel's int32 identity: no narrower value reaches it
        info = torch.iinfo(dtype)
        r = torch.where(r == _I32.max, info.max, r) if op == "min" else \
            torch.where(r == _I32.min, info.min, r)
    return r.to(dtype)


def grouped_aggregate(gids, mask, ts, values, col_masks=(), *, num_groups,
                      ops, has_col_masks=False, device=None):
    """Fused masked group-by over unsorted group ids; the reference's API
    and semantics (greptimedb_tpu/ops/kernels.py:77).

    gids: int32 [N] (numpy or tensor); mask: bool [N] row filter; ts:
    int32 [N] (int64 within int32's range is narrowed, outside it raises);
    values: per-op columns; col_masks: per-op validity, read only with
    has_col_masks. Numpy inputs go to `device` ("cuda" unless given;
    without CUDA that raises); tensors stay where they are.

    Returns (per-op results [num_groups], int32 row counts), as tensors.
    Empty groups give 0 for sum/count, NaN for avg/stddev/variance, the
    identity (+-inf, int max/min) for min/max and NaN (0 for ints) for
    first/last; callers null them out via the counts. One kernel launch
    computes every moment; avg, stddev and variance are built from its
    sums here, as the reference builds them."""
    args, finish = grouped_aggregate_plan(
        gids, mask, ts, values, col_masks, num_groups=num_groups, ops=ops,
        has_col_masks=has_col_masks, device=device)
    res, counts = grouped_moments(*args, num_groups=int(num_groups))
    return finish(res), counts


def grouped_aggregate_plan(gids, mask, ts, values, col_masks=(), *,
                           num_groups, ops, has_col_masks=False,
                           device=None):
    """grouped_aggregate up to its kernel call: returns the kernel's
    arguments (gids, mask, ts, values, col_masks, ops: each moment once)
    and the function that turns the kernel's moments into the ops'
    results."""
    check_i64_safe(ts, what="grouped_aggregate ts")
    check_i64_safe(*values, what="grouped_aggregate values")
    for op in ops:
        if op not in AGG_OPS:
            raise ValueError(f"unsupported agg op: {op}")
    dev = _device_for(device, gids, mask, ts, *values)
    gids = _on(gids, dev, torch.int32)
    mask = _on(mask, dev, torch.bool)
    ts = _on(ts, dev, torch.int32)
    # a column passed for several ops moves to the device once
    on = {}
    cols = [on[id(v)] if id(v) in on else on.setdefault(id(v), _on(v, dev))
            for v in values]
    cmasks = [_on(c, dev, torch.bool) for c in col_masks] \
        if has_col_masks else []
    G = int(num_groups)
    k_ops, k_vals, k_masks, seen = [], [], [], {}
    kcols = {}

    def kernel_column(i, op):
        # one 32-bit copy of a column for every moment that reads it
        # (uint32's min / max read its keys)
        k = (id(cols[i]), op in ("min", "max") and
             cols[i].dtype == torch.uint32)
        if k not in kcols:
            kcols[k] = _kernel_column(cols[i], op)
        return kcols[k]

    def moment(op, i, col=None, key=None):
        # without column masks every count is the row count: one moment
        k = (op, -1 if op == "count" and not has_col_masks else i, key)
        if k not in seen:
            seen[k] = len(k_ops)
            k_ops.append(op)
            k_vals.append(kernel_column(i, op) if col is None else col)
            k_masks.append(cmasks[i] if has_col_masks else None)
        return seen[k]

    in_range = mask & (gids >= 0) & (gids < G)
    plan = []
    for i, op in enumerate(ops):
        if op in ("count", "sum", "min", "max", "first", "last"):
            plan.append((op, i, moment(op, i)))
        elif op == "avg":
            plan.append((op, i, moment("sum", i), moment("count", i)))
        else:   # stddev, variance: shifted one-pass moments, as the
            # reference: center on the column's mean over the counted rows
            m = mask & cmasks[i] if has_col_masks else mask
            colf = cols[i].to(torch.float32)
            gc = (in_range & m).sum().clamp(min=1)
            shift = (torch.where(m, colf.to(torch.float64), 0.0).sum() /
                     gc).to(torch.float32)
            d = torch.where(m, colf - shift, 0.0).contiguous()
            plan.append((op, i, moment("sum", i, d, "d"),
                         moment("sum_sq", i, d, "d"), moment("count", i)))

    def finish(res):
        results = []
        for op, i, *idx in plan:
            dt = cols[i].dtype
            if len(idx) == 1:
                r = res[idx[0]]
                results.append(r if op == "count" else
                               _from_kernel(op, r, dt))
            elif op == "avg":
                results.append(_avg(_from_kernel("sum", res[idx[0]], dt),
                                    res[idx[1]]))
            else:
                results.append(_variance(op, *(res[j] for j in idx)))
        return tuple(results)

    return (gids, mask, ts, k_vals, k_masks, k_ops), finish


def _avg(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The mean as the reference divides it: the sum in the column's
    dtype (wrapped, for integers) over the count, in the column's float
    type (float16 stays float16) or in float32 for an integer column."""
    dt = s.dtype if s.dtype.is_floating_point else torch.float32
    return torch.where(c > 0, s.to(dt) / c.clamp(min=1).to(dt),
                       float("nan"))


def _variance(op: str, s: torch.Tensor, sq: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """Sample variance (ddof=1, DataFusion's convention) from shifted
    sums, as the reference finalizes it; < 2 rows → NaN."""
    cc = c.clamp(min=1).to(torch.float32)
    var = (sq - (s / cc) * s).clamp(min=0.0) / \
        (c - 1).clamp(min=1).to(torch.float32)
    var = torch.where(c >= 2, var, float("nan"))
    return var.sqrt() if op == "stddev" else var


# ---------------------------------------------------------------------------
# the reference's elementwise helpers and its device merge/dedup, as torch
# ops (no path of either package runs them but the graft entry's)
# ---------------------------------------------------------------------------

def time_bucket_ids(ts, origin: int, stride: int, num_buckets: int
                    ) -> torch.Tensor:
    """Map timestamps onto [0, num_buckets) bucket ids (floor division,
    clamped), in ts's integer dtype's arithmetic as the reference's."""
    ts = ts if isinstance(ts, torch.Tensor) else \
        _on(ts, torch.device("cpu"))
    b = torch.div(ts - origin, stride, rounding_mode="floor")
    return torch.clamp(b, 0, num_buckets - 1).to(torch.int32)


def combine_group_ids(tag_gids, bucket_ids, num_buckets: int
                      ) -> torch.Tensor:
    tag = torch.as_tensor(tag_gids).to(torch.int32)
    return tag * num_buckets + torch.as_tensor(bucket_ids).to(
        device=tag.device, dtype=torch.int32)


CMP_OPS = {"eq", "ne", "lt", "le", "gt", "ge", "isin", "between"}


def apply_cmp(op: str, col: torch.Tensor, a, b=None) -> torch.Tensor:
    if op == "eq":
        return col == a
    if op == "ne":
        return col != a
    if op == "lt":
        return col < a
    if op == "le":
        return col <= a
    if op == "gt":
        return col > a
    if op == "ge":
        return col >= a
    if op == "between":
        return (col >= a) & (col <= b)
    if op == "isin":
        return torch.isin(col, torch.as_tensor(a, device=col.device))
    raise ValueError(f"unknown cmp op {op}")


def sort_merge_dedup(series_ids, ts, seq, op_types, valid
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge-sort rows of any number of concatenated runs and compute the
    MVCC keep-mask (reference: greptimedb_tpu/ops/kernels.py:238).

    Returns (order, keep): `order` (int32) sorts rows by (series, ts, seq)
    with invalid rows last, ties in input order (three stable sorts, as
    jnp.lexsort orders them); `keep[i]` marks, in sorted position i, the
    highest sequence of each (series, ts) unless that winner is a
    DELETE. Numpy inputs run on the CPU; int64 ts / seq outside int32's
    range raise, as the reference's wrapper does."""
    check_i64_safe(ts, what="sort_merge_dedup ts")
    check_i64_safe(seq, what="sort_merge_dedup seq")
    dev = series_ids.device if isinstance(series_ids, torch.Tensor) \
        else torch.device("cpu")
    s, t, q = (_on(x, dev) for x in (series_ids, ts, seq))
    o, v = _on(op_types, dev), _on(valid, dev, torch.bool)
    big = torch.where(v, s.to(torch.int32), _I32.max)
    order = torch.arange(s.shape[0], device=dev)
    for key in (q, t, big):
        order = order[torch.sort(key[order], stable=True).indices]
    s_sorted, t_sorted = big[order], t[order]
    nxt_same = torch.cat([
        (s_sorted[1:] == s_sorted[:-1]) & (t_sorted[1:] == t_sorted[:-1]),
        torch.zeros(1, dtype=torch.bool, device=dev)])
    keep = v[order] & ~nxt_same & (o[order] == OP_PUT)
    return order.to(torch.int32), keep
