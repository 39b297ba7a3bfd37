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

The merge/dedup helpers (`merge_dedup_numpy`) run on the host, in numpy,
as the reference's do.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    (counted in `segment_moments.launches`), or an exception."""
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
    moment; avg, stddev and variance are built from its sums here."""
    del seg_len_k
    check_i64_safe(ts, what="sorted_grouped_aggregate ts")
    check_i64_safe(*values, what="sorted_grouped_aggregate values")
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
