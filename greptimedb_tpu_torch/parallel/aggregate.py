"""Distributed group-by aggregation: all-reduce of per-shard moments.

The port of greptimedb_tpu/parallel/aggregate.py. Every rank folds its
own rows to per-group moments with the hand-written grouped-moments
kernel (ops/kernels.py:grouped_moments; its plain version on CPU
tensors), and torch.distributed finishes the job where the reference
emits psum / pmin / pmax inside shard_map.

Decomposable moments per op (classic partial-aggregation algebra):
  sum, count           -> all_reduce SUM (int32 sums in int64, wrapped
                          back mod 2^32 as the reference's psum wraps)
  avg                  -> SUM of sum and count
  stddev/variance      -> SUM of shifted sums and squares and count, the
                          shift from the globally reduced sum and count
  min/max              -> MIN / MAX (floats as order-preserving int32
                          keys, so NaN propagates on every backend)
  first/last           -> MIN of the packed (ts, global row index) key,
                          then the owner's value by a native-dtype SUM
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kernels import (AGG_OPS, _avg, _kernel_column, _narrow_dtype,
                           _variance, check_i64_safe, grouped_moments)
from .mesh import Mesh, pad_rows_to_multiple

_I32 = torch.iinfo(torch.int32)
_I64_MAX = torch.iinfo(torch.int64).max


def all_reduce_many(mesh: Mesh, items: Sequence[Tuple[torch.Tensor, str]]
                    ) -> List[torch.Tensor]:
    """All-reduce each (tensor, "sum" | "min" | "max") over the mesh, one
    collective per (dtype, op) pair of flat tensors concatenated. A mesh
    of one rank returns the tensors as they are."""
    out: List[torch.Tensor] = [t for t, _ in items]
    if not mesh.distributed:
        return out
    buckets: Dict[Tuple[torch.dtype, str], List[int]] = {}
    for i, (t, op) in enumerate(items):
        buckets.setdefault((t.dtype, op), []).append(i)
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    for (_, op), idx in buckets.items():
        flat = torch.cat([items[i][0].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=red[op], group=mesh.group)
        at = 0
        for i in idx:
            t = items[i][0]
            out[i] = flat[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
    return out


def _float_key(x: torch.Tensor, op: str) -> torch.Tensor:
    """float32 → int32 keys in the values' order; NaN below (min) or above
    (max) every value, so it wins as jnp's min / max lets it."""
    b = x.view(torch.int32)
    key = torch.where(b >= 0, b, b ^ 0x7fffffff)
    nan = _I32.min if op == "min" else _I32.max
    return torch.where(torch.isnan(x), nan, key)


def _key_float(key: torch.Tensor, op: str) -> torch.Tensor:
    nan = _I32.min if op == "min" else _I32.max
    b = torch.where(key >= 0, key, key ^ 0x7fffffff)
    return torch.where(key == nan, float("nan"), b.view(torch.float32))


def _shard(a, lo: int, hi: int, per: int, fill=0) -> np.ndarray:
    """Rows [lo, hi) of a host array, padded to `per` rows with `fill`."""
    a = np.asarray(a)
    part = a[lo:hi]
    if part.shape[0] == per:
        return np.ascontiguousarray(part)
    out = np.full((per,) + a.shape[1:], fill, dtype=a.dtype)
    out[:part.shape[0]] = part
    return out


def distributed_grouped_aggregate(
    gids: np.ndarray, mask: np.ndarray, ts: np.ndarray,
    values: Sequence[np.ndarray], col_masks: Sequence[np.ndarray] = (), *,
    num_groups: int, ops: Sequence[str], mesh: Mesh,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Mesh-sharded twin of ops.kernels.grouped_aggregate.

    Pads rows to a multiple of the mesh size (padding is masked out),
    gives each rank its slice of the flattened (region, block) axes, folds
    it with the grouped-moments kernel and reduces the partial moments
    over the process group. Collective: every rank passes the same host
    inputs. Results and counts come back replicated, on `mesh.device`."""
    check_i64_safe(ts, what="distributed_grouped_aggregate ts")
    check_i64_safe(*values, what="distributed_grouped_aggregate values")
    for op in ops:
        if op not in AGG_OPS:
            raise ValueError(f"unsupported agg op: {op}")
    n = int(np.asarray(gids).shape[0])
    total = pad_rows_to_multiple(max(n, mesh.size), mesh.size)
    per = total // mesh.size
    lo = mesh.rank * per
    hi = min(lo + per, n)
    dev = mesh.device

    def put(a, dtype=None, fill=0):
        a = _shard(a, lo, hi, per, fill)
        t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype or _narrow_dtype(t.dtype)) \
            .contiguous()

    g = put(np.asarray(gids).astype(np.int32))
    m = put(np.asarray(mask, dtype=bool), torch.bool, False)
    t = put(ts, torch.int32)
    # a column passed for several ops moves to the device once
    on = {}
    cols = [on[id(v)] if id(v) in on else on.setdefault(id(v), put(v))
            for v in values]
    cmasks = [put(np.asarray(c, dtype=bool), torch.bool, False)
              for c in col_masks]
    has_cm = bool(cmasks)
    G = int(num_groups)

    def agg_mask(i):
        return m & cmasks[i] if has_cm else m

    # stddev / variance: the shift is the mean over every shard's counted
    # rows, so every shard centers alike
    var_cols = [i for i, op in enumerate(ops) if op in ("stddev", "variance")]
    shifts = {}
    if var_cols:
        parts = []
        for i in var_cols:
            mi = agg_mask(i)
            colf = cols[i].to(torch.float32).to(torch.float64)
            parts.append(torch.stack([torch.where(mi, colf, 0.0).sum(),
                                      mi.sum().to(torch.float64)]))
        (tot,) = all_reduce_many(mesh, [(torch.stack(parts), "sum")])
        for j, i in enumerate(var_cols):
            shifts[i] = (tot[j, 0] / tot[j, 1].clamp(min=1.0)).to(
                torch.float32)

    k_ops, k_vals, k_masks, seen = [], [], [], {}

    def moment(op, i, col=None, key=None):
        k = (op, -1 if op == "count" and not has_cm else i, key)
        if k not in seen:
            seen[k] = len(k_ops)
            k_ops.append(op)
            k_vals.append(_kernel_column(cols[i]) if col is None else col)
            k_masks.append(cmasks[i] if has_cm else None)
        return seen[k]

    plan = []
    for i, op in enumerate(ops):
        if op in ("count", "sum", "min", "max"):
            plan.append((op, i, moment(op, i)))
        elif op in ("first", "last"):
            plan.append((op, i, moment(f"{op}_key", i)))
        elif op == "avg":
            plan.append((op, i, moment("sum", i), moment("count", i)))
        else:
            mi = agg_mask(i)
            d = torch.where(mi, cols[i].to(torch.float32) - shifts[i],
                            0.0).contiguous()
            plan.append((op, i, moment("sum", i, d, "d"),
                         moment("sum_sq", i, d, "d"), moment("count", i)))
    res, counts = grouped_moments(g, m, t, k_vals, k_masks, k_ops,
                                  num_groups=G, row_base=lo)

    # one reduction per moment: how it reduces and how it comes back
    items, back = [], []
    for j, (op, x) in enumerate(zip(k_ops, res)):
        if op == "sum" and not x.dtype.is_floating_point:
            items.append((x.to(torch.int64), "sum"))
            back.append(lambda r: ((r + 2**31) % 2**32 - 2**31).to(
                torch.int32))
        elif op in ("min", "max") and x.dtype.is_floating_point:
            items.append((_float_key(x, op), op))
            back.append(lambda r, op=op: _key_float(r, op))
        elif op in ("min", "max"):
            items.append((x, op))
            back.append(lambda r: r)
        elif op.endswith("_key"):
            items.append((x, "min"))
            back.append(lambda r: r)
        else:
            items.append((x, "sum"))
            back.append(lambda r: r)
    items.append((counts, "sum"))
    red = all_reduce_many(mesh, items)
    moments = [f(r) for f, r in zip(back, red[:-1])]
    counts = red[-1]

    # first / last: the owner of each winning row sends its value
    picks = [(op, i, idx[0]) for op, i, *idx in plan
             if op in ("first", "last")]
    if picks:
        contrib = []
        for op, i, j in picks:
            key = moments[j]
            found = key != _I64_MAX
            local = torch.where(found, key % 2**32 - lo, -1)
            own = (local >= 0) & (local < hi - lo)
            col = _kernel_column(cols[i])
            val = col[local.clamp(0, max(per - 1, 0))] if per else \
                torch.zeros_like(key, dtype=col.dtype)
            contrib.append((torch.where(own, val, torch.zeros(
                (), dtype=col.dtype, device=dev)), "sum"))
        owned = dict(zip([j for _, _, j in picks],
                         all_reduce_many(mesh, contrib)))

    results = []
    for op, i, *idx in plan:
        dt = cols[i].dtype
        if op in ("first", "last"):
            key = moments[idx[0]]
            empty = float("nan") if dt.is_floating_point else 0
            r = torch.where(key != _I64_MAX, owned[idx[0]],
                            torch.tensor(empty, dtype=owned[idx[0]].dtype,
                                         device=dev))
            results.append(r.to(dt))
        elif len(idx) == 1:
            r = moments[idx[0]]
            results.append(r if op == "count" else r.to(dt))
        elif op == "avg":
            results.append(_avg(moments[idx[0]], moments[idx[1]]))
        else:
            results.append(_variance(op, *(moments[j] for j in idx)))
    return tuple(results), counts
