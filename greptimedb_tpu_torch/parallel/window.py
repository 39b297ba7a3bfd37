"""Sequence/series-parallel window evaluation over the mesh.

The port of greptimedb_tpu/parallel/window.py. The two long-context
strategies of the reference, over a process group:

- **series sharding**: each rank owns a slice of the series axis and
  evaluates windows for its series entirely locally with the port's
  single-device range functions (ops/window.py, whose window bounds are
  the hand-written K1 kernel on a CUDA tensor): no collective until the
  [S/size, T] slices are gathered back into [S, T];
- **time blocking**: the time axis is split into contiguous blocks over
  the block axis (series over the region axis); a window straddling a
  block boundary needs the tail of the previous block, which arrives as
  a halo from the left neighbour of the same region row (one
  point-to-point hop, never a broadcast); block 0's halo is the sum's
  zero or the min / max identity.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.window import (CUMSUM_OPS, GATHER_OPS, _rebase_i64_host,
                          range_aggregate_cumsum, range_aggregate_gather)
from .mesh import BLOCK_AXIS, REGION_AXIS, Mesh


def _range_dispatch(ts2d, val2d, lengths, t0, step, range_ms, *, op, nsteps,
                    maxw, param, param2, series_block):
    if op in CUMSUM_OPS:
        return range_aggregate_cumsum(ts2d, val2d, lengths, t0, step,
                                      range_ms, op=op, nsteps=nsteps,
                                      param=param)
    if op in GATHER_OPS:
        return range_aggregate_gather(ts2d, val2d, t0, step, range_ms, op=op,
                                      nsteps=nsteps, maxw=maxw, param=param,
                                      param2=param2,
                                      series_block=series_block)
    raise ValueError(f"unknown range op: {op}")


def _gather_rows(mesh: Mesh, part: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's equal [rows, ...] slice in rank order."""
    if not mesh.distributed:
        return part
    wire = part.to(torch.uint8) if part.dtype == torch.bool else part
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire.contiguous(), group=mesh.group)
    out = torch.cat(parts, dim=0)
    return out.to(torch.bool) if part.dtype == torch.bool else out


def series_sharded_range_aggregate(
    ts2d: np.ndarray, val2d: np.ndarray, lengths: np.ndarray,
    t0, step, range_ms, *, op: str, nsteps: int, mesh: Mesh,
    maxw: int = 128, param: float = 0.0, param2: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a range function with the series axis sharded over the
    mesh (collective: every rank passes the same host matrices).

    Host int64 timestamps are rebased once for the whole matrix (so every
    rank shares the base); the series axis is padded to a mesh multiple
    with the int32-max sentinel (padded series give ok=False rows that are
    sliced off). Returns (result [S, nsteps], ok [S, nsteps]) on
    `mesh.device`, replicated."""
    S = ts2d.shape[0]
    if S == 0:
        raise ValueError("series_sharded_range_aggregate: empty series axis")
    if isinstance(ts2d, np.ndarray) and ts2d.dtype == np.int64:
        ts2d, t0 = _rebase_i64_host(ts2d, t0, step, nsteps, range_ms)
    pad = (-S) % mesh.size if mesh.size > 1 else 0
    ts2d, val2d = np.asarray(ts2d), np.asarray(val2d)
    lengths = np.asarray(lengths)
    if pad:
        # the sentinel must fit the (possibly rebased-to-int32) ts dtype
        sentinel = np.iinfo(ts2d.dtype).max
        ts2d = np.pad(ts2d, ((0, pad), (0, 0)), constant_values=sentinel)
        val2d = np.pad(val2d, ((0, pad), (0, 0)))
        lengths = np.pad(lengths, (0, pad))
    per = (S + pad) // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a[rows]))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
        return t.to(mesh.device)

    # size the gather path's series blocking to the per-shard slice so
    # small shards don't pad up to the global default block of 128
    out, ok = _range_dispatch(
        put(ts2d), put(val2d), put(lengths), t0, step, range_ms, op=op,
        nsteps=nsteps, maxw=maxw, param=param, param2=param2,
        series_block=min(128, max(1, per)))
    return _gather_rows(mesh, out)[:S], _gather_rows(mesh, ok)[:S]


def _halo(mesh: Mesh, vals: torch.Tensor, halo: int, op: str
          ) -> torch.Tensor:
    """The last `halo` columns of the left neighbour's block (same region
    row), or block 0's identity: zero for sum/avg, ±inf for min/max."""
    S = vals.shape[0]
    nblocks = mesh.shape[BLOCK_AXIS]
    bi = mesh.coords[1]
    ident = {"min": float("inf"), "max": float("-inf")}.get(op, 0.0)
    left = torch.full((S, halo), ident, dtype=vals.dtype, device=vals.device)
    ops = []
    if bi + 1 < nblocks:
        ops.append(dist.P2POp(dist.isend, vals[:, -halo:].contiguous(),
                              mesh.rank + 1, group=mesh.group))
    if bi > 0:
        ops.append(dist.P2POp(dist.irecv, left, mesh.rank - 1,
                              group=mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return left


def _blocked_window(mesh: Mesh, vals: torch.Tensor, window: int, op: str
                    ) -> torch.Tensor:
    """Per rank: trailing-window reduce over a dense step grid with a halo
    of (window-1) columns from the left neighbour."""
    S, T = vals.shape
    halo = window - 1
    ext = torch.cat([_halo(mesh, vals, halo, op), vals], dim=1) \
        if halo > 0 else vals
    if op in ("sum", "avg"):
        acc = torch.promote_types(vals.dtype, torch.float32)
        cs = torch.cumsum(ext.to(acc), dim=1)
        csp = torch.cat([torch.zeros((S, 1), dtype=acc, device=vals.device),
                         cs], dim=1)
        out = csp[:, window:] - csp[:, :-window] if halo else \
            csp[:, 1:] - csp[:, :-1]
        if op == "avg":
            out = out / window
        return out.to(vals.dtype)
    if op in ("min", "max"):
        win = ext.unfold(1, window, 1)                     # [S, T, window]
        return win.amin(dim=2) if op == "min" else win.amax(dim=2)
    raise ValueError(f"unsupported blocked window op: {op}")


def time_blocked_window_sum(vals: np.ndarray, *, window: int, op: str = "sum",
                            mesh: Mesh) -> torch.Tensor:
    """Trailing-window reduce over a dense [series, steps] grid with the
    time axis sharded over the block axis (the downsampling inner loop).

    result[s, t] = op(vals[s, t-window+1 .. t]); leading steps treat
    out-of-range samples as 0 (sum/avg) or identity (min/max). The series
    axis shards over the region axis. Requires steps % block_axis == 0 and
    window-1 <= steps per block (one-hop halo). Collective; the result
    comes back whole on `mesh.device`."""
    region_n, block_n = mesh.shape[REGION_AXIS], mesh.shape[BLOCK_AXIS]
    vals = np.asarray(vals)
    S, T = vals.shape
    pad_s = (-S) % region_n
    if pad_s:
        vals = np.pad(vals, ((0, pad_s), (0, 0)))
    if T % block_n:
        raise ValueError(f"steps {T} not divisible by block axis {block_n}")
    if window - 1 > T // block_n:
        raise ValueError(f"window {window} exceeds one block + halo "
                         f"({T // block_n} steps/block)")
    sr, tb = (S + pad_s) // region_n, T // block_n
    ri, bi = mesh.coords
    part = torch.from_numpy(np.ascontiguousarray(
        vals[ri * sr:(ri + 1) * sr, bi * tb:(bi + 1) * tb]))
    if part.dtype == torch.float64:
        part = part.to(torch.float32)
    out = _blocked_window(mesh, part.to(mesh.device), window, op)
    if not mesh.distributed:
        return out[:S]
    parts = [torch.empty_like(out) for _ in range(mesh.size)]
    dist.all_gather(parts, out.contiguous(), group=mesh.group)
    grid = torch.cat([torch.cat(parts[r * block_n:(r + 1) * block_n], dim=1)
                      for r in range(region_n)], dim=0)
    return grid[:S]
