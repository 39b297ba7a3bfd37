"""The ("region", "block") mesh over a torch.distributed process group.

The reference builds a `jax.sharding.Mesh` over its devices
(greptimedb_tpu/parallel/mesh.py) and shards a query's rows over both
axes flattened. Here the mesh is a process group, one rank per device
(the rank's own GPU under NCCL, or the CPU under gloo when the caller
asks for it), laid out row-major: rank = region_index * block +
block_index, the order of the reference's `np.reshape(region, block)`.

Every API call over a mesh is collective, as a JAX multi-controller
program is: each rank passes the same global host inputs, takes its own
shard, and returns the reference's replicated (or gathered) result.
Without an initialised process group the mesh is (1, 1): this process
alone, with the same code path and no collective to run; inside a group
of one rank (NCCL on one card) the collectives run.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

# Mesh axis names. "region" is the cross-host axis regions shard over;
# "block" is the within-host axis row blocks shard over.
REGION_AXIS = "region"
BLOCK_AXIS = "block"
ROW_AXES = (REGION_AXIS, BLOCK_AXIS)


def _split_factor(n: int) -> Tuple[int, int]:
    """Factor n into (region, block) with region <= block, preferring a
    near-square split so both collectives axes get exercised."""
    best = (1, n)
    for r in range(1, math.isqrt(n) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


class Mesh:
    """A 2D ("region", "block") layout of a process group's ranks.

    `shape` maps axis name to size (the reference's `Mesh.shape`); `rank`
    and `coords` place this process; `device` is where its shard lives;
    `group` is the process group (None: the default group, or no group
    at all on a (1, 1) mesh built without one)."""

    axis_names = ROW_AXES

    def __init__(self, region: int, block: int, rank: int,
                 device: torch.device, group=None, distributed=False):
        self.shape: Dict[str, int] = {REGION_AXIS: region, BLOCK_AXIS: block}
        self.size = region * block
        self.rank = rank
        self.coords = divmod(rank, block)
        self.device = device
        self.group = group
        #: whether collectives run: a process group spans the mesh (a
        #: group of one rank runs them too, as NCCL on one card does)
        self.distributed = distributed

    def __repr__(self) -> str:
        return (f"Mesh(region={self.shape[REGION_AXIS]}, "
                f"block={self.shape[BLOCK_AXIS]}, rank={self.rank}, "
                f"device={self.device})")


def _rank_device(device, backend: Optional[str], rank: int) -> torch.device:
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available for "
                               f"device {device!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: CUDA is not available; the mesh runs on the "
                "rank's GPU unless asked for device='cpu' (gloo)")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL group needs CUDA devices, "
                         f"not {dev}")
    return dev


def make_mesh(region: Optional[int] = None, block: Optional[int] = None, *,
              group=None, device=None) -> Mesh:
    """Build a ("region", "block") mesh over the process group's ranks.

    With neither axis size given, factors the world size near-square, as
    the reference does. A world of 1 (or no initialised group) yields a
    (1, 1) mesh that runs the same code (with no collective when no
    group is initialised). `device`:
    the rank's own GPU unless "cpu" (gloo) is asked for; without CUDA the
    default raises. A mesh over a process group checks with two
    all-reduces that every rank built the same shape."""
    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size(group)
        rank = dist.get_rank(group)
        backend = dist.get_backend(group)
    else:
        if group is not None:
            raise ValueError("make_mesh: a group without an initialised "
                             "default process group")
        n, rank, backend = 1, 0, None
    if region is None and block is None:
        region, block = _split_factor(n)
    elif region is None:
        region = n // block
    elif block is None:
        block = n // region
    if region * block != n:
        raise ValueError(f"mesh {region}x{block} != {n} devices")
    dev = _rank_device(device, backend, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(region, block, rank, dev, group, distributed=backend
                is not None)
    if mesh.distributed:
        # every rank must agree on the layout; this also opens the group's
        # communicator before any point-to-point call
        shape = torch.tensor([region, block], dtype=torch.int64, device=dev)
        lo, hi = shape.clone(), shape.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        if not torch.equal(lo, hi):
            raise ValueError(f"make_mesh: ranks disagree on the mesh shape "
                             f"({lo.tolist()} .. {hi.tolist()})")
    return mesh


def pad_rows_to_multiple(n: int, multiple: int) -> int:
    """Rows per device must be equal across the mesh; round n up."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple
