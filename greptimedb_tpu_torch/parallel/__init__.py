"""Distributed execution over torch.distributed process groups.

The port of greptimedb_tpu/parallel/. The reference places table regions
on datanodes and, within one program, shards a query over a
`jax.sharding.Mesh` with two axes; here the same two axes lay out the
ranks of a process group (mesh.py):

- ``region`` axis — the cross-host axis: table regions (horizontal
  partitions) live on different hosts; cross-region partial aggregates
  reduce over it.
- ``block`` axis — the within-host axis: rows within a region are blocked
  over the devices of one host.

Collectives are torch.distributed's (all_reduce, all_gather, point-to-
point sends): NCCL between GPUs, gloo between CPU ranks. Each rank folds
its shard with the port's kernels (the grouped-moments kernel, the
window-bounds kernel K1). launch.py spawns a group of ranks on one
machine.
"""

from .mesh import (
    make_mesh,
    pad_rows_to_multiple,
    ROW_AXES,
)
from .aggregate import distributed_grouped_aggregate
from .window import (
    series_sharded_range_aggregate,
    time_blocked_window_sum,
)

__all__ = [
    "make_mesh",
    "pad_rows_to_multiple",
    "ROW_AXES",
    "distributed_grouped_aggregate",
    "series_sharded_range_aggregate",
    "time_blocked_window_sum",
]
