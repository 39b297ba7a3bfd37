"""Datanode: the node role that hosts storage regions + a query engine.

Reference behavior: src/datanode/src/instance.rs:106-236 — wires object
store, WAL, storage engine, table engines, catalog, and query engine.
"""

from .instance import DatanodeInstance, DatanodeOptions

__all__ = ["DatanodeInstance", "DatanodeOptions"]
