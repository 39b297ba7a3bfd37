"""Continuous rollup flows: streaming downsample with query rewrite.

The device analog of GreptimeDB's flow engine: `CREATE FLOW` registers
a standing aggregate over a source table; a background (or cooperative)
task folds newly-written rows past a per-region watermark into a rollup
sink table via the sorted-segment reducer (storage/downsample.py); the
query planner transparently re-targets compatible `GROUP BY date_bin`
queries at the 60x-smaller sink (flow/rewrite.py).

Ported from greptimedb_tpu/flow/. The folds run on the FlowManager's
device ("cuda" unless the caller asks for "cpu"). `KvFlowStore` (flow
specs in the meta kv) comes along for the distributed frontend, which the
port does not have yet: nothing wires it.
"""

from .manager import (FlowAgg, FlowManager, FlowSpec, KvFlowStore,
                      ObjectStoreFlowStore, compile_flow)

__all__ = ["FlowAgg", "FlowManager", "FlowSpec", "KvFlowStore",
           "ObjectStoreFlowStore", "compile_flow"]
