"""Self-monitoring: the database is its own monitoring store.

Reference behavior: GreptimeDB's `export_metrics` option ("export
metrics to self") — a per-node task periodically writes the process'
own Prometheus registry into ordinary time-series tables, so the
cluster's history is queryable with SQL/PromQL, rollable-up with flows,
and subject to the same retention/compaction as user data.

Ported from greptimedb_tpu/monitor/ over the port's registry and regions.
"""

from .scraper import (NODE_METRICS_TABLE, PRIVATE_SCHEMA,
                      REGION_HEAT_TABLE, SelfMonitor)

__all__ = ["SelfMonitor", "PRIVATE_SCHEMA", "NODE_METRICS_TABLE",
           "REGION_HEAT_TABLE"]
