"""file-table-engine: immutable external-file tables.

Reference behavior: src/file-table-engine — `ImmutableFileTableEngine`
serves read-only tables whose data lives in CSV/JSON/Parquet files on the
object store (engine/immutable.rs:449); the format/location come from
table options (table/format.rs), a small table manifest persists the
metadata (manifest.rs), and inserts are rejected.

    CREATE EXTERNAL TABLE logs (ts TIMESTAMP TIME INDEX, msg STRING)
      WITH (location='data/logs.parquet', format='parquet');
"""

from .engine import ImmutableFileTable, ImmutableFileTableEngine

__all__ = ["ImmutableFileTable", "ImmutableFileTableEngine"]
