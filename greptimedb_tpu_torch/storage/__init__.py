"""The single-region storage engine: WAL, memtables, Parquet SSTs,
manifest, compaction (reference: greptimedb_tpu/storage/). The query
path reads a region's `ScanData` (storage/region.py) through the series
dictionary (storage/series.py)."""

from .engine import StorageEngine, EngineConfig  # noqa: F401
from .region import Region, RegionDescriptor, ScanData  # noqa: F401
from .series import SeriesDict  # noqa: F401
from .write_batch import WriteBatch, Mutation  # noqa: F401
