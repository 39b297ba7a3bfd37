"""Table partitioning: range rules, write splitting, region pruning.

Reference behavior: src/partition — `PartitionRule` trait
(src/partition/src/partition.rs:30), `RangePartitionRule` over one column
(src/partition/src/range.rs:64), `RangeColumnsPartitionRule` over several
(src/partition/src/columns.rs:49), `WriteSplitter` routing insert/delete rows
to regions (src/partition/src/splitter.rs:35-100), and predicate-based
region pruning (`find_regions_by_filters`, src/partition/src/manager.rs:192).
"""

from .rule import (
    MAXVALUE,
    HashPartitionRule,
    PartitionRule,
    RangeColumnsPartitionRule,
    RangePartitionRule,
    rule_from_partitions,
)
from .splitter import split_rows

__all__ = [
    "MAXVALUE",
    "HashPartitionRule",
    "PartitionRule",
    "RangePartitionRule",
    "RangeColumnsPartitionRule",
    "rule_from_partitions",
    "split_rows",
]
