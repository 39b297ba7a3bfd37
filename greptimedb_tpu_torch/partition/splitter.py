"""Row → region splitting for inserts and deletes.

Reference behavior: src/partition/src/splitter.rs:35-100 — `WriteSplitter`
computes a region number per row from the partition rule and groups rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .rule import PartitionRule


def split_rows(rule: Optional[PartitionRule],
               columns: Dict[str, Sequence],
               num_rows: int) -> Dict[int, np.ndarray]:
    """Return region number → row-index array.

    With no rule (single-region table) every row goes to region 0. Missing
    partition columns raise — the reference requires them on every insert
    (splitter.rs:46-80).
    """
    if rule is None:
        return {0: np.arange(num_rows)}
    pcols = rule.partition_columns()
    for c in pcols:
        if c not in columns:
            raise ValueError(f"insert missing partition column {c!r}")
    vals = [columns[c] for c in pcols]
    regions: Dict[int, List[int]] = {}
    for i in range(num_rows):
        r = rule.find_region(tuple(v[i] for v in vals))
        regions.setdefault(r, []).append(i)
    return {r: np.asarray(ix) for r, ix in regions.items()}
