"""A region scan's rows, as the query path receives them.

Reference behavior: src/storage/src/snapshot.rs — a snapshot scan
concatenates memtable and SST runs, unsorted, with each row's write
sequence and op type; readers merge and dedup before interpreting rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..datatypes import Schema
from .series import SeriesDict


@dataclass
class ScanData:
    """Concatenated unsorted runs from memtables + SSTs (SoA).

    Consumers run the merge/dedup (ops/kernels.py merge_dedup_numpy)
    before interpreting rows."""
    schema: Schema
    series_dict: SeriesDict
    series_ids: np.ndarray
    ts: np.ndarray
    seq: np.ndarray
    op_types: np.ndarray
    fields: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]

    @property
    def num_rows(self) -> int:
        return len(self.ts)
