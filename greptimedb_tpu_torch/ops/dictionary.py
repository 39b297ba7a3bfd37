"""Host-side dictionary encoding for tag columns.

TPUs (and XLA generally) are hostile to string processing and dynamic hash
tables, so tag values are dictionary-encoded to dense int32 ids on the host
before touching the device. This mirrors the reference's observation that
high-cardinality group-by needs a dictionary/sort strategy rather than a hash
table (SURVEY.md §7 'hard parts'); the reference's row keys live in
src/storage/src/memtable/btree.rs — here the key space is a per-region
insertion-ordered dictionary, which is stable across flushes so SSTs and
memtables agree on ids.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np


class Dictionary:
    """Insertion-ordered value <-> dense id mapping."""

    __slots__ = ("_value_to_id", "_values")

    def __init__(self, values: Optional[Iterable[Hashable]] = None):
        self._value_to_id: Dict[Hashable, int] = {}
        self._values: List[Hashable] = []
        if values is not None:
            for v in values:
                self.get_or_insert(v)

    def __len__(self) -> int:
        return len(self._values)

    def get_or_insert(self, value: Hashable) -> int:
        i = self._value_to_id.get(value)
        if i is None:
            i = len(self._values)
            self._value_to_id[value] = i
            self._values.append(value)
        return i

    def get(self, value: Hashable) -> Optional[int]:
        return self._value_to_id.get(value)

    def value(self, i: int) -> Hashable:
        return self._values[i]

    def values(self) -> List[Hashable]:
        return list(self._values)

    def encode(self, values: Sequence[Hashable]) -> np.ndarray:
        """Encode values to int32 ids, inserting unseen values.

        Batches beyond a few hundred rows dedup through np.unique first so
        the per-value dict walk touches each distinct value once — ingest
        batches usually carry few distinct tags (TSBS: 100s of hosts across
        millions of rows). Loader batches additionally present rows grouped
        by tag (sorted ingest order), so a run-collapse pass — encode one
        value per run, np.repeat the ids back out — beats even the hash
        factorize ~5x; a strided sample gates the full adjacency pass so
        shuffled object columns (where elementwise != falls back to
        PyObject compares) never pay for it."""
        n = len(values)
        if n > 256:
            arr = values if isinstance(values, np.ndarray) \
                else np.asarray(values, dtype=object)
            out = self._encode_runs(arr)
            if out is not None:
                return out
            try:
                # hash-based dedup: ~5x faster than sorting on strings
                import pandas as pd
                inv, uniq = pd.factorize(arr, use_na_sentinel=False)
            except (TypeError, ValueError):
                uniq = None      # unhashable values
            if uniq is not None:
                ids_u = np.empty(len(uniq), dtype=np.int32)
                for i, v in enumerate(uniq.tolist()):
                    if isinstance(v, float) and v != v:
                        # factorize surfaces None as NaN; store the real
                        # None so ids stay stable across batches and the
                        # per-value path
                        v = None
                    ids_u[i] = self.get_or_insert(v)
                return ids_u[np.asarray(inv).reshape(-1)] \
                    .astype(np.int32, copy=False)
        out = np.empty(n, dtype=np.int32)
        get = self._value_to_id.get
        for i, v in enumerate(values):
            j = get(v)
            if j is None:
                j = self.get_or_insert(v)
            out[i] = j
        return out

    def _encode_runs(self, arr: np.ndarray) -> Optional[np.ndarray]:
        """Run-collapse fast path: when adjacent rows repeat (series-
        grouped loader batches), encode one value per run. Returns None
        when the sample says runs won't pay, or the values don't support
        vectorized compare."""
        n = len(arr)
        probe = arr[:512]
        try:
            sample_runs = int(np.count_nonzero(probe[1:] != probe[:-1]))
        except Exception:  # noqa: BLE001 — e.g. unhashable/odd objects
            return None
        if sample_runs * 8 > len(probe):     # <8-row runs: not worth a pass
            return None
        flags = np.empty(n, dtype=bool)
        flags[0] = True
        np.not_equal(arr[1:], arr[:-1], out=flags[1:])
        starts = np.nonzero(flags)[0]
        if len(starts) * 16 > n:             # sample lied; fall back
            return None
        run_ids = np.empty(len(starts), dtype=np.int32)
        get = self._value_to_id.get
        for i, v in enumerate(arr[starts].tolist()):
            if isinstance(v, float) and v != v:
                v = None                     # match the factorize path's
            j = get(v)                       # NaN→None normalization
            if j is None:
                j = self.get_or_insert(v)
            run_ids[i] = j
        return np.repeat(run_ids, np.diff(starts, append=n))

    def encode_existing(self, values: Sequence[Hashable]) -> np.ndarray:
        """Encode without inserting; unseen values map to -1."""
        out = np.empty(len(values), dtype=np.int32)
        get = self._value_to_id.get
        for i, v in enumerate(values):
            out[i] = get(v, -1)
        return out

    def decode(self, ids: np.ndarray) -> List[Hashable]:
        vals = self._values
        return [vals[int(i)] for i in ids]

    def to_list(self) -> List[Hashable]:
        return list(self._values)

    @staticmethod
    def from_list(values: List[Hashable]) -> "Dictionary":
        return Dictionary(values)
