"""Region-level series dictionary: tag tuples ↔ dense series ids.

The TPU-first analogue of the reference's row keys (BTree keys in
src/storage/src/memtable/btree.rs): every distinct combination of tag values
gets a dense int32 `series_id`. Ids are insertion-ordered and append-only, so
they stay stable across flushes — SSTs persist series ids alongside tag
values, and the dictionary snapshot is persisted via the manifest so a
reopened region keeps the same mapping. All group-by/merge/window kernels
operate on these ids; strings never reach the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datatypes import Schema
from ..ops.dictionary import Dictionary


class SeriesDict:
    def __init__(self, tag_names: Sequence[str]):
        self.tag_names = list(tag_names)
        self.tag_dicts: List[Dictionary] = [Dictionary() for _ in self.tag_names]
        self.series = Dictionary()          # tuple(tag ids) -> series id
        self._series_rows: List[Tuple[int, ...]] = []  # series id -> tag ids
        # decode_tag_column staging (per tag): (num_series, id column,
        # num_values, values array) — rebuilt only when the dictionary grew
        self._decode_cache: Dict[int, Tuple[int, np.ndarray, int,
                                            np.ndarray]] = {}

    @property
    def num_series(self) -> int:
        return len(self.series)

    def encode_rows(self, tag_columns: Sequence[Sequence]) -> np.ndarray:
        """tag_columns: one sequence per tag (aligned rows) → series ids."""
        if not self.tag_names:
            return np.zeros(len(tag_columns[0]) if tag_columns else 0, np.int32)
        n = len(tag_columns[0])
        ids_per_tag = [d.encode(col) for d, col in zip(self.tag_dicts, tag_columns)]
        series = self.series
        rows = self._series_rows
        if n > 1024:
            # dedup tag-id combinations first: the per-row dict walk then
            # touches each distinct series once. Combinations pack into
            # ONE int64 key hashed by pandas factorize — O(n), no sort
            # (np.unique(axis=0) argsorts a structured view: 2.6s per 2M
            # rows; this path is ~50ms)
            bits = [max((int(ids.max()) + 1).bit_length(), 1)
                    for ids in ids_per_tag]
            if sum(bits) <= 63:
                import pandas as pd
                if len(ids_per_tag) == 1:
                    key = ids_per_tag[0].astype(np.int64)
                else:
                    key = np.zeros(n, np.int64)
                    for ids, b in zip(ids_per_tag, bits):
                        key = (key << b) | ids.astype(np.int64)
                # run-collapse first: series-grouped loader batches turn
                # the per-row factorize into one over run starts (int
                # adjacency compare is ~50x cheaper than hashing)
                flags = np.empty(n, dtype=bool)
                flags[0] = True
                np.not_equal(key[1:], key[:-1], out=flags[1:])
                starts = np.nonzero(flags)[0]
                lens = None
                if len(starts) * 16 <= n:
                    lens = np.diff(starts, append=n)
                    key = key[starts]
                codes, uniques = pd.factorize(key, sort=False)
                sids_u = np.empty(len(uniques), dtype=np.int32)
                for k, u in enumerate(uniques):
                    if len(ids_per_tag) == 1:
                        key_t = (int(u),)
                    else:
                        rem = int(u)
                        rev: List[int] = []
                        for b in reversed(bits):
                            rev.append(rem & ((1 << b) - 1))
                            rem >>= b
                        key_t = tuple(reversed(rev))
                    sid = series.get(key_t)
                    if sid is None:
                        sid = series.get_or_insert(key_t)
                        rows.append(key_t)
                    sids_u[k] = sid
                out = sids_u[codes].astype(np.int32, copy=False)
                return np.repeat(out, lens) if lens is not None else out
            mat = np.stack(ids_per_tag, axis=1)
            uniq, inv = np.unique(mat, axis=0, return_inverse=True)
            sids_u = np.empty(len(uniq), dtype=np.int32)
            for k, row in enumerate(uniq):
                key = tuple(int(x) for x in row)
                sid = series.get(key)
                if sid is None:
                    sid = series.get_or_insert(key)
                    rows.append(key)
                sids_u[k] = sid
            return sids_u[inv.reshape(-1)].astype(np.int32, copy=False)
        out = np.empty(n, dtype=np.int32)
        for i in range(n):
            key = tuple(int(ids[i]) for ids in ids_per_tag)
            sid = series.get(key)
            if sid is None:
                sid = series.get_or_insert(key)
                rows.append(key)
            out[i] = sid
        return out

    def encode_zero_tags(self, n: int) -> np.ndarray:
        """For tables without tags: every row is series 0."""
        if self.series.get(()) is None:
            self.series.get_or_insert(())
            self._series_rows.append(())
        return np.zeros(n, dtype=np.int32)

    def _decode_staging(self, tag_index: int):
        """[num_series] tag-id column + values array for one tag, cached;
        rebuilt only when the dictionary grew (ids are append-only)."""
        d = self.tag_dicts[tag_index]
        rows = self._series_rows
        cached = self._decode_cache.get(tag_index)
        if cached is None or cached[0] != len(rows) or cached[2] != len(d):
            col = np.fromiter((r[tag_index] for r in rows), np.int32,
                              len(rows))
            vals = np.asarray(d.values(), dtype=object)
            cached = (len(rows), col, len(d), vals)
            self._decode_cache[tag_index] = cached
        return cached[1], cached[3]

    def decode_tag_column(self, series_ids: np.ndarray, tag_index: int) -> List:
        d = self.tag_dicts[tag_index]
        rows = self._series_rows
        n = len(series_ids)
        if n > 1024 and rows:
            # gather through the [num_series] id column + values array
            # instead of a per-row Python walk
            col, vals = self._decode_staging(tag_index)
            sids = np.asarray(series_ids, dtype=np.int64)
            return vals[col[sids]].tolist()
        return [d.value(rows[int(s)][tag_index]) for s in series_ids]

    def tag_id_column(self, series_ids: np.ndarray, tag_index: int
                      ) -> Tuple[np.ndarray, list]:
        """(per-row tag value ids, dictionary values) — lets the SST
        writer build an arrow DictionaryArray directly instead of
        materializing and re-encoding the string column."""
        col, _ = self._decode_staging(tag_index)
        sids = np.asarray(series_ids, dtype=np.int64)
        return col[sids] if len(col) else np.zeros(len(sids), np.int32), \
            self.tag_dicts[tag_index].values()

    def series_tag_matrix(self) -> np.ndarray:
        """[num_series, num_tags] per-tag value ids — the device-side mapping
        for group-by over a subset of tags."""
        if not self._series_rows:
            return np.zeros((0, len(self.tag_names)), dtype=np.int32)
        return np.asarray(self._series_rows, dtype=np.int32)

    def tag_value_id(self, tag_index: int, value) -> Optional[int]:
        return self.tag_dicts[tag_index].get(value)

    def sids_for_value_ids(self, tag_index: int,
                           value_ids: Sequence[int]) -> np.ndarray:
        """Sorted series ids whose tag at `tag_index` takes any of the
        given dictionary value ids — the inverted (tag value → series)
        lookup behind per-SST index pruning: one vectorized pass over
        the [num_series] staging column, no per-row work."""
        if not value_ids or not self._series_rows:
            return np.zeros(0, dtype=np.int32)
        col, _ = self._decode_staging(tag_index)
        hits = np.isin(col, np.asarray(list(value_ids), dtype=np.int32))
        return np.nonzero(hits)[0].astype(np.int32)

    def sids_for_tag_values(self, tag_index: int,
                            values: Sequence) -> np.ndarray:
        """Sorted series ids whose tag equals any of `values` exactly —
        values absent from the dictionary match nothing (a point query
        for a never-seen tag value resolves to the empty set, which
        prunes every file)."""
        ids = [self.tag_dicts[tag_index].get(v) for v in values]
        return self.sids_for_value_ids(
            tag_index, [i for i in ids if i is not None])

    # ---- persistence ----
    def to_dict(self) -> dict:
        return {
            "tag_names": self.tag_names,
            "tag_values": [d.to_list() for d in self.tag_dicts],
            "series": [list(t) for t in self._series_rows],
        }

    @staticmethod
    def from_dict(d: dict) -> "SeriesDict":
        sd = SeriesDict(d["tag_names"])
        sd.tag_dicts = [Dictionary.from_list(vals) for vals in d["tag_values"]]
        for row in d["series"]:
            key = tuple(row)
            sd.series.get_or_insert(key)
            sd._series_rows.append(key)
        return sd

    @staticmethod
    def for_schema(schema: Schema) -> "SeriesDict":
        return SeriesDict(schema.tag_names())
