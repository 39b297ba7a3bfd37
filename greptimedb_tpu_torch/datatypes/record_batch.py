"""RecordBatch: a schema + equal-length vectors.

Reference behavior: src/common/recordbatch/src/ — the unit of data flowing
between scan, compute and protocol layers. Interops with pyarrow for
Parquet/Flight/IPC, and exposes the SoA numpy view the device path consumes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import pyarrow as pa

from .schema import Schema
from .vector import Vector


class RecordBatch:
    def __init__(self, schema: Schema, columns: Sequence[Vector]):
        assert len(schema) == len(columns), \
            f"schema has {len(schema)} cols, got {len(columns)} vectors"
        lens = {len(c) for c in columns}
        assert len(lens) <= 1, f"ragged columns: {lens}"
        self.schema = schema
        self.columns: List[Vector] = list(columns)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, idx_or_name) -> Vector:
        if isinstance(idx_or_name, str):
            return self.columns[self.schema.column_index(idx_or_name)]
        return self.columns[idx_or_name]

    # ---- constructors ----
    @staticmethod
    def from_pydict(schema: Schema, data: Dict[str, Sequence[Any]]) -> "RecordBatch":
        cols = []
        for c in schema.column_schemas:
            v = data[c.name]
            if not isinstance(v, (list, np.ndarray)):
                v = list(v)
            cols.append(Vector.from_pylist(v, c.dtype))
        return RecordBatch(schema, cols)

    @staticmethod
    def empty(schema: Schema) -> "RecordBatch":
        return RecordBatch(schema, [Vector.from_pylist([], c.dtype)
                                    for c in schema.column_schemas])

    @staticmethod
    def from_arrow(batch: pa.RecordBatch | pa.Table,
                   schema: Optional[Schema] = None) -> "RecordBatch":
        if schema is None:
            schema = Schema.from_arrow(batch.schema)
        cols = [Vector.from_arrow(batch.column(i)) for i in range(batch.num_columns)]
        return RecordBatch(schema, cols)

    # ---- conversions ----
    def to_arrow(self) -> pa.RecordBatch:
        return pa.RecordBatch.from_arrays(
            [c.to_arrow() for c in self.columns], schema=self.schema.to_arrow())

    def to_pydict(self) -> Dict[str, list]:
        return {c.name: v.to_pylist()
                for c, v in zip(self.schema.column_schemas, self.columns)}

    def to_pylist(self) -> List[dict]:
        cols = self.to_pydict()
        names = self.schema.names()
        return [dict(zip(names, row)) for row in zip(*[cols[n] for n in names])]

    def rows(self) -> Iterable[tuple]:
        lists = [c.to_pylist() for c in self.columns]
        return zip(*lists) if lists else iter(())

    # ---- ops ----
    def project(self, names: Sequence[str]) -> "RecordBatch":
        idxs = [self.schema.column_index(n) for n in names]
        return RecordBatch(self.schema.project(names), [self.columns[i] for i in idxs])

    def slice(self, start: int, length: int) -> "RecordBatch":
        return RecordBatch(self.schema, [c.slice(start, length) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "RecordBatch":
        return RecordBatch(self.schema, [c.filter(mask) for c in self.columns])

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch(self.schema, [c.take(indices) for c in self.columns])

    @staticmethod
    def concat(batches: Sequence["RecordBatch"]) -> "RecordBatch":
        assert batches, "cannot concat zero batches"
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        cols = [Vector.concat([b.columns[i] for b in batches])
                for i in range(len(schema))]
        return RecordBatch(schema, cols)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RecordBatch[{self.num_rows}x{self.num_columns}]"


def pretty_print(batches: Sequence[RecordBatch]) -> str:
    """Render batches as an ASCII table (for CLI / sqlness-style tests)."""
    if not batches:
        return "(empty)"
    schema = batches[0].schema
    names = schema.names()
    rows: List[List[str]] = []
    for b in batches:
        for row in b.rows():
            rows.append(["NULL" if v is None else _fmt(v, schema.column_schemas[i])
                         for i, v in enumerate(row)])
    widths = [len(n) for n in names]
    for r in rows:
        for i, v in enumerate(r):
            widths[i] = max(widths[i], len(v))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep, "|" + "|".join(f" {n:<{w}} " for n, w in zip(names, widths)) + "|", sep]
    for r in rows:
        out.append("|" + "|".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def arrow_to_ingest_columns(tbl: pa.Table | pa.RecordBatch,
                            schema: Schema,
                            extra: str = "drop") -> Dict[str, Any]:
    """Arrow table → ingest columns shaped for the bulk-load fast path.

    The raw path in Region.bulk_ingest skips all per-value validation
    when every column arrives as a typed ndarray, so this converter
    keeps columns in columnar form end to end: timestamps cast to the
    schema unit and viewed as int64, numerics handed over zero-copy
    when null-free, string tags as one object array. Only null-bearing
    numeric columns fall back to python lists (Nones carry validity
    through the validating WriteBatch path). Columns absent from the
    schema are dropped by default (reference: COPY FROM column pruning,
    src/operator/src/statement/copy_table_from.rs); extra="keep" passes
    them through as python lists for auto-ALTER ingest paths."""
    out: Dict[str, Any] = {}
    for name in tbl.schema.names:
        col = tbl.column(name)
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if not schema.contains(name):
            if extra == "keep":
                # unknown columns survive as python lists so the caller's
                # auto-ALTER sees them (the Flight bulk path matches
                # insert()'s create/alter-on-demand contract)
                out[name] = col.to_pylist()
            continue
        cs = schema.column_schema(name)
        if cs.dtype.is_string or cs.dtype.is_binary:
            if pa.types.is_dictionary(col.type):
                col = col.dictionary_decode()
            out[name] = col.to_numpy(zero_copy_only=False)
        elif cs.dtype.is_timestamp:
            # cast to the schema unit FIRST (to_pylist of a timestamp
            # column yields datetime objects the validating path cannot
            # cast; int64 epoch values round-trip for both branches)
            want = cs.dtype.pa_type
            if col.type != want:
                col = col.cast(want)
            ints = col.cast(pa.int64())
            out[name] = ints.to_pylist() if col.null_count \
                else np.asarray(ints, dtype=np.int64)
        elif col.null_count:
            # Nones must survive into the validating path (numpy would
            # silently coerce them to NaN for float dtypes)
            out[name] = col.to_pylist()
        else:
            want = cs.dtype.np_dtype
            arr = col.to_numpy(zero_copy_only=False)
            if want is not None and arr.dtype != want:
                arr = arr.astype(want)
            out[name] = arr
    return out


def _fmt(v: Any, col) -> str:
    if col.dtype.is_timestamp:
        from ..common.time import Timestamp
        return Timestamp(v, col.dtype.time_unit).to_datetime().strftime(
            "%Y-%m-%dT%H:%M:%S.%f")[:-3]
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    return str(v)
