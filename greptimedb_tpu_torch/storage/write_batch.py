"""WriteBatch: typed mutations with an Arrow IPC wire codec.

Reference behavior: src/storage/src/write_batch.rs — a batch of Put/Delete
mutations validated against the region schema, encoded as arrow-ipc for the
WAL payload. Deletes carry only the row key (tags + timestamp).
"""

from __future__ import annotations

import io
import json

import numpy as np
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import pyarrow as pa
import pyarrow.ipc as pa_ipc

from ..datatypes import RecordBatch, Schema
from ..errors import InvalidArgumentsError

OP_PUT = 0
OP_DELETE = 1


@dataclass
class Mutation:
    op_type: int               # OP_PUT | OP_DELETE
    data: RecordBatch          # puts: full row schema; deletes: key columns only


class WriteBatch:
    def __init__(self, schema: Schema):
        self.schema = schema
        self.mutations: List[Mutation] = []

    @property
    def num_rows(self) -> int:
        return sum(m.data.num_rows for m in self.mutations)

    def put(self, data: Dict[str, Sequence] | RecordBatch) -> None:
        rb = self._coerce_put(data)
        self.mutations.append(Mutation(OP_PUT, rb))

    def delete(self, keys: Dict[str, Sequence] | RecordBatch) -> None:
        rb = self._coerce_delete(keys)
        self.mutations.append(Mutation(OP_DELETE, rb))

    # ---- validation/coercion ----
    def _coerce_put(self, data) -> RecordBatch:
        if isinstance(data, RecordBatch):
            rb = data
            if rb.schema.names() != self.schema.names():
                raise InvalidArgumentsError(
                    f"put batch columns {rb.schema.names()} != region schema "
                    f"{self.schema.names()}")
            for a, b in zip(rb.schema.column_schemas, self.schema.column_schemas):
                if a.dtype != b.dtype:
                    raise InvalidArgumentsError(
                        f"column {a.name}: type {a.dtype} != {b.dtype}")
        else:
            n = None
            cols = {}
            for c in self.schema.column_schemas:
                if c.name in data:
                    vals = data[c.name]
                    if not isinstance(vals, (list, np.ndarray)):
                        vals = list(vals)
                    if n is None:
                        n = len(vals)
                    elif len(vals) != n:
                        raise InvalidArgumentsError(
                            f"ragged column {c.name}: {len(vals)} vs {n}")
                    cols[c.name] = vals
            if n is None:
                raise InvalidArgumentsError("empty put")
            for c in self.schema.column_schemas:
                if c.name not in cols:
                    v = c.create_default_vector(n)
                    if v is None:
                        raise InvalidArgumentsError(
                            f"missing non-null column without default: {c.name}")
                    cols[c.name] = v.to_pylist()
            rb = RecordBatch.from_pydict(self.schema, cols)
        for c, vec in zip(rb.schema.column_schemas, rb.columns):
            if not c.nullable and vec.null_count:
                raise InvalidArgumentsError(f"null in non-nullable column {c.name}")
        return rb

    def _key_schema(self) -> Schema:
        names = self.schema.tag_names() + [self.schema.timestamp_column.name]
        return self.schema.project(names)

    def _coerce_delete(self, keys) -> RecordBatch:
        ks = self._key_schema()
        if isinstance(keys, RecordBatch):
            if keys.schema.names() != ks.names():
                raise InvalidArgumentsError(
                    f"delete batch columns {keys.schema.names()} != key "
                    f"columns {ks.names()}")
            return keys
        missing = [c.name for c in ks.column_schemas if c.name not in keys]
        if missing:
            raise InvalidArgumentsError(f"delete missing key columns: {missing}")
        return RecordBatch.from_pydict(ks, {c.name: list(keys[c.name])
                                            for c in ks.column_schemas})

    # ---- codec (WAL payload) ----
    def encode(self) -> bytes:
        """[json header][arrow IPC stream with one batch per mutation]"""
        header = {
            "schema_version": self.schema.version,
            "ops": [m.op_type for m in self.mutations],
        }
        hdr = json.dumps(header).encode()
        buf = io.BytesIO()
        buf.write(len(hdr).to_bytes(4, "little"))
        buf.write(hdr)
        # one IPC stream per mutation group (schemas differ between put/delete)
        for m in self.mutations:
            sink = io.BytesIO()
            table = m.data.to_arrow()
            with pa_ipc.new_stream(sink, table.schema) as w:
                w.write_batch(table)
            payload = sink.getvalue()
            buf.write(len(payload).to_bytes(4, "little"))
            buf.write(payload)
        return buf.getvalue()

    @staticmethod
    def decode(data: bytes, schema: Schema) -> "WriteBatch":
        view = memoryview(data)
        hlen = int.from_bytes(view[:4], "little")
        header = json.loads(bytes(view[4:4 + hlen]))
        pos = 4 + hlen
        wb = WriteBatch(schema)
        for op in header["ops"]:
            plen = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
            payload = view[pos:pos + plen]
            pos += plen
            with pa_ipc.open_stream(pa.BufferReader(payload)) as r:
                table = r.read_all()
            batches = table.to_batches()
            rb_schema = Schema.from_arrow(table.schema)
            if batches:
                rb = RecordBatch.from_arrow(batches[0], rb_schema)
                if len(batches) > 1:
                    rb = RecordBatch.concat(
                        [rb] + [RecordBatch.from_arrow(b, rb_schema) for b in batches[1:]])
            else:
                rb = RecordBatch.empty(rb_schema)
            wb.mutations.append(Mutation(op, rb))
        wb._decoded_schema_version = header.get("schema_version", 0)
        return wb
