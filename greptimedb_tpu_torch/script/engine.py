"""Script engine: compile, persist, run, and SQL-register coprocessors.

Reference behavior: src/script/src/python/engine.rs:44-80 — `PyEngine`
compiles a script into a `PyScript`, exposes `execute` (optionally running
the copr's bound `sql` first to produce input vectors), and registers the
coprocessor as a UDF in the query engine; src/script/src/table.rs:51 —
scripts persist to a `scripts` system table keyed by (schema, name) so
they survive restarts. The script executes in a namespace pre-loaded with
`copr`/`coprocessor`, numpy and `torch` (the device path: a coprocessor
body written with torch ops runs on the frontend's device).

Ported from greptimedb_tpu/script/engine.py. Where the reference's
namespace holds `jnp`, whose arrays land on the TPU by default, the
port's holds `torch`, and `compile` binds each coprocessor to the
frontend's device (`frontend.query_engine.device`, "cuda" unless the
frontend was built for the CPU): its body runs under
`with torch.device(...)`, so `torch.as_tensor(x)` is a tensor on the
card. A tensor it returns is fetched once (`copr.as_vectors`) and typed
as the reference types numpy values (float → FLOAT64, int → INT64,
bool → BOOLEAN).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datatypes import data_type as dt
from ..datatypes.record_batch import RecordBatch
from ..datatypes.schema import ColumnSchema, Schema
from ..errors import GreptimeError, InvalidArgumentsError
from ..query.output import Output
from ..session import QueryContext
from .copr import Coprocessor, as_vectors, copr, coprocessor

logger = logging.getLogger(__name__)

SCRIPTS_TABLE = "scripts"


class ScriptEngine:
    """Owns compiled coprocessors + the scripts system table."""

    def __init__(self, frontend):
        self.frontend = frontend
        #: the device coprocessor bodies run under: the frontend's
        self.device = torch.device(frontend.query_engine.device)
        self._compiled: Dict[str, Coprocessor] = {}   # schema.name -> copr

    # ---- compile ----
    def compile(self, script: str,
                name: Optional[str] = None) -> Coprocessor:
        """Execute the script text; the (single) @copr function is the
        entry point (reference: parse.rs finds the decorated fn), bound
        to this engine's device."""
        namespace = {"copr": copr, "coprocessor": coprocessor,
                     "np": np, "numpy": np, "torch": torch}
        try:
            exec(compile(script, name or "<script>", "exec"), namespace)
        except SyntaxError as e:
            raise InvalidArgumentsError(f"script syntax error: {e}") from e
        coprs = [v for v in namespace.values()
                 if isinstance(v, Coprocessor)]
        if not coprs:
            raise InvalidArgumentsError(
                "script defines no @copr/@coprocessor function")
        for c in coprs:
            c.device = self.device
        if name is not None and len(coprs) > 1:
            named = [c for c in coprs if c.name == name]
            if named:
                return named[0]
        return coprs[0]

    # ---- persistence (scripts system table) ----
    def _ensure_scripts_table(self, ctx: QueryContext):
        from .. import DEFAULT_CATALOG_NAME
        table = self.frontend.catalog.table(
            DEFAULT_CATALOG_NAME, ctx.current_schema, SCRIPTS_TABLE)
        if table is not None:
            return table
        self.frontend.do_query(
            f"CREATE TABLE IF NOT EXISTS {SCRIPTS_TABLE} ("
            "schema_name STRING, name STRING, script STRING,"
            " engine STRING, timestamp TIMESTAMP TIME INDEX,"
            " PRIMARY KEY(schema_name, name))", ctx)
        return self.frontend.catalog.table(
            DEFAULT_CATALOG_NAME, ctx.current_schema, SCRIPTS_TABLE)

    def insert_script(self, name: str, script: str,
                      ctx: Optional[QueryContext] = None) -> None:
        """Compile (validating) + persist + register as a SQL UDF."""
        ctx = ctx or QueryContext()
        compiled = self.compile(script, name)
        table = self._ensure_scripts_table(ctx)
        table.insert({
            "schema_name": [ctx.current_schema], "name": [name],
            "script": [script], "engine": ["python"],
            "timestamp": [int(time.time() * 1000)]})
        self._register(ctx.current_schema, name, compiled)

    def _register(self, schema_name: str, name: str,
                  compiled: Coprocessor) -> None:
        self._compiled[f"{schema_name}.{name}"] = compiled
        from ..query.functions import register_udf
        register_udf(name, _udf_adapter(compiled))

    def load_scripts(self, ctx: Optional[QueryContext] = None) -> int:
        """Recompile + re-register every persisted script (restart path;
        reference recompiles from the scripts table on access)."""
        ctx = ctx or QueryContext()
        from .. import DEFAULT_CATALOG_NAME
        table = self.frontend.catalog.table(
            DEFAULT_CATALOG_NAME, ctx.current_schema, SCRIPTS_TABLE)
        if table is None:
            return 0
        n = 0
        for batch in table.scan_batches(
                projection=["schema_name", "name", "script"]):
            for schema_name, name, script in batch.rows():
                try:
                    self._register(schema_name, name,
                                   self.compile(script, name))
                    n += 1
                except GreptimeError:
                    logger.exception("failed to recompile script %s", name)
        return n

    def get_script(self, name: str,
                   ctx: Optional[QueryContext] = None) -> Optional[str]:
        ctx = ctx or QueryContext()
        from .. import DEFAULT_CATALOG_NAME
        table = self.frontend.catalog.table(
            DEFAULT_CATALOG_NAME, ctx.current_schema, SCRIPTS_TABLE)
        if table is None:
            return None
        for batch in table.scan_batches(
                projection=["schema_name", "name", "script"]):
            for schema_name, nm, script in batch.rows():
                if nm == name and schema_name == ctx.current_schema:
                    return script
        return None

    # ---- execution ----
    def run(self, name_or_script: str, params: Optional[Dict] = None,
            ctx: Optional[QueryContext] = None,
            is_script_text: bool = False) -> Output:
        ctx = ctx or QueryContext()
        if is_script_text:
            compiled = self.compile(name_or_script)
        else:
            key = f"{ctx.current_schema}.{name_or_script}"
            compiled = self._compiled.get(key)
            if compiled is None:
                script = self.get_script(name_or_script, ctx)
                if script is None:
                    raise GreptimeError(
                        f"script {name_or_script!r} not found")
                compiled = self.compile(script, name_or_script)
                self._register(ctx.current_schema, name_or_script, compiled)
        return self._execute(compiled, params or {}, ctx)

    def _execute(self, compiled: Coprocessor, params: Dict,
                 ctx: QueryContext) -> Output:
        args: List = []
        if compiled.sql:
            outputs = self.frontend.do_query(compiled.sql, ctx)
            out = outputs[-1]
            if not out.is_batches or not out.batches:
                raise GreptimeError("coprocessor sql returned no rows")
            batch = RecordBatch.concat(out.batches)
            cols = batch.to_pydict()
            for arg in compiled.arg_names:
                if arg not in cols:
                    raise InvalidArgumentsError(
                        f"coprocessor arg {arg!r} not in sql result "
                        f"columns {sorted(cols)}")
                args.append(np.asarray(cols[arg]))
        else:
            for arg in compiled.arg_names:
                if arg not in params:
                    raise InvalidArgumentsError(
                        f"missing coprocessor param {arg!r}")
                v = params[arg]
                args.append(np.asarray(v) if isinstance(v, (list, tuple))
                            else v)
        result = compiled(*args)
        names = compiled.output_names()
        vectors = as_vectors(result, len(names))
        schema = Schema([ColumnSchema(n, _np_dtype(v))
                         for n, v in zip(names, vectors)])
        rb = RecordBatch.from_pydict(
            schema, {n: np.asarray(v).tolist()
                     for n, v in zip(names, vectors)})
        return Output.record_batches([rb], schema)


def _np_dtype(arr: np.ndarray):
    kind = np.asarray(arr).dtype.kind
    if kind == "b":
        return dt.BOOLEAN
    if kind == "i":
        return dt.INT64
    if kind == "u":
        return dt.UINT64
    if kind == "f":
        return dt.FLOAT64
    return dt.STRING


def _udf_adapter(compiled: Coprocessor):
    """Expose a coprocessor as a scalar SQL function: its args come from
    the call site instead of the bound sql (reference: engine.rs registers
    each coprocessor as a DataFusion UDF)."""
    def call(*arrays):
        out = as_vectors(compiled(*[np.asarray(a) for a in arrays]),
                         len(compiled.output_names()))
        return out[0]
    return call
