"""Python coprocessor / UDF engine.

Reference behavior: src/script/src/python/ — the `@copr(args, returns,
sql=...)` decorator marks a Python function as a coprocessor
(ffi_types/copr.rs:40-120, decorator parse ffi_types/copr/parse.rs);
vectors bridge zero-copy into the script (ffi_types/vector.rs); scripts
persist in a `scripts` system table (table.rs:51) and register as UDFs
into the query engine (python/engine.rs:44-80). The reference needs a
RustPython/PyO3 VM to host Python; this framework *is* Python, so the
engine compiles scripts natively and hands them numpy vectors.

Ported from greptimedb_tpu/script/: the coprocessor namespace holds
`torch` where the reference's holds `jnp`, and a coprocessor body runs
under the frontend's device (`with torch.device(...)`), so the tensors
it makes land on the card.
"""

from .copr import copr, coprocessor, Coprocessor
from .engine import ScriptEngine

__all__ = ["copr", "coprocessor", "Coprocessor", "ScriptEngine"]
