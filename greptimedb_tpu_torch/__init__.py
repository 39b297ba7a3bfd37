"""greptimedb_tpu_torch — the PyTorch / CUDA port of greptimedb_tpu.

The port runs the same engines in PyTorch on an NVIDIA Hopper GPU
(sm_90a). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a kernel written by hand for Hopper, built
from `csrc/` at first use (ops/cuda_build.py).

Ported so far: the PromQL engine (promql/) above its data-access seam
(`PromqlEngine.select`) and the window evaluation under it (ops/window.py,
ops/pallas_window.py); the SQL engine's SELECT path (sql/, query/), with
the sorted-segment moments of the aggregate fast path in ops/kernels.py
and csrc/segment_moments.cu; the single-region storage engine under it
(storage/: WAL, memtables, Parquet SSTs, manifest, compaction, with the
host substrate in utils/ and common/); and the standalone frontend over
it (frontend/, datanode/, the mito table engine in mito/, DDL procedures
in procedure/, partition rules in partition/, the durable catalog in
catalog/), with its observability (common/trace_store.py,
common/profiler.py, monitor/) and coprocessor scripts (script/), whose
bodies run on the frontend's device. The package never imports jax or
greptimedb_tpu; the PromQL
path imports torch and numpy only, the SQL path and the storage engine
also pandas and pyarrow (as the reference's do). Entry points run on the
GPU unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

DEFAULT_CATALOG_NAME = "greptime"
DEFAULT_SCHEMA_NAME = "public"
MITO_ENGINE = "mito"
