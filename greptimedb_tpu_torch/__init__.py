"""greptimedb_tpu_torch — the PyTorch / CUDA port of greptimedb_tpu.

The port runs the same engines in PyTorch on an NVIDIA Hopper GPU
(sm_90a). Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas for the TPU is a kernel written by hand for Hopper, built
from `csrc/` at first use (ops/cuda_build.py).

Ported so far: the PromQL engine (promql/) above its data-access seam
(`PromqlEngine.select`) and the window evaluation under it (ops/window.py,
ops/pallas_window.py). The package imports torch and numpy only; it
never imports jax, greptimedb_tpu, pandas or pyarrow. Entry points run on
the GPU unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

DEFAULT_CATALOG_NAME = "greptime"
DEFAULT_SCHEMA_NAME = "public"
MITO_ENGINE = "mito"
