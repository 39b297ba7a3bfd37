"""Guards on the port's boundaries.

- Importing the port's slice modules (and running queries through them on
  the CPU) adds no jax, greptimedb_tpu, pandas or pyarrow module to
  sys.modules. The check compares sys.modules before and after, in a
  subprocess, because the interpreter's site setup may import JAX first.
- No source file of the port imports any of them, and imports inside the
  package stay relative.
- An engine left on its default device ("cuda") raises on a machine
  without CUDA rather than running on the CPU; chip_smoke.py exits
  non-zero there and prints no result.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "greptimedb_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "greptimedb_tpu", "pandas", "pyarrow")
# one intra-op thread: the subprocesses share cores with parallel workers
_ENV = dict(os.environ, OMP_NUM_THREADS="1")

_PROBE = r"""
import json, sys
before = set(sys.modules)
import greptimedb_tpu_torch
import greptimedb_tpu_torch.common.time
import greptimedb_tpu_torch.errors
import greptimedb_tpu_torch.ops.cuda_build
import greptimedb_tpu_torch.ops.pallas_window
import greptimedb_tpu_torch.ops.window as win
import greptimedb_tpu_torch.promql
import greptimedb_tpu_torch.session
import greptimedb_tpu_torch.sql
from greptimedb_tpu_torch.promql import engine as eng
import numpy as np

ts = 1_700_000_000_000 + np.arange(0, 1_800_000, 15_000)
sm = win.SeriesMatrix.build(np.zeros(len(ts), int), ts,
                            np.arange(len(ts), dtype=float), 1)

class Mem(eng.PromqlEngine):
    def select(self, sel, lo, hi, ctx):
        return eng._Selection([{"__name__": "x"}], sm, int(ts[0]),
                              int(ts[-1]))

e = Mem(None, device="cpu")
for q in ["rate(x[5m])", "max_over_time(x[5m])", "hour()", "x",
          "timestamp(x)"]:
    e.query_to_prom_json(q, int(ts[0]), int(ts[-1]), 60_000)
greptimedb_tpu_torch.common.time.parse_prom_time("2023-11-14T22:13:20Z")
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def test_port_imports_no_reference_or_storage_stack():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    new = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in new if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "greptimedb_tpu_torch.promql.engine" in new


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_sources_import_nothing_forbidden():
    seen = 0
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN, f"{path}: imports {name}"
                assert top != "greptimedb_tpu_torch", \
                    f"{path}: absolute import of {name}; keep it relative"
        seen += 1
    assert seen >= 10


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    from greptimedb_tpu_torch.ops import window as win
    from greptimedb_tpu_torch.promql import engine as eng
    import numpy as np
    ts = 1_700_000_000_000 + np.arange(0, 600_000, 15_000)
    sm = win.SeriesMatrix.build(np.zeros(len(ts), int), ts,
                                np.ones(len(ts)), 1)

    class Mem(eng.PromqlEngine):
        def select(self, sel, lo, hi, ctx):
            return eng._Selection([{"__name__": "x"}], sm, int(ts[0]),
                                  int(ts[-1]))

    e = Mem(None)
    assert e.device.type == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e.query_to_prom_json("rate(x[5m])", int(ts[0]), int(ts[-1]),
                             60_000)


def test_counts_leq_refuses_devices_it_has_no_kernel_for():
    from greptimedb_tpu_torch.ops import pallas_window as pw
    b = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pw.counts_leq(b, 4)


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_ENV, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr
