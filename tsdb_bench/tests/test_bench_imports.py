"""Nothing that the benchmark runs loads JAX or the JAX package (names
compared whole, by the part before the first dot: the port's name
begins with the JAX package's), the reference loads nothing of the
program, and a client loads no torch."""

import ast
import glob
import json
import os
import subprocess
import sys

from tsdb_bench.run import FORBIDDEN

RUN_SMALL = r"""
import json, sys
sys.path.insert(0, {root!r})
from tsdb_bench import run
from greptimedb_tpu_torch.query import tpu_exec
tpu_exec._dispatch_min_rows = lambda: 0
from tsdb_bench.tests.conftest import load_bench
bench = load_bench({root!r}, kept_out=True)
for name in ("tsbs-4000.dashboard", "tsbs-4000-4r.dashboard"):
    cell = run.Cell({root!r}, bench, name)
    cell.cfg = dict(cell.cfg, hosts=16, hours=12)
    out = run.run_cell({root!r}, cell, 3, 1.5, trace=True, device="cpu")
    assert out["correct"], out["checks"]
for m in bench["end_to_end"] + bench["per_layer"]:
    run.metric_reader({root!r}, m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(code: str, root: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(root):
    mods = top_level_after(RUN_SMALL.format(root=root), root)
    assert "greptimedb_tpu_torch" in mods and "torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program(root):
    code = ("import json, sys; import tsdb_bench.reference, "
            "tsdb_bench.traffic, tsdb_bench.tsbs; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    mods = top_level_after(code, root)
    assert not mods & (set(FORBIDDEN) | {"greptimedb_tpu_torch", "torch"})


def test_client_loads_no_torch(root):
    code = ("import json, sys; import tsdb_bench.client; "
            "import greptimedb_tpu_torch.client.flight; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    mods = top_level_after(code, root)
    assert "torch" not in mods and not mods & set(FORBIDDEN)


def test_no_source_names_jax(root):
    for path in glob.glob(os.path.join(root, "tsdb_bench", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
    src = open(os.path.join(root, "tsdb_bench", "reference.py")).read()
    assert "greptimedb_tpu_torch" not in src.split('"""', 2)[2]
