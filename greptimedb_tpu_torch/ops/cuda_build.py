"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes. Nothing is built
when a module is imported: the first launch of a kernel builds its
library into `csrc/build/` (ignored by git), named by a hash of the
source and flags so an edit rebuilds, and later processes reuse it.
A missing nvcc or a failed compile raises; there is no fallback.

`count_launch` is where every kernel wrapper counts a launch: the
datanodes' pool threads launch concurrently, so the counts move under
one lock, where the race detector (devtools/greptsan) watches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

from ..common.locks import TrackedLock, TrackedRLock
from ..common.tracking import tracked_state
from ..errors import KernelError
from ..utils import atomic_publish

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: re-entrant: load() holds it across build(), which takes it again
#: to record build_info
_lock = TrackedRLock("ops.cuda_build")
_libs: Dict[str, ctypes.CDLL] = {}
#: per source: seconds the build took in this process (0.0 when an
#: existing library was reused) and nvcc's output (ptxas register and
#: shared-memory report)
build_info: Dict[str, dict] = tracked_state({}, "ops.cuda_build.build_info")

_launch_lock = TrackedLock("ops.launches")
#: the launch counts as the race detector sees them: written with each
#: wrapper's `launches` under _launch_lock, so a count that moved outside
#: it would show as a race
_launch_view: Dict[str, int] = tracked_state({}, "ops.launches")


def count_launch(wrapper) -> None:
    """One launch of `wrapper`'s kernel: `wrapper.launches += 1`."""
    with _launch_lock:
        wrapper.launches += 1
        _launch_view[wrapper.__name__] = wrapper.launches


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.access(path, os.X_OK):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise KernelError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use")
    return path


def _lib_path(name: str, src: str, flags: List[str]) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into a shared library (unless a current one
    exists) and return its path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = _lib_path(name, src, NVCC_FLAGS)
    if os.path.exists(out):
        with _lock:
            build_info.setdefault(name, {"seconds": 0.0, "log": "",
                                         "path": out})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed building {src} "
                          f"(exit {proc.returncode}):\n{log}")
    atomic_publish(tmp, out, fsync=False)   # concurrent builds agree
    with _lock:
        build_info[name] = {"seconds": secs, "log": log, "path": out}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(build(name))
                _libs[name] = lib
    return lib
