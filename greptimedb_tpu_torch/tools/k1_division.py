"""Times the fused window-bounds entry with each way of dividing by the
step, on one GPU.

    python3 -m greptimedb_tpu_torch.tools.k1_division

`counts_leq_grid_launch` (csrc/counts_leq.cu) divides q - 1 by the step
for every sample inside the grid: by a 32-bit multiply-shift when every
quotient it takes fits, else by a 64-bit division. This script builds two
variants of that source beside it, each changed in one place: the 64-bit
division forced (the selection never takes the multiply-shift), and a
plain 32-bit `/` in place of the multiply-shift. It holds each against
the plain PyTorch version (exact), then times the three and the bucket
entry, which divides nothing, at the PromQL main-path shape: [4000,
16384] int32 rebased timestamps, 8640 samples per row 10 s apart and the
rest pads, T = 2053 steps of 60 s. Times are CUDA events around 20
back-to-back launches over their count, in 5 interleaved rounds.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import pallas_window as pw

SELECT = "if (step < (1LL << 31) && top <= (1LL << 31)) {"
MUL_SHIFT = ("const unsigned d = g.step == 1 ? u : "
             "__umulhi(u, g.mul) >> g.shr;")
DIV32 = "const unsigned d = u / static_cast<unsigned>(g.step);"
PAD = np.iinfo(np.int32).max
S, L, N, T, T0, STEP = 4000, 16384, 8640, 2053, -300_000, 60_000


def _variants(src: str) -> dict:
    out = {"multiply-shift (committed)": src,
           "64-bit division forced": src.replace(SELECT, "if (false) {"),
           "plain 32-bit division": src.replace(MUL_SHIFT, DIV32)}
    for name, text in out.items():
        if name != "multiply-shift (committed)" and text == src:
            raise RuntimeError(f"{name}: the source no longer has the line "
                               f"this variant changes")
    return out


def _build_all(variants: dict) -> dict:
    """nvcc for every variant at once; the loaded libraries by name."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        cu = os.path.join(cuda_build.BUILD_DIR, f"k1_division_{i}.cu")
        so = os.path.join(cuda_build.BUILD_DIR, f"libk1_division_{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.counts_leq_grid_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.counts_leq_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
    return libs


def _batch_ms(fn, launches: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(launches):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / launches


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    with open(os.path.join(cuda_build.CSRC_DIR, "counts_leq.cu")) as f:
        libs = _build_all(_variants(f.read()))

    row = np.full(L, PAD, np.int32)
    row[:N] = np.arange(N, dtype=np.int32) * 10_000
    ts = torch.as_tensor(np.tile(row, (S, 1)), device="cuda")
    b = pw.step_buckets(ts, T0, STEP, T)
    want = pw.counts_leq_plain(b, T)
    out = torch.empty((S, T), dtype=torch.int32, device="cuda")
    fns = {}
    for name, lib in libs.items():
        def grid(lib=lib):
            return lib.counts_leq_grid_launch(
                ts.data_ptr(), out.data_ptr(), S, L, T, T0, STEP,
                torch.cuda.current_stream().cuda_stream)
        if grid() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: kernel != plain")
        fns[f"counts_leq_grid, {name}"] = grid
    lib = libs["multiply-shift (committed)"]
    fns["counts_leq on the same buckets (no division)"] = \
        lambda: lib.counts_leq_launch(b.data_ptr(), out.data_ptr(), S, L, T,
                                      torch.cuda.current_stream().cuda_stream)
    times = {name: [] for name in fns}
    for _ in range(5):
        for name, fn in fns.items():
            times[name].append(_batch_ms(fn))
    print(f"main-path shape ({S}, {L}) T={T}, every variant == plain; ms "
          f"per launch (20 back-to-back launches, 5 rounds):", flush=True)
    for name, ms in times.items():
        print(f"  {name}: median {statistics.median(ms):.4f} (rounds "
              f"{' / '.join(f'{m:.4f}' for m in ms)})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
