"""PromQL window-bounds counting: the port of the JAX package's one TPU
kernel.

`counts_leq(b, nsteps)` computes `out[s, k] = #{l : b[s, l] <= k}` for
`k < nsteps` over int32 step buckets `b[S, L]`. Buckets equal to nsteps,
the padding, fall in no step. `counts_leq_grid(ts2d, t0, step, nsteps)`
is the same count over int32 rebased timestamps for the step grid
`t0 + k*step`: it buckets each sample as `step_buckets` does, so the
PromQL window-bounds pass (ops/window.py) reads the timestamps once and
never writes the buckets to device memory.

Both replace greptimedb_tpu/ops/pallas_window.py:counts_leq_pallas. On a
CUDA tensor each wrapper launches its entry of the hand-written Hopper
kernel csrc/counts_leq.cu (a per-row shared-memory histogram plus a
block scan, O(S*(L+T)); the source notes its bound) or raises. On a CPU
tensor it computes the plain PyTorch version (`counts_leq_plain`, and
`counts_leq_plain` of `step_buckets` for the grid), which is also what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import KernelError
from . import cuda_build

#: bound on |t0| and step that the grid entry takes (int64 bucketing
#: arithmetic cannot overflow below it)
GRID_LIMIT = 2**62


def counts_leq_plain(b: torch.Tensor, nsteps: int) -> torch.Tensor:
    """Plain PyTorch version: per-row histogram of the clamped buckets
    (scatter-add) and a running sum along the steps."""
    S = b.shape[0]
    nsteps = int(nsteps)
    # b < 0 counts at every step like 0; b >= nsteps at none, like nsteps
    idx = b.clamp(0, nsteps).to(torch.int64)
    hist = torch.zeros((S, nsteps + 1), dtype=torch.int32, device=b.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.cumsum(hist[:, :nsteps], dim=1, dtype=torch.int32)


def step_buckets(ts2d: torch.Tensor, t0: int, step: int,
                 nsteps: int) -> torch.Tensor:
    """int32 [S, L]: for each sample the smallest k with t0 + k*step >= ts,
    clipped to [0, nsteps]; the pad sentinel maps to nsteps (no step)."""
    t0, step, nsteps = int(t0), int(step), int(nsteps)
    # Pads are routed through t0 and forced to nsteps afterwards; the
    # difference is taken in int64 so no t0 can overflow it. Floor
    # division rounds toward -inf, as the reference's floor_divide does.
    sentinel = torch.iinfo(ts2d.dtype).max
    is_pad = ts2d == sentinel
    safe_ts = torch.where(is_pad, t0, ts2d.to(torch.int64))
    k = torch.div(t0 - safe_ts, step, rounding_mode="floor")
    b = (-k).clamp_(0, nsteps).to(torch.int32)
    return b.masked_fill_(is_pad, nsteps)


def _launcher():
    lib = cuda_build.load("counts_leq")
    if lib.counts_leq_launch.argtypes is None:
        lib.counts_leq_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.counts_leq_launch.restype = ctypes.c_int
        lib.counts_leq_grid_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.counts_leq_grid_launch.restype = ctypes.c_int
        lib.counts_leq_error_string.argtypes = [ctypes.c_int]
        lib.counts_leq_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_input(name: str, x: torch.Tensor, nsteps: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous int32 matrix, "
                         f"got {x.dtype} (contiguous={x.is_contiguous()})")
    if max(*x.shape, nsteps) >= 2**31:
        raise ValueError(f"{name}: shape {(*x.shape, nsteps)} exceeds int32")


def _launch(entry, x: torch.Tensor, nsteps: int, *grid) -> torch.Tensor:
    """Launch the kernel's C entry `<entry name>_launch` on x's device and
    current stream, and count the launch on the wrapper `entry`."""
    name = entry.__name__
    _check_kernel_input(name, x, nsteps)
    S, L = x.shape
    out = torch.empty((S, nsteps), dtype=torch.int32, device=x.device)
    if S == 0 or nsteps == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), out.data_ptr(), S, L, nsteps, *grid, stream)
    if err != 0:
        msg = lib.counts_leq_error_string(err).decode()
        raise KernelError(f"{name} kernel launch failed: {msg} "
                          f"(cuda error {err})")
    cuda_build.count_launch(entry)
    return out


def counts_leq(b: torch.Tensor, nsteps: int) -> torch.Tensor:
    """out[s, k] = #{l : b[s, l] <= k} for k < nsteps; b int32 [S, L].

    CPU tensor: the plain version. CUDA tensor: the Hopper kernel
    (counted in `counts_leq.launches`), or an exception."""
    nsteps = int(nsteps)
    if b.dim() != 2:
        raise ValueError(f"counts_leq expects a 2-d bucket matrix, got "
                         f"shape {tuple(b.shape)}")
    if nsteps < 0:
        raise ValueError(f"counts_leq: nsteps={nsteps} is negative")
    if b.device.type == "cpu":
        return counts_leq_plain(b, nsteps)
    return _launch(counts_leq, b, nsteps)


def counts_leq_grid(ts2d: torch.Tensor, t0: int, step: int,
                    nsteps: int) -> torch.Tensor:
    """#samples per row with ts <= t0 + k*step, for k in [0, nsteps): a
    side='right' searchsorted against a regular grid, for rows in any
    order. ts2d: int32 [S, L] rebased timestamps, int32 max the pad.

    CPU tensor: `counts_leq_plain(step_buckets(...))`. CUDA tensor: the
    Hopper kernel with the bucketing fused into its loads (counted in
    `counts_leq_grid.launches`), or an exception."""
    t0, step, nsteps = int(t0), int(step), int(nsteps)
    if ts2d.dim() != 2:
        raise ValueError(f"counts_leq_grid expects a 2-d timestamp matrix, "
                         f"got shape {tuple(ts2d.shape)}")
    if ts2d.dtype != torch.int32:
        raise ValueError(f"counts_leq_grid takes int32 rebased timestamps, "
                         f"got {ts2d.dtype}")
    if nsteps < 0:
        raise ValueError(f"counts_leq_grid: nsteps={nsteps} is negative")
    if not 0 < step <= GRID_LIMIT or abs(t0) > GRID_LIMIT:
        raise ValueError(f"counts_leq_grid: needs 0 < step <= 2^62 and "
                         f"|t0| <= 2^62, got t0={t0} step={step}")
    if ts2d.device.type == "cpu":
        return counts_leq_plain(step_buckets(ts2d, t0, step, nsteps), nsteps)
    return _launch(counts_leq_grid, ts2d, nsteps, t0, step)


#: kernel launches since the count was last reset (plain-version calls
#: on CPU tensors do not count)
counts_leq.launches = 0
counts_leq_grid.launches = 0
