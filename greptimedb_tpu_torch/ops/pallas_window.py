"""PromQL window-bounds counting: the port of the JAX package's one TPU
kernel.

`counts_leq(b, nsteps)` computes `out[s, k] = #{l : b[s, l] <= k}` for
`k < nsteps` over int32 step buckets `b[S, L]` (ops/window.py makes them
from timestamps). Buckets equal to nsteps, the padding, fall in no step.

It replaces greptimedb_tpu/ops/pallas_window.py:counts_leq_pallas. On a
CUDA tensor the wrapper launches the hand-written Hopper kernel
csrc/counts_leq.cu (a per-row shared-memory histogram plus a block scan,
O(S*(L+T)); the source notes its bound) or raises. On a CPU tensor it
computes the plain PyTorch version, `counts_leq_plain`, which is also what
the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


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


def _launcher():
    lib = cuda_build.load("counts_leq")
    fn = lib.counts_leq_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.counts_leq_error_string.argtypes = [ctypes.c_int]
        lib.counts_leq_error_string.restype = ctypes.c_char_p
    return lib


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
    if b.device.type != "cuda":
        raise ValueError(f"counts_leq: no kernel for device {b.device}")
    if b.dtype != torch.int32 or not b.is_contiguous():
        raise ValueError("counts_leq kernel takes a contiguous int32 "
                         f"matrix, got {b.dtype} (contiguous="
                         f"{b.is_contiguous()})")
    S, L = b.shape
    if max(S, L, nsteps) >= 2**31:
        raise ValueError(f"counts_leq: shape {(S, L, nsteps)} exceeds int32")
    out = torch.empty((S, nsteps), dtype=torch.int32, device=b.device)
    if S == 0 or nsteps == 0:
        return out
    lib = _launcher()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.counts_leq_launch(b.data_ptr(), out.data_ptr(), S, L,
                                    nsteps, stream)
    if err != 0:
        msg = lib.counts_leq_error_string(err).decode()
        raise RuntimeError(f"counts_leq kernel launch failed: {msg} "
                           f"(cuda error {err})")
    counts_leq.launches += 1
    return out


#: kernel launches since the count was last reset (plain-version calls
#: on CPU tensors do not count)
counts_leq.launches = 0
