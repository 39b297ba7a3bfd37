"""Run a function of the port on every rank of a fresh process group.

`run_ranks(world_size, fn, payload, device)` spawns `world_size`
processes (torch.multiprocessing, spawn), joins them into one process
group over a FileStore in a temporary directory (gloo for
device="cpu", NCCL with one GPU per rank for "cuda"), calls
`fn(mesh, payload)` on each with the mesh `make_mesh(device=device)`
builds, and returns rank 0's result. `fn` must be a module-level
function of the port: the children import the port and nothing else.
A rank that raises fails the call with its traceback, and the other
ranks are stopped.

The JAX package runs its multi-device checks on one process with
virtual devices; a torch process group needs a process per rank, which
is what this module gives the tests, `tools/multichip.py` and anyone
who wants a mesh of several ranks on one machine.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence

import torch

#: seconds a rank waits in a collective before the group gives up
COLLECTIVE_TIMEOUT_S = 300


def _rank_main(rank: int, world: int, tmp: str, device: str,
               results) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh
    torch.set_num_threads(1)
    backend = "gloo" if device == "cpu" else "nccl"
    store_path = os.path.join(tmp, "store")
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, payload = pickle.load(f)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            out = fn(make_mesh(device=device), payload)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    # the traceback is the rank's answer: it reaches the parent through
    # the results queue, which re-raises it there
    except Exception:  # noqa: BLE001  # greptlint: disable=GL01
        results.put((rank, False, traceback.format_exc()))


def run_ranks(world_size: int, fn: Callable, payload: Any = None,
              device: str = "cuda", timeout: float = 600.0) -> Any:
    """`fn(mesh, payload)` on `world_size` spawned ranks; rank 0's result.

    device "cuda" (the default) gives each rank its own GPU over NCCL and
    raises here when CUDA is missing or has fewer GPUs than ranks; "cpu"
    runs gloo. Results must pickle (numpy arrays, not tensors)."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: CUDA is not available; pass "
                               "device='cpu' for gloo ranks")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"run_ranks: {world_size} NCCL ranks need "
                               f"{world_size} GPUs, "
                               f"{torch.cuda.device_count()} are visible")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gt_ranks_")
    results = ctx.Queue()
    # the call goes through a file: a spawned child reads its arguments
    # from a pipe only after its imports, so large ones would hold each
    # start() until the child before it had imported torch
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world_size, tmp, device, results)) for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=0.5)
            except queue.Empty:
                # a rank that died before it could report (killed, or its
                # interpreter failed to start) never answers
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"run_ranks: ranks {dead} exited without an "
                        f"answer" if dead else f"run_ranks: no answer from "
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"within {timeout}s") from None
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world_size} "
                                   f"failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(60)
        return got[0]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(tmp, ignore_errors=True)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def run_calls(mesh, calls: Sequence[tuple]) -> List[Any]:
    """Rank function: each (name, args, kwargs) of the parallel API (or
    "mesh_layout"), in order, on `mesh`; results as numpy, a raised error as ("error", its
    type's name, its message). Every rank runs every call, so the
    collectives pair up."""
    from . import (distributed_grouped_aggregate,
                   series_sharded_range_aggregate, time_blocked_window_sum)
    api = {f.__name__: f for f in (distributed_grouped_aggregate,
                                    series_sharded_range_aggregate,
                                    time_blocked_window_sum, mesh_layout)}
    out = []
    for name, args, kwargs in calls:
        try:
            out.append(_to_host(api[name](*args, mesh=mesh, **kwargs)))
        except (ValueError, TypeError) as e:
            out.append(("error", type(e).__name__, str(e)))
    return out


def mesh_layout(mesh, payload=None) -> Dict[str, Any]:
    """Rank function: the mesh as this rank sees it, and the top-level
    packages the rank has imported (a check that ranks import the port
    and not the JAX package)."""
    return {"shape": dict(mesh.shape), "size": mesh.size,
            "axis_names": list(mesh.axis_names), "rank": mesh.rank,
            "coords": list(mesh.coords), "device": str(mesh.device),
            "packages": sorted({m.split(".")[0] for m in sys.modules})}
