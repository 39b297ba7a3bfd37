"""The @copr decorator and coprocessor call protocol.

Reference behavior: src/script/src/python/ffi_types/copr.rs:40-120 — a
coprocessor declares `args` (input column names, bound from `sql`'s
result or from caller-supplied params), `returns` (output column names),
and optionally `sql` (the query whose columns feed the args). The wrapped
function receives one vector per arg and returns one vector (or a tuple,
one per return name).

Ported from greptimedb_tpu/script/copr.py. A coprocessor compiled by the
script engine carries the frontend's device and runs its body under
`with torch.device(device)`: torch's factory functions (`torch.as_tensor`,
`torch.tensor`, `torch.zeros`, `torch.arange`, ...) then make their
tensors there. `torch.from_numpy` does not follow the device (it shares
the numpy buffer on the host): a body that wants the card passes
`device=` to it, or uses `torch.as_tensor`. `as_vectors` takes a torch
tensor on any device and fetches it with one `.detach().cpu().numpy()`.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..errors import InvalidArgumentsError


@dataclass
class Coprocessor:
    name: str
    fn: Callable
    arg_names: List[str] = field(default_factory=list)
    returns: List[str] = field(default_factory=list)
    sql: Optional[str] = None
    backend: str = "native"          # reference: rspy | pyo3; here native
    #: the device the body runs under (the script engine sets the
    #: frontend's); None runs it as plain Python
    device: Optional[torch.device] = None

    def __call__(self, *args, **kwargs):
        if self.device is None:
            return self.fn(*args, **kwargs)
        with torch.device(self.device):
            return self.fn(*args, **kwargs)

    def output_names(self) -> List[str]:
        if self.returns:
            return list(self.returns)
        return [self.name]


def copr(args: Sequence[str] = (), returns: Sequence[str] = (),
         sql: Optional[str] = None, name: Optional[str] = None):
    """Mark a function as a coprocessor:

        @copr(args=["cpu", "mem"], returns=["load"], sql="select * from m")
        def load(cpu, mem):
            return cpu + mem
    """
    def wrap(fn: Callable) -> Coprocessor:
        arg_names = list(args)
        if not arg_names:
            sig = inspect.signature(fn)
            arg_names = [p.name for p in sig.parameters.values()
                         if p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)]
        return Coprocessor(name=name or fn.__name__, fn=fn,
                           arg_names=arg_names, returns=list(returns),
                           sql=sql)
    return wrap


#: reference alias (both spellings exist in the reference decorator parser)
coprocessor = copr


def as_vectors(result, n_expected_cols: int) -> List[np.ndarray]:
    """Normalize a coprocessor's return value into output columns."""
    if isinstance(result, tuple):
        cols = list(result)
    else:
        cols = [result]
    if n_expected_cols and len(cols) != n_expected_cols:
        raise InvalidArgumentsError(
            f"coprocessor returned {len(cols)} columns, "
            f"declared {n_expected_cols} returns")
    out = []
    for c in cols:
        if isinstance(c, torch.Tensor):
            c = c.detach().cpu().numpy()
        arr = np.asarray(c)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        out.append(arr)
    lens = {len(a) for a in out}
    if len(lens) > 1:
        # scalars broadcast against vector outputs
        n = max(lens)
        out = [np.full(n, a[0]) if len(a) == 1 else a for a in out]
        if {len(a) for a in out} != {n}:
            raise InvalidArgumentsError(
                f"ragged coprocessor output lengths: {sorted(lens)}")
    return out
