"""The table's values, made on the device from the seed.

TSBS cpu-only's walks (`tsbs.py`) for every host and field at once: one
`torch.Generator` on the device draws every start and every step in two
calls, the clamped walk runs one interval at a time over all fields and
hosts, and one copy brings the result to the host, where the load and
the reference read it. The same seed gives the same values on one kind
of device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .tsbs import CPU_FIELDS


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for `torch.Generator` from any whole `seed`."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def tsbs_values(seed: int, hosts: int, hours: float, interval_ms: int,
                device: str, fields: Sequence[str] = CPU_FIELDS
                ) -> np.ndarray:
    """float64 [fields, n, hosts], n = hours / interval: field-major,
    time-major within a field (every host at one instant, then the next),
    as a TSBS loader sends rows."""
    n = int(hours * 3600_000 // interval_ms)
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, 0))
    F = len(fields)
    start = torch.rand((F, hosts), generator=g, device=device,
                       dtype=torch.float64) * 100.0
    walk = torch.randn((n, F, hosts), generator=g, device=device,
                       dtype=torch.float64)
    walk[0].add_(start).clamp_(0.0, 100.0)
    for i in range(1, n):
        walk[i].add_(walk[i - 1]).clamp_(0.0, 100.0)
    out = walk.permute(1, 0, 2).contiguous().cpu().numpy()
    del walk
    return out


def table_arrays(seed: int, cfg: dict, device: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(ts [n] int64 ms, values [fields, n, hosts]) of a configuration."""
    vals = tsbs_values(seed, cfg["hosts"], cfg["hours"], cfg["interval_ms"],
                       device, cfg["fields"])
    n = vals.shape[1]
    ts = cfg["start_ms"] + np.arange(n, dtype=np.int64) * cfg["interval_ms"]
    return ts, vals


def load_columns(ts: np.ndarray, tags, vals: np.ndarray,
                 fields: Sequence[str], tag_names: Sequence[str]
                 ) -> Dict[str, np.ndarray]:
    """The rows as a TSBS loader sends them, time-major; the value
    columns are views of `vals`."""
    F, n, H = vals.shape
    cols = {t: np.tile(np.array([tg[i] for tg in tags], dtype=object), n)
            for i, t in enumerate(tag_names)}
    cols["ts"] = np.repeat(ts, H)
    for k, f in enumerate(fields):
        cols[f] = vals[k].reshape(-1)
    return cols
