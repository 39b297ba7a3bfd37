"""TSBS `cpu-only` data, frozen for the benchmark.

The generator that `chip_smoke.py` uses (`tsbs_cpu_table`, `sql_ddl`),
copied here so that a later change to the smoke script cannot move the
benchmark's data. TSBS is github.com/timescale/tsbs, `--use-case=cpu-only
--log-interval=10s`: the ten host tags of
pkg/data/usecases/devops/host.go and the ten `usage_*` fields of cpu.go,
each a random walk clamped to [0, 100] (steps N(0, 1), start U(0, 100)).
The table's walks are made on the device (`datagen.py`); the tags come
from a stream of their own here, so that a client process can make them.
`LiveWalk` continues every host's walks past the table, one 10 s interval
at a time, for the writer of the live mix; the reference replays it from
the same seed. Imports numpy only: the clients import it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# TSBS devops: pkg/data/usecases/devops/host.go regions and datacenters
TSBS_REGIONS = {
    "us-east-1": ["us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"],
    "us-west-1": ["us-west-1a", "us-west-1b"],
    "us-west-2": ["us-west-2a", "us-west-2b", "us-west-2c"],
    "eu-west-1": ["eu-west-1a", "eu-west-1b", "eu-west-1c"],
    "eu-central-1": ["eu-central-1a", "eu-central-1b"],
    "ap-southeast-1": ["ap-southeast-1a", "ap-southeast-1b"],
    "ap-southeast-2": ["ap-southeast-2a", "ap-southeast-2b"],
    "ap-northeast-1": ["ap-northeast-1a", "ap-northeast-1c"],
    "sa-east-1": ["sa-east-1a", "sa-east-1b", "sa-east-1c"],
}
TSBS_TAGS = ("hostname", "region", "datacenter", "rack", "os", "arch",
             "team", "service", "service_version", "service_environment")
CPU_FIELDS = ("usage_user", "usage_system", "usage_idle", "usage_nice",
              "usage_iowait", "usage_irq", "usage_softirq", "usage_steal",
              "usage_guest", "usage_guest_nice")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run: any whole `seed`, negative or
    past 64 bits included, maps to the same entropy on every machine."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def host_tags(seed: int, hosts: int) -> List[tuple]:
    """The ten tags of every host, from a stream of their own, so that a
    writer can make its rows' tags without making the table."""
    rng = rng_for(seed, 2)
    regions = list(TSBS_REGIONS)
    tags = []
    for h in range(hosts):
        r = regions[rng.integers(len(regions))]
        dcs = TSBS_REGIONS[r]
        tags.append((
            f"host_{h}", r, dcs[rng.integers(len(dcs))],
            str(rng.integers(100)),
            ("Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10")[
                rng.integers(3)],
            ("x64", "x86")[rng.integers(2)],
            ("SF", "NYC", "LON", "CHI")[rng.integers(4)],
            str(rng.integers(20)), str(rng.integers(2)),
            ("production", "staging", "test")[rng.integers(3)]))
    return tags


class LiveWalk:
    """The walks past the table's last interval: `next()` gives the next
    interval's value of every field on every host, {field: float64
    [hosts]}. Batches depend only on the seed and the table's last
    column, so the writer and the reference produce the same ones."""

    def __init__(self, seed: int, last: Dict[str, np.ndarray]):
        self._rng = rng_for(seed, 1)
        self._x = {f: np.array(v, dtype=np.float64) for f, v in last.items()}

    def next(self) -> Dict[str, np.ndarray]:
        for f in self._x:
            self._x[f] = np.clip(
                self._x[f] + self._rng.standard_normal(len(self._x[f])),
                0.0, 100.0)
        return {f: v.copy() for f, v in self._x.items()}


def sql_ddl(name: str, fields: Dict[str, str], partition: str = "") -> str:
    """CREATE TABLE `name`: the ten TSBS tags as the primary key, ts the
    time index, then `fields` ({name: SQL type}) as fields; `partition`
    is an optional PARTITION BY clause."""
    cols = [f"{t} STRING" for t in TSBS_TAGS] + ["ts TIMESTAMP TIME INDEX"] + \
        [f"{f} {t}" for f, t in fields.items()]
    return (f"CREATE TABLE {name} ({', '.join(cols)}, PRIMARY KEY("
            f"{', '.join(TSBS_TAGS)})){partition}")


def range_partition(hosts: int, regions: int) -> str:
    """PARTITION BY RANGE COLUMNS (hostname) into `regions` regions of
    equal host counts, the split points taken from the sorted names."""
    names = sorted(f"host_{h}" for h in range(hosts))
    bounds = [f"'{names[k * hosts // regions]}'"
              for k in range(1, regions)] + ["MAXVALUE"]
    return " PARTITION BY RANGE COLUMNS (hostname) (" + ", ".join(
        f"PARTITION r{i} VALUES LESS THAN ({b})"
        for i, b in enumerate(bounds)) + ")"


def batch_columns(ts: int, tags: List[tuple],
                  values: Dict[str, np.ndarray]) -> Dict[str, object]:
    """One interval of every host as the writer sends it."""
    H = len(tags)
    cols: Dict[str, object] = {t: [tg[i] for tg in tags]
                               for i, t in enumerate(TSBS_TAGS)}
    cols["ts"] = np.full(H, ts, dtype=np.int64)
    cols.update(values)
    return cols
