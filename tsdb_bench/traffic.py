"""The one generator that every traffic mix goes through.

A mix is a data file, `mixes/<name>.json`; this module reads it and draws
each client's statements from the seed. A statement type is a TSBS
`devops` query of the group-by family: an aggregate (`avg` or `max`) of
the first `fields` fields of the configuration, for all hosts or `hosts`
random ones, over the last or a random `span_s` seconds, by `bucket` and
host. A mix states:

- `readers`: closed-loop clients without think time;
- `writer`: true for one more client, which sends the next 10 s interval
  of every host as one row insert, each acknowledged before the next;
- `window_end`: `random` (a window placed on the 10 s grid inside the
  table, drawn from the seed) or `last_ack` (a window ending at the last
  interval the writer had acknowledged when the statement was sent);
- `compare_share`: the share of each client's answers, drawn from the
  seed, that the run holds against the reference;
- `statements`: the types.

Each reader sends every type once per round, in an order drawn from the
seed, so that every seed sends the same work in another order.

Imports numpy only: the client processes import it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

from .tsbs import rng_for

UNIT_MS = {"second": 1000, "minute": 60_000, "hour": 3600_000,
           "day": 86_400_000}


def bucket_ms(bucket: str) -> int:
    """Milliseconds of an interval such as '1 hour' or '30 minutes'."""
    n, unit = bucket.split()
    return int(n) * UNIT_MS[unit.rstrip("s")]


def load_json(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def load_mix(root: str, name: str) -> dict:
    """`mixes/<name>.json` under the benchmark's folder."""
    return load_json(root, os.path.join("tsdb_bench", "mixes",
                                        f"{name}.json"))


def draws(mix: dict, cfg: dict, seed: int, reader: int) -> Iterator[dict]:
    """The statements of one reader, unbound to a window end: each has
    `type`, `agg`, `fields`, `hosts` (sorted host numbers, or None for
    all), `span_ms`, `bucket`, `bucket_ms`, `offset` (a fraction in
    [0, 1) that places a `random` window), `compare` (whether its answer
    is held against the reference) and `index`."""
    rng = rng_for(seed, 10, reader)
    types = mix["statements"]
    H = cfg["hosts"]
    index = 0
    while True:
        for t in rng.permutation(len(types)):
            st = types[int(t)]
            hosts = None
            if st["hosts"] != "all":
                hosts = sorted(int(h) for h in rng.choice(
                    H, min(int(st["hosts"]), H), replace=False))
            yield {
                "type": st["name"], "agg": st["agg"],
                "fields": list(cfg["fields"][:st["fields"]]),
                "hosts": hosts, "span_ms": int(st["span_s"]) * 1000,
                "bucket": st["bucket"], "bucket_ms": bucket_ms(st["bucket"]),
                "offset": float(rng.random()),
                "compare": bool(rng.random() < mix["compare_share"]),
                "index": index,
            }
            index += 1


def bind(draw: dict, mix: dict, cfg: dict, acked: int) -> dict:
    """The statement with its window [a, b): `acked` is the number of
    intervals the writer had acknowledged past the table (0 without a
    writer)."""
    iv = cfg["interval_ms"]
    n = int(cfg["hours"] * 3600_000 // iv)
    span = draw["span_ms"]
    if mix["window_end"] == "last_ack":
        b = cfg["start_ms"] + (n + acked) * iv
    elif mix["window_end"] == "random":
        slots = (n * iv - span) // iv + 1
        b = cfg["start_ms"] + int(draw["offset"] * slots) * iv + span
    else:
        raise ValueError(f"unknown window_end {mix['window_end']!r}")
    return {**draw, "a": b - span, "b": b, "acked": acked}


def sql(stmt: dict, table: str) -> str:
    aggs = ", ".join(f"{stmt['agg']}({f})" for f in stmt["fields"])
    where = f"ts >= {stmt['a']} AND ts < {stmt['b']}"
    if stmt["hosts"] is not None:
        names = ", ".join(f"'host_{h}'" for h in stmt["hosts"])
        where = f"hostname IN ({names}) AND {where}"
    return (f"SELECT date_bin(INTERVAL '{stmt['bucket']}', ts) AS bucket, "
            f"hostname, {aggs} FROM {table} WHERE {where} GROUP BY bucket, "
            f"hostname ORDER BY bucket, hostname")


def warm_statements(mix: dict, cfg: dict, seed: int, acked: int
                    ) -> List[dict]:
    """One statement of every type, for the set-up."""
    seen: Dict[str, dict] = {}
    for d in draws(mix, cfg, seed, reader=len(mix["statements"]) + 1000):
        seen.setdefault(d["type"], d)
        if len(seen) == len(mix["statements"]):
            break
    return [bind(seen[t["name"]], mix, cfg, acked)
            for t in mix["statements"]]

