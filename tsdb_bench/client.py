"""A client process of a run: one reader or the writer, over Arrow Flight.

Run as `python -m tsdb_bench.client`. It imports the program's Flight
client (`greptimedb_tpu_torch.client.flight.Database`, which imports no
torch), numpy and pyarrow, and nothing of the server side, as a remote
client would. The harness talks to it over its standard streams:

1. the harness writes one JSON line, the spec: role, address, seed,
   reader number, the mix, the configuration, the acknowledgement file,
   the CPUs to keep to (or null) and, for the writer, the table's last
   interval of every field;
2. the client connects (the writer also sends its first batch, the
   set-up's warm-up of the write path) and prints `ready`;
3. the harness writes `go <t0> <t1>` in `time.monotonic()` seconds, a
   clock that every process of the machine shares;
4. from t0 the client sends in a closed loop, and sends nothing from t1
   on; it then waits for what is in flight and writes its records to
   standard output as one pickle.

A reader's record of a statement holds the statement, its send and
receive times and its error, if any; the answers of the statements drawn
for comparison, and of the reader's slowest one, travel beside them. The
writer's record of a batch holds its number, send and acknowledgement
times. The writer publishes the number of batches acknowledged in the
acknowledgement file, which the readers of a `last_ack` mix read before
each statement.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import sys
import time
from typing import Dict, List

import numpy as np
import pyarrow as pa

from . import traffic, tsbs


class AckFile:
    """The writer's count of acknowledged batches, shared through a small
    file: the count is written twice in one pwrite, and a reader retries
    a read whose halves differ."""

    def __init__(self, path: str, create: bool = False):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o600)
        if create:
            self.publish(0)

    def publish(self, k: int) -> None:
        os.pwrite(self.fd, struct.pack("<qq", k, k), 0)

    def read(self) -> int:
        while True:
            a, b = struct.unpack("<qq", os.pread(self.fd, 16, 0))
            if a == b:
                return a

    def close(self) -> None:
        os.close(self.fd)


def decode(batches) -> dict:
    """A statement's answer as the reference's keys: bucket ms, hostname
    and the aggregate columns as float64."""
    if not batches:
        return {"bucket": np.zeros(0, dtype=np.int64),
                "host": np.zeros(0, dtype=object), "values": []}
    t = pa.Table.from_batches([b.to_arrow() for b in batches])
    bucket = t.column(0)
    if pa.types.is_timestamp(bucket.type):
        bucket = bucket.cast(pa.timestamp("ms")).cast(pa.int64())
    return {"bucket": bucket.to_numpy().astype(np.int64),
            "host": t.column(1).to_numpy(zero_copy_only=False).astype(object),
            "values": [t.column(i).to_numpy(zero_copy_only=False)
                       .astype(np.float64) for i in range(2, t.num_columns)]}


def wait_until(t: float) -> None:
    """Sleep until time.monotonic() reaches t."""
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run_reader(db, spec: dict, t0: float, t1: float) -> dict:
    mix, cfg = spec["mix"], spec["config"]
    ack = AckFile(spec["ack_file"]) if mix["window_end"] == "last_ack" \
        else None
    records: List[dict] = []
    answers: Dict[int, dict] = {}
    slowest = (-1.0, None, None)
    wait_until(t0)
    for draw in traffic.draws(mix, cfg, spec["seed"], spec["reader"]):
        if time.monotonic() >= t1:
            break
        acked = ack.read() if ack is not None else 0
        stmt = traffic.bind(draw, mix, cfg, acked)
        text = traffic.sql(stmt, cfg["table"])
        err = None
        ts = time.monotonic()
        try:
            out = db.sql(text)
        except Exception as e:  # noqa: BLE001 — every failure is counted
            err = f"{type(e).__name__}: {e}"[:1500]
            out = None
        tr = time.monotonic()
        records.append({"stmt": stmt, "send": ts, "recv": tr, "error": err})
        if out is None:
            continue
        if stmt["compare"]:
            answers[stmt["index"]] = decode(out)
        elif tr - ts > slowest[0]:
            slowest = (tr - ts, stmt["index"], out)
    if slowest[1] is not None:
        answers[slowest[1]] = decode(slowest[2])
    if ack is not None:
        ack.close()
    return {"role": "reader", "reader": spec["reader"], "records": records,
            "answers": answers}


def run_writer(db, spec: dict, ready) -> dict:
    """Sends batch 1 before `ready` (set-up), then the rest in the
    window."""
    cfg = spec["config"]
    tags = tsbs.host_tags(spec["seed"], cfg["hosts"])
    walk = tsbs.LiveWalk(spec["seed"],
                         {f: np.asarray(v) for f, v in spec["last"].items()})
    ack = AckFile(spec["ack_file"])
    iv = cfg["interval_ms"]
    n = int(cfg["hours"] * 3600_000 // iv)
    k = 0

    def send() -> dict:
        nonlocal k
        ts = cfg["start_ms"] + (n + k) * iv
        cols = tsbs.batch_columns(ts, tags, walk.next())
        err = None
        t_send = time.monotonic()
        try:
            db.insert(cfg["table"], cols, tag_columns=tsbs.TSBS_TAGS,
                      timestamp_column="ts")
        except Exception as e:  # noqa: BLE001 — every failure is counted
            err = f"{type(e).__name__}: {e}"[:1500]
        t_ack = time.monotonic()
        if err is None:
            k += 1
            ack.publish(k)
        return {"batch": k, "send": t_send, "ack": t_ack, "error": err,
                "rows": len(tags)}

    first = send()
    if first["error"] is not None:
        raise RuntimeError(f"the warm-up batch failed: {first['error']}")
    t0, t1 = ready()
    records = []
    wait_until(t0)
    while time.monotonic() < t1:
        r = send()
        records.append(r)
        if r["error"] is not None:
            # a refused batch is not resent: the walk has moved on, and a
            # later batch would leave a hole the reference cannot see
            break
    ack.close()
    return {"role": "writer", "records": records, "acked": k}


def main() -> int:
    from greptimedb_tpu_torch.client.flight import Database

    spec = json.loads(sys.stdin.readline())
    if spec.get("cpus"):
        os.sched_setaffinity(0, spec["cpus"])
    db = Database(spec["address"])

    def ready():
        sys.stdout.write("ready\n")
        sys.stdout.flush()
        line = sys.stdin.readline().split()
        if not line or line[0] != "go":
            raise SystemExit(f"expected go, read {line!r}")
        return float(line[1]), float(line[2])

    if spec["role"] == "writer":
        out = run_writer(db, spec, ready)
    else:
        t0, t1 = ready()
        out = run_reader(db, spec, t0, t1)
    sys.stdout.flush()
    pickle.dump(out, sys.stdout.buffer, protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
