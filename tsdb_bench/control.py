"""The control of `correct`: the reference in bfloat16, put in the
program's place, through the comparison that every run makes.

    python -m tsdb_bench.control --workload <name> --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's table as a run does (on the device),
draws the statements that a run's readers would send first (for a
`last_ack` mix, each window ending at a count of acknowledged batches
that grows as a run's does, the batches made from the seed), answers
each in bfloat16 (`reference.answer(..., "bfloat16")`) and holds the
answer against the float64 reference. It prints, per seed, the numbers
that a run compares, beside the run's limits; the control has to fail
them. Runs are not timed and the program does not run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import reference, traffic
from .run import LIMITS, Cell, bench_root, live_values

#: statements per reader, about what a run compares
PER_READER = 6
#: batches acknowledged per statement in a `last_ack` mix (a run of the
#: live cell acknowledges about this many while a statement runs)
BATCHES_PER_STATEMENT = 8


def control_readings(cell: Cell, seed: int, device: str) -> dict:
    from . import datagen
    cfg, mix = cell.cfg, cell.mix
    _, vals = datagen.table_arrays(seed, cfg, device)
    live = mix["window_end"] == "last_ack"
    stmts = []
    for r in range(mix["readers"]):
        it = traffic.draws(mix, cfg, seed, r)
        for i in range(PER_READER):
            acked = 1 + BATCHES_PER_STATEMENT * (i * mix["readers"] + r) \
                if live else 0
            stmts.append(traffic.bind(next(it), mix, cfg, acked))
    K = max(s["acked"] for s in stmts)
    data = reference.Data(live_values(seed, vals, K), cfg["fields"],
                          cfg["start_ms"], cfg["interval_ms"])
    worst, mism = 0.0, 0.0
    for s in stmts:
        want = reference.answer(data, s)
        got = reference.answer(data, s, precision="bfloat16")
        c = reference.compare(got, want, s["agg"])
        worst = max(worst, c["worst"])
        mism += c["mismatches"]
    failed = worst > LIMITS["avg_err_over_bound"] or \
        mism > LIMITS["exact_mismatches"]
    return {"seed": seed, "statements": len(stmts),
            "avg_err_over_bound": worst, "exact_mismatches": mism,
            "limits": LIMITS, "control_fails": failed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tsdb_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = bench_root()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cell = Cell(root, json.load(f), args.workload)
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_readings(cell, seed, args.device)
        ok = ok and out["control_fails"]
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
