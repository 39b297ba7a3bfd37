"""The port's race detector (greptimedb_tpu_torch/devtools/greptsan) and
race hammer (greptimedb_tpu_torch/tools/race_hammer.py), held to the
reference's detector.

One race detector per process: the test session runs the reference's
(tests/conftest.py), so the port's runs in child processes with
GREPTIME_RACE_CHECK=1 that import nothing of the reference:

- one child (`san`) runs every in-process case, so torch loads once: the
  three seeded bugs, which must report the states and kinds that the
  reference's detector reports on its own selftest in this process; the
  happens-before edges that must suppress a race (the port's TrackedLock
  feeding the hooks, a thread join, a pool submit and result, an Event,
  a Condition handoff), with a plain lock as the control that must not;
  the launch counters and the streaming knobs hammered from threads
  (regressions of the races the hammer found); suppression keys, the
  baseline filter and generation hygiene;
- `race_hammer --device cpu` reports no unsuppressed race, its seeded
  race and a nonzero count of tracked accesses;
- an enabled port detector refuses to install over a `threading` that
  another module patched.

In this process, where the port's detector is off, `tracked_state` is
the identity and `threading` is the reference's to patch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from greptimedb_tpu.devtools.greptsan import detector as ref_detector
from greptimedb_tpu.devtools.greptsan import selftest as ref_seeded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: each child's own limit: the cases take seconds, torch's import most
CHILD_TIMEOUT_S = 240
ENV = dict(os.environ, GREPTIME_RACE_CHECK="1", OMP_NUM_THREADS="1")

_SAN = r'''
import json, os, sys, threading, time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

before = set(sys.modules)
from greptimedb_tpu_torch.common import locks
from greptimedb_tpu_torch.common.locks import TrackedLock
from greptimedb_tpu_torch.common.tracking import tracked_state
from greptimedb_tpu_torch.devtools import greptsan
from greptimedb_tpu_torch.devtools.greptsan import detector
from greptimedb_tpu_torch.devtools.greptsan import selftest as seeded

out = {"enabled": greptsan.enabled(), "locks": locks.enabled(),
       "hooks": locks._RACE_HOOKS is not None,
       "start_owner": threading.Thread.start.__module__,
       "tracked_type": type(tracked_state({}, "t.type")).__name__}


def races():
    return sorted({(r.state, r.kind) for r in detector.drain_races()})


def case(fn):
    detector.reset()
    fn()
    return races()


for name in ("unlocked_dict_mutation", "notify_without_lock",
             "pool_result_before_join"):
    detector.reset()
    state = getattr(seeded, name)()
    reps = detector.drain_races()
    out[name] = {"state": state,
                 "races": sorted({(r.state, r.kind) for r in reps}),
                 "render": [r.render() for r in reps if r.state == state][:1],
                 "keys": sorted({r.suppression_key() for r in reps})}
# the same seeded bug keys alike twice
seeded.pool_result_before_join()
out["key_again"] = sorted({r.suppression_key()
                           for r in detector.drain_races()})


def locked(make_lock):
    def run():
        lk = make_lock()
        d = tracked_state({}, "t.locked")

        def bump():
            for _ in range(20):
                with lk:
                    d["n"] = d.get("n", 0) + 1
        ts = [threading.Thread(target=bump) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert d["n"] == 60
    return run


def join_edge():
    d = tracked_state({}, "t.join")
    t = threading.Thread(target=lambda: d.__setitem__("x", 1))
    t.start()
    t.join()
    d["x"] = 2


def pool_edges():
    d = tracked_state({}, "t.pool")
    d["x"] = 0
    with ThreadPoolExecutor(2) as p:
        p.submit(lambda: d.__setitem__("x", d["x"] + 1)).result()
        d["x"] = 9


def event_edge():
    d = tracked_state({}, "t.event")
    ev = threading.Event()

    def producer():
        d["x"] = 1
        ev.set()
    t = threading.Thread(target=producer)
    t.start()
    assert ev.wait(10)
    d["x"] = 2
    t.join()


def condition_edge():
    cond = threading.Condition(TrackedLock("t.cond", force=True))
    d = tracked_state({}, "t.cond_state")

    def producer():
        with cond:
            d["ready"] = 1
            cond.notify()
    t = threading.Thread(target=producer)
    with cond:
        t.start()
        while not d.get("ready"):
            cond.wait(timeout=10)
    t.join()


out["edges"] = {
    "tracked_lock": case(locked(lambda: TrackedLock("t.lock", force=True))),
    "thread_join": case(join_edge),
    "pool_submit_result": case(pool_edges),
    "event_set_wait": case(event_edge),
    "condition_handoff": case(condition_edge),
    # the control: a plain lock gives the detector no edge
    "plain_lock": case(locked(threading.Lock)),
}


def launches():
    from greptimedb_tpu_torch.ops import cuda_build

    def wrapper():
        pass
    wrapper.launches = 0
    barrier = threading.Barrier(4)

    def launch():
        barrier.wait()
        for _ in range(200):
            cuda_build.count_launch(wrapper)
    ts = [threading.Thread(target=launch) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    out["launch_count"] = wrapper.launches


def knobs():
    from greptimedb_tpu_torch.query import stream_exec
    default = stream_exec.stream_threshold_rows()
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            stream_exec.stream_threshold_rows()
    t = threading.Thread(target=reader)
    t.start()
    for i in range(50):
        stream_exec.configure_streaming(threshold_rows=256 + i)
        time.sleep(0.001)
    stop.set()
    t.join()
    stream_exec.configure_streaming(threshold_rows=default)


out["launches_race"] = case(launches)
out["knobs_race"] = case(knobs)

od = tracked_state(OrderedDict([("a", 1), ("b", 2)]), "t.od_copy")
out["od_copy"] = [type(od.copy()).__name__, list(od.copy().items())]
seeded.unlocked_dict_mutation()
n = len(detector.races())
detector.new_generation()
out["generation"] = [n, len(detector.races()), len(detector._vars)]
new = set(sys.modules) - before
out["forbidden"] = sorted(m for m in new
                          if m.split(".")[0] in ("jax", "greptimedb_tpu"))
print(json.dumps(out))
'''

_CONFLICT = r'''
import threading

def start(self):
    raise AssertionError("never called")

threading.Thread.start = start           # another detector's patch
try:
    from greptimedb_tpu_torch.devtools.greptsan import detector
except Exception as e:
    print(type(e).__name__, e)
else:
    print("INSTALLED", detector.enabled())
'''


def _child(args, env=ENV):
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    return proc


@pytest.fixture(scope="module")
def san():
    proc = _child(["-c", _SAN])
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def hammer():
    proc = _child(["-m", "greptimedb_tpu_torch.tools.race_hammer",
                   "--device", "cpu", "--seconds", "3"])
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture()
def ref_isolated():
    """The reference's seeded races are drained, so the session's race
    gate (tests/conftest.py) sees none of them."""
    ref_detector.reset()
    yield
    ref_detector.reset()


def test_child_runs_the_ports_detector_alone(san):
    assert san["enabled"] and san["locks"] and san["hooks"]
    assert san["start_owner"].startswith(
        "greptimedb_tpu_torch.devtools.greptsan")
    assert san["tracked_type"] == "TrackedDict"
    assert san["forbidden"] == []


@pytest.mark.parametrize("name", ["unlocked_dict_mutation",
                                  "notify_without_lock",
                                  "pool_result_before_join"])
def test_seeded_bug_reports_as_in_the_reference(san, name, ref_isolated):
    ref_detector.reset()
    state = getattr(ref_seeded, name)()
    want = sorted({(r.state, r.kind) for r in ref_detector.drain_races()})
    got = san[name]
    assert got["state"] == state
    assert want, f"the reference's detector missed its own {name}"
    # a read-write report needs a thread switch between one thread's get
    # and its set, which either run may or may not see: every other kind
    # is the same
    assert {tuple(x) for x in got["races"] if x[1] != "read-write"} == \
        {x for x in want if x[1] != "read-write"}
    assert {x[0] for x in got["races"]} == {x[0] for x in want}


def test_report_names_both_stacks_and_the_missing_edge(san):
    [text] = san["unlocked_dict_mutation"]["render"]
    assert "DATA RACE" in text and "prior" in text and "current" in text
    assert text.count("in bump") >= 2 and "missing edge" in text
    assert all(k.startswith("greptsan.selftest.unlocked_dict:")
               for k in san["unlocked_dict_mutation"]["keys"])


def test_suppression_keys_are_stable(san):
    assert set(san["key_again"]) & set(san["pool_result_before_join"]["keys"])


@pytest.mark.parametrize("edge", ["tracked_lock", "thread_join",
                                  "pool_submit_result", "event_set_wait",
                                  "condition_handoff"])
def test_happens_before_edge_suppresses_the_race(san, edge):
    assert san["edges"][edge] == []


def test_a_plain_lock_orders_nothing(san):
    """The control of the TrackedLock case: the same code over a plain
    threading.Lock reports, so the lock edge above comes from the port's
    TrackedLock feeding the hooks."""
    assert ["t.locked", "write-write"] in san["edges"]["plain_lock"] or \
        ["t.locked", "write-read"] in san["edges"]["plain_lock"]


def test_launch_counts_move_under_one_lock(san):
    """Regression: the wrappers' `launches` counts moved with `+= 1` from
    whatever thread launched; four threads counting at once lose no
    count and race on nothing."""
    assert san["launches_race"] == []
    assert san["launch_count"] == 800


def test_streaming_knobs_read_under_their_lock(san):
    """Regression for the race the hammer found: configure_streaming
    wrote the streaming threshold while the scans read it with no lock."""
    assert san["knobs_race"] == []


def test_tracked_ordereddict_copy_and_generation(san):
    assert san["od_copy"] == ["OrderedDict", [["a", 1], ["b", 2]]]
    n, kept, vars_left = san["generation"]
    assert n >= 1 and kept == n and vars_left == 0


def test_race_hammer_on_the_cpu(hammer):
    proc, out = hammer
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert out["seeded_reported"] is True
    assert out["unsuppressed"] == 0 and out["races"] == 0
    assert out["accesses"] > 0 and out["errors"] == []
    assert "query.scan_cache.entries" in out["states"]
    assert set(out["launches"]) == {"counts_leq", "counts_leq_grid",
                                    "segment_moments", "grouped_moments"}


def test_race_hammer_refuses_a_detector_switched_off():
    proc = _child(["-m", "greptimedb_tpu_torch.tools.race_hammer",
                   "--device", "cpu", "--seconds", "0"],
                  env=dict(ENV, GREPTIME_RACE_CHECK="0"))
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "GREPTIME_RACE_CHECK" in proc.stderr


def test_refuses_to_install_over_another_detector():
    proc = _child(["-c", _CONFLICT])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("DetectorConflictError"), proc.stdout
    assert "__main__" in proc.stdout


def test_suppression_baseline_filters_by_key(tmp_path):
    from greptimedb_tpu_torch.devtools.greptsan import detector
    assert detector.load_suppressions(detector.DEFAULT_BASELINE) == {}
    assert detector.load_suppressions(str(tmp_path / "missing.json")) == {}
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"version": 1,
                              "suppressions": {"s:0000": "test only"}}))
    assert detector.load_suppressions(str(bl)) == {"s:0000": "test only"}
    bl.write_text(json.dumps({"version": 2}))
    with pytest.raises(ValueError):
        detector.load_suppressions(str(bl))


def test_port_detector_is_off_in_this_process():
    """The reference's detector owns this session: the port's stays off,
    its tracked_state is the identity and its locks feed no hooks."""
    import threading

    from greptimedb_tpu_torch.common import locks
    from greptimedb_tpu_torch.common.tracking import tracked_state
    from greptimedb_tpu_torch.devtools import greptsan
    assert not greptsan.enabled()
    d = {}
    assert tracked_state(d, "x") is d and type(tracked_state([], "y")) is list
    assert locks._RACE_HOOKS is None
    assert not threading.Thread.start.__module__.startswith(
        "greptimedb_tpu_torch")
