"""The continuous profiler: the port's `common/profiler.py` and its wiring
(ADMIN SHOW PROFILE, the SET knobs, `information_schema.profile_samples`,
`/debug/prof/cpu`, the `profiler_flush` failpoint) against the JAX
package's, on the CPU.

The sampler is driven with `sample_once()`, never by the wall clock, so
the counts below are exact under parallel test workers: a helper thread
parks inside one package's `process_list.track(...)` (a statement in
flight) or `background_jobs.job(...)` (a background job) while that
package's profiler samples it. The helper's frames are this file's and
the threading module's, so both packages fold them to the same stacks.
Compared exactly: `folded_text`, `flamegraph_svg` and
`profile_tree_rows` on the same rows; `fold_stack` and `stack_id`; the
attribution of the helper threads (kind, trace id, stack); the tree
ADMIN SHOW PROFILE renders by trace and by query id; the columns and
types of `greptime_private.profile_samples` and of the view; the knob
validation messages; a flush under the armed failpoint; the
`/debug/prof/cpu` answers' status, content type and shape. Both
packages' profiler knobs and failpoints are process state: every test
restores them.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from greptimedb_tpu.common import background_jobs as ref_jobs
from greptimedb_tpu.common import failpoint as ref_failpoint
from greptimedb_tpu.common import process_list as ref_procs
from greptimedb_tpu.common import profiler as ref_profiler
from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.servers.http import HttpServer as RefHttpServer
from greptimedb_tpu_torch.common import background_jobs, failpoint
from greptimedb_tpu_torch.common import process_list, profiler
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.servers.http import HttpServer

TIMEOUT_S = 60
TRACE = "5eed" * 8


class Side:
    """One package's frontend and its profiler, registries and failpoints."""

    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
        self.prof = profiler if port else ref_profiler
        self.procs = process_list if port else ref_procs
        self.jobs = background_jobs if port else ref_jobs
        self.failpoint = failpoint if port else ref_failpoint
        self.fe.do_query("CREATE TABLE cpu (host STRING, ts TIMESTAMP TIME "
                         "INDEX, v DOUBLE, PRIMARY KEY(host))")
        self.fe.do_query("INSERT INTO cpu VALUES ('a', 1000, 1.5), "
                         "('b', 2000, 2.5)")

    def do(self, sql):
        return self.fe.do_query(sql)[-1]

    def answer(self, sql):
        try:
            out = self.do(sql)
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"{type(e).__name__}: {e}"
        if not out.is_batches:
            return out.affected_rows
        return [tuple(r) for b in out.batches for r in b.rows()]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    saved = [(m, m.sampler()) for m in (profiler, ref_profiler)]
    both = {"port": Side(True, tmp_path_factory.mktemp("port")),
            "ref": Side(False, tmp_path_factory.mktemp("ref"))}
    yield both
    for s in both.values():
        s.fe.shutdown()
    for m, sampler in saved:
        m.install(sampler)


@pytest.fixture(autouse=True)
def _knobs():
    saved = [(m, m.enabled(), m.hz(), m.retention_ms())
             for m in (profiler, ref_profiler)]
    yield
    for m, on, hz, keep in saved:
        m.configure(enabled=on, hz=hz, retention_ms=keep)
    for fp in (failpoint, ref_failpoint):
        fp.configure("profiler_flush", None)


def _hold(ready, release):
    ready.set()
    release.wait(TIMEOUT_S)


class Held:
    """A helper thread parked inside `ctx()` until the block ends."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.ready, self.release = threading.Event(), threading.Event()

    def _run(self):
        with self.ctx():
            _hold(self.ready, self.release)

    def __enter__(self):
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.ready.wait(TIMEOUT_S)
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.thread.join(TIMEOUT_S)
        assert not self.thread.is_alive()


def _held_statement(s, sql="SELECT host FROM cpu", trace_id=TRACE):
    return Held(lambda: s.procs.track(sql, trace_id=trace_id))


def _held_job(s):
    return Held(lambda: s.jobs.job("flush", region="cpu_0"))


def _own(keys):
    """The sampled keys of this file's helper threads, the ids and a job's
    own (random) trace id left out."""
    return sorted((node, kind, bool(ident),
                   trace if kind == "query" else bool(trace), stack)
                  for node, kind, ident, trace, stack in keys
                  if ":_hold;" in stack)


def _random_rows(seed, n=60):
    rng = np.random.default_rng(seed)
    frames = [f"greptimedb_tpu/q/m{i}.py:f{i}" for i in range(9)] + \
        ["threading.py:run", "<b>&'\"x", "a" * 90]
    rows = []
    for _ in range(n):
        depth = int(rng.integers(1, 12))
        stack = ";".join(frames[int(rng.integers(0, len(frames)))]
                         for _ in range(depth))
        rows.append({"node": ["standalone", "dn1", "dn2"][
            int(rng.integers(0, 3))], "kind": "query", "id": "1",
            "trace_id": "", "stack": stack,
            "count": int(rng.integers(0, 40))})
    return rows


ROW_CASES = {
    "empty": [],
    "one deep stack": [{"node": "standalone", "stack": ";".join(
        f"m.py:f{i}" for i in range(64)), "count": 3}],
    "random 1": _random_rows(1),
    "random 2": _random_rows(2, 300),
}
RENDERERS = ("folded_text", "flamegraph_svg", "profile_tree_rows")


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("case", list(ROW_CASES))
def test_renderers_match_reference(renderer, case):
    rows = ROW_CASES[case]
    got = getattr(profiler, renderer)([dict(r) for r in rows])
    assert got == getattr(ref_profiler, renderer)([dict(r) for r in rows])


def test_folding_matches_reference():
    frame = sys._getframe()
    assert profiler.fold_stack(frame) == ref_profiler.fold_stack(frame)
    assert profiler.fold_stack(frame).endswith(
        ":test_folding_matches_reference")
    for s in ("", "a;b;c", "x" * 1000):
        assert profiler.stack_id(s) == ref_profiler.stack_id(s)
    # the package's own frames fold package-relative, as the reference's
    assert profiler._frame_label(profiler.fold_stack.__code__) == \
        "greptimedb_tpu_torch/common/profiler.py:fold_stack"
    assert ref_profiler._frame_label(ref_profiler.fold_stack.__code__) == \
        "greptimedb_tpu/common/profiler.py:fold_stack"


def test_sample_attribution_matches_reference(sides):
    """A statement in flight and a background job, each on a parked
    helper thread, attribute as in the reference: kind, id present, trace
    id and the folded stack; the live statement becomes 'last' and its
    top frames read the same."""
    got = {}
    for key, s in sides.items():
        prof = s.prof.Profiler(node_label="standalone", writer=None)
        with _held_statement(s), _held_job(s):
            assert prof.sample_once() >= 2
            assert prof.sample_once() >= 2
        got[key] = (_own(prof._agg), prof.last_query_trace,
                    prof.top_frames(TRACE), prof.pending_count() > 0)
    assert got["port"] == got["ref"]
    own = got["port"][0]
    assert [k[1] for k in own] == ["flush", "query"]
    assert own[1][3] == TRACE and got["port"][1] == TRACE
    assert [c for _, c in got["port"][2]] == [2]


def test_admin_show_profile_matches_reference(sides):
    """Samples of a parked statement flush into profile_samples; ADMIN
    SHOW PROFILE 'last' (its trace) and by its query id render the same
    tree in both packages, and the table and view have the same columns
    and types."""
    got = {}
    for key, s in sides.items():
        prof = s.fe.profiler
        prof.flush()
        with _held_statement(s, trace_id=TRACE) as held:
            for _ in range(3):
                prof.sample_once()
            entry = s.procs.entries_by_thread()[held.thread.ident]
        tree = s.answer("ADMIN SHOW PROFILE 'last'")
        by_id = s.answer(f"ADMIN SHOW PROFILE '{entry.id}'")
        table = s.fe.catalog.table("greptime", "greptime_private",
                                   "profile_samples")
        cols = [(c.name, c.dtype.name, str(c.semantic_type.value))
                for c in table.schema.column_schemas]
        view = s.do("SELECT * FROM information_schema.profile_samples")
        vcols = [(c.name, c.dtype.name)
                 for c in view.batches[0].schema.column_schemas]
        got[key] = (tree, by_id, cols, vcols)
    assert got["port"] == got["ref"]
    tree = got["port"][0]
    assert isinstance(tree, list) and tree[0][1] == "standalone"
    assert tree[-1][0].endswith("└─ threading.py:wait")
    assert tree[-1][2] == 3


@pytest.mark.parametrize("sql", [
    "SET profiling = 'on'",
    "SET profile_hz = 0.5",
    "SET profile_hz = 99999",
    "SET profile_hz = 'fast'",
    "SET profile_hz = 50",
    "SET profile_retention_ms = 'abc'",
    "SET profile_retention_ms = -1",
    "SET profile_retention_ms = 3600000",
    "ADMIN SHOW PROFILE 'f00dfeedf00dfeedf00dfeedf00dfeed'",
    "ADMIN SHOW PROFILE '999999'",
])
def test_profile_knobs_and_errors_match_reference(sides, sql):
    got = sides["port"].answer(sql)
    assert got == sides["ref"].answer(sql)
    assert (profiler.enabled(), profiler.hz(), profiler.retention_ms()) == \
        (ref_profiler.enabled(), ref_profiler.hz(),
         ref_profiler.retention_ms())


def test_profiling_switch_matches_reference(sides):
    """SET profiling = 1 arms the sampler thread in both packages, 0
    disarms it; no thread runs before the first arm."""
    for key, s in sides.items():
        assert s.answer("SET profiling = 1") == 0
        assert s.prof.enabled() and s.prof.sampler()._thread.is_alive()
        assert s.answer("SET profiling = 0") == 0
        assert not s.prof.enabled()


def test_flush_failpoint_matches_reference(sides):
    """A 'err' profiler_flush drops that flush's rows, counted on
    write_errors and dropped; disarmed, the next flush writes."""
    got = {}
    for key, s in sides.items():
        prof = s.fe.profiler
        prof.flush()
        with _held_statement(s):
            prof.sample_once()
        pending = prof.pending_count()
        before = dict(prof.stats)
        s.do("SET failpoint_profiler_flush = 'err'")
        failed = prof.flush()
        s.do("SET failpoint_profiler_flush = 'off'")
        delta = {k: prof.stats[k] - before[k]
                 for k in ("write_errors", "flushes")}
        dropped = prof.stats["dropped"] - before["dropped"]
        with _held_statement(s):
            prof.sample_once()
        got[key] = (failed, delta, dropped == pending, prof.flush() > 0,
                    [p for p in s.failpoint.list_points()
                     if p["name"] == "profiler_flush"][0]["fires"] >= 1)
    assert got["port"] == got["ref"]
    assert got["port"] == (0, {"write_errors": 1, "flushes": 0}, True, True,
                           True)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=TIMEOUT_S) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("query", [
    "seconds=0.2", "seconds=0.2&format=flamegraph",
    "seconds=0.2&hz=250&format=json", "format=pprof", "seconds=abc"])
def test_http_cpu_prof_matches_reference(sides, query):
    """GET /debug/prof/cpu: a burst of the same length through both
    servers at once answers the same status and content type, folded
    lines, an SVG or the JSON keys; bad parameters the same 400."""
    servers = {"port": HttpServer(sides["port"].fe, addr="127.0.0.1:0"),
               "ref": RefHttpServer(sides["ref"].fe, addr="127.0.0.1:0")}
    got = {}
    try:
        for srv in servers.values():
            srv.start()
        threads = [threading.Thread(target=lambda k=k, srv=srv: got.update(
            {k: _get(srv.port, "/debug/prof/cpu?" + query)}))
            for k, srv in servers.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        for srv in servers.values():
            srv.shutdown()
    (status, ctype, body), (rstatus, rctype, rbody) = got["port"], got["ref"]
    assert (status, ctype) == (rstatus, rctype)
    if status != 200:
        assert json.loads(body) == json.loads(rbody)
        return
    if "json" in query:
        doc, ref_doc = json.loads(body), json.loads(rbody)
        assert sorted(doc) == sorted(ref_doc) == [
            "rows", "sample_count", "seconds"]
        assert doc["seconds"] == ref_doc["seconds"] and doc["sample_count"]
        assert sorted(doc["rows"][0]) == sorted(ref_doc["rows"][0])
    elif "flamegraph" in query:
        assert body.startswith(b"<svg") and rbody.startswith(b"<svg")
    else:
        lines = body.decode().splitlines()
        assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
