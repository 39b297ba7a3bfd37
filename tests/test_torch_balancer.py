"""Elastic regions, the JAX package's scenarios run against both packages,
on the CPU.

tests/test_balancer.py drives the meta balancer's resumable operations
(ADMIN MIGRATE / SPLIT / REBALANCE, the heat-driven auto split, the
torture cases that crash each step, a meta restart mid-migration, the
failover of a dead node) through in-process clusters over one shared
object store. This file runs every one of those scenarios twice, `[ref]`
on the JAX package and `[port]` on greptimedb_tpu_torch: the port's case
is the same source with the package name swapped (`load_scenarios`), its
datanodes and frontend on "cpu". Each scenario's own assertions decide,
so the port is held to exactly what the reference is held to: no acked
row lost or duplicated across a move, a split or a crashed step, the
same placement, the same typed errors.

Then mixed clusters (`test_mixed_cluster_migrates_and_splits`): meta,
frontend and one datanode from one package, the other datanode from the
other package, over one shared object store; a region migrates each way
and splits, and every acknowledged row is read back exactly once.

The reference's scenarios compile no JAX program beyond the small
aggregate path's first signature; the whole file takes about 20 s here.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))


def _cpu(cls):
    """`cls` with device="cpu" unless the caller passes one (the port's
    entry points run on "cuda" by default)."""
    @functools.wraps(cls)
    def make(*args, **kw):
        kw.setdefault("device", "cpu")
        return cls(*args, **kw)
    return make


def load_scenarios(source: str, side: str, renames: dict = ()):
    """tests/<source> as a module of `side`'s package. For "ref" it is the
    module itself. For "port" every `greptimedb_tpu` becomes
    `greptimedb_tpu_torch`, `from X import` becomes `from renames[X]
    import` for the scenario modules it builds on, and its datanodes,
    standalone datanodes and distributed frontends default to "cpu"."""
    name = source[:-3]
    if side == "ref":
        return importlib.import_module(name)
    alias = f"_port_{name}"
    if alias in sys.modules:
        return sys.modules[alias]
    text = (TESTS / source).read_text()
    text = re.sub(r"\bgreptimedb_tpu\b", "greptimedb_tpu_torch", text)
    for old, new in dict(renames).items():
        text = text.replace(f"from {old} import", f"from {new} import")
    mod = types.ModuleType(alias)
    mod.__file__ = str(TESTS / source)
    sys.modules[alias] = mod
    exec(compile(text, mod.__file__, "exec"), mod.__dict__)
    from greptimedb_tpu_torch.datanode import instance as dn_mod
    from greptimedb_tpu_torch.frontend import distributed as dist_mod
    dn_mod_opts = _cpu(dn_mod.DatanodeOptions)
    for attr, value in (("DatanodeOptions", dn_mod_opts),
                        ("DistInstance", _cpu(dist_mod.DistInstance))):
        if attr in mod.__dict__:
            setattr(mod, attr, value)
    return mod


def scenario_cases(mod, classes):
    """(class, method, params) for every test method of `classes` in
    `mod`, one entry per parametrize combination."""
    cases = []
    for cls_name in classes:
        cls = getattr(mod, cls_name)
        for meth_name, meth in inspect.getmembers(cls, inspect.isfunction):
            if not meth_name.startswith("test_"):
                continue
            combos = [{}]
            for mark in getattr(meth, "pytestmark", []):
                if mark.name != "parametrize":
                    continue
                argnames, values = mark.args[0], mark.args[1]
                names = [a.strip() for a in argnames.split(",")] \
                    if isinstance(argnames, str) else list(argnames)
                ids = mark.kwargs.get("ids")
                new = []
                for k, v in enumerate(values):
                    vals = v if len(names) > 1 else (v,)
                    label = ids[k] if ids else "-".join(map(str, vals))
                    for c in combos:
                        new.append({**c, **dict(zip(names, vals)),
                                    "__id__": c.get("__id__", ()) +
                                    (str(label),)})
                combos = new
            for c in combos:
                cid = "-".join(c.pop("__id__", ()))
                cases.append((cls_name, meth_name, c,
                              f"{cls_name}.{meth_name}" +
                              (f"[{cid}]" if cid else "")))
    return cases


def run_scenario(mod, cls_name, meth_name, params, fixtures, request):
    """Call one scenario method with the fixtures its signature names,
    built from `fixtures` (name -> context-manager factory taking the
    module) and pytest's own (`tmp_path`, `request`)."""
    meth = getattr(getattr(mod, cls_name)(), meth_name)
    kwargs, stack = dict(params), []
    try:
        for arg in inspect.signature(meth).parameters:
            if arg in kwargs:
                continue
            if arg == "tmp_path":
                kwargs[arg] = request.getfixturevalue("tmp_path")
            elif arg == "request":
                kwargs[arg] = request
            else:
                cm = fixtures[arg](mod, request.getfixturevalue("tmp_path"))
                kwargs[arg] = cm.__enter__()
                stack.append(cm)
        meth(**kwargs)
    finally:
        while stack:
            stack.pop().__exit__(None, None, None)


class _Fixture:
    """A scenario module's generator fixture, driven by hand."""

    def __init__(self, gen):
        self._gen = gen

    def __enter__(self):
        return next(self._gen)

    def __exit__(self, *exc):
        for _ in self._gen:
            pass


def _balancer_cluster(mod, tmp_path):
    """tests/test_balancer.py's `cluster` fixture, on `mod`'s package."""
    def gen():
        mod.failpoint.reset()
        c = mod.Cluster(tmp_path)
        try:
            yield c
        finally:
            mod.failpoint.reset()
            c.shutdown()
    return _Fixture(gen())


SIDES = ("ref", "port")
MODULES = {side: load_scenarios("test_balancer.py", side) for side in SIDES}
CLASSES = ("TestRuleRefinement", "TestMigrate", "TestSplit",
           "TestRebalanceAndAuto", "TestMigrationTorture",
           "TestElasticFailover")
CASES = scenario_cases(MODULES["ref"], CLASSES)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("case", CASES, ids=[c[3] for c in CASES])
def test_scenario(side, case, request):
    cls_name, meth_name, params, _ = case
    run_scenario(MODULES[side], cls_name, meth_name, params,
                 {"cluster": _balancer_cluster}, request)


def test_port_cases_are_the_references():
    """Both sides run the same scenario list, and the port's module is
    built on the port's package alone."""
    assert scenario_cases(MODULES["port"], CLASSES) == CASES
    assert len(CASES) >= 20
    port = MODULES["port"]
    for name in ("DistInstance", "MetaSrv", "FsObjectStore", "failpoint"):
        obj = getattr(port, name)
        where = obj.__name__ if isinstance(obj, types.ModuleType) \
            else obj.__module__
        assert where.startswith("greptimedb_tpu_torch"), name


# ---------------------------------------------------------------------------
# mixed clusters: one datanode of each package
# ---------------------------------------------------------------------------

def _pkg(side):
    pkg = "greptimedb_tpu" if side == "ref" else "greptimedb_tpu_torch"

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")
    return types.SimpleNamespace(
        datanode=m("datanode.instance"), client=m("client.flight"),
        server=m("servers.flight"), dist=m("frontend.distributed"),
        meta=m("meta"), store=m("storage.object_store"),
        failpoint=m("common.failpoint"))


class MixedCluster:
    """Meta and the frontend of `front`; datanode i of `sides[i - 1]`,
    behind its own package's FlightDatanodeServer (objects of one package
    do not cross into the other in process: the wire is the contract);
    one shared data home and object store, each node through its own
    package's FsObjectStore. Pumped by hand like test_balancer.py's
    Cluster: the balancer's steps ride heartbeat responses as dicts."""

    def __init__(self, tmp_path, front, sides, data_home="home"):
        self.tmp_path = tmp_path
        f = _pkg(front)
        self.srv = f.meta.MetaSrv(f.meta.MemKv(), datanode_lease_secs=3600.0)
        self.srv.balancer.resend_interval_s = 0.0
        self.meta = f.meta.MetaClient(self.srv)
        self.datanodes, self.clients, self.servers = {}, {}, {}
        self.serving = {}
        for i, side in enumerate(sides, start=1):
            p = _pkg(side)
            kw = {"device": "cpu"} if side == "port" else {}
            dn = p.datanode.DatanodeInstance(
                p.datanode.DatanodeOptions(
                    data_home=str(tmp_path / data_home), node_id=i,
                    register_numbers_table=False, **kw),
                store=p.store.FsObjectStore(str(tmp_path / "shared")))
            dn.start()
            dn.attach_meta(self.meta)
            server = p.server.FlightDatanodeServer(dn)
            self.serving[i] = server.serve_in_background()
            self.servers[i] = server
            self.datanodes[i] = dn
            self.clients[i] = f.client.FlightDatanodeClient(server.address,
                                                            i)
            self.srv.register_datanode(f.meta.Peer(i, server.address))
            self.srv.handle_heartbeat(i)
        kw = {"device": "cpu"} if front == "port" else {}
        self.fe = f.dist.DistInstance(self.meta, self.clients, **kw)

    def pump(self, rounds=16):
        for _ in range(rounds):
            self.srv.balancer.tick()
            for i, dn in self.datanodes.items():
                for msg in self.srv.handle_heartbeat(i).mailbox:
                    dn._handle_mailbox(msg)
            if not self.srv.balancer.ops():
                return True
        return False

    def owner(self, region):
        route = self.srv.table_route("greptime.public.ha")
        return next(rr.leader.id for rr in route.region_routes
                    if rr.region_number == region)

    def rows(self):
        out = self.fe.do_query("SELECT host, ts, v FROM ha")[-1]
        return sorted(tuple(r) for b in out.batches for r in b.rows())

    def shutdown(self):
        if hasattr(self.fe, "shutdown"):
            self.fe.shutdown()
        for c in self.clients.values():
            c.close()
        for i, server in self.servers.items():
            # a serve thread still winding down can close the socket of
            # a server made after it in the process: join it
            server.shutdown()
            if self.serving[i] is not None:
                self.serving[i].join(60)
        for dn in self.datanodes.values():
            dn.shutdown()


@pytest.mark.parametrize("front,sides", [
    ("port", ("port", "ref")), ("port", ("ref", "port")),
    ("ref", ("port", "ref")), ("ref", ("ref", "port"))],
    ids=["port-fe-port-ref", "port-fe-ref-port", "ref-fe-port-ref",
         "ref-fe-ref-port"])
def test_mixed_cluster_migrates_and_splits(tmp_path, front, sides):
    """A region written through one package's datanode migrates to the
    other package's and back, a split copies across packages, and every
    acknowledged row is read back exactly once after each step."""
    ref_bal = MODULES["ref"]
    c = MixedCluster(tmp_path, front, sides)
    try:
        c.fe.do_query(ref_bal.DDL)
        acked = []

        def write(lo, hi):
            vals = [(f"h{i % 10}", 1000 + i, float(i)) for i in range(lo, hi)]
            c.fe.do_query("INSERT INTO ha VALUES " + ", ".join(
                f"('{h}', {t}, {v})" for h, t, v in vals))
            acked.extend(vals)

        write(0, 20)
        assert c.rows() == sorted(acked)
        for _ in range(2):                       # there and back
            src = c.owner(0)
            dst = next(i for i in c.datanodes if i != src)
            write(20 + len(acked), 30 + len(acked))   # unflushed tail
            c.fe.do_query(f"ADMIN MIGRATE REGION ha 0 TO {dst}")
            assert c.pump(), c.srv.balancer.ops()
            assert c.srv.balancer.done_ops()[-1]["state"] == "done"
            assert c.owner(0) == dst
            assert c.rows() == sorted(acked)
        c.fe.do_query("ADMIN SPLIT REGION ha 1 AT 'h7'")
        assert c.pump(), c.srv.balancer.ops()
        assert c.srv.balancer.done_ops()[-1]["state"] == "done"
        write(500, 520)
        assert c.rows() == sorted(acked)
        assert len(c.rows()) == len(set(c.rows()))
    finally:
        c.shutdown()
