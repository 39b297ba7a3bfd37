"""The coprocessor script engine: the port's `script/` (`@copr`, the
ScriptEngine's compile, persistence in the `scripts` table, runs with a
bound `sql` or with params, the SQL UDFs, `/v1/scripts` and
`/v1/run-script`) against the JAX package's, on the CPU.

Both packages' standalone frontends get the same table `monitor` (values
from a seed) and the same scripts. A numpy-only script answers exactly
what the reference's answers: the same column names, types and values.
A body written in torch (the port's namespace holds `torch`, where the
reference's holds `jnp`) answers within float32 of the same math
written in `jnp` for the reference: |port - ref| <= 8 eps32 sum|x| per
value, x the input column (the reference computes in float32, the port
in the column's float64). The body runs under the frontend's device:
here the CPU (`device="cpu"`), on the card "cuda", as chip_smoke.py's
phase 13 checks. The UDF registry is process state in each package:
every test unregisters what it registered.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from greptimedb_tpu.datanode import DatanodeInstance as RefDatanode
from greptimedb_tpu.datanode import DatanodeOptions as RefOptions
from greptimedb_tpu.frontend import FrontendInstance as RefFrontend
from greptimedb_tpu.query import functions as ref_functions
from greptimedb_tpu.script import copr as ref_copr
from greptimedb_tpu.script.copr import as_vectors as ref_as_vectors
from greptimedb_tpu.script.engine import _np_dtype as ref_np_dtype
from greptimedb_tpu.servers.http import HttpServer as RefHttpServer
from greptimedb_tpu_torch.datanode import DatanodeOptions
from greptimedb_tpu_torch.frontend import build_standalone
from greptimedb_tpu_torch.query import functions
from greptimedb_tpu_torch.script import copr
from greptimedb_tpu_torch.script.copr import as_vectors
from greptimedb_tpu_torch.script.engine import _np_dtype
from greptimedb_tpu_torch.servers.http import HttpServer

T0 = 1_700_000_000_000
EPS32 = float(np.finfo(np.float32).eps)
TIMEOUT_S = 60


def _rows():
    rng = np.random.default_rng(23)
    return ", ".join(
        f"('h{i % 7}', {T0 + i * 1000}, "
        f"{float(np.round(rng.normal(40, 15), 4))}, "
        f"{int(rng.integers(100, 5000))})" for i in range(200))


class Side:
    def __init__(self, port: bool, home):
        self.port = port
        if port:
            self.fe = build_standalone(DatanodeOptions(
                data_home=str(home), device="cpu"))
        else:
            self.fe = RefFrontend(RefDatanode(RefOptions(
                data_home=str(home))))
            self.fe.start()
        self.functions = functions if port else ref_functions
        self.fe.do_query("CREATE TABLE monitor (host STRING, ts TIMESTAMP "
                         "TIME INDEX, cpu DOUBLE, memory BIGINT, "
                         "PRIMARY KEY(host))")
        self.fe.do_query("INSERT INTO monitor VALUES " + _rows())

    @property
    def engine(self):
        return self.fe.script_engine

    def columns(self, out):
        """(name, type name) of each column, and its values."""
        schema = out.batches[0].schema
        d = {}
        for b in out.batches:
            for k, v in b.to_pydict().items():
                d.setdefault(k, []).extend(v)
        return [(c.name, c.dtype.name) for c in schema.column_schemas], d

    def attempt(self, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"{type(e).__name__}: {e}"


@pytest.fixture()
def sides(tmp_path):
    both = {"port": Side(True, tmp_path / "port"),
            "ref": Side(False, tmp_path / "ref")}
    yield both
    for s in both.values():
        s.fe.shutdown()
        for name in list(s.functions.UDF_REGISTRY):
            s.functions.unregister_udf(name)


#: name -> script text, numpy only: the same text runs in both packages
NUMPY_SCRIPTS = {
    "load": '''
@copr(args=["cpu", "memory"], returns=["load"],
      sql="SELECT cpu, memory FROM monitor ORDER BY ts")
def load(cpu, memory):
    return cpu + memory / 1000.0
''',
    "spread": '''
@coprocessor(args=["cpu"], returns=["lo", "hi", "above"],
             sql="SELECT host, cpu FROM monitor ORDER BY ts")
def spread(cpu):
    return np.minimum(cpu, 30.0), np.maximum(cpu, 50.0), cpu > 40.0
''',
    "rank": '''
@copr(args=["memory"], returns=["r", "total"],
      sql="SELECT memory FROM monitor WHERE host = 'h3' ORDER BY ts")
def rank(memory):
    return np.argsort(np.argsort(memory)), int(memory.sum())
''',
}


@pytest.mark.parametrize("name", list(NUMPY_SCRIPTS))
def test_numpy_script_matches_reference(sides, name):
    """Stored, then run by name: the same columns, types and values."""
    got = {}
    for key, s in sides.items():
        s.engine.insert_script(name, NUMPY_SCRIPTS[name])
        got[key] = s.columns(s.engine.run(name))
    assert got["port"] == got["ref"]


def test_params_and_errors_match_reference(sides):
    script = '''
@copr(args=["v", "k"], returns=["scaled"])
def scaled(v, k):
    return v * k
'''
    got = {}
    for key, s in sides.items():
        s.engine.insert_script("scaled", script)
        got[key] = (
            s.columns(s.engine.run("scaled", params={"v": [1.0, 2.5],
                                                     "k": 3})),
            s.attempt(lambda: s.engine.run("scaled", params={"v": [1]})),
            s.attempt(lambda: s.engine.run("nope")),
            s.attempt(lambda: s.engine.insert_script("bad", "x = 1")),
            s.attempt(lambda: s.engine.insert_script(
                "broken", "def broken(:\n  pass")),
            s.attempt(lambda: s.engine.run(
                '@copr(args=["zz"], sql="SELECT cpu FROM monitor")\n'
                'def f(zz):\n    return zz\n', is_script_text=True)))
    assert got["port"] == got["ref"]
    assert got["port"][0][1] == {"scaled": [3.0, 7.5]}


def test_udf_from_sql_matches_reference(sides):
    """A stored coprocessor is a scalar SQL function."""
    got = {}
    for key, s in sides.items():
        s.engine.insert_script("centi", '''
@copr(args=["x"], returns=["c"])
def centi(x):
    return x * 100.0
''')
        out = s.fe.do_query("SELECT host, centi(cpu) AS c FROM monitor "
                            "WHERE host = 'h1' ORDER BY ts")[-1]
        got[key] = s.columns(out)
    assert got["port"] == got["ref"]


def test_restart_reloads_scripts_as_reference(sides, tmp_path):
    """Scripts persist in the `scripts` table; a frontend opened again on
    the same data home recompiles them in start()."""
    got = {}
    for key, s in sides.items():
        s.engine.insert_script("load", NUMPY_SCRIPTS["load"])
        table = s.fe.catalog.table("greptime", "public", "scripts")
        cols = [(c.name, c.dtype.name) for c in table.schema.column_schemas]
        s.fe.shutdown()
        home = tmp_path / key
        if s.port:
            s.fe = build_standalone(DatanodeOptions(data_home=str(home),
                                                    device="cpu"))
        else:
            s.fe = RefFrontend(RefDatanode(RefOptions(data_home=str(home))))
            s.fe.start()
        got[key] = (cols, sorted(s.engine._compiled),
                    s.columns(s.engine.run("load")))
    assert got["port"] == got["ref"]
    assert got["port"][1] == ["public.load"]


#: the same standardization, in torch for the port and in jnp for the
#: reference
TORCH_BODY = '''
@copr(args=["cpu"], returns=["z", "device"],
      sql="SELECT cpu FROM monitor ORDER BY ts")
def standardize(cpu):
    x = torch.as_tensor(cpu)
    z = (x - x.mean()) / x.std(unbiased=False)
    return z, x.device.type
'''
JNP_BODY = '''
@copr(args=["cpu"], returns=["z", "device"],
      sql="SELECT cpu FROM monitor ORDER BY ts")
def standardize(cpu):
    x = jnp.asarray(cpu)
    z = (x - jnp.mean(x)) / jnp.std(x)
    return np.asarray(z), "cpu"
'''


def test_torch_body_within_float32_of_jnp_body(sides):
    """The torch body runs on the frontend's device (here the CPU) and
    answers within 8 eps32 sum|x| of the jnp body per value; the tensor
    it returns is fetched to a FLOAT64 column."""
    sides["port"].engine.insert_script("standardize", TORCH_BODY)
    sides["ref"].engine.insert_script("standardize", JNP_BODY)
    (cols, got), (ref_cols, want) = (
        sides[k].columns(sides[k].engine.run("standardize"))
        for k in ("port", "ref"))
    assert cols == ref_cols == [("z", "Float64"), ("device", "String")]
    assert got["device"] == want["device"] == ["cpu"] * 200
    cpu = np.asarray(sides["port"].columns(sides["port"].fe.do_query(
        "SELECT cpu FROM monitor ORDER BY ts")[-1])[1]["cpu"])
    bound = 8 * EPS32 * np.abs(cpu).sum()
    err = np.abs(np.asarray(got["z"]) - np.asarray(want["z"]))
    assert err.max() <= bound
    exact = (cpu - cpu.mean()) / cpu.std()
    np.testing.assert_allclose(got["z"], exact, rtol=1e-12, atol=1e-12)


def test_namespace_holds_torch_not_jnp(sides):
    """The port's namespace: copr, coprocessor, np, numpy and torch; a
    `jnp` body is a NameError; the body runs under the engine's device,
    which is the frontend's."""
    engine = sides["port"].engine
    assert engine.device == torch.device("cpu")
    seen = engine.compile('''
@copr(args=[])
def names():
    return sorted(k for k in globals() if not k.startswith("__"))
''')
    assert seen.device == engine.device
    assert list(seen()) == ["copr", "coprocessor", "names", "np", "numpy",
                            "torch"]
    with pytest.raises(NameError, match="jnp"):
        engine.run(JNP_BODY.replace("ORDER BY ts", "LIMIT 3"),
                   is_script_text=True)
    made = engine.compile('''
@copr(args=[])
def made():
    return torch.zeros(2), torch.arange(3).float(), torch.tensor([1.0])
''')
    assert all(t.device == engine.device for t in made.fn())


@pytest.mark.parametrize("value, kind", [
    (torch.tensor([1.5, 2.5], dtype=torch.float32), "Float64"),
    (torch.tensor([1.5, 2.5], dtype=torch.float64), "Float64"),
    (torch.tensor([3, 4], dtype=torch.int32), "Int64"),
    (torch.tensor([True, False]), "Boolean"),
    (torch.tensor(7.0), "Float64"),
])
def test_tensor_outputs_type_as_the_reference_types_numpy(value, kind):
    """as_vectors takes a tensor (any device, one fetch); the column type
    is the one the reference gives the same values as numpy."""
    (got,) = as_vectors(value, 1)
    (want,) = ref_as_vectors(value.numpy(), 1)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    assert _np_dtype(got).name == ref_np_dtype(want).name == kind


def test_copr_decorator_matches_reference():
    @copr(args=["a", "b"], returns=["s"])
    def add(a, b):
        return a + b

    @ref_copr(args=["a", "b"], returns=["s"])
    def ref_add(a, b):
        return a + b

    @copr(returns=["v"])
    def inferred(x, y):
        return x * y

    assert (add.arg_names, add.returns, add.output_names()) == \
        (ref_add.arg_names, ref_add.returns, ref_add.output_names())
    assert inferred.arg_names == ["x", "y"] and inferred.device is None
    a, b = np.array([1.0, 2.0]), np.array([10.0, 20.0])
    np.testing.assert_array_equal(add(a, b), ref_add(a, b))
    def outcome(fn, *args):
        try:
            return [v.tolist() for v in fn(*args)]
        except Exception as e:  # noqa: BLE001 — each package's own class
            return f"{type(e).__name__}: {e}"

    for args in (((np.array([1, 2, 3]), 7.0), 2), ((np.array([1.0]),), 2),
                 ((np.array([1, 2]), np.array([1, 2, 3])), 2)):
        assert outcome(as_vectors, *args) == outcome(ref_as_vectors, *args)


def _post(port, path, body):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                               method="POST")
    try:
        with urllib.request.urlopen(r, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_script_routes_match_reference(sides):
    """POST /v1/scripts, then /v1/run-script by name and with a script
    body, and their 400s, through both packages' servers."""
    servers = {"port": HttpServer(sides["port"].fe, addr="127.0.0.1:0"),
               "ref": RefHttpServer(sides["ref"].fe, addr="127.0.0.1:0")}
    got = {}
    try:
        for key, srv in servers.items():
            srv.start()
            answers = [
                _post(srv.port, "/v1/scripts?name=load&db=public",
                      NUMPY_SCRIPTS["load"].encode()),
                _post(srv.port, "/v1/run-script?name=load&db=public", b""),
                _post(srv.port, "/v1/run-script",
                      NUMPY_SCRIPTS["spread"].encode()),
                _post(srv.port, "/v1/scripts", b"x"),
                _post(srv.port, "/v1/run-script", b""),
                _post(srv.port, "/v1/scripts?name=bad", b"x = 1"),
            ]
            for _, doc in answers:
                doc.pop("execution_time_ms", None)
            got[key] = answers
    finally:
        for srv in servers.values():
            srv.shutdown()
    assert got["port"] == got["ref"]
    assert [a[0] for a in got["port"]] == [200, 200, 200, 400, 400, 400]
