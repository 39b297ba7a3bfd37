"""The port's greptlint (greptimedb_tpu_torch/devtools/greptlint) held to
the reference's (greptimedb_tpu/devtools/greptlint) on the same inputs.

- Both linters give the same findings (rule, file, line, column and
  message) on the reference's selftest fixtures, on `greptimedb_tpu/`
  and on `greptimedb_tpu_torch/`, and on the synthetic sources of the
  reference's regression tests (tests/test_greptlint.py).
- The rule catalogs are the same, ids and titles.
- Every port rule fires on the port's own fixture, and each fixture
  triggers only its rule; the port's CLI exits 1 on its fixtures and 0
  on the port.
- The suppression comment and the line-move-stable baseline behave as
  the reference's.
- The port's scan is clean with no baseline: the port adds no greptlint
  baseline file.

Each directory scan takes seconds, so each (linter, tree) scan runs once
per module and the cases share it.
"""

from __future__ import annotations

import functools
import glob
import os
import subprocess
import sys

import pytest

from greptimedb_tpu.devtools import greptlint as ref_lint
from greptimedb_tpu_torch.devtools import greptlint as port_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO, "greptimedb_tpu")
PORT_PKG = os.path.join(REPO, "greptimedb_tpu_torch")
REF_SELFTEST = os.path.join(REF_PKG, "devtools", "greptlint", "selftest")
PORT_SELFTEST = os.path.join(PORT_PKG, "devtools", "greptlint", "selftest")
LINTERS = {"ref": ref_lint, "port": port_lint}
TREES = {"ref_fixtures": REF_SELFTEST, "ref_package": REF_PKG,
         "port_package": PORT_PKG}


def _key(f):
    return (f.rule, f.rel, f.line, f.col, f.msg)


@functools.lru_cache(maxsize=None)
def scan(linter, tree):
    """(findings as tuples, errors) of one linter over one tree, no
    baseline."""
    path = TREES.get(tree, tree)
    _fresh, found, errors = LINTERS[linter].lint_paths([path])
    return [_key(f) for f in found], list(errors)


@pytest.mark.parametrize("tree", sorted(TREES))
def test_port_finds_what_the_reference_finds(tree):
    ref, ref_errors = scan("ref", tree)
    port, port_errors = scan("port", tree)
    assert not ref_errors and not port_errors, (ref_errors, port_errors)
    assert port == ref


def test_reference_fixtures_fire_every_rule():
    """The comparison above is not vacuous: every rule fires on the
    reference's fixtures, in both linters."""
    found, _ = scan("port", "ref_fixtures")
    assert {f[0] for f in found} == {r.id for r in port_lint.ALL_RULES}


@pytest.mark.parametrize("linter", sorted(LINTERS))
def test_port_package_is_clean_without_a_baseline(linter):
    found, errors = scan(linter, "port_package")
    assert not errors, errors
    assert found == [], "\n".join(map(str, found))


def test_no_baseline_file_for_the_port():
    assert not glob.glob(os.path.join(PORT_PKG, "**", "*baseline*.json"),
                         recursive=True)


def test_rule_catalog_is_the_references():
    assert [(r.id, r.title) for r in port_lint.ALL_RULES] == \
        [(r.id, r.title) for r in ref_lint.ALL_RULES]
    ids = [r.id for r in port_lint.ALL_RULES]
    assert len(ids) == len(set(ids)) and all(
        r.title for r in port_lint.ALL_RULES)


def _fixture_for(rule_id):
    hits = glob.glob(os.path.join(PORT_SELFTEST,
                                  f"{rule_id.lower()}_*.py"))
    assert len(hits) == 1, hits
    return hits[0]


@pytest.mark.parametrize("rule", [r.id for r in port_lint.ALL_RULES])
def test_rule_fires_on_its_port_fixture(rule):
    fixture = os.path.basename(_fixture_for(rule))
    found, errors = scan("port", PORT_SELFTEST)
    assert not errors, errors
    assert [f for f in found
            if f[0] == rule and os.path.basename(f[1]) == fixture]


def test_port_fixtures_trigger_only_their_own_rule():
    found, _ = scan("port", PORT_SELFTEST)
    by_file = {}
    for f in found:
        by_file.setdefault(os.path.basename(f[1]), []).append(f[0])
    assert len(by_file) == len(port_lint.ALL_RULES)
    for fname, rules in sorted(by_file.items()):
        assert rules == [fname.split("_", 1)[0].upper()], (fname, rules)


def test_port_fixtures_match_the_references():
    """The port's fixtures are the reference's, but for the one import
    that names a package: the same findings, rule by rule and line by
    line."""
    def strip(found):
        return [(r, os.path.basename(rel), ln, col)
                for r, rel, ln, col, _m in found]
    assert strip(scan("port", PORT_SELFTEST)[0]) == \
        strip(scan("ref", "ref_fixtures")[0])


@pytest.mark.parametrize("target,code", [(PORT_SELFTEST, 1), (PORT_PKG, 0)],
                         ids=["fixtures", "port"])
def test_cli_exit_codes(target, code):
    proc = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.devtools.greptlint",
         target, "--no-baseline"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == code, proc.stdout[-3000:] + proc.stderr
    if code:
        for rule in port_lint.ALL_RULES:
            assert rule.id in proc.stdout
    assert "finding(s)" in proc.stdout.splitlines()[-1]


def test_cli_lists_the_catalog_and_defaults_to_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "greptimedb_tpu_torch.devtools.greptlint",
         "--list-rules"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == \
        [r.id for r in port_lint.ALL_RULES]
    from greptimedb_tpu_torch.devtools.greptlint import __main__ as cli
    assert cli.main(["--rule", "GL99"]) == 2


# ---- the reference's regression inputs, through both linters ----------

BARE_RENAME = 'import os\n\ndef f():\n    os.replace("a", "b")\n'

#: (name, {relative path: source}) from tests/test_greptlint.py
SOURCES = {
    "bare_rename": {"mod.py": BARE_RENAME},
    "suppressed_rename": {"mod.py": BARE_RENAME.replace(
        'os.replace("a", "b")',
        'os.replace("a", "b")  # greptlint: disable=GL03')},
    "gl04_aliased_register": {"site.py": (
        "from greptimedb_tpu.common.failpoint import register as "
        "_fp_register\n"
        "from greptimedb_tpu.common.failpoint import fail_point\n"
        '_fp_register("aliased_point_regression")\n'
        "def f():\n"
        '    fail_point("aliased_point_regression")\n')},
    "gl09_module_alias": {"aliased_metric.py": (
        "import prometheus_client as pc\n"
        "from collections import Counter\n"
        'M = pc.Counter("aliased_total", "dodges the from-import check")\n'
        'C = Counter("abc")          # collections, not a metric\n')},
    "gl10_taxonomy": {"servers/__init__.py": "", "servers/flight.py": (
        "class GreptimeError(Exception):\n    pass\n"
        "class MyTyped(GreptimeError):\n    pass\n"
        "class Untyped(Exception):\n    pass\n"
        "class Srv:\n"
        "    def do_get(self, t):\n"
        "        remote_context(None)\n"
        "        a()\n        b()\n        c()\n        d()\n        e()\n"
        "def a():\n    raise MyTyped('fine')\n"
        "def b():\n    raise _convert('fine')\n"
        "def c():\n    raise Untyped('flagged')\n"
        "def d():\n    raise RuntimeError\n"
        "def e(exc=None):\n"
        "    try:\n        a()\n"
        "    except Exception as err:\n        raise err\n"
        "def _convert(m):\n    return MyTyped(m)\n")},
    "gl11_io_loop": {"query/__init__.py": "", "query/exec.py": (
        "register('objstore_read')\n"
        "def do_query(files):\n"
        "    for f in files:\n"
        "        _read(f)\n"
        "def _read(f):\n"
        "    fail_point('objstore_read')\n")},
    "gl11_io_loop_checked": {"query/__init__.py": "", "query/exec.py": (
        "register('objstore_read')\n"
        "def do_query(files):\n"
        "    for f in files:\n"
        "        _read(f)\n"
        "def _read(f):\n"
        "    check_cancelled()\n"
        "    fail_point('objstore_read')\n")},
    "gl11_wait_loop": {"query/__init__.py": "", "query/cohort.py": (
        "def follow(batch):\n"
        "    while not batch.done.is_set():\n"
        "        batch.done.wait()\n"
        "    return batch.result\n")},
    "gl11_wait_loop_bounded": {"query/__init__.py": "", "query/cohort.py": (
        "def follow(batch):\n"
        "    while not batch.done.is_set():\n"
        "        batch.done.wait(timeout=0.05)\n"
        "    return batch.result\n")},
    "gl12_dead_sites": {"sites.py": (
        "register('never_evaluated')\n"
        "register('orphan_site')\n"
        "register('live_site')\n"
        "def _orphan():\n    fail_point('orphan_site')\n"
        "def _live():\n    fail_point('live_site')\n"
        "def flush():\n    _live()\n"
        "def entry():\n    flush()\n")},
    "gl13_background_roots": {"storage/engine.py": (
        "class Engine:\n"
        "    def start(self):\n"
        "        self._t1 = RepeatedTask(5.0, self._covered_tick)\n"
        "        self._t2 = RepeatedTask(5.0, self._rootless_tick)\n"
        "        self.scheduler.submit('flush:x', self._covered_job)\n"
        "        self._t3 = RepeatedTask(5.0, lambda: None)\n"
        "    def _covered_tick(self):\n"
        "        self._do_work()\n"
        "    def _do_work(self):\n"
        "        with job('flush', region='r'):\n"
        "            pass\n"
        "    def _covered_job(self):\n"
        "        with root_span('job_flush'):\n"
        "            pass\n"
        "    def _rootless_tick(self):\n"
        "        sweep()\n")},
}

#: the rules each source must raise, as the reference's tests expect
EXPECTED = {
    "bare_rename": ["GL03"], "suppressed_rename": [],
    "gl04_aliased_register": [], "gl09_module_alias": ["GL09"],
    "gl10_taxonomy": ["GL10", "GL10"], "gl11_io_loop": ["GL11"],
    "gl11_io_loop_checked": [], "gl11_wait_loop": ["GL11"],
    "gl11_wait_loop_bounded": [], "gl12_dead_sites": ["GL12", "GL12"],
    "gl13_background_roots": ["GL13"],
}
RULES_OF = {"gl04": "GL04", "gl09": "GL09", "gl10": "GL10", "gl11": "GL11",
            "gl12": "GL12", "gl13": "GL13"}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_regression_inputs_answer_alike(name, tmp_path):
    for rel, src in SOURCES[name].items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    got = {k: [_key(f) for f in LINTERS[k].lint_paths([str(tmp_path)])[0]]
           for k in LINTERS}
    assert got["port"] == got["ref"]
    rule = RULES_OF.get(name.split("_", 1)[0])
    rules = [f[0] for f in got["port"] if rule is None or f[0] == rule]
    assert rules == EXPECTED[name], got["port"]


def test_baseline_is_line_move_stable(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(BARE_RENAME)
    _f, all1, _e = port_lint.lint_paths([str(p)])
    bl = str(tmp_path / "bl.json")
    assert port_lint.save_baseline(bl, all1) == 1
    p.write_text('import os\n\nX = 1\nY = 2\n\ndef f():\n'
                 '    os.replace("a", "b")\n')
    fresh, found, _e = port_lint.lint_paths([str(p)], baseline_path=bl)
    assert fresh == [] and len(found) == 1
    # the reference reads the same baseline file alike
    assert ref_lint.lint_paths([str(p)], baseline_path=bl)[0] == []
    p.write_text(BARE_RENAME + '\ndef g():\n    os.replace("c", "d")\n')
    fresh, _a, _e = port_lint.lint_paths([str(p)], baseline_path=bl)
    assert [f.line for f in fresh] == [7]


def test_single_file_scan_matches_directory_scan():
    from greptimedb_tpu_torch.devtools.greptlint.core import collect_files
    target = os.path.join(PORT_PKG, "storage", "scheduler.py")
    [(path, rel)] = collect_files([target])
    assert rel == os.path.join("greptimedb_tpu_torch", "storage",
                               "scheduler.py")
    assert dict(collect_files([PORT_PKG]))[path] == rel


def test_callgraph_resolves_calls_and_drops_hubs(tmp_path):
    from greptimedb_tpu_torch.devtools.greptlint.core import (
        build_context, collect_files)
    (tmp_path / "many.py").write_text("\n".join(
        f"class C{i}:\n    def common(self):\n        pass"
        for i in range(12)))
    (tmp_path / "m.py").write_text(
        "def caller():\n    unique()\n    common()\n"
        "def unique():\n    pass\n"
        "def common():\n    pass\n")
    cg = build_context(collect_files([str(tmp_path)]),
                       str(tmp_path)).callgraph
    [caller] = [f for f in cg.functions if f.name == "caller"]
    assert {t.name for t in cg.targets("unique")} == {"unique"}
    assert cg.targets("common") == []
    reach = cg.reachable([caller])
    assert any(f.name == "unique" for f in reach)
    assert not any(f.name == "common" for f in reach)


def test_the_port_lints_the_burned_down_sites():
    """The 14 findings the reference's linter raised on the port before
    the burn-down stay fixed, each the way it was fixed: typed errors
    that still catch as RuntimeError, build_info and the streaming knobs
    written under their module locks, the compiler's output published
    through utils.atomic_publish."""
    from greptimedb_tpu_torch.errors import (DeviceUnavailableError,
                                             GreptimeError, KernelError,
                                             StatusCode)
    for cls in (DeviceUnavailableError, KernelError):
        assert issubclass(cls, GreptimeError)
        assert issubclass(cls, RuntimeError)
        assert cls("x").status_code == StatusCode.INTERNAL
    src = open(os.path.join(PORT_PKG, "ops", "cuda_build.py")).read()
    assert "os.replace" not in src and "atomic_publish(" in src
