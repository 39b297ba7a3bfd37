"""The standalone sqlness goldens through the port, on the CPU.

Each in-scope case of tests/sqlness/cases/standalone/ runs through the
port's own golden runner (greptimedb_tpu_torch/tools/sqlness.py: a fresh
`build_standalone(DatanodeOptions(device="cpu"))` per case) and its
output must byte-match the committed `.result`, the same file the JAX
package's runner is held to (tests/test_sqlness.py).

The copy/* cases run with their '/tmp/sqlness_ files moved under the
case's own data home (the runner rewrites the path it executes and
echoes the statement as written), so parallel runs never share a file.

Out of scope, each waiting for a module of a later slice:
- admin/show_profile, admin/show_trace: the profiler and the trace store
  (common/profiler.py, common/trace_store.py);
- explain/analyze, explain/index_prune: red on the JAX package itself
  (their partial_bytes differ from what it prints under the tests'
  settings); the port prints what the reference prints on them;
- system/failpoints: its profiler_flush row needs common/profiler.py; the
  rest of the case is held to its golden below.

The runner's statement splitter is held to the JAX package's on every
case file.
"""

import sys
from pathlib import Path

import pytest

from greptimedb_tpu_torch.tools import sqlness

sys.path.insert(0, str(Path(__file__).parent / "sqlness"))
import runner as ref_runner  # noqa: E402

IN_SCOPE = list(sqlness.IN_SCOPE)
WAITING = sqlness.WAITING


@pytest.mark.parametrize("case", IN_SCOPE)
def test_golden_matches(case):
    err = sqlness.run_one(sqlness.CASES_DIR / f"{case}.sql", device="cpu")
    assert err is None, f"\n{err}"


def _without_profiler_block(text: str) -> str:
    """The case's output with the one statement about the profiler's
    failpoint (and its result table) taken out."""
    blocks = text.split("\n\n")
    out, skip = [], False
    for b in blocks:
        if "profiler_%" in b:
            skip = True              # the statement; its table follows
            continue
        if skip:
            skip = False
            continue
        out.append(b)
    return "\n\n".join(out)


def test_failpoints_case_apart_from_profiler(tmp_path):
    """system/failpoints.sql through the port: every statement but the
    profiler_flush lookup (common/profiler.py is not ported) byte-matches
    the golden."""
    from greptimedb_tpu_torch.common import background_jobs, failpoint
    from greptimedb_tpu_torch.datanode import DatanodeOptions
    from greptimedb_tpu_torch.frontend import build_standalone
    path = sqlness.CASES_DIR / "system" / "failpoints.sql"
    failpoint.reset()
    background_jobs.reset()
    fe = build_standalone(DatanodeOptions(data_home=str(tmp_path),
                                          device="cpu"))
    try:
        got = sqlness.run_case(path.read_text(), fe)
    finally:
        fe.shutdown()
    want = path.with_suffix(".result").read_text()
    assert "profiler_flush" in want and "profiler_flush" not in got
    assert _without_profiler_block(got) == _without_profiler_block(want)
    assert len(_without_profiler_block(want)) < len(want)


def test_in_scope_cases_exist():
    names = {str(p.relative_to(sqlness.CASES_DIR))[:-4]
             for p in sqlness.case_files([])}
    assert set(IN_SCOPE) | set(WAITING) <= names
    assert len(IN_SCOPE) + len(WAITING) == 37
    assert {c for c in IN_SCOPE if c.startswith("tql/")} == {
        "tql/explain", "tql/operators", "tql/range_functions", "tql/tql"}
    assert {"explain/rollup", "flow/create_flow", "system/background_jobs",
            "copy/copy", "copy/copy_compressed"} <= set(IN_SCOPE)


def test_copy_case_files_stay_under_the_given_directory(tmp_path):
    """run_case executes a copy case's '/tmp/sqlness_ paths as files under
    `files_dir` and echoes each statement as written: the output is the
    golden, and the files are where the runner put them."""
    from greptimedb_tpu_torch.datanode import DatanodeOptions
    from greptimedb_tpu_torch.frontend import build_standalone
    path = sqlness.CASES_DIR / "copy" / "copy_compressed.sql"
    fe = build_standalone(DatanodeOptions(data_home=str(tmp_path / "home"),
                                          device="cpu"))
    try:
        got = sqlness.run_case(path.read_text(), fe,
                               files_dir=str(tmp_path / "files"))
    finally:
        fe.shutdown()
    assert got == path.with_suffix(".result").read_text()
    assert "'/tmp/sqlness_copy_comp.csv.gz'" in got
    assert sorted(p.name for p in (tmp_path / "files").iterdir()) == [
        "sqlness_copy_comp.csv.gz", "sqlness_copy_comp.json.zst"]


@pytest.mark.parametrize(
    "path", sqlness.case_files([]),
    ids=[str(p.relative_to(sqlness.CASES_DIR))[:-4]
         for p in sqlness.case_files([])])
def test_splitter_matches_reference(path):
    text = path.read_text()
    got = sqlness.split_statements(text)
    assert got == ref_runner.split_statements(text)
    assert [sqlness.strip_comment_lines(s) for s in got] == \
        [ref_runner._strip_comment_lines(s) for s in got]


def test_filter_and_missing_cases(tmp_path, capsys):
    cpu = ["--device", "cpu", "--cases", str(tmp_path)]
    assert sqlness.main(cpu + ["nothing"]) == 2
    (tmp_path / "a.sql").write_text("SELECT 1;")
    assert sqlness.main(cpu) == 1
    assert "missing .result" in capsys.readouterr().out
    (tmp_path / "a.result").write_text(
        "SELECT 1;\n\n+---+\n| 1 |\n+---+\n| 1 |\n+---+\n")
    assert sqlness.main(cpu + ["a"]) == 0
