"""greptlint: AST-based static analyzer for this repo's invariants.

Usage::

    python -m greptimedb_tpu_torch.devtools.greptlint greptimedb_tpu_torch/

Exit codes: 0 clean (after suppressions + baseline), 1 findings,
2 unusable input (unparseable file / bad flags). See rules.py for the
rule catalog. The port adds no baseline file: its scan is clean with
``--no-baseline``.
"""

from __future__ import annotations

from .core import (Finding, ModuleInfo, ProjectContext, apply_baseline,
                   build_context, collect_files, load_baseline, run_files,
                   save_baseline)
from .rules import ALL_RULES, Rule

__all__ = ["Finding", "ModuleInfo", "ProjectContext", "Rule", "ALL_RULES",
           "collect_files", "build_context", "run_files", "load_baseline",
           "save_baseline", "apply_baseline", "lint_paths"]


def lint_paths(paths, baseline_path=None, rules=None):
    """Library entry point: returns (fresh_findings, all_findings, errors).

    ``fresh_findings`` has the baseline applied (what should fail a
    build); ``all_findings`` is pre-baseline (what --write-baseline
    records)."""
    import os
    rules = ALL_RULES if rules is None else rules
    files = collect_files(paths)
    root = os.path.commonpath([p for p, _ in files]) if files else "."
    ctx = build_context(files, root)
    findings, errors = run_files(files, rules, ctx)
    fresh = findings
    if baseline_path is not None:
        fresh = apply_baseline(findings, load_baseline(baseline_path))
    return fresh, findings, errors
