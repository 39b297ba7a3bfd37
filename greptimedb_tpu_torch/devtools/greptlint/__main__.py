"""Command line. ``python -m greptimedb_tpu_torch.devtools.greptlint --help``."""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from . import (ALL_RULES, apply_baseline, build_context, collect_files,
               load_baseline, run_files, save_baseline)

DEFAULT_BASELINE = ".greptlint-baseline.json"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="greptlint",
        description="project-invariant static analyzer (rules GL01-GL12; "
                    "GL10-GL12 are interprocedural over the repo-wide "
                    "call graph)")
    ap.add_argument("paths", nargs="*", default=["greptimedb_tpu_torch"],
                    help="files or directories to scan")
    ap.add_argument("--baseline", metavar="PATH", default=None,
                    help=f"baseline file of grandfathered findings "
                         f"(default: ./{DEFAULT_BASELINE} when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="GLxx", help="run only the named rule(s)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.id}  {r.title}")
        return 0

    rules = ALL_RULES
    if args.rule:
        wanted = {r.upper() for r in args.rule}
        rules = [r for r in ALL_RULES if r.id in wanted]
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"greptlint: unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    baseline_path = args.baseline
    if baseline_path is None and not args.no_baseline and \
            os.path.isfile(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    if args.no_baseline:
        baseline_path = None

    files = collect_files(args.paths)
    if not files:
        print("greptlint: no .py files found under given paths",
              file=sys.stderr)
        return 2
    root = os.path.commonpath([p for p, _ in files])
    ctx = build_context(files, root)
    findings, errors = run_files(files, rules, ctx)

    if args.write_baseline:
        path = args.baseline or DEFAULT_BASELINE
        n = save_baseline(path, findings)
        print(f"greptlint: wrote {n} grandfathered finding(s) to {path}")
        return 0

    fresh = findings
    if baseline_path is not None:
        try:
            fresh = apply_baseline(findings, load_baseline(baseline_path))
        except (OSError, ValueError) as e:
            print(f"greptlint: cannot load baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    for err in errors:
        print(f"greptlint: error: {err}", file=sys.stderr)
    for f in fresh:
        print(f.render())
    grandfathered = len(findings) - len(fresh)
    tail = f" ({grandfathered} grandfathered)" if grandfathered else ""
    print(f"greptlint: scanned {len(files)} files, "
          f"{len(fresh)} finding(s){tail}")
    if errors:
        return 2
    return 1 if fresh else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:     # `greptlint ... | head` closed the pipe
        sys.exit(0)
