"""greptlint core: file collection, AST indexing, suppressions, baseline.

The analyzer is rule-based over the stdlib ``ast`` module (no external
dependencies). Each scanned file is parsed **once** into a
:class:`ModuleInfo` carrying the tree, a parent map, and a by-node-type
index; rules (see ``rules.py``) query the index instead of re-walking,
so adding a rule costs one dict lookup per node type, not a fresh pass.

Suppressions are comment-driven and reviewable in diffs:

- ``# greptlint: disable=GL01`` (trailing or own-line) silences the
  named rule(s) on that line;
- ``# greptlint: disable-file=GL03`` anywhere in the file silences the
  rule(s) for the whole file. ``all`` matches every rule.

The baseline file grandfathers pre-existing findings: keys are
``RULE:relpath:crc32(stripped source line)`` (line-number independent,
so unrelated edits don't churn it) with an occurrence count. Findings
beyond the baselined count fail the run; fixing findings never does.
"""

from __future__ import annotations

import ast
import json
import logging
import os
import re
import zlib
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

SUPPRESS_RE = re.compile(
    r"#\s*greptlint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")

#: directories never collected when walking (explicit file args still scan)
SKIP_DIRS = frozenset({"__pycache__", "selftest", ".git"})


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # absolute path
    rel: str           # path relative to the scan root (stable key part)
    line: int
    col: int
    msg: str
    source_line: str = ""

    def baseline_key(self) -> str:
        crc = zlib.crc32(self.source_line.strip().encode()) & 0xFFFFFFFF
        return f"{self.rule}:{self.rel}:{crc:08x}"

    def render(self) -> str:
        return f"{self.rel}:{self.line}:{self.col}: {self.rule} {self.msg}"


class ModuleInfo:
    """One parsed file: tree + parent map + node index + suppressions."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.by_type: Dict[type, List[ast.AST]] = defaultdict(list)
        for node in ast.walk(self.tree):
            self.by_type[type(node)].append(node)
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.line_suppressed: Dict[int, Set[str]] = {}
        self.file_suppressed: Set[str] = set()
        for i, text in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip().upper() for r in m.group(2).split(",")}
            if m.group(1) == "disable-file":
                self.file_suppressed |= rules
            else:
                self.line_suppressed.setdefault(i, set()).update(rules)

    def nodes(self, *types: type) -> Iterator[ast.AST]:
        for t in types:
            yield from self.by_type.get(t, ())

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        if "ALL" in self.file_suppressed or rule in self.file_suppressed:
            return True
        on_line = self.line_suppressed.get(lineno, ())
        return rule in on_line or "ALL" in on_line

    def finding(self, rule: str, node: ast.AST, msg: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.path, rel=self.rel,
                       line=lineno, col=col, msg=msg,
                       source_line=self.line_text(lineno))


@dataclass
class FunctionInfo:
    """One function/method in the repo-wide call graph."""
    name: str                      # bare def name ("do_query")
    qual: str                      # "rel:Class.name" / "rel:name"
    rel: str
    cls: Optional[str]             # enclosing class name, if a method
    node: ast.AST                  # the FunctionDef/AsyncFunctionDef
    mod: "ModuleInfo"
    calls: Set[str] = field(default_factory=set)       # callee leaf names
    #: failpoint names this function evaluates via fail_point/fires
    failpoint_sites: Set[str] = field(default_factory=set)

    def __hash__(self) -> int:
        return hash(self.qual)


class CallGraph:
    """Repo-wide, name-resolved call graph (the interprocedural tier).

    Resolution is intentionally approximate — Python has no static
    receiver types — and biased toward *precision*: a call edge links a
    callee name to every same-named def, EXCEPT when the name is so
    common (> ``hub_limit`` defs: ``get``, ``run``, ...) that following
    it would connect everything to everything. Over-approximate hubs
    would drown GL10/GL11 in unfixable findings; dropping them only
    shrinks reach, which for a zero-budget gate is the right failure
    mode (greptlint stays a no-false-positive tool first)."""

    def __init__(self, hub_limit: int = 8):
        self.hub_limit = hub_limit
        self.functions: List[FunctionInfo] = []
        self.defs: Dict[str, List[FunctionInfo]] = defaultdict(list)
        #: callee leaf names invoked from module top level, per rel
        self.module_calls: Dict[str, Set[str]] = defaultdict(set)
        #: failpoint names evaluated at module top level, per rel
        #: (registration-time probes — trivially reachable for GL12)
        self.module_failpoint_sites: Dict[str, Set[str]] = \
            defaultdict(set)

    def add_module(self, mod: "ModuleInfo") -> None:
        for fn in _index_functions(mod):
            self.functions.append(fn)
            self.defs[fn.name].append(fn)
        self.module_calls[mod.rel] |= _module_level_calls(mod)
        for node in _walk_outside_functions(mod.tree):
            if isinstance(node, ast.Call) and \
                    _call_leaf(node) in ("fail_point", "fires"):
                name = _str_arg0(node)
                if name:
                    self.module_failpoint_sites[mod.rel].add(name)

    def targets(self, callee: str) -> List[FunctionInfo]:
        cands = self.defs.get(callee, [])
        if len(cands) > self.hub_limit:
            return []                      # hub: following it links all
        return cands

    def reachable(self, roots: Iterable[FunctionInfo]
                  ) -> Dict[FunctionInfo, Tuple[str, ...]]:
        """BFS closure: {function: call path from its nearest root}."""
        out: Dict[FunctionInfo, Tuple[str, ...]] = {}
        queue: List[FunctionInfo] = []
        for r in roots:
            if r not in out:
                out[r] = (r.qual,)
                queue.append(r)
        while queue:
            fn = queue.pop(0)
            path = out[fn]
            for callee in sorted(fn.calls):
                for tgt in self.targets(callee):
                    if tgt not in out:
                        out[tgt] = path + (tgt.qual,)
                        queue.append(tgt)
        return out

    def has_caller(self, fn: FunctionInfo) -> bool:
        """Anything (another function, or module top level) calls this
        name — the GL12 'reachable from at least one non-test caller'
        floor. By-name: a same-named sibling's caller counts, which only
        makes the check more permissive (never a false positive)."""
        for other in self.functions:
            if other is not fn and fn.name in other.calls:
                return True
        return any(fn.name in calls
                   for calls in self.module_calls.values())


def _module_level_calls(mod: "ModuleInfo") -> Set[str]:
    out: Set[str] = set()
    for node in _walk_outside_functions(mod.tree):
        if isinstance(node, ast.Call):
            leaf = _call_leaf(node)
            if leaf:
                out.add(leaf)
    return out


def _walk_outside_functions(tree: ast.AST) -> Iterator[ast.AST]:
    stack: List[ast.AST] = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _call_leaf(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _str_arg0(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def _index_functions(mod: "ModuleInfo") -> Iterator[FunctionInfo]:
    for node in mod.nodes(ast.FunctionDef, ast.AsyncFunctionDef):
        cls = None
        for anc in mod.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cls = None
                break                     # nested def: attribute to the
            if isinstance(anc, ast.ClassDef):   # innermost def only
                cls = anc.name
                break
        qual = f"{mod.rel}:{cls + '.' if cls else ''}{node.name}"
        fi = FunctionInfo(name=node.name, qual=qual, rel=mod.rel,
                          cls=cls, node=node, mod=mod)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                leaf = _call_leaf(sub)
                if leaf:
                    fi.calls.add(leaf)
                    if leaf in ("fail_point", "fires"):
                        name = _str_arg0(sub)
                        if name:
                            fi.failpoint_sites.add(name)
        yield fi


@dataclass
class ProjectContext:
    """Cross-file facts collected in a pre-pass before rules run."""
    root: str
    #: failpoint names registered anywhere (static `register("x")` calls
    #: across the scanned tree, unioned with the live registry when the
    #: package is importable) — GL04 checks call sites against this
    failpoint_names: Set[str] = field(default_factory=set)
    errors: List[str] = field(default_factory=list)
    #: abs path -> source read by build_context's pre-pass, consumed by
    #: run_files so each file hits the disk once, not twice
    sources: Dict[str, str] = field(default_factory=dict)
    #: abs path -> parsed ModuleInfo (one parse per file; run_files and
    #: the call-graph pre-pass share it)
    modules: Dict[str, "ModuleInfo"] = field(default_factory=dict)
    #: abs path -> parse error string (reported by run_files)
    parse_errors: Dict[str, str] = field(default_factory=dict)
    #: the repo-wide call graph (interprocedural rules GL10-GL12)
    callgraph: CallGraph = field(default_factory=CallGraph)
    #: failpoint name -> (rel, lineno) of its STATIC register("x") call
    #: within the scanned files (unlike failpoint_names this never
    #: unions the live registry: GL12 reasons about the scanned tree)
    registered_failpoints: Dict[str, Tuple[str, int]] = \
        field(default_factory=dict)
    #: exception class names participating in the errors.* taxonomy
    #: (GreptimeError + every transitive subclass defined anywhere)
    taxonomy: Set[str] = field(default_factory=set)
    #: per-run scratch for rules that compute expensive whole-graph
    #: closures once (reachability sets) — keyed by rule id
    cache: Dict[str, object] = field(default_factory=dict)


def _package_rel(path: str) -> str:
    """rel for an explicitly-passed file, matching what a directory scan
    of its containing package would produce: climb while ``__init__.py``
    marks a package, then relativize from the package root's parent.
    Path-scoped rules (GL05/GL07) and baseline keys would otherwise see
    a bare basename on single-file scans and silently not apply."""
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.path.relpath(path, d)


def collect_files(paths: Iterable[str]) -> List[Tuple[str, str]]:
    """Expand files/directories into (abs_path, rel_path) pairs.

    Directory walks skip SKIP_DIRS (fixtures with seeded violations live
    under ``selftest/``); a path given explicitly is always scanned."""
    out: List[Tuple[str, str]] = []
    seen: Set[str] = set()
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            rel = _package_rel(p)
            if p not in seen:
                seen.add(p)
                out.append((p, rel))
            continue
        base = os.path.dirname(p.rstrip(os.sep))
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                ap = os.path.join(dirpath, fn)
                if ap in seen:
                    continue
                seen.add(ap)
                out.append((ap, os.path.relpath(ap, base)))
    return out


# matches plain `register("x")` and aliased imports like
# `from ..common.failpoint import register as _fp_register` — any
# identifier ENDING in `register` counts (over-matching only shrinks
# GL04's reach, never produces a false positive)
_REGISTER_RE = re.compile(r"""\b\w*register\(\s*["']([a-z][a-z0-9_]*)["']""")


def build_context(files: List[Tuple[str, str]], root: str) -> ProjectContext:
    """Pre-pass: read + parse every file ONCE, build the repo-wide call
    graph and the cross-file fact tables the interprocedural rules
    (GL10-GL12) consume. run_files reuses the parsed ModuleInfos."""
    ctx = ProjectContext(root=root)
    for path, rel in files:
        try:
            with open(path, encoding="utf-8") as f:
                src = f.read()
        except OSError as e:
            ctx.errors.append(f"{path}: unreadable: {e}")
            continue
        ctx.sources[path] = src
        ctx.failpoint_names.update(_REGISTER_RE.findall(src))
        try:
            mod = ModuleInfo(path, rel, src)
        except (SyntaxError, ValueError) as e:
            ctx.parse_errors[path] = f"{rel}: cannot parse: {e}"
            continue
        ctx.modules[path] = mod
        ctx.callgraph.add_module(mod)
        _collect_registered_failpoints(mod, ctx)
    _collect_taxonomy(ctx)
    # union the live registry: names registered by modules outside the
    # scanned set (the analyzer may be pointed at one subpackage)
    try:
        from ...common import failpoint
        ctx.failpoint_names.update(p["name"] for p in failpoint.list_points())
    except Exception as e:  # noqa: BLE001 — linting must not require a
        # fully importable package (e.g. scanning a broken tree); the
        # static register() sweep above already covers the common case,
        # so degrade to it with a note rather than failing the run
        logger.warning("greptlint: live failpoint registry unavailable "
                       "(%s); GL04 uses the static register() sweep only",
                       e)
    return ctx


def _collect_registered_failpoints(mod: ModuleInfo,
                                   ctx: ProjectContext) -> None:
    for call in mod.nodes(ast.Call):
        if _call_leaf(call).endswith("register"):
            name = _str_arg0(call)
            if name:
                ctx.registered_failpoints.setdefault(
                    name, (mod.rel, getattr(call, "lineno", 1)))


def _collect_taxonomy(ctx: ProjectContext) -> None:
    """Fixpoint over class defs: GreptimeError + every transitive
    subclass, wherever it is defined (errors.py, failpoint.py, meta
    modules...) — the set of raise targets GL10 accepts as wire-typed."""
    bases_of: Dict[str, Set[str]] = {}
    for mod in ctx.modules.values():
        for cls in mod.nodes(ast.ClassDef):
            names = set()
            for b in cls.bases:
                leaf = b.attr if isinstance(b, ast.Attribute) else \
                    b.id if isinstance(b, ast.Name) else ""
                if leaf:
                    names.add(leaf)
            bases_of.setdefault(cls.name, set()).update(names)
    taxonomy = {"GreptimeError"}
    changed = True
    while changed:
        changed = False
        for cls, bases in bases_of.items():
            if cls not in taxonomy and bases & taxonomy:
                taxonomy.add(cls)
                changed = True
    ctx.taxonomy = taxonomy


def run_files(files: List[Tuple[str, str]], rules: "Iterable",
              ctx: ProjectContext) -> Tuple[List[Finding], List[str]]:
    """Run every rule over the pre-parsed modules; returns (findings,
    errors). Suppression comments are honored here so every rule gets
    them free. Files absent from ctx (a ctx built by a different caller)
    parse on demand."""
    findings: List[Finding] = []
    errors: List[str] = list(ctx.errors)
    for path, rel in files:
        if path in ctx.parse_errors:
            errors.append(ctx.parse_errors[path])
            continue
        mod = ctx.modules.get(path)
        if mod is None:
            try:
                source = ctx.sources.pop(path, None)
                if source is None:       # ctx built by a different caller
                    with open(path, encoding="utf-8") as f:
                        source = f.read()
                mod = ModuleInfo(path, rel, source)
            except (OSError, SyntaxError, ValueError) as e:
                errors.append(f"{rel}: cannot parse: {e}")
                continue
        for rule in rules:
            for fnd in rule.check(mod, ctx):
                if not mod.suppressed(fnd.rule, fnd.line):
                    findings.append(fnd)
    findings.sort(key=lambda f: (f.rel, f.line, f.rule))
    return findings, errors


# ---- baseline ------------------------------------------------------

def load_baseline(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != 1:
        raise ValueError(f"unsupported baseline format in {path}")
    return {str(k): int(v) for k, v in doc.get("findings", {}).items()}


def save_baseline(path: str, findings: List[Finding]) -> int:
    counts = Counter(f.baseline_key() for f in findings)
    doc = {"version": 1, "findings": dict(sorted(counts.items()))}
    from ...utils import atomic_write
    atomic_write(path, json.dumps(doc, indent=1) + "\n", fsync=False)
    return sum(counts.values())


def apply_baseline(findings: List[Finding],
                   baseline: Dict[str, int]) -> List[Finding]:
    """Drop findings covered by the baseline; the overflow (more
    occurrences of a key than grandfathered) stays reported."""
    budget = Counter(baseline)
    fresh: List[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            fresh.append(f)
    return fresh
