"""greptlint rules GL01-GL14: the project's load-bearing conventions.

GL01-GL09 are per-file; GL10-GL12 are *interprocedural* — they consume
the repo-wide call graph core.build_context assembles (exception-flow,
cancellation reachability, failpoint reachability).

Each rule is grounded in a real past bug class (see README "Static
analysis & invariants"); together they turn review folklore into a
build gate. Rules are small classes over the shared
:class:`~..core.ModuleInfo` index; to add one, subclass :class:`Rule`,
give it an ``id``/``title``, implement ``check``, append it to
:data:`ALL_RULES`, and drop a seeded-violation fixture into
``selftest/`` (tests/test_torch_greptlint.py picks it up automatically).

Path scoping note: scoped rules (GL05 storage/client/meta, GL07
servers/) also match ``selftest/`` so each rule's fixture can live with
the analyzer instead of being planted into production packages.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import (Finding, ModuleInfo, ProjectContext, _call_leaf,
                   _str_arg0)


def _segments(rel: str) -> List[str]:
    return rel.replace("\\", "/").split("/")


def _in_dirs(rel: str, dirs: Sequence[str]) -> bool:
    segs = _segments(rel)[:-1]
    return any(d in segs for d in dirs)


def _is_module(rel: str, names: Sequence[str]) -> bool:
    norm = rel.replace("\\", "/")
    return any(norm.endswith(n) for n in names)


def _dotted(node: ast.AST) -> str:
    """'os.path.join' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _walk_shallow(stmts: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class
    bodies (their control flow doesn't handle THIS except block)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class Rule:
    id: str = "GL00"
    title: str = ""

    def check(self, mod: ModuleInfo,
              ctx: ProjectContext) -> Iterator[Finding]:
        raise NotImplementedError


def _catches(handler: ast.ExceptHandler, names: Set[str]) -> bool:
    t = handler.type
    types = t.elts if isinstance(t, ast.Tuple) else [t] if t else []
    for e in types:
        d = _dotted(e)
        if d.split(".")[-1] in names:
            return True
    return False


#: attribute names whose call inside a handler counts as "dealt with it":
#: logging, metric counters, error recording / waiter hand-off
_HANDLED_CALL_ATTRS = frozenset({
    "exception", "error", "warning", "warn", "critical", "info", "debug",
    "log", "inc", "observe", "observe_latency", "increment_counter",
    "record", "_finish", "put_nowait", "submit_later", "add_error",
    "set_exception",
})
_HANDLED_CALL_NAMES = frozenset({
    "increment_counter", "observe_latency", "logged", "record_error",
    "print",                                # CLI/REPL error reporting
})


def _handler_deals_with_it(handler: ast.ExceptHandler) -> bool:
    for node in _walk_shallow(handler.body):
        if isinstance(node, (ast.Raise, ast.Return)):
            return True
        if isinstance(node, ast.AugAssign):
            return True                      # counter bump (x += 1)
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _HANDLED_CALL_ATTRS:
                return True
            if isinstance(node.func, ast.Name) and \
                    node.func.id in _HANDLED_CALL_NAMES:
                return True
    return False


class SwallowedException(Rule):
    id = "GL01"
    title = ("`except Exception`/bare `except` must log, re-raise, count, "
             "or return a degraded value — silent swallows hide real bugs")

    def check(self, mod, ctx):
        for h in mod.nodes(ast.ExceptHandler):
            bare = h.type is None
            if not bare and not _catches(h, {"Exception"}):
                continue
            if _handler_deals_with_it(h):
                continue
            what = "bare `except:`" if bare else "`except Exception`"
            yield mod.finding(
                self.id, h,
                f"{what} swallows the error: the handler neither logs, "
                f"re-raises, counts, nor returns a degraded value")


class BaseExceptionCaught(Rule):
    id = "GL02"
    title = ("catching BaseException/SimulatedCrash without re-raising "
             "defeats crash-injection (SimulatedCrash must behave like "
             "SIGKILL outside tests/torture.py)")

    EXEMPT = ("tests/torture.py",)

    def check(self, mod, ctx):
        if _is_module(mod.rel, self.EXEMPT):
            return
        for h in mod.nodes(ast.ExceptHandler):
            bare = h.type is None
            broad = _catches(h, {"BaseException", "SimulatedCrash"})
            if not (bare or broad):
                continue
            if any(isinstance(n, ast.Raise)
                   for n in _walk_shallow(h.body)):
                continue
            what = ("bare `except:`" if bare else
                    "`except BaseException`/`except SimulatedCrash`")
            yield mod.finding(
                self.id, h,
                f"{what} without re-raise can swallow SimulatedCrash — "
                f"crash-injection recovery paths must not survive a "
                f"simulated kill; re-raise or narrow the catch")


class BareRename(Rule):
    id = "GL03"
    title = ("os.rename/os.replace outside utils.atomic_write: durable "
             "renames must go through the one fsync-then-rename helper")

    EXEMPT = ("utils/__init__.py",)

    def check(self, mod, ctx):
        if _is_module(mod.rel, self.EXEMPT):
            return
        for call in mod.nodes(ast.Call):
            d = _dotted(call.func)
            if d in ("os.rename", "os.replace"):
                yield mod.finding(
                    self.id, call,
                    f"direct {d}() — route durable write-then-rename "
                    f"through utils.atomic_write (temp file, fsync, "
                    f"rename, crash-safe cleanup)")


class UnknownFailpoint(Rule):
    id = "GL04"
    title = ("failpoint.fail_point/fires(name) literals must name a "
             "registered point — typos otherwise only WARN at runtime")

    def check(self, mod, ctx):
        for call in mod.nodes(ast.Call):
            fn = call.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else "")
            if name not in ("fail_point", "fires"):
                continue
            if not call.args:
                continue
            arg = call.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            if arg.value not in ctx.failpoint_names:
                yield mod.finding(
                    self.id, call,
                    f"failpoint {arg.value!r} is not registered anywhere "
                    f"(known: {len(ctx.failpoint_names)} names) — typo'd "
                    f"sites never fire")


class UntypedRaise(Rule):
    id = "GL05"
    title = ("raising bare Exception/RuntimeError in storage/client/meta "
             "bypasses the errors.* taxonomy the retry layer classifies")

    SCOPE = ("storage", "client", "meta", "selftest")
    BAD = {"Exception", "RuntimeError"}

    def check(self, mod, ctx):
        if not _in_dirs(mod.rel, self.SCOPE):
            return
        for node in mod.nodes(ast.Raise):
            exc = node.exc
            target = exc.func if isinstance(exc, ast.Call) else exc
            d = _dotted(target) if target is not None else ""
            if d in self.BAD:
                yield mod.finding(
                    self.id, node,
                    f"raise {d} in a retry-classified layer — raise a "
                    f"GreptimeError subclass (errors.py) so "
                    f"is_transient()/status codes stay meaningful")


class RawThreadConstruction(Rule):
    id = "GL06"
    title = ("ThreadPoolExecutor/threading.Thread construction outside "
             "common/runtime.py: bespoke pools bypass telemetry."
             "propagate() and detach spans/ExecStats from their query")

    EXEMPT = ("common/runtime.py", "common/telemetry.py",
              "storage/scheduler.py")

    def check(self, mod, ctx):
        if _is_module(mod.rel, self.EXEMPT):
            return
        for call in mod.nodes(ast.Call):
            d = _dotted(call.func)
            leaf = d.split(".")[-1]
            if leaf not in ("Thread", "ThreadPoolExecutor", "Timer"):
                continue
            if d not in ("Thread", "threading.Thread", "threading.Timer",
                         "Timer", "ThreadPoolExecutor",
                         "concurrent.futures.ThreadPoolExecutor",
                         "futures.ThreadPoolExecutor"):
                continue
            yield mod.finding(
                self.id, call,
                f"direct {d}() — use common.runtime (new_thread / "
                f"transient_executor / the shared runtimes) so workers "
                f"inherit the caller's trace + ExecStats context")


class UntracedHandler(Rule):
    id = "GL07"
    title = ("servers/ RPC handlers must join the caller's trace: Flight "
             "do_get/do_put/do_action need remote_context, HTTP handlers "
             "moving work off-thread need _traced_call")

    SCOPE = ("servers", "selftest")
    FLIGHT_METHODS = ("do_get", "do_put", "do_action", "do_exchange")
    TRACE_NAMES = frozenset({"remote_context", "current_traceparent",
                             "parse_traceparent"})

    def _refs(self, fn: ast.AST, names: Set[str],
              attrs: Set[str]) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and node.id in names:
                return True
            if isinstance(node, ast.Attribute) and node.attr in (names
                                                                 | attrs):
                return True
        return False

    def check(self, mod, ctx):
        if not _in_dirs(mod.rel, self.SCOPE):
            return
        for cls in mod.nodes(ast.ClassDef):
            for stmt in cls.body:
                if not isinstance(stmt, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if stmt.name in self.FLIGHT_METHODS:
                    if not self._refs(stmt, set(self.TRACE_NAMES), set()):
                        yield mod.finding(
                            self.id, stmt,
                            f"Flight handler {cls.name}.{stmt.name} never "
                            f"touches remote_context/traceparent — wire "
                            f"RPCs would drop the caller's trace")
                elif stmt.name.startswith("handle_"):
                    uses_executor = any(
                        isinstance(n, ast.Attribute)
                        and n.attr == "run_in_executor"
                        for n in ast.walk(stmt))
                    if uses_executor and not self._refs(
                            stmt, set(self.TRACE_NAMES),
                            {"_traced_call", "_traced"}):
                        yield mod.finding(
                            self.id, stmt,
                            f"HTTP handler {cls.name}.{stmt.name} ships "
                            f"work to an executor without _traced_call — "
                            f"the worker detaches from the request trace")


class UnlockedModuleMutation(Rule):
    id = "GL08"
    title = ("in modules that declare a module-level lock, module-level "
             "dict/list state must only be mutated under `with <lock>:`")

    MUTATORS = frozenset({
        "append", "extend", "insert", "pop", "popitem", "clear", "update",
        "setdefault", "remove", "discard", "add", "move_to_end",
    })
    _CONTAINER_CALLS = frozenset({
        "dict", "list", "set", "OrderedDict", "defaultdict", "deque",
        "Counter",
    })

    def _module_locks(self, mod: ModuleInfo) -> Set[str]:
        locks: Set[str] = set()
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            v = stmt.value
            if not isinstance(v, ast.Call):
                continue
            d = _dotted(v.func).split(".")[-1]
            if d in ("Lock", "RLock", "TrackedLock", "TrackedRLock"):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        locks.add(t.id)
        return locks

    def _module_containers(self, mod: ModuleInfo) -> Set[str]:
        names: Set[str] = set()
        for stmt in mod.tree.body:
            targets: List[ast.expr] = []
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            is_container = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                              ast.DictComp, ast.ListComp,
                                              ast.SetComp))
            if isinstance(value, ast.Call) and \
                    _dotted(value.func).split(".")[-1] in \
                    self._CONTAINER_CALLS:
                is_container = True
            if not is_container:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        return names

    def _under_lock(self, mod: ModuleInfo, node: ast.AST,
                    locks: Set[str]) -> bool:
        for anc in mod.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    e = item.context_expr
                    if isinstance(e, ast.Name) and e.id in locks:
                        return True
                    # lock attribute/call forms: `with _lock:` only —
                    # other shapes don't guard MODULE state by convention
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # keep walking: an enclosing function may hold the lock
                # around a nested helper? No — a nested def runs later.
                return False
        return False

    def check(self, mod, ctx):
        locks = self._module_locks(mod)
        if not locks:
            return
        containers = self._module_containers(mod)
        if not containers:
            return

        def container_of(node: ast.expr) -> Optional[str]:
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id in containers:
                return node.value.id
            return None

        candidates: List[Tuple[ast.AST, str, str]] = []
        for node in mod.nodes(ast.Assign):
            for t in node.targets:
                name = container_of(t)
                if name:
                    candidates.append((node, name, "item assignment"))
        for node in mod.nodes(ast.AugAssign):
            name = container_of(node.target)
            if name:
                candidates.append((node, name, "augmented assignment"))
        for node in mod.nodes(ast.Delete):
            for t in node.targets:
                name = container_of(t)
                if name:
                    candidates.append((node, name, "deletion"))
        for node in mod.nodes(ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in self.MUTATORS and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id in containers:
                candidates.append((node, fn.value.id,
                                   f".{fn.attr}() call"))
        for node, name, how in candidates:
            # module-level statements run at import, single-threaded
            if not any(isinstance(a, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                       for a in mod.ancestors(node)):
                continue
            if self._under_lock(mod, node, locks):
                continue
            yield mod.finding(
                self.id, node,
                f"module-level container {name!r} mutated ({how}) outside "
                f"`with {'/'.join(sorted(locks))}:` although this module "
                f"declares a module lock for its shared state")


class AdhocMetricObject(Rule):
    id = "GL09"
    title = ("prometheus metric objects constructed outside "
             "common/telemetry helpers: the self-monitoring scraper and "
             "runtime_metrics only see the shared registry walk — a "
             "bespoke Counter/Gauge/Histogram also dodges the "
             "suppress_metrics recursion guard and the name-collision "
             "sanitizer")

    EXEMPT = ("common/telemetry.py",)
    METRIC_TYPES = frozenset({"Counter", "Gauge", "Histogram", "Summary",
                              "Info", "Enum"})

    def _prometheus_bindings(self, mod: ModuleInfo
                             ) -> Tuple[Set[str], Set[str]]:
        """(metric names, module aliases) bound from prometheus_client
        in this module (module level or inside functions — telemetry
        itself imports lazily), so a bare `Counter(...)` from
        collections never false-positives and `import prometheus_client
        as pc; pc.Counter(...)` doesn't dodge the rule (the GL04
        aliased-import lesson)."""
        names: Set[str] = set()
        modules: Set[str] = {"prometheus_client"}
        for imp in mod.nodes(ast.ImportFrom):
            if imp.module and imp.module.split(".")[0] == \
                    "prometheus_client":
                for alias in imp.names:
                    if alias.name in self.METRIC_TYPES:
                        names.add(alias.asname or alias.name)
        for imp in mod.nodes(ast.Import):
            for alias in imp.names:
                if alias.name.split(".")[0] == "prometheus_client":
                    modules.add(alias.asname or alias.name.split(".")[0])
        return names, modules

    def check(self, mod, ctx):
        if _is_module(mod.rel, self.EXEMPT):
            return
        bound, modules = self._prometheus_bindings(mod)
        for call in mod.nodes(ast.Call):
            d = _dotted(call.func)
            if not d:
                continue
            parts = d.split(".")
            is_metric = (len(parts) == 2 and parts[0] in modules
                         and parts[1] in self.METRIC_TYPES) \
                or d in bound
            if not is_metric:
                continue
            yield mod.finding(
                self.id, call,
                f"ad-hoc metric object {d}() — use common.telemetry "
                f"helpers (increment_counter / timer / observe_latency) "
                f"so the metric lands in the shared registry the "
                f"scraper, /metrics and runtime_metrics all read")


# ---------------------------------------------------------------------
# interprocedural rules (GL10-GL12): these consume the repo-wide call
# graph core.build_context assembles. Resolution is name-based with a
# hub cutoff (see core.CallGraph) — biased toward precision, so a
# finding is always actionable and the budget stays at zero.
# ---------------------------------------------------------------------

def _shallow_nodes(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Walk one function's body without descending into nested defs
    (those are separate call-graph nodes with their own reachability)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class UntypedHandlerException(Rule):
    id = "GL10"
    title = ("exception-flow: any `raise` reachable from a protocol "
             "handler (Flight do_get/do_put/do_action, HTTP/mysql/"
             "postgres handle_*, datanode mailbox steps) must be an "
             "errors.* taxonomy type or wire-mapped — untyped raises "
             "cross the RPC boundary as status UNKNOWN")

    FLIGHT_METHODS = ("do_get", "do_put", "do_action", "do_exchange")
    MAILBOX_METHODS = ("_handle_mailbox", "_handle_balancer_msg",
                       "_balancer_step")
    #: raise targets that cross the boundary deliberately:
    #: - SimulatedCrash is crash injection (GL02 guards its catching);
    #: - NotImplementedError is an abstract-surface contract — 500 is
    #:   the honest status for "this build cannot do that";
    #: - stop/system/keyboard are control flow, not errors;
    #: - ValueError/TypeError/KeyError are the validated-input contract
    #:   the protocol surfaces translate at the boundary (http/flight
    #:   handlers and the SET machinery catch them into 400s);
    #: - OSError/FileNotFoundError are the object-store read contract
    #:   (callers branch on not-found; the retry layer classifies the
    #:   rest);
    #: - LockOrderError/IoUnderLockError are the test-only lock
    #:   detector, which must fail LOUDLY wherever it trips.
    WIRE_MAPPED = frozenset({
        "SimulatedCrash", "NotImplementedError", "StopIteration",
        "StopAsyncIteration", "KeyboardInterrupt", "SystemExit",
        "TimeoutError", "BrokenPipeError", "ConnectionError",
        "ConnectionResetError", "ValueError", "TypeError", "KeyError",
        "OSError", "FileNotFoundError", "PermissionError",
        "UnicodeDecodeError", "LockOrderError", "IoUnderLockError",
    })

    def _roots(self, ctx: ProjectContext) -> Iterator:
        for fn in ctx.callgraph.functions:
            in_servers = _in_dirs(fn.rel, ("servers", "selftest"))
            if in_servers and fn.cls and fn.name in self.FLIGHT_METHODS:
                yield fn
            elif in_servers and fn.cls and fn.name.startswith("handle_"):
                yield fn
            elif fn.rel.replace("\\", "/").endswith(
                    "datanode/instance.py") and \
                    fn.name in self.MAILBOX_METHODS:
                yield fn

    def _reach(self, ctx: ProjectContext):
        reach = ctx.cache.get(self.id)
        if reach is None:
            reach = ctx.callgraph.reachable(self._roots(ctx))
            ctx.cache[self.id] = reach
        return reach

    def check(self, mod, ctx):
        reach = self._reach(ctx)
        for fn in ctx.callgraph.functions:
            if fn.mod is not mod or fn not in reach:
                continue
            for node in _shallow_nodes(fn.node):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                exc = node.exc
                if isinstance(exc, ast.Name) and not exc.id[:1].isupper():
                    continue              # propagating a bound object
                    # (an UPPERCASE bare Name is a class raise — `raise
                    # RuntimeError` without parens raises an instance
                    # all the same and falls through to the check)
                target = exc.func if isinstance(exc, ast.Call) else exc
                d = _dotted(target) if target is not None else ""
                leaf = d.split(".")[-1]
                if not leaf or leaf in ctx.taxonomy or \
                        leaf in self.WIRE_MAPPED:
                    continue
                if not leaf[:1].isupper():
                    # `raise _to_greptime_error(e)`: a converter factory,
                    # not a class — its return type is beyond static
                    # reach, and the converters exist to produce typed
                    # errors (under-approximate rather than false-flag)
                    continue
                path = reach[fn]
                via = " -> ".join(path[-3:]) if len(path) > 1 else path[0]
                yield mod.finding(
                    self.id, node,
                    f"raise {leaf} reachable from a protocol handler "
                    f"(via {via}) — raise a GreptimeError subclass "
                    f"(errors.py) so the wire carries a real status "
                    f"code instead of UNKNOWN/500")


class UncancellableLoop(Rule):
    id = "GL11"
    title = ("cancellation reachability: every loop over SST files / "
             "regions / RPC futures / streamed slices reachable from "
             "statement execution must pass through check_cancelled(), "
             "and every cohort-wait loop (WAL group commit, ingest "
             "coalescer, scan fusion) must bound its waits or reach "
             "check_cancelled() — KILL <id> otherwise cannot interrupt "
             "it, and a dead leader wedges the cohort")

    #: loops are only *scanned* in the read/execution layers — write-side
    #: and background loops (flush, compaction, purge) must NOT be
    #: cancellable mid-flight, their atomicity is the crash-safety story.
    #: wal.py and coalesce.py join the scope for their group-commit /
    #: coalescer cohort-wait loops (requests park there mid-statement)
    SCAN_DIRS = ("query", "promql", "selftest")
    SCAN_MODULES = ("storage/region.py", "frontend/distributed.py",
                    "storage/wal.py", "servers/coalesce.py")
    #: RPC leaf calls that make a loop iteration remote-heavy
    RPC_CALLS = frozenset({"_dist_rpc"})
    #: leaf calls that PARK the thread (Event.wait / Condition.wait):
    #: inside a loop they must carry a timeout or the loop must reach a
    #: cancellation point — an unbounded park can neither be KILLed nor
    #: outlive a dead group-commit/coalesce leader
    WAIT_CALLS = frozenset({"wait"})

    def _roots(self, ctx: ProjectContext) -> Iterator:
        for fn in ctx.callgraph.functions:
            if fn.name == "do_query":
                yield fn
            elif fn.name == "execute" and _in_dirs(fn.rel, ("query",
                                                            "selftest")):
                yield fn

    def _closures(self, ctx: ProjectContext):
        cached = ctx.cache.get(self.id)
        if cached is not None:
            return cached
        from ...common.locks import IO_FAILPOINT_SITES
        cg = ctx.callgraph
        reach = cg.reachable(self._roots(ctx))

        def fixpoint(base_pred):
            members = {fn for fn in cg.functions if base_pred(fn)}
            changed = True
            while changed:
                changed = False
                for fn in cg.functions:
                    if fn in members:
                        continue
                    for callee in fn.calls:
                        if any(t in members for t in cg.targets(callee)):
                            members.add(fn)
                            changed = True
                            break
            return members

        io_reach = fixpoint(
            lambda fn: bool(fn.failpoint_sites & IO_FAILPOINT_SITES)
            or fn.name in self.RPC_CALLS)
        can_reach = fixpoint(lambda fn: "check_cancelled" in fn.calls)
        cached = (reach, io_reach, can_reach)
        ctx.cache[self.id] = cached
        return cached

    def _in_scope(self, rel: str) -> bool:
        return _in_dirs(rel, self.SCAN_DIRS) or \
            _is_module(rel, self.SCAN_MODULES)

    def check(self, mod, ctx):
        if not self._in_scope(mod.rel):
            return
        reach, io_reach, can_reach = self._closures(ctx)
        cg = ctx.callgraph
        from ...common.locks import IO_FAILPOINT_SITES

        def body_nodes(loop):
            stack = list(loop.body)
            while stack:
                node = stack.pop()
                yield node
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                stack.extend(ast.iter_child_nodes(node))

        for fn in cg.functions:
            if fn.mod is not mod:
                continue
            in_reach = fn in reach
            for loop in _shallow_nodes(fn.node):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                io_heavy = False
                covered = False
                unbounded_wait = False
                for node in body_nodes(loop):
                    if not isinstance(node, ast.Call):
                        continue
                    leaf = _call_leaf(node)
                    if leaf == "check_cancelled":
                        covered = True
                        break
                    if leaf in ("fail_point", "fires") and \
                            _str_arg0(node) in IO_FAILPOINT_SITES:
                        io_heavy = True
                        continue
                    if leaf in self.WAIT_CALLS and \
                            isinstance(node.func, ast.Attribute) and \
                            not node.args and \
                            not any(kw.arg == "timeout"
                                    for kw in node.keywords):
                        # x.wait() with neither a positional nor a
                        # timeout= bound: the park can outlive its waker
                        unbounded_wait = True
                        continue
                    targets = cg.targets(leaf)
                    if any(t in can_reach for t in targets):
                        covered = True
                        break
                    if leaf in self.RPC_CALLS or \
                            any(t in io_reach for t in targets):
                        io_heavy = True
                if covered:
                    continue
                if io_heavy and in_reach:
                    yield mod.finding(
                        self.id, loop,
                        f"loop in {fn.qual} does per-iteration I/O or "
                        f"RPC work, is reachable from statement "
                        f"execution, and never passes through "
                        f"check_cancelled() — KILL cannot interrupt it "
                        f"at a batch boundary")
                elif unbounded_wait:
                    # cohort-wait loops are flagged regardless of the
                    # do_query reach set: protocol-ingest waits (the
                    # coalescer) park request threads do_query never sees
                    yield mod.finding(
                        self.id, loop,
                        f"wait loop in {fn.qual} parks without a "
                        f"timeout and never passes through "
                        f"check_cancelled() — a dead group-commit/"
                        f"coalesce leader (or a KILL on the waiting "
                        f"statement) wedges it forever; bound the wait "
                        f"(timeout=...) or add a cancellation point")


class DeadFailpoint(Rule):
    id = "GL12"
    title = ("failpoint reachability: every registered failpoint name "
             "must be evaluated by a call site reachable from at least "
             "one non-test caller — dead failpoints rot the torture "
             "matrix (experiments arm them and silently never fire)")

    def check(self, mod, ctx):
        cg = ctx.callgraph
        for name, (rel, lineno) in \
                sorted(ctx.registered_failpoints.items()):
            if rel != mod.rel:
                continue                  # report at the register() site
            site_fns = [fn for fn in cg.functions
                        if name in fn.failpoint_sites]
            module_site = any(name in sites for sites
                              in cg.module_failpoint_sites.values())
            anchor = _Line(lineno)
            if not site_fns and not module_site:
                yield mod.finding(
                    self.id, anchor,
                    f"failpoint {name!r} is registered here but no "
                    f"fail_point()/fires() site evaluates it anywhere "
                    f"in the scanned tree — arming it never fires")
            elif not module_site and not any(
                    cg.has_caller(fn) for fn in site_fns):
                owners = ", ".join(fn.qual for fn in site_fns[:3])
                yield mod.finding(
                    self.id, anchor,
                    f"failpoint {name!r} is only evaluated inside "
                    f"{owners}, which no non-test code calls — the "
                    f"site is dead and the experiment never fires")


class RootlessBackgroundJob(Rule):
    id = "GL13"
    title = ("background root spans: every callback handed to "
             "RepeatedTask(...) or a scheduler submit/submit_later "
             "must reach background_jobs.job() or telemetry."
             "root_span() — background work that roots no trace is "
             "invisible to the durable trace store and the "
             "information_schema.background_jobs view")

    #: where background loops live (and the seeded fixture)
    SCAN_DIRS = ("storage", "flow", "monitor", "meta", "datanode",
                 "cmd", "servers", "selftest")
    #: call leaves that satisfy the contract
    ROOTING_CALLS = frozenset({"job", "root_span"})

    def _covered(self, ctx: ProjectContext):
        """Functions that (transitively) reach a rooting call — the
        GL11 fixpoint shape, cached per run."""
        cached = ctx.cache.get(self.id)
        if cached is not None:
            return cached
        cg = ctx.callgraph
        members = {fn for fn in cg.functions
                   if fn.calls & self.ROOTING_CALLS}
        changed = True
        while changed:
            changed = False
            for fn in cg.functions:
                if fn in members:
                    continue
                for callee in fn.calls:
                    if any(t in members for t in cg.targets(callee)):
                        members.add(fn)
                        changed = True
                        break
        ctx.cache[self.id] = members
        return members

    @staticmethod
    def _callback_arg(node: ast.Call, leaf: str):
        """The callback expression of a background registration, or
        None when this call is not one. RepeatedTask(interval, fn, ...);
        scheduler submit/submit_later(key: str-literal/f-string, fn) —
        the string first arg keeps ThreadPoolExecutor.submit(fn, ...)
        out (precision first)."""
        if leaf == "RepeatedTask":
            if len(node.args) >= 2:
                return node.args[1]
            return next((kw.value for kw in node.keywords
                         if kw.arg == "fn"), None)
        if leaf in ("submit", "submit_later"):
            if len(node.args) >= 2 and isinstance(
                    node.args[0], (ast.Constant, ast.JoinedStr)):
                return node.args[1]
        return None

    def check(self, mod, ctx):
        if not _in_dirs(mod.rel, self.SCAN_DIRS):
            return
        cg = ctx.callgraph
        covered = None                    # computed lazily: most files
        for fn in cg.functions:           # have no registration sites
            if fn.mod is not mod:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                leaf = _call_leaf(node)
                if leaf not in ("RepeatedTask", "submit",
                                "submit_later"):
                    continue
                cb = self._callback_arg(node, leaf)
                if cb is None:
                    continue
                if isinstance(cb, ast.Attribute):
                    cb_name = cb.attr
                elif isinstance(cb, ast.Name):
                    cb_name = cb.id
                else:
                    continue              # lambda/call: unresolvable,
                targets = cg.targets(cb_name)   # skip for precision
                if not targets:
                    continue              # hub or external name
                if covered is None:
                    covered = self._covered(ctx)
                if any(t in covered for t in targets):
                    continue
                yield mod.finding(
                    self.id, node,
                    f"background callback {cb_name!r} (registered in "
                    f"{fn.qual}) never reaches background_jobs.job() "
                    f"or telemetry.root_span() — its work rides no "
                    f"trace and never appears in "
                    f"information_schema.background_jobs")


class _Line:
    """Anchor object for findings not tied to one AST node."""

    def __init__(self, lineno: int):
        self.lineno = lineno
        self.col_offset = 0


class UnsanctionedDataAccess(Rule):
    id = "GL14"
    title = ("promql/ and flow/ must not touch storage regions, the "
             "device scan cache or raw scan_batches outside their "
             "lowering modules — front ends reach data through the "
             "plan IR (query/ir.py), never around it")

    SCOPE = ("promql", "flow", "selftest")
    #: the ONE sanctioned IR-lowering module per front end: all region /
    #: scan-cache / raw-scan access under promql/ and flow/ lives there,
    #: so fast-path coverage (scatter, pruning, fusion) cannot silently
    #: fork per front end
    EXEMPT = ("promql/lowering.py", "flow/lowering.py")

    #: attribute accesses that reach storage underneath the IR
    ATTRS = frozenset({"regions", "scan_batches"})
    #: module-level names that bypass the IR entirely
    NAMES = frozenset({"SCAN_CACHE"})

    def check(self, mod, ctx):
        if not _in_dirs(mod.rel, self.SCOPE):
            return
        if _is_module(mod.rel, self.EXEMPT):
            return

        def hit(node, what):
            return mod.finding(
                self.id, node,
                f"{what} under {_segments(mod.rel)[-2]}/ bypasses the "
                f"plan IR — move the access into the front end's "
                f"lowering module (promql/lowering.py or "
                f"flow/lowering.py) so it rides scatter/pruning/fusion "
                f"and EXPLAIN stays truthful")

        for node in mod.nodes(ast.Attribute):
            if node.attr in self.ATTRS:
                yield hit(node, f"`.{node.attr}` access")
            elif node.attr in self.NAMES:
                yield hit(node, f"`{node.attr}` access")
        for node in mod.nodes(ast.Name):
            if node.id in self.NAMES and \
                    isinstance(node.ctx, ast.Load):
                yield hit(node, f"`{node.id}` access")
        for node in mod.nodes(ast.ImportFrom):
            for alias in node.names:
                if alias.name in self.NAMES:
                    yield hit(node, f"import of `{alias.name}`")


class UndaemonedThread(Rule):
    id = "GL15"
    title = ("threading.Thread constructed without daemon=True and "
             "never .join()ed on any shutdown path: a forgotten "
             "non-daemon thread keeps the interpreter alive after "
             "main() returns (hung process on exit)")

    THREAD_NAMES = ("Thread", "threading.Thread")

    def check(self, mod, ctx):
        # every `<target>.join(...)` in the module, by dotted receiver —
        # a Thread assigned to that receiver counts as reclaimed
        joined: Set[str] = set()
        for call in mod.nodes(ast.Call):
            f = call.func
            if isinstance(f, ast.Attribute) and f.attr == "join":
                d = _dotted(f.value)
                if d:
                    joined.add(d)
        assigned_to: Dict[int, str] = {}
        for node in mod.nodes(ast.Assign):
            if len(node.targets) == 1 and \
                    isinstance(node.value, ast.Call):
                d = _dotted(node.targets[0])
                if d:
                    assigned_to[id(node.value)] = d
        for call in mod.nodes(ast.Call):
            if _dotted(call.func) not in self.THREAD_NAMES:
                continue
            kw = next((k for k in call.keywords
                       if k.arg == "daemon"), None)
            if kw is not None and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is False):
                continue          # daemon=True / daemon=<flag var>
            target = assigned_to.get(id(call))
            if target is not None and target in joined:
                continue          # reclaimed on some path
            yield mod.finding(
                self.id, call,
                "threading.Thread without daemon=True and never "
                ".join()ed — a non-daemon thread left running blocks "
                "interpreter shutdown; set daemon=True or join it on "
                "a reachable shutdown path")


ALL_RULES: List[Rule] = [
    SwallowedException(), BaseExceptionCaught(), BareRename(),
    UnknownFailpoint(), UntypedRaise(), RawThreadConstruction(),
    UntracedHandler(), UnlockedModuleMutation(), AdhocMetricObject(),
    UntypedHandlerException(), UncancellableLoop(), DeadFailpoint(),
    RootlessBackgroundJob(), UnsanctionedDataAccess(),
    UndaemonedThread(),
]
