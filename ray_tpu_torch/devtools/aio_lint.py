"""AST-based asyncio hazard linter for the single-loop control plane.

The GCS/raylet/core-worker tier is cooperative asyncio: every ``await`` is a
potential interleaving point and the only mutual exclusion is "don't await
between the read and the write". These rules encode the failure modes that
have actually bitten this codebase (see rpc.py's ``spawn()`` docstring for
the GC'd fire-and-forget task bug) in the spirit of compositional pre-commit
race detectors (RacerD) rather than whole-program model checking: each rule
is a local, per-function pattern with an explicit suppression escape hatch.

Rules
-----
- ``blocking-call``: a known blocking call (``time.sleep``, sync
  ``subprocess``/``socket``/``urllib``/``requests``/``shutil`` entry
  points, builtin ``open``, and the pathlib convenience I/O methods
  ``read_text``/``read_bytes``/``write_text``/``write_bytes`` on any
  receiver) lexically inside an ``async def``. Nested *sync* ``def``s are
  exempt — they are usually ``run_in_executor`` targets.
- ``raw-create-task``: ``asyncio.create_task`` / ``loop.create_task`` /
  ``asyncio.ensure_future`` anywhere. The event loop holds only weak task
  references; every background task must go through ``rpc.spawn()`` (or an
  owner that parks a strong reference and is suppressed explicitly).
- ``unawaited-coro``: a bare expression statement calling a *locally
  defined* ``async def`` (module function or method of the enclosing class)
  without ``await`` — the coroutine object is created and dropped.
- ``await-interleave``: asyncio TOCTOU. The function reads a shared
  container (an attribute initialised to a dict/list/set/deque in the
  class's ``__init__``, or a module-global container), then crosses an
  interleave point, then mutates that container without re-reading it
  after the suspension and without holding an ``asyncio.Lock``. Interleave
  points are explicit ``await``s, the implicit awaits of ``async for`` /
  ``async with`` (including the back-edge ``__anext__``), async-generator
  ``yield``s (the consumer runs before the next line), and async
  comprehensions (``[... async for ...]`` awaits in expression position).
  Purely additive mutations (``append``/``add``/``extend``) are not
  treated as hazardous writes — the lost-update shape needs a
  read-modify-write or a rebind/del.

Suppression: ``# aio-lint: disable=<rule>[,<rule>]`` (or ``disable=all``)
on the flagged line or the line directly above it.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

RULE_BLOCKING = "blocking-call"
RULE_CREATE_TASK = "raw-create-task"
RULE_UNAWAITED = "unawaited-coro"
RULE_INTERLEAVE = "await-interleave"

ALL_RULES = (RULE_BLOCKING, RULE_CREATE_TASK, RULE_UNAWAITED, RULE_INTERLEAVE)

# Dotted call targets that block the event loop. Matched against the
# longest resolvable attribute chain (``a.b.c(...)`` -> "a.b.c"), so an
# aliased module import (``import subprocess as sp``) is not caught — the
# linter is a tripwire, not a soundness proof.
_BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "os.system",
    "os.popen",
    "os.waitpid",
    "socket.create_connection",
    "socket.getaddrinfo",
    "socket.gethostbyname",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.delete",
    "requests.head",
    "requests.request",
    "shutil.copy",
    "shutil.copy2",
    "shutil.copyfile",
    "shutil.copytree",
    "shutil.copymode",
    "shutil.copystat",
    "shutil.move",
    "shutil.rmtree",
}

# Builtin calls that do synchronous file I/O.
_BLOCKING_BUILTINS = {"open"}

# Method names that do synchronous file I/O on any receiver: the pathlib
# convenience readers/writers (``cfg_path.read_text()``). Matched on the
# trailing attribute alone because the receiver is an arbitrary Path
# expression, not an importable module chain.
_BLOCKING_METHODS = {
    "read_text",
    "read_bytes",
    "write_text",
    "write_bytes",
}

# Container constructors that mark an attribute as shared mutable state.
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict"}

# Mutating container methods that can lose a concurrent update (read-modify-
# write or removal). Additive ops (append/add/extend/appendleft) are
# deliberately excluded: interleaved appends merge, they don't clobber.
_MUTATING_METHODS = {
    "pop",
    "popitem",
    "clear",
    "update",
    "remove",
    "discard",
    "setdefault",
    "insert",
}

_SUPPRESS_RE = re.compile(r"#\s*aio-lint:\s*disable=([\w\-, ]+)")


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number -> set of suppressed rule names ('all' wildcard)."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _dotted(node: ast.AST) -> Optional[str]:
    """Resolve ``a.b.c`` attribute chains to a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if isinstance(node, ast.Call):
        # e.g. asyncio.get_running_loop().create_task -> "().create_task";
        # we only care about the trailing attribute in that case.
        return "()." + ".".join(reversed(parts)) if parts else None
    return None


def _ctor_name(value: ast.AST) -> Optional[str]:
    """Name of the constructor if ``value`` builds a fresh container."""
    if isinstance(value, (ast.Dict, ast.DictComp)):
        return "dict"
    if isinstance(value, (ast.List, ast.ListComp)):
        return "list"
    if isinstance(value, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None
        )
        if name in _CONTAINER_CTORS:
            return name
    return None


def _is_lock_expr(node: ast.AST) -> bool:
    """Heuristic: does this ``async with`` context expression look like a
    mutual-exclusion primitive (``self._lock``, ``sem``, ``self.mu``...)?"""
    name = None
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        name = node.attr
    elif isinstance(node, ast.Name):
        name = node.id
    if name is None:
        return False
    lowered = name.lower()
    return any(tok in lowered for tok in ("lock", "mutex", "sem", "guard"))


class _ModuleIndex:
    """Per-module symbol tables the per-function passes consult."""

    def __init__(self, tree: ast.Module):
        self.module_async: Set[str] = set()
        self.class_async: Dict[str, Set[str]] = {}
        self.class_shared: Dict[str, Set[str]] = {}
        self.module_shared: Set[str] = set()
        for node in tree.body:
            if isinstance(node, ast.AsyncFunctionDef):
                self.module_async.add(node.name)
            elif isinstance(node, ast.Assign) and _ctor_name(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_shared.add(tgt.id)
            elif isinstance(node, ast.ClassDef):
                methods: Set[str] = set()
                shared: Set[str] = set()
                for item in node.body:
                    if isinstance(item, ast.AsyncFunctionDef):
                        methods.add(item.name)
                    elif (
                        isinstance(item, ast.FunctionDef)
                        and item.name == "__init__"
                    ):
                        for stmt in ast.walk(item):
                            if not isinstance(stmt, ast.Assign):
                                continue
                            if not _ctor_name(stmt.value):
                                continue
                            for tgt in stmt.targets:
                                if (
                                    isinstance(tgt, ast.Attribute)
                                    and isinstance(tgt.value, ast.Name)
                                    and tgt.value.id == "self"
                                ):
                                    shared.add(tgt.attr)
                self.class_async[node.name] = methods
                self.class_shared[node.name] = shared


# Events for the interleaving state machine.
_EV_READ, _EV_WRITE, _EV_AWAIT = "read", "write", "await"


class _AsyncFnLinter:
    """Runs all per-function rules over one ``async def`` body in statement
    order, without descending into nested function definitions."""

    def __init__(
        self,
        fn: ast.AsyncFunctionDef,
        index: _ModuleIndex,
        class_name: Optional[str],
        path: str,
    ):
        self.fn = fn
        self.index = index
        self.class_name = class_name
        self.path = path
        self.findings: List[Finding] = []
        self.shared = (
            index.class_shared.get(class_name, set()) if class_name else set()
        )
        self.lock_depth = 0
        # attr -> state for the interleave machine:
        #   "read"           read seen, no await yet
        #   "read+await"     read, then crossed an await, not re-read since
        #   "revalidated"    re-read after the await (fresh view)
        self._state: Dict[str, str] = {}
        self._flagged: Set[str] = set()

    # -- shared-container classification ------------------------------------

    def _shared_attr(self, node: ast.AST) -> Optional[str]:
        """Return a stable key if ``node`` names a shared container."""
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in self.shared
        ):
            return "self." + node.attr
        if isinstance(node, ast.Name) and node.id in self.index.module_shared:
            return node.id
        return None

    def _record(self, ev: str, attr: str, node: ast.AST) -> None:
        if ev == _EV_READ:
            if self._state.get(attr) == "read+await":
                self._state[attr] = "revalidated"
            elif attr not in self._state:
                self._state[attr] = "read"
        elif ev == _EV_WRITE:
            if (
                self._state.get(attr) == "read+await"
                and self.lock_depth == 0
                and attr not in self._flagged
            ):
                self._flagged.add(attr)
                self._emit(
                    node,
                    RULE_INTERLEAVE,
                    f"{attr} is read, then an await interleaves, then it is "
                    "mutated without re-validation or an asyncio.Lock "
                    "(lost-update hazard: another task may have changed it "
                    "across the await)",
                )
            # A write ends the read-await-write window: statements are atomic
            # between awaits, so a completed mutation (including an atomic
            # ``+=`` read-modify-write) leaves nothing stale to write back.
            self._state.pop(attr, None)

    def _cross_await(self) -> None:
        for attr, st in self._state.items():
            if st in ("read", "revalidated"):
                self._state[attr] = "read+await"

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(
            Finding(
                self.path,
                getattr(node, "lineno", self.fn.lineno),
                getattr(node, "col_offset", 0),
                rule,
                msg,
            )
        )

    # -- walk ---------------------------------------------------------------

    def run(self) -> List[Finding]:
        for stmt in self.fn.body:
            self._visit(stmt)
        return self.findings

    def _visit(self, node: ast.AST) -> None:  # noqa: C901 - dispatch table
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Nested definitions execute later (or in an executor); their
            # bodies are linted in their own pass if async.
            return
        if isinstance(node, ast.Await):
            self._visit(node.value)
            self._cross_await()
            return
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            # Only reachable inside an async generator (this linter walks
            # ``async def`` bodies): ``yield`` suspends the generator, the
            # consumer — and any other task — runs before the next line.
            if node.value is not None:
                self._visit(node.value)
            self._cross_await()
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp)):
            if any(gen.is_async for gen in node.generators):
                # ``[... async for ...]`` awaits __anext__ at every
                # iteration, right here in expression position.
                for child in ast.iter_child_nodes(node):
                    self._visit(child)
                self._cross_await()
                return
            for child in ast.iter_child_nodes(node):
                self._visit(child)
            return
        if isinstance(node, ast.AsyncFor):
            self._visit(node.iter)
            self._cross_await()
            for s in node.body + node.orelse:
                self._visit(s)
            # The hidden __anext__ await at the loop back-edge.
            self._cross_await()
            return
        if isinstance(node, ast.AsyncWith):
            locked = any(_is_lock_expr(item.context_expr) for item in node.items)
            for item in node.items:
                self._visit(item.context_expr)
            self._cross_await()
            if locked:
                self.lock_depth += 1
            for s in node.body:
                self._visit(s)
            if locked:
                self.lock_depth -= 1
            self._cross_await()
            return
        if isinstance(node, ast.Call):
            self._check_call(node)
            # Mutating method on a shared container: self.X.pop(...), etc.
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATING_METHODS:
                attr = self._shared_attr(fn.value)
                if attr is not None:
                    for arg in node.args:
                        self._visit(arg)
                    for kw in node.keywords:
                        self._visit(kw.value)
                    self._record(_EV_WRITE, attr, node)
                    return
            for child in ast.iter_child_nodes(node):
                self._visit(child)
            return
        if isinstance(node, ast.Expr):
            self._check_unawaited(node)
            self._visit(node.value)
            return
        if isinstance(node, ast.Assign):
            self._visit(node.value)
            for tgt in node.targets:
                self._visit_target(tgt)
            return
        if isinstance(node, ast.AugAssign):
            self._visit(node.value)
            self._visit_target(node.target, aug=True)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._visit_target(tgt)
            return
        if isinstance(node, (ast.Attribute, ast.Name)):
            attr = self._shared_attr(node)
            if attr is not None and isinstance(getattr(node, "ctx", None), ast.Load):
                self._record(_EV_READ, attr, node)
            for child in ast.iter_child_nodes(node):
                self._visit(child)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _visit_target(self, tgt: ast.AST, aug: bool = False) -> None:
        """Assignment/deletion targets: writes to shared containers."""
        if isinstance(tgt, ast.Subscript):
            attr = self._shared_attr(tgt.value)
            self._visit(tgt.slice)
            if attr is not None:
                self._record(_EV_WRITE, attr, tgt)
                return
            self._visit(tgt.value)
            return
        attr = self._shared_attr(tgt)
        if attr is not None:
            # Rebinding the container itself (or +=) clobbers concurrent
            # mutations outright.
            self._record(_EV_WRITE, attr, tgt)
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._visit_target(elt, aug=aug)
            return
        for child in ast.iter_child_nodes(tgt):
            self._visit(child)

    # -- individual call rules ----------------------------------------------

    def _check_call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        matched = False
        if name is not None:
            tail2 = ".".join(name.split(".")[-2:])
            if name in _BLOCKING_CALLS or tail2 in _BLOCKING_CALLS:
                matched = True
                self._emit(
                    node,
                    RULE_BLOCKING,
                    f"blocking call {tail2}() inside async def "
                    f"{self.fn.name!r} stalls the event loop; use the async "
                    "equivalent or loop.run_in_executor()",
                )
        if (
            not matched
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_METHODS
        ):
            self._emit(
                node,
                RULE_BLOCKING,
                f"blocking file I/O .{node.func.attr}() inside async def "
                f"{self.fn.name!r} stalls the event loop; use the async "
                "equivalent or loop.run_in_executor()",
            )
        if isinstance(node.func, ast.Name) and node.func.id in _BLOCKING_BUILTINS:
            self._emit(
                node,
                RULE_BLOCKING,
                f"synchronous file I/O ({node.func.id}()) inside async def "
                f"{self.fn.name!r}; wrap in loop.run_in_executor() or move "
                "off the hot path",
            )

    def _check_unawaited(self, node: ast.Expr) -> None:
        call = node.value
        if not isinstance(call, ast.Call):
            return
        fn = call.func
        is_async = False
        label = None
        if isinstance(fn, ast.Name):
            is_async = fn.id in self.index.module_async
            label = fn.id
        elif (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
            and self.class_name is not None
        ):
            is_async = fn.attr in self.index.class_async.get(self.class_name, set())
            label = "self." + fn.attr
        if is_async:
            self._emit(
                node,
                RULE_UNAWAITED,
                f"coroutine {label}() is never awaited — the call builds a "
                "coroutine object and drops it (add await, or rpc.spawn() "
                "for fire-and-forget)",
            )


class _CreateTaskLinter(ast.NodeVisitor):
    """raw-create-task applies everywhere (sync helpers schedule tasks too)."""

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func) or ""
        if name.endswith(".create_task") or name in (
            "asyncio.ensure_future",
            "ensure_future",
        ):
            self.findings.append(
                Finding(
                    self.path,
                    node.lineno,
                    node.col_offset,
                    RULE_CREATE_TASK,
                    "raw create_task/ensure_future: the loop keeps only a "
                    "weak reference and the task can be GC'd mid-flight; "
                    "use ray_tpu_torch._private.rpc.spawn() (see rpc.py)",
                )
            )
        self.generic_visit(node)


def lint_source(
    source: str, path: str = "<string>", apply_suppressions: bool = True
) -> List[Finding]:
    """Lint one module's source text; returns unsuppressed findings.

    ``apply_suppressions=False`` returns the raw findings with the
    ``# aio-lint: disable=`` comments ignored — the stale-suppression audit
    in ``devtools.lint`` uses this to decide which comments still earn
    their keep."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, 0, "parse-error", str(e.msg))]
    index = _ModuleIndex(tree)
    findings: List[Finding] = []

    ct = _CreateTaskLinter(path)
    ct.visit(tree)
    findings.extend(ct.findings)

    # Every async function, with its enclosing class (one level: the control
    # plane doesn't nest classes).
    def walk_functions(body, class_name):
        for node in body:
            if isinstance(node, ast.AsyncFunctionDef):
                findings.extend(
                    _AsyncFnLinter(node, index, class_name, path).run()
                )
                walk_functions(node.body, class_name)
            elif isinstance(node, ast.FunctionDef):
                walk_functions(node.body, class_name)
            elif isinstance(node, ast.ClassDef):
                walk_functions(node.body, node.name)
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.For, ast.While)):
                for field in ("body", "orelse", "finalbody", "handlers"):
                    sub = getattr(node, field, None) or []
                    for item in sub:
                        if isinstance(item, ast.ExceptHandler):
                            walk_functions(item.body, class_name)
                    if sub and not isinstance(sub[0], ast.ExceptHandler):
                        walk_functions(sub, class_name)

    walk_functions(tree.body, None)

    sup = _suppressions(source) if apply_suppressions else {}

    def suppressed(f: Finding) -> bool:
        for line in (f.line, f.line - 1):
            rules = sup.get(line)
            if rules and ("all" in rules or f.rule in rules):
                return True
        return False

    return sorted(
        (f for f in findings if not suppressed(f)),
        key=lambda f: (f.line, f.col, f.rule),
    )


def lint_file(path: str, apply_suppressions: bool = True) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path, apply_suppressions=apply_suppressions)


def iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",)]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(
    paths: Iterable[str], apply_suppressions: bool = True
) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        if os.path.isdir(path):
            for f in iter_py_files(path):
                findings.extend(lint_file(f, apply_suppressions=apply_suppressions))
        else:
            findings.extend(lint_file(path, apply_suppressions=apply_suppressions))
    return findings


# ---------------------------------------------------------------------------
# Shared-attribute footprints (consumed by devtools.explore for DPOR)
# ---------------------------------------------------------------------------


def _fn_footprint(
    fn: ast.AST,
    class_name: Optional[str],
    index: _ModuleIndex,
    modbase: str,
) -> Tuple[Set[str], Set[str], Set[str]]:
    """(reads, writes, callee-qualnames) of one function over shared state.

    Tracks EVERY ``self.<attr>`` access (not just attributes the linter
    recognises as shared containers — an incomplete footprint would let the
    explorer's independence oracle judge truly conflicting events
    independent, i.e. unsound pruning) plus module-level shared containers.
    Deliberately over-approximate: any method call on a tracked attribute
    counts as a write, and nested defs are folded in — a too-big footprint
    only costs pruning, a too-small one would hide interleavings."""
    reads: Set[str] = set()
    writes: Set[str] = set()
    callees: Set[str] = set()

    def shared_key(node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and class_name is not None
        ):
            # Keyed by bare attribute name, NOT Cls.attr: a base-class
            # method and a subclass method touch the SAME ``self._x`` slot,
            # and class-prefixed keys would judge them independent. Merging
            # same-named attrs across unrelated classes is the safe
            # direction (costs pruning, never soundness).
            return f"self.{node.attr}"
        if isinstance(node, ast.Name) and node.id in index.module_shared:
            return f"{modbase}:{node.id}"
        return None

    for node in ast.walk(fn):
        if isinstance(node, (ast.Attribute, ast.Name)):
            key = shared_key(node)
            if key is not None:
                if isinstance(getattr(node, "ctx", None), (ast.Store, ast.Del)):
                    writes.add(key)
                else:
                    reads.add(key)
        elif isinstance(node, ast.Subscript):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                key = shared_key(node.value)
                if key is not None:
                    writes.add(key)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute):
                key = shared_key(f.value)
                if key is not None:
                    writes.add(key)
                if (
                    isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and class_name is not None
                ):
                    callees.add(f"{class_name}.{f.attr}")
            elif isinstance(f, ast.Name):
                callees.add(f.id)
    return reads, writes, callees


def extract_footprints(
    paths: Optional[List[str]] = None,
) -> Dict[str, Dict[str, Set[str]]]:
    """Static read/write footprints over shared containers, per function.

    Returns ``{qualname: {"reads": set, "writes": set}}`` where qualname is
    ``Cls.method`` for methods and the bare name for module functions, and
    footprint keys are ``self.attr`` / ``module:global``. Effects of callees
    reachable through ``self.x()`` and same-module function calls are folded
    in transitively (fixpoint); same qualnames across modules merge by
    union. Sync functions are included — a loop callback need not be a
    coroutine.
    """
    paths = paths or [_default_root()]
    raw: Dict[str, Dict[str, Set[str]]] = {}

    def fold(qual: str, reads: Set[str], writes: Set[str], callees: Set[str]) -> None:
        ent = raw.setdefault(
            qual, {"reads": set(), "writes": set(), "callees": set()}
        )
        ent["reads"] |= reads
        ent["writes"] |= writes
        ent["callees"] |= callees

    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            files.extend(iter_py_files(path))
        else:
            files.append(path)
    for fpath in files:
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=fpath)
        except (OSError, SyntaxError):
            continue
        index = _ModuleIndex(tree)
        modbase = os.path.splitext(os.path.basename(fpath))[0]
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fold(node.name, *_fn_footprint(node, None, index, modbase))
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        fold(
                            f"{node.name}.{item.name}",
                            *_fn_footprint(item, node.name, index, modbase),
                        )

    # Transitive closure over the intra-repo call graph.
    changed = True
    while changed:
        changed = False
        for ent in raw.values():
            for callee in list(ent["callees"]):
                sub = raw.get(callee)
                if sub is None:
                    continue
                before = len(ent["reads"]) + len(ent["writes"]) + len(ent["callees"])
                ent["reads"] |= sub["reads"]
                ent["writes"] |= sub["writes"]
                ent["callees"] |= sub["callees"]
                if len(ent["reads"]) + len(ent["writes"]) + len(ent["callees"]) != before:
                    changed = True
    return {
        qual: {"reads": ent["reads"], "writes": ent["writes"]}
        for qual, ent in raw.items()
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.aio_lint",
        description="asyncio hazard linter (see module docstring for rules)",
    )
    parser.add_argument("paths", nargs="*", default=None)
    args = parser.parse_args(argv)
    paths = args.paths or [_default_root()]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"aio-lint: {len(findings)} finding(s)")
        return 1
    print("aio-lint: clean")
    return 0


def _default_root() -> str:
    import ray_tpu_torch

    return os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))


if __name__ == "__main__":
    sys.exit(main())
