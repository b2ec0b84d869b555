"""Paired-resource lifecycle dataflow pass.

Every ledger bug's chaos subsystem caught — double-grant, quota
stranding, pin leaks — was an unbalanced acquire/release on one of a small
set of paired-resource APIs. This pass encodes those pairs in a registry
and runs an intraprocedural abstract interpretation over each function's
AST, tracking a per-resource state lattice:

    U (unheld) --acquire--> H (held) --release--> R (released)
    join(a, b) = a if a == b else M (maybe)

and flags the paths where the release can be skipped:

Rules
-----
- ``lifecycle-leak-exception``: while a resource is held and its release is
  not in an enclosing ``finally``, a call that may raise is made — an
  exception propagates past the release.
- ``lifecycle-leak-return``: a ``return`` (or falling off the end of the
  function) while a scoped resource is held and unprotected.
- ``lifecycle-held-await``: an ``await`` is crossed while holding an
  unprotected resource. Awaits are cancellation points: ``Task.cancel``
  raises ``CancelledError`` out of the await and skips every statement
  after it that is not in a ``finally`` — exactly the
  ``BandwidthQuota.acquire`` leak class.
- ``lifecycle-double-release``: a release when the state is already R
  (released on this path).

Pairs come in two modes. **Scoped** pairs (pull-quota, lease-pool) must
release within the acquiring function — holding one across a function
boundary is itself a bug, so every rule applies unconditionally. **Ledger**
pairs (store pins, object-store holds, granted-lease bookkeeping, the
raylet resource ledger) legitimately outlive the acquiring function; for
those, the leak/await rules only fire in functions that contain *both* an
acquire and a release for the same resource — i.e. functions that clearly
intend a balanced scope.

The pass is a tripwire, not a soundness proof: resources are keyed by the
receiver's dotted expression (``self.pull_manager``), aliasing is not
tracked, and interprocedural flows are out of scope (that is what the
chaos suite is for).

Suppression: ``# lifecycle: disable=<rule>[,<rule>]`` (or ``disable=all``)
on the flagged line or the line directly above it.

Run: ``python -m ray_tpu_torch.devtools.lifecycle [paths]``.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.aio_lint import (
    Finding,
    _default_root,
    _dotted,
    iter_py_files,
)

RULE_LEAK_EXC = "lifecycle-leak-exception"
RULE_LEAK_RETURN = "lifecycle-leak-return"
RULE_HELD_AWAIT = "lifecycle-held-await"
RULE_DOUBLE_RELEASE = "lifecycle-double-release"

ALL_RULES = (RULE_LEAK_EXC, RULE_LEAK_RETURN, RULE_HELD_AWAIT, RULE_DOUBLE_RELEASE)

_SUPPRESS_RE = re.compile(r"#\s*lifecycle:\s*disable=([\w\-, ]+)")

# Abstract states. U/H/R as above; M = maybe-held (branch join disagreed),
# on which no rule fires — a conditional release is assumed deliberate.
U, H, R, M = "U", "H", "R", "M"

_DEAD = "__dead__"  # path terminated (return/raise) — excluded from joins


@dataclass(frozen=True)
class PairSpec:
    """One acquire/release pair.

    ``receivers`` restricts matching to call receivers whose dotted chain
    ends in one of the given names (``self.pull_manager.acquire`` matches
    receiver ``pull_manager``); ``None`` matches any receiver, for
    project-unique method names like ``_record_granted``.
    """

    name: str
    acquire: Tuple[str, ...]
    release: Tuple[str, ...]
    receivers: Optional[Tuple[str, ...]]
    scoped: bool
    doc: str


REGISTRY: Tuple[PairSpec, ...] = (
    PairSpec(
        name="pull-quota",
        acquire=("acquire",),
        release=("release",),
        receivers=("pull_manager",),
        scoped=True,
        doc="BandwidthQuota bytes_in_flight/active admission "
        "(ray_tpu_torch/_private/pull_manager.py)",
    ),
    PairSpec(
        name="lease-pool",
        acquire=("acquire",),
        release=("release",),
        receivers=("lease_pool",),
        scoped=True,
        doc="core_worker LeasePool worker lease "
        "(ray_tpu_torch/_private/core_worker.py)",
    ),
    PairSpec(
        name="store-pin",
        acquire=("pin",),
        release=("unpin",),
        receivers=("store",),
        scoped=False,
        doc="Store object pin refcount (ray_tpu_torch/_private/store_core.py)",
    ),
    PairSpec(
        name="obj-holds",
        acquire=("get", "pull"),
        release=("release", "release_many", "release_counts"),
        receivers=("plasma",),
        scoped=False,
        doc="object-store client hold counts "
        "(ray_tpu_torch/_private/object_store.py)",
    ),
    PairSpec(
        name="trace-span",
        acquire=("set_context",),
        release=("reset_context",),
        receivers=("tracing",),
        scoped=True,
        doc="trace-context token: set_context returns a contextvar "
        "reset token that must be reset in the same function, or the span "
        "leaks onto unrelated work sharing the thread/context "
        "(ray_tpu_torch/util/tracing.py)",
    ),
    PairSpec(
        name="grant-ledger",
        acquire=("_record_granted",),
        release=("_mark_lease_released", "_burn_lease_id"),
        receivers=None,
        scoped=False,
        doc="raylet granted-lease dedup ledger (ray_tpu_torch/_private/raylet.py)",
    ),
)

# The raylet resource ledger is not a method pair but an assignment idiom:
#   self.available = self.available - demand   (deduct / acquire)
#   self.available = self.available + demand   (refund / release)
# Tracked as a ledger-mode pseudo-pair keyed on the assigned attribute.
_LEDGER_ATTR = "available"
_LEDGER_PAIR = PairSpec(
    name="resource-ledger",
    acquire=(),
    release=(),
    receivers=None,
    scoped=False,
    doc="raylet available-resources deduct/refund (ray_tpu_torch/_private/raylet.py)",
)

# Calls that cannot meaningfully raise between acquire and release — pure
# bookkeeping; flagging them would force try/finally around straight-line
# arithmetic.
_EXEMPT_BUILTINS = {
    "len",
    "int",
    "float",
    "str",
    "repr",
    "bool",
    "list",
    "dict",
    "tuple",
    "set",
    "frozenset",
    "min",
    "max",
    "sum",
    "abs",
    "sorted",
    "isinstance",
    "getattr",
    "hasattr",
    "id",
    "range",
    "enumerate",
    "zip",
}
_EXEMPT_PREFIXES = ("logger.", "logging.", "log.", "time.monotonic", "time.time")


def _suppressions(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _match_call(node: ast.Call) -> Optional[Tuple[PairSpec, str, str]]:
    """(pair, resource key, 'acquire'|'release') for a registry call site.

    Method *definitions* don't get here (they aren't Call nodes), so the
    implementations of acquire/release themselves are never self-flagged.
    """
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    method = func.attr
    recv = _dotted(func.value)
    recv_last = recv.rsplit(".", 1)[-1] if recv else None
    for pair in REGISTRY:
        if method not in pair.acquire and method not in pair.release:
            continue
        if pair.receivers is not None:
            if recv_last is None or recv_last not in pair.receivers:
                continue
        elif recv is None:
            continue
        kind = "acquire" if method in pair.acquire else "release"
        key = f"{pair.name}:{recv or '?'}"
        return pair, key, kind
    return None


def _match_ledger_assign(node: ast.Assign) -> Optional[Tuple[str, str]]:
    """(resource key, kind) for ``x.available = x.available ± expr``."""
    if len(node.targets) != 1:
        return None
    tgt = node.targets[0]
    if not (isinstance(tgt, ast.Attribute) and tgt.attr == _LEDGER_ATTR):
        return None
    val = node.value
    if not isinstance(val, ast.BinOp) or not isinstance(
        val.op, (ast.Add, ast.Sub)
    ):
        return None
    tgt_dotted = _dotted(tgt)
    left_dotted = _dotted(val.left)
    if tgt_dotted is None or tgt_dotted != left_dotted:
        return None
    kind = "acquire" if isinstance(val.op, ast.Sub) else "release"
    return f"{_LEDGER_PAIR.name}:{tgt_dotted}", kind


def _pair_for_key(key: str) -> PairSpec:
    name = key.split(":", 1)[0]
    if name == _LEDGER_PAIR.name:
        return _LEDGER_PAIR
    for pair in REGISTRY:
        if pair.name == name:
            return pair
    raise KeyError(key)


class _FnLifecycle:
    """Abstract interpretation of one function body."""

    def __init__(self, fn: ast.AST, path: str) -> None:
        self.fn = fn
        self.path = path
        self.findings: List[Finding] = []
        self._flagged: Set[Tuple[str, str, int]] = set()
        # Stack of key-sets whose release sits in an enclosing ``finally``.
        self.protected: List[Set[str]] = []
        self.released_keys = self._collect_releases(fn.body)

    # -- pre-pass -----------------------------------------------------------

    def _collect_releases(self, body: List[ast.stmt]) -> Set[str]:
        """Keys this function releases anywhere (gates ledger-mode rules)."""
        out: Set[str] = set()
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(node, ast.Call):
                    hit = _match_call(node)
                    if hit and hit[2] == "release":
                        out.add(hit[1])
                elif isinstance(node, ast.Assign):
                    led = _match_ledger_assign(node)
                    if led and led[1] == "release":
                        out.add(led[0])
        return out

    def _releases_in(self, stmts: List[ast.stmt]) -> Set[str]:
        return self._collect_releases(stmts)

    # -- reporting ----------------------------------------------------------

    def _relevant(self, key: str) -> bool:
        return _pair_for_key(key).scoped or key in self.released_keys

    def _is_protected(self, key: str) -> bool:
        return any(key in layer for layer in self.protected)

    def _emit(self, node: ast.AST, key: str, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        mark = (key, rule, line)
        if mark in self._flagged:
            return
        self._flagged.add(mark)
        self.findings.append(
            Finding(self.path, line, getattr(node, "col_offset", 0), rule, message)
        )

    def _flag_held(self, node: ast.AST, state: Dict[str, str], rule: str,
                   what: str) -> None:
        for key, st in state.items():
            if st != H or self._is_protected(key) or not self._relevant(key):
                continue
            pair = _pair_for_key(key)
            self._emit(
                node,
                key,
                rule,
                f"{what} while holding {key} ({pair.doc}) with no "
                f"enclosing finally to release it",
            )

    # -- lattice ------------------------------------------------------------

    @staticmethod
    def _join(a: Dict[str, str], b: Dict[str, str]) -> Dict[str, str]:
        if a.get(_DEAD):
            return dict(b)
        if b.get(_DEAD):
            return dict(a)
        out: Dict[str, str] = {}
        for key in set(a) | set(b):
            sa, sb = a.get(key, U), b.get(key, U)
            out[key] = sa if sa == sb else M
        return out

    # -- statements ---------------------------------------------------------

    def _block(self, stmts: List[ast.stmt], state: Dict[str, str]) -> None:
        for stmt in stmts:
            if state.get(_DEAD):
                return
            self._stmt(stmt, state)

    def _stmt(self, node: ast.stmt, state: Dict[str, str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs analyzed as their own functions
        if isinstance(node, ast.Try):
            self._try(node, state)
        elif isinstance(node, ast.If):
            self._expr(node.test, state)
            s_then = dict(state)
            s_else = dict(state)
            self._block(node.body, s_then)
            self._block(node.orelse, s_else)
            state.clear()
            state.update(self._join(s_then, s_else))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self._expr(node.iter, state)
            if isinstance(node, ast.AsyncFor):
                self._flag_held(node, state, RULE_HELD_AWAIT,
                                "async-for suspension point crossed")
            s_in = dict(state)
            self._block(node.body, state)
            state.update(self._join(s_in, state))
            self._block(node.orelse, state)
        elif isinstance(node, ast.While):
            self._expr(node.test, state)
            s_in = dict(state)
            self._block(node.body, state)
            state.update(self._join(s_in, state))
            self._block(node.orelse, state)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._expr(item.context_expr, state)
            if isinstance(node, ast.AsyncWith):
                self._flag_held(node, state, RULE_HELD_AWAIT,
                                "async-with suspension point crossed")
            self._block(node.body, state)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self._expr(node.value, state)
            self._flag_return(node, state)
            state[_DEAD] = True
        elif isinstance(node, ast.Raise):
            if node.exc is not None:
                self._expr(node.exc, state)
            self._flag_held(node, state, RULE_LEAK_EXC, "raise propagates")
            state[_DEAD] = True
        elif isinstance(node, ast.Assign):
            led = _match_ledger_assign(node)
            self._expr(node.value, state)
            for tgt in node.targets:
                self._expr(tgt, state)
            if led is not None:
                self._transition(node, led[0], led[1], state)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._expr(child, state)

    def _flag_return(self, node: ast.AST, state: Dict[str, str]) -> None:
        for key, st in state.items():
            if key == _DEAD or st != H:
                continue
            if self._is_protected(key) or not _pair_for_key(key).scoped:
                continue
            pair = _pair_for_key(key)
            self._emit(
                node,
                key,
                RULE_LEAK_RETURN,
                f"function can return while still holding {key} "
                f"({pair.doc}); release it on this path or move the "
                f"release to a finally",
            )

    def _try(self, node: ast.Try, state: Dict[str, str]) -> None:
        entry = dict(state)
        self.protected.append(self._releases_in(node.finalbody))
        s_body = dict(state)
        self._block(node.body, s_body)
        # A handler can run after any prefix of the body: join entry with
        # after-body so releases inside the body stay conditional there.
        handler_in = self._join(entry, s_body)
        branches: List[Dict[str, str]] = []
        for handler in node.handlers:
            sh = dict(handler_in)
            self._block(handler.body, sh)
            branches.append(sh)
        s_orelse = dict(s_body)
        self._block(node.orelse, s_orelse)
        branches.append(s_orelse)
        self.protected.pop()
        out = branches[0]
        for br in branches[1:]:
            out = self._join(out, br)
        self._block(node.finalbody, out)
        state.clear()
        state.update(out)

    # -- expressions --------------------------------------------------------

    def _transition(self, node: ast.AST, key: str, kind: str,
                    state: Dict[str, str]) -> None:
        if kind == "acquire":
            state[key] = H
            return
        st = state.get(key, U)
        if st == R:
            pair = _pair_for_key(key)
            self._emit(
                node,
                key,
                RULE_DOUBLE_RELEASE,
                f"{key} ({pair.doc}) already released on this path — "
                f"double release corrupts the ledger",
            )
        elif st == H:
            state[key] = R
        # U: release of something acquired elsewhere (ledger mode) — fine.
        # M: conditional release pattern — deliberately quiet.

    def _risky_call(self, node: ast.Call) -> bool:
        name = _dotted(node.func) or ""
        if name in _EXEMPT_BUILTINS:
            return False
        if any(name.startswith(p) or name == p.rstrip(".")
               for p in _EXEMPT_PREFIXES):
            return False
        return True

    def _expr(self, node: ast.AST, state: Dict[str, str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Await):
            held_before = {k for k, v in state.items() if v == H}
            self._expr(node.value, state)
            # Keys acquired *by* this await (``await pm.acquire()``) or
            # released by it are excluded: only pre-held keys are at risk
            # from this suspension point's cancellation window.
            at_risk = {
                k for k in held_before
                if state.get(k) == H and not self._is_protected(k)
                and self._relevant(k)
            }
            for key in at_risk:
                pair = _pair_for_key(key)
                self._emit(
                    node,
                    key,
                    RULE_HELD_AWAIT,
                    f"await crossed while holding {key} ({pair.doc}) "
                    f"outside a finally — cancellation at this suspension "
                    f"point skips the release",
                )
            return
        if isinstance(node, ast.Call):
            hit = _match_call(node)
            for arg in node.args:
                self._expr(arg, state)
            for kw in node.keywords:
                self._expr(kw.value, state)
            self._expr(node.func, state)
            if hit is not None:
                self._transition(node, hit[1], hit[2], state)
            elif self._risky_call(node):
                self._flag_held(
                    node, state, RULE_LEAK_EXC,
                    f"call to {_dotted(node.func) or 'dynamic target'}() "
                    f"may raise",
                )
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, state)

    # -- entry --------------------------------------------------------------

    def run(self) -> List[Finding]:
        state: Dict[str, str] = {}
        self._block(self.fn.body, state)
        if not state.get(_DEAD):
            self._flag_return(self.fn, state)
        return self.findings


def lint_source(
    source: str, path: str = "<string>", apply_suppressions: bool = True
) -> List[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, 0, "parse-error", str(e.msg))]
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.extend(_FnLifecycle(node, path).run())
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


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lifecycle",
        description="paired-resource lifecycle linter "
        "(see module docstring for rules)",
    )
    parser.add_argument("paths", nargs="*", default=None)
    args = parser.parse_args(argv)
    paths = args.paths or [_default_root()]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"lifecycle: {len(findings)} finding(s)")
        return 1
    print("lifecycle: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
