"""Whole-program exception-propagation analyzer for the RPC control plane.

Yuan et al. (OSDI '14, "Simple Testing Can Prevent Most Critical
Failures") found that the majority of catastrophic distributed-system
failures trace to trivially mishandled error paths: a swallowed exception,
a retry of a non-idempotent op, an ack written before the state it acks.
This pass — the eighth in the unified lint gate — closes that axis
statically. It reuses rpc_check's cached wire Inventory (handler
registrations + call sites, parsed once per gate run) and the same
handler-closure BFS shape as rpc_flow to compute, per registered RPC
handler, the interprocedural set of typed errors that can escape the
handler, and checks four contracts the runtime's correctness story leans
on: the ``wire.py`` ``errors=`` declarations, the control-error taxonomy
(CancelledError / DeadlineExceeded / StaleLeaderError must never be
silently eaten), the ``RETRY_SAFE``/``RETRY_DEDUP`` idempotence promises,
and the GCS's persist-before-ack ordering.

Rules
-----
- ``error-wire-undeclared``: a typed error (the ``wire.KNOWN_ERRORS``
  taxonomy — the RayTpuError family plus the re-typed RpcError control
  errors) can escape a registered handler whose method has a ``WireSchema``
  that does not declare it in ``errors=``. An undeclared escape crosses the
  wire as an untyped ``RpcError`` string, losing the fencing/recovery
  semantics callers dispatch on (``except StaleLeaderError`` never fires).
  Escape sets are interprocedural over the same-module call closure, with
  try/except filtering: a raise caught by a matching clause (and not
  re-raised) does not escape. Two extra-lingual facts feed the analysis:
  ``*.store.put``/``*.store.delete`` in GCS-service files can raise
  ``StaleLeaderError`` (replicated-store fencing, gcs_store.py), and a
  nested RPC call can re-raise whatever its target method *declares* of
  the re-typed set (cross-service propagation through the registry).
- ``swallowed-control-error``: a broad/bare ``except`` that eats a
  control-flow error with no re-raise. Two shapes: (a) ``except:`` or
  ``except BaseException:`` around an ``await`` in any async function of
  runtime code — that swallows ``CancelledError``, making teardown
  cancellation a silent no-op (the task becomes unkillable); (b) any broad
  clause on a *handler path* where ``DeadlineExceeded``/``StaleLeaderError``
  can flow out of the try body — that converts fencing and deadline
  signals into silent success. A clause whose body re-raises (bare
  ``raise``, or ``raise e`` of the bound name) is exempt; so is an earlier
  dedicated clause that catches the control error first.
- ``retry-unsafe-mutation``: a handler whose method is declared
  ``RETRY_SAFE`` mutates non-keyed state somewhere in its closure — an
  append/extend/insert on a shared container, or a counter
  ``+=``/``-=`` — so a transparent retry after a lost reply double-applies
  (keyed writes ``d[k] = v``, idempotent ``set.add``, and observability
  counters are exempt). ``RETRY_DEDUP`` handlers get the same finding for
  mutations sequenced *before* the first read of the schema's
  ``dedup_key`` (the dedup ledger can only mirror outcomes it has seen;
  state mutated before the key check double-applies on re-delivery).
- ``ack-before-persist``: in the GCS (gcs.py / gcs_ha.py), a reply
  (``return {...}``), waiter completion (``fut.set_result`` /
  ``set_exception``), or pubsub publish sequenced after a mutation of a
  durable table (actors / named / kv / jobs / pgs) but before the
  ``store.put`` / ``_persist_*`` write-through for that table. A crash in
  the window acks state the restarted GCS will not reload — the static
  complement of explore's ``--crash-points`` scan, which only samples the
  schedules it is given.

Static horizon: callee resolution is same-module (``self._foo()`` and
module-level ``foo()``), matching rpc_flow; cross-module escapes flow only
through the two declared facts above. The ack-before-persist ordering is
line-linear within one function — branch-crossing false positives are
possible and get a justified waiver.

Suppression: ``# exc-flow: disable=<rule>[,<rule>]`` (or ``disable=all``)
on the flagged line or the line directly above it. The unified lint gate's
stale-suppression audit covers this family.

Run: ``python -m ray_tpu_torch.devtools.exc_flow [--report] [--mutate NAME
[--expect-violation]] [paths]``. ``--report`` prints the per-handler
escape-set table (triage aid); ``--mutate swallow_cancel`` overlays a
seeded except-swallow of CancelledError in the raylet grant path and
``--expect-violation`` inverts the exit status so CI proves the pass has
teeth.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
import textwrap
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.devtools import rpc_check
from ray_tpu_torch.devtools.aio_lint import Finding, _default_root, _dotted
from ray_tpu_torch.devtools.rpc_flow import _service_for

RULE_UNDECLARED = "error-wire-undeclared"
RULE_SWALLOW = "swallowed-control-error"
RULE_RETRY = "retry-unsafe-mutation"
RULE_ACK = "ack-before-persist"

ALL_RULES = (RULE_UNDECLARED, RULE_SWALLOW, RULE_RETRY, RULE_ACK)

_SUPPRESS_RE = re.compile(r"#\s*exc-flow:\s*disable=([\w\-, ]+)")

# ---------------------------------------------------------------------------
# Typed-error taxonomy (mirrors common.py + rpc.py class hierarchies; kept
# static so fixture trees need no imports). ``wire.KNOWN_ERRORS`` is the
# declarable subset.
# ---------------------------------------------------------------------------

_PARENTS: Dict[str, str] = {
    "TaskError": "RayTpuError",
    "WorkerCrashedError": "RayTpuError",
    "ActorDiedError": "RayTpuError",
    "ActorUnavailableError": "RayTpuError",
    "ObjectLostError": "RayTpuError",
    "ObjectReconstructionFailedError": "ObjectLostError",
    "GetTimeoutError": "RayTpuError",
    "TaskCancelledError": "RayTpuError",
    "PlacementGroupError": "RayTpuError",
    "CollectiveGroupDiedError": "RayTpuError",
    "RayTpuError": "Exception",
    "ConnectionLost": "RpcError",
    "DeadlineExceeded": "RpcError",
    "StaleLeaderError": "RpcError",
    "RpcError": "Exception",
    "TimeoutError": "Exception",
    "Exception": "BaseException",
    "CancelledError": "BaseException",
}

# Control-flow errors whose silent swallow breaks cancellation/fencing.
_CONTROL = ("CancelledError", "DeadlineExceeded", "StaleLeaderError")

# The subset that crosses the wire *typed* (rpc._TYPED_ERRORS re-types the
# error-reply string): only these propagate through nested RPC call sites.
_WIRE_TYPED = frozenset({"StaleLeaderError", "DeadlineExceeded"})


def _ancestors(name: str) -> Set[str]:
    out: Set[str] = set()
    cur = name
    while cur in _PARENTS:
        cur = _PARENTS[cur]
        out.add(cur)
    if name == "GetTimeoutError":  # multiple inheritance (common.py)
        out.add("TimeoutError")
    return out


_ANCESTORS: Dict[str, Set[str]] = {n: _ancestors(n) for n in _PARENTS}


def _covers(caught: Set[str], err: str) -> bool:
    """Does an except clause naming ``caught`` classes catch ``err``?"""
    return bool(
        caught & ({err} | _ANCESTORS.get(err, set()))
    )


def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _catch_set(handler: ast.ExceptHandler) -> Set[str]:
    """Trailing class names an except clause catches (bare = BaseException)."""
    t = handler.type
    if t is None:
        return {"BaseException"}
    if isinstance(t, ast.Tuple):
        return {n for n in (_tail(e) for e in t.elts) if n}
    n = _tail(t)
    return {n} if n else set()


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Bare ``raise`` (or ``raise e`` of the bound name) in the clause body."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (
                handler.name
                and isinstance(node.exc, ast.Name)
                and node.exc.id == handler.name
            ):
                return True
    return False


_SPAWN_NAMES = {"spawn", "_spawn"}

# Receiver-chain segments that mark observability state: mutations of
# counters/stat dicts/flight-recorder events are not retry hazards (they
# skew a metric, not the control plane).
_OBS_TOKENS = ("stats", "telemetry", "_tel", "events", "metrics", "tracing")

# Non-idempotent container adds (list semantics). ``set.add``/``discard``
# and keyed dict writes are idempotent and exempt.
_APPEND_VERBS = {"append", "extend", "insert", "appendleft"}

# ---------------------------------------------------------------------------
# GCS durability model (ack-before-persist).
# ---------------------------------------------------------------------------

_GCS_SUFFIXES = ("_private/gcs.py", "_private/gcs_ha.py")

# In-memory attribute -> canonical durable-table id (store table names).
_DURABLE_ATTRS = {
    "actors": "actors",
    "named_actors": "named",
    "kv": "kv",
    "jobs": "jobs",
    "placement_groups": "pgs",
}
# Conventional aliases for records pulled out of (or passed alongside) a
# durable table: ``actor.state = DEAD`` mutates the actors table.
_ALIAS_NAMES = {"actor": "actors", "pg": "pgs", "job": "jobs"}
_PERSIST_FNS = {
    "_persist_actor": "actors",
    "_persist_named": "named",
    "_persist_kv": "kv",
    "_persist_job": "jobs",
    "_persist_pg": "pgs",
}
_STORE_TABLES = {"actors", "named", "kv", "jobs", "pgs"}
# Record attributes that are NOT persisted (in-memory bookkeeping riding
# the same record objects): mutating them needs no write-through.
_EPHEMERAL_REC_ATTRS = {"pending", "fut", "future", "waiters", "conn"}


def _is_gcs_file(path: str) -> bool:
    norm = os.path.abspath(path).replace(os.sep, "/")
    return norm.endswith(_GCS_SUFFIXES)


def _in_runtime_scope(path: str) -> bool:
    return "_private" in os.path.abspath(path).split(os.sep)


# ---------------------------------------------------------------------------
# Module scan: function table with callee resolution (rpc_flow's shape,
# keeping the AST nodes for the escape walk).
# ---------------------------------------------------------------------------


def _local_nodes(fn: ast.AST):
    """Walk a function body without descending into nested defs/lambdas."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _ModuleFns:
    """Qualname -> function AST for one module, with same-module callee
    resolution (``self._foo()`` against the enclosing class, bare ``foo()``
    against module level)."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.service = _service_for(path)
        self.fns: Dict[str, ast.AST] = {}
        self.by_name: Dict[str, List[str]] = {}
        self._walk(tree.body, prefix="")

    def _walk(self, body, prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._walk(node.body, prefix=f"{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                if qual in self.fns:  # redefinition: keep the last
                    self.by_name[node.name].remove(qual)
                self.fns[qual] = node
                self.by_name.setdefault(node.name, []).append(qual)

    def resolve(self, name: str, cls: Optional[str]) -> Optional[str]:
        if cls is not None and f"{cls}.{name}" in self.fns:
            return f"{cls}.{name}"
        quals = self.by_name.get(name, [])
        if len(quals) == 1:
            return quals[0]
        if cls is None and name in self.fns:
            return name
        return None

    def callees(self, qual: str) -> Tuple[Set[str], Set[str]]:
        """(synchronous callees, spawned callees), resolved qualnames."""
        fn = self.fns[qual]
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        sync: Set[str] = set()
        spawned: Set[str] = set()
        spawn_args: Set[int] = set()
        for node in _local_nodes(fn):
            if (
                isinstance(node, ast.Call)
                and _tail(node.func) in _SPAWN_NAMES
                and node.args
                and isinstance(node.args[0], ast.Call)
            ):
                spawn_args.add(id(node.args[0]))
                target = _tail(node.args[0].func)
                if target:
                    nxt = self.resolve(target, cls)
                    if nxt is not None:
                        spawned.add(nxt)
        for node in _local_nodes(fn):
            if not isinstance(node, ast.Call) or id(node) in spawn_args:
                continue
            func = node.func
            name = None
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                name = func.attr
            elif isinstance(func, ast.Name):
                name = func.id
            if name is None:
                continue
            nxt = self.resolve(name, cls)
            if nxt is not None:
                sync.add(nxt)
        return sync, spawned


# ---------------------------------------------------------------------------
# Escape analysis: the set of typed error names that can escape each
# function, interprocedural (same-module fixpoint) with try/except
# filtering.
# ---------------------------------------------------------------------------


class _EscapeTable:
    def __init__(self, mod: _ModuleFns):
        self.mod = mod
        self.table: Dict[str, Set[str]] = {q: set() for q in mod.fns}
        changed = True
        while changed:
            changed = False
            for qual, fn in mod.fns.items():
                cur = self._block(list(ast.iter_child_nodes(fn)), qual)
                if cur != self.table[qual]:
                    self.table[qual] = cur
                    changed = True

    # -- per-node escape contribution ---------------------------------------

    def _node(self, node: ast.AST, qual: str) -> Set[str]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return set()
        if isinstance(node, ast.Try):
            return self._try(node, qual)
        out: Set[str] = set()
        if isinstance(node, ast.Raise) and node.exc is not None:
            exc = node.exc
            name = _tail(exc.func) if isinstance(exc, ast.Call) else _tail(exc)
            if name in _PARENTS and name not in ("Exception", "BaseException"):
                out.add(name)
        elif isinstance(node, ast.Call):
            out |= self._call(node, qual)
            if _tail(node.func) in _SPAWN_NAMES:
                # A spawned task's exceptions do not propagate to this
                # function — do not descend into the spawned coroutine call.
                return out
        for child in ast.iter_child_nodes(node):
            out |= self._node(child, qual)
        return out

    def _call(self, node: ast.Call, qual: str) -> Set[str]:
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        # Nested RPC: the target method's *declared* re-typed errors can
        # re-raise here (rpc._typed_error reconstructs them caller-side).
        if attr in rpc_check._CALL_METHODS and node.args:
            m = node.args[0]
            if isinstance(m, ast.Constant) and isinstance(m.value, str):
                from ray_tpu_torch._private import wire

                schema = wire.SCHEMAS.get(m.value)
                if schema is not None:
                    return set(schema.errors) & _WIRE_TYPED
            return set()
        # Replicated-store fencing: a write through the GCS store can raise
        # StaleLeaderError (gcs_store.py) — the fact that makes every GCS
        # write-through handler escape it.
        if (
            attr in ("put", "delete")
            and self.mod.service == "gcs"
            and isinstance(func, ast.Attribute)
        ):
            recv = _dotted(func.value) or ""
            if recv.rsplit(".", 1)[-1] == "store" or recv == "store":
                return {"StaleLeaderError"}
        # Same-module callee: its current escape estimate flows through.
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        name = None
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            name = func.attr
        elif isinstance(func, ast.Name):
            name = func.id
        if name is not None:
            callee = self.mod.resolve(name, cls)
            if callee is not None:
                return set(self.table.get(callee, set()))
        return set()

    def _block(self, stmts, qual: str) -> Set[str]:
        out: Set[str] = set()
        for s in stmts:
            out |= self._node(s, qual)
        return out

    def _try(self, node: ast.Try, qual: str) -> Set[str]:
        body = self._block(node.body, qual)
        for h in node.handlers:
            caught = _catch_set(h)
            if not _reraises(h):
                body = {e for e in body if not _covers(caught, e)}
            body |= self._block(h.body, qual)
        body |= self._block(node.orelse, qual)
        body |= self._block(node.finalbody, qual)
        return body

    # -- what can arrive at a try's except clauses --------------------------

    def arriving(self, t: ast.Try, qual: str) -> Set[str]:
        """Typed errors the try body can deliver to the handler clauses."""
        return self._block(t.body, qual)


# ---------------------------------------------------------------------------
# Whole-program analysis container.
# ---------------------------------------------------------------------------


@dataclass
class HandlerInfo:
    service: str
    method: str
    path: str
    line: int
    qualname: Optional[str]
    closure: Set[str] = field(default_factory=set)  # quals, sync + spawned


@dataclass
class Analysis:
    scans: Dict[str, _ModuleFns] = field(default_factory=dict)
    escapes: Dict[str, _EscapeTable] = field(default_factory=dict)
    handlers: List[HandlerInfo] = field(default_factory=list)
    # (module path, qual) -> handler labels ("service:Method") whose closure
    # contains the function (sync or spawned part).
    on_handler_path: Dict[Tuple[str, str], Set[str]] = field(
        default_factory=dict
    )

    def handler_escapes(self, h: HandlerInfo) -> Set[str]:
        if h.qualname is None:
            return set()
        return set(self.escapes[h.path].table.get(h.qualname, set()))


def _collect_sources(
    paths: Sequence[str],
    extra_sources: Optional[Sequence[Tuple[str, str]]],
) -> List[Tuple[str, Optional[ast.Module]]]:
    out: List[Tuple[str, Optional[ast.Module]]] = []
    for f in rpc_check._collect_files(list(paths)):
        out.append((f, rpc_check.cached_tree(f)))
    for vpath, vsrc in extra_sources or ():
        try:
            out.append((vpath, ast.parse(textwrap.dedent(vsrc), filename=vpath)))
        except SyntaxError:
            out.append((vpath, None))
    return out


def build(
    paths: Optional[Sequence[str]] = None,
    extra_sources: Optional[Sequence[Tuple[str, str]]] = None,
) -> Analysis:
    paths = list(paths or [_default_root()])
    inv = rpc_check.cached_inventory(paths)
    if extra_sources:
        inv = rpc_check._merge_inventories(
            [inv], extra_sources=list(extra_sources)
        )

    analysis = Analysis()
    for path, tree in _collect_sources(paths, extra_sources):
        if tree is None:
            continue
        mod = _ModuleFns(path, tree)
        analysis.scans[path] = mod
        analysis.escapes[path] = _EscapeTable(mod)

    for reg in sorted(inv.regs, key=lambda r: (r.path, r.line)):
        mod = analysis.scans.get(reg.path)
        if mod is None:
            continue
        qual = None
        if reg.handler_name:
            quals = mod.by_name.get(reg.handler_name, [])
            if quals:
                qual = quals[0]
        h = HandlerInfo(
            service=mod.service,
            method=reg.method,
            path=reg.path,
            line=reg.line,
            qualname=qual,
        )
        if qual is not None:
            h.closure = _closure(mod, qual)
            label = f"{h.service}:{h.method}"
            for q in h.closure:
                analysis.on_handler_path.setdefault(
                    (reg.path, q), set()
                ).add(label)
        analysis.handlers.append(h)
    return analysis


def _closure(mod: _ModuleFns, start: str) -> Set[str]:
    """Same-module call closure (sync + spawned) of one handler."""
    seen: Set[str] = set()
    frontier = [start]
    while frontier:
        qual = frontier.pop()
        if qual in seen or qual not in mod.fns:
            continue
        seen.add(qual)
        sync, spawned = mod.callees(qual)
        frontier.extend(sync | spawned)
    return seen


# ---------------------------------------------------------------------------
# Rule: error-wire-undeclared.
# ---------------------------------------------------------------------------


def _undeclared_findings(analysis: Analysis) -> List[Finding]:
    from ray_tpu_torch._private import wire

    findings: List[Finding] = []
    seen: Set[Tuple[str, str, Tuple[str, ...]]] = set()
    for h in analysis.handlers:
        schema = wire.SCHEMAS.get(h.method)
        if schema is None or h.qualname is None:
            continue
        escapes = analysis.handler_escapes(h) & wire.KNOWN_ERRORS
        undeclared = tuple(sorted(escapes - set(schema.errors)))
        if not undeclared:
            continue
        fn = analysis.scans[h.path].fns[h.qualname]
        key = (h.path, h.method, undeclared)
        if key in seen:
            continue
        seen.add(key)
        findings.append(
            Finding(
                h.path,
                fn.lineno,
                0,
                RULE_UNDECLARED,
                f"handler {h.qualname} for {h.method!r} can raise "
                f"{list(undeclared)} — not declared on its WireSchema "
                f"(wire.py errors={sorted(schema.errors)}); an undeclared "
                "typed error crosses the wire as an untyped RpcError and "
                "callers lose the fencing/recovery dispatch. Add it to the "
                "schema's errors= (or catch it in the handler)",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# Rule: swallowed-control-error.
# ---------------------------------------------------------------------------


def _broad_kind(h: ast.ExceptHandler) -> Optional[str]:
    if h.type is None:
        return "bare except:"
    t = _tail(h.type)
    if t == "BaseException":
        return "except BaseException"
    if t == "Exception":
        return "except Exception"
    return None


def _has_await(stmts) -> bool:
    for s in stmts:
        for node in ast.walk(s):
            if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                return True
    return False


def _swallow_findings(analysis: Analysis) -> List[Finding]:
    findings: List[Finding] = []
    for path, mod in analysis.scans.items():
        if not _in_runtime_scope(path):
            continue
        esc = analysis.escapes[path]
        for qual, fn in mod.fns.items():
            is_async = isinstance(fn, ast.AsyncFunctionDef)
            handler_of = analysis.on_handler_path.get((path, qual), set())
            for node in _local_nodes(fn):
                if not isinstance(node, ast.Try):
                    continue
                arriving = esc.arriving(node, qual)
                cancel_can_flow = is_async and _has_await(node.body)
                remaining = set(arriving)
                cancel_remaining = cancel_can_flow
                for h in node.handlers:
                    caught = _catch_set(h)
                    kind = _broad_kind(h)
                    caught_typed = {
                        e for e in remaining if _covers(caught, e)
                    }
                    catches_cancel = cancel_remaining and _covers(
                        caught, "CancelledError"
                    )
                    if kind is not None and not _reraises(h):
                        eaten: Set[str] = set()
                        if catches_cancel and kind != "except Exception":
                            # except Exception does NOT catch
                            # CancelledError (BaseException since 3.8).
                            eaten.add("CancelledError")
                        if handler_of:
                            eaten |= caught_typed & set(_CONTROL)
                        if eaten:
                            on = (
                                " on the handler path of "
                                + ", ".join(sorted(handler_of)[:3])
                                if handler_of
                                else f" in async {qual}"
                            )
                            findings.append(
                                Finding(
                                    path,
                                    h.lineno,
                                    0,
                                    RULE_SWALLOW,
                                    f"{kind} swallows "
                                    f"{sorted(eaten)}{on} — converts a "
                                    "cancellation/fencing/deadline signal "
                                    "into silent success. Re-raise control "
                                    "errors (bare `raise`, or an isinstance "
                                    "filter) or narrow the except",
                                )
                            )
                    # Whatever this clause catches never reaches later
                    # clauses (re-raised errors escape the try entirely).
                    remaining -= caught_typed
                    if catches_cancel:
                        cancel_remaining = False
    return findings


# ---------------------------------------------------------------------------
# Rule: retry-unsafe-mutation.
# ---------------------------------------------------------------------------


def _observability(chain: str) -> bool:
    return any(
        tok in seg.lower() for seg in chain.split(".") for tok in _OBS_TOKENS
    )


def _self_rooted(node: ast.AST) -> Optional[str]:
    """Dotted chain if the expression is rooted at ``self``."""
    chain = _dotted(node)
    if chain and (chain == "self" or chain.startswith("self.")):
        return chain
    return None


def _mutation_sites(fn: ast.AST) -> List[Tuple[int, str]]:
    """Non-keyed mutations of self-rooted shared state in one function:
    counter arithmetic (AugAssign) and list-semantics adds. The verbs
    mirror aio_lint's shared-attribute write footprints, narrowed to the
    non-idempotent subset (keyed ``d[k] = v`` and ``set.add`` are fine
    under re-delivery)."""
    out: List[Tuple[int, str]] = []
    for node in _local_nodes(fn):
        if isinstance(node, ast.AugAssign):
            tgt = node.target
            base = tgt.value if isinstance(tgt, (ast.Attribute, ast.Subscript)) else None
            chain = _self_rooted(tgt) or (
                _self_rooted(base) if base is not None else None
            )
            if chain and not _observability(chain):
                out.append((node.lineno, f"{chain} {type(node.op).__name__}="))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _APPEND_VERBS
        ):
            chain = _self_rooted(node.func.value)
            if chain and not _observability(chain):
                out.append((node.lineno, f"{chain}.{node.func.attr}(...)"))
    return out


def _dedup_key_line(fn: ast.AST, key: str) -> Optional[int]:
    """First line the handler reads its dedup key (``p["k"]``/``p.get("k")``
    on the payload parameter, or any literal of the key name)."""
    args = getattr(fn, "args", None)
    pname = args.args[-1].arg if args and args.args else None
    best: Optional[int] = None
    for node in _local_nodes(fn):
        hit = False
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == pname
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == key
        ):
            hit = True
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("get", "pop")
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == pname
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == key
        ):
            hit = True
        elif isinstance(node, ast.Constant) and node.value == key:
            hit = True
        if hit and (best is None or node.lineno < best):
            best = node.lineno
    return best


def _retry_findings(analysis: Analysis) -> List[Finding]:
    from ray_tpu_torch._private import wire

    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for h in analysis.handlers:
        schema = wire.SCHEMAS.get(h.method)
        if schema is None or h.qualname is None:
            continue
        mod = analysis.scans[h.path]
        if schema.retry == wire.RETRY_SAFE:
            for qual in sorted(h.closure):
                fn = mod.fns.get(qual)
                if fn is None:
                    continue
                for line, desc in _mutation_sites(fn):
                    key = (h.path, line)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(
                        Finding(
                            h.path,
                            line,
                            0,
                            RULE_RETRY,
                            f"RETRY_SAFE handler {h.service}:{h.method} "
                            f"mutates non-keyed state (`{desc}` in {qual}) "
                            "— a transparent retry after a lost reply "
                            "double-applies it. Make the write keyed/"
                            "idempotent, or declare the method RETRY_NONE/"
                            "RETRY_DEDUP honestly",
                        )
                    )
        elif schema.retry == wire.RETRY_DEDUP:
            fn = mod.fns.get(h.qualname)
            if fn is None:
                continue
            key_line = _dedup_key_line(fn, schema.dedup_key or "")
            own = [(ln, d, h.qualname) for ln, d in _mutation_sites(fn)]
            # Callee mutations count at their call-site line in the handler:
            # the dedup check must happen before ANY state moves.
            cls = (
                h.qualname.rsplit(".", 1)[0] if "." in h.qualname else None
            )
            mutating_callees = {
                q
                for q in h.closure
                if q != h.qualname
                and mod.fns.get(q) is not None
                and _mutation_sites(mod.fns[q])
            }
            for node in _local_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = None
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "self"
                ):
                    name = func.attr
                elif isinstance(func, ast.Name):
                    name = func.id
                if name is None:
                    continue
                callee = mod.resolve(name, cls)
                if callee in mutating_callees:
                    own.append(
                        (node.lineno, f"{name}(...) [mutating callee]", callee)
                    )
            for line, desc, where in own:
                if key_line is not None and line >= key_line:
                    continue  # after the dedup-key check: ledger covers it
                key = (h.path, line)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(
                    Finding(
                        h.path,
                        line,
                        0,
                        RULE_RETRY,
                        f"RETRY_DEDUP handler {h.service}:{h.method} "
                        f"mutates state (`{desc}`) before reading its "
                        f"dedup key {schema.dedup_key!r}"
                        + (
                            f" (first read at line {key_line})"
                            if key_line is not None
                            else " (never read in the handler)"
                        )
                        + " — a re-delivered frame double-applies the "
                        "mutation before the ledger can mirror the "
                        "original outcome. Check the dedup key first",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# Rule: ack-before-persist.
# ---------------------------------------------------------------------------


def _ack_findings(analysis: Analysis) -> List[Finding]:
    findings: List[Finding] = []
    handler_quals = {
        (h.path, h.qualname)
        for h in analysis.handlers
        if h.qualname is not None
    }
    for path, mod in analysis.scans.items():
        if not _is_gcs_file(path):
            continue
        # Per-fn: which durable tables its closure persists (for clearing
        # dirt at helper-call sites).
        persists_of: Dict[str, Set[str]] = {}
        for qual, fn in mod.fns.items():
            persists_of[qual] = _direct_persists(fn)
        for qual in mod.fns:
            closure = _closure(mod, qual)
            merged = set()
            for q in closure:
                merged |= persists_of.get(q, set())
            persists_of[qual] = merged
        for qual, fn in mod.fns.items():
            findings.extend(
                _scan_fn_ordering(
                    mod,
                    qual,
                    fn,
                    persists_of,
                    is_handler=(path, qual) in handler_quals,
                )
            )
    return findings


def _direct_persists(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in _local_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        t = _tail(node.func)
        if t in _PERSIST_FNS:
            out.add(_PERSIST_FNS[t])
        elif (
            t in ("put", "delete")
            and isinstance(node.func, ast.Attribute)
            and (_dotted(node.func.value) or "").rsplit(".", 1)[-1] == "store"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value in _STORE_TABLES
        ):
            out.add(node.args[0].value)
    return out


def _scan_fn_ordering(
    mod: _ModuleFns,
    qual: str,
    fn: ast.AST,
    persists_of: Dict[str, Set[str]],
    is_handler: bool = True,
) -> List[Finding]:
    """Line-linear mutate → persist → ack ordering within one function."""
    cls = qual.rsplit(".", 1)[0] if "." in qual else None
    aliases: Dict[str, str] = {}
    args = getattr(fn, "args", None)
    if args is not None:
        for a in args.args:
            if a.arg in _ALIAS_NAMES:
                aliases[a.arg] = _ALIAS_NAMES[a.arg]

    def durable_of(node: ast.AST) -> Optional[str]:
        """Durable table a reference resolves to (self.<attr> or alias)."""
        if isinstance(node, ast.Attribute):
            root = _dotted(node) or ""
            if root.startswith("self.") :
                attr = root.split(".", 2)[1] if root.count(".") >= 1 else ""
                if attr in _DURABLE_ATTRS:
                    return _DURABLE_ATTRS[attr]
        if isinstance(node, ast.Name) and node.id in aliases:
            return aliases[node.id]
        return None

    # events: (line, col, kind, payload)
    events: List[Tuple[int, int, str, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            continue
        # alias binding: actor = self.actors[...] / .get(...) / .pop(...)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            src = node.value
            base = None
            if isinstance(src, ast.Subscript):
                base = src.value
            elif (
                isinstance(src, ast.Call)
                and isinstance(src.func, ast.Attribute)
                and src.func.attr in ("get", "pop", "setdefault")
            ):
                base = src.func.value
            if (
                base is not None
                and isinstance(tgt, ast.Name)
                and isinstance(base, ast.Attribute)
            ):
                root = _dotted(base) or ""
                attr = root.split(".")[1] if root.startswith("self.") else ""
                if attr in _DURABLE_ATTRS:
                    aliases[tgt.id] = _DURABLE_ATTRS[attr]
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            it = node.iter
            base = None
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute):
                base = it.func.value
                if (
                    isinstance(base, ast.Call)
                    and isinstance(base.func, ast.Name)
                    and base.func.id == "list"
                    and base.args
                ):
                    inner = base.args[0]
                    if isinstance(inner, ast.Call) and isinstance(
                        inner.func, ast.Attribute
                    ):
                        base = inner.func.value
            if isinstance(base, ast.Attribute):
                root = _dotted(base) or ""
                attr = root.split(".")[1] if root.startswith("self.") else ""
                if attr in _DURABLE_ATTRS:
                    aliases[node.target.id] = _DURABLE_ATTRS[attr]

    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
            continue
        line, col = getattr(node, "lineno", 0), getattr(node, "col_offset", 0)
        # -- mutations --
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            tgts = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in tgts:
                if isinstance(tgt, ast.Subscript):
                    t = durable_of(tgt.value)
                    if t:
                        events.append((line, col, "mut", t))
                elif isinstance(tgt, ast.Attribute):
                    if tgt.attr in _EPHEMERAL_REC_ATTRS:
                        continue
                    t = durable_of(tgt.value)
                    if t:
                        events.append((line, col, "mut", t))
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    t = durable_of(tgt.value)
                    if t:
                        events.append((line, col, "mut", t))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            verb = node.func.attr
            if verb in ("pop", "update", "clear", "setdefault", "append"):
                t = durable_of(node.func.value)
                if t:
                    events.append((line, col, "mut", t))
        # -- persists (direct + via helper call) --
        if isinstance(node, ast.Call):
            t = _tail(node.func)
            if t in _PERSIST_FNS:
                events.append((line, col, "persist", _PERSIST_FNS[t]))
            elif (
                t in ("put", "delete")
                and isinstance(node.func, ast.Attribute)
                and (_dotted(node.func.value) or "").rsplit(".", 1)[-1]
                == "store"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value in _STORE_TABLES
            ):
                events.append((line, col, "persist", node.args[0].value))
            elif t is not None:
                callee = mod.resolve(t, cls)
                if callee is not None and callee != qual:
                    for table in sorted(persists_of.get(callee, ())):
                        events.append((line, col, "persist", table))
        # -- acks --
        # A ``return`` is a wire reply only in a registered handler; a
        # helper returning a value to the scheduler loop acks nothing.
        if (
            is_handler
            and isinstance(node, ast.Return)
            and node.value is not None
        ):
            if not (
                isinstance(node.value, ast.Constant)
                and node.value.value is None
            ):
                events.append((line, col, "ack", "reply (return)"))
        elif isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            a = node.func.attr
            recv = _dotted(node.func.value) or ""
            if a in ("set_result", "set_exception"):
                events.append((line, col, "ack", f"waiter {a}"))
            elif a == "_publish_msg" or (
                a == "publish" and "publisher" in recv
            ):
                events.append((line, col, "ack", "publish"))

    events.sort(key=lambda e: (e[0], e[1]))
    dirty: Dict[str, int] = {}
    findings: List[Finding] = []
    reported: Set[int] = set()
    for line, _col, kind, payload in events:
        if kind == "mut":
            dirty.setdefault(payload, line)
        elif kind == "persist":
            dirty.pop(payload, None)
        elif kind == "ack" and dirty and line not in reported:
            reported.add(line)
            tables = ", ".join(
                f"{t} (mutated line {ln})" for t, ln in sorted(dirty.items())
            )
            findings.append(
                Finding(
                    mod.path,
                    line,
                    0,
                    RULE_ACK,
                    f"{payload} in {qual} is reachable before the "
                    f"write-through for durable table(s) {tables} — a crash "
                    "in the window acks state the restarted GCS will not "
                    "reload. Persist first, then reply/publish",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# Mutation gate: a seeded except-swallow of CancelledError in the raylet
# grant path. The overlay path ends in _private/raylet.py so scope rules
# attribute it to the runtime; --expect-violation requires the pass to
# flag it with its own rule (the rpc_flow/explore --mutate pattern).
# ---------------------------------------------------------------------------

# name -> (virtual overlay path, overlay source, rule the gate must raise)
_MUTATIONS: Dict[str, Tuple[str, str, str]] = {
    "swallow_cancel": (
        "<mutant>/_private/raylet.py",
        """
        class _MutantRaylet:
            def _register_handlers(self, s):
                s.register(
                    "RequestWorkerLease", self._request_worker_lease_mutant
                )

            async def _request_worker_lease_mutant(self, conn, p):
                try:
                    return await self._grant_lease(p)
                except BaseException:
                    # Swallows CancelledError during teardown: the grant
                    # task reports success instead of unwinding.
                    return {"ok": True}

            async def _grant_lease(self, p):
                await self.pool.ready()
                return {"granted": True}
        """,
        RULE_SWALLOW,
    ),
}


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def check(
    paths: Optional[Sequence[str]] = None,
    apply_suppressions: bool = True,
    mutate: Optional[str] = None,
) -> List[Finding]:
    extra = None
    if mutate is not None:
        if mutate not in _MUTATIONS:
            raise SystemExit(
                f"unknown mutation {mutate!r} (have: {sorted(_MUTATIONS)})"
            )
        vpath, vsrc, _ = _MUTATIONS[mutate]
        extra = [(vpath, vsrc)]
    analysis = build(paths, extra_sources=extra)
    findings = (
        _undeclared_findings(analysis)
        + _swallow_findings(analysis)
        + _retry_findings(analysis)
        + _ack_findings(analysis)
    )
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if not apply_suppressions:
        return findings

    sup_cache: Dict[str, Dict[int, Set[str]]] = {}

    def suppressed(f: Finding) -> bool:
        if f.path not in sup_cache:
            sup: Dict[int, Set[str]] = {}
            try:
                with open(f.path, "r", encoding="utf-8") as fh:
                    for i, text in enumerate(fh.read().splitlines(), 1):
                        m = _SUPPRESS_RE.search(text)
                        if m:
                            sup[i] = {
                                r.strip()
                                for r in m.group(1).split(",")
                                if r.strip()
                            }
            except OSError:
                pass
            sup_cache[f.path] = sup
        for line in (f.line, f.line - 1):
            rules = sup_cache[f.path].get(line)
            if rules and ("all" in rules or f.rule in rules):
                return True
        return False

    return [f for f in findings if not suppressed(f)]


def report(paths: Optional[Sequence[str]] = None) -> str:
    """Per-handler escape-set table (triage aid for errors= declarations)."""
    from ray_tpu_torch._private import wire

    analysis = build(paths)
    lines = ["handler escape sets (typed taxonomy only):", ""]
    for h in sorted(analysis.handlers, key=lambda h: (h.service, h.method)):
        if h.qualname is None:
            continue
        esc = analysis.handler_escapes(h) & wire.KNOWN_ERRORS
        schema = wire.SCHEMAS.get(h.method)
        declared = sorted(schema.errors) if schema else None
        lines.append(
            f"  {h.service}:{h.method}  escapes={sorted(esc) or '[]'}  "
            f"declared={declared if declared is not None else '(no schema)'}"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.exc_flow",
        description="whole-program exception-propagation analyzer",
    )
    parser.add_argument("paths", nargs="*", default=None)
    parser.add_argument(
        "--report",
        action="store_true",
        help="print the per-handler escape-set table instead of checking",
    )
    parser.add_argument(
        "--mutate",
        default=None,
        help=f"overlay a seeded defect (have: {sorted(_MUTATIONS)})",
    )
    parser.add_argument(
        "--expect-violation",
        action="store_true",
        help="invert the exit status: succeed only if findings were raised",
    )
    args = parser.parse_args(argv)
    paths = args.paths or None
    if args.report:
        print(report(paths))
        return 0
    findings = check(paths, mutate=args.mutate)
    for f in findings:
        print(f)
    if args.expect_violation:
        # The seeded defect must raise its *own* rule — pre-existing
        # findings of other rules must not make a toothless pass look
        # sharp.
        want = (
            _MUTATIONS[args.mutate][2] if args.mutate in _MUTATIONS else None
        )
        hits = [f for f in findings if want is None or f.rule == want]
        if hits:
            print(
                f"exc-flow: mutation detected ({len(hits)} "
                f"{want or 'any'} finding(s)) — the pass has teeth"
            )
            return 0
        print(
            f"exc-flow: expected a {want or 'violation'} finding "
            "but found none"
        )
        return 1
    if findings:
        print(f"exc-flow: {len(findings)} finding(s)")
        return 1
    print("exc-flow: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
