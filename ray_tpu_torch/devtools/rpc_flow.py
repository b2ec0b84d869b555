"""Whole-program blocking-graph analyzer for the RPC control plane.

Every other devtools pass is local: aio_lint is per-function, lifecycle is
intraprocedural, protocols is per-state-machine, and the explore harness is
exhaustive only on closed scenario fragments. This pass closes the remaining
axis — *cross-process* blocking — statically. It reuses rpc_check's wire
inventory (literal method strings at ``conn.call(...)`` sites matched against
``Server.register(...)`` registrations) to build an interprocedural blocking
graph: for every registered handler, the closure of same-module calls it can
make, the RPCs issued along that closure (resolved to the destination
service's handler), and the local suspension points (futures, Events,
Queues, ``rpc.spawn``). The model is the Chandy–Misra–Haas wait-for graph
applied at lint time instead of detection time: a cycle among handler nodes
is the distributed-deadlock shape before it ever hangs a deployment.

Rules
-----
- ``wait-cycle``: a cycle in the cross-service blocking graph over
  synchronous edges (``call``/``call_into``/``call_with_blob`` — vias that
  suspend the issuing handler until the remote handler replies). Example
  shape: a GCS handler awaiting a raylet RPC whose handler synchronously
  re-enters the GCS. Every edge crosses a process boundary, so every cycle
  is a potential distributed deadlock (and a certain one on the single-loop
  SimCluster, where the "two processes" share an event loop).
  Spawn-crossing and ``call_nowait`` edges are recorded in the graph but
  excluded from cycles: a spawned task or an unawaited future does not
  block the handler that issued it.
- ``deadline-drop``: a request issued on a handler path through a via that
  drops the caller's remaining deadline budget. ``Connection.call`` and
  ``call_into`` fold the ambient handler deadline into the frame TTL
  (``_effective_deadline``), but ``call_nowait`` only carries a TTL when
  ``deadline=`` is passed explicitly, ``call_cb`` never carries one, and
  ``call_with_blob`` *cannot* (its fifth frame slot is the blob byte
  length). Work dispatched through those vias outlives the deadline that
  ``_run_deadlined`` enforces at the top of the calling handler. Flagged
  only when the handler's method is ever called with a budget (some call
  site passes ``timeout=``/``deadline=`` or uses an ambient-folding via).
  Remedy: pass ``deadline=rpc.current_deadline()`` (absolute loop-time
  instant) or switch to ``conn.call``; waive one-way wire shapes.
- ``unbounded-await``: a handler path awaits a future
  (``loop.create_future()`` locals, ``*.fut`` attributes), an
  ``Event.wait()``, or a queue ``get()``/``join()`` with no
  ``asyncio.wait_for`` bound, while the handler's method is *not*
  guaranteed a deadline (at least one call site sends no TTL). The await
  can park the handler forever; ``_run_deadlined`` only cancels when a
  TTL rode the frame. Only the synchronous part of the closure counts:
  across an ``rpc.spawn`` boundary the spawned task, not the handler, is
  the one parked (background pumps/reapers wait unboundedly by design).
- ``unsupervised-spawn``: a bare ``rpc.spawn(...)``/``self._spawn(...)``
  expression statement (result dropped — failure is only logged by the
  spawn machinery) on a handler path that participates in a ledgered
  pair (raylet grant ledger, ``available`` resource arithmetic) or the
  placement-group 2PC protocol (``PreparePGBundles``/``CommitPGBundles``/
  ``ReleasePGBundles``). A crashed background step strands the ledger or
  the 2PC state machine with nobody to repair it.

Static horizon: callee resolution is same-module only (``self._foo()`` and
module-level ``foo()``); cross-module helper wrappers around ``conn.call``
are not followed — direct call sites dominate this codebase. Receiver
hints (``node.conn`` → raylet, ``handle.conn`` → worker, ``self.gcs`` →
gcs) disambiguate method names registered by more than one service;
unhinted ambiguous sites fan out to every registrant (over-approximation).

Suppression: ``# rpc-flow: disable=<rule>[,<rule>]`` (or ``disable=all``)
on the flagged line or the line directly above it. The unified lint gate's
stale-suppression audit covers this family.

Run: ``python -m ray_tpu_torch.devtools.rpc_flow [--markdown] [--mutate NAME
[--expect-violation]] [paths]``. ``--markdown`` emits the committed
``docs/rpc_flow.md`` blocking-graph inventory; ``--mutate back_call``
overlays a seeded synchronous back-call cycle (a raylet ``ReleasePGBundles``
handler re-entering the GCS) and ``--expect-violation`` inverts the exit
status so CI proves the pass has teeth.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
import textwrap
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.devtools import rpc_check
from ray_tpu_torch.devtools.aio_lint import (
    Finding,
    _default_root,
    _dotted,
    iter_py_files,
)

RULE_CYCLE = "wait-cycle"
RULE_DROP = "deadline-drop"
RULE_UNBOUNDED = "unbounded-await"
RULE_SPAWN = "unsupervised-spawn"

ALL_RULES = (RULE_CYCLE, RULE_DROP, RULE_UNBOUNDED, RULE_SPAWN)

_SUPPRESS_RE = re.compile(r"#\s*rpc-flow:\s*disable=([\w\-, ]+)")

# ---------------------------------------------------------------------------
# Service topology.
#
# Which OS process a file's handlers run in. Path-suffix keyed (basenames
# collide: serve has its own server.py). Files not listed are named by
# module stem — they only matter if they register handlers.
# ---------------------------------------------------------------------------

_SERVICE_MAP: Tuple[Tuple[str, str], ...] = (
    ("_private/gcs.py", "gcs"),
    ("_private/gcs_ha.py", "gcs"),
    ("_private/gcs_store.py", "gcs"),
    ("_private/raylet.py", "raylet"),
    ("_private/worker_main.py", "worker"),
    ("_private/worker_zygote.py", "worker"),
    ("_private/core_worker.py", "core"),
    ("_private/worker.py", "driver"),
    ("util/client/server.py", "client-proxy"),
)

# Receiver-chain tokens that pin an ambiguous method name to one service:
# ``handle.conn.call("CreateActor", ...)`` in the raylet dials the *worker*
# it just leased, not the GCS registration of the same method name.
_RECV_HINTS: Tuple[Tuple[str, str], ...] = (
    ("gcs", "gcs"),
    ("raylet", "raylet"),
    ("node", "raylet"),
    ("peer", "raylet"),
    ("handle", "worker"),
    ("worker", "worker"),
    ("lease", "worker"),
)

# Vias that suspend the issuing handler until the remote replies: these are
# the blocking edges cycles are computed over. call_nowait returns a future
# (blocks only if awaited later — beyond the static horizon, recorded as an
# async edge); push/push_nowait/blob_push_nowait are one-way notifications.
_SYNC_VIAS = {"call", "call_into", "call_with_blob"}
_ASYNC_VIAS = {"call_nowait", "call_cb"}

# Request-shaped vias that drop the ambient deadline budget (see module
# docstring). call_nowait only drops it when no explicit deadline= rides.
_DROP_VIAS = {"call_cb", "call_with_blob"}

_TWO_PC_METHODS = {"PreparePGBundles", "CommitPGBundles", "ReleasePGBundles"}

# Ledgered-pair participation markers (see devtools/lifecycle.py REGISTRY):
# the raylet grant-dedup ledger methods and the `available` resource
# arithmetic idiom.
_LEDGER_CALLS = {"_record_granted", "_mark_lease_released", "_burn_lease_id"}
_LEDGER_ATTR = "available"

_SPAWN_NAMES = {"spawn", "_spawn"}


def _service_for(path: str) -> str:
    norm = os.path.abspath(path).replace(os.sep, "/")
    for suffix, svc in _SERVICE_MAP:
        if norm.endswith(suffix):
            return svc
    return os.path.splitext(os.path.basename(path))[0]


# ---------------------------------------------------------------------------
# Per-function facts.
# ---------------------------------------------------------------------------


@dataclass
class RpcSite:
    method: str
    via: str
    line: int
    recv: str  # dotted receiver chain ("node.conn", "self.gcs", ...)
    timeout_src: Optional[str] = None  # unparsed timeout= argument
    deadline_src: Optional[str] = None  # unparsed deadline= argument


@dataclass
class AwaitSite:
    line: int
    kind: str  # "future" | "event" | "queue"
    desc: str  # unparsed awaited expression


@dataclass
class SpawnSite:
    line: int
    target: Optional[str]  # trailing name of the spawned callable, if a call
    desc: str
    supervised: bool  # result bound to a name (caller can observe failure)


@dataclass
class FnInfo:
    path: str
    qualname: str
    line: int
    is_async: bool
    rpc_sites: List[RpcSite] = field(default_factory=list)
    await_sites: List[AwaitSite] = field(default_factory=list)
    spawn_sites: List[SpawnSite] = field(default_factory=list)
    callees: Set[str] = field(default_factory=set)  # resolved same-module
    spawned: Set[str] = field(default_factory=set)  # spawned same-module
    ledger: bool = False
    two_pc: bool = False


def _local_nodes(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs/lambdas
    (they are scanned as their own functions)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _queueish(recv: str) -> bool:
    last = recv.rsplit(".", 1)[-1].lower()
    return "queue" in last or last == "q" or last.endswith("_q")


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return "<expr>"


class _ModuleScan:
    """All FnInfos of one module, plus name-based lookup for callee and
    registered-handler resolution."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.fns: Dict[str, FnInfo] = {}
        self.by_name: Dict[str, List[str]] = {}
        self._walk(tree.body, prefix="")

    def _walk(self, body: Sequence[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._walk(node.body, prefix=f"{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                if qual in self.fns:  # redefinition: keep the last
                    self.by_name[node.name].remove(qual)
                self.fns[qual] = self._scan_fn(node, qual)
                self.by_name.setdefault(node.name, []).append(qual)
                # Nested defs become their own (bare-name addressable) fns.
                self._walk(
                    [
                        n
                        for n in ast.walk(node)
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and n is not node
                        and self._direct_child_fn(node, n)
                    ],
                    prefix=f"{qual}.",
                )

    @staticmethod
    def _direct_child_fn(parent: ast.AST, fn: ast.AST) -> bool:
        for node in _local_nodes(parent):
            if node is fn:
                return True
        return False

    def resolve(self, name: str, cls: Optional[str]) -> Optional[str]:
        """Resolve a called name to a qualname in this module."""
        if cls is not None and f"{cls}.{name}" in self.fns:
            return f"{cls}.{name}"
        quals = self.by_name.get(name, [])
        if len(quals) == 1:
            return quals[0]
        if cls is None and name in self.fns:
            return name
        return None

    def _scan_fn(self, fn: ast.AST, qual: str) -> FnInfo:
        info = FnInfo(
            path=self.path,
            qualname=qual,
            line=fn.lineno,
            is_async=isinstance(fn, ast.AsyncFunctionDef),
        )
        expr_values = set()
        spawn_args = set()
        fut_vars: Set[str] = set()
        for node in _local_nodes(fn):
            if isinstance(node, ast.Expr):
                expr_values.add(id(node.value))
            elif (
                isinstance(node, ast.Call)
                and _tail(node.func) in _SPAWN_NAMES
                and node.args
                and isinstance(node.args[0], ast.Call)
            ):
                # The coroutine call inside spawn(...) crosses the spawn
                # boundary — it must not double as a synchronous callee.
                spawn_args.add(id(node.args[0]))
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                tail = _tail(node.value.func)
                dotted = _dotted(node.value.func) or ""
                if tail == "create_future" or dotted == "asyncio.Future":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            fut_vars.add(tgt.id)

        for node in _local_nodes(fn):
            if isinstance(node, ast.Call):
                self._scan_call(node, info, expr_values, spawn_args)
            elif isinstance(node, ast.Await):
                self._scan_await(node, info, fut_vars)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                if node.value in _TWO_PC_METHODS:
                    info.two_pc = True
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                tgts = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in tgts:
                    if isinstance(tgt, ast.Attribute) and tgt.attr == _LEDGER_ATTR:
                        info.ledger = True
        return info

    def _scan_call(
        self,
        node: ast.Call,
        info: FnInfo,
        expr_values: Set[int],
        spawn_args: Set[int],
    ) -> None:
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        tail = _tail(func)
        if attr in rpc_check._CALL_METHODS and node.args:
            method = node.args[0]
            if isinstance(method, ast.Constant) and isinstance(method.value, str):
                timeout_src = None
                deadline_src = None
                if attr == "call" and len(node.args) > 2:
                    timeout_src = _unparse(node.args[2])
                for kw in node.keywords:
                    if kw.arg == "timeout":
                        timeout_src = _unparse(kw.value)
                    elif kw.arg == "deadline":
                        deadline_src = _unparse(kw.value)
                info.rpc_sites.append(
                    RpcSite(
                        method=method.value,
                        via=attr,
                        line=node.lineno,
                        recv=_dotted(func.value) or "?",
                        timeout_src=timeout_src,
                        deadline_src=deadline_src,
                    )
                )
                return
        if tail in _LEDGER_CALLS:
            info.ledger = True
        if tail in _SPAWN_NAMES:
            target = None
            if node.args and isinstance(node.args[0], ast.Call):
                target = _tail(node.args[0].func)
            elif node.args:
                # spawn(coro) forwarding a parameter (the spawn wrapper
                # itself) — nothing to say about an opaque coroutine.
                return
            info.spawn_sites.append(
                SpawnSite(
                    line=node.lineno,
                    target=target,
                    desc=_unparse(node)[:80],
                    supervised=id(node) not in expr_values,
                )
            )
            if target is not None:
                info.spawned.add(target)
            return
        # Same-module callee candidates: self.X(...) and bare f(...).
        if id(node) in spawn_args:
            return
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            info.callees.add(func.attr)
        elif isinstance(func, ast.Name):
            info.callees.add(func.id)

    def _scan_await(
        self, node: ast.Await, info: FnInfo, fut_vars: Set[str]
    ) -> None:
        v = node.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute):
            recv = _dotted(v.func.value) or ""
            if v.func.attr == "wait" and not v.args and recv != "asyncio":
                info.await_sites.append(
                    AwaitSite(node.lineno, "event", _unparse(v))
                )
            elif v.func.attr in ("get", "join") and _queueish(recv):
                info.await_sites.append(
                    AwaitSite(node.lineno, "queue", _unparse(v))
                )
        elif isinstance(v, ast.Name) and v.id in fut_vars:
            info.await_sites.append(AwaitSite(node.lineno, "future", v.id))
        elif isinstance(v, ast.Attribute) and (
            v.attr in ("fut", "future") or v.attr.endswith("_fut")
        ):
            info.await_sites.append(
                AwaitSite(node.lineno, "future", _unparse(v))
            )


# ---------------------------------------------------------------------------
# Whole-program analysis.
# ---------------------------------------------------------------------------


@dataclass
class Edge:
    src_service: str
    src_method: str
    dst_service: str
    dst_method: str
    site: RpcSite
    site_path: str
    via_spawn: bool  # reached across a spawn boundary


@dataclass
class Handler:
    service: str
    method: str
    path: str
    line: int
    qualname: Optional[str]  # None when the handler body is out of reach


@dataclass
class Analysis:
    handlers: List[Handler] = field(default_factory=list)
    edges: List[Edge] = field(default_factory=list)
    # (handler, FnInfo path, site, via_spawn) for local-wait/spawn rules.
    closure_awaits: List[Tuple[Handler, str, AwaitSite]] = field(
        default_factory=list
    )
    closure_spawns: List[Tuple[Handler, str, SpawnSite, bool]] = field(
        default_factory=list
    )
    closure_drops: List[Tuple[Handler, str, RpcSite]] = field(
        default_factory=list
    )
    # method -> every RpcSite anywhere in the tree (deadline provenance).
    sites_by_method: Dict[str, List[Tuple[str, RpcSite]]] = field(
        default_factory=dict
    )
    services_by_method: Dict[str, Set[str]] = field(default_factory=dict)


def _collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            files.extend(iter_py_files(path))
        else:
            files.append(path)
    return files


def _dst_services(site: RpcSite, registered_in: Set[str]) -> Set[str]:
    """Destination services for a call site, hint-disambiguated."""
    if len(registered_in) <= 1:
        return set(registered_in)
    recv = site.recv.lower()
    segments = set(recv.replace("self.", "").split("."))
    hinted = {
        svc
        for token, svc in _RECV_HINTS
        if svc in registered_in
        and any(token in seg for seg in segments)
    }
    return hinted or set(registered_in)


def build(
    paths: Optional[Sequence[str]] = None,
    extra_sources: Optional[Sequence[Tuple[str, str]]] = None,
) -> Analysis:
    paths = list(paths or [_default_root()])
    # Share rpc_check's per-file parse+scan cache: the lint gate runs
    # rpc_check, rpc_flow, and exc_flow in one process over the same tree.
    frags: List[rpc_check.Inventory] = []
    scans: Dict[str, _ModuleScan] = {}
    for f in _collect_files(paths):
        tree, frag = rpc_check._scan_file(f)
        if tree is None:
            continue
        if frag is not None:
            frags.append(frag)
        scans[f] = _ModuleScan(f, tree)
    for vpath, vsrc in extra_sources or ():
        try:
            vtree = ast.parse(vsrc, filename=vpath)
        except SyntaxError:
            continue
        frags.append(rpc_check._scan_tree(vpath, vtree))
        scans[vpath] = _ModuleScan(vpath, vtree)
    inv = rpc_check._merge_inventories(frags)

    analysis = Analysis()
    for scan in scans.values():
        for fn in scan.fns.values():
            for site in fn.rpc_sites:
                analysis.sites_by_method.setdefault(site.method, []).append(
                    (fn.path, site)
                )
    regs_by_method: Dict[str, List[rpc_check.Registration]] = {}
    for reg in inv.regs:
        regs_by_method.setdefault(reg.method, []).append(reg)
    for method, regs in regs_by_method.items():
        analysis.services_by_method[method] = {
            _service_for(r.path) for r in regs
        }

    # One handler node per (service, method, registration); the closure
    # walk below unions multiple registrations of the same node.
    for method, regs in sorted(regs_by_method.items()):
        for reg in sorted(regs, key=lambda r: (r.path, r.line)):
            scan = scans.get(reg.path)
            qual = None
            if scan is not None and reg.handler_name:
                quals = scan.by_name.get(reg.handler_name, [])
                if quals:
                    qual = quals[0]
            handler = Handler(
                service=_service_for(reg.path),
                method=method,
                path=reg.path,
                line=reg.line,
                qualname=qual,
            )
            analysis.handlers.append(handler)
            if qual is not None:
                _walk_closure(handler, scans[reg.path], analysis)
    return analysis


def _walk_closure(
    handler: Handler, scan: _ModuleScan, analysis: Analysis
) -> None:
    """BFS the handler's same-module call closure, recording RPC edges and
    local suspension points. ``via_spawn`` marks everything reached across
    a spawn boundary — still on the handler's causal path, but no longer
    blocking it."""
    assert handler.qualname is not None
    start = handler.qualname
    seen: Set[Tuple[str, bool]] = set()
    frontier: List[Tuple[str, bool]] = [(start, False)]
    path_ledger = False
    path_two_pc = False
    visited_infos: List[Tuple[FnInfo, bool]] = []
    while frontier:
        qual, via_spawn = frontier.pop()
        if (qual, via_spawn) in seen:
            continue
        seen.add((qual, via_spawn))
        info = scan.fns.get(qual)
        if info is None:
            continue
        visited_infos.append((info, via_spawn))
        path_ledger = path_ledger or info.ledger
        path_two_pc = path_two_pc or info.two_pc
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        for name in info.callees:
            nxt = scan.resolve(name, cls)
            if nxt is not None:
                frontier.append((nxt, via_spawn))
        for name in info.spawned:
            nxt = scan.resolve(name, cls)
            if nxt is not None:
                frontier.append((nxt, True))

    critical = path_ledger or path_two_pc
    for info, via_spawn in visited_infos:
        for site in info.rpc_sites:
            registered_in = analysis.services_by_method.get(site.method, set())
            for dst in sorted(_dst_services(site, registered_in)):
                analysis.edges.append(
                    Edge(
                        src_service=handler.service,
                        src_method=handler.method,
                        dst_service=dst,
                        dst_method=site.method,
                        site=site,
                        site_path=info.path,
                        via_spawn=via_spawn,
                    )
                )
            drops = site.via in _DROP_VIAS or (
                site.via == "call_nowait" and site.deadline_src is None
            )
            if drops:
                analysis.closure_drops.append((handler, info.path, site))
        # Local waits only matter on the synchronous part of the closure:
        # across a spawn boundary the handler is not the one parked.
        if not via_spawn:
            for aw in info.await_sites:
                analysis.closure_awaits.append((handler, info.path, aw))
        for sp in info.spawn_sites:
            analysis.closure_spawns.append(
                (handler, info.path, sp, critical)
            )


# ---------------------------------------------------------------------------
# Deadline provenance (shared with rpc_check --markdown's deadline column).
# ---------------------------------------------------------------------------


def deadline_sources(
    analysis: Analysis, method: str
) -> Tuple[bool, bool, List[str]]:
    """(maybe_deadlined, guaranteed_deadlined, budget sources) for a method.

    - maybe: some call site sends a TTL (explicit timeout=/deadline=, or an
      ambient-folding via under a deadlined caller).
    - guaranteed: every call site pins an explicit budget.
    """
    sites = analysis.sites_by_method.get(method, [])
    if not sites:
        return (False, False, [])
    srcs: List[str] = []
    maybe = False
    guaranteed = True
    for _, site in sites:
        explicit = site.timeout_src or site.deadline_src
        if explicit and explicit != "None":
            srcs.append(explicit)
            maybe = True
            if "None" in explicit:
                # A conditional like ``None if t is None else t + 30`` can
                # still evaluate to no-deadline — explicit, but not pinned.
                guaranteed = False
        elif site.via in ("call", "call_into"):
            maybe = True  # folds the ambient deadline when one exists
            guaranteed = False
        else:
            guaranteed = False
    return (maybe, guaranteed, sorted(set(srcs)))


# ---------------------------------------------------------------------------
# Rules.
# ---------------------------------------------------------------------------


def _cycle_findings(analysis: Analysis) -> List[Finding]:
    graph: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    edge_at: Dict[
        Tuple[Tuple[str, str], Tuple[str, str]], Tuple[str, int]
    ] = {}
    for e in analysis.edges:
        if e.via_spawn or e.site.via not in _SYNC_VIAS:
            continue
        src = (e.src_service, e.src_method)
        dst = (e.dst_service, e.dst_method)
        graph.setdefault(src, set()).add(dst)
        key = (src, dst)
        anchor = (e.site_path, e.site.line)
        if key not in edge_at or anchor < edge_at[key]:
            edge_at[key] = anchor

    # Tarjan SCC over handler nodes; any SCC with >1 node (or a self-edge)
    # is a wait cycle.
    index: Dict[Tuple[str, str], int] = {}
    low: Dict[Tuple[str, str], int] = {}
    on_stack: Set[Tuple[str, str]] = set()
    stack: List[Tuple[str, str]] = []
    sccs: List[List[Tuple[str, str]]] = []
    counter = [0]

    def strongconnect(v: Tuple[str, str]) -> None:
        # Iterative Tarjan (handler graphs are small, but no recursion cap).
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)

    findings: List[Finding] = []
    for comp in sccs:
        members = set(comp)
        cyclic = len(comp) > 1 or any(
            v in graph.get(v, ()) for v in comp
        )
        if not cyclic:
            continue
        # Render one concrete cycle path for the message: walk successor
        # edges inside the SCC from the smallest node.
        ordered = sorted(members)
        walk = [ordered[0]]
        while True:
            nxts = sorted(
                w for w in graph.get(walk[-1], ()) if w in members
            )
            if not nxts:
                break
            if nxts[0] in walk:
                walk.append(nxts[0])
                break
            walk.append(nxts[0])
        label = " -> ".join(f"{s}:{m}" for s, m in walk)
        anchor = min(
            edge_at[(a, b)]
            for (a, b) in edge_at
            if a in members and b in members
        )
        findings.append(
            Finding(
                anchor[0],
                anchor[1],
                0,
                RULE_CYCLE,
                f"synchronous RPC wait cycle: {label} — every hop blocks "
                "its handler until the next replies, the distributed-"
                "deadlock shape (and a guaranteed hang on the single-loop "
                "SimCluster); break it with a call_nowait continuation, a "
                "push, or a spawned follow-up",
            )
        )
    return findings


def _drop_findings(analysis: Analysis) -> List[Finding]:
    by_site: Dict[Tuple[str, int], Tuple[RpcSite, Set[str]]] = {}
    for handler, path, site in analysis.closure_drops:
        maybe, _, _ = deadline_sources(analysis, handler.method)
        if not maybe:
            continue  # nobody ever sends this handler a budget
        key = (path, site.line)
        entry = by_site.setdefault(key, (site, set()))
        entry[1].add(f"{handler.service}:{handler.method}")
    findings = []
    for (path, line), (site, handlers) in sorted(by_site.items()):
        hs = ", ".join(sorted(handlers)[:3])
        if site.via == "call_with_blob":
            why = (
                "call_with_blob cannot carry a TTL (the fifth frame slot "
                "is the blob byte length)"
            )
        elif site.via == "call_cb":
            why = "call_cb frames never carry a TTL"
        else:
            why = "call_nowait only carries a TTL when deadline= is passed"
        findings.append(
            Finding(
                path,
                line,
                0,
                RULE_DROP,
                f"{site.via}({site.method!r}) on the deadlined handler "
                f"path of {hs} drops the remaining budget — {why}; the "
                "downstream work outlives the deadline _run_deadlined "
                "enforces at the top. Pass deadline=rpc.current_deadline() "
                "or use conn.call (which folds the ambient budget)",
            )
        )
    return findings


def _unbounded_findings(analysis: Analysis) -> List[Finding]:
    by_site: Dict[Tuple[str, int], Tuple[AwaitSite, Set[str]]] = {}
    for handler, path, aw in analysis.closure_awaits:
        _, guaranteed, _ = deadline_sources(analysis, handler.method)
        if guaranteed:
            continue  # _run_deadlined cancels the handler at the deadline
        key = (path, aw.line)
        entry = by_site.setdefault(key, (aw, set()))
        entry[1].add(f"{handler.service}:{handler.method}")
    findings = []
    for (path, line), (aw, handlers) in sorted(by_site.items()):
        hs = ", ".join(sorted(handlers)[:3])
        findings.append(
            Finding(
                path,
                line,
                0,
                RULE_UNBOUNDED,
                f"handler path of {hs} awaits {aw.kind} `{aw.desc}` with "
                "no asyncio.wait_for bound and no guaranteed request "
                "deadline — the handler can park forever. Bound it with a "
                "config budget, or make every caller send a TTL",
            )
        )
    return findings


def _spawn_findings(analysis: Analysis) -> List[Finding]:
    by_site: Dict[Tuple[str, int], Tuple[SpawnSite, Set[str]]] = {}
    for handler, path, sp, critical in analysis.closure_spawns:
        if sp.supervised or not critical:
            continue
        key = (path, sp.line)
        entry = by_site.setdefault(key, (sp, set()))
        entry[1].add(f"{handler.service}:{handler.method}")
    findings = []
    for (path, line), (sp, handlers) in sorted(by_site.items()):
        hs = ", ".join(sorted(handlers)[:3])
        findings.append(
            Finding(
                path,
                line,
                0,
                RULE_SPAWN,
                f"bare spawn `{sp.desc}` on the handler path of {hs}, "
                "which participates in a ledgered pair or the PG 2PC "
                "protocol — a crashed background step is only logged, "
                "stranding ledger/2PC state. Keep the task and observe "
                "its failure (done-callback that repairs state, or await)",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# Mutation gate.
#
# A seeded synchronous back-call cycle: a raylet ReleasePGBundles handler
# that re-enters the GCS while the GCS _remove_pg handler is itself blocked
# on ReleasePGBundles. The overlay path ends in _private/raylet.py so the
# service map attributes it to the raylet; --expect-violation requires the
# pass to flag it (the explore --mutate pattern).
# ---------------------------------------------------------------------------

# name -> (virtual overlay path, overlay source, rule the gate must raise)
_MUTATIONS: Dict[str, Tuple[str, str, str]] = {
    "back_call": (
        "<mutant>/_private/raylet.py",
        textwrap.dedent(
            '''
            class _MutantRaylet:
                def _register_handlers(self, s):
                    s.register("ReleasePGBundles", self._release_pg_mutant)

                async def _release_pg_mutant(self, conn, p):
                    # Synchronous back-call into the GCS while the GCS
                    # _remove_pg handler blocks on ReleasePGBundles.
                    return await self.gcs.call(
                        "RemovePlacementGroup", {"pg_id": p["pg_id"]}
                    )
            '''
        ),
        RULE_CYCLE,
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
        _cycle_findings(analysis)
        + _drop_findings(analysis)
        + _unbounded_findings(analysis)
        + _spawn_findings(analysis)
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


def markdown(paths: Optional[Sequence[str]] = None) -> str:
    """The versioned blocking-graph inventory committed to docs/."""
    analysis = build(paths)
    root = os.path.dirname(_default_root())

    def rel(p: str) -> str:
        if p.startswith("<"):
            return p
        return os.path.relpath(p, root)

    # Service-level edge summary for the mermaid graph.
    svc_edges: Dict[Tuple[str, str, str], Set[str]] = {}
    for e in analysis.edges:
        kind = (
            "sync"
            if (not e.via_spawn and e.site.via in _SYNC_VIAS)
            else "async"
        )
        svc_edges.setdefault(
            (e.src_service, e.dst_service, kind), set()
        ).add(e.dst_method)

    lines = [
        "# RPC blocking graph",
        "",
        "Generated by `python -m ray_tpu_torch.devtools.rpc_flow --markdown`.",
        "Nodes are services (which OS process a handler runs in); an edge",
        "`A -> B (M)` means some registered handler of A can issue RPC `M`",
        "handled by B while serving a request. **Solid** edges block the",
        "issuing handler until the remote replies (`call`/`call_into`/",
        "`call_with_blob`) — cycles over solid edges are the",
        "Chandy–Misra–Haas distributed-deadlock shape and fail the",
        "`wait-cycle` lint rule. **Dashed** edges are non-blocking",
        "(`call_nowait`/`call_cb` futures, or work reached across an",
        "`rpc.spawn` boundary): still on the causal path, but the issuing",
        "handler does not wait. One-way pushes are omitted.",
        "",
        "```mermaid",
        "graph LR",
    ]
    for (src, dst, kind), methods in sorted(svc_edges.items()):
        shown = sorted(methods)
        label = ", ".join(shown[:4]) + (
            f", +{len(shown) - 4}" if len(shown) > 4 else ""
        )
        arrow = "-->" if kind == "sync" else "-.->"
        lines.append(f"    {src} {arrow}|{label}| {dst}")
    lines.append("```")
    lines.append("")
    lines.append("## Blocking edges (handler → nested RPC)")
    lines.append("")
    lines.append(
        "| Handler (service:method) | Via | Calls | Handled by | Site |"
    )
    lines.append("|---|---|---|---|---|")
    edge_rows = set()
    for e in analysis.edges:
        via = e.site.via + (" ∥spawned" if e.via_spawn else "")
        edge_rows.add(
            (
                f"`{e.src_service}:{e.src_method}`",
                f"`{via}`",
                f"`{e.dst_method}`",
                e.dst_service,
                f"`{rel(e.site_path)}:{e.site.line}`",
            )
        )
    lines.extend(_markdown_rows(edge_rows))
    lines.append("")
    lines.append("## Handler-reachable local waits")
    lines.append("")
    lines.append(
        "Futures/Events/Queues a handler path can park on with no"
    )
    lines.append(
        "`asyncio.wait_for` bound (raw inventory — the `unbounded-await`"
    )
    lines.append(
        "rule additionally requires the method to lack a guaranteed"
    )
    lines.append("request deadline before it fires).")
    lines.append("")
    lines.append("| Handler | Waits on | Kind | Site |")
    lines.append("|---|---|---|---|")
    wait_rows = set()
    for handler, path, aw in analysis.closure_awaits:
        wait_rows.add(
            (
                f"`{handler.service}:{handler.method}`",
                f"`{aw.desc}`",
                aw.kind,
                f"`{rel(path)}:{aw.line}`",
            )
        )
    lines.extend(_markdown_rows(wait_rows))
    lines.append("")
    lines.append("## Spawn points on handler paths")
    lines.append("")
    lines.append(
        "| Handler | Spawns | Supervised | Ledger/2PC path | Site |"
    )
    lines.append("|---|---|---|---|---|")
    spawn_rows = set()
    for handler, path, sp, critical in analysis.closure_spawns:
        spawn_rows.add(
            (
                f"`{handler.service}:{handler.method}`",
                f"`{sp.target or '?'}`",
                "✓" if sp.supervised else "—",
                "✓" if critical else "—",
                f"`{rel(path)}:{sp.line}`",
            )
        )
    lines.extend(_markdown_rows(spawn_rows))
    lines.append("")
    n_sync = len(
        {
            (e.src_service, e.src_method, e.dst_service, e.dst_method)
            for e in analysis.edges
            if not e.via_spawn and e.site.via in _SYNC_VIAS
        }
    )
    lines.append(
        f"{len(analysis.handlers)} registered handlers; "
        f"{len(edge_rows)} edge rows ({n_sync} distinct blocking edges); "
        f"{len(wait_rows)} local waits; {len(spawn_rows)} spawn points."
    )
    lines.append("")
    return "\n".join(lines)


def _markdown_rows(rows: Iterable[Tuple[str, ...]]) -> List[str]:
    return ["| " + " | ".join(r) + " |" for r in sorted(rows)]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.rpc_flow",
        description="whole-program RPC blocking-graph analyzer",
    )
    parser.add_argument("paths", nargs="*", default=None)
    parser.add_argument(
        "--markdown",
        action="store_true",
        help="emit the blocking-graph markdown inventory instead of checking",
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
    if args.markdown:
        print(markdown(paths))
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
                f"rpc-flow: mutation detected ({len(hits)} "
                f"{want or 'any'} finding(s)) — the pass has teeth"
            )
            return 0
        print(
            f"rpc-flow: expected a {want or 'violation'} finding "
            "but found none"
        )
        return 1
    if findings:
        print(f"rpc-flow: {len(findings)} finding(s)")
        return 1
    print("rpc-flow: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
