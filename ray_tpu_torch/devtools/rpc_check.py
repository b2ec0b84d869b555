"""Wire-protocol cross-checker for the msgpack RPC layer.

The RPC layer (:mod:`ray_tpu_torch._private.rpc`) dispatches untyped
``[msgid, kind, method, payload]`` frames by *string* method name, and the
payloads are ad-hoc msgpack dicts — a method-name typo or a renamed payload
key fails at runtime (or worse, silently returns ``None`` from ``p.get``).
This pass makes the wire protocol checkable at lint time:

1. **Method inventory** — every literal method string at a
   ``call``/``call_nowait``/``call_cb``/``push``/``push_nowait`` call site —
   plus the blob-sidecar sends ``blob_push_nowait``/``call_with_blob``/
   ``call_into`` — is cross-checked against every handler registration
   (``Server.register``/``register_sync``/``register_blob``,
   ``@server.handler(...)``, literal
   ``handlers={...}`` dicts passed to ``rpc.connect``/``Connection``, and
   ``_handlers["X"] = fn`` / ``_handlers.setdefault("X", fn)``). Call sites
   naming a method no server registers are errors; registered handlers no
   client ever calls are reported as orphans.
2. **Payload-key drift** — for the message types declared in
   :mod:`ray_tpu_torch._private.wire`, producer payload dict literals must carry
   every required key and nothing undeclared, and consumer handler bodies
   (``p["k"]`` / ``p.get("k")`` on the payload parameter) must only touch
   declared keys.
3. **Magic timeouts** — runtime code under ``_private/`` must not pass a
   numeric ``timeout=`` literal at a ``.call(...)`` site, nor a numeric
   literal of >= 10 s to ``asyncio.wait_for`` (that magnitude is a deadline
   *budget*, not a cleanup grace wait); budgets come from
   ``common.config`` (the ``rpc_*_timeout_s`` knobs) so they are tunable,
   greppable, and consistent with the resilience layer's deadline
   propagation. Under ``serve/_private/`` the same rule additionally covers
   numeric ``timeout_s=`` keyword literals (the serving stack's request
   budgets — ``common.config``'s ``serve_*`` knobs own those). Tests,
   devtools, and examples may use literals.

4. **Trace declaration** — every message type declared in
   :mod:`ray_tpu_torch._private.wire` must state whether its request frames
   carry the sixth-slot trace context (``trace=True``/``trace=False``):
   an undeclared schema (``trace=None``) means nobody decided whether
   the hop joins the distributed trace, and the docs table can't say.

Non-literal method names (e.g. the dashboard's generic proxy
``conn.call(method, ...)``) are outside the static horizon and skipped.
Suppression: ``# aio-lint: disable=<rule>`` with rules
``unknown-rpc-method``, ``orphan-rpc-handler``, ``payload-key-drift``,
``rpc-magic-timeout``, ``wire-trace-undeclared``, ``wire-native-drift``.

Run: ``python -m ray_tpu_torch.devtools.rpc_check [--markdown] [paths]``.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.aio_lint import (
    Finding,
    _suppressions,
    iter_py_files,
    _default_root,
)

RULE_UNKNOWN = "unknown-rpc-method"
RULE_ORPHAN = "orphan-rpc-handler"
RULE_DRIFT = "payload-key-drift"
RULE_TIMEOUT = "rpc-magic-timeout"
RULE_TRACE = "wire-trace-undeclared"
RULE_NATIVE = "wire-native-drift"

_CALL_METHODS = {
    "call",
    "call_nowait",
    "call_cb",
    "push",
    "push_nowait",
    # Blob-sidecar sends (rpc.py kinds 4/5): same (method, payload, ...)
    # shape, so method-name and payload-key checking apply unchanged.
    "blob_push_nowait",
    "call_with_blob",
    "call_into",
}
_REGISTER_METHODS = {"register", "register_sync", "handler", "register_blob"}
# asyncio.wait_for literals at or above this many seconds are deadline
# *budgets* (drain windows, fallback gets, spawn waits) and must come from
# config; shorter literals are bounded cleanup/grace waits and stay inline.
_WAIT_FOR_BUDGET_S = 10.0


@dataclass
class CallSite:
    method: str
    path: str
    line: int
    # Literal payload keys when the payload is a dict display with constant
    # keys; None when the payload is dynamic (or **expanded).
    payload_keys: Optional[Set[str]] = None
    via: str = "call"
    # Numeric timeout literal passed at the call site (timeout= kwarg or the
    # third positional argument of .call), if any.
    timeout_literal: Optional[float] = None


@dataclass
class Registration:
    method: str
    path: str
    line: int
    handler_name: Optional[str] = None  # simple function/method name if known
    kind: str = "register"


@dataclass
class Inventory:
    calls: List[CallSite] = field(default_factory=list)
    regs: List[Registration] = field(default_factory=list)
    # (path, handler_name) -> payload keys the handler body touches.
    handler_keys: Dict[Tuple[str, str], Set[str]] = field(default_factory=dict)
    # Every other string literal in the tree, for lenient orphan detection:
    # state/dashboard wrappers pass method names through one indirection
    # (``_call_gcs("ListActors")``), so "no other literal mentions this
    # method" is the actual dead-handler signal.
    str_literals: Set[str] = field(default_factory=set)
    # asyncio.wait_for(..., <numeric literal>) sites: (path, line, seconds).
    wait_for_literals: List[Tuple[str, int, float]] = field(default_factory=list)
    # Any-call numeric timeout_s= keyword literals: (path, line, seconds).
    # Checked only under serve/_private (the serving stack's budget kwarg).
    timeout_s_literals: List[Tuple[str, int, float]] = field(default_factory=list)


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _const_num(node: ast.AST) -> Optional[float]:
    """Numeric literal (incl. unary minus), or None. Booleans excluded."""
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
    ):
        return float(node.value)
    return None


def _payload_keys(node: Optional[ast.AST]) -> Optional[Set[str]]:
    """Keys of a dict-display payload, or None when not fully literal."""
    if not isinstance(node, ast.Dict):
        return None
    keys: Set[str] = set()
    for k in node.keys:
        if k is None:  # **spread
            return None
        s = _const_str(k)
        if s is None:
            return None
        keys.add(s)
    return keys


def _fn_simple_name(node: ast.AST) -> Optional[str]:
    """``self._foo`` / ``foo`` -> the trailing identifier."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class _FileScanner(ast.NodeVisitor):
    def __init__(self, path: str, inv: Inventory):
        self.path = path
        self.inv = inv
        self._fn_stack: List[ast.AST] = []

    # -- handler payload-key usage ------------------------------------------

    def _scan_handler_body(self, fn) -> None:
        """Record ``p["k"]``/``p.get("k")`` key usage for handler-shaped
        functions ``(conn, p)`` / ``(self, conn, p)``."""
        args = fn.args.args
        if not args:
            return
        pname = args[-1].arg
        if pname == "size" and len(args) >= 2:
            # Blob sink factory shape ``(conn, p, size)`` (register_blob):
            # the payload is the second-to-last parameter.
            pname = args[-2].arg
        if pname in ("self", "conn"):
            return
        keys: Set[str] = set()
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id == pname
            ):
                s = _const_str(node.slice)
                if s is not None:
                    keys.add(s)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("get", "pop")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == pname
                and node.args
            ):
                s = _const_str(node.args[0])
                if s is not None:
                    keys.add(s)
        if keys:
            self.inv.handler_keys[(self.path, fn.name)] = keys

    def visit_FunctionDef(self, node) -> None:
        self._scan_handler_body(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._scan_handler_body(node)
        self.generic_visit(node)

    # -- call sites and registrations ---------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        if attr in _CALL_METHODS and node.args:
            method = _const_str(node.args[0])
            if method is not None:
                payload = node.args[1] if len(node.args) > 1 else None
                timeout_literal = None
                if attr == "call" and len(node.args) > 2:
                    timeout_literal = _const_num(node.args[2])
                for kw in node.keywords:
                    if kw.arg == "payload":
                        payload = kw.value
                    elif kw.arg == "timeout":
                        timeout_literal = _const_num(kw.value)
                self.inv.calls.append(
                    CallSite(
                        method,
                        self.path,
                        node.lineno,
                        _payload_keys(payload),
                        via=attr,
                        timeout_literal=timeout_literal,
                    )
                )
        elif attr in _REGISTER_METHODS and node.args:
            method = _const_str(node.args[0])
            if method is not None:
                handler = (
                    _fn_simple_name(node.args[1]) if len(node.args) > 1 else None
                )
                self.inv.regs.append(
                    Registration(method, self.path, node.lineno, handler, attr)
                )
        elif (
            attr == "wait_for"
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "asyncio"
        ):
            t = None
            if len(node.args) > 1:
                t = _const_num(node.args[1])
            for kw in node.keywords:
                if kw.arg == "timeout":
                    t = _const_num(kw.value)
            if t is not None:
                self.inv.wait_for_literals.append((self.path, node.lineno, t))
        elif attr == "setdefault" and len(node.args) == 2:
            # GcsClient-style: conn._handlers.setdefault("Pub", self._on_pub)
            if self._targets_handlers_dict(fn.value):
                method = _const_str(node.args[0])
                if method is not None:
                    self.inv.regs.append(
                        Registration(
                            method,
                            self.path,
                            node.lineno,
                            _fn_simple_name(node.args[1]),
                            "setdefault",
                        )
                    )
        for kw in node.keywords:
            if kw.arg == "timeout_s":
                t = _const_num(kw.value)
                if t is not None:
                    self.inv.timeout_s_literals.append(
                        (self.path, node.lineno, t)
                    )
        # Literal handlers= dicts passed to rpc.connect()/Connection().
        for kw in node.keywords:
            if kw.arg in ("handlers", "sync_handlers") and isinstance(
                kw.value, ast.Dict
            ):
                for k, v in zip(kw.value.keys, kw.value.values):
                    s = _const_str(k) if k is not None else None
                    if s is not None:
                        self.inv.regs.append(
                            Registration(
                                s, self.path, k.lineno, _fn_simple_name(v), kw.arg
                            )
                        )
        self.generic_visit(node)

    def _targets_handlers_dict(self, node: ast.AST) -> bool:
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        return name is not None and "handlers" in name

    def visit_Assign(self, node: ast.Assign) -> None:
        # _handlers["Name"] = fn
        for tgt in node.targets:
            if (
                isinstance(tgt, ast.Subscript)
                and self._targets_handlers_dict(tgt.value)
            ):
                method = _const_str(tgt.slice)
                if method is not None:
                    self.inv.regs.append(
                        Registration(
                            method,
                            self.path,
                            node.lineno,
                            _fn_simple_name(node.value),
                            "subscript",
                        )
                    )
        self.generic_visit(node)


def _collect_files(paths: List[str]) -> List[str]:
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            files.extend(iter_py_files(path))
        else:
            files.append(path)
    return files


def _scan_tree(path: str, tree: ast.Module) -> Inventory:
    """Per-file Inventory fragment (scanner pass + stray string literals)."""
    frag = Inventory()
    _FileScanner(path, frag).visit(tree)
    reg_lines = {(r.path, r.line) for r in frag.regs}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and (path, node.lineno) not in reg_lines
        ):
            frag.str_literals.add(node.value)
    return frag


# Per-file parse+scan cache shared by every pass that needs the wire
# Inventory (rpc_check, rpc_flow, exc_flow): the unified lint gate runs
# them in one process, and re-parsing the tree three times is the
# difference between fitting the 120 s budget and not.  Keyed by
# (mtime_ns, size) so an edited file re-scans; holds (tree, fragment).
_FILE_CACHE: Dict[
    str, Tuple[int, int, Optional[ast.Module], Optional[Inventory]]
] = {}


def _scan_file(path: str) -> Tuple[Optional[ast.Module], Optional[Inventory]]:
    try:
        st = os.stat(path)
    except OSError:
        return None, None
    sig = (st.st_mtime_ns, st.st_size)
    ent = _FILE_CACHE.get(path)
    if ent is not None and (ent[0], ent[1]) == sig:
        return ent[2], ent[3]
    try:
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        tree: Optional[ast.Module] = ast.parse(src, filename=path)
    except (OSError, SyntaxError):
        tree = None
    frag = _scan_tree(path, tree) if tree is not None else None
    _FILE_CACHE[path] = (sig[0], sig[1], tree, frag)
    return tree, frag


def cached_tree(path: str) -> Optional[ast.Module]:
    """Parsed AST for a file, via the shared per-file cache."""
    return _scan_file(path)[0]


def _merge_inventories(
    fragments: List[Inventory],
    extra_sources: Optional[List[Tuple[str, str]]] = None,
) -> Inventory:
    """Merge fragments (plus ad-hoc virtual sources, e.g. mutation
    overlays) into one fresh Inventory — cached fragments are never
    mutated."""
    import textwrap as _textwrap

    inv = Inventory()
    frags = list(fragments)
    for vpath, vsrc in extra_sources or ():
        try:
            vtree = ast.parse(_textwrap.dedent(vsrc), filename=vpath)
        except SyntaxError:
            continue
        frags.append(_scan_tree(vpath, vtree))
    for frag in frags:
        inv.calls.extend(frag.calls)
        inv.regs.extend(frag.regs)
        inv.handler_keys.update(frag.handler_keys)
        inv.str_literals |= frag.str_literals
        inv.wait_for_literals.extend(frag.wait_for_literals)
        inv.timeout_s_literals.extend(frag.timeout_s_literals)
    return inv


def cached_inventory(paths: List[str]) -> Inventory:
    """Tree-wide Inventory assembled from the per-file cache."""
    frags = []
    for f in _collect_files(paths):
        frag = _scan_file(f)[1]
        if frag is not None:
            frags.append(frag)
    return _merge_inventories(frags)


def build_inventory(paths: List[str]) -> Inventory:
    return cached_inventory(paths)


def _rpc_module_path() -> str:
    from ray_tpu_torch._private import rpc

    return os.path.abspath(rpc.__file__)


def check(
    paths: Optional[List[str]] = None, apply_suppressions: bool = True
) -> List[Finding]:
    paths = paths or [_default_root()]
    inv = build_inventory(paths)
    rpc_path = _rpc_module_path()

    registered = {r.method for r in inv.regs}
    called: Dict[str, List[CallSite]] = {}
    for c in inv.calls:
        # The rpc module's own wrappers (call() delegating to call_nowait())
        # pass variables, never literals, but keep the guard explicit.
        if os.path.abspath(c.path) == rpc_path:
            continue
        called.setdefault(c.method, []).append(c)

    findings: List[Finding] = []

    for method, sites in sorted(called.items()):
        if method not in registered:
            for c in sites:
                findings.append(
                    Finding(
                        c.path,
                        c.line,
                        0,
                        RULE_UNKNOWN,
                        f"RPC {c.via}({method!r}) has no registered handler "
                        "anywhere in the tree — typo or dead protocol?",
                    )
                )

    seen_reg: Set[str] = set()
    for r in sorted(inv.regs, key=lambda r: (r.path, r.line)):
        if r.method in called or r.method in seen_reg:
            continue
        if r.method in inv.str_literals:
            continue  # referenced through a wrapper indirection
        seen_reg.add(r.method)
        findings.append(
            Finding(
                r.path,
                r.line,
                0,
                RULE_ORPHAN,
                f"handler {r.method!r} is registered but no client call "
                "site names it (dead handler, or callers build the method "
                "name dynamically — suppress if so)",
            )
        )

    findings.extend(_check_payload_drift(inv))
    findings.extend(_check_magic_timeouts(inv, rpc_path))
    findings.extend(_check_trace_declared())
    findings.extend(_check_native_wire_drift())

    # Apply inline suppressions from the source files involved.
    if not apply_suppressions:
        return findings
    sup_cache: Dict[str, Dict[int, Set[str]]] = {}

    def suppressed(f: Finding) -> bool:
        if f.path not in sup_cache:
            try:
                with open(f.path, "r", encoding="utf-8") as fh:
                    sup_cache[f.path] = _suppressions(fh.read())
            except OSError:
                sup_cache[f.path] = {}
        for line in (f.line, f.line - 1):
            rules = sup_cache[f.path].get(line)
            if rules and ("all" in rules or f.rule in rules):
                return True
        return False

    return [f for f in findings if not suppressed(f)]


def _check_payload_drift(inv: Inventory) -> List[Finding]:
    from ray_tpu_torch._private import wire

    findings: List[Finding] = []
    # Producer side: literal payload dicts at call sites.
    for c in inv.calls:
        schema = wire.SCHEMAS.get(c.method)
        if schema is None or c.payload_keys is None:
            continue
        missing = schema.required - c.payload_keys
        unknown = c.payload_keys - schema.required - schema.optional
        if missing:
            findings.append(
                Finding(
                    c.path,
                    c.line,
                    0,
                    RULE_DRIFT,
                    f"{c.method} payload is missing required key(s) "
                    f"{sorted(missing)} (wire.py schema)",
                )
            )
        if unknown:
            findings.append(
                Finding(
                    c.path,
                    c.line,
                    0,
                    RULE_DRIFT,
                    f"{c.method} payload carries key(s) {sorted(unknown)} "
                    "not declared in wire.py — field-name drift, or extend "
                    "the schema",
                )
            )
    # Consumer side: key usage inside the registered handler bodies.
    for r in inv.regs:
        schema = wire.SCHEMAS.get(r.method)
        if schema is None or r.handler_name is None:
            continue
        keys = inv.handler_keys.get((r.path, r.handler_name))
        if not keys:
            continue
        unknown = keys - schema.required - schema.optional
        if unknown:
            findings.append(
                Finding(
                    r.path,
                    r.line,
                    0,
                    RULE_DRIFT,
                    f"handler for {r.method} ({r.handler_name}) reads "
                    f"payload key(s) {sorted(unknown)} not declared in "
                    "wire.py — producer/consumer drift",
                )
            )
    return findings


def _fastpath_cc_path() -> str:
    repo_root = os.path.dirname(
        os.path.dirname(os.path.dirname(_rpc_module_path()))
    )
    return os.path.join(repo_root, "src", "fastpath.cc")


def _check_native_wire_drift(cc_path: Optional[str] = None) -> List[Finding]:
    """Every natively packed schema (wire.NATIVE_WIRE_SCHEMAS) must have a
    matching ``// NATIVE_WIRE_SCHEMA: <Method> v<N> fields=...`` marker in
    src/fastpath.cc with the SAME version and field list. A Python field
    change without a C-side version bump would ship two processes that
    pack the same method differently while both believe they match — the
    runtime gate (schema_versions) only protects processes that agree on
    wire.py, so the drift must die in lint."""
    import re

    from ray_tpu_torch._private import wire

    cc = cc_path or _fastpath_cc_path()
    if not os.path.exists(cc):
        return []  # installed distribution without the C sources
    findings: List[Finding] = []
    pat = re.compile(
        r"//\s*NATIVE_WIRE_SCHEMA:\s*(\w+)\s+v(\d+)\s+fields=([\w,]*)"
    )
    markers: Dict[str, Tuple[int, Tuple[str, ...], int]] = {}
    with open(cc, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            m = pat.search(line)
            if m:
                fields = tuple(sorted(f for f in m.group(3).split(",") if f))
                markers[m.group(1)] = (int(m.group(2)), fields, lineno)
    for method, (ver, fields) in sorted(wire.NATIVE_WIRE_SCHEMAS.items()):
        marker = markers.pop(method, None)
        if marker is None:
            findings.append(
                Finding(
                    cc,
                    1,
                    0,
                    RULE_NATIVE,
                    f"natively packed schema {method} (wire.py v{ver}) has "
                    "no NATIVE_WIRE_SCHEMA marker in fastpath.cc — add the "
                    "marker (and the kWireSchemas entry) or remove the "
                    "method from NATIVE_WIRE_SCHEMAS",
                )
            )
            continue
        cc_ver, cc_fields, lineno = marker
        if tuple(sorted(fields)) != cc_fields:
            findings.append(
                Finding(
                    cc,
                    lineno,
                    0,
                    RULE_NATIVE,
                    f"{method} field list drifted: wire.py declares "
                    f"{sorted(fields)} but the fastpath.cc marker has "
                    f"{list(cc_fields)} — update the marker AND bump the "
                    "schema version on both sides",
                )
            )
        elif cc_ver != ver:
            findings.append(
                Finding(
                    cc,
                    lineno,
                    0,
                    RULE_NATIVE,
                    f"{method} schema version skew: wire.py v{ver} vs "
                    f"fastpath.cc v{cc_ver} — bump both sides together "
                    "(the runtime gate would silently fall back to the "
                    "Python packer on every process)",
                )
            )
    for method, (cc_ver, _fields, lineno) in sorted(markers.items()):
        findings.append(
            Finding(
                cc,
                lineno,
                0,
                RULE_NATIVE,
                f"fastpath.cc declares native schema {method} v{cc_ver} "
                "that wire.py does not list in NATIVE_WIRE_SCHEMAS — "
                "stale marker, or the registry entry was dropped without "
                "the C side",
            )
        )
    return findings


def _check_magic_timeouts(inv: Inventory, rpc_path: str) -> List[Finding]:
    """Numeric ``timeout=`` literals at RPC call sites in runtime code.

    Scope is ``_private/`` only (excluding rpc.py itself, whose defaults ARE
    the mechanism): that is the production control/data plane where a magic
    number silently diverges from the config budgets. Tests, devtools, and
    examples legitimately pin tiny timeouts.
    """
    findings: List[Finding] = []

    def _in_scope(path: str) -> bool:
        p = os.path.abspath(path)
        return "_private" in p.split(os.sep) and p != rpc_path

    for c in inv.calls:
        if c.timeout_literal is None or not _in_scope(c.path):
            continue
        findings.append(
            Finding(
                c.path,
                c.line,
                0,
                RULE_TIMEOUT,
                f"{c.via}({c.method!r}, ..., timeout={c.timeout_literal:g}) "
                "uses a numeric literal — take the budget from "
                "common.config (rpc_*_timeout_s) so it is tunable and "
                "consistent with deadline propagation",
            )
        )
    for path, line, t in inv.wait_for_literals:
        if t < _WAIT_FOR_BUDGET_S or not _in_scope(path):
            continue
        findings.append(
            Finding(
                path,
                line,
                0,
                RULE_TIMEOUT,
                f"asyncio.wait_for(..., {t:g}) uses a numeric literal of "
                f">= {_WAIT_FOR_BUDGET_S:g}s — that is a deadline budget; "
                "take it from common.config so it is tunable (short "
                "cleanup/grace waits are exempt)",
            )
        )

    def _serve_scope(path: str) -> bool:
        parts = os.path.abspath(path).split(os.sep)
        return "serve" in parts and "_private" in parts

    for path, line, t in inv.timeout_s_literals:
        if not _serve_scope(path):
            continue
        findings.append(
            Finding(
                path,
                line,
                0,
                RULE_TIMEOUT,
                f"timeout_s={t:g} uses a numeric literal in the serving "
                "stack — request budgets come from common.config (the "
                "serve_* knobs) so admission control and deadline "
                "propagation stay consistent",
            )
        )
    return findings


def _check_trace_declared() -> List[Finding]:
    """Every wire schema must declare trace propagation (trace=True/False).

    ``trace=None`` means nobody decided whether this method's request
    frames carry the sixth-slot trace context — new schemas must take a
    position so the committed protocol table stays complete.
    """
    from ray_tpu_torch._private import wire

    findings: List[Finding] = []
    wire_path = os.path.abspath(wire.__file__)
    try:
        with open(wire_path, "r", encoding="utf-8") as fh:
            src_lines = fh.read().splitlines()
    except OSError:
        src_lines = []

    def _line_of(method: str) -> int:
        needle = f'"{method}":'
        for i, line in enumerate(src_lines, 1):
            if needle in line:
                return i
        return 1

    for method in sorted(wire.SCHEMAS):
        if wire.SCHEMAS[method].trace is None:
            findings.append(
                Finding(
                    wire_path,
                    _line_of(method),
                    0,
                    RULE_TRACE,
                    f"wire schema {method!r} does not declare trace "
                    "propagation — set trace=True (request frames carry "
                    "the trace-context slot) or trace=False (control/"
                    "background traffic, or a kind-4 blob request whose "
                    "fifth slot is the byte length)",
                )
            )
    return findings


def markdown_table(paths: Optional[List[str]] = None) -> str:
    """The versioned wire-protocol inventory committed to docs/."""
    from ray_tpu_torch._private import wire
    from ray_tpu_torch.devtools import rpc_flow  # deferred: rpc_flow imports us

    paths = paths or [_default_root()]
    inv = build_inventory(paths)
    flow = rpc_flow.build(paths)
    root = os.path.dirname(_default_root())

    def rel(p: str) -> str:
        return os.path.relpath(p, root)

    by_method: Dict[str, Dict[str, List]] = {}
    for r in inv.regs:
        by_method.setdefault(r.method, {"regs": [], "calls": []})["regs"].append(r)
    for c in inv.calls:
        if os.path.abspath(c.path) == _rpc_module_path():
            continue
        by_method.setdefault(c.method, {"regs": [], "calls": []})["calls"].append(c)

    lines = [
        "# RPC wire-protocol inventory",
        "",
        "Generated by `python -m ray_tpu_torch.devtools.rpc_check --markdown`.",
        "Frames are msgpack `[msgid, kind, method, payload]`; requests may",
        "carry a fifth element, the remaining deadline budget (TTL) in",
        "seconds — the receiver reconstructs an absolute deadline from it,",
        "sheds already-expired calls, and hands handlers the remaining",
        "budget to pass downstream (see `ray_tpu_torch/_private/rpc.py`). Blob",
        "frames (kinds 4 and 5) put the sidecar byte length in the fifth",
        "slot instead and stream that many raw bytes after the control",
        "frame — the data plane's zero-copy path. `LeaseBatch` (kind 3,",
        "schema in `wire.py`) is a transport envelope, not a handler",
        "method: `Connection.call_batched` coalesces every request bound",
        "for one peer in the same event-loop tick into one push frame whose",
        "payload is `{entries: [[msgid, method, payload, ttl?, trace_ctx?],",
        "...]}`; the receiving read loop unpacks it and dispatches each",
        "entry exactly as if it had arrived as its own request frame, so",
        "per-entry msgids keep replies, cancellation, retry dedup, and",
        "chaos fault injection addressed to individual requests (see",
        "docs/scheduling.md \"Batched lease frames\"). Request frames may also",
        "carry a sixth element, the active trace context as",
        "`[trace_id, span_id]` — the receiver re-establishes it as the",
        "ambient span parent for the handler so runtime spans recorded on",
        "the far side join the caller's trace (see `docs/observability.md`,",
        "\"Distributed tracing\"). Schemas",
        "for the starred methods live in `ray_tpu_torch/_private/wire.py`; the",
        "lint gate fails on drift. Retry is the method's wire retry class",
        "consumed by `rpc.RetryableConnection`: `safe` = idempotent, retried",
        "freely; `dedup(key)` = retried only with the msgid-stable token;",
        "`none` = never retried. Blob is the sidecar direction: `push` =",
        "one-way kind-4 blob into a registered sink, `request` = kind-4",
        "blob the handler reads as `p[\"data\"]`, `reply` = the handler",
        "returns `rpc.Blob` and the caller's sink receives the bytes.",
        "Trace is whether request frames for the method carry the",
        "trace-context slot: ✓ = propagates (a traced caller's context",
        "rides the frame), — = control/background traffic that never",
        "joins a request trace (kind-4 blob requests cannot carry it).",
        "Deadline is the default budget the method's frames carry, derived",
        "from its call sites by `rpc_flow.deadline_sources`: `pinned (...)`",
        "= every site sends an explicit timeout/deadline (the listed",
        "sources); `ambient` = sites fold the caller's remaining budget",
        "when one is set (`_effective_deadline`), so the TTL slot is",
        "populated exactly when the caller is itself deadlined; `mixed",
        "(...)` = some sites pin a budget, others fold ambient; `never` =",
        "no site ever sends a TTL (fire-and-forget or callback vias).",
        "Errors is the schema's `errors=` declaration: the typed errors the",
        "handler can let escape as a typed error reply (reconstructed",
        "caller-side by `rpc._typed_error`; `exc_flow`'s",
        "error-wire-undeclared rule cross-checks handlers against it).",
        "Ambient machinery errors — ConnectionLost, deadline shedding — are",
        "channel facts, not per-method declarations.",
        "",
        "| Method | Schema | Retry | Blob | Trace | Deadline | Errors | Servers (handler) | Client call sites | Payload keys |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for method in sorted(by_method):
        info = by_method[method]
        schema = wire.SCHEMAS.get(method)
        servers = ", ".join(
            sorted(
                {
                    f"`{os.path.basename(r.path)}`:{r.handler_name or '?'}"
                    for r in info["regs"]
                }
            )
        ) or "—"
        nsites = len(info["calls"])
        files = sorted({os.path.basename(c.path) for c in info["calls"]})
        callers = f"{nsites} site(s) in {', '.join(files)}" if nsites else "—"
        if schema is not None:
            keys = ", ".join(
                sorted(schema.required)
                + [f"{k}?" for k in sorted(schema.optional)]
            ) or "(empty)"
            star = "★"
            if schema.retry == wire.RETRY_DEDUP:
                retry = f"dedup({schema.dedup_key})"
            else:
                retry = schema.retry
            blob = schema.blob or "—"
            trace = "✓" if schema.trace else "—"
            errors = ", ".join(f"`{e}`" for e in schema.errors) or "—"
        else:
            keys, star, retry, blob, trace, errors = "", "", "", "", "", ""
        maybe, guaranteed, srcs = rpc_flow.deadline_sources(flow, method)
        shown = ", ".join(f"`{s}`" for s in srcs[:3])
        if len(srcs) > 3:
            shown += f" +{len(srcs) - 3}"
        if not info["calls"]:
            deadline = "—"
        elif guaranteed:
            deadline = f"pinned ({shown})"
        elif maybe and srcs:
            deadline = f"mixed ({shown})"
        elif maybe:
            deadline = "ambient"
        else:
            deadline = "never"
        lines.append(
            f"| `{method}` | {star} | {retry} | {blob} | {trace} | "
            f"{deadline} | {errors} | {servers} | {callers} | {keys} |"
        )
    lines.append("")
    lines.append(
        f"{len(by_method)} methods; ★ = schema-checked "
        f"({len(wire.SCHEMAS)} declared)."
    )
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.rpc_check",
        description="RPC wire cross-checker (methods + payload schemas)",
    )
    parser.add_argument("paths", nargs="*", default=None)
    parser.add_argument(
        "--markdown",
        action="store_true",
        help="emit the method-inventory markdown table instead of checking",
    )
    args = parser.parse_args(argv)
    paths = args.paths or None
    if args.markdown:
        print(markdown_table(paths))
        return 0
    findings = check(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"rpc-check: {len(findings)} finding(s)")
        return 1
    print("rpc-check: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
