"""Control-plane protocol state machines: spec + static checker + docs.

The control plane is a bundle of small FSMs — GCS actor states, placement
groups, node liveness, the raylet's granted-lease ledger — and the chaos
runs in showed that the expensive bugs are illegal *edges*: a node
marked DEAD resurrecting, a restarted GCS persisting a bogus state, a
lease released twice. This module declares each machine as data
(:class:`Machine`: states, legal transitions, terminal states, and which
component drives each edge), and the checker statically extracts every
``<recv>.state = X`` / ``<recv>["state"] = X`` assignment in ``gcs.py`` /
``raylet.py`` / ``core_worker.py`` and verifies it against the spec.

Rules
-----
- ``protocol-unknown-state``: an assignment or comparison resolves to a
  string that is not a declared state of the receiver's machine (typo, or
  the spec is stale).
- ``protocol-illegal-transition``: an assignment that cannot be a legal
  edge — in ``__init__`` it must be an initial state; under a
  ``if recv.state == SRC`` (or ``in (SRC, ...)``) guard the edge
  ``SRC -> dst`` must be declared; unguarded, ``dst`` must be an initial
  state or have at least one declared incoming edge.
- ``protocol-unresolvable``: the assigned value is dynamic (not a literal
  or module-level constant). Restart-restore paths are the legitimate
  case; suppress them with a justification.
- ``protocol-invariant-drift``: the actor machine's quiescent states and
  ``ray_tpu_torch.chaos.invariants.TERMINAL_ACTOR_STATES`` disagree — the
  static spec and the chaos convergence invariants must never drift.

Resolution is symbolic: module-level ``NAME = "LITERAL"`` constants in the
scanned file are followed, so ``gcs.py`` keeping its states in constants
is what makes the pass precise (see the normalization in that module).
Receivers are mapped to machines by class (``self.state`` inside
``ActorInfo``), by conventional variable name (``actor``/``node``/``pg``),
or by subscript variable for wire dicts (``info["state"]``); the
``granted_lease_ids[...] = True/False`` ledger writes map booleans to the
LIVE/RELEASED states. Unmapped receivers are out of scope.

``--markdown`` regenerates ``docs/protocols.md`` (tables + mermaid
diagrams) from the same spec, so the docs cannot drift either (CI diffs
the checked-in copy).

Suppression: ``# protocol: disable=<rule>[,<rule>]`` on the flagged line
or the line directly above it.

Run: ``python -m ray_tpu_torch.devtools.protocols [--markdown] [paths]``.
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

RULE_UNKNOWN = "protocol-unknown-state"
RULE_ILLEGAL = "protocol-illegal-transition"
RULE_UNRESOLVABLE = "protocol-unresolvable"
RULE_DRIFT = "protocol-invariant-drift"

ALL_RULES = (RULE_UNKNOWN, RULE_ILLEGAL, RULE_UNRESOLVABLE, RULE_DRIFT)

_SUPPRESS_RE = re.compile(r"#\s*protocol:\s*disable=([\w\-, ]+)")


@dataclass(frozen=True)
class Machine:
    """One protocol FSM, declared as data.

    ``classes`` maps ``self.state`` assignments inside those class bodies;
    ``variables`` maps ``<name>.state`` receivers; ``subscript_vars`` maps
    ``<name>["state"]`` wire-dict receivers. ``quiescent`` is the set of
    states that may legitimately persist once the cluster has settled
    (cross-checked against the chaos invariants for the actor machine).
    ``transitions`` is ``(src, dst, driver)`` where driver names the
    component allowed to take the edge.
    """

    name: str
    doc: str
    classes: Tuple[str, ...]
    variables: Tuple[str, ...]
    subscript_vars: Tuple[str, ...]
    files: Tuple[str, ...]
    states: Tuple[str, ...]
    initial: Tuple[str, ...]
    terminal: Tuple[str, ...]
    quiescent: Tuple[str, ...]
    transitions: Tuple[Tuple[str, str, str], ...]


ACTOR = Machine(
    name="actor",
    doc="GCS actor FSM (ray_tpu_torch/_private/gcs.py, reference: "
    "gcs_actor_manager.cc)",
    classes=("ActorInfo",),
    variables=("actor", "existing", "existing_self", "a"),
    subscript_vars=("info",),
    files=("gcs.py", "core_worker.py"),
    states=("DEPENDENCIES_UNREADY", "PENDING_CREATION", "ALIVE", "RESTARTING",
            "DEAD"),
    initial=("DEPENDENCIES_UNREADY", "PENDING_CREATION"),
    terminal=("DEAD",),
    quiescent=("ALIVE", "DEAD"),
    transitions=(
        ("DEPENDENCIES_UNREADY", "PENDING_CREATION", "gcs"),
        ("DEPENDENCIES_UNREADY", "DEAD", "gcs"),
        ("PENDING_CREATION", "ALIVE", "gcs"),
        ("PENDING_CREATION", "RESTARTING", "gcs"),
        ("PENDING_CREATION", "DEAD", "gcs"),
        ("ALIVE", "RESTARTING", "gcs"),
        ("ALIVE", "DEAD", "gcs"),
        ("RESTARTING", "ALIVE", "gcs"),
        ("RESTARTING", "RESTARTING", "gcs"),
        ("RESTARTING", "DEAD", "gcs"),
    ),
)

PLACEMENT_GROUP = Machine(
    name="placement-group",
    doc="GCS placement-group FSM (ray_tpu_torch/_private/gcs.py, reference: "
    "gcs_placement_group_mgr.cc)",
    classes=("PlacementGroupInfo",),
    variables=("pg", "g"),
    subscript_vars=(),
    files=("gcs.py",),
    states=("PENDING", "CREATED", "RESCHEDULING", "REMOVED", "INFEASIBLE"),
    initial=("PENDING",),
    terminal=("REMOVED", "INFEASIBLE"),
    quiescent=("CREATED", "REMOVED", "INFEASIBLE"),
    transitions=(
        ("PENDING", "CREATED", "gcs"),
        ("PENDING", "INFEASIBLE", "gcs"),
        ("PENDING", "REMOVED", "client→gcs"),
        ("CREATED", "RESCHEDULING", "gcs (node death)"),
        ("CREATED", "REMOVED", "client→gcs"),
        ("RESCHEDULING", "CREATED", "gcs"),
        ("RESCHEDULING", "INFEASIBLE", "gcs"),
        ("RESCHEDULING", "REMOVED", "client→gcs"),
    ),
)

NODE = Machine(
    name="node",
    doc="GCS node-liveness FSM (ray_tpu_torch/_private/gcs.py, reference: "
    "gcs_node_manager.cc). Nodes never resurrect: a rejoining host "
    "registers under a fresh node id.",
    classes=("NodeInfo",),
    variables=("node", "n"),
    subscript_vars=("n", "node"),
    files=("gcs.py", "raylet.py", "core_worker.py"),
    states=("ALIVE", "DEAD"),
    initial=("ALIVE",),
    terminal=("DEAD",),
    quiescent=("ALIVE", "DEAD"),
    transitions=(("ALIVE", "DEAD", "gcs (health check / conn drop)"),),
)

LEASE_LEDGER = Machine(
    name="lease-ledger",
    doc="raylet granted-lease dedup ledger (ray_tpu_torch/_private/raylet.py): "
    "granted_lease_ids[lease_id] = True (LIVE) / False (RELEASED). "
    "Entries are evicted, never flipped back.",
    classes=(),
    variables=(),
    subscript_vars=(),
    files=("raylet.py",),
    states=("LIVE", "RELEASED"),
    initial=("LIVE", "RELEASED"),  # burn-on-arrival inserts RELEASED directly
    terminal=("RELEASED",),
    quiescent=("LIVE", "RELEASED"),
    transitions=(("LIVE", "RELEASED", "raylet"),),
)

OBJECT = Machine(
    name="object-location",
    doc="Location FSM of one primary object copy "
    "(ray_tpu_torch/_private/raylet.py store side, "
    "ray_tpu_torch/_private/core_worker.py owner side; see docs/object_plane.md). "
    "The raylet tracks the store-side states by set/dict membership "
    "(`spilling`, `spilled`, `restoring`) rather than a `.state` field, so "
    "the static extractor has no receivers to scan — this machine is "
    "enforced behaviorally: the chaos `store-settled` invariant rejects "
    "SPILLING/RESTORING after quiescence, and the spill suite's "
    "no-data-loss invariant exercises every edge, including the lost-copy "
    "paths. LOST is owner-observed (node-death pubsub or a failed "
    "restore); RECONSTRUCTING re-runs the producing TaskSpec from lineage.",
    classes=(),
    variables=(),
    subscript_vars=(),
    files=(),
    states=("LOCAL", "SPILLING", "SPILLED", "RESTORING", "LOST",
            "RECONSTRUCTING"),
    initial=("LOCAL",),
    terminal=(),
    quiescent=("LOCAL", "SPILLED", "LOST"),
    transitions=(
        ("LOCAL", "SPILLING", "raylet (pressure loop past "
         "object_spilling_threshold)"),
        ("SPILLING", "SPILLED", "raylet (external-storage write fsynced)"),
        ("SPILLING", "LOCAL", "raylet (spill aborted: freed or pinned "
         "mid-write)"),
        ("SPILLED", "RESTORING", "raylet (ObjGet miss or owner-directed "
         "RestoreSpilled)"),
        ("RESTORING", "LOCAL", "raylet (restore sealed back into the arena)"),
        ("RESTORING", "LOST", "raylet (SpillIntegrityError: torn file — "
         "copy dropped)"),
        ("LOCAL", "LOST", "owner (node-death pubsub: resident copy died)"),
        ("SPILLED", "LOST", "owner (node-death pubsub: spill namespace died "
         "with its node)"),
        ("LOST", "RECONSTRUCTING", "owner (lineage recovery re-submits the "
         "producing TaskSpec)"),
        ("RECONSTRUCTING", "LOCAL", "owner (producer re-ran; value is back)"),
        ("RECONSTRUCTING", "LOST", "owner (re-execution failed, depth cap, "
         "or lineage pruned → typed ObjectReconstructionFailedError)"),
    ),
)

MACHINES: Tuple[Machine, ...] = (
    ACTOR, PLACEMENT_GROUP, NODE, LEASE_LEDGER, OBJECT
)

# Attribute name whose subscript assignment drives the lease ledger.
_LEDGER_ATTR = "granted_lease_ids"
_BOOL_STATES = {True: "LIVE", False: "RELEASED"}


def _suppressions(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _spec_findings() -> List[Finding]:
    """Internal consistency of the spec itself (always checked)."""
    out: List[Finding] = []
    here = os.path.abspath(__file__)

    def bad(msg: str) -> None:
        out.append(Finding(here, 0, 0, RULE_ILLEGAL, f"spec error: {msg}"))

    for m in MACHINES:
        states = set(m.states)
        for group, name in ((m.initial, "initial"), (m.terminal, "terminal"),
                            (m.quiescent, "quiescent")):
            for s in group:
                if s not in states:
                    bad(f"{m.name}: {name} state {s!r} not in states")
        for src, dst, _driver in m.transitions:
            if src not in states or dst not in states:
                bad(f"{m.name}: transition {src}->{dst} uses unknown state")
            if src in m.terminal and src != dst:
                bad(f"{m.name}: terminal state {src} has outgoing edge to {dst}")
        for t in m.terminal:
            if t not in m.quiescent:
                bad(f"{m.name}: terminal state {t} missing from quiescent")
    return out


def check_invariants_sync(
    machine: Machine = ACTOR,
    invariant_states: Optional[Set[str]] = None,
) -> List[Finding]:
    """Cross-check the actor spec against the chaos convergence invariants.

    ``invariants.TERMINAL_ACTOR_STATES`` (the states chaos allows after
    quiescence) must equal the spec's quiescent set, and the spec's
    terminal states must survive quiescence — otherwise either chaos would
    flag legal end states as stuck, or the linter would bless states chaos
    rejects. Parameters exist so tests can inject drift.
    """
    import ray_tpu_torch.chaos.invariants as inv

    if invariant_states is None:
        invariant_states = set(inv.TERMINAL_ACTOR_STATES)
    path = os.path.abspath(inv.__file__)
    line = 0
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for i, text in enumerate(fh, start=1):
                if "TERMINAL_ACTOR_STATES" in text:
                    line = i
                    break
    except OSError:
        pass
    out: List[Finding] = []
    spec_states = set(machine.quiescent)
    if spec_states != invariant_states:
        out.append(
            Finding(
                path, line, 0, RULE_DRIFT,
                f"chaos TERMINAL_ACTOR_STATES {sorted(invariant_states)} != "
                f"protocol spec quiescent({machine.name}) "
                f"{sorted(spec_states)} — update whichever is stale",
            )
        )
    for s in machine.terminal:
        if s not in invariant_states:
            out.append(
                Finding(
                    path, line, 0, RULE_DRIFT,
                    f"spec terminal state {s!r} of machine {machine.name!r} "
                    f"is not accepted by chaos TERMINAL_ACTOR_STATES — "
                    f"every terminal state must survive quiescence",
                )
            )
    return out


class _FileChecker(ast.NodeVisitor):
    """Extract and verify state assignments/comparisons in one file."""

    def __init__(self, tree: ast.Module, path: str) -> None:
        self.path = path
        self.base = os.path.basename(path)
        self.findings: List[Finding] = []
        self.class_stack: List[str] = []
        self.func_stack: List[str] = []
        # (machine name, receiver repr, possible source states)
        self.guards: List[Tuple[str, str, Set[str]]] = []
        self.consts: Dict[str, str] = {}
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                self.consts[node.targets[0].id] = node.value.value

    # -- resolution ---------------------------------------------------------

    def _machines_here(self) -> List[Machine]:
        return [m for m in MACHINES if self.base in m.files]

    def _state_expr(self, node: ast.AST) -> Optional[Tuple[Machine, str]]:
        """(machine, receiver repr) if ``node`` reads/writes a machine's
        state — ``recv.state``, ``recv["state"]``, or the ledger subscript."""
        if isinstance(node, ast.Attribute) and node.attr == "state":
            recv = node.value
            if isinstance(recv, ast.Name):
                for m in self._machines_here():
                    if recv.id == "self":
                        if self.class_stack and self.class_stack[-1] in m.classes:
                            return m, "self.state"
                    elif recv.id in m.variables:
                        return m, f"{recv.id}.state"
            return None
        if isinstance(node, ast.Subscript):
            key = node.slice
            if isinstance(key, ast.Constant) and key.value == "state":
                if isinstance(node.value, ast.Name):
                    for m in self._machines_here():
                        if node.value.id in m.subscript_vars:
                            return m, f'{node.value.id}["state"]'
            recv = _dotted(node.value)
            if recv and recv.rsplit(".", 1)[-1] == _LEDGER_ATTR:
                if self.base in LEASE_LEDGER.files:
                    return LEASE_LEDGER, f"{recv}[...]"
            return None
        return None

    def _resolve(self, node: ast.AST, machine: Machine) -> Tuple[Optional[str], bool]:
        """(state string or None, resolvable) for an assigned/compared value."""
        if isinstance(node, ast.Constant):
            if machine is LEASE_LEDGER and isinstance(node.value, bool):
                return _BOOL_STATES[node.value], True
            if isinstance(node.value, str):
                return node.value, True
            return None, False
        if isinstance(node, ast.Name) and node.id in self.consts:
            return self.consts[node.id], True
        return None, False

    # -- structure tracking -------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _guard_from_test(self, test: ast.AST) -> Optional[Tuple[str, str, Set[str]]]:
        """A state guard in an if/while test: ``recv.state == SRC`` or
        ``recv.state in (SRC, ...)`` — possibly one conjunct of an ``and``."""
        tests = test.values if isinstance(test, ast.BoolOp) and isinstance(
            test.op, ast.And) else [test]
        for t in tests:
            if not (isinstance(t, ast.Compare) and len(t.ops) == 1):
                continue
            se = self._state_expr(t.left)
            if se is None:
                continue
            machine, recv = se
            op = t.ops[0]
            comparator = t.comparators[0]
            if isinstance(op, ast.Eq):
                val, ok = self._resolve(comparator, machine)
                if ok and val in machine.states:
                    return machine.name, recv, {val}
            elif isinstance(op, ast.In) and isinstance(
                comparator, (ast.Tuple, ast.List, ast.Set)
            ):
                vals = set()
                for elt in comparator.elts:
                    val, ok = self._resolve(elt, machine)
                    if not ok:
                        break
                    vals.add(val)
                else:
                    if vals and vals <= set(machine.states):
                        return machine.name, recv, vals
        return None

    def _visit_guarded(self, node) -> None:
        self.visit(node.test)
        guard = self._guard_from_test(node.test)
        if guard is not None:
            self.guards.append(guard)
        for stmt in node.body:
            self.visit(stmt)
        if guard is not None:
            self.guards.pop()
        for stmt in node.orelse:
            self.visit(stmt)

    visit_If = _visit_guarded
    visit_While = _visit_guarded

    # -- the checks ---------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0),
                    getattr(node, "col_offset", 0), rule, msg)
        )

    def _check_assign(self, target: ast.AST, value: ast.AST,
                      node: ast.stmt) -> None:
        se = self._state_expr(target)
        if se is None:
            return
        machine, recv = se
        dst, ok = self._resolve(value, machine)
        if not ok:
            self._emit(
                node, RULE_UNRESOLVABLE,
                f"{recv} assigned a dynamic value — the {machine.name} "
                f"machine cannot verify this edge statically; use a "
                f"declared state constant or suppress with justification",
            )
            return
        if dst not in machine.states:
            self._emit(
                node, RULE_UNKNOWN,
                f"{recv} assigned {dst!r}, not a state of the "
                f"{machine.name} machine {list(machine.states)}",
            )
            return
        edges = {(s, d) for s, d, _ in machine.transitions}
        if (
            self.func_stack
            and self.func_stack[-1] == "__init__"
            and recv == "self.state"
        ):
            if dst not in machine.initial:
                self._emit(
                    node, RULE_ILLEGAL,
                    f"__init__ sets {recv} to {dst!r}, not an initial "
                    f"state of the {machine.name} machine "
                    f"{list(machine.initial)}",
                )
            return
        for g_machine, g_recv, sources in reversed(self.guards):
            if g_machine != machine.name or g_recv != recv:
                continue
            if dst in sources:
                return  # self-loop under the guard
            if not any((src, dst) in edges for src in sources):
                self._emit(
                    node, RULE_ILLEGAL,
                    f"{recv} set to {dst!r} under a guard proving state in "
                    f"{sorted(sources)}, but no transition "
                    f"{sorted(sources)}→{dst} is declared for the "
                    f"{machine.name} machine",
                )
            return
        # Unguarded: the edge source is unknown, so require that *some*
        # declared edge (or initial marking) can reach dst.
        if dst not in machine.initial and not any(d == dst for _, d in edges):
            self._emit(
                node, RULE_ILLEGAL,
                f"{recv} set to {dst!r}, but the {machine.name} machine "
                f"declares no transition into {dst!r} and it is not an "
                f"initial state",
            )

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_assign(target, node.value, node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if len(node.ops) == 1:
            se = self._state_expr(node.left)
            if se is not None:
                machine, recv = se
                comparator = node.comparators[0]
                elts = (
                    comparator.elts
                    if isinstance(node.ops[0], (ast.In, ast.NotIn))
                    and isinstance(comparator, (ast.Tuple, ast.List, ast.Set))
                    else [comparator]
                )
                for elt in elts:
                    val, ok = self._resolve(elt, machine)
                    if ok and val not in machine.states:
                        self._emit(
                            node, RULE_UNKNOWN,
                            f"{recv} compared against {val!r}, not a state "
                            f"of the {machine.name} machine "
                            f"{list(machine.states)}",
                        )
        self.generic_visit(node)


_SCANNED_BASENAMES = {b for m in MACHINES for b in m.files}


def check_source(
    source: str, path: str, apply_suppressions: bool = True
) -> List[Finding]:
    """Check one file's source; only files named like a scanned module
    (gcs.py / raylet.py / core_worker.py) produce findings."""
    if os.path.basename(path) not in _SCANNED_BASENAMES:
        return []
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, 0, "parse-error", str(e.msg))]
    checker = _FileChecker(tree, path)
    checker.visit(tree)
    sup = _suppressions(source) if apply_suppressions else {}

    def suppressed(f: Finding) -> bool:
        for line in (f.line, f.line - 1):
            rules = sup.get(line)
            if rules and ("all" in rules or f.rule in rules):
                return True
        return False

    return sorted(
        (f for f in checker.findings if not suppressed(f)),
        key=lambda f: (f.line, f.col, f.rule),
    )


def check_file(path: str, apply_suppressions: bool = True) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return check_source(fh.read(), path, apply_suppressions=apply_suppressions)


def check(
    paths: Optional[Iterable[str]] = None, apply_suppressions: bool = True
) -> List[Finding]:
    """Full pass: spec validation + file extraction + invariants sync."""
    paths = list(paths) if paths else [_default_root()]
    findings = _spec_findings()
    for path in paths:
        if os.path.isdir(path):
            for f in iter_py_files(path):
                findings.extend(check_file(f, apply_suppressions=apply_suppressions))
        else:
            findings.extend(check_file(path, apply_suppressions=apply_suppressions))
    try:
        findings.extend(check_invariants_sync())
    except ImportError:
        pass  # chaos subsystem not importable in this environment
    return findings


# -- documentation ----------------------------------------------------------


def markdown() -> str:
    """Render docs/protocols.md from the spec (deterministic)."""
    lines: List[str] = [
        "# Control-plane protocol state machines",
        "",
        "Generated from `ray_tpu_torch/devtools/protocols.py` — do not edit by",
        "hand; run `make protocols` after changing the spec. The same spec",
        "drives the static checker (`python -m ray_tpu_torch.devtools.protocols`,",
        "part of the `make lint` gate), so these tables are, by",
        "construction, what the linter enforces.",
        "",
    ]
    for m in MACHINES:
        lines += [f"## {m.name}", "", m.doc, ""]
        lines += [
            "| state | initial | terminal | quiescent |",
            "|---|---|---|---|",
        ]
        for s in m.states:
            lines.append(
                "| `{}` | {} | {} | {} |".format(
                    s,
                    "✓" if s in m.initial else "",
                    "✓" if s in m.terminal else "",
                    "✓" if s in m.quiescent else "",
                )
            )
        lines += [
            "",
            "| from | to | driven by |",
            "|---|---|---|",
        ]
        for src, dst, driver in m.transitions:
            lines.append(f"| `{src}` | `{dst}` | {driver} |")
        lines += ["", "```mermaid", "stateDiagram-v2"]
        for s in m.initial:
            lines.append(f"    [*] --> {s}")
        for src, dst, driver in m.transitions:
            lines.append(f"    {src} --> {dst}")
        for s in m.terminal:
            lines.append(f"    {s} --> [*]")
        lines += ["```", ""]
    lines += [
        "## Cross-checks",
        "",
        "- The actor machine's quiescent set must equal",
        "  `ray_tpu_torch.chaos.invariants.TERMINAL_ACTOR_STATES` (the states the",
        "  chaos suite accepts after convergence); the checker fails with",
        "  `protocol-invariant-drift` if they diverge.",
        "- Every `.state = X` / `[\"state\"] = X` assignment in `gcs.py`,",
        "  `raylet.py`, and `core_worker.py` is verified against these",
        "  tables at lint time; dynamic assignments (restart restore paths)",
        "  carry `# protocol: disable=protocol-unresolvable` suppressions.",
        "",
    ]
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.protocols",
        description="protocol FSM checker (see module docstring for rules)",
    )
    parser.add_argument("paths", nargs="*", default=None)
    parser.add_argument(
        "--markdown",
        action="store_true",
        help="print docs/protocols.md content instead of checking",
    )
    args = parser.parse_args(argv)
    if args.markdown:
        sys.stdout.write(markdown())
        return 0
    findings = check(args.paths or None)
    for f in findings:
        print(f)
    if findings:
        print(f"protocols: {len(findings)} finding(s)")
        return 1
    print("protocols: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
