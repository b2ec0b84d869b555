"""Deterministic seeded fault schedules.

A schedule is derived entirely from ``(seed, specs)`` at construction time:
for every :class:`FaultSpec` a dedicated ``random.Random`` (seeded from a
stable SHA-256 derivation — never the salted builtin ``hash``) pre-computes a
finite decision stream indexed by *match number*. The runtime interceptor
only ever consumes decisions by match index, so the planned fault sequence is
a pure function of the seed: replaying a seed replays byte-identical faults
against the same traffic, and ``to_bytes()`` of two schedules built from the
same seed compare equal (the CI determinism gate).

Jepsen's nemesis schedules inspired the shape; the determinism requirement
(seed -> identical fault sequence -> replayable failure) comes from this
repo's convergence story: a failing seed lands in the replay corpus and any
future PR can re-run exactly that fault sequence against the runtime.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("drop", "delay", "dup", "reorder")
FRAME_CLASSES = ("request", "reply", "push", "any")

# How many matches per spec get a pre-computed decision. Matches past the
# horizon flow through un-faulted — a bounded plan keeps serialization small
# and makes "the schedule" a finite, comparable artifact.
DEFAULT_HORIZON = 2048


def stable_u64(text: str) -> int:
    """Deterministic 64-bit digest of a string (process- and run-stable,
    unlike builtin ``hash`` which is salted per interpreter)."""
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "big")


@dataclass(frozen=True)
class FaultSpec:
    """One fault rule: which frames it matches and what it may do to them.

    ``method`` is an ``fnmatch`` pattern over RPC method names ("PushChunk",
    "Request*"). ``frame`` narrows by frame class: request / reply (normal +
    error replies) / push (one-way) / any. ``p`` is the per-match fire
    probability; ``start_after`` exempts the first N matches so bring-up
    traffic is never faulted; ``max_fires`` caps total fires (< 0: unbounded).
    """

    name: str
    kind: str  # drop | delay | dup | reorder
    method: str
    frame: str = "any"
    p: float = 1.0
    delay_s: Tuple[float, float] = (0.01, 0.05)
    start_after: int = 0
    max_fires: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.frame not in FRAME_CLASSES:
            raise ValueError(f"unknown frame class {self.frame!r}")

    def to_wire(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "method": self.method,
            "frame": self.frame,
            "p": self.p,
            "delay_s": list(self.delay_s),
            "start_after": self.start_after,
            "max_fires": self.max_fires,
        }


# A decision is None (let the frame through) or a tuple ("drop",) /
# ("delay", seconds) / ("dup",) / ("reorder",).
Decision = Optional[Tuple]


class FaultSchedule:
    """Seed-deterministic plan: spec name -> decision per match index."""

    def __init__(
        self,
        seed: int,
        specs: Sequence[FaultSpec],
        horizon: int = DEFAULT_HORIZON,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate spec names in {names}")
        self.seed = int(seed)
        self.specs: List[FaultSpec] = list(specs)
        self.horizon = int(horizon)
        self.decisions: Dict[str, List[Decision]] = {
            spec.name: self._plan_spec(spec) for spec in self.specs
        }

    def _plan_spec(self, spec: FaultSpec) -> List[Decision]:
        import random

        rng = random.Random(stable_u64(f"{self.seed}:{spec.name}"))
        plan: List[Decision] = []
        fires = 0
        for i in range(self.horizon):
            if i < spec.start_after:
                plan.append(None)
                continue
            roll = rng.random()
            capped = 0 <= spec.max_fires <= fires
            if capped or roll >= spec.p:
                plan.append(None)
                continue
            fires += 1
            if spec.kind == "delay":
                lo, hi = spec.delay_s
                # Round so the serialized schedule is float-stable.
                plan.append(("delay", round(rng.uniform(lo, hi), 6)))
            else:
                plan.append((spec.kind,))
        return plan

    def decision(self, spec_name: str, match_index: int) -> Decision:
        plan = self.decisions[spec_name]
        if match_index >= len(plan):
            return None
        return plan[match_index]

    def to_wire(self) -> dict:
        return {
            "seed": self.seed,
            "horizon": self.horizon,
            "specs": [s.to_wire() for s in self.specs],
            "decisions": {
                name: [list(d) if d is not None else None for d in plan]
                for name, plan in self.decisions.items()
            },
        }

    def to_bytes(self) -> bytes:
        """Canonical serialization; byte-identical for identical seeds."""
        return json.dumps(
            self.to_wire(), sort_keys=True, separators=(",", ":")
        ).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()


@dataclass
class FaultEvent:
    """One fault that actually fired at runtime."""

    spec: str
    match_index: int
    action: Tuple
    method: str
    kind: int  # wire frame kind (0 req / 1 rep / 2 err / 3 push)

    def to_wire(self) -> dict:
        return {
            "spec": self.spec,
            "match_index": self.match_index,
            "action": list(self.action),
            "method": self.method,
            "kind": self.kind,
        }


@dataclass
class FaultLog:
    """Append-only record of fired faults; the runtime half of the replay
    story (the schedule is the planned half)."""

    events: List[FaultEvent] = field(default_factory=list)

    def record(self, event: FaultEvent) -> None:
        self.events.append(event)

    def count(self, spec: Optional[str] = None) -> int:
        if spec is None:
            return len(self.events)
        return sum(1 for e in self.events if e.spec == spec)

    def to_wire(self) -> list:
        return [e.to_wire() for e in self.events]

    def to_bytes(self) -> bytes:
        return json.dumps(self.to_wire(), separators=(",", ":")).encode()

    def digest(self) -> str:
        return hashlib.sha256(self.to_bytes()).hexdigest()


class NemesisPlan:
    """Seed-deterministic plan for process-level fault actions.

    For a workload of ``steps`` checkpoints, decides at which step indices
    each nemesis action fires and pre-draws the integer used for victim
    selection (index modulo candidate count at fire time, over a sorted
    candidate list — the pick is deterministic whenever cluster membership
    at the fire point is, which a deterministic schedule arranges).
    """

    def __init__(self, seed: int, actions: Sequence[str], steps: int):
        import random

        self.seed = int(seed)
        self.actions = list(actions)
        self.steps = int(steps)
        self.points: List[Tuple[int, str, int]] = []  # (step, action, pick)
        for action in self.actions:
            rng = random.Random(stable_u64(f"{seed}:nemesis:{action}"))
            # One fire per action per run, never at step 0 (let the workload
            # establish state worth destroying first).
            step = rng.randrange(1, max(2, self.steps))
            self.points.append((step, action, rng.randrange(1 << 30)))
        self.points.sort(key=lambda t: (t[0], t[1]))

    def at_step(self, step: int) -> List[Tuple[str, int]]:
        return [(a, pick) for (s, a, pick) in self.points if s == step]

    def to_wire(self) -> dict:
        return {
            "seed": self.seed,
            "steps": self.steps,
            "points": [list(p) for p in self.points],
        }
