"""Exhaustive interleaving explorer for the asyncio control plane.

Randomized chaos (``ray_tpu_torch.chaos``) samples schedules; this module
*enumerates* them.  It virtualizes the asyncio event loop so that every
ready-callback wakeup and timer fire is an explicit *choice point*, then
drives a depth-first search over the schedule tree:

- ``VirtualLoop``: an ``asyncio.BaseEventLoop`` subclass with no selector,
  no self-pipe and no wall clock.  ``call_soon``/``call_at`` park labeled
  events in explorer-owned queues; ``time()`` reads a virtual clock that
  only advances when nothing runnable remains.  Every event gets a
  deterministic key ``<qualname>#<n>`` (task wakeups are labeled by the
  task's coroutine qualname), so a schedule is just a list of keys.
- ``Explorer``: sleep-set pruned DFS (Godefroid-style; the DPOR flavour
  where commuting independent wakeups are explored once).  Independence
  comes from the static ``aio_lint`` shared-attribute footprints: two
  events commute iff their code's read/write sets on shared containers are
  disjoint.  Unknown or same-qualname events are conservatively dependent.
  ``--naive`` disables pruning for A/B comparison.
- Replay: any schedule (in particular a violating one) serializes to a
  JSON choice trace and replays byte-identically; divergence between the
  recorded enabled sets and a replay is itself reported as a determinism
  failure.  Traces for regression tests live under ``tests/schedules/``.
- Crash-point enumeration (``crash_scan_wal`` / ``crash_scan_replicated``):
  run a store workload once, snapshot the table state at every
  group-commit boundary, then for each commit reopen the log truncated at
  that boundary (plus a torn-tail variant) and prove recovery lands
  exactly on the acknowledged prefix.

Scenarios are registered in ``ray_tpu_torch.chaos.scenarios_explore`` and share
the chaos invariant checks.  CLI::

    python -m ray_tpu_torch.devtools.explore --list
    python -m ray_tpu_torch.devtools.explore --scenario all --budget 20000
    python -m ray_tpu_torch.devtools.explore --scenario lease_exactly_once \
        --mutate double_grant --expect-violation --save-trace /tmp/t.json
    python -m ray_tpu_torch.devtools.explore --replay tests/schedules/x.json
    python -m ray_tpu_torch.devtools.explore --crash-points

The footprint approximation is intentionally conservative but not
transitively complete across classes (see docs/static_analysis.md); the
``--naive`` mode is the ground truth the DPOR mode is tested against.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import hashlib
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

TRACE_FORMAT = 1


class ExploreError(Exception):
    """Engine-level failure (divergence, deadlock, budget exhaustion)."""


class NondeterminismError(ExploreError):
    """A replayed prefix produced a different enabled set."""


class DeadlockError(ExploreError):
    """No runnable event and no pending timer, but the root task is live."""


# ---------------------------------------------------------------------------
# Virtual event loop
# ---------------------------------------------------------------------------


class _Event:
    """One schedulable unit: a parked ``Handle`` plus its stable label."""

    __slots__ = ("key", "handle", "when", "seq")

    def __init__(self, key: str, handle: asyncio.Handle, when: Optional[float], seq: int):
        self.key = key
        self.handle = handle
        self.when = when  # None for ready callbacks, virtual time for timers
        self.seq = seq

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<_Event {self.key} when={self.when}>"


def _callback_qualname(cb: Any) -> str:
    """Deterministic label for a loop callback (no memory addresses)."""
    while isinstance(cb, functools.partial):
        cb = cb.func
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        coro = owner.get_coro()
        qual = getattr(coro, "__qualname__", None) or type(coro).__name__
        return f"task:{qual}"
    qual = getattr(cb, "__qualname__", None)
    if qual is None:
        qual = type(cb).__name__
    return f"cb:{qual}"


#: Callback labels that are pure container bookkeeping — they neither read
#: protocol state nor unblock any coroutine, so their placement in the
#: schedule is unobservable.  The loop dispatches them eagerly instead of
#: offering them as choice points (``set.discard``/``set.add`` come from
#: task-registry done-callbacks such as ``rpc._BG_TASKS.discard``).
_BOOKKEEPING_LABELS = ("cb:set.discard#", "cb:set.add#")


def _is_bookkeeping(key: str) -> bool:
    return key.startswith(_BOOKKEEPING_LABELS)


class VirtualLoop(asyncio.BaseEventLoop):
    """A fully controlled event loop: nothing runs until the explorer says so.

    ``BaseEventLoop`` (not ``SelectorEventLoop``) on purpose: the selector
    flavour allocates a selector plus a self-pipe socketpair per instance,
    and the explorer constructs thousands of loops per enumeration.  This
    subclass opens no file descriptors at all.
    """

    def __init__(self) -> None:
        super().__init__()
        self._vclock = 0.0
        self._seq = 0
        self._label_counts: Dict[str, int] = {}
        self._ready_events: List[_Event] = []
        self._timer_events: List[_Event] = []
        self.exceptions: List[BaseException] = []

    # -- event capture ------------------------------------------------------

    def _park(self, handle: asyncio.Handle, cb: Any, when: Optional[float]) -> None:
        label = _callback_qualname(cb)
        n = self._label_counts.get(label, 0)
        self._label_counts[label] = n + 1
        self._seq += 1
        ev = _Event(f"{label}#{n}", handle, when, self._seq)
        if when is None:
            self._ready_events.append(ev)
        else:
            self._timer_events.append(ev)

    def call_soon(self, callback, *args, context=None):
        handle = asyncio.Handle(callback, args, self, context)
        self._park(handle, callback, None)
        return handle

    def call_soon_threadsafe(self, callback, *args, context=None):
        return self.call_soon(callback, *args, context=context)

    def call_later(self, delay, callback, *args, context=None):
        return self.call_at(self._vclock + max(0.0, delay), callback, *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        handle = asyncio.TimerHandle(when, callback, args, self, context)
        self._park(handle, callback, when)
        return handle

    def time(self) -> float:
        return self._vclock

    # BaseEventLoop's _timer_handle_cancelled only bookkeeps handles it
    # scheduled itself (``_scheduled`` flag); ours never set it, so the
    # inherited no-op behaviour is correct.

    # -- scheduling surface consumed by the explorer ------------------------

    def enabled_events(self) -> List[_Event]:
        """Runnable events, deterministic order: ready FIFO then due timers."""
        self._ready_events = [e for e in self._ready_events if not e.handle._cancelled]
        self._timer_events = [e for e in self._timer_events if not e.handle._cancelled]
        due = [e for e in self._timer_events if e.when <= self._vclock + 1e-9]
        due.sort(key=lambda e: (e.when, e.seq))
        return self._ready_events + due

    def advance_clock(self) -> bool:
        """Jump to the next timer deadline; False if no timers pending."""
        self._timer_events = [e for e in self._timer_events if not e.handle._cancelled]
        if not self._timer_events:
            return False
        self._vclock = min(e.when for e in self._timer_events)
        return True

    def dispatch(self, ev: _Event) -> None:
        try:
            self._ready_events.remove(ev)
        except ValueError:
            self._timer_events.remove(ev)
        if not ev.handle._cancelled:
            ev.handle._run()

    def call_exception_handler(self, context) -> None:
        exc = context.get("exception")
        if exc is not None:
            self.exceptions.append(exc)

    # -- drive / drain ------------------------------------------------------

    def drive(self, coro, chooser: Callable[[List[_Event]], _Event], max_steps: int) -> Any:
        """Run ``coro`` to completion, delegating every choice to ``chooser``.

        Returns the coroutine's result; raises its exception; raises
        ``DeadlockError``/``ExploreError`` on stuck or over-budget runs.
        """
        asyncio.events._set_running_loop(self)
        try:
            root = asyncio.tasks.Task(coro, loop=self)
            try:
                steps = 0
                while not root.done():
                    enabled = self.enabled_events()
                    auto = next(
                        (e for e in enabled if _is_bookkeeping(e.key)), None
                    )
                    if auto is not None:
                        # GC-registry bookkeeping (task done-callbacks like
                        # rpc._BG_TASKS.discard) commutes with every protocol
                        # transition: running it eagerly collapses a
                        # factorial blowup without hiding any interleaving.
                        self.dispatch(auto)
                        continue
                    if not enabled:
                        if self.advance_clock():
                            continue
                        raise DeadlockError(
                            "no runnable events and no pending timers but "
                            "the scenario has not finished"
                        )
                    steps += 1
                    if steps > max_steps:
                        raise ExploreError(
                            f"schedule exceeded max_steps={max_steps}"
                        )
                    self.dispatch(chooser(enabled))
            except BaseException:
                # Consume the root coroutine (and any tasks it spawned) so
                # abandoned schedules don't leak never-awaited coroutines.
                root.cancel()
                self._shutdown()
                raise
            self._shutdown()
            return root.result()
        finally:
            asyncio.events._set_running_loop(None)

    def _shutdown(self) -> None:
        """Cancel abandoned background tasks and drain their wakeups."""
        for task in asyncio.tasks.all_tasks(self):
            if not task.done():
                task.cancel()
        self._drain_fifo()
        self._timer_events = []

    def _drain_fifo(self, rounds: int = 64) -> None:
        for _ in range(rounds):
            self._ready_events = [
                e for e in self._ready_events if not e.handle._cancelled
            ]
            if not self._ready_events:
                break
            batch, self._ready_events = self._ready_events, []
            for ev in batch:
                if not ev.handle._cancelled:
                    ev.handle._run()


# ---------------------------------------------------------------------------
# Independence oracle (static aio_lint footprints)
# ---------------------------------------------------------------------------


class IndependenceOracle:
    """Decide whether two events commute, from static read/write footprints.

    ``footprints`` maps a function qualname (``Cls.method`` or module-level
    name) to ``{"reads": set, "writes": set}`` over shared-container keys.
    Missing qualnames and identical qualnames are conservatively dependent.
    """

    def __init__(self, footprints: Dict[str, Dict[str, Set[str]]]):
        self.footprints = footprints

    @staticmethod
    def qual_of(key: str) -> str:
        label = key.rsplit("#", 1)[0]
        return label.split(":", 1)[1] if ":" in label else label

    def independent(self, key_a: str, key_b: str) -> bool:
        qa, qb = self.qual_of(key_a), self.qual_of(key_b)
        if qa == qb:
            return False
        fa = self.footprints.get(qa)
        fb = self.footprints.get(qb)
        if fa is None or fb is None:
            return False
        if fa["writes"] & (fb["reads"] | fb["writes"]):
            return False
        if fb["writes"] & fa["reads"]:
            return False
        return True


_REPO_FOOTPRINTS: Optional[Dict[str, Dict[str, Set[str]]]] = None


def repo_footprints() -> Dict[str, Dict[str, Set[str]]]:
    """Shared-attribute footprints for the whole package (cached)."""
    global _REPO_FOOTPRINTS
    if _REPO_FOOTPRINTS is None:
        from ray_tpu_torch.devtools import aio_lint

        _REPO_FOOTPRINTS = aio_lint.extract_footprints([aio_lint._default_root()])
    return _REPO_FOOTPRINTS


# ---------------------------------------------------------------------------
# Sleep-set DFS explorer
# ---------------------------------------------------------------------------


@dataclass
class _Frame:
    enabled: List[str]
    chosen: str = ""
    tried: Set[str] = field(default_factory=set)
    sleep: Set[str] = field(default_factory=set)


@dataclass
class RunRecord:
    status: str  # "ok" | "violation" | "pruned"
    choices: List[str]
    violations: List[str]


@dataclass
class ExploreReport:
    scenario: str
    schedules: int = 0
    pruned: int = 0
    violations: int = 0
    complete: bool = False
    stopped_on_violation: bool = False
    first_violation: Optional[RunRecord] = None
    digest: str = ""

    def summary(self) -> str:
        if self.complete:
            state = "exhausted"
        elif self.stopped_on_violation:
            state = "stopped at first violation"
        else:
            state = "BUDGET EXCEEDED"
        return (
            f"{self.scenario}: {self.schedules} schedules ({state}), "
            f"{self.pruned} pruned, {self.violations} violation(s), "
            f"digest {self.digest[:16]}"
        )


class _PruneRun(Exception):
    """Internal: every enabled event at this node is in the sleep set."""


class Explorer:
    """Depth-first schedule enumeration with sleep-set pruning.

    ``scenario_factory`` builds a fresh scenario instance per run; the
    instance exposes ``async run() -> List[str]`` (violation strings) and a
    sync ``cleanup()``.  Each run replays the choice prefix on the frame
    stack and extends it with the default policy (first enabled event not
    in the node's sleep set); backtracking forces the next untried
    candidate at the deepest incomplete frame.
    """

    def __init__(
        self,
        scenario_factory: Callable[[], Any],
        oracle: Optional[IndependenceOracle] = None,
        dpor: bool = True,
        max_steps: int = 5000,
    ):
        self.scenario_factory = scenario_factory
        self.oracle = oracle
        self.dpor = dpor and oracle is not None
        self.max_steps = max_steps
        self.stack: List[_Frame] = []
        self._redo_depth: Optional[int] = None
        self._redo_choice: Optional[str] = None
        self._hash = hashlib.sha256()

    def _run_once(self) -> RunRecord:
        loop = VirtualLoop()
        inst = self.scenario_factory()
        depth = 0  # index into the branching-frame stack, not the step count
        cur_sleep: Set[str] = set()
        choices: List[str] = []
        pruned = False

        def wake(sleep: Set[str], executed: str) -> Set[str]:
            """Executing a transition wakes every dependent slept event."""
            if not sleep or not self.dpor:
                return set()
            assert self.oracle is not None
            return {x for x in sleep if self.oracle.independent(x, executed)}

        def chooser(enabled: List[_Event]) -> _Event:
            nonlocal depth, cur_sleep
            keys = [e.key for e in enabled]
            if all(k in cur_sleep for k in keys):
                # Every continuation is slept: this whole subtree is
                # equivalent to one explored elsewhere.
                raise _PruneRun()
            if len(enabled) == 1:
                # Forced move, not a choice point: no frame, but it still
                # wakes dependent slept events.
                ev = enabled[0]
                cur_sleep = wake(cur_sleep, ev.key)
                choices.append(ev.key)
                return ev
            if depth < len(self.stack):
                frame = self.stack[depth]
                if frame.enabled != keys:
                    raise NondeterminismError(
                        f"replay divergence at branch {depth}: recorded "
                        f"{frame.enabled} vs observed {keys}"
                    )
                if depth == self._redo_depth:
                    assert self._redo_choice is not None
                    frame.chosen = self._redo_choice
                    frame.tried.add(self._redo_choice)
                cur_sleep = set(frame.sleep)
            else:
                frame = _Frame(enabled=keys, sleep=set(cur_sleep))
                candidates = [k for k in keys if k not in frame.sleep]
                frame.chosen = candidates[0]
                frame.tried.add(frame.chosen)
                self.stack.append(frame)
            depth += 1
            cur_sleep = wake(
                (frame.sleep | frame.tried) - {frame.chosen}, frame.chosen
            )
            choices.append(frame.chosen)
            for ev in enabled:
                if ev.key == frame.chosen:
                    return ev
            raise NondeterminismError(
                f"recorded choice {frame.chosen!r} not enabled at branch "
                f"{depth - 1}: {keys}"
            )

        try:
            violations = loop.drive(inst.run(), chooser, self.max_steps)
        except _PruneRun:
            pruned = True
            violations = []
        except (asyncio.CancelledError, DeadlockError) as exc:
            if isinstance(exc, DeadlockError):
                violations = [f"deadlock: {exc}"]
            else:
                violations = ["scenario cancelled unexpectedly"]
        except ExploreError:
            raise
        except BaseException as exc:  # scenario bug is a finding, not a crash
            violations = [f"exception: {type(exc).__name__}: {exc}"]
        finally:
            try:
                inst.cleanup()
            finally:
                loop.close()
        if not pruned:
            for exc in loop.exceptions:
                violations.append(
                    f"background exception: {type(exc).__name__}: {exc}"
                )
        status = "pruned" if pruned else ("violation" if violations else "ok")
        return RunRecord(status=status, choices=choices, violations=violations)

    def explore(
        self,
        name: str,
        budget: int = 50000,
        stop_on_violation: bool = False,
    ) -> ExploreReport:
        report = ExploreReport(scenario=name)
        runs = 0
        while True:
            if runs >= budget:
                report.complete = False
                break
            runs += 1
            rec = self._run_once()
            self._redo_depth = self._redo_choice = None
            self._hash.update(
                ("|".join(rec.choices) + "::" + rec.status).encode()
            )
            if rec.status == "pruned":
                report.pruned += 1
            else:
                report.schedules += 1
                if rec.status == "violation":
                    report.violations += 1
                    if report.first_violation is None:
                        report.first_violation = rec
                    if stop_on_violation:
                        # Mutation-gate mode: the first witness schedule is
                        # the deliverable; the rest of the space is moot.
                        report.complete = False
                        report.stopped_on_violation = True
                        break
            # Backtrack to the deepest frame with an untried, unslept branch.
            redo: Optional[Tuple[int, str]] = None
            while self.stack:
                f = self.stack[-1]
                cands = [
                    k for k in f.enabled if k not in f.tried and k not in f.sleep
                ]
                if cands:
                    redo = (len(self.stack) - 1, cands[0])
                    break
                self.stack.pop()
            if redo is None:
                report.complete = True
                break
            self._redo_depth, self._redo_choice = redo
        report.digest = self._hash.hexdigest()
        return report


# ---------------------------------------------------------------------------
# Trace replay
# ---------------------------------------------------------------------------


def save_trace(path: str, scenario: str, rec: RunRecord, mutations: Sequence[str]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {
                "format": TRACE_FORMAT,
                "scenario": scenario,
                "mutations": list(mutations),
                "status": rec.status,
                "violations": rec.violations,
                "trace": rec.choices,
            },
            fh,
            indent=2,
        )
        fh.write("\n")


def load_trace(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("format") != TRACE_FORMAT:
        raise ExploreError(f"unsupported trace format in {path}: {data.get('format')}")
    return data


def replay(scenario_factory: Callable[[], Any], trace: Sequence[str], max_steps: int = 5000) -> RunRecord:
    """Re-execute one schedule from its serialized choice list."""
    loop = VirtualLoop()
    inst = scenario_factory()
    cursor = 0
    choices: List[str] = []

    def chooser(enabled: List[_Event]) -> _Event:
        nonlocal cursor
        if cursor >= len(trace):
            raise NondeterminismError(
                f"trace exhausted after {cursor} choices but scenario still "
                f"runnable (enabled: {[e.key for e in enabled]})"
            )
        want = trace[cursor]
        cursor += 1
        for ev in enabled:
            if ev.key == want:
                choices.append(want)
                return ev
        raise NondeterminismError(
            f"trace step {cursor - 1} wants {want!r} but enabled events are "
            f"{[e.key for e in enabled]}"
        )

    try:
        violations = loop.drive(inst.run(), chooser, max_steps)
    except NondeterminismError:
        raise
    except ExploreError:
        raise
    except BaseException as exc:
        violations = [f"exception: {type(exc).__name__}: {exc}"]
    finally:
        try:
            inst.cleanup()
        finally:
            loop.close()
    for exc in loop.exceptions:
        violations.append(f"background exception: {type(exc).__name__}: {exc}")
    return RunRecord(
        status="violation" if violations else "ok",
        choices=choices,
        violations=violations,
    )


# ---------------------------------------------------------------------------
# Crash-point enumeration
# ---------------------------------------------------------------------------


@dataclass
class CrashReport:
    backend: str
    commits: int = 0
    cases: int = 0
    failures: List[str] = field(default_factory=list)

    def summary(self) -> str:
        verdict = "all durable" if not self.failures else f"{len(self.failures)} FAILURE(S)"
        return (
            f"crash-points[{self.backend}]: {self.commits} commits, "
            f"{self.cases} crash cases, {verdict}"
        )


def crash_scan_wal(workdir: str, workload: Optional[Callable[[Any], None]] = None) -> CrashReport:
    """Enumerate WalStore crash points: one truncated + one torn-tail case
    per group-commit boundary; recovery must land on the acked prefix."""
    import copy
    import os
    import shutil

    from ray_tpu_torch._private import gcs_store

    report = CrashReport(backend="wal")
    log = os.path.join(workdir, "wal-crash.log")
    snapshots: List[Tuple[int, Dict[str, Dict[bytes, bytes]]]] = []

    store = gcs_store.WalStoreClient(log, sync="off")
    store.commit_listener = lambda commit, offset, n_ops: snapshots.append(
        (offset, copy.deepcopy(store._tables))
    )
    if workload is None:
        def workload(st):
            for i in range(6):
                st.put("t", f"k{i}", b"v%d" % i)
                st.flush()
                if i % 2 == 1:
                    st.delete("t", f"k{i - 1}")
                    st.flush()
    workload(store)
    store.commit_listener = None
    store.close()

    report.commits = len(snapshots)
    for idx, (offset, tables) in enumerate(snapshots):
        for torn in (False, True):
            case = os.path.join(workdir, f"wal-case-{idx}-{int(torn)}.log")
            shutil.copyfile(log, case)
            with open(case, "r+b") as fh:
                fh.truncate(offset)
            if torn:
                gcs_store.inject_torn_tail(case)
            recovered = gcs_store.WalStoreClient(case, sync="off")
            try:
                report.cases += 1
                if recovered._tables != tables:
                    report.failures.append(
                        f"commit {idx} (torn={torn}): recovered state does "
                        f"not match acked snapshot"
                    )
            finally:
                recovered.close()
            os.unlink(case)
    return report


def crash_scan_replicated(workdir: str) -> CrashReport:
    """Quorum-replicated crash points over a 3-member group with a rotating
    partitioned laggard. At every quorum commit boundary the member files
    are imaged; for each image we enumerate losing each single member ×
    {clean, torn-tail-on-survivors} and run the quorum-freshest election
    (max (term, seq) via _parse_replicated) over the two survivors. Every
    acknowledged write must appear in the elected state — the on-disk
    proof of the ack-quorum ∩ election-majority intersection argument.
    Writes *after* the imaged commit may legitimately be lost."""
    import os
    import shutil

    from ray_tpu_torch._private import gcs_store

    report = CrashReport(backend="replicated")
    primary = os.path.join(workdir, "repl-crash.log")
    followers = [
        os.path.join(workdir, "repl-crash.follower0"),
        os.path.join(workdir, "repl-crash.follower1"),
    ]
    members = [primary] + followers
    acked: List[Set[str]] = []
    images: List[List[str]] = []
    written: List[str] = []

    store = gcs_store.ReplicatedStoreClient(
        primary, followers=followers, term=1, sync="off"
    )

    def on_commit(seq: int, n_ops: int) -> None:
        # Image every member file at the commit boundary. A partitioned or
        # lagging member's copy may be stale or mid-append (torn) — that is
        # the point: the election must not need it.
        idx = len(images)
        image = []
        for mi, path in enumerate(members):
            copy_path = os.path.join(workdir, f"repl-case-{idx}.m{mi}")
            shutil.copyfile(path, copy_path)
            image.append(copy_path)
        images.append(image)
        acked.append(set(written))

    store.commit_listener = on_commit
    # Rotate a minority partition across the followers: commits 0-2 with
    # follower0 dark, 3-5 with follower1 dark (follower0 catches up via a
    # snapshot frame), 6-9 fully healed. Quorum (2 of 3) must keep acking
    # throughout.
    schedule = {0: followers[0], 3: followers[1], 6: None}
    try:
        for i in range(10):
            if i in schedule:
                gcs_store.heal_all_partitions()
                if schedule[i] is not None:
                    gcs_store.partition_host(schedule[i])
            key = f"rk{i}"
            store.put("t", key, b"rv%d" % i)
            written.append(key)
            store.flush()
    finally:
        store.commit_listener = None
        store.close()
        gcs_store.heal_all_partitions()

    report.commits = len(images)
    for idx, image in enumerate(images):
        for lost in range(len(members)):
            survivors = [p for mi, p in enumerate(image) if mi != lost]
            for torn in (False, True):
                report.cases += 1
                states = []
                for sp in survivors:
                    case = sp + (".torn" if torn else ".clean")
                    shutil.copyfile(sp, case)
                    if torn:
                        gcs_store.inject_torn_tail(case)
                    with open(case, "rb") as fh:
                        data = fh.read()
                    states.append(gcs_store._parse_replicated(data))
                    os.unlink(case)
                tables, term, seq, _ = max(states, key=lambda s: (s[1], s[2]))
                have = set(tables.get("t", {}).keys())
                missing = acked[idx] - have
                if missing:
                    report.failures.append(
                        f"commit {idx} (lost=m{lost}, torn={torn}): acked "
                        f"keys missing from elected state: {sorted(missing)}"
                    )
        for copy_path in image:
            os.unlink(copy_path)
    return report


# ---------------------------------------------------------------------------
# Virtual in-memory RPC transport (for protocol scenarios)
# ---------------------------------------------------------------------------


class _VirtualTransport(asyncio.Transport):
    """Loopback transport: writes become ``call_soon`` deliveries on the
    peer protocol, so every frame delivery is an explorer choice point."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        super().__init__()
        self._loop = loop
        self.peer: Optional[Any] = None  # peer protocol
        self._closing = False

    def write(self, data: bytes) -> None:
        if self._closing or self.peer is None:
            return
        self._loop.call_soon(self.peer.data_received, bytes(data))

    def is_closing(self) -> bool:
        return self._closing

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        if self.peer is not None:
            self._loop.call_soon(self.peer.connection_lost, None)

    def abort(self) -> None:
        self.close()

    def get_extra_info(self, name: str, default: Any = None) -> Any:
        return default


def virtual_connection_pair(client_handlers: Dict[str, Any], server_handlers: Dict[str, Any]) -> Tuple[Any, Any]:
    """Two ``rpc.Connection``s wired back-to-back entirely in memory.

    Must be called with the virtual loop running (Connection's ctor
    requires a running loop).  Returns ``(client_conn, server_conn)``.
    """
    from ray_tpu_torch._private import rpc

    loop = asyncio.get_running_loop()
    client = rpc.Connection(handlers=client_handlers)
    server = rpc.Connection(handlers=server_handlers)
    t_client = _VirtualTransport(loop)
    t_server = _VirtualTransport(loop)
    t_client.peer = server._protocol
    t_server.peer = client._protocol
    client._protocol.connection_made(t_client)
    server._protocol.connection_made(t_server)
    return client, server


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _scenario_registry() -> Dict[str, Any]:
    from ray_tpu_torch.chaos import scenarios_explore

    return scenarios_explore.SCENARIOS


def _build_explorer(spec: Any, naive: bool, max_steps: int, mutations: Sequence[str]) -> Explorer:
    oracle = None if naive else IndependenceOracle(repo_footprints())
    return Explorer(
        scenario_factory=lambda: spec.factory(mutations=list(mutations)),
        oracle=oracle,
        dpor=not naive,
        max_steps=max_steps,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.explore",
        description="exhaustive interleaving explorer (see module docstring)",
    )
    parser.add_argument("--list", action="store_true", help="list scenarios")
    parser.add_argument("--scenario", default=None, help="scenario name or 'all'")
    parser.add_argument("--budget", type=int, default=50000, help="max schedules per scenario")
    parser.add_argument("--max-steps", type=int, default=5000, help="max events per schedule")
    parser.add_argument("--naive", action="store_true", help="disable sleep-set pruning")
    parser.add_argument(
        "--mutate",
        action="append",
        default=[],
        help="enable a seeded bug (e.g. double_grant) — the explorer must catch it",
    )
    parser.add_argument(
        "--expect-violation",
        action="store_true",
        help="exit 0 iff at least one violation is found (mutation gate)",
    )
    parser.add_argument(
        "--allow-bounded",
        action="store_true",
        help="a clean run that exhausts the budget without exhausting the "
        "space still exits 0 (for spaces too big for the CI budget)",
    )
    parser.add_argument("--save-trace", default=None, help="write first violating schedule to FILE")
    parser.add_argument("--replay", default=None, help="replay a serialized choice trace")
    parser.add_argument(
        "--check-determinism",
        action="store_true",
        help="run each enumeration twice and require identical digests",
    )
    parser.add_argument(
        "--crash-points",
        action="store_true",
        help="enumerate WalStore/ReplicatedStore crash points instead of schedules",
    )
    args = parser.parse_args(argv)

    if args.crash_points:
        import tempfile
        import shutil as _shutil

        tmp = tempfile.mkdtemp(prefix="explore-crash-")
        try:
            reports = [crash_scan_wal(tmp), crash_scan_replicated(tmp)]
        finally:
            _shutil.rmtree(tmp, ignore_errors=True)
        bad = False
        for rep in reports:
            print(rep.summary())
            for f in rep.failures:
                print(f"  FAIL: {f}")
                bad = True
        return 1 if bad else 0

    registry = _scenario_registry()
    if args.list:
        for name, spec in sorted(registry.items()):
            print(f"{name}: {spec.description}")
        return 0

    if args.replay:
        data = load_trace(args.replay)
        name = data["scenario"]
        if name not in registry:
            print(f"explore: unknown scenario in trace: {name}", file=sys.stderr)
            return 2
        spec = registry[name]
        mutations = data.get("mutations", [])
        rec = replay(
            lambda: spec.factory(mutations=mutations),
            data["trace"],
            max_steps=args.max_steps,
        )
        print(f"replay {name} ({len(rec.choices)} choices): {rec.status}")
        for v in rec.violations:
            print(f"  violation: {v}")
        if args.expect_violation:
            return 0 if rec.status == "violation" else 1
        return 0 if rec.status == "ok" else 1

    if not args.scenario:
        parser.print_usage()
        return 2
    names = sorted(registry) if args.scenario == "all" else [args.scenario]
    exit_code = 0
    for name in names:
        if name not in registry:
            print(f"explore: unknown scenario {name!r}", file=sys.stderr)
            return 2
        spec = registry[name]
        explorer = _build_explorer(spec, args.naive, args.max_steps, args.mutate)
        report = explorer.explore(
            name,
            budget=args.budget,
            stop_on_violation=args.expect_violation,
        )
        if args.check_determinism:
            second = _build_explorer(spec, args.naive, args.max_steps, args.mutate)
            report2 = second.explore(name, budget=args.budget)
            if report.digest != report2.digest:
                print(f"{name}: NONDETERMINISTIC enumeration "
                      f"({report.digest[:16]} vs {report2.digest[:16]})")
                exit_code = 1
            else:
                print(f"{name}: deterministic across two runs")
        print(report.summary())
        if report.first_violation is not None:
            for v in report.first_violation.violations:
                print(f"  violation: {v}")
            if args.save_trace:
                save_trace(args.save_trace, name, report.first_violation, args.mutate)
                print(f"  trace saved to {args.save_trace}")
        if args.expect_violation:
            if report.violations == 0:
                print(f"{name}: expected a violation but found none")
                exit_code = 1
        else:
            if report.violations:
                exit_code = 1
            elif not report.complete and not args.allow_bounded:
                exit_code = 1
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
