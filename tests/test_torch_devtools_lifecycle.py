"""Fixtures for the lifecycle dataflow pass and the protocol FSM checker.

Positive fixtures prove each rule fires on its target shape; negative
fixtures prove the clean idioms used in the tree (acquire + try/finally,
guarded legal transitions, constants) stay quiet; and the repo-clean tests
pin the acceptance bar: the shipped package must lint clean under both
passes.
"""

import asyncio
import dataclasses
import os
import textwrap

import pytest

from ray_tpu_torch._private.pull_manager import PullManager
from ray_tpu_torch.devtools import aio_lint, lifecycle, protocols


def _lrules(src):
    findings = lifecycle.lint_source(textwrap.dedent(src), "fixture.py")
    return {f.rule for f in findings}


def _prules(src, name="gcs.py"):
    findings = protocols.check_source(textwrap.dedent(src), name)
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# lifecycle: paired-resource dataflow


def test_leak_on_exception():
    rules = _lrules(
        """
        class R:
            async def pull(self, size):
                await self.pull_manager.acquire(size)
                data = self.decode(size)  # may raise -> quota leaks
                self.pull_manager.release(size)
                return data
        """
    )
    assert lifecycle.RULE_LEAK_EXC in rules


def test_leak_on_early_return():
    rules = _lrules(
        """
        class R:
            async def pull(self, size):
                await self.pull_manager.acquire(size)
                if size > 10:
                    return None  # skips the release
                self.pull_manager.release(size)
        """
    )
    assert lifecycle.RULE_LEAK_RETURN in rules


def test_held_across_await_without_finally():
    rules = _lrules(
        """
        class R:
            async def pull(self, size, conn):
                await self.pull_manager.acquire(size)
                await conn.call("FetchChunk", {})  # cancellation point
                self.pull_manager.release(size)
        """
    )
    assert lifecycle.RULE_HELD_AWAIT in rules


def test_double_release():
    rules = _lrules(
        """
        class R:
            async def pull(self, size):
                await self.pull_manager.acquire(size)
                self.pull_manager.release(size)
                self.pull_manager.release(size)
        """
    )
    assert lifecycle.RULE_DOUBLE_RELEASE in rules


def test_trace_span_leak_across_await():
    # The span token is scoped: crossing an await before the reset
    # means a cancellation leaks the span onto whatever runs next on this
    # context.
    rules = _lrules(
        """
        class R:
            async def handle(self, ctx):
                tok = tracing.set_context(ctx)
                await self.invoke()
                tracing.reset_context(tok)
        """
    )
    assert lifecycle.RULE_HELD_AWAIT in rules


def test_trace_span_try_finally_is_clean():
    # The shipped idiom (worker_main, serve replica): reset in a finally.
    assert not _lrules(
        """
        class R:
            async def handle(self, ctx):
                tok = tracing.set_context(ctx)
                try:
                    return await self.invoke()
                finally:
                    tracing.reset_context(tok)
        """
    )


def test_clean_try_finally():
    assert not _lrules(
        """
        class R:
            async def pull(self, size, conn):
                await self.pull_manager.acquire(size)
                try:
                    return await conn.call("FetchChunk", {})
                finally:
                    self.pull_manager.release(size)
        """
    )


def test_conditional_release_is_quiet():
    # Branch-joined "maybe held" never fires: a conditional release
    # pattern is assumed deliberate.
    assert not _lrules(
        """
        class R:
            async def pull(self, size, ok):
                await self.pull_manager.acquire(size)
                try:
                    if ok:
                        self.pull_manager.release(size)
                finally:
                    pass
        """
    )


def test_ledger_mode_needs_balanced_scope():
    # A ledger-style acquire with no in-function release is a legitimate
    # cross-function hold (raylet deduct / store pin) — no findings.
    assert not _lrules(
        """
        class Raylet:
            def grant(self, req):
                self.available = self.available - req.demand
                self._record_granted(req.lease_id)
                self.commit(req)
        """
    )
    # But a function that both deducts and refunds is a balanced scope and
    # the hazard rules apply between them.
    rules = _lrules(
        """
        class Raylet:
            def grant(self, req):
                self.available = self.available - req.demand
                self.commit(req)  # may raise
                self.available = self.available + req.demand
        """
    )
    assert lifecycle.RULE_LEAK_EXC in rules


def test_release_only_function_is_quiet():
    assert not _lrules(
        """
        class W:
            def done(self, a, b):
                self.plasma.release_many(a)
                self.plasma.release_many(b)
        """
    )


def test_lifecycle_suppression():
    assert not _lrules(
        """
        class R:
            async def pull(self, size):
                await self.pull_manager.acquire(size)
                if size > 10:
                    # owner tracks the quota  # lifecycle: disable=lifecycle-leak-return
                    return None
                self.pull_manager.release(size)
        """
    )


# ---------------------------------------------------------------------------
# protocols: FSM checker


def test_illegal_transition_under_guard():
    rules = _prules(
        """
        DEAD = "DEAD"
        ALIVE = "ALIVE"
        class GcsServer:
            async def f(self, actor):
                if actor.state == DEAD:
                    actor.state = ALIVE  # dead actors do not resurrect
        """
    )
    assert protocols.RULE_ILLEGAL in rules


def test_unknown_state_literal():
    rules = _prules(
        """
        class GcsServer:
            async def f(self, actor):
                actor.state = "ZOMBIE"
        """
    )
    assert protocols.RULE_UNKNOWN in rules


def test_unknown_state_in_comparison():
    rules = _prules(
        """
        def f(pg):
            return pg.state == "CREATEDD"
        """
    )
    assert protocols.RULE_UNKNOWN in rules


def test_unresolvable_state_assignment():
    rules = _prules(
        """
        class GcsServer:
            def f(self, actor, rec):
                actor.state = rec["state"]
        """
    )
    assert protocols.RULE_UNRESOLVABLE in rules


def test_protocol_suppression():
    assert not _prules(
        """
        class GcsServer:
            def f(self, actor, rec):
                actor.state = rec["state"]  # protocol: disable=protocol-unresolvable
        """
    )


def test_init_must_use_initial_state():
    rules = _prules(
        """
        class ActorInfo:
            def __init__(self):
                self.state = "ALIVE"
        """
    )
    assert protocols.RULE_ILLEGAL in rules


def test_clean_guarded_transition():
    assert not _prules(
        """
        PG_CREATED = "CREATED"
        PG_RESCHEDULING = "RESCHEDULING"
        def on_node_death(pg):
            if pg.state == PG_CREATED:
                pg.state = PG_RESCHEDULING
        """
    )


def test_clean_constant_assignment():
    assert not _prules(
        """
        RESTARTING = "RESTARTING"
        def f(actor):
            actor.state = RESTARTING
        """
    )


def test_lease_ledger_booleans():
    assert not _prules(
        """
        class Raylet:
            def record(self, lease_id):
                self.granted_lease_ids[lease_id] = True
            def burn(self, lease_id):
                self.granted_lease_ids[lease_id] = False
        """,
        "raylet.py",
    )
    rules = _prules(
        """
        class Raylet:
            def record(self, lease_id):
                self.granted_lease_ids[lease_id] = "weird"
        """,
        "raylet.py",
    )
    assert protocols.RULE_UNKNOWN in rules


def test_unscanned_filenames_are_ignored():
    assert not _prules(
        """
        def f(actor):
            actor.state = "ZOMBIE"
        """,
        "dashboard.py",
    )


def test_spec_is_internally_consistent():
    assert protocols._spec_findings() == []


def test_invariant_cross_check_detects_drift():
    # Removing a terminal state from the spec must break the sync with
    # chaos TERMINAL_ACTOR_STATES (a regression pin).
    broken = dataclasses.replace(
        protocols.ACTOR, terminal=(), quiescent=("ALIVE",)
    )
    findings = protocols.check_invariants_sync(machine=broken)
    assert any(f.rule == protocols.RULE_DRIFT for f in findings)
    # And the shipped spec is in sync.
    assert protocols.check_invariants_sync() == []


def test_markdown_generation():
    text = protocols.markdown()
    assert text.startswith("# Control-plane protocol state machines")
    for machine in protocols.MACHINES:
        assert f"## {machine.name}" in text
    assert "stateDiagram-v2" in text
    # Deterministic: docs drift check in CI relies on this.
    assert text == protocols.markdown()


def test_repo_protocols_doc_is_current():
    """docs/torch/protocols.md is what the port's --markdown prints."""
    root = os.path.dirname(aio_lint._default_root())
    with open(os.path.join(root, "docs", "torch", "protocols.md"), encoding="utf-8") as fh:
        assert fh.read() == protocols.markdown()


# ---------------------------------------------------------------------------
# acceptance: the shipped tree lints clean under both passes


def test_repo_is_lifecycle_clean():
    root = aio_lint._default_root()
    assert [str(f) for f in lifecycle.lint_paths([root])] == []


def test_repo_is_protocol_clean():
    root = aio_lint._default_root()
    assert [str(f) for f in protocols.check([root])] == []


# ---------------------------------------------------------------------------
# the pull-quota cancellation leak (regression-pinned)


def test_pull_quota_cancelled_acquire_releases():
    async def main():
        pm = PullManager(100)
        await pm.acquire(80)
        waiter = asyncio.get_running_loop().create_task(pm.acquire(50))
        await asyncio.sleep(0)  # park the waiter in the heap
        # Admit the waiter (its future resolves, quota is charged) and
        # cancel before it resumes: the acquire must undo the admission.
        pm.release(80)
        assert pm.bytes_in_flight == 50 and pm.active == 1
        waiter.cancel()
        with pytest.raises(asyncio.CancelledError):
            await waiter
        assert pm.bytes_in_flight == 0 and pm.active == 0

    asyncio.run(main())


def test_pull_quota_cancelled_before_admission():
    async def main():
        pm = PullManager(100)
        await pm.acquire(80)
        waiter = asyncio.get_running_loop().create_task(pm.acquire(50))
        await asyncio.sleep(0)
        # Not yet admitted: cancelling must not touch the quota.
        waiter.cancel()
        with pytest.raises(asyncio.CancelledError):
            await waiter
        assert pm.bytes_in_flight == 80 and pm.active == 1
        pm.release(80)
        assert pm.bytes_in_flight == 0 and pm.active == 0

    asyncio.run(main())


def test_pull_quota_underflow_fails_loudly():
    pm = PullManager(100)
    with pytest.raises(AssertionError, match="underflow"):
        pm.release(10)
