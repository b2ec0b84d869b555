"""Fixtures for the whole-program blocking-graph pass (rpc_flow).

Each rule gets a positive fixture (must flag) and a negative fixture (the
clean idiom must stay quiet) over throwaway trees whose file layout maps
onto the service topology (``_private/gcs.py`` -> gcs, ...); the mutation
gate is exercised from both sides (seeded cycle detected, unmutated tree
clean); and the stale-suppression audit is pinned to cover the
``# rpc-flow:`` waiver family.
"""

import os
import textwrap

import pytest

from ray_tpu_torch.devtools import aio_lint, lint, rpc_check, rpc_flow


def _rules(findings):
    return {f.rule for f in findings}


def _tree(tmp_path, sources):
    """Write {relpath: source} under tmp_path; returns check() paths."""
    for name, src in sources.items():
        dest = tmp_path / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(textwrap.dedent(src))
    return [str(tmp_path)]


# ---------------------------------------------------------------------------
# wait-cycle
# ---------------------------------------------------------------------------

_CYCLE_GCS = """
class Gcs:
    def setup(self, s):
        s.register("RemoveThing", self._remove_thing)

    async def _remove_thing(self, conn, p):
        return await self.raylet.call("ReleaseThing", {})
"""


def test_wait_cycle_positive(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": _CYCLE_GCS,
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ReleaseThing", self._release_thing)

                async def _release_thing(self, conn, p):
                    return await self.gcs.call("RemoveThing", {})
            """,
        },
    )
    findings = rpc_flow.check(paths)
    assert rpc_flow.RULE_CYCLE in _rules(findings)
    [f] = [f for f in findings if f.rule == rpc_flow.RULE_CYCLE]
    assert "gcs:RemoveThing" in f.message and "raylet:ReleaseThing" in f.message


def test_wait_cycle_negative_async_via(tmp_path):
    # Breaking one edge with a non-blocking via dissolves the cycle: the
    # raylet replies before the GCS round-trip resolves.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": _CYCLE_GCS,
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ReleaseThing", self._release_thing)

                async def _release_thing(self, conn, p):
                    self.gcs.call_nowait("RemoveThing", {})
                    return {}
            """,
        },
    )
    assert rpc_flow.RULE_CYCLE not in _rules(rpc_flow.check(paths))


def test_wait_cycle_negative_spawn_boundary(tmp_path):
    # Work reached across rpc.spawn is on the causal path but does not
    # block the issuing handler — no cycle over it.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": _CYCLE_GCS,
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("ReleaseThing", self._release_thing)

                async def _release_thing(self, conn, p):
                    task = rpc.spawn(self._notify(p))
                    return {}

                async def _notify(self, p):
                    await self.gcs.call("RemoveThing", {})
            """,
        },
    )
    assert rpc_flow.RULE_CYCLE not in _rules(rpc_flow.check(paths))


# ---------------------------------------------------------------------------
# deadline-drop
# ---------------------------------------------------------------------------

_DROP_CALLER = """
async def go(conn):
    await conn.call("DoWork", {}, timeout=5.0)
"""


def test_deadline_drop_positive(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "client.py": _DROP_CALLER,
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("DoWork", self._do_work)

                async def _do_work(self, conn, p):
                    self.worker.call_cb("Notify", {}, self._on_reply)
                    return {}
            """,
        },
    )
    findings = rpc_flow.check(paths)
    assert rpc_flow.RULE_DROP in _rules(findings)


def test_deadline_drop_negative_deadline_kwarg(tmp_path):
    # call_nowait with deadline= re-arms the budget downstream: no drop.
    paths = _tree(
        tmp_path,
        {
            "client.py": _DROP_CALLER,
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("DoWork", self._do_work)

                async def _do_work(self, conn, p):
                    self.worker.call_nowait(
                        "Notify", {}, deadline=rpc.current_deadline()
                    )
                    return {}
            """,
        },
    )
    assert rpc_flow.RULE_DROP not in _rules(rpc_flow.check(paths))


def test_deadline_drop_negative_never_deadlined(tmp_path):
    # No caller ever sends DoWork a budget — there is nothing to drop.
    paths = _tree(
        tmp_path,
        {
            "client.py": """
            async def go(conn):
                conn.call_nowait("DoWork", {})
            """,
            "_private/gcs.py": """
            class Gcs:
                def setup(self, s):
                    s.register("DoWork", self._do_work)

                async def _do_work(self, conn, p):
                    self.worker.call_cb("Notify", {}, self._on_reply)
                    return {}
            """,
        },
    )
    assert rpc_flow.RULE_DROP not in _rules(rpc_flow.check(paths))


# ---------------------------------------------------------------------------
# unbounded-await
# ---------------------------------------------------------------------------

_WAIT_HANDLER = """
import asyncio

class Gcs:
    def setup(self, s):
        s.register("WaitThing", self._wait_thing)

    async def _wait_thing(self, conn, p):
        fut = asyncio.get_running_loop().create_future()
        self.waiters.append(fut)
        return await fut
"""


def test_unbounded_await_positive(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": _WAIT_HANDLER,
            "client.py": """
            async def go(conn):
                await conn.call("WaitThing", {})
            """,
        },
    )
    findings = rpc_flow.check(paths)
    assert rpc_flow.RULE_UNBOUNDED in _rules(findings)


def test_unbounded_await_negative_guaranteed_deadline(tmp_path):
    # Every caller pins a budget, so _run_deadlined cancels the parked
    # handler at the deadline: the await is bounded from outside.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": _WAIT_HANDLER,
            "client.py": """
            async def go(conn, config):
                await conn.call("WaitThing", {}, timeout=config.wait_s)
            """,
        },
    )
    assert rpc_flow.RULE_UNBOUNDED not in _rules(rpc_flow.check(paths))


def test_unbounded_await_negative_spawned_path(tmp_path):
    # A spawned background task parking on a future is its job, not the
    # handler's — only the synchronous closure counts.
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            import asyncio

            class Gcs:
                def setup(self, s):
                    s.register("WaitThing", self._wait_thing)

                async def _wait_thing(self, conn, p):
                    task = rpc.spawn(self._background())
                    return {}

                async def _background(self):
                    fut = asyncio.get_running_loop().create_future()
                    await fut
            """,
            "client.py": """
            async def go(conn):
                await conn.call("WaitThing", {})
            """,
        },
    )
    assert rpc_flow.RULE_UNBOUNDED not in _rules(rpc_flow.check(paths))


# ---------------------------------------------------------------------------
# unsupervised-spawn
# ---------------------------------------------------------------------------

_SPAWN_TREE = {
    "_private/raylet.py": """
    class Raylet:
        def setup(self, s):
            s.register("GrantThing", self._grant_thing)

        async def _grant_thing(self, conn, p):
            self._record_granted(p["id"])
            rpc.spawn(self._finish(p))
            return {}

        async def _finish(self, p):
            pass
    """,
}


def test_unsupervised_spawn_positive(tmp_path):
    findings = rpc_flow.check(_tree(tmp_path, _SPAWN_TREE))
    assert rpc_flow.RULE_SPAWN in _rules(findings)


def test_unsupervised_spawn_negative_bound_task(tmp_path):
    # Binding the task means the caller can observe its failure.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("GrantThing", self._grant_thing)

                async def _grant_thing(self, conn, p):
                    self._record_granted(p["id"])
                    task = rpc.spawn(self._finish(p))
                    task.add_done_callback(self._finish_done)
                    return {}

                async def _finish(self, p):
                    pass
            """,
        },
    )
    assert rpc_flow.RULE_SPAWN not in _rules(rpc_flow.check(paths))


def test_unsupervised_spawn_negative_no_critical_state(tmp_path):
    # Bare spawns are only findings on paths touching ledgered pairs or
    # the PG 2PC protocol; fire-and-forget elsewhere is idiomatic.
    paths = _tree(
        tmp_path,
        {
            "_private/raylet.py": """
            class Raylet:
                def setup(self, s):
                    s.register("PokeThing", self._poke_thing)

                async def _poke_thing(self, conn, p):
                    rpc.spawn(self._finish(p))
                    return {}

                async def _finish(self, p):
                    pass
            """,
        },
    )
    assert rpc_flow.RULE_SPAWN not in _rules(rpc_flow.check(paths))


# ---------------------------------------------------------------------------
# deadline provenance (shared with the wire-protocol Deadline column)
# ---------------------------------------------------------------------------


def test_deadline_sources_pinned_vs_conditional(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "client.py": """
            async def a(conn, config, timeout):
                await conn.call("Pinned", {}, timeout=config.rpc_s)
                await conn.call(
                    "Conditional",
                    {},
                    timeout=None if timeout is None else timeout + 5,
                )
                await conn.call("Ambient", {})
                conn.push_nowait("Never", {})
            """,
        },
    )
    analysis = rpc_flow.build(paths)
    assert rpc_flow.deadline_sources(analysis, "Pinned") == (
        True,
        True,
        ["config.rpc_s"],
    )
    maybe, guaranteed, _ = rpc_flow.deadline_sources(analysis, "Conditional")
    assert maybe and not guaranteed
    assert rpc_flow.deadline_sources(analysis, "Ambient") == (True, False, [])
    assert rpc_flow.deadline_sources(analysis, "Never") == (False, False, [])


# ---------------------------------------------------------------------------
# suppressions + the stale-suppression audit for the rpc-flow family
# ---------------------------------------------------------------------------


def test_suppression_masks_finding(tmp_path):
    paths = _tree(
        tmp_path,
        {
            "_private/gcs.py": """
            import asyncio

            class Gcs:
                def setup(self, s):
                    s.register("WaitThing", self._wait_thing)

                async def _wait_thing(self, conn, p):
                    fut = asyncio.get_running_loop().create_future()
                    self.waiters.append(fut)
                    return await fut  # rpc-flow: disable=unbounded-await
            """,
            "client.py": """
            async def go(conn):
                await conn.call("WaitThing", {})
            """,
        },
    )
    assert rpc_flow.RULE_UNBOUNDED not in _rules(rpc_flow.check(paths))
    raw = rpc_flow.check(paths, apply_suppressions=False)
    assert rpc_flow.RULE_UNBOUNDED in _rules(raw)
    # ...and the audit sees the waiver as live, not stale.
    audit = lint.audit_suppressions(paths)
    assert [f for f in audit if f.rule == lint.RULE_STALE] == []


def test_stale_rpc_flow_suppression_flagged(tmp_path):
    (tmp_path / "m.py").write_text("x = 1  # rpc-flow: disable=wait-cycle\n")
    findings = lint.audit_suppressions([str(tmp_path)])
    assert [f.rule for f in findings] == [lint.RULE_STALE]


# ---------------------------------------------------------------------------
# mutation gate, both sides
# ---------------------------------------------------------------------------


def test_mutation_seeds_detectable_cycle():
    findings = rpc_flow.check(mutate="back_call")
    cycles = [f for f in findings if f.rule == rpc_flow.RULE_CYCLE]
    assert cycles, "seeded back-call cycle must be detected"
    assert any("ReleasePGBundles" in f.message for f in cycles)


def test_mutation_gate_cli_passes_on_mutant(capsys):
    assert rpc_flow.main(["--mutate", "back_call", "--expect-violation"]) == 0
    assert "mutation detected" in capsys.readouterr().out


def test_expect_violation_fails_on_clean_tree(capsys):
    # The other side of the gate: with no seeded defect the clean tree
    # must NOT satisfy --expect-violation (a toothless pass would).
    assert rpc_flow.main(["--expect-violation"]) == 1


# ---------------------------------------------------------------------------
# acceptance: the shipped tree and its committed graph doc (the full-repo
# walk is the expensive part — share one result across the pins)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repo_markdown():
    return rpc_flow.markdown()


def test_repo_is_rpc_flow_clean():
    assert [str(f) for f in rpc_flow.check()] == []


def test_repo_doc_is_current(repo_markdown):
    root = os.path.dirname(aio_lint._default_root())
    doc = os.path.join(root, "docs", "torch", "rpc_flow.md")
    with open(doc, "r", encoding="utf-8") as fh:
        assert fh.read() == repo_markdown + "\n"


def test_markdown_shape(repo_markdown):
    assert "```mermaid" in repo_markdown
    assert "## Blocking edges" in repo_markdown
    assert "## Handler-reachable local waits" in repo_markdown
    assert "## Spawn points on handler paths" in repo_markdown


def test_wire_protocol_doc_has_deadline_column():
    text = rpc_check.markdown_table()
    header = [l for l in text.splitlines() if l.startswith("| Method ")][0]
    assert "| Deadline |" in header
