"""Tests for the exhaustive interleaving explorer (devtools.explore).

Covers the virtualized event loop (determinism, virtual time, deadlock
detection), sleep-set DPOR pruning against naive enumeration on a toy
scenario with known footprints, trace save/replay round-trips, crash-point
enumeration over the WAL group-commit boundaries, the three control-plane
scenarios, and the double-grant mutation gate (explorer catches it; the
committed schedule in tests/schedules/ replays to the violation).
"""

import asyncio
import json
import os

import pytest

from ray_tpu_torch.chaos import scenarios_explore
from ray_tpu_torch.devtools import explore

SCHEDULES_DIR = os.path.join(os.path.dirname(__file__), "schedules")


# ---------------------------------------------------------------------------
# Toy scenario: three tasks, two conflicting, one independent
# ---------------------------------------------------------------------------


async def _toy_writer_a(shared):
    shared["a"] = shared.get("a", 0) + 1


async def _toy_writer_b(shared):
    shared["b"] = shared.get("b", 0) + 1


TOY_FOOTPRINTS = {
    "_toy_writer_a": {"reads": set(), "writes": {"self.a"}},
    "_toy_writer_b": {"reads": set(), "writes": {"self.b"}},
}


class _ToyScenario:
    def __init__(self, mutations=()):
        self.shared = {}

    async def run(self):
        await asyncio.gather(
            _toy_writer_a(self.shared),
            _toy_writer_b(self.shared),
            _toy_writer_a(self.shared),
        )
        return []

    def cleanup(self):
        pass


def _toy_explorer(dpor):
    return explore.Explorer(
        _ToyScenario,
        oracle=explore.IndependenceOracle(TOY_FOOTPRINTS),
        dpor=dpor,
    )


def test_toy_exhausts_clean():
    report = _toy_explorer(dpor=True).explore("toy", budget=10000)
    assert report.complete
    assert report.violations == 0
    assert report.schedules >= 1


def test_dpor_prunes_vs_naive_same_verdict():
    dpor = _toy_explorer(dpor=True).explore("toy", budget=10000)
    naive = _toy_explorer(dpor=False).explore("toy", budget=10000)
    assert dpor.complete and naive.complete
    # Sleep sets must cut the enumeration without changing the verdict.
    # (The savings surface as branches never tried — `pruned` only counts
    # runs abandoned mid-flight, which this tiny space may not produce.)
    assert dpor.schedules < naive.schedules
    assert naive.pruned == 0
    assert dpor.violations == naive.violations == 0


def test_enumeration_deterministic():
    first = _toy_explorer(dpor=True).explore("toy", budget=10000)
    second = _toy_explorer(dpor=True).explore("toy", budget=10000)
    assert first.digest == second.digest
    assert first.schedules == second.schedules


# ---------------------------------------------------------------------------
# Independence oracle
# ---------------------------------------------------------------------------


def test_oracle_rules():
    oracle = explore.IndependenceOracle(TOY_FOOTPRINTS)
    # Disjoint write sets commute.
    assert oracle.independent("task:_toy_writer_a#0", "task:_toy_writer_b#0")
    # Same qualname: conservatively dependent (same instance state).
    assert not oracle.independent("task:_toy_writer_a#0", "task:_toy_writer_a#1")
    # Unknown qualnames: conservatively dependent.
    assert not oracle.independent("task:_toy_writer_a#0", "task:mystery#0")


def test_oracle_repo_footprints_capture_writes():
    fp = explore.repo_footprints()
    # Spot-check: the store flush path writes its pending buffer.
    ent = fp.get("ReplicatedStoreClient.put")
    assert ent is not None
    assert "self._pending" in ent["writes"]


# ---------------------------------------------------------------------------
# VirtualLoop semantics
# ---------------------------------------------------------------------------


def test_virtual_time_ordering():
    loop = explore.VirtualLoop()
    order = []

    async def main():
        async def late():
            await asyncio.sleep(5.0)
            order.append("late")

        async def early():
            await asyncio.sleep(1.0)
            order.append("early")

        await asyncio.gather(late(), early())
        return []

    try:
        loop.drive(main(), lambda enabled: enabled[0], 1000)
    finally:
        loop.close()
    assert order == ["early", "late"]
    # Virtual clock jumped to the furthest deadline without real sleeping.
    assert loop.time() >= 5.0


def test_deadlock_detected():
    loop = explore.VirtualLoop()

    async def main():
        await asyncio.get_running_loop().create_future()  # never resolved

    try:
        with pytest.raises(explore.DeadlockError):
            loop.drive(main(), lambda enabled: enabled[0], 1000)
    finally:
        loop.close()


def test_max_steps_guard():
    loop = explore.VirtualLoop()

    async def main():
        while True:
            await asyncio.sleep(0)

    try:
        with pytest.raises(explore.ExploreError):
            loop.drive(main(), lambda enabled: enabled[0], 50)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# Trace save / load / replay
# ---------------------------------------------------------------------------


def test_trace_round_trip(tmp_path):
    report = _toy_explorer(dpor=True).explore("toy", budget=10000)
    assert report.schedules > 0
    # Re-run one schedule by replaying the first run's recorded choices:
    # enumerate once more and take the first record via a fresh explorer.
    ex = _toy_explorer(dpor=True)
    rec = ex._run_once()
    path = tmp_path / "trace.json"
    explore.save_trace(str(path), "toy", rec, mutations=[])
    data = explore.load_trace(str(path))
    assert data["scenario"] == "toy"
    assert data["trace"] == rec.choices
    replayed = explore.replay(_ToyScenario, data["trace"])
    assert replayed.status == rec.status == "ok"
    assert replayed.choices == rec.choices


def test_replay_divergence_detected():
    ex = _toy_explorer(dpor=True)
    rec = ex._run_once()
    bogus = ["task:not_a_real_event#0"] + rec.choices
    with pytest.raises(explore.NondeterminismError):
        explore.replay(_ToyScenario, bogus)


# ---------------------------------------------------------------------------
# Crash-point enumeration
# ---------------------------------------------------------------------------


def test_crash_scan_wal(tmp_path):
    report = explore.crash_scan_wal(str(tmp_path))
    assert report.commits > 0
    # Every commit boundary is probed twice: clean truncation + torn tail.
    assert report.cases == 2 * report.commits
    assert report.failures == []


def test_crash_scan_replicated(tmp_path):
    report = explore.crash_scan_replicated(str(tmp_path))
    assert report.commits > 0
    # Per commit image of the 3-member group: lose each single member,
    # each with a clean and a torn-tail survivor variant.
    assert report.cases == 6 * report.commits
    assert report.failures == []


# ---------------------------------------------------------------------------
# Control-plane scenarios
# ---------------------------------------------------------------------------


def _explore_scenario(name, budget, mutations=(), stop_on_violation=False):
    spec = scenarios_explore.SCENARIOS[name]
    ex = explore.Explorer(
        lambda: spec.factory(mutations=list(mutations)),
        oracle=explore.IndependenceOracle(explore.repo_footprints()),
        dpor=True,
    )
    return ex.explore(name, budget=budget, stop_on_violation=stop_on_violation)


def test_lease_exactly_once_exhausts_clean():
    report = _explore_scenario("lease_exactly_once", budget=6000)
    assert report.complete, report.summary()
    assert report.violations == 0, report.first_violation
    assert report.schedules > 100  # a real space, not a degenerate one


def test_ha_promotion_bounded_clean():
    report = _explore_scenario("ha_promotion", budget=400)
    assert report.violations == 0, report.first_violation
    assert report.schedules + report.pruned > 100


def test_resubscribe_gap_bounded_clean():
    report = _explore_scenario("resubscribe_gap", budget=300)
    assert report.violations == 0, report.first_violation
    # Measured space: ~99 interleavings. The publisher's inline fan-out
    # (no drain task when a subscriber has no backlog and a writable
    # transport) removed one task-spawn choice point per delivery, so the
    # space is smaller than the pre-batching ~150 — still far from
    # degenerate.
    assert report.schedules + report.pruned > 60


def test_quorum_election_exhausts_clean():
    # Measured space: 591 schedules — small enough to exhaust inline.
    report = _explore_scenario("quorum_election", budget=2000)
    assert report.complete, report.summary()
    assert report.violations == 0, report.first_violation
    assert report.schedules > 100


@pytest.mark.slow
def test_ha_promotion_exhausts_clean():
    # Measured space: 29369 schedules (~1 min); budget leaves headroom so
    # the assert fails loudly if the scenario ever grows past exhaustibility.
    report = _explore_scenario("ha_promotion", budget=40000)
    assert report.complete, report.summary()
    assert report.violations == 0, report.first_violation


# ---------------------------------------------------------------------------
# Mutation gate: the seeded double-grant bug must be caught
# ---------------------------------------------------------------------------


def test_mutation_double_grant_caught_in_budget():
    report = _explore_scenario(
        "lease_exactly_once",
        budget=2000,
        mutations=("double_grant",),
        stop_on_violation=True,
    )
    assert report.violations > 0
    assert any(
        "resource-ledger" in v for v in report.first_violation.violations
    )


def test_committed_double_grant_trace_replays_to_violation():
    path = os.path.join(SCHEDULES_DIR, "lease_double_grant.json")
    data = explore.load_trace(path)
    assert data["scenario"] == "lease_exactly_once"
    assert data["mutations"] == ["double_grant"]
    spec = scenarios_explore.SCENARIOS["lease_exactly_once"]
    rec = explore.replay(
        lambda: spec.factory(mutations=data["mutations"]), data["trace"]
    )
    assert rec.status == "violation"
    assert any("resource-ledger" in v for v in rec.violations)


def test_unmutated_scenario_on_violation_schedule_is_clean():
    """The schedule that kills the mutant must be survivable by the fix.

    The fixed code takes a different branch (duplicate detection), so the
    trace diverges — either a clean completion or a NondeterminismError at
    the divergence point is acceptable; a violation is not.
    """
    path = os.path.join(SCHEDULES_DIR, "lease_double_grant.json")
    data = explore.load_trace(path)
    spec = scenarios_explore.SCENARIOS["lease_exactly_once"]
    try:
        rec = explore.replay(lambda: spec.factory(), data["trace"])
    except explore.NondeterminismError:
        return
    assert rec.status == "ok", rec.violations


def test_unknown_mutation_rejected():
    spec = scenarios_explore.SCENARIOS["lease_exactly_once"]
    with pytest.raises(ValueError):
        spec.factory(mutations=["not_a_mutation"])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_list(capsys):
    assert explore.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in scenarios_explore.SCENARIOS:
        assert name in out


def test_cli_replay_committed_trace(capsys):
    path = os.path.join(SCHEDULES_DIR, "lease_double_grant.json")
    assert explore.main(["--replay", path, "--expect-violation"]) == 0


def test_trace_file_is_valid_json():
    path = os.path.join(SCHEDULES_DIR, "lease_double_grant.json")
    with open(path) as fh:
        data = json.load(fh)
    assert data["format"] == explore.TRACE_FORMAT
    assert isinstance(data["trace"], list) and data["trace"]
