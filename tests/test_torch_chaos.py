"""ray_tpu_torch.chaos: schedule determinism, interceptor fault units, the
double-grant lease guard, pull stall recovery, and a fixed-seed convergence
smoke (reference fault-injection shape: Jepsen nemeses + deterministic
schedule replay)."""

import asyncio

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.chaos import interceptors, invariants
from ray_tpu_torch.chaos.runner import SCENARIOS, SUITES, run_scenario
from ray_tpu_torch.chaos.schedule import (
    FaultLog,
    FaultSchedule,
    FaultSpec,
    NemesisPlan,
    stable_u64,
)
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401


# ---------------------------------------------------------------- schedules


def test_stable_u64_is_process_stable():
    # sha256-derived, not the salted builtin hash: value is a constant.
    assert stable_u64("42:lose-chunks") == stable_u64("42:lose-chunks")
    assert stable_u64("a") != stable_u64("b")


def test_schedule_same_seed_byte_identical():
    specs = [
        FaultSpec("d", "drop", "PushChunk", frame="push", p=0.3),
        FaultSpec("l", "delay", "Request*", p=0.5, delay_s=(0.001, 0.2)),
    ]
    a = FaultSchedule(123, specs)
    b = FaultSchedule(123, specs)
    assert a.to_bytes() == b.to_bytes()
    assert a.digest() == b.digest()


def test_schedule_different_seed_differs():
    specs = [FaultSpec("d", "drop", "PushChunk", frame="push", p=0.3)]
    assert FaultSchedule(1, specs).to_bytes() != FaultSchedule(2, specs).to_bytes()


def test_schedule_respects_start_after_and_max_fires():
    spec = FaultSpec("d", "drop", "*", p=1.0, start_after=3, max_fires=2)
    plan = FaultSchedule(7, [spec]).decisions["d"]
    assert plan[:3] == [None, None, None]
    assert [d for d in plan if d is not None] == [("drop",), ("drop",)]


def test_schedule_rejects_bad_specs():
    with pytest.raises(ValueError):
        FaultSpec("x", "explode", "*")
    with pytest.raises(ValueError):
        FaultSpec("x", "drop", "*", frame="sideways")
    with pytest.raises(ValueError):
        FaultSchedule(1, [FaultSpec("x", "drop", "*"), FaultSpec("x", "dup", "*")])


def test_scenario_catalog_schedules_deterministic():
    # The exact property the CI gate replays: every cataloged scenario's
    # schedule and nemesis plan is a pure function of the seed.
    for scenario in SCENARIOS.values():
        for seed in (0, 1, 99):
            assert (
                FaultSchedule(seed, scenario.specs).to_bytes()
                == FaultSchedule(seed, scenario.specs).to_bytes()
            )
            assert (
                NemesisPlan(seed, scenario.nemesis, scenario.steps).to_wire()
                == NemesisPlan(seed, scenario.nemesis, scenario.steps).to_wire()
            )
    assert set(SUITES["smoke"]) <= set(SCENARIOS)


def test_nemesis_plan_never_fires_at_step_zero():
    plan = NemesisPlan(5, ["kill_worker", "restart_gcs"], steps=4)
    assert all(step >= 1 for step, _, _ in plan.points)
    assert plan.at_step(0) == []


# ------------------------------------------------------------- interceptors


class _FakeLoop:
    def __init__(self):
        self.later = []

    def call_later(self, t, fn, *args):
        self.later.append((t, fn, args))
        return _FakeTimer()


class _FakeTimer:
    def cancelled(self):
        return False


class _FakeConn:
    """Quacks like rpc.Connection for the interceptor's send paths."""

    def __init__(self):
        self.sent = []
        self._loop = _FakeLoop()

    def _send_direct(self, msg):
        self.sent.append(msg)


def _interceptor(spec, seed=0):
    return interceptors.ChaosInterceptor(FaultSchedule(seed, [spec]))


def test_interceptor_drop_consumes_frame():
    chaos = _interceptor(FaultSpec("d", "drop", "PushChunk", frame="push", p=1.0))
    conn = _FakeConn()
    msg = [0, 3, "PushChunk", {"oid": "x"}]
    assert chaos(conn, msg) is True  # consumed: never sent
    assert conn.sent == []
    assert chaos.log.count("d") == 1


def test_interceptor_delay_schedules_send_direct():
    chaos = _interceptor(
        FaultSpec("l", "delay", "ObjGet", frame="request", p=1.0,
                  delay_s=(0.01, 0.02))
    )
    conn = _FakeConn()
    msg = [1, 0, "ObjGet", {}]
    assert chaos(conn, msg) is True
    (t, fn, args), = conn._loop.later
    assert 0.01 <= t <= 0.02 and fn == conn._send_direct and args == (msg,)


def test_interceptor_dup_sends_extra_copy():
    chaos = _interceptor(FaultSpec("2x", "dup", "RequestWorkerLease", p=1.0))
    conn = _FakeConn()
    msg = [2, 0, "RequestWorkerLease", {"lease_id": "abc"}]
    # Returns False: the original still flows; one extra copy went direct.
    assert chaos(conn, msg) is False
    assert conn.sent == [msg]


def test_interceptor_reorder_swaps_adjacent_frames():
    # Fire on match 0, pass match 1: frame B must be sent before held frame A.
    chaos = _interceptor(
        FaultSpec("r", "reorder", "PushChunk", frame="push", p=1.0, max_fires=1)
    )
    conn = _FakeConn()
    a = [3, 3, "PushChunk", {"seq": 0}]
    b = [4, 3, "PushChunk", {"seq": 1}]
    assert chaos(conn, a) is True and conn.sent == []  # held
    assert chaos(conn, b) is True
    assert conn.sent == [b, a]  # swapped


def test_interceptor_flush_held_releases_frames():
    chaos = _interceptor(
        FaultSpec("r", "reorder", "PushChunk", frame="push", p=1.0)
    )
    conn = _FakeConn()
    msg = [5, 3, "PushChunk", {}]
    assert chaos(conn, msg) is True
    chaos.flush_held()
    assert conn.sent == [msg]


def test_interceptor_ignores_unmatched_frames():
    chaos = _interceptor(FaultSpec("d", "drop", "PushChunk", frame="push", p=1.0))
    conn = _FakeConn()
    assert chaos(conn, [0, 0, "PushChunk", {}]) is False  # request, not push
    assert chaos(conn, [0, 3, "PushStart", {}]) is False  # different method
    assert chaos.log.count() == 0


def test_fault_log_digest_tracks_events():
    chaos = _interceptor(FaultSpec("d", "drop", "*", p=1.0))
    empty = FaultLog().digest()
    assert chaos.log.digest() == empty
    chaos(_FakeConn(), [0, 0, "Anything", {}])
    assert chaos.log.digest() != empty


def test_install_uninstall_roundtrip():
    schedule = FaultSchedule(0, [FaultSpec("d", "drop", "NoSuchMethod", p=1.0)])
    chaos = interceptors.install(schedule)
    try:
        assert rpc.get_send_interceptor() is chaos
        with pytest.raises(RuntimeError):
            interceptors.install(schedule)
    finally:
        assert interceptors.uninstall() is chaos
    assert rpc.get_send_interceptor() is None
    assert interceptors.uninstall() is None


# ------------------------------------------- double-grant guard (regression)


@pytest.fixture
def ray_two_cpus(torch_shutdown_only):
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield worker_mod.global_worker


def _head_raylet(w):
    return w.node.raylet


def test_duplicated_lease_request_grants_once(ray_two_cpus):
    """Regression for the raylet.leases write-write: a wire-duplicated
    RequestWorkerLease must grant exactly one worker, keep the resource
    ledger balanced, and leak nothing (ROADMAP AIOCHECK open item)."""
    w = ray_two_cpus
    schedule = FaultSchedule(
        0, [FaultSpec("2x", "dup", "RequestWorkerLease", frame="request", p=1.0)]
    )

    async def _install():
        return interceptors.install(schedule)

    async def _uninstall():
        return interceptors.uninstall()

    w.run_async(_install())
    try:

        @ray_tpu_torch.remote
        def f(x):
            return x * 2

        assert ray_tpu_torch.get([f.remote(i) for i in range(4)], timeout=60) == [
            0, 2, 4, 6,
        ]
    finally:
        w.run_async(_uninstall())

    raylet = _head_raylet(w)
    assert raylet.duplicate_lease_grants_avoided >= 1

    async def _settle():
        # Leases drain after worker_lease_idle_keep_s; then the ledger must
        # balance exactly and no worker may sit leaked outside the idle pool.
        deadline = asyncio.get_running_loop().time() + 10
        while asyncio.get_running_loop().time() < deadline:
            task_leases = [
                lid for lid, h in raylet.leases.items() if h.actor_id is None
            ]
            if not task_leases and raylet.available == raylet.total:
                return
            await asyncio.sleep(0.05)
        raise AssertionError(
            f"leases={list(raylet.leases)} "
            f"available={raylet.available.to_dict()} "
            f"total={raylet.total.to_dict()}"
        )

    w.run_async(_settle(), timeout=15)
    assert invariants.check_leases(raylet) == []


def test_duplicate_grant_ledger_allows_actor_restart_reuse():
    """Actor lease ids ARE legitimately re-requested after release (actor
    restart); task lease ids never are."""
    from ray_tpu_torch._private.raylet import Raylet

    r = object.__new__(Raylet)  # ledger methods only touch these attrs
    from collections import OrderedDict

    r.granted_lease_ids = OrderedDict()
    r.duplicate_lease_grants_avoided = 0
    r._record_granted("task-lease-1")
    r._record_granted("actor:abc")
    assert r._is_duplicate_grant("task-lease-1")
    assert r._is_duplicate_grant("actor:abc")
    r._mark_lease_released("task-lease-1")
    r._mark_lease_released("actor:abc")
    # Released task ids stay duplicates (late wire-dup must not re-grant);
    # released actor ids may be granted again (restart path).
    assert r._is_duplicate_grant("task-lease-1")
    assert not r._is_duplicate_grant("actor:abc")
    assert not r._is_duplicate_grant("never-seen")


# ------------------------------------------------------ pull stall recovery


def test_watch_stream_detects_stall():
    from ray_tpu_torch._private.pull_manager import PullManager, PullStalled

    async def go():
        pm = PullManager(1 << 20, stall_timeout_s=0.2)
        with pytest.raises(PullStalled):
            await pm.watch_stream(lambda: 0, lambda: False, timeout=5.0)
        assert pm.stalled_streams == 1

    asyncio.run(go())


def test_watch_stream_returns_on_completion():
    from ray_tpu_torch._private.pull_manager import PullManager

    async def go():
        pm = PullManager(1 << 20, stall_timeout_s=0.2)
        state = {"n": 0, "done": False}

        async def producer():
            for _ in range(4):
                await asyncio.sleep(0.05)
                state["n"] += 1
            state["done"] = True

        task = asyncio.ensure_future(producer())
        await pm.watch_stream(
            lambda: state["n"], lambda: state["done"], timeout=5.0
        )
        await task
        assert pm.stalled_streams == 0

    asyncio.run(go())


def test_chunk_loss_pull_rerequests(torch_shutdown_only, monkeypatch):
    """Drop every early PushChunk of the first transfer: the pull must
    stall-detect, abort the half assembly, and converge via re-request or
    the fetch fallback instead of hanging. The reference marks its copy
    slow (a two-node boot); on the port it runs in tier-1 (~6 s)."""
    monkeypatch.setenv("RAY_TPU_OBJECT_CHUNK_SIZE", "32768")
    monkeypatch.setenv("RAY_TPU_PULL_STALL_TIMEOUT_S", "0.5")
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    try:
        cluster.add_node(num_cpus=1, resources={"victim": 1})
        cluster.connect()
        w = worker_mod.global_worker
        schedule = FaultSchedule(
            3,
            [FaultSpec("lose", "drop", "PushChunk", frame="push", p=1.0,
                       max_fires=6)],
        )

        async def _install():
            return interceptors.install(schedule)

        async def _uninstall():
            return interceptors.uninstall()

        chaos = w.run_async(_install())

        @ray_tpu_torch.remote(resources={"victim": 1})
        def blob():
            return b"\xab" * 300_000

        try:
            data = ray_tpu_torch.get(blob.remote(), timeout=90)
        finally:
            w.run_async(_uninstall())
        assert data == b"\xab" * 300_000
        assert chaos.log.count("lose") >= 1
        stalled = sum(
            r.pull_manager.stalled_streams for r in cluster.raylets.values()
        )
        assert stalled >= 1
    finally:
        cluster.shutdown()


# -------------------------------------------------------- convergence smoke


@pytest.mark.parametrize("name", ["rpc_delay", "dup_lease"])
def test_chaos_smoke_fixed_seeds(torch_shutdown_only, name):
    """Tier-1 smoke: two interceptor scenarios over a fixed seed must
    converge with every invariant intact (CI's chaos-smoke job runs the
    full suite over 20 seeds)."""
    results = run_scenario(SCENARIOS[name], seeds=[0], corpus=None)
    assert [r.ok for r in results] == [True], [
        v for r in results for v in r.violations
    ]
    # Replay determinism: the recorded schedule digest is reproducible.
    for r in results:
        assert (
            FaultSchedule(r.seed, SCENARIOS[name].specs).digest()
            == r.schedule_digest
        )
