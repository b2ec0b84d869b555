"""Serve's load path on the port (ray_tpu_torch.serve, ray_tpu_torch.loadgen),
on the CPU: the cases of tests/test_serve_load.py on the port's runtime
(loadgen outcome classification, admission-control sheds, the
continuous-batching edges, the queue-EWMA autoscaler's hysteresis), then
the same scripted inputs through both packages' policy code, compared
exactly: loadgen's percentile and outcome buckets, the replica's batch
formation, the autoscaler's decisions over one metrics sequence, and the
router's admission, shed and pick decisions."""


import asyncio
import random

import numpy as np
import pytest

from ray_tpu_torch.testing import torch_cluster  # noqa: F401


# -- loadgen unit tests (no cluster) ------------------------------------------


def test_percentile_nearest_rank():
    from ray_tpu_torch.loadgen import percentile

    assert percentile([], 0.99) == 0.0
    vals = [float(i) for i in range(1, 101)]
    assert percentile(vals, 0.0) == 1.0
    assert percentile(vals, 1.0) == 100.0
    assert percentile(vals, 0.99) == 99.0  # round(0.99 * 99) = 98
    assert 50.0 <= percentile(vals, 0.5) <= 51.0


class _ScriptedRouter:
    """assign_request stub: runs the supplied coroutine function."""

    def __init__(self, fn):
        self._fn = fn

    async def assign_request(self, dep, meta, args, kwargs, timeout_s=None):
        return await self._fn()


def test_loadgen_outcome_classification():
    from ray_tpu_torch import loadgen
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.serve._private.common import DeploymentOverloadedError

    async def main():
        res = loadgen.PhaseResult("t")

        async def ok():
            return 1

        async def shed_q():
            raise DeploymentOverloadedError("d", "queue_full", "full")

        async def shed_d():
            raise DeploymentOverloadedError("d", "deadline_unreachable", "x")

        async def cut():
            raise rpc.DeadlineExceeded("late")

        async def boom():
            raise RuntimeError("kaput")

        for fn in (ok, shed_q, shed_d, cut, boom):
            await loadgen._issue_one(_ScriptedRouter(fn), "d", 0, 1.0, res)
        assert res.issued == 5
        assert res.ok == 1
        assert res.shed_queue_full == 1
        assert res.shed_deadline == 1
        assert res.shed == 2
        assert res.deadline_cut == 1
        assert res.errors == 1 and "kaput" in res.error_samples[0]
        assert res.overruns == 0

    asyncio.run(main())


def test_loadgen_success_past_deadline_is_overrun():
    """A SUCCESS delivered past deadline + grace is the invariant violation
    the harness exists to catch — it must land in `overruns`, not `ok`."""
    from ray_tpu_torch import loadgen
    from ray_tpu_torch._private.common import config

    async def main():
        res = loadgen.PhaseResult("t")

        async def late_success():
            await asyncio.sleep(0.05 + config.rpc_deadline_grace_s + 0.1)
            return "fine"

        await loadgen._issue_one(
            _ScriptedRouter(late_success), "d", 0, 0.05, res
        )
        assert res.overruns == 1
        assert res.ok == 0 and not res.latencies_ms

    asyncio.run(main())


def test_loadgen_loops_and_gate_json_shape():
    from ray_tpu_torch import loadgen

    async def main():
        async def fast():
            await asyncio.sleep(0.001)
            return 1

        router = _ScriptedRouter(fast)
        closed = await loadgen.closed_loop(
            router, "d", concurrency=4, duration_s=0.2, timeout_s=1.0
        )
        opened = await loadgen.open_loop(
            router, "d", rps=200.0, duration_s=0.2, timeout_s=1.0
        )
        return closed, opened

    closed, opened = asyncio.run(main())
    assert closed.issued > 0 and closed.ok == closed.issued
    # Open loop fires on the arrival schedule regardless of completions.
    assert 20 <= opened.issued <= 120
    out = __import__("ray_tpu_torch.loadgen", fromlist=["to_gate_json"]).to_gate_json(
        closed, opened
    )
    for key in (
        "serve_rps",
        "serve_p50_ms",
        "serve_p99_ms",
        "serve_p999_ms",
        "serve_goodput_rps",
        "serve_offered_rps",
        "serve_shed",
        "serve_deadline_cut",
        "serve_overruns",
        "serve_errors",
    ):
        assert key in out, key
    assert out["serve_rps"] > 0
    assert out["serve_overruns"] == 0 and out["serve_errors"] == 0


# -- continuous-batching edges (no cluster) -----------------------------------


def _batch_queue(method, max_batch_size, wait_s, concurrent=1):
    from ray_tpu_torch.serve._private.replica import _BatchQueue, _BatchStats

    stats = _BatchStats()
    return _BatchQueue(method, max_batch_size, wait_s, concurrent, stats), stats


def test_batch_of_one_flushes_on_wait_timeout():
    async def main():
        async def method(xs):
            return [x + 1 for x in xs]

        bq, stats = _batch_queue(method, 8, 0.02)
        try:
            assert await bq.submit(41) == 42
        finally:
            bq.close()
        d = stats.to_dict()
        assert d["batches"] == 1 and d["size_max"] == 1

    asyncio.run(main())


def test_full_batch_dispatches_without_waiting():
    async def main():
        calls = []

        async def method(xs):
            calls.append(list(xs))
            return [x * 2 for x in xs]

        # Wait window long enough that a split would be visible: reaching
        # max_batch_size must dispatch immediately, not after the window.
        bq, stats = _batch_queue(method, 4, 5.0)
        try:
            out = await asyncio.wait_for(
                asyncio.gather(*(bq.submit(i) for i in range(4))), timeout=2.0
            )
        finally:
            bq.close()
        assert out == [0, 2, 4, 6]
        assert calls == [[0, 1, 2, 3]]
        assert stats.to_dict()["size_max"] == 4

    asyncio.run(main())


def test_straggler_joins_batch_within_wait_window():
    async def main():
        calls = []

        async def method(xs):
            calls.append(list(xs))
            return list(xs)

        bq, stats = _batch_queue(method, 8, 0.3)
        try:
            t1 = asyncio.ensure_future(bq.submit("a"))
            await asyncio.sleep(0.05)  # well inside the 0.3s window
            t2 = asyncio.ensure_future(bq.submit("b"))
            assert await asyncio.gather(t1, t2) == ["a", "b"]
        finally:
            bq.close()
        assert calls == [["a", "b"]]
        d = stats.to_dict()
        assert d["batches"] == 1 and d["size_max"] == 2

    asyncio.run(main())


def test_batch_result_length_mismatch_is_typed_error():
    async def main():
        async def method(xs):
            return [1]  # wrong length for a batch of 2

        bq, _ = _batch_queue(method, 2, 1.0)
        try:
            results = await asyncio.gather(
                bq.submit("a"), bq.submit("b"), return_exceptions=True
            )
        finally:
            bq.close()
        assert all(isinstance(r, TypeError) for r in results)

    asyncio.run(main())


def test_cancelled_waiter_is_dropped_at_formation():
    """A request cancelled while still queued must never occupy a batch
    slot (the pump skips done futures when forming)."""

    async def main():
        gate = asyncio.Event()
        seen = []

        async def method(xs):
            seen.append(list(xs))
            await gate.wait()
            return list(xs)

        bq, _ = _batch_queue(method, 1, 0.0, concurrent=1)
        try:
            ta = asyncio.ensure_future(bq.submit("a"))
            await asyncio.sleep(0.05)  # [a] dispatched, holds the only slot
            tb = asyncio.ensure_future(bq.submit("b"))
            tc = asyncio.ensure_future(bq.submit("c"))
            await asyncio.sleep(0.05)  # [b] formed (awaiting slot), c queued
            tc.cancel()
            with pytest.raises(asyncio.CancelledError):
                await tc
            gate.set()
            assert await ta == "a"
            assert await tb == "b"
            assert await bq.submit("d") == "d"
        finally:
            bq.close()
        assert seen == [["a"], ["b"], ["d"]]

    asyncio.run(main())


# -- autoscaler hysteresis (no cluster) ---------------------------------------


def _autoscale_fixture():
    from ray_tpu_torch.serve._private.common import DeploymentID
    from ray_tpu_torch.serve._private.controller import _DeploymentState
    from ray_tpu_torch.serve.schema import AutoscalingConfig

    ac = AutoscalingConfig(
        min_replicas=1,
        max_replicas=5,
        target_ongoing_requests=2.0,
        upscale_delay_s=1.0,
        downscale_delay_s=2.0,
        look_back_period_s=10.0,
    )
    state = _DeploymentState(DeploymentID("d"), {"config": {}})
    state.config.autoscaling_config = ac
    return state, ac


def test_autoscale_upscale_requires_sustained_load():
    from ray_tpu_torch.serve._private.controller import autoscale_tick

    state, ac = _autoscale_fixture()
    state.metrics_window.append((0.0, 8))  # desired = ceil(8/2) = 4
    assert autoscale_tick(state, ac, 0.0) is None  # timer just started
    state.metrics_window.append((0.5, 8))
    assert autoscale_tick(state, ac, 0.5) is None  # 0.5s < upscale_delay 1s
    state.metrics_window.append((1.1, 8))
    assert autoscale_tick(state, ac, 1.1) == 4  # held past the delay
    state.current_target = 4
    assert state.target_replicas == 4


def test_autoscale_downscale_has_longer_fuse():
    from ray_tpu_torch.serve._private.controller import autoscale_tick

    state, ac = _autoscale_fixture()
    state.current_target = 4
    state.metrics_window.append((20.0, 0))
    assert autoscale_tick(state, ac, 20.0) is None
    state.metrics_window.append((21.0, 0))
    assert autoscale_tick(state, ac, 21.0) is None  # 1s < downscale_delay 2s
    state.metrics_window.append((22.5, 0))
    assert autoscale_tick(state, ac, 22.5) == 1  # clamped to min_replicas

    # And never below min_replicas even from min.
    state.current_target = 1
    state.metrics_window.append((23.0, 0))
    assert autoscale_tick(state, ac, 23.0) is None


def test_autoscale_flapping_load_resets_hysteresis_timer():
    from ray_tpu_torch.serve._private.controller import autoscale_tick

    state, ac = _autoscale_fixture()
    state.metrics_window = [(0.0, 8)]
    assert autoscale_tick(state, ac, 0.0) is None  # above-timer starts
    # Load falls back to target before the delay elapses: timer must reset.
    state.metrics_window = [(0.6, 2)]
    assert autoscale_tick(state, ac, 0.6) is None
    assert state.above_since is None
    # Load spikes again: the delay restarts from here, not from t=0.
    state.metrics_window = [(0.8, 8)]
    assert autoscale_tick(state, ac, 0.8) is None
    state.metrics_window.append((1.5, 8))
    assert autoscale_tick(state, ac, 1.5) is None  # 0.7s < 1s
    state.metrics_window.append((1.9, 8))
    assert autoscale_tick(state, ac, 1.9) == 4


def test_autoscale_queue_ewma_drives_scaling_when_ongoing_saturates():
    """Queued (not-yet-absorbed) load must scale the deployment even when
    per-replica ongoing counts plateau at max_ongoing_requests."""
    from ray_tpu_torch.serve._private.controller import autoscale_tick

    state, ac = _autoscale_fixture()
    state.queue_ewma = 6.0  # routers report deep queues
    state.metrics_window = [(0.0, 0)]
    assert autoscale_tick(state, ac, 0.0) is None
    state.metrics_window.append((1.1, 0))
    assert autoscale_tick(state, ac, 1.1) == 3  # ceil(6/2)


def test_autoscale_empty_window_is_a_no_op():
    from ray_tpu_torch.serve._private.controller import autoscale_tick

    state, ac = _autoscale_fixture()
    assert autoscale_tick(state, ac, 100.0) is None
    # Stale samples beyond look_back are pruned, leaving a no-op.
    state.metrics_window = [(0.0, 8)]
    assert autoscale_tick(state, ac, 100.0) is None
    assert state.metrics_window == []


def test_replica_set_evict_drops_corpse_and_wakes_queued():
    """A data-plane-observed death must take effect immediately: the corpse
    leaves the set, its phantom ongoing slots vanish, affinity pins are
    released, and queued pickers wake up to re-route."""

    async def run():
        from ray_tpu_torch.serve._private.common import RunningReplicaInfo
        from ray_tpu_torch.serve._private.router import _ReplicaSet

        rs = _ReplicaSet()
        infos = [
            RunningReplicaInfo(
                replica_id_str=f"r{i}",
                deployment_id_str="default#d",
                actor_id=f"a{i}",
                max_ongoing_requests=4,
                max_queued_requests=32,
            )
            for i in range(2)
        ]
        rs.update(infos)
        rs.ongoing["r0"] = 3
        rs.model_affinity["m"] = "r0"
        rs.slot_freed.clear()

        rs.evict("r0")
        assert [r.replica_id_str for r in rs.replicas] == ["r1"]
        assert rs.evicted == 1
        assert "r0" not in rs.ongoing
        assert "m" not in rs.model_affinity
        assert rs.slot_freed.is_set()  # queued pickers must re-run the pick
        assert rs.nonempty.is_set()  # a live replica remains

        # Unknown / already-evicted ids are no-ops.
        rs.evict("r0")
        assert rs.evicted == 1

        rs.evict("r1")
        assert rs.replicas == []
        assert rs.evicted == 2
        assert not rs.nonempty.is_set()  # empty set parks new arrivals

    asyncio.run(run())


# -- cluster integration ------------------------------------------------------


@pytest.fixture
def serve_cluster(torch_cluster):  # noqa: F811
    from ray_tpu_torch import serve

    yield serve
    serve.shutdown()


def _meta():
    return {"call_method": "__call__", "request_id": "", "multiplexed_model_id": ""}


def test_admission_control_sheds_typed(serve_cluster):
    serve = serve_cluster
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.serve import handle as handle_mod
    from ray_tpu_torch.serve._private.common import DeploymentOverloadedError

    @serve.deployment(
        num_replicas=1, max_ongoing_requests=1, max_queued_requests=2
    )
    class Slow:
        async def __call__(self, x):
            await asyncio.sleep(0.3)
            return x

    serve.run(Slow.bind(), route_prefix=None)
    dep = "default#Slow"

    async def burst():
        router = await handle_mod._get_router()
        # Warm the router: the queue cap rides the replica info delivered by
        # long-poll, so until the first push arrives the router only has the
        # config-default cap. One request waits that push out (and seeds the
        # service-time EWMA for the deadline-unreachable probe below).
        assert await router.assign_request(
            dep, _meta(), (-1,), {}, timeout_s=10.0
        ) == -1

        async def one(i):
            try:
                return await router.assign_request(
                    dep, _meta(), (i,), {}, timeout_s=10.0
                )
            except DeploymentOverloadedError as e:
                return e

        results = await asyncio.gather(*(one(i) for i in range(10)))

        # With the EWMA warmed by the completions above, a budget smaller
        # than the service estimate is shed at the door.
        tight_reason = None
        try:
            await router.assign_request(dep, _meta(), (99,), {}, timeout_s=0.02)
        except DeploymentOverloadedError as e:
            tight_reason = e.reason
        return results, tight_reason, router.stats()[dep]

    results, tight_reason, stats = worker_mod.global_worker.run_async(
        burst(), timeout=60
    )
    sheds = [r for r in results if isinstance(r, DeploymentOverloadedError)]
    oks = [
        (i, r) for i, r in enumerate(results) if not isinstance(r, Exception)
    ]
    # 1 in flight + 2 queued admitted; the rest of the burst is shed typed.
    assert sheds, f"expected queue-cap sheds, got {results}"
    assert all(e.reason == "queue_full" for e in sheds)
    assert oks and all(r == i for i, r in oks)
    assert tight_reason == "deadline_unreachable"
    assert stats["shed_queue_full"] == len(sheds)
    assert stats["shed_deadline"] >= 1
    assert stats["completed"] >= len(oks)


def test_batched_deployment_end_to_end(serve_cluster):
    serve = serve_cluster

    @serve.deployment(
        num_replicas=1,
        max_ongoing_requests=16,
        max_batch_size=4,
        batch_wait_timeout_s=0.05,
    )
    class Tripler:
        async def __call__(self, batch):
            assert isinstance(batch, list)
            return [b * 3 for b in batch]

    handle = serve.run(Tripler.bind(), route_prefix=None)
    responses = [handle.remote(i) for i in range(8)]
    assert [r.result(timeout_s=30) for r in responses] == [
        i * 3 for i in range(8)
    ]


def test_loadgen_smoke_no_overruns():
    """End-to-end loadgen smoke: overload comes back as typed sheds or
    deadline cuts — zero admitted requests overrun, zero untyped errors."""
    from ray_tpu_torch import loadgen

    out = loadgen.run_smoke(
        closed_concurrency=8,
        closed_duration_s=0.6,
        open_duration_s=0.6,
        overload_factor=5.0,
        num_replicas=2,
        verbose=False,
    )
    assert out["serve_rps"] > 0
    assert out["serve_offered_rps"] > out["serve_goodput_rps"]
    assert out["serve_overruns"] == 0
    assert out["serve_errors"] == 0
    # Overload must be visible as typed backpressure.
    assert out["serve_shed"] + out["serve_deadline_cut"] > 0


# -- the same scripted inputs through both packages ---------------------------

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _both(fn, *args):
    """fn(pkg, *args) for the JAX package and the port; both results."""
    return [fn(pkg, *args) for pkg in PACKAGES]


def test_percentile_parity():
    rng = np.random.RandomState(0)
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0)
    for n in (0, 1, 2, 7, 100, 1001):
        vals = sorted(rng.exponential(50.0, n).tolist())
        ref, port = _both(lambda pkg: [_mod(pkg, "loadgen").percentile(vals, q) for q in qs])
        assert port == ref


def _outcomes(pkg: str, script) -> dict:
    """A PhaseResult's buckets after one scripted outcome per request."""
    loadgen = _mod(pkg, "loadgen")
    rpc = _mod(pkg, "_private.rpc")
    config = _mod(pkg, "_private.common").config
    overloaded = _mod(pkg, "serve._private.common").DeploymentOverloadedError

    async def one(kind):
        if kind == "late":
            await asyncio.sleep(0.05 + config.rpc_deadline_grace_s + 0.05)
        elif kind == "queue_full":
            raise overloaded("d", "queue_full", "full")
        elif kind == "deadline":
            raise overloaded("d", "deadline_unreachable", "x")
        elif kind == "cut":
            raise rpc.DeadlineExceeded("late")
        elif kind == "timeout":
            raise asyncio.TimeoutError()
        elif kind == "boom":
            raise RuntimeError("kaput")
        return 1

    async def main():
        res = loadgen.PhaseResult("t")
        for kind in script:
            await loadgen._issue_one(_ScriptedRouter(lambda k=kind: one(k)), "d", 0, 0.05, res)
        return res

    res = asyncio.run(main())
    s = res.summary()
    return {k: s[k] for k in ("issued", "ok", "shed_queue_full", "shed_deadline",
                              "deadline_cut", "overruns", "errors", "error_samples")} | {
        "shed": res.shed, "n_latencies": len(res.latencies_ms)}


def test_loadgen_outcome_buckets_parity():
    rng = np.random.RandomState(1)
    kinds = ("ok", "queue_full", "deadline", "cut", "timeout", "boom")
    script = [kinds[i] for i in rng.randint(0, len(kinds), 40)] + ["late", "late"]
    ref, port = _both(_outcomes, script)
    assert port == ref
    assert port["overruns"] == 2 and port["issued"] == 42


def _batches(pkg: str, scenario: str):
    """The batches one replica batch queue forms from a scripted arrival
    pattern, and its stats (queue ages aside: they are clock readings)."""
    replica = _mod(pkg, "serve._private.replica")

    async def main():
        calls = []

        async def method(xs):
            calls.append(list(xs))
            await asyncio.sleep(0.01)
            return [x * 10 for x in xs]

        stats = replica._BatchStats()
        if scenario == "burst":  # 10 at once, batches of up to 4
            bq = replica._BatchQueue(method, 4, 0.05, 2, stats)
            tasks = [asyncio.ensure_future(bq.submit(i)) for i in range(10)]
        elif scenario == "cancelled":  # two of six cancelled while queued
            bq = replica._BatchQueue(method, 4, 0.05, 1, stats)
            tasks = [asyncio.ensure_future(bq.submit(i)) for i in range(6)]
            await asyncio.sleep(0)
            for i in (1, 4):
                tasks[i].cancel()
        else:  # "stragglers": three join within the window, two come late
            bq = replica._BatchQueue(method, 8, 0.25, 2, stats)
            tasks = []
            for i, delay in enumerate((0.0, 0.02, 0.02, 0.6, 0.02)):
                await asyncio.sleep(delay)
                tasks.append(asyncio.ensure_future(bq.submit(i)))
        try:
            out = await asyncio.wait_for(asyncio.gather(*tasks, return_exceptions=True), 10)
        finally:
            bq.close()
        d = stats.to_dict()
        return calls, [r if not isinstance(r, BaseException) else type(r).__name__ for r in out], {
            k: d[k] for k in ("batches", "requests", "size_max", "size_avg")}

    return asyncio.run(main())


@pytest.mark.parametrize("scenario", ["burst", "cancelled", "stragglers"])
def test_batch_formation_parity(scenario):
    ref, port = _both(_batches, scenario)
    assert port == ref
    expected = {"burst": [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]],
                "cancelled": [[0, 2, 3, 5]],
                "stragglers": [[0, 1, 2], [3, 4]]}[scenario]
    assert port[0] == expected


def _autoscale_decisions(pkg: str, seq) -> list:
    """autoscale_tick over one (time, ongoing, queue EWMA) sequence: each
    tick's decision, the target, both hysteresis timers and the window."""
    common = _mod(pkg, "serve._private.common")
    controller = _mod(pkg, "serve._private.controller")
    schema = _mod(pkg, "serve.schema")
    ac = schema.AutoscalingConfig(min_replicas=1, max_replicas=6, target_ongoing_requests=2.0,
                                  upscale_delay_s=1.0, downscale_delay_s=2.5,
                                  look_back_period_s=3.0)
    state = controller._DeploymentState(common.DeploymentID("d"), {"config": {}})
    state.config.autoscaling_config = ac
    out = []
    for t, ongoing, queued in seq:
        state.metrics_window.append((t, ongoing))
        state.queue_ewma = queued
        decision = controller.autoscale_tick(state, ac, t)
        if decision is not None:
            state.current_target = decision
        out.append((decision, state.target_replicas, state.above_since, state.below_since,
                    len(state.metrics_window)))
    return out


def test_autoscaler_decisions_parity():
    rng = np.random.RandomState(2)
    load = np.concatenate([rng.poisson(lam, 40) for lam in (1, 9, 3, 14, 0, 6)])
    seq = [(0.25 * i, int(v), float(q)) for i, (v, q) in
           enumerate(zip(load, rng.exponential(1.0, len(load)).round(3)))]
    ref, port = _both(_autoscale_decisions, seq)
    assert port == ref
    decisions = [d for d, *_ in port if d is not None]
    assert len(set(decisions)) >= 3, decisions  # it scaled up and down


class _Clock:
    def __init__(self):
        self.t = 100.0

    def time(self) -> float:
        return self.t


def _router_decisions(pkg: str, seed: int) -> list:
    """A seeded script of service-time observations, deadline admissions and
    replica picks (occupancy and model ids drawn, module random seeded
    before each pick) on one replica set; then a burst against full
    replicas, where the queue cap sheds. Every decision, in order."""
    common = _mod(pkg, "serve._private.common")
    router_mod = _mod(pkg, "serve._private.router")
    overloaded = common.DeploymentOverloadedError
    dep = "default#d"

    async def main():
        router = router_mod.Router(None, None)
        router._watched[dep] = True  # no controller: the set is scripted
        rs = router._replica_set(dep)
        infos = [common.RunningReplicaInfo(replica_id_str=f"r{i}", deployment_id_str=dep,
                                           actor_id=f"a{i}", max_ongoing_requests=3,
                                           max_queued_requests=4) for i in range(3)]
        rs.update(infos)
        clock, rng, out = _Clock(), np.random.RandomState(seed), []
        for step in range(300):
            op = rng.randint(4)
            if op == 0:
                rs.observe_service_time(float(rng.uniform(0.01, 0.5)))
                out.append(("ewma", rs.ewma_service_s))
            elif op == 1:
                budget = float(rng.uniform(0.0, 1.0))
                try:
                    router._admit_deadline(rs, dep, clock.t + budget, clock)
                    out.append(("admit", budget))
                except overloaded as e:
                    out.append(("shed", e.reason, budget))
            elif op == 2:
                for info in infos:
                    rs.ongoing[info.replica_id_str] = int(rng.randint(0, 4))
                model = ("", "m1", "m2")[rng.randint(3)]
                random.seed(step)
                pick = router._pick_replica(rs, model or None)
                out.append(("pick", pick and pick.replica_id_str, sorted(rs.model_affinity.items())))
            else:
                clock.t += float(rng.uniform(0.0, 0.1))
        # Every replica full: four requests queue, the rest are shed typed;
        # then a slot frees on r1 and the queued requests are handed r1.
        rs.ewma_service_s = None
        for info in infos:
            rs.ongoing[info.replica_id_str] = 3
        loop = asyncio.get_running_loop()
        meta = {"call_method": "__call__", "multiplexed_model_id": ""}
        tasks = [asyncio.ensure_future(router._acquire_replica(dep, meta, loop.time() + 5.0))
                 for _ in range(7)]
        await asyncio.sleep(0.05)
        shed = [t.exception().reason for t in tasks if t.done() and t.exception()]
        out.append(("queued", rs.queued, "shed", shed))
        rs.ongoing["r1"] = 2
        rs.slot_freed.set()
        await asyncio.sleep(0.05)
        got = [t.result()[1].replica_id_str for t in tasks if t.done() and not t.exception()]
        out.append(("acquired", got, "queued", rs.queued))
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        stats = router.stats()[dep]
        out.append(("stats", {k: stats[k] for k in ("shed_queue_full", "shed_deadline",
                                                     "completed")}))
        return out

    return asyncio.run(main())


def test_router_admission_and_picks_parity():
    ref, port = _both(_router_decisions, 3)
    assert port == ref
    kinds = {row[0] for row in port}
    assert {"admit", "shed", "pick", "ewma"} <= kinds
    queued = next(row for row in port if row[0] == "queued")
    assert queued[1] == 4 and queued[3] == ["queue_full"] * 3
    # _acquire_replica takes no ongoing count (assign_request does): every
    # queued request sees r1's freed slot.
    assert next(row for row in port if row[0] == "acquired")[1] == ["r1"] * 4
