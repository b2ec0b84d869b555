"""The reference's tests/test_scheduling_policy.py on the port, case for case
after the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest
fixtures -> ray_tpu_torch.testing's). No case differs.

Scheduling policy fidelity (reference:
src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.cc +
scheduling_options.h SPREAD/NODE_AFFINITY; test shapes mirror
cluster_task_manager_test.cc scenarios)."""

import time
from collections import Counter

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


@pytest.fixture
def three_nodes():
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.connect()
    yield cluster
    cluster.shutdown()


@ray_tpu_torch.remote
def where():
    import os

    return os.environ["RAY_TPU_NODE_ID"]


def test_spread_strategy_uses_all_nodes(three_nodes):
    refs = [
        where.options(scheduling_strategy="SPREAD").remote() for _ in range(12)
    ]
    nodes = Counter(ray_tpu_torch.get(refs, timeout=120))
    # SPREAD must land tasks on every node, not pile onto the head.
    assert len(nodes) == 3, f"SPREAD used only {dict(nodes)}"


def test_hybrid_spills_past_threshold(three_nodes):
    """Hybrid packs locally while below the spread threshold, then moves
    excess load to other nodes — a burst larger than the head node's CPUs
    must not all run on the head."""

    @ray_tpu_torch.remote
    def hold():
        import os
        import time as _t

        _t.sleep(1.5)
        return os.environ["RAY_TPU_NODE_ID"]

    refs = [hold.remote() for _ in range(6)]
    nodes = Counter(ray_tpu_torch.get(refs, timeout=120))
    assert len(nodes) >= 2, f"hybrid never spilled: {dict(nodes)}"


def test_node_affinity_task(three_nodes):
    target = [n["node_id"] for n in ray_tpu_torch.nodes()][-1]
    refs = [
        where.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=target, soft=False
            )
        ).remote()
        for _ in range(4)
    ]
    assert set(ray_tpu_torch.get(refs, timeout=120)) == {target}


def test_node_affinity_hard_missing_node_fails(three_nodes):
    with pytest.raises(Exception, match="affinity target"):
        ray_tpu_torch.get(
            where.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id="f" * 32, soft=False
                )
            ).remote(),
            timeout=60,
        )


# -- locality-aware leasing (reference: locality-aware lease policy) ---------
#
# White-box regressions on the simulated cluster: hints name the raylet
# holding a task's args; the deciding raylet must honor them when the
# holder has room (telemetry hit) and fall back to the normal policy when
# it is saturated (telemetry miss).


def _addr_key(addr):
    return f"{addr[0]}:{addr[1]}"


def test_locality_hint_places_on_arg_holder():
    """Args on node X -> the lease is granted on X when X is feasible, and
    the entry raylet counts a locality hit."""
    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    cluster = SimCluster(8).start()
    try:
        client = SimLeaseClient(cluster)
        nids = sorted(cluster.raylets)
        entry = cluster.raylets[nids[0]]
        target = cluster.raylets[nids[-1]]
        hits0 = entry._tel_locality_hits.v
        grant = cluster.run(
            client.lease(
                {"CPU": 1.0},
                entry_addr=tuple(entry.addr),
                locality={_addr_key(target.addr): 2.0},
            ),
            timeout=30,
        )
        assert tuple(grant["addr"]) == tuple(target.addr), grant
        assert entry._tel_locality_hits.v == hits0 + 1
        cluster.run(client.release(grant), timeout=10)
        cluster.run(client.close(), timeout=10)
    finally:
        cluster.shutdown()


def test_locality_miss_when_holder_saturated():
    """Args on a node with no room -> the hint is a counted miss and the
    regular policy places the lease elsewhere."""
    import asyncio

    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    cluster = SimCluster(4, resources={"CPU": 1.0}).start()
    try:
        client = SimLeaseClient(cluster)
        nids = sorted(cluster.raylets)
        entry = cluster.raylets[nids[0]]
        target = cluster.raylets[nids[-1]]
        tkey = _addr_key(target.addr)

        # Exhaust the arg holder: its single CPU is pinned under a lease.
        pin = cluster.run(
            client.lease({"CPU": 1.0}, entry_addr=tuple(target.addr)),
            timeout=30,
        )
        assert tuple(pin["addr"]) == tuple(target.addr)

        async def holder_seen_saturated():
            # The entry raylet decides from its synced view; wait for the
            # holder's drained availability to reach it (resource report ->
            # GCS -> head broadcast / pulled view) before leasing.
            for _ in range(100):
                entry._view_time = 0.0  # force a fresh GetAllNodes pull
                await entry._cluster_view()
                n = entry._view_map.get(target.node_id)
                head = entry._head_by_addr(tkey)
                # A fully drained resource is omitted from ``available``.
                if (
                    n is not None
                    and n["available"].get("CPU", 0) == 0
                    and (head is None or head["available"].get("CPU", 0) == 0)
                ):
                    return True
                await asyncio.sleep(0.05)
            return False

        assert cluster.run(holder_seen_saturated(), timeout=30), (
            "holder saturation never reached the entry raylet's view"
        )

        misses0 = entry._tel_locality_misses.v
        grant = cluster.run(
            client.lease(
                {"CPU": 1.0},
                entry_addr=tuple(entry.addr),
                locality={tkey: 5.0},
            ),
            timeout=30,
        )
        assert tuple(grant["addr"]) != tuple(target.addr), (
            "lease landed on the saturated arg holder"
        )
        assert entry._tel_locality_misses.v == misses0 + 1
        cluster.run(client.release(grant), timeout=10)
        cluster.run(client.release(pin), timeout=10)
        cluster.run(client.close(), timeout=10)
    finally:
        cluster.shutdown()


# --------------------------------------------- batched lease cancel race


def test_cancel_before_batch_flush_withdraws_locally():
    """A surplus cancel landing between enqueue-into-batch and the flush
    tick must withdraw the entry from the pending LeaseBatch
    (``try_cancel_batched``) instead of sending a CancelWorkerLease for a
    request frame that never went out — the raylet would see a cancel for
    a phantom lease_id."""
    import asyncio

    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.core_worker import LeasePool

    async def go():
        seen = []
        server = rpc.Server("127.0.0.1", 0)

        async def req(conn, p):
            seen.append(("RequestWorkerLease", p["lease_id"]))
            return {"cancelled": True}

        async def cancel(conn, p):
            seen.append(("CancelWorkerLease", p["lease_id"]))

        server.register("RequestWorkerLease", req)
        server.register("CancelWorkerLease", cancel)
        addr = await server.start()
        conn = await rpc.connect(*addr)

        class _Core:
            raylet_conn = conn
            job_id = "job-test"

        lp = LeasePool(_Core())
        key = lp.shape_key({"CPU": 1}, None, -1, None)
        pool = lp._pool(key, {"CPU": 1}, None, -1, None)
        waiter = asyncio.get_running_loop().create_future()
        pool.pending.append(("waiter", waiter, None))
        try:
            lp._pump(key, pool)  # spawns one _request_lease
            assert pool.inflight == 1
            # One tick: the request coroutine runs up to its reply await,
            # queueing its entry into this tick's (still unsent) batch.
            await asyncio.sleep(0)
            assert len(conn._batch_entries) == 1, "request must sit in the unsent batch"
            # The work disappears in the same tick (acquire cancelled).
            waiter.cancel()
            pool.pending.clear()
            lp._pump(key, pool)  # surplus trim races the flush
            assert pool.inflight == 0
            assert conn._batch_entries == [], "entry must be withdrawn from the batch"
            assert pool.inflight_ids == set()
            assert pool.inflight_reqs == {}
            # Let the flush tick and any stray frames land.
            await asyncio.sleep(0.2)
            assert seen == [], f"nothing may reach the wire, saw {seen}"
            # The withdrawn coroutine must not double-decrement the slot.
            assert pool.inflight == 0
        finally:
            await conn.close()
            await server.stop()

    asyncio.run(go())


def test_cancel_after_batch_flush_sends_wire_cancel():
    """Contrast case: once the batch has flushed, the surplus trim must
    fall back to a wire CancelWorkerLease — the raylet holds the queued
    request and must be told to drop it."""
    import asyncio

    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.core_worker import LeasePool

    async def go():
        seen = []
        cancelled = asyncio.Event()
        server = rpc.Server("127.0.0.1", 0)

        async def req(conn, p):
            seen.append(("RequestWorkerLease", p["lease_id"]))
            await cancelled.wait()  # park until the cancel lands
            return {"cancelled": True}

        async def cancel(conn, p):
            seen.append(("CancelWorkerLease", p["lease_id"]))
            cancelled.set()

        server.register("RequestWorkerLease", req)
        server.register("CancelWorkerLease", cancel)
        addr = await server.start()
        conn = await rpc.connect(*addr)

        class _Core:
            raylet_conn = conn
            job_id = "job-test"

        lp = LeasePool(_Core())
        key = lp.shape_key({"CPU": 1}, None, -1, None)
        pool = lp._pool(key, {"CPU": 1}, None, -1, None)
        waiter = asyncio.get_running_loop().create_future()
        pool.pending.append(("waiter", waiter, None))
        try:
            lp._pump(key, pool)
            await asyncio.sleep(0.1)  # batch flushes; request reaches server
            assert ("RequestWorkerLease", next(iter(pool.inflight_ids))) in seen
            waiter.cancel()
            pool.pending.clear()
            lp._pump(key, pool)
            await asyncio.wait_for(cancelled.wait(), 5)
            await asyncio.sleep(0.1)  # cancelled reply drains
            assert [m for m, _ in seen] == ["RequestWorkerLease", "CancelWorkerLease"]
            assert pool.inflight == 0
            assert pool.inflight_ids == set()
            assert pool.inflight_reqs == {}
        finally:
            await conn.close()
            await server.stop()

    asyncio.run(go())
