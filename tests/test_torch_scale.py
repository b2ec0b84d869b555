"""The simulated cluster (ray_tpu_torch._private.sim_cluster) on the port:
the four test_sim_* cases of tests/test_scale.py at the reference's sizes
— 10,000 leases over 500 in-process raylets, lease latency at 50 against
500 nodes, the autoscaler driving SimNodeProvider past 500 nodes, and a
1000-raylet reconnect storm after the GCS host is lost.

The file's seven other cases, the reference's scalability envelope on
real multi-process clusters (test_10k_queued_tasks, test_200_actors,
test_50_placement_groups, test_100k_queued_tasks, test_1000_actors,
test_200_placement_groups, test_256mb_broadcast_to_8_nodes), have their
twins in tests/test_torch_scale_envelope.py, a file of its own so that
the suite's `--dist loadfile` runs them on another worker."""

import time

import pytest


# -- simulated-cluster scheduler scale (ray_tpu_torch._private.sim_cluster) --------


def _sim_schedule(cluster, client, n_tasks, concurrency=64, latencies=None):
    """Run n_tasks 1-CPU lease/release cycles round-robin over every node
    as the entry point, optionally recording per-lease grant latency."""
    import asyncio

    async def schedule_all():
        sem = asyncio.Semaphore(concurrency)
        entries = [tuple(r.addr) for r in cluster.raylets.values()]
        loop = asyncio.get_running_loop()

        async def one(i):
            async with sem:
                t0 = loop.time()
                grant = await client.lease(
                    {"CPU": 1.0}, entry_addr=entries[i % len(entries)]
                )
                if latencies is not None:
                    latencies.append(loop.time() - t0)
                await client.release(grant)

        await asyncio.gather(*(one(i) for i in range(n_tasks)))

    cluster.run(schedule_all(), timeout=600)


@pytest.mark.timeout(900)
def test_sim_500_nodes_10k_tasks():
    """The headline bar: 500 in-process raylets stand up and 10,000 lease
    cycles schedule through the real spillback protocol."""
    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    cluster = SimCluster(500).start()
    try:
        assert len(cluster.raylets) == 500
        client = SimLeaseClient(cluster)
        t0 = time.perf_counter()
        _sim_schedule(cluster, client, 10_000)
        dt = time.perf_counter() - t0
        print(
            f"\n10k tasks over 500 sim nodes in {dt:.1f}s "
            f"({10_000 / dt:.0f} leases/s)"
        )
        cluster.run(client.close(), timeout=30)
    finally:
        cluster.shutdown()


def _median_lease_latency_s(num_nodes, samples=1500):
    import statistics

    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    cluster = SimCluster(num_nodes).start()
    try:
        client = SimLeaseClient(cluster)
        _sim_schedule(cluster, client, min(samples, 500))  # warmup
        lat = []
        _sim_schedule(cluster, client, samples, concurrency=16, latencies=lat)
        cluster.run(client.close(), timeout=30)
        return statistics.median(lat)
    finally:
        cluster.shutdown()


@pytest.mark.timeout(900)
def test_sim_lease_latency_o_k_not_o_n():
    """The per-lease scheduling decision is O(k), not O(cluster): median
    grant latency at 500 nodes stays within 2x of 50 nodes. (The old
    GetAllNodes-per-lease path was O(N) and blew this bound by an order of
    magnitude.) A 250us absolute floor keeps sub-millisecond timing noise
    from flaking the ratio on a fast host."""
    m50 = _median_lease_latency_s(50)
    m500 = _median_lease_latency_s(500)
    print(f"\nmedian lease latency: 50 nodes {m50 * 1e3:.2f}ms, "
          f"500 nodes {m500 * 1e3:.2f}ms ({m500 / m50:.2f}x)")
    assert m500 <= max(2.0 * m50, m50 + 250e-6), (
        f"lease latency grew {m500 / m50:.1f}x from 50 to 500 nodes "
        f"({m50 * 1e3:.2f}ms -> {m500 * 1e3:.2f}ms): scheduling is "
        "scanning the cluster again"
    )


@pytest.mark.timeout(900)
def test_sim_autoscaler_scales_to_500_nodes():
    """The autoscaler control loop drives the sim provider past 500 nodes
    on sustained synthetic demand, then runs a clean steady-state round on
    real harness stats."""
    from ray_tpu_torch._private.sim_cluster import SimCluster, SimNodeProvider
    from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig

    target = 500
    cluster = SimCluster(16).start()
    try:
        provider = SimNodeProvider(
            cluster,
            node_types={
                "sim.cpu4": {"resources": {"CPU": 4}, "max_workers": 2000}
            },
        )

        def state():
            stats = cluster.node_stats()
            if len(cluster.raylets) < target:
                # Sustained unmet demand until the fleet reaches target.
                stats[0]["pending_leases"] = 256
                stats[0]["pending_demand"] = [{"CPU": 10000}] * 64
            return stats

        asc = Autoscaler(
            provider,
            AutoscalerConfig(
                upscale_delay_s=0.0,
                idle_timeout_s=3600.0,
                max_launches_per_round=64,
            ),
            state_fn=state,
        )
        t0 = time.perf_counter()
        rounds = 0
        while len(cluster.raylets) < target and rounds < 40:
            asc.update()
            rounds += 1
        dt = time.perf_counter() - t0
        assert len(cluster.raylets) >= target, (
            f"autoscaler stalled at {len(cluster.raylets)} nodes "
            f"after {rounds} rounds"
        )
        print(
            f"\nautoscaled 16 -> {len(cluster.raylets)} sim nodes in "
            f"{rounds} rounds / {dt:.1f}s"
        )
        # Steady state: a round on real stats must neither launch nor kill.
        out = asc.update()
        assert out["launched"] == 0 and out["terminated"] == 0
    finally:
        cluster.shutdown()


@pytest.mark.timeout(300)
def test_sim_ha_boot_survives_a_loop_stall(monkeypatch):
    """An HA sim's boot on a loaded host: right after a lease renewal, while
    the raylets register, the sim's loop stalls past the leader's lease (2 s
    against 1 + 1/3 s). Its standby watches the lease on that same loop, so
    armed before the boot it reads the stall as the leader's death and
    promotes mid-boot (the storm test's failure at start). Armed once every
    node has registered, it does not: start() completes with every node
    registered under the first leader, and the standby still promotes when
    the GCS host is then lost."""
    import asyncio
    import os
    import shutil
    import tempfile

    from ray_tpu_torch._private import gcs_ha
    from ray_tpu_torch._private.sim_cluster import SimCluster

    n = 64  # two waves of _BOOT_CONCURRENCY
    booted, stalled = [], []
    add_node, write_leadership = SimCluster._add_node_async, gcs_ha.write_leadership

    async def slow_add_node(self, resources):
        raylet = await add_node(self, resources)
        booted.append(raylet.node_id)
        await asyncio.sleep(0.5)  # the first wave holds the boot slots past a renewal
        return raylet

    def stalling_write(store, term, addr):
        write_leadership(store, term, addr)
        if booted and len(booted) < n and not stalled:
            stalled.append(len(booted))
            time.sleep(2.0)  # the whole loop: raylets, leader and standby

    monkeypatch.setattr(SimCluster, "_add_node_async", slow_add_node)
    monkeypatch.setattr(gcs_ha, "write_leadership", stalling_write)
    tmp = tempfile.mkdtemp(prefix="ha_stall_")
    cluster = SimCluster(
        n,
        persist_path=os.path.join(tmp, "gcs.wal"),
        ha=True,
        env={
            "RAY_TPU_GCS_LEADER_LEASE_S": "1.0",
            "RAY_TPU_GCS_STANDBY_POLL_S": "0.05",
        },
    )
    try:
        cluster.start()
        first = cluster.gcs_server
        assert stalled and len(cluster.raylets) == n
        assert not cluster.gcs_standby.promoted.is_set() and not first.fenced
        assert cluster.run(cluster.kill_gcs_host_async(), timeout=60)
        assert cluster.gcs_server is not first and cluster.gcs_standby is not None
    finally:
        cluster.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.timeout(1800)
def test_sim_1000_node_failover_reconnect_storm():
    """HA failover at the scale bar: 1000 in-process raylets lose the GCS
    *machine* (process + its replicated-log member), the warm standby
    promotes from the follower log, and the full 1000-raylet reconnect
    wave re-targets the new leader through the leader file — converging to
    a complete ALIVE node view without melting the control plane."""
    import asyncio
    import os
    import shutil
    import tempfile

    from ray_tpu_torch._private import gcs_ha, rpc
    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    n = 1000
    tmp = tempfile.mkdtemp(prefix="ha_scale_")
    cluster = SimCluster(
        n,
        persist_path=os.path.join(tmp, "gcs.wal"),
        ha=True,
        env={
            "RAY_TPU_GCS_LEADER_LEASE_S": "1.0",
            "RAY_TPU_GCS_STANDBY_POLL_S": "0.05",
        },
    ).start()
    try:
        assert len(cluster.raylets) == n
        client = SimLeaseClient(cluster)
        _sim_schedule(cluster, client, 500)  # warm: every node registered
        t0 = time.perf_counter()
        assert cluster.run(cluster.kill_gcs_host_async(), timeout=120)
        t_promote = time.perf_counter() - t0

        async def converged() -> float:
            # Probe through the leader file like the raylets do: under the
            # reconnect wave a promoted leader can miss its own lease and a
            # second standby takes over, fencing term N and closing its
            # connections — re-resolve and re-dial instead of dying on the
            # demoted address. GetAllNodes is a read; re-issuing is safe.
            leader_file = cluster.gcs_leader_file()

            async def dial() -> "rpc.Connection":
                addr = gcs_ha.resolve_leader_file(leader_file)
                return await rpc.connect(*(addr or cluster.gcs_addr))

            conn = None
            try:
                deadline = asyncio.get_running_loop().time() + 600
                while True:
                    try:
                        if conn is None:
                            conn = await dial()
                        reply = await conn.call("GetAllNodes", timeout=60)
                    except (rpc.RpcError, OSError):
                        if asyncio.get_running_loop().time() > deadline:
                            raise
                        if conn is not None:
                            await conn.close()
                            conn = None
                        await asyncio.sleep(0.25)
                        continue
                    alive = sum(
                        1 for node in reply["nodes"]
                        if node["state"] == "ALIVE"
                    )
                    if alive >= n:
                        return time.perf_counter() - t0
                    if asyncio.get_running_loop().time() > deadline:
                        raise AssertionError(
                            f"only {alive}/{n} nodes re-registered"
                        )
                    await asyncio.sleep(0.25)
            finally:
                if conn is not None:
                    await conn.close()

        t_converge = cluster.run(converged(), timeout=700)
        # The promoted leader still schedules: a fresh lease burst works.
        _sim_schedule(cluster, client, 500)
        cluster.run(client.close(), timeout=30)
        print(
            f"\n{n}-node failover: promoted in {t_promote:.2f}s, full "
            f"reconnect storm converged in {t_converge:.1f}s"
        )
    finally:
        cluster.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
