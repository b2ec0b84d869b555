"""The reference's tests/test_gcs_ha.py on the port, case for case after the
rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest fixtures
-> ray_tpu_torch.testing's). No case differs.

Highly-available control plane (gcs_ha.py + replicated gcs_store):
warm-standby failover, epoch-fenced leadership, leader-file re-targeting,
and the resubscribe/term protocol that keeps clients consistent across a
promotion (docs/fault_tolerance.md "HA deployment")."""

import asyncio
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401
from ray_tpu_torch._private import gcs_ha, rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.common import config
from ray_tpu_torch._private.gcs import GcsClient, GcsServer
from ray_tpu_torch._private.gcs_store import drop_host


@pytest.fixture
def ha_env(monkeypatch, tmp_path):
    monkeypatch.setenv("RAY_TPU_GCS_PERSIST_BACKEND", "replicated")
    monkeypatch.setenv("RAY_TPU_GCS_LEADER_LEASE_S", "1.0")
    monkeypatch.setenv("RAY_TPU_GCS_STANDBY_POLL_S", "0.05")
    config.refresh()
    yield str(tmp_path / "gcs.wal")
    # Undo the env BEFORE refreshing: monkeypatch's own teardown runs after
    # this fixture body, which would leave the restored env uncached.
    monkeypatch.undo()
    config.refresh()


def test_failover_preserves_state_and_retargets_clients(ha_env):
    """Tentpole e2e: primary dies WITH its disk; the warm standby promotes
    from the follower log at term+1, the leader file flips, and a client
    with a file resolver re-targets — acknowledged state fully intact."""
    path = ha_env
    leader_file = gcs_ha.leader_file_path(path)

    async def go():
        primary = GcsServer(session_name="ha", persist_path=path,
                            persist_backend="replicated")
        await primary.start()
        assert primary.leader_term == 1
        standby = gcs_ha.GcsStandby(session_name="ha", persist_path=path)
        await standby.start()

        conn = await rpc.connect(*primary.server.address)
        client = GcsClient(conn, resolver=gcs_ha.file_resolver(leader_file))
        await client.call("KVPut", {"ns": "", "key": "k", "value": b"v"})

        await primary.crash()
        drop_host(path)  # the primary's machine (and log member) is gone
        await asyncio.wait_for(standby.promoted.wait(), 30)
        new = standby.server
        assert new.leader_term == 2
        assert gcs_ha.resolve_leader_file(leader_file) == new.server.address

        # The same client object follows the leader file to the new server.
        reply = await client.call("KVGet", {"ns": "", "key": "k"},
                                  timeout=30)
        assert reply.get("value") == b"v"
        lead = gcs_ha.read_leadership(new.store)
        assert lead["term"] == 2

        await client.close()
        await standby.stop()

    asyncio.run(go())


def test_fenced_old_primary_rejects_writes_and_demotes(ha_env, monkeypatch):
    """Satellite (c): a partitioned old primary that keeps writing after its
    lease expired gets every write rejected with a typed StaleLeaderError,
    never pollutes the new leader's tables, and exits its serve loop."""
    # A huge lease suppresses the old primary's own renewal beat, so the
    # test (not a background timer) drives the first fenced write.
    monkeypatch.setenv("RAY_TPU_GCS_LEADER_LEASE_S", "60")
    config.refresh()
    path = ha_env

    async def go():
        old = GcsServer(session_name="ha", persist_path=path,
                        persist_backend="replicated")
        await old.start()
        conn = await rpc.connect(*old.server.address)  # raw: no retry wrap
        await conn.call("KVPut", {"ns": "", "key": "pre", "value": b"1"})

        # "Partition": a new leader is elected elsewhere while the old
        # process still serves. Opening the store at term+1 raises the
        # fence on every replica member.
        new = GcsServer(session_name="ha", persist_path=path,
                        persist_backend="replicated", term=old.leader_term + 1)
        await new.start()

        rejections = 0
        for i in range(3):
            with pytest.raises(rpc.StaleLeaderError):
                await conn.call(
                    "KVPut", {"ns": "", "key": f"post{i}", "value": b"2"},
                    timeout=10,
                )
            rejections += 1
        assert rejections == 3

        # The old primary noticed the fence and demoted: serve loop done.
        for _ in range(100):
            if old.fenced and old._stopping:
                break
            await asyncio.sleep(0.05)
        assert old.fenced and old._stopping

        # No stale write leaked into the new leader's view; pre-fence
        # acknowledged state is intact.
        assert new.kv.get(("", "pre")) == b"1"
        assert not any(key.startswith("post") for _, key in new.kv)
        assert gcs_ha.read_leadership(new.store)["term"] == new.leader_term

        await conn.close()
        await new.stop()

    asyncio.run(go())


def test_restart_in_place_bumps_term(ha_env):
    """A replicated-backend GCS restarted over the same files must come
    back at a HIGHER term: its old incarnation may still think it leads."""
    path = ha_env

    async def go():
        s1 = GcsServer(session_name="ha", persist_path=path,
                       persist_backend="replicated")
        await s1.start()
        assert s1.leader_term == 1
        await s1.crash()
        s2 = GcsServer(session_name="ha", persist_path=path,
                       persist_backend="replicated")
        await s2.start()
        assert s2.leader_term == 2
        await s2.stop()

    asyncio.run(go())


def test_resubscribe_term_change_forces_snapshot(ha_env):
    """Satellite (a): on resubscribe, a changed leader term is
    unconditionally stale — snapshot pull even when epoch/seq line up."""
    path = ha_env

    async def go():
        server = GcsServer(session_name="ha", persist_path=path,
                           persist_backend="replicated")
        await server.start()
        conn = await rpc.connect(*server.server.address)
        client = GcsClient(conn)
        await client.subscribe("syncer:nodes", lambda m: None)
        channel = "syncer:nodes"
        assert client._sub_term[channel] == server.leader_term

        gaps = []
        client._note_gap = lambda ch, why: gaps.append((ch, why))
        # Same epoch, same seq, NEW term -> mandatory snapshot pull.
        client._check_resubscribe(channel, {
            "seq": client._sub_seq[channel],
            "pub_epoch": client._sub_epoch[channel],
            "leader_term": server.leader_term + 1,
        })
        assert gaps == [(channel, "resubscribe")]
        assert client._sub_term[channel] == server.leader_term + 1

        # Same term + same seq (the no-failover happy path) is NOT stale.
        gaps.clear()
        client._check_resubscribe(channel, {
            "seq": client._sub_seq[channel],
            "pub_epoch": client._sub_epoch[channel],
            "leader_term": server.leader_term + 1,
        })
        assert gaps == []

        await client.close()
        await server.stop()

    asyncio.run(go())


def test_stale_term_publish_dropped(ha_env):
    """Satellite (a): a pre-failover message straggling in after promotion
    (lower leader term) is dropped, never delivered to handlers."""
    path = ha_env

    async def go():
        server = GcsServer(session_name="ha", persist_path=path,
                           persist_backend="replicated")
        await server.start()
        conn = await rpc.connect(*server.server.address)
        client = GcsClient(conn)
        seen = []
        await client.subscribe("chan", seen.append)
        term = server.leader_term

        # Fresh-term message delivers; known term advances with it.
        await client._dispatch_pub("chan", {"v": 1, "leader_term": term + 1}, 1)
        # A stale pre-failover straggler (lower term) must be dropped.
        await client._dispatch_pub("chan", {"v": 2, "leader_term": term}, 2)
        assert [m["v"] for m in seen] == [1]

        await client.close()
        await server.stop()

    asyncio.run(go())


# -- driver-level failover ---------------------------------------------------


@pytest.fixture
def ray_ha(torch_shutdown_only, monkeypatch):
    monkeypatch.setenv("RAY_TPU_GCS_PERSIST_BACKEND", "replicated")
    monkeypatch.setenv("RAY_TPU_GCS_LEADER_LEASE_S", "1.0")
    monkeypatch.setenv("RAY_TPU_GCS_STANDBY_POLL_S", "0.05")
    config.refresh()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()  # before the env reverts: teardown needs HA config
    monkeypatch.undo()
    config.refresh()


def _kill_gcs_host():
    w = worker_mod.global_worker
    node = w.node
    return w.run_async(node.kill_gcs_host(), timeout=60)


def test_driver_cluster_survives_gcs_host_loss(ray_ha):
    """Whole-machine GCS loss under a live driver cluster: the standby
    promotes, raylet/driver/worker clients re-target via the leader file,
    and work — including in-flight sends that died mid-failover — resumes
    with state intact."""

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    assert ray_tpu_torch.get(f.remote(1)) == 2
    w = worker_mod.global_worker
    w.run_async(w.core.gcs.kv_put("stay", b"put-before-failover", ns="ha"))

    node = worker_mod.global_worker.node
    old_term = node.gcs_server.leader_term
    _kill_gcs_host()
    assert node.gcs_server.leader_term == old_term + 1

    deadline = time.monotonic() + 30
    while True:
        try:
            assert ray_tpu_torch.get(f.remote(41), timeout=30) == 42
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
    assert (
        w.run_async(w.core.gcs.kv_get("stay", ns="ha"), timeout=30)
        == b"put-before-failover"
    )


def test_lease_during_failover_granted_exactly_once(ray_ha):
    """Satellite (b): tasks whose control-plane traffic (lease, telemetry,
    deadline-stat sends) straddles the failover retry against the new
    leader per their wire retry class and run exactly once each."""
    import collections

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.calls = collections.Counter()

        def mark(self, i):
            self.calls[i] += 1
            return i

        def all(self):
            return dict(self.calls)

    c = Counter.remote()
    # Launch work, fail over while it is in flight, launch more.
    first = [c.mark.remote(i) for i in range(8)]
    _kill_gcs_host()
    second = [c.mark.remote(i) for i in range(8, 16)]
    assert sorted(ray_tpu_torch.get(first + second, timeout=60)) == list(range(16))
    calls = ray_tpu_torch.get(c.all.remote(), timeout=30)
    # Exactly once: no mark ran twice (a duplicated grant would double-run).
    assert calls == {i: 1 for i in range(16)}


# -- quorum HA: standby pools, majority loss, RPC-fed standbys ---------------


def test_two_consecutive_failovers_same_standby_pool(ha_env):
    """Regression: a standby that loses the promotion race (or whose
    promotion attempt fails) must RE-ARM at the next term, not give up
    forever — the same two-standby pool must absorb two failovers."""
    from ray_tpu_torch._private.gcs_store import drop_host

    path = ha_env

    async def go():
        primary = GcsServer(session_name="ha", persist_path=path,
                            persist_backend="replicated")
        await primary.start()
        sb1 = gcs_ha.GcsStandby(session_name="ha", persist_path=path)
        sb2 = gcs_ha.GcsStandby(session_name="ha", persist_path=path)
        await sb1.start()
        await sb2.start()

        conn = await rpc.connect(*primary.server.address)
        await conn.call("KVPut", {"ns": "", "key": "k1", "value": b"v1"})
        await conn.close()

        # Failover #1: both standbys race; try_claim_term lets exactly one
        # open the store at term 2, the loser re-enters its watch loop.
        await primary.crash()
        drop_host(path)
        deadline = time.monotonic() + 30
        while not (sb1.promoted.is_set() or sb2.promoted.is_set()):
            assert time.monotonic() < deadline, "no standby promoted"
            await asyncio.sleep(0.05)
        winner, loser = (sb1, sb2) if sb1.promoted.is_set() else (sb2, sb1)
        new1 = winner.server
        assert new1.leader_term == 2
        assert not loser.promoted.is_set()

        conn = await rpc.connect(*new1.server.address)
        await conn.call("KVPut", {"ns": "", "key": "k2", "value": b"v2"})
        await conn.close()

        # Failover #2 through the SAME pool: the first race's loser must
        # still be armed and take term 3.
        await new1.crash()
        drop_host(path)
        await asyncio.wait_for(loser.promoted.wait(), 30)
        new2 = loser.server
        assert new2.leader_term == 3
        assert new2.kv.get(("", "k1")) == b"v1"
        assert new2.kv.get(("", "k2")) == b"v2"

        await winner.stop()
        await loser.stop()

    asyncio.run(go())


def test_majority_loss_demotes_leader_server(ha_env):
    """Graceful degradation's hard edge: with EVERY follower partitioned no
    majority can hold a commit — the leader must demote (typed rejection
    to clients, serve loop exits), never ack unreplicated writes."""
    from ray_tpu_torch._private import gcs_store
    from ray_tpu_torch._private.gcs_store import follower_paths, partition_host

    path = ha_env

    async def go():
        server = GcsServer(session_name="ha", persist_path=path,
                           persist_backend="replicated")
        await server.start()
        conn = await rpc.connect(*server.server.address)
        await conn.call("KVPut", {"ns": "", "key": "pre", "value": b"1"})
        await asyncio.sleep(0.1)  # let the pre write's group commit land
        try:
            for fol in follower_paths(path):
                partition_host(fol)
            # Batch sync: the RPC reply can precede the group commit, so
            # this write may be accepted in-memory — but its flush finds no
            # majority and the leader must demote instead of limping on.
            try:
                await conn.call(
                    "KVPut", {"ns": "", "key": "lost", "value": b"2"},
                    timeout=10,
                )
            except (rpc.StaleLeaderError, rpc.RpcError, OSError):
                pass
            for _ in range(200):
                if server.fenced and server._stopping:
                    break
                await asyncio.sleep(0.05)
            assert server.fenced and server._stopping
            # The demoted leader never shipped the unreplicated write: no
            # member of the (partitioned) majority holds it, while the
            # quorum-acked pre-partition write is on every follower.
            for fol in follower_paths(path):
                with open(fol, "rb") as f:
                    tables, _, _, _ = gcs_store._parse_replicated(f.read())
                assert "\x00pre" in tables.get("kv", {})
                assert "\x00lost" not in tables.get("kv", {})
        finally:
            gcs_store.heal_all_partitions()
            await conn.close()
            await server.stop()

    asyncio.run(go())


def test_standby_rpc_stream_mirrors_commits(ha_env):
    """The cross-process standby feed: a ShipSubscribe'd standby bootstraps
    from ShipSnapshot and then mirrors every quorum commit from pushed
    ShipFrames — no reliance on reading the leader's local files."""
    path = ha_env

    async def go():
        server = GcsServer(session_name="ha", persist_path=path,
                           persist_backend="replicated")
        await server.start()
        standby = gcs_ha.GcsStandby(session_name="ha", persist_path=path,
                                    mode="rpc")
        await standby.start()
        conn = await rpc.connect(*server.server.address)
        # Let the standby's watch loop dial and subscribe first so the
        # puts arrive as streamed frames, not just the bootstrap snapshot.
        deadline = time.monotonic() + 30
        while standby.snapshots_pulled == 0:
            assert time.monotonic() < deadline, "standby never subscribed"
            await asyncio.sleep(0.05)
        for i in range(3):
            await conn.call(
                "KVPut", {"ns": "", "key": f"k{i}", "value": b"v"}
            )
        while standby.mirror.seq < server.store.seq:
            assert time.monotonic() < deadline, "mirror never caught up"
            await asyncio.sleep(0.05)
        assert standby.frames_received > 0
        assert standby.mirror.term == server.store.term
        await conn.close()
        await standby.stop()
        await server.stop()

    asyncio.run(go())


def test_os_process_standby_promotes_after_host_loss(ha_env):
    """E2E with a REAL second process: ``python -m ray_tpu_torch._private.gcs_ha``
    arms a standby in its own OS process; when the leader host dies the
    subprocess promotes, flips the leader file, and serves the acked state
    to clients that re-target through it."""
    import sys

    from ray_tpu_torch._private import gcs_store
    from ray_tpu_torch._private.gcs_store import drop_host, follower_paths

    path = ha_env
    leader_file = gcs_ha.leader_file_path(path)

    async def go():
        primary = GcsServer(session_name="ha", persist_path=path,
                            persist_backend="replicated")
        await primary.start()
        conn = await rpc.connect(*primary.server.address)
        await conn.call("KVPut", {"ns": "", "key": "k", "value": b"v"})
        await conn.close()
        old_addr = gcs_ha.resolve_leader_file(leader_file)
        assert old_addr == primary.server.address

        env = dict(
            os.environ,
            RAY_TPU_GCS_PERSIST_BACKEND="replicated",
            RAY_TPU_GCS_LEADER_LEASE_S="1.0",
            RAY_TPU_GCS_STANDBY_POLL_S="0.05",
            JAX_PLATFORMS="cpu",
        )
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ray_tpu_torch._private.gcs_ha",
            "--persist-path", path, "--session", "ha",
            env=env,
        )
        try:
            await primary.crash()
            drop_host(path)
            deadline = time.monotonic() + 30
            new_addr = None
            while time.monotonic() < deadline:
                addr = gcs_ha.resolve_leader_file(leader_file)
                if addr is not None and addr != old_addr:
                    new_addr = addr
                    break
                await asyncio.sleep(0.1)
            assert new_addr is not None, "subprocess standby never promoted"

            conn2 = await rpc.connect(*new_addr)
            reply = await conn2.call(
                "KVGet", {"ns": "", "key": "k"}, timeout=10
            )
            assert reply.get("value") == b"v"
            await conn2.close()
            tailer = gcs_store.ReplicaTailer(follower_paths(path)[0])
            tailer.poll()
            assert gcs_ha.read_leadership(tailer)["term"] == 2
        finally:
            proc.terminate()
            await proc.wait()

    asyncio.run(go())
