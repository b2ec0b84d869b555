"""The reference's tests/test_health_pubsub.py on the port, case for case after
the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest
fixtures -> ray_tpu_torch.testing's). No case differs.

GCS active health checks + pubsub backpressure.

Reference analogs: gcs_health_check_manager.cc (periodic probe with miss
counting) and pubsub/publisher.h (per-subscriber bounded queues)."""

import asyncio
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.cluster_utils import Cluster


def test_wedged_node_detected_by_health_checks(monkeypatch):
    """A raylet whose event loop stops serving RPCs (but keeps its TCP
    session) must be detected by periodic Pings with miss counting —
    connection-centric death detection alone would never notice it."""
    monkeypatch.setenv("RAY_TPU_HEALTH_CHECK_INITIAL_DELAY_S", "0.1")
    monkeypatch.setenv("RAY_TPU_HEALTH_CHECK_PERIOD_S", "0.2")
    monkeypatch.setenv("RAY_TPU_HEALTH_CHECK_TIMEOUT_S", "0.5")
    monkeypatch.setenv("RAY_TPU_HEALTH_CHECK_FAILURE_THRESHOLD", "3")
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    wedged = cluster.add_node(num_cpus=1)
    cluster.connect()
    try:
        assert len([n for n in ray_tpu_torch.nodes() if n["state"] == "ALIVE"]) == 2

        async def hang(conn, p):
            await asyncio.sleep(3600)

        wedged.server._handlers["Ping"] = hang

        # Watch for the death EVENT: after being marked DEAD the GCS drops
        # the link and the (still-connected but wedged) raylet re-registers,
        # so polling instantaneous state can miss the DEAD window.
        w = worker_mod.global_worker
        removed = []

        async def subscribe():
            core = w.core
            await core.gcs.subscribe(
                "nodes",
                lambda msg: removed.append(msg["node"]["node_id"])
                if msg.get("event") == "removed"
                else None,
            )

        w.run_async(subscribe(), timeout=30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and wedged.node_id not in removed:
            time.sleep(0.25)
        assert wedged.node_id in removed, (
            "wedged raylet was never marked DEAD by health checks"
        )
    finally:
        cluster.shutdown()


def test_versioned_view_sync(monkeypatch):
    """Raylets converge on the scheduling head via versioned broadcasts (no
    polling): joins, resource updates, and deaths all bump the version, and
    membership changes bump the shape epoch (reference: ray_syncer.h
    streams, inverted — the GCS sorts, subscribers receive the head)."""
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    head_raylet = cluster.head_node.raylet

    def head_ids():
        return {n["node_id"] for n in head_raylet._head}

    cluster.connect()
    try:
        n2 = cluster.add_node(num_cpus=2)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if head_raylet._head_version >= 0 and n2.node_id in head_ids():
                break
            time.sleep(0.1)
        assert n2.node_id in head_ids(), "join broadcast never arrived"
        v_after_join = head_raylet._head_version
        epoch_after_join = head_raylet._head_epoch
        assert v_after_join >= 0

        cluster.remove_node(n2)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if n2.node_id not in head_ids():
                break
            time.sleep(0.1)
        assert n2.node_id not in head_ids(), "death broadcast never arrived"
        assert head_raylet._head_version > v_after_join
        assert head_raylet._head_epoch > epoch_after_join
    finally:
        cluster.shutdown()


def test_subscriber_gap_pulls_snapshot():
    """A subscriber that observes a seq jump (its backlog was shed, or it
    missed a window) must resync from a channel Snapshot instead of acting
    on a stale picture."""
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.connect()
    w = worker_mod.global_worker
    gcs = cluster.gcs_server
    try:

        @ray_tpu_torch.remote
        class A:
            def ping(self):
                return 1

        a = A.remote()
        assert ray_tpu_torch.get(a.ping.remote()) == 1
        channel = f"actor:{a._actor_id}"
        got = []

        async def provoke_gap():
            await w.core.gcs.subscribe(channel, got.append)
            # Simulate a shed backlog: jump the channel's seqno past what
            # the subscriber has seen, then publish. The client must flag
            # the gap and pull a Snapshot (the actor's current record).
            gcs.publisher.seqnos[channel] = (
                gcs.publisher.seqnos.get(channel, 0) + 5
            )
            gcs.publisher.publish(channel, {"state": "ALIVE", "probe": True})

        w.run_async(provoke_gap(), timeout=30)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if any("probe" in m for m in got) and any(
                m.get("actor_id") == a._actor_id for m in got
            ):
                break
            time.sleep(0.1)
        # Both the gap-straddling publish AND the snapshot resync arrive.
        assert any("probe" in m for m in got), got
        assert any(m.get("actor_id") == a._actor_id for m in got), got
    finally:
        cluster.shutdown()


def test_slow_subscriber_backpressure(monkeypatch):
    """A subscriber that stops reading its socket must not stall the GCS:
    its queue bounds, oldest messages drop, and other RPCs stay fast."""
    monkeypatch.setenv("RAY_TPU_PUBSUB_MAX_BUFFERED_MSGS", "50")
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0})
    cluster.connect()
    w = worker_mod.global_worker
    gcs = cluster.gcs_server
    try:
        received = []

        async def connect_sub():
            async def on_pub(conn, p):
                received.append(p["msg"])

            async def on_pub_batch(conn, p):
                for _ch, msg, _seq in p["items"]:
                    received.append(msg)

            conn = await rpc.connect(
                *cluster.gcs_addr,
                handlers={"Pub": on_pub, "PubBatch": on_pub_batch},
            )
            await conn.call("Subscribe", {"channel": "bench"})
            return conn

        sub_conn = w.run_async(connect_sub(), timeout=30)

        async def stall_and_publish():
            # Stop reading: the server's sends back up on this transport.
            sub_conn._protocol.transport.pause_reading()
            payload = "x" * 4096
            for i in range(2000):
                gcs.publisher.publish("bench", {"i": i, "pad": payload})
            await asyncio.sleep(0.5)  # let drain tasks hit the full socket

        w.run_async(stall_and_publish(), timeout=60)
        # Other RPCs still served promptly.
        t0 = time.monotonic()
        assert any(n["state"] == "ALIVE" for n in ray_tpu_torch.nodes())
        assert time.monotonic() - t0 < 2.0
        stats = gcs.publisher.stats()
        assert stats["total_dropped"] > 0, stats
        bench = stats["channels"]["bench"]
        assert bench["queued"] <= 50, stats

        async def resume():
            sub_conn._protocol.transport.resume_reading()

        w.run_async(resume(), timeout=10)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not received:
            time.sleep(0.1)
        # The tail of the stream (newest retained messages) arrives.
        assert received and received[-1]["i"] >= 1950, (
            len(received),
            received[-1]["i"] if received else None,
        )

        async def close_sub():
            await sub_conn.close()

        w.run_async(close_sub(), timeout=10)
    finally:
        cluster.shutdown()
