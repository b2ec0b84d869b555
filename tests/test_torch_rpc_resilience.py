"""The reference's tests/test_rpc_resilience.py on the port, case for case after
the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest
fixtures -> ray_tpu_torch.testing's). No case differs.

RPC resilience layer: retry policies, end-to-end deadlines, and the
retryable connection wrapper (reference analogs: retryable_grpc_client.h,
gcs_rpc_client.h failover call queues).

Covers: backoff/jitter schedule determinism, deadline shrinking across a
3-hop call chain, server-side shedding of expired frames, deadline
enforcement (handler cancelled at its deadline), reconnect-and-drain across
a server restart, and per-method retry safety incl. dedup-token gating.
"""

import asyncio
import itertools
import random

import pytest

from ray_tpu_torch._private import rpc, wire


# ------------------------------------------------------------ retry policy


def test_backoff_schedule_deterministic_under_seeded_rng():
    policy = rpc.RetryPolicy(
        initial_backoff_s=0.1,
        max_backoff_s=1.0,
        multiplier=2.0,
        max_attempts=5,
        total_budget_s=10.0,
    )
    a = list(itertools.islice(policy.backoffs(random.Random(7)), 10))
    b = list(itertools.islice(policy.backoffs(random.Random(7)), 10))
    assert a == b, "same seed must reproduce the identical jitter schedule"
    c = list(itertools.islice(policy.backoffs(random.Random(8)), 10))
    assert a != c


def test_backoff_caps_grow_exponentially_then_clamp():
    policy = rpc.RetryPolicy(
        initial_backoff_s=0.1, max_backoff_s=1.0, multiplier=2.0
    )
    caps = [policy.backoff_cap(i) for i in range(8)]
    assert caps == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0, 1.0, 1.0]
    # Full jitter: every sleep lands in [0, cap_i].
    sleeps = list(itertools.islice(policy.backoffs(random.Random(3)), 8))
    assert all(0.0 <= s <= cap for s, cap in zip(sleeps, caps))


def test_policy_allows_enforces_both_caps():
    policy = rpc.RetryPolicy(max_attempts=3, total_budget_s=5.0)
    assert policy.allows(1, 0.0)
    assert policy.allows(3, 4.9)
    assert not policy.allows(4, 0.0), "attempt cap"
    assert not policy.allows(2, 5.0), "total budget cap"
    unbounded = rpc.RetryPolicy(max_attempts=0, total_budget_s=0.0)
    assert unbounded.allows(10_000, 1e6)


def test_connect_backoff_dial_gives_up_within_budget():
    async def go():
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        with pytest.raises(rpc.ConnectionLost):
            # Port 1 refuses instantly; legacy args map onto a policy with
            # total budget retry * retry_interval.
            await rpc.connect("127.0.0.1", 1, retry=3, retry_interval=0.05)
        assert loop.time() - t0 < 2.0

    asyncio.run(go())


# ------------------------------------------------------ deadline propagation


def test_deadline_shrinks_across_three_hop_chain():
    """driver -> A -> B -> C: every hop's remaining budget must be strictly
    smaller than its caller's, because the wire TTL is re-derived from the
    same absolute deadline at each hop."""

    async def go():
        budgets = {}
        servers = [rpc.Server("127.0.0.1", 0) for _ in range(3)]
        conns = {}

        async def handler_c(conn, p):
            budgets["c"] = rpc.remaining_budget()
            return "leaf"

        async def handler_b(conn, p):
            budgets["b"] = rpc.remaining_budget()
            # No explicit timeout: the ambient deadline alone must ride on.
            return await conns["bc"].call("Hop", None)

        async def handler_a(conn, p):
            budgets["a"] = rpc.remaining_budget()
            return await conns["ab"].call("Hop", None)

        servers[0].register("Hop", handler_a)
        servers[1].register("Hop", handler_b)
        servers[2].register("Hop", handler_c)
        addrs = [await s.start() for s in servers]
        conns["ab"] = await rpc.connect(*addrs[1])
        conns["bc"] = await rpc.connect(*addrs[2])
        driver = await rpc.connect(*addrs[0])
        try:
            assert await driver.call("Hop", None, timeout=1.0) == "leaf"
            assert 0 < budgets["c"] < budgets["b"] < budgets["a"] <= 1.0
            # No deadline at all: budget is unbounded end to end.
            budgets.clear()
            assert await driver.call("Hop", None) == "leaf"
            assert budgets == {"a": None, "b": None, "c": None}
        finally:
            await driver.close()
            await conns["ab"].close()
            await conns["bc"].close()
            for s in servers:
                await s.stop()

    asyncio.run(go())


def test_server_sheds_frames_that_arrive_past_deadline():
    """A frame delayed beyond its TTL (chaos-delay analog: held, then
    re-sent via _send_direct, which re-stamps the TTL at pack time) must be
    shed on arrival — the handler never runs."""

    async def go():
        loop = asyncio.get_running_loop()
        ran = []

        async def handler(conn, p):
            ran.append(p)
            return "late"

        server = rpc.Server("127.0.0.1", 0)
        server.register("Slow", handler)
        addr = await server.start()
        conn = await rpc.connect(*addr)

        def hold(c, msg):
            if msg[1] == 0 and msg[2] == "Slow":
                loop.call_later(0.25, c._send_direct, msg)
                return True
            return False

        rpc.set_send_interceptor(hold)
        rpc.deadline_stats.reset()
        try:
            with pytest.raises(asyncio.TimeoutError):
                await conn.call("Slow", None, timeout=0.1)
            # Give the held frame time to arrive and be shed.
            await asyncio.sleep(0.3)
            assert ran == [], "handler must not run for an expired frame"
            assert rpc.deadline_stats.shed == 1
        finally:
            rpc.set_send_interceptor(None)
            await conn.close()
            await server.stop()

    asyncio.run(go())


def test_handler_cancelled_at_deadline_and_error_reply_text():
    async def go():
        loop = asyncio.get_running_loop()
        unwound = []

        async def sleepy(conn, p):
            try:
                await asyncio.sleep(30)
            finally:
                unwound.append(True)
            return "never"

        server = rpc.Server("127.0.0.1", 0)
        server.register("Sleepy", sleepy)
        addr = await server.start()
        conn = await rpc.connect(*addr)
        rpc.deadline_stats.reset()
        try:
            # call_nowait + bare await (no local wait_for) so the error
            # reply itself is observable instead of the local timeout.
            fut = conn.call_nowait("Sleepy", None, deadline=loop.time() + 0.2)
            with pytest.raises(rpc.RpcError, match="DeadlineExceeded"):
                await fut
            assert rpc.deadline_stats.enforced == 1
            assert unwound == [True], "cancellation must unwind the handler"
            assert rpc.deadline_stats.overruns == []
        finally:
            await conn.close()
            await server.stop()

    asyncio.run(go())


# ------------------------------------------------- retryable connection


def _fast_policy():
    return rpc.RetryPolicy(
        initial_backoff_s=0.02,
        max_backoff_s=0.1,
        multiplier=2.0,
        max_attempts=0,
        total_budget_s=10.0,
    )


def test_reconnect_and_drain_across_server_restart():
    """Calls issued while the server is down queue behind the redial lock
    and drain once it is back — a restart is a latency blip, not an error."""

    async def go():
        async def echo(conn, p):
            return p

        server = rpc.Server("127.0.0.1", 0)
        server.register("Echo", echo)
        host, port = await server.start()

        async def dial():
            return await rpc.connect(host, port, policy=_fast_policy())

        rc = rpc.RetryableConnection(
            dial, conn=await dial(), policy=_fast_policy(),
            default_retry=wire.RETRY_SAFE, name="test",
        )
        try:
            assert await rc.call("Echo", 1) == 1
            await server.stop()
            # In-flight while down: all must block, then drain on restart.
            calls = [
                asyncio.ensure_future(rc.call("Echo", i)) for i in range(5)
            ]
            await asyncio.sleep(0.15)
            assert not any(c.done() for c in calls)
            server = rpc.Server("127.0.0.1", port)
            server.register("Echo", echo)
            await server.start()
            assert await asyncio.wait_for(asyncio.gather(*calls), 10) == [
                0, 1, 2, 3, 4,
            ]
            assert rc.stats["redials"] >= 1
            # Late arrivals park behind the redial lock rather than failing.
            assert rc.stats["queued"] >= 1
        finally:
            await rc.close()
            await server.stop()

    asyncio.run(go())


def test_closed_retryable_connection_stops_redialing():
    async def go():
        async def echo(conn, p):
            return p

        server = rpc.Server("127.0.0.1", 0)
        server.register("Echo", echo)
        host, port = await server.start()

        async def dial():
            return await rpc.connect(host, port, policy=_fast_policy())

        rc = rpc.RetryableConnection(
            dial, conn=await dial(), policy=_fast_policy(),
            default_retry=wire.RETRY_SAFE, name="test",
        )
        await rc.close()
        with pytest.raises(rpc.ConnectionLost):
            await rc.call("Echo", 1)
        await server.stop()

    asyncio.run(go())


def _lossy_lease_server(calls):
    """Server whose first reply per method is lost: the handler runs, then
    the connection dies before the reply frame ships."""

    async def lease(conn, p):
        calls.append(p.get("lease_id"))
        if len(calls) == 1:
            await conn.close()  # reply vanishes with the link
        return {"granted": True}

    server = rpc.Server("127.0.0.1", 0)
    server.register("RequestWorkerLease", lease)
    return server


def test_dedup_method_retries_only_with_token():
    """RequestWorkerLease is RETRY_DEDUP on lease_id: with the token the
    wrapper re-issues after a lost reply (the raylet's grant ledger dedupes
    server-side); without it the failure surfaces."""

    async def go():
        calls = []
        server = _lossy_lease_server(calls)
        host, port = await server.start()

        async def dial():
            return await rpc.connect(host, port, policy=_fast_policy())

        rc = rpc.RetryableConnection(
            dial, conn=await dial(), policy=_fast_policy(), name="test",
        )
        try:
            reply = await rc.call(
                "RequestWorkerLease", {"lease_id": "L1", "resources": {}}
            )
            assert reply == {"granted": True}
            assert calls == ["L1", "L1"], "retry must carry the same token"
        finally:
            await rc.close()
            await server.stop()

    asyncio.run(go())


def test_dedup_method_without_token_does_not_retry():
    async def go():
        calls = []
        server = _lossy_lease_server(calls)
        host, port = await server.start()

        async def dial():
            return await rpc.connect(host, port, policy=_fast_policy())

        rc = rpc.RetryableConnection(
            dial, conn=await dial(), policy=_fast_policy(), name="test",
        )
        try:
            with pytest.raises(rpc.ConnectionLost):
                await rc.call("RequestWorkerLease", {"resources": {}})
            assert calls == [None], "no token -> no transparent retry"
        finally:
            await rc.close()
            await server.stop()

    asyncio.run(go())


def test_retry_none_method_surfaces_first_failure():
    async def go():
        async def push_task(conn, p):
            await conn.close()
            return "lost"

        server = rpc.Server("127.0.0.1", 0)
        server.register("PushTask", push_task)
        host, port = await server.start()

        async def dial():
            return await rpc.connect(host, port, policy=_fast_policy())

        rc = rpc.RetryableConnection(
            dial, conn=await dial(), policy=_fast_policy(),
            default_retry=wire.RETRY_SAFE, name="test",
        )
        try:
            # PushTask is RETRY_NONE in wire.SCHEMAS: the channel default
            # ("safe") must not override the per-method declaration.
            with pytest.raises(rpc.ConnectionLost):
                await rc.call("PushTask", {"spec": {}})
        finally:
            await rc.close()
            await server.stop()

    asyncio.run(go())


def test_retry_class_registry():
    assert wire.retry_class("KVGet") == (wire.RETRY_SAFE, None)
    assert wire.retry_class("RequestWorkerLease") == (
        wire.RETRY_DEDUP, "lease_id",
    )
    assert wire.retry_class("PushChunk") == (wire.RETRY_NONE, None)
    assert wire.retry_class("NoSuchMethod") == (wire.RETRY_NONE, None)
    assert wire.retry_class("NoSuchMethod", wire.RETRY_SAFE) == (
        wire.RETRY_SAFE, None,
    )
