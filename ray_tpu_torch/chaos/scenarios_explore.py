"""Exhaustively-explored concurrency scenarios for the interleaving explorer.

Each scenario here is a SMALL, CLOSED protocol interaction — a handful of
concurrent tasks over real control-plane code (raylet lease ledger,
replicated store promotion, pubsub resubscribe) whose whole schedule space
``ray_tpu_torch.devtools.explore`` can enumerate.  Unlike ``chaos.scenarios``-style
randomized soak runs, a clean report here is a PROOF over the modeled space:
every interleaving of the tasks' wakeups and timers was executed and the
invariants held in all of them.

The contract with the explorer (``explore.Explorer``):

- a spec in ``SCENARIOS`` exposes ``description`` and
  ``factory(mutations=[...]) -> scenario instance``;
- the instance exposes ``async run() -> List[str]`` returning violation
  strings (empty == invariants held on this schedule) and a synchronous
  ``cleanup()`` called after every run, pass or fail;
- ``run()`` must be deterministic given the explorer's schedule choices:
  no wall-clock reads that steer control flow, no real sockets, no
  subprocesses.  Timers are fine — the virtual loop owns the clock.

Mutations re-introduce historical bugs behind a flag so CI can prove the
explorer still has teeth: ``double_grant`` disables BOTH layers of the
duplicate-lease fix (the grant ledger and the leases[] recovery branch);
the explorer must find a schedule that corrupts the resource ledger, and
the committed trace in ``tests/schedules/`` must replay to that violation.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Sequence

__all__ = ["SCENARIOS", "ScenarioSpec"]


class ScenarioSpec:
    """Registry entry: a named scenario class plus its supported mutations."""

    def __init__(self, cls: Callable[..., Any], description: str):
        self.cls = cls
        self.description = description

    @property
    def mutations(self) -> Sequence[str]:
        return getattr(self.cls, "MUTATIONS", ())

    def factory(self, mutations: Sequence[str] = ()) -> Any:
        unknown = set(mutations) - set(self.mutations)
        if unknown:
            raise ValueError(
                f"unknown mutation(s) {sorted(unknown)} for this scenario; "
                f"supported: {sorted(self.mutations)}"
            )
        return self.cls(mutations=list(mutations))


class LeaseExactlyOnce:
    """Concurrent grant / duplicate-grant / cancel frames for ONE lease id.

    Three tasks race against a sim-worker raylet with CPU capacity 2: two
    requesters carrying the same lease id (a wire-duplicated
    RequestWorkerLease frame — the incident shape) that return their
    worker once granted, and a canceller for that id.  Every interleaving
    must leave the raylet balanced: no live leases, availability restored
    to total, and ``chaos.invariants.check_leases`` clean (no worker held
    by two leases, no leaked grant).

    The ``double_grant`` mutation disables the duplicate-grant ledger AND
    the ``leases[]`` recovery branch; schedules where both grants commit
    then overwrite each other leak a worker's resources, which the final
    ledger check reports.
    """

    MUTATIONS = ("double_grant",)
    LEASE_ID = "L-explore-1"

    def __init__(self, mutations: Sequence[str] = ()):
        from ray_tpu_torch._private import raylet as raylet_mod

        self._raylet_mod = raylet_mod
        self._mutate = "double_grant" in mutations
        self._raylet: Any = None
        if self._mutate:
            raylet_mod.Raylet._mutate_double_grant = True

    async def run(self) -> List[str]:
        from ray_tpu_torch._private.common import ResourceSet
        from ray_tpu_torch.chaos import invariants

        raylet = self._raylet_mod.Raylet(
            gcs_addr=("127.0.0.1", 1),
            session_name="explore",
            resources={"CPU": 2.0},
            object_store_memory=1 << 20,
            node_id="e0" * 14,
            sim_workers=True,
        )
        self._raylet = raylet
        # start() never runs under the virtual loop (it would bind sockets);
        # sim-worker handles read the listen address, so pin it by hand.
        raylet.addr = ("127.0.0.1", 0)

        payload = {
            "lease_id": self.LEASE_ID,
            "resources": ResourceSet({"CPU": 1.0}).to_units(),
            # Mark as spilled here by a peer: skips the locality/policy
            # pick (which would need a GCS view) and queues locally.
            "spilled_from": "peer-node",
        }

        async def requester() -> None:
            reply = await raylet._request_worker_lease(None, dict(payload))
            if reply.get("granted"):
                await raylet._return_worker(
                    None, {"lease_id": self.LEASE_ID}
                )

        async def canceller() -> None:
            await raylet._cancel_worker_lease(
                None, {"lease_id": self.LEASE_ID}
            )

        await asyncio.gather(requester(), requester(), canceller())

        violations = [str(v) for v in invariants.check_leases(raylet)]
        if raylet.leases:
            violations.append(
                f"lease-exactly-once: {len(raylet.leases)} lease(s) still "
                "live after every requester returned its worker"
            )
        if raylet.available != raylet.total:
            violations.append(
                "resource-ledger: availability "
                f"{raylet.available.to_dict()} != total "
                f"{raylet.total.to_dict()} after all leases released"
            )
        return violations

    def cleanup(self) -> None:
        if self._mutate:
            self._raylet_mod.Raylet._mutate_double_grant = False
        raylet = self._raylet
        self._raylet = None
        if raylet is None:
            return
        raylet._io_pool.shutdown(wait=False)
        close = getattr(raylet.store, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
        shutil.rmtree(raylet.spill_dir, ignore_errors=True)


class HaPromotion:
    """Standby promotion racing a still-writing primary over a shared
    follower (the epoch-fencing protocol of the HA control plane).

    The term-1 primary streams puts while a term-2 standby adopts the
    shared follower, raises the fence, rewrites the leadership record and
    writes its own data — at every possible interleaving of the two tasks'
    event-loop ticks.  Invariants, checked per schedule:

    - no split brain: once the standby exists, a probe write on the old
      primary raises StaleLeaderError (or poisons it as fenced);
    - the standby itself is never fenced;
    - durability of acks: every term-1 key whose group commit SUCCEEDED
      (observed via ``commit_listener``, which fence aborts never fire) is
      present in the follower's final state;
    - the follower's final leadership record carries term 2.
    """

    MUTATIONS = ()
    # Number of term-1 puts streamed before the final flush.  One put keeps
    # the full space within an exhaustive CI budget; more puts multiply the
    # promotion landing points for deeper offline runs.
    PUTS = 1

    def __init__(self, mutations: Sequence[str] = ()):
        self._tmp = tempfile.mkdtemp(prefix="explore-ha-")
        self._stores: List[Any] = []

    async def run(self) -> List[str]:
        from ray_tpu_torch._private import gcs_ha, gcs_store, rpc

        violations: List[str] = []
        follower = os.path.join(self._tmp, "shared.follower")

        primary = gcs_store.ReplicatedStoreClient(
            os.path.join(self._tmp, "a.log"),
            followers=[follower],
            term=1,
            sync="off",
        )
        self._stores.append(primary)
        gcs_ha.write_leadership(primary, 1, ("hostA", 1))

        # Ack tracking: keys move sent -> acked only when their group
        # commit ships (the listener); a fence abort drops them unacked.
        sent: List[str] = []
        acked: List[str] = []

        def on_commit(seq: int, n_ops: int) -> None:
            acked.extend(sent[:n_ops])
            del sent[:n_ops]

        primary.commit_listener = on_commit

        async def old_primary() -> None:
            try:
                for i in range(self.PUTS):
                    key = f"t1-k{i}"
                    sent.append(key)
                    primary.put("data", key, b"v1")
                    await asyncio.sleep(0)
                primary.flush()
            except rpc.StaleLeaderError:
                pass

        async def standby() -> None:
            await asyncio.sleep(0)
            # Constructor adopts the freshest member then fences term 2 on
            # every member — synchronous, so the explorer is probing WHERE
            # in the primary's write stream the promotion lands.
            promoted = gcs_store.ReplicatedStoreClient(
                os.path.join(self._tmp, "b.log"),
                followers=[follower],
                term=2,
                sync="off",
            )
            self._stores.append(promoted)
            gcs_ha.write_leadership(promoted, 2, ("hostB", 2))
            promoted.put("data", "t2-k0", b"v2")
            promoted.flush()
            if promoted.fenced:
                violations.append(
                    "ha-promotion: promoted term-2 store got fenced"
                )

        await asyncio.gather(old_primary(), standby())

        # Split-brain probe: the deposed primary must refuse new writes.
        try:
            primary.put("data", "probe", b"p")
            primary.flush()
            if not primary.fenced:
                violations.append(
                    "ha-no-split-brain: deposed term-1 primary accepted a "
                    "write after term-2 promotion"
                )
        except rpc.StaleLeaderError:
            pass

        tailer = gcs_store.ReplicaTailer(follower)
        tailer.poll()
        for key in acked:
            if tailer.get("data", key) is None:
                violations.append(
                    f"ha-ack-durability: acked term-1 key {key!r} missing "
                    "from the follower after promotion"
                )
        leadership = gcs_ha.read_leadership(tailer)
        if leadership is None or leadership.get("term") != 2:
            violations.append(
                "ha-promotion: follower leadership record is "
                f"{leadership!r}, expected term 2"
            )
        return violations

    def cleanup(self) -> None:
        for store in self._stores:
            try:
                store.close()
            except Exception:
                pass
        self._stores.clear()
        shutil.rmtree(self._tmp, ignore_errors=True)


class QuorumElection:
    """Quorum-freshest election racing a partitioned follower's rejoin.

    A 3-member group (primary + followers fA, fB) runs with fB dark behind
    a minority partition: quorum commits keep acking on primary+fA, so fB
    is a stale laggard.  Then the primary host dies (crash + drop_host —
    disk gone) and a promoter elects over the survivors [fA, fB], which is
    a 2-member group needing BOTH members reachable; while fB is still
    partitioned the election must fail closed with QuorumLostError, and
    the promoter retries until a concurrently-scheduled healer rejoins fB.
    The explorer probes every landing point of the heal against the retry
    loop.  Invariants, checked per schedule:

    - liveness under a minority partition: every writer flush acks
      (commit_listener fires) while fB is dark;
    - fail-closed: no promotion happens before fB is healed, and the
      first election attempt after the heal must succeed;
    - quorum-freshest adoption: the promoted store (elected at max
      (term, seq) over the rejoined members) contains every acked term-1
      key — stale fB must never win over fA;
    - fence bump on rejoin: after a post-election write, fB's file carries
      the promoted term and the full acked state (catch-up snapshot).
    """

    MUTATIONS = ()
    PUTS = 2
    RETRIES = 40

    def __init__(self, mutations: Sequence[str] = ()):
        self._tmp = tempfile.mkdtemp(prefix="explore-quorum-")
        self._stores: List[Any] = []

    async def run(self) -> List[str]:
        from ray_tpu_torch._private import gcs_store

        violations: List[str] = []
        f_a = os.path.join(self._tmp, "member.fA")
        f_b = os.path.join(self._tmp, "member.fB")
        primary_path = os.path.join(self._tmp, "member.primary")

        gcs_store.partition_host(f_b)
        primary = gcs_store.ReplicatedStoreClient(
            primary_path, followers=[f_a, f_b], term=1, sync="off"
        )
        self._stores.append(primary)

        sent: List[str] = []
        acked: List[str] = []

        def on_commit(seq: int, n_ops: int) -> None:
            acked.extend(sent[:n_ops])
            del sent[:n_ops]

        primary.commit_listener = on_commit
        for i in range(self.PUTS):
            key = f"t1-k{i}"
            sent.append(key)
            primary.put("data", key, b"v1")
            primary.flush()
        if sent:
            violations.append(
                "quorum-liveness: writes did not ack under a minority "
                f"partition (unacked: {sent})"
            )
        # Host loss: the leader process dies AND its log member's disk is
        # gone. Survivors are fA (quorum-fresh) and fB (stale, still dark).
        primary.crash()
        gcs_store.drop_host(primary_path)

        promoted_box: List[Any] = []
        healed = asyncio.Event()

        async def healer() -> None:
            await asyncio.sleep(0)
            gcs_store.heal_host(f_b)
            healed.set()

        async def promoter() -> None:
            # Election attempts race the heal: an attempt landing before it
            # must fail closed (QuorumLostError), after which the promoter
            # blocks on the heal signal and the next attempt must succeed.
            # (An unconditional retry-on-sleep loop would depend on
            # scheduler fairness, which the explorer rightly violates.)
            for _ in range(self.RETRIES):
                try:
                    promoted = gcs_store.ReplicatedStoreClient(
                        f_a, followers=[f_b], term=2, sync="off"
                    )
                except gcs_store.QuorumLostError:
                    if f_b not in gcs_store.partitioned_hosts():
                        violations.append(
                            "quorum-election: QuorumLostError after the "
                            "partition healed"
                        )
                        return
                    await healed.wait()
                    continue
                if f_b in gcs_store.partitioned_hosts():
                    violations.append(
                        "quorum-election: promotion succeeded while the "
                        "2-member survivor group was missing fB"
                    )
                self._stores.append(promoted)
                promoted_box.append(promoted)
                return
            violations.append(
                "quorum-election: election kept failing after the heal"
            )

        await asyncio.gather(healer(), promoter())
        if not promoted_box:
            return violations
        promoted = promoted_box[0]

        for key in acked:
            if promoted.get("data", key) is None:
                violations.append(
                    f"quorum-freshest: acked key {key!r} missing from the "
                    "elected state (stale rejoined member won?)"
                )
        promoted.put("data", "t2-k0", b"v2")
        promoted.flush()
        promoted.wait_replication()
        if promoted.fenced:
            violations.append("quorum-election: promoted store got fenced")

        tailer = gcs_store.ReplicaTailer(f_b)
        tailer.poll()
        tables, term = tailer.tables, tailer.term
        if term != 2:
            violations.append(
                f"quorum-rejoin: fB fence/term is {term} after catch-up, "
                "expected the promoted term 2"
            )
        have = set(tables.get("data", {}).keys())
        missing = (set(acked) | {"t2-k0"}) - have
        if missing:
            violations.append(
                "quorum-rejoin: fB missing keys after catch-up snapshot: "
                f"{sorted(missing)}"
            )
        return violations

    def cleanup(self) -> None:
        from ray_tpu_torch._private import gcs_store

        gcs_store.heal_all_partitions()
        for store in self._stores:
            try:
                store.close()
            except Exception:
                pass
        self._stores.clear()
        shutil.rmtree(self._tmp, ignore_errors=True)


class ResubscribeGap:
    """Pubsub overflow-shed / snapshot-pull gap closure, frame by frame.

    A real ``pubsub.Publisher`` and a real ``gcs.GcsClient`` talk over an
    in-memory transport pair where EVERY frame delivery is an explorer
    choice point.  The subscriber's buffer is pinned to one message, so
    publishing three versions can shed the backlog in any pattern the
    schedule allows; a shed shows up client-side as a seqno gap, which must
    trigger the Snapshot pull and still converge.  Invariants per schedule:

    - convergence: the client's last delivered version equals the
      publisher's final state and its seqno cursor catches up;
    - monotonicity: delivered versions never go backwards (a stale
      snapshot applied over a newer pub would).
    """

    MUTATIONS = ()
    CHANNEL = "explore:counter"

    def __init__(self, mutations: Sequence[str] = ()):
        from ray_tpu_torch._private.common import config

        self._config = config
        # Buffer of ONE queued message per subscriber: any two publishes in
        # flight shed the older (instance attr; _Config.__getattr__ caches
        # computed values on the instance, so pop() restores the default).
        config.pubsub_max_buffered_msgs = 1

    async def run(self) -> List[str]:
        from ray_tpu_torch._private import gcs, pubsub
        from ray_tpu_torch.devtools import explore

        violations: List[str] = []
        publisher = pubsub.Publisher()
        state = {"v": 0}
        term = 1
        server_side: Dict[str, Any] = {}

        # Thin GCS façade: the Subscribe/Snapshot reply shapes of
        # gcs.GcsServer over the scenario's `state`, without the server's
        # store/node machinery.
        async def on_subscribe(conn: Any, p: dict) -> dict:
            seq = publisher.subscribe(p["channel"], server_side["conn"])
            return {
                "ok": True,
                "seq": seq,
                "pub_epoch": publisher.epoch,
                "leader_term": term,
            }

        async def on_snapshot(conn: Any, p: dict) -> dict:
            return {
                "snapshot": {"v": state["v"]},
                "seq": publisher.seqnos.get(p["channel"], 0),
                "pub_epoch": publisher.epoch,
                "leader_term": term,
            }

        client_conn, server_conn = explore.virtual_connection_pair(
            {},
            {"Subscribe": on_subscribe, "Snapshot": on_snapshot},
        )
        server_side["conn"] = server_conn
        client = gcs.GcsClient(client_conn)

        delivered: List[int] = []

        def on_msg(msg: Any) -> None:
            if isinstance(msg, dict) and "v" in msg:
                delivered.append(msg["v"])

        await client.subscribe(self.CHANNEL, on_msg)

        async def publish_stream() -> None:
            for v in (1, 2):
                state["v"] = v
                publisher.publish(self.CHANNEL, {"v": v})
                await asyncio.sleep(0)
            # Third version lands in the same tick as the second flush:
            # with a 1-message budget the drain can shed either.
            state["v"] = 3
            publisher.publish(self.CHANNEL, {"v": 3})

        await publish_stream()

        # Convergence: bounded settle loop (virtual time, so "waiting" is
        # just scheduling the remaining drain/snapshot machinery).
        for _ in range(40):
            caught_up = (
                delivered
                and delivered[-1] == state["v"]
                and client._sub_seq.get(self.CHANNEL, 0)
                >= publisher.seqnos.get(self.CHANNEL, 0)
            )
            if caught_up:
                break
            await asyncio.sleep(0.001)
        else:
            violations.append(
                "resubscribe-gap: client never converged — delivered "
                f"{delivered}, state v={state['v']}, client seq "
                f"{client._sub_seq.get(self.CHANNEL)}, publisher seq "
                f"{publisher.seqnos.get(self.CHANNEL)}"
            )

        for prev, cur in zip(delivered, delivered[1:]):
            if cur < prev:
                violations.append(
                    f"resubscribe-gap: delivered versions went backwards "
                    f"({prev} -> {cur}) in {delivered}"
                )
                break

        return violations

    def cleanup(self) -> None:
        self._config.__dict__.pop("pubsub_max_buffered_msgs", None)


SCENARIOS: Dict[str, ScenarioSpec] = {
    "lease_exactly_once": ScenarioSpec(
        LeaseExactlyOnce,
        "duplicate RequestWorkerLease frames racing a cancel against the "
        "grant ledger (mutation: double_grant re-seeds the bug)",
    ),
    "ha_promotion": ScenarioSpec(
        HaPromotion,
        "term-2 standby promotion racing a still-writing term-1 primary "
        "over a shared follower: fencing, ack durability, leadership",
    ),
    "quorum_election": ScenarioSpec(
        QuorumElection,
        "promotion over 2 survivors racing a partitioned laggard's rejoin: "
        "fail-closed QuorumLostError, quorum-freshest adoption, fence bump",
    ),
    "resubscribe_gap": ScenarioSpec(
        ResubscribeGap,
        "pubsub overflow shedding with a 1-message buffer: seqno gap must "
        "trigger a snapshot pull and converge monotonically",
    ),
}
