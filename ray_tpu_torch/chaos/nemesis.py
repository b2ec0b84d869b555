"""Process-level nemesis actions (Jepsen's nemesis, scoped to the
in-process cluster harness): kill a worker process, kill a raylet, restart
the GCS. Victim selection is by plan-provided pick index over a *sorted*
candidate list so a replayed seed attacks the same victim whenever cluster
membership at the fire point matches.

Every action is something the runtime promises to survive: killed workers
are re-leased and their tasks retried, killed raylets trigger lineage
reconstruction on surviving nodes, a restarted GCS resumes from its
persisted tables.
"""

from __future__ import annotations

import logging
from typing import List, Optional

logger = logging.getLogger(__name__)

ACTIONS = (
    "kill_worker", "kill_replica", "kill_raylet", "restart_gcs", "crash_gcs",
    "kill_collective_rank", "kill_gcs_host", "partition_follower",
    "heal_partition", "partition_majority",
)

# Actor-name prefix of Serve replica workers (ReplicaID.to_actor_name).
SERVE_REPLICA_PREFIX = "SERVE_REPLICA::"

# Actor-name prefix of collective-group rank actors (the chaos collective
# workload names its ranks this way). The group's rendezvous actor
# (`__collective_*`) is deliberately NOT a target: killing it exercises the
# same store-death path, but the invariant under test is peer death
# detection mid-op (docs/collectives.md "Failure semantics").
COLLECTIVE_RANK_PREFIX = "COLLECTIVE_RANK::"


class Nemesis:
    """Fires plan points against a live :class:`~ray_tpu_torch.cluster_utils.Cluster`.

    ``protect_head``: the head raylet hosts the driver's object store in the
    smoke scenarios, so kill_raylet targets non-head nodes when any exist.
    """

    def __init__(self, cluster, protect_head: bool = True):
        self.cluster = cluster
        self.protect_head = protect_head
        self.actions_fired: List[str] = []
        # crash_gcs durability violations (acknowledged control-plane state
        # missing after the crash-restart); the runner folds these into the
        # seed's violation list.
        self.state_loss: List[str] = []

    async def fire(self, action: str, pick: int) -> Optional[str]:
        """Run one action; returns a human-readable description (or None if
        no eligible target existed — e.g. no spawned workers yet)."""
        if action == "kill_worker":
            return self._kill_worker(pick)
        if action == "kill_replica":
            return self._kill_replica(pick)
        if action == "kill_collective_rank":
            return self._kill_collective_rank(pick)
        if action == "kill_raylet":
            return await self._kill_raylet(pick)
        if action == "restart_gcs":
            return await self._restart_gcs()
        if action == "crash_gcs":
            return await self._crash_gcs()
        if action == "kill_gcs_host":
            return await self._kill_gcs_host()
        if action == "partition_follower":
            return self._partition_follower(pick)
        if action == "heal_partition":
            return self._heal_partition()
        if action == "partition_majority":
            return await self._partition_majority()
        raise ValueError(f"unknown nemesis action {action!r}")

    def _kill_worker(self, pick: int) -> Optional[str]:
        candidates = []
        for node_id in sorted(self.cluster.raylets):
            raylet = self.cluster.raylets[node_id]
            for worker_id in sorted(raylet.workers):
                handle = raylet.workers[worker_id]
                if handle.proc is not None and handle.proc.returncode is None:
                    candidates.append((node_id, worker_id, handle))
        if not candidates:
            return None
        node_id, worker_id, handle = candidates[pick % len(candidates)]
        try:
            handle.proc.kill()  # SIGKILL: no atexit, no farewell RPC
        except ProcessLookupError:
            return None
        self.actions_fired.append("kill_worker")
        logger.info("nemesis: killed worker %s on %s", worker_id[:8], node_id[:8])
        return f"kill_worker {worker_id[:8]}@{node_id[:8]}"

    def _kill_replica(self, pick: int) -> Optional[str]:
        """SIGKILL a worker hosting a Serve *replica* actor — never the
        controller or proxy, whose loss is a control-plane outage rather than
        the data-plane fault the serve scenarios exercise. The controller's
        health loop must replace the replica and routers must route around
        the corpse."""
        gcs = self.cluster.gcs_server
        if gcs is None:
            return None
        replica_workers = {
            a.worker_id
            for a in gcs.actors.values()
            if a.state == "ALIVE"
            and (a.name or "").startswith(SERVE_REPLICA_PREFIX)
            and a.worker_id
        }
        candidates = []
        for node_id in sorted(self.cluster.raylets):
            raylet = self.cluster.raylets[node_id]
            for worker_id in sorted(raylet.workers):
                if worker_id not in replica_workers:
                    continue
                handle = raylet.workers[worker_id]
                if handle.proc is not None and handle.proc.returncode is None:
                    candidates.append((node_id, worker_id, handle))
        if not candidates:
            return None
        node_id, worker_id, handle = candidates[pick % len(candidates)]
        try:
            handle.proc.kill()
        except ProcessLookupError:
            return None
        self.actions_fired.append("kill_replica")
        logger.info(
            "nemesis: killed serve replica worker %s on %s",
            worker_id[:8],
            node_id[:8],
        )
        return f"kill_replica {worker_id[:8]}@{node_id[:8]}"

    def _kill_collective_rank(self, pick: int) -> Optional[str]:
        """SIGKILL a worker hosting a collective-group rank actor while its
        group op is in flight. The surviving ranks' blocked ops must fail
        with a typed CollectiveGroupDiedError within the health deadline —
        never hang (docs/collectives.md)."""
        gcs = self.cluster.gcs_server
        if gcs is None:
            return None
        rank_workers = {
            a.worker_id
            for a in gcs.actors.values()
            if a.state == "ALIVE"
            and (a.name or "").startswith(COLLECTIVE_RANK_PREFIX)
            and a.worker_id
        }
        candidates = []
        for node_id in sorted(self.cluster.raylets):
            raylet = self.cluster.raylets[node_id]
            for worker_id in sorted(raylet.workers):
                if worker_id not in rank_workers:
                    continue
                handle = raylet.workers[worker_id]
                if handle.proc is not None and handle.proc.returncode is None:
                    candidates.append((node_id, worker_id, handle))
        if not candidates:
            return None
        node_id, worker_id, handle = candidates[pick % len(candidates)]
        try:
            handle.proc.kill()
        except ProcessLookupError:
            return None
        self.actions_fired.append("kill_collective_rank")
        logger.info(
            "nemesis: killed collective rank worker %s on %s",
            worker_id[:8],
            node_id[:8],
        )
        return f"kill_collective_rank {worker_id[:8]}@{node_id[:8]}"

    async def _kill_raylet(self, pick: int) -> Optional[str]:
        head_id = (
            self.cluster.head_node.raylet.node_id
            if self.cluster.head_node is not None
            else None
        )
        candidates = [
            nid
            for nid in sorted(self.cluster.raylets)
            if not (self.protect_head and nid == head_id)
        ]
        if not candidates:
            return None
        node_id = candidates[pick % len(candidates)]
        raylet = self.cluster.raylets.pop(node_id)
        await raylet.stop()
        self.actions_fired.append("kill_raylet")
        logger.info("nemesis: killed raylet %s", node_id[:8])
        return f"kill_raylet {node_id[:8]}"

    async def _restart_gcs(self) -> Optional[str]:
        node = self.cluster.head_node
        if node is None or node.gcs_server is None:
            return None
        await node.kill_gcs()
        await node.restart_gcs()
        # cluster_utils keeps its own reference for shutdown(); refresh it.
        self.cluster.gcs_server = node.gcs_server
        self.actions_fired.append("restart_gcs")
        logger.info("nemesis: restarted GCS")
        return "restart_gcs"

    async def _crash_gcs(self) -> Optional[str]:
        """Hard-crash the GCS — no store checkpoint, no final fsync, a torn
        half-record on the WAL tail — then restart it and diff the restored
        control-plane tables against the pre-crash picture. Every record
        acknowledged before the crash must survive (group commit flushes to
        the OS on crash; only an OS-level crash may lose the last tick)."""
        gcs = self.cluster.gcs_server
        if gcs is None:
            return None
        from ray_tpu_torch._private.gcs_store import InMemoryStoreClient

        durable = not isinstance(gcs.store, InMemoryStoreClient)
        pre = {
            "actors": set(gcs.actors),
            "pgs": set(gcs.placement_groups),
            "jobs": set(gcs.jobs),
            "named": dict(gcs.named_actors),
            "kv": dict(gcs.kv),
        }
        node = self.cluster.head_node
        if node is not None and node.gcs_server is not None:
            await node.crash_gcs(torn_tail=True)
            await node.restart_gcs()
            self.cluster.gcs_server = node.gcs_server
        elif hasattr(self.cluster, "crash_gcs_async"):
            # SimCluster shape: no Node wrapper, the sim owns its GCS.
            if not await self.cluster.crash_gcs_async(torn_tail=True):
                return None
        else:
            return None
        if durable:
            new = self.cluster.gcs_server
            post = {
                "actors": set(new.actors),
                "pgs": set(new.placement_groups),
                "jobs": set(new.jobs),
            }
            for table in ("actors", "pgs", "jobs"):
                lost = pre[table] - post[table]
                if lost:
                    self.state_loss.append(
                        f"state-loss: {len(lost)} {table} record(s) gone "
                        f"after crash-restart (e.g. {sorted(lost)[:3]})"
                    )
            for (ns, name), aid in pre["named"].items():
                if new.named_actors.get((ns, name)) != aid:
                    self.state_loss.append(
                        f"state-loss: named actor {ns}/{name} -> {aid[:8]} "
                        "gone after crash-restart"
                    )
            for key, value in pre["kv"].items():
                if new.kv.get(key) != value:
                    self.state_loss.append(
                        f"state-loss: kv {key} changed/gone after "
                        "crash-restart"
                    )
        self.actions_fired.append("crash_gcs")
        logger.info("nemesis: crashed GCS (torn WAL tail) and restarted")
        return "crash_gcs"

    async def _kill_gcs_host(self) -> Optional[str]:
        """Lose the whole GCS *machine* (process killed hard AND its local
        replicated-log member dropped), then wait for the warm standby to
        promote over the surviving follower log. Every record acknowledged
        before the kill must be present in the new leader's tables — the
        zero-acknowledged-state-loss invariant for HA failover
        (docs/fault_tolerance.md "HA deployment")."""
        gcs = self.cluster.gcs_server
        if gcs is None:
            return None
        pre = {
            "actors": set(gcs.actors),
            "pgs": set(gcs.placement_groups),
            "jobs": set(gcs.jobs),
            "named": dict(gcs.named_actors),
            "kv": dict(gcs.kv),
        }
        pre_term = gcs.leader_term
        node = self.cluster.head_node
        if node is not None and getattr(node, "gcs_standby", None) is not None:
            await node.kill_gcs_host()
            self.cluster.gcs_server = node.gcs_server
        elif hasattr(self.cluster, "kill_gcs_host_async"):
            # SimCluster shape: no Node wrapper, the sim owns its GCS.
            if not await self.cluster.kill_gcs_host_async():
                return None
        else:
            return None
        new = self.cluster.gcs_server
        if new.leader_term <= pre_term:
            self.state_loss.append(
                f"split-brain: promoted leader term {new.leader_term} did "
                f"not advance past {pre_term}"
            )
        post = {
            "actors": set(new.actors),
            "pgs": set(new.placement_groups),
            "jobs": set(new.jobs),
        }
        for table in ("actors", "pgs", "jobs"):
            lost = pre[table] - post[table]
            if lost:
                self.state_loss.append(
                    f"state-loss: {len(lost)} {table} record(s) gone "
                    f"after failover (e.g. {sorted(lost)[:3]})"
                )
        for (ns, name), aid in pre["named"].items():
            if new.named_actors.get((ns, name)) != aid:
                self.state_loss.append(
                    f"state-loss: named actor {ns}/{name} -> {aid[:8]} "
                    "gone after failover"
                )
        for key, value in pre["kv"].items():
            if new.kv.get(key) != value:
                self.state_loss.append(
                    f"state-loss: kv {key} changed/gone after failover"
                )
        self.actions_fired.append("kill_gcs_host")
        logger.info(
            "nemesis: killed GCS host; standby promoted at term %d",
            new.leader_term,
        )
        return f"kill_gcs_host term={new.leader_term}"

    # -- replication-group partitions (docs/fault_tolerance.md §HA) ----------

    def _gcs_persist_path(self) -> Optional[str]:
        node = getattr(self.cluster, "head_node", None)
        if node is not None and hasattr(node, "gcs_persist_path"):
            return node.gcs_persist_path()
        return getattr(self.cluster, "persist_path", None)

    def _partition_follower(self, pick: int) -> Optional[str]:
        """Partition one follower member away from the leader — a strict
        minority of a ≥3-member group. The quorum-ack contract says this
        must NOT stall or demote the leader: commits keep acking on the
        remaining majority while the partitioned member's lag grows."""
        import os

        from ray_tpu_torch._private.gcs_store import (
            follower_paths, partition_host, partitioned_hosts,
        )

        gcs = self.cluster.gcs_server
        path = self._gcs_persist_path()
        if gcs is None or not path:
            return None
        followers = follower_paths(path)
        # One partition at a time: this action models a minority fault, and
        # stacking it must not silently become a majority partition.
        if partitioned_hosts() or len(followers) < 2:
            return None
        target = followers[pick % len(followers)]
        partition_host(target)
        self.actions_fired.append("partition_follower")
        logger.info("nemesis: partitioned follower %s", os.path.basename(target))
        return f"partition_follower {os.path.basename(target)}"

    def _heal_partition(self) -> Optional[str]:
        """Heal every injected partition. Before healing, verify the
        minority partition did not demote the leader — commits must have
        kept flowing on the majority the whole time."""
        from ray_tpu_torch._private.gcs_store import heal_all_partitions, partitioned_hosts

        if not partitioned_hosts():
            return None
        gcs = self.cluster.gcs_server
        if gcs is not None and gcs.fenced:
            self.state_loss.append(
                "quorum: leader demoted under a minority partition "
                "(commits must keep acking on the majority)"
            )
        heal_all_partitions()
        self.actions_fired.append("heal_partition")
        logger.info("nemesis: healed all partitions")
        return "heal_partition"

    async def _partition_majority(self) -> Optional[str]:
        """Partition EVERY follower away from the leader: no write can
        reach a majority, so the leader must demote itself (fence, typed
        StaleLeaderError to clients) rather than ack unreplicated writes.
        After healing, the standby promotes at a higher term and every
        record acknowledged before the partition must survive."""
        import asyncio

        from ray_tpu_torch._private.common import config
        from ray_tpu_torch._private.gcs_store import (
            follower_paths, heal_all_partitions, partition_host,
        )

        gcs = self.cluster.gcs_server
        path = self._gcs_persist_path()
        if gcs is None or not path:
            return None
        node = getattr(self.cluster, "head_node", None)
        has_standby = (
            node is not None and getattr(node, "gcs_standby", None) is not None
        ) or hasattr(self.cluster, "adopt_promoted_gcs_async")
        if not has_standby:
            return None
        pre = {
            "actors": set(gcs.actors),
            "pgs": set(gcs.placement_groups),
            "jobs": set(gcs.jobs),
            "named": dict(gcs.named_actors),
            "kv": dict(gcs.kv),
        }
        pre_term = gcs.leader_term
        for f in follower_paths(path):
            partition_host(f)
        # The leader discovers the loss on its next group commit — at the
        # latest the lease renewal, every lease/3. Wait for the demotion.
        deadline = config.gcs_leader_lease_s * 4.0 + 5.0
        waited = 0.0
        while not gcs.fenced and waited < deadline:
            await asyncio.sleep(0.05)
            waited += 0.05
        if not gcs.fenced:
            heal_all_partitions()
            self.state_loss.append(
                "quorum: leader kept serving with every follower partitioned "
                "(must demote rather than ack unreplicated writes)"
            )
            return None
        heal_all_partitions()
        # With the partition healed the standby promotes past the demoted
        # leader; adopt the new server like kill_gcs_host does.
        if node is not None and getattr(node, "gcs_standby", None) is not None:
            await node.adopt_promoted_gcs()
            self.cluster.gcs_server = node.gcs_server
        else:
            if not await self.cluster.adopt_promoted_gcs_async():
                return None
        new = self.cluster.gcs_server
        if new.leader_term <= pre_term:
            self.state_loss.append(
                f"split-brain: promoted leader term {new.leader_term} did "
                f"not advance past {pre_term} after majority partition"
            )
        post = {
            "actors": set(new.actors),
            "pgs": set(new.placement_groups),
            "jobs": set(new.jobs),
        }
        for table in ("actors", "pgs", "jobs"):
            lost = pre[table] - post[table]
            if lost:
                self.state_loss.append(
                    f"state-loss: {len(lost)} {table} record(s) gone "
                    f"after majority-partition failover (e.g. {sorted(lost)[:3]})"
                )
        for (ns, name), aid in pre["named"].items():
            if new.named_actors.get((ns, name)) != aid:
                self.state_loss.append(
                    f"state-loss: named actor {ns}/{name} -> {aid[:8]} "
                    "gone after majority-partition failover"
                )
        for key, value in pre["kv"].items():
            if new.kv.get(key) != value:
                self.state_loss.append(
                    f"state-loss: kv {key} changed/gone after "
                    "majority-partition failover"
                )
        self.actions_fired.append("partition_majority")
        logger.info(
            "nemesis: majority partition -> leader demoted, standby "
            "promoted at term %d",
            new.leader_term,
        )
        return f"partition_majority term={new.leader_term}"
