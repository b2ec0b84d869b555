"""Scenario runner + ``python -m ray_tpu_torch.chaos`` CLI.

A *scenario* names a cluster shape, a workload, a set of fault specs, and
optional nemesis actions; a *run* executes one scenario under one seed's
:class:`FaultSchedule`, then drives the cluster to quiescence and checks the
convergence invariants plus two functional probes (old refs still ``get``
correctly — reconstruction allowed — and a fresh task still runs). Failing
seeds are appended to a JSONL replay corpus; ``--replay`` re-runs them.

Within one scenario the cluster is reused across seeds (boot cost is paid
once); any seed that fails invariants gets the cluster rebuilt so one bad
seed cannot poison the next. Scenario env overrides (chunk size, stall
timeout) are applied before cluster boot and restored after.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.chaos.schedule import FaultSchedule, FaultSpec, NemesisPlan

# -- workload helpers --------------------------------------------------------

TRANSFER_BLOB_SIZE = 300_000  # > max_direct_call_object_size -> plasma


def _blob(tag) -> bytes:
    """Deterministic payload for a tag; verified bytewise after transfer."""
    h = hashlib.sha256(repr(tag).encode()).digest()
    return (h * (TRANSFER_BLOB_SIZE // len(h) + 1))[:TRANSFER_BLOB_SIZE]


def _produce_blob(tag):
    import hashlib as _hashlib

    h = _hashlib.sha256(repr(tag).encode()).digest()
    return (h * (300_000 // len(h) + 1))[:300_000]


SPILL_BLOB_SIZE = 4 * 1024 * 1024  # a handful oversubscribe the spill arena
_SPILL_ARENA = 32 * 1024 * 1024  # per-node object store for spill scenarios


def _spill_digest(tag) -> str:
    """sha256 of the deterministic 4 MB payload for a tag (the payload bytes
    themselves; equal whether the value round-trips as bytes or uint8)."""
    h = hashlib.sha256(repr(tag).encode()).digest()
    blob = (h * (SPILL_BLOB_SIZE // len(h) + 1))[:SPILL_BLOB_SIZE]
    return hashlib.sha256(blob).hexdigest()


def _produce_spill_blob(tag):
    import hashlib as _hashlib

    import numpy as _np

    h = _hashlib.sha256(repr(tag).encode()).digest()
    n = 4 * 1024 * 1024
    # uint8 array, not bytes: numpy values are weakref-able, so the driver's
    # zero-copy value hold dies with the value and an already-pulled copy
    # stays evictable — bytes would pin the oversubscribed arena for the
    # ObjectRef's whole lifetime and wedge later pulls.
    return _np.frombuffer((h * (n // len(h) + 1))[:n], dtype=_np.uint8)


def _add(a, b):
    return a + b


class _ServeEcho:
    """Serve chaos workload: echo with a small await, so process kills land
    mid-request and delay faults have a handler window to bite."""

    async def __call__(self, x):
        await asyncio.sleep(0.02)
        return x


class _CollectiveRank:
    """Collective chaos workload: one rank of a store-backend group. The
    caller staggers contributions (delay_s) so peers are parked inside the
    group op when the nemesis kills a rank — the survivors' blocked
    allreduce must fail typed within the health deadline, never hang."""

    def __init__(self, group: str, world: int, rank: int):
        self.group, self.world, self.rank = group, world, rank

    def join(self) -> int:
        """Form the group (rendezvous actor + member registration). The
        driver gates on every rank's join before arming the nemesis: the
        scenario tests death mid-OP — a rank killed before it registers is
        unwatchable by design (nothing to watch yet)."""
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(
            self.world, self.rank, backend="store", group_name=self.group
        )
        return self.rank

    def reduce(self, delay_s: float = 0.0) -> float:
        import time as _time

        import numpy as np

        from ray_tpu_torch.util import collective as col

        if delay_s:
            _time.sleep(delay_s)
        out = col.allreduce(
            np.full(1024, float(self.rank + 1), dtype=np.float64),
            group_name=self.group,
        )
        return float(out[0])


# -- scenario catalog --------------------------------------------------------


@dataclass
class Scenario:
    name: str
    description: str
    specs: List[FaultSpec]
    workload: str  # "tasks" | "transfer" | "serve" | "sched" | "collective" | "spill"
    steps: int = 3
    nemesis: List[str] = field(default_factory=list)
    remote_node: bool = False  # add a {"victim": 2} node for cross-node work
    env: Dict[str, str] = field(default_factory=dict)
    # Shrink each node's arena (spill workload: working set is sized as a
    # multiple of this, so pressure spilling is guaranteed, not incidental).
    object_store_memory: Optional[int] = None
    # Re-add a victim node at the end of a seed run if nemesis removed one.
    repair: bool = False
    # sched workload: size of the SimCluster (in-process raylets, no driver).
    sim_nodes: int = 0
    # sched workload: boot the SimCluster's GCS with a durable store (a
    # session tempdir) so crash_gcs has acknowledged state to recover.
    persist: bool = False
    # sched workload: replicated store + warm standby + leader file, so the
    # kill_gcs_host nemesis has a follower log to fail over onto.
    ha: bool = False
    # serve workload: per-request budget, and whether to tear down the
    # process-wide router between steps (it must rebuild from the controller).
    serve_timeout_s: float = 2.0
    router_restart: bool = False


_TRANSFER_ENV = {
    # Small chunks so one blob is many PushChunk frames; quick stall
    # detection so dropped tails re-request within the step, not after 30s.
    "RAY_TPU_OBJECT_CHUNK_SIZE": "32768",
    "RAY_TPU_PULL_STALL_TIMEOUT_S": "1.0",
    "RAY_TPU_WORKER_LEASE_IDLE_KEEP_S": "0.2",
}

_TASKS_ENV = {"RAY_TPU_WORKER_LEASE_IDLE_KEEP_S": "0.2"}

_SPILL_ENV = {
    # Spill decisions must land within a step, and a pull whose source died
    # mid-transfer re-requests quickly instead of riding out the default
    # stall window.
    "RAY_TPU_OBJECT_SPILLING_POLL_INTERVAL_S": "0.05",
    "RAY_TPU_PULL_STALL_TIMEOUT_S": "1.0",
    "RAY_TPU_WORKER_LEASE_IDLE_KEEP_S": "0.2",
}

_LATENCY_ENV = {
    # Per-attempt cap on the retryable GCS channel: a dropped reply is
    # re-issued after 2s instead of hanging the caller's whole budget.
    # Safe here because the latency workloads are tasks-only (no
    # CreateActor wait_alive long-polls ride the GCS channel).
    "RAY_TPU_RPC_DEFAULT_TIMEOUT_S": "2.0",
    "RAY_TPU_WORKER_LEASE_IDLE_KEEP_S": "0.2",
}


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario(
            name="rpc_delay",
            description="control-plane latency: lease requests and object "
            "lookups delayed 5-40ms",
            specs=[
                FaultSpec("delay-lease", "delay", "RequestWorkerLease",
                          frame="request", p=0.7, delay_s=(0.005, 0.04)),
                FaultSpec("delay-objget", "delay", "ObjGet",
                          frame="reply", p=0.5, delay_s=(0.005, 0.04)),
            ],
            workload="tasks",
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="dup_lease",
            description="wire-level duplication of RequestWorkerLease frames "
            "(the raylet.leases write-write reproducer)",
            specs=[
                FaultSpec("dup-lease", "dup", "RequestWorkerLease",
                          frame="request", p=1.0, max_fires=3),
            ],
            workload="tasks",
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="chunk_loss",
            description="one-way PushChunk loss mid object transfer; pulls "
            "must stall-detect and re-request",
            specs=[
                FaultSpec("lose-chunks", "drop", "PushChunk",
                          frame="push", p=0.25),
            ],
            workload="transfer",
            remote_node=True,
            env=dict(_TRANSFER_ENV),
        ),
        Scenario(
            name="reorder_push",
            description="adjacent PushChunk reordering; destination aborts "
            "the corrupt assembly and the pull recovers",
            specs=[
                FaultSpec("swap-chunks", "reorder", "PushChunk",
                          frame="push", p=0.15),
            ],
            workload="transfer",
            remote_node=True,
            env=dict(_TRANSFER_ENV),
        ),
        Scenario(
            name="kill_worker",
            description="SIGKILL a live worker between steps; tasks retry on "
            "a fresh lease",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["kill_worker"],
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="gcs_restart",
            description="kill + restart the GCS mid-workload; raylets "
            "re-register and work resumes",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["restart_gcs"],
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="latency_storm",
            description="heavy ambient latency: every request and reply "
            "delayed 5-80ms with p=0.35; deadlines must shrink hop to hop "
            "and no handler may outlive its caller",
            specs=[
                FaultSpec("delay-req", "delay", "*",
                          frame="request", p=0.35, delay_s=(0.005, 0.08)),
                FaultSpec("delay-rep", "delay", "*",
                          frame="reply", p=0.35, delay_s=(0.005, 0.08)),
            ],
            workload="tasks",
            env=dict(_LATENCY_ENV),
        ),
        Scenario(
            name="latency_gcs_drop",
            description="GCS reply loss: idempotent control-plane replies "
            "dropped; the retryable channel re-issues within its budget "
            "(named methods only — blanket drops would hang long-polls)",
            specs=[
                FaultSpec("drop-kv", "drop", "KV*",
                          frame="reply", p=0.2),
                FaultSpec("drop-resources", "drop", "UpdateResources",
                          frame="reply", p=0.3),
                FaultSpec("drop-nodes", "drop", "GetAllNodes",
                          frame="reply", p=0.3),
            ],
            workload="tasks",
            env=dict(_LATENCY_ENV),
        ),
        Scenario(
            name="latency_gcs_restart",
            description="ambient request latency plus a GCS kill+restart: "
            "GCS-bound calls queue across the failover and drain after "
            "reconnect as latency blips, not errors",
            specs=[
                FaultSpec("delay-req", "delay", "*",
                          frame="request", p=0.25, delay_s=(0.005, 0.06)),
            ],
            workload="tasks",
            steps=4,
            nemesis=["restart_gcs"],
            env=dict(_LATENCY_ENV),
        ),
        Scenario(
            name="serve_replica_kill",
            description="SIGKILL a serve replica worker while 16 requests "
            "are in flight; failures surface typed, the health loop replaces "
            "the replica, and fresh requests route around the corpse",
            specs=[],
            workload="serve",
            steps=4,
            nemesis=["kill_replica"],
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="serve_deadline_storm",
            description="delay serve data-plane dispatch 10-120ms against a "
            "tight 0.4s request budget; excess latency must come back as "
            "typed sheds or deadline cuts, never an admitted request "
            "outliving its deadline",
            specs=[
                FaultSpec("delay-dispatch", "delay", "PushActorTask",
                          frame="request", p=0.5, delay_s=(0.01, 0.12)),
                FaultSpec("delay-dispatch-rep", "delay", "PushActorTask",
                          frame="reply", p=0.5, delay_s=(0.01, 0.12)),
            ],
            workload="serve",
            steps=4,
            serve_timeout_s=0.4,
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="serve_router_restart",
            description="tear down the process-wide router between steps; a "
            "fresh router rebuilds its replica view from the controller and "
            "requests keep succeeding",
            specs=[],
            workload="serve",
            steps=4,
            router_restart=True,
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="collective_rank_kill",
            description="SIGKILL a collective-group rank while its peers "
            "are parked inside a store-backend allreduce; survivors must "
            "fail with a typed CollectiveGroupDiedError within the health "
            "deadline — never hang — and the cluster keeps running fresh "
            "work",
            specs=[],
            workload="collective",
            steps=3,
            nemesis=["kill_collective_rank"],
            env=dict(
                _TASKS_ENV,
                RAY_TPU_COLLECTIVE_HEALTH_INTERVAL_S="0.25",
                RAY_TPU_COLLECTIVE_TIMEOUT_S="20",
            ),
        ),
        Scenario(
            name="kill_raylet",
            description="kill the node holding transferred objects; refs "
            "recover via lineage reconstruction",
            specs=[],
            workload="transfer",
            steps=3,
            nemesis=["kill_raylet"],
            remote_node=True,
            repair=True,
            env=dict(_TRANSFER_ENV),
        ),
        Scenario(
            name="spill_kill_raylet",
            description="working set 4x the arena forces pressure spilling "
            "on the victim node, then the node dies (its spill files die "
            "with it); every acknowledged object must come back bytewise "
            "intact via restore or lineage re-execution, or fail with the "
            "typed reconstruction error — never wrong bytes or a hang",
            specs=[],
            workload="spill",
            steps=3,
            nemesis=["kill_raylet"],
            remote_node=True,
            repair=True,
            env=dict(_SPILL_ENV),
            object_store_memory=_SPILL_ARENA,
        ),
        Scenario(
            name="spill_kill_worker",
            description="working set 4x the arena with a worker SIGKILLed "
            "between steps: producers retry on fresh leases while the "
            "pressure loop keeps spilling, and no acknowledged object is "
            "lost or corrupted",
            specs=[],
            workload="spill",
            steps=3,
            nemesis=["kill_worker"],
            remote_node=True,
            env=dict(_SPILL_ENV),
            object_store_memory=_SPILL_ARENA,
        ),
        Scenario(
            name="recovery_durable",
            description="hard-crash the GCS (no checkpoint, torn WAL tail) "
            "mid-workload; recovery truncates the torn frame, reloads every "
            "acknowledged record losslessly, and reconciliation re-drives "
            "in-flight creations",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["crash_gcs"],
            env=dict(_TASKS_ENV),
        ),
        Scenario(
            name="recovery_durable_sim",
            description="200-node simulated cluster: crash the persistent "
            "GCS (torn WAL) under concurrent lease storms; restored state "
            "must be lossless and the 200-raylet reconnect wave must "
            "re-register without melting the control plane",
            specs=[],
            workload="sched",
            steps=3,
            nemesis=["crash_gcs"],
            sim_nodes=200,
            persist=True,
        ),
        Scenario(
            name="kill_gcs_host",
            description="lose the whole GCS machine mid-workload (process "
            "killed hard, its replicated-log member gone with the disk); "
            "the warm standby promotes over the surviving follower log, "
            "clients re-target via the leader file, and every acknowledged "
            "record survives — zero state loss, no split-brain",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["kill_gcs_host"],
            env=dict(
                _TASKS_ENV,
                RAY_TPU_GCS_PERSIST_BACKEND="replicated",
                # Fast lease turnover so promotion lands inside the seed,
                # not after a 2s production lease + grace window.
                RAY_TPU_GCS_LEADER_LEASE_S="1.0",
                RAY_TPU_GCS_STANDBY_POLL_S="0.05",
            ),
        ),
        Scenario(
            name="kill_gcs_host_sim",
            description="200-node simulated cluster: kill the GCS host "
            "under concurrent lease storms; the standby promotes from the "
            "follower log and the 200-raylet reconnect wave re-targets the "
            "new leader through the leader file without melting it",
            specs=[],
            workload="sched",
            steps=3,
            nemesis=["kill_gcs_host"],
            sim_nodes=200,
            persist=True,
            ha=True,
            env={
                "RAY_TPU_GCS_LEADER_LEASE_S": "1.0",
                "RAY_TPU_GCS_STANDBY_POLL_S": "0.05",
            },
        ),
        Scenario(
            name="partition_follower",
            description="partition one follower of the 3-member replication "
            "group mid-workload, then heal: commits must keep acking on the "
            "remaining majority (the leader never stalls or demotes), and "
            "the healed member catches back up via a snapshot frame with "
            "zero acknowledged loss",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["partition_follower", "heal_partition"],
            env=dict(
                _TASKS_ENV,
                RAY_TPU_GCS_PERSIST_BACKEND="replicated",
                RAY_TPU_GCS_LEADER_LEASE_S="1.0",
                RAY_TPU_GCS_STANDBY_POLL_S="0.05",
            ),
        ),
        Scenario(
            name="partition_majority",
            description="partition every follower away from the leader: the "
            "next group commit cannot reach a majority, so the leader must "
            "demote itself (typed StaleLeaderError, no unreplicated acks); "
            "after the heal the standby promotes at a higher term and every "
            "record acknowledged before the partition survives",
            specs=[],
            workload="tasks",
            steps=4,
            nemesis=["partition_majority"],
            env=dict(
                _TASKS_ENV,
                RAY_TPU_GCS_PERSIST_BACKEND="replicated",
                RAY_TPU_GCS_LEADER_LEASE_S="1.0",
                RAY_TPU_GCS_STANDBY_POLL_S="0.05",
            ),
        ),
        Scenario(
            name="sched_storm",
            description="120-node simulated cluster saturated with "
            "concurrent lease bursts; raylets killed mid-spillback-chain, "
            "clients re-anchor around the corpses, every surviving lease "
            "ledger must balance exactly-once",
            specs=[],
            workload="sched",
            steps=3,
            nemesis=["kill_raylet", "kill_raylet"],
            sim_nodes=120,
            repair=True,
        ),
    ]
}

SUITES: Dict[str, List[str]] = {
    # Interceptor-only faults: fast, no process churn — the CI 20-seed gate.
    "smoke": ["rpc_delay", "dup_lease", "chunk_loss", "reorder_push"],
    # Process-level nemesis: heavier, run over fewer seeds.
    "recovery": ["kill_worker", "gcs_restart", "kill_raylet"],
    # Crash-consistency: hard GCS crashes (torn WAL) with the no-state-loss
    # invariant, on a driver cluster and a 200-node sim reconnect storm —
    # plus whole-host GCS loss with warm-standby failover (HA).
    "recovery_durable": [
        "recovery_durable", "recovery_durable_sim",
        "kill_gcs_host", "kill_gcs_host_sim",
    ],
    # HA failover + replication-group partitions: the chaos-ha CI job's
    # 10+-seed gate (minority partition must not stall commits; majority
    # partition must demote the leader, then fail over on heal).
    "ha": [
        "kill_gcs_host", "kill_gcs_host_sim",
        "partition_follower", "partition_majority",
    ],
    # Delay/drop-heavy schedules exercising the RPC resilience layer
    # (retryable channels, deadline propagation, GCS failover queueing).
    "latency": ["latency_storm", "latency_gcs_drop", "latency_gcs_restart"],
    # Serving stack under fire: replica death mid-request, deadline storms,
    # router restarts — the no-request-lost-or-overrun invariant suite.
    "serve": [
        "serve_replica_kill", "serve_deadline_storm", "serve_router_restart",
    ],
    # Object plane under memory pressure: oversubscribed working sets with
    # node/worker kills — the check_no_data_loss invariant suite (the
    # chaos-spill CI job's 10-seed gate).
    "spill": ["spill_kill_raylet", "spill_kill_worker"],
    # Simulated-cluster scheduler scenarios: no driver, hundreds of
    # in-process raylets (see _private/sim_cluster.py).
    "sched": ["sched_storm"],
    # Collective groups under fire: rank death mid-allreduce must surface
    # as a typed CollectiveGroupDiedError, never a hang (docs/collectives.md).
    "collective": ["collective_rank_kill"],
    "full": [
        "rpc_delay", "dup_lease", "chunk_loss", "reorder_push",
        "latency_storm", "latency_gcs_drop", "latency_gcs_restart",
        "serve_replica_kill", "serve_deadline_storm", "serve_router_restart",
        "kill_worker", "gcs_restart", "kill_raylet", "sched_storm",
        "spill_kill_raylet", "spill_kill_worker",
        "recovery_durable", "recovery_durable_sim", "collective_rank_kill",
        "kill_gcs_host", "kill_gcs_host_sim",
        "partition_follower", "partition_majority",
    ],
}


# -- seed result -------------------------------------------------------------


@dataclass
class SeedResult:
    scenario: str
    seed: int
    ok: bool
    schedule_digest: str
    fault_log_digest: str
    faults_fired: int
    violations: List[str]
    duplicate_grants_avoided: int = 0
    stalled_streams: int = 0
    rerequested_streams: int = 0
    deadline_shed: int = 0
    deadline_enforced: int = 0
    spilled_bytes: int = 0

    def to_wire(self) -> dict:
        return {
            "scenario": self.scenario,
            "seed": self.seed,
            "ok": self.ok,
            "schedule_digest": self.schedule_digest,
            "fault_log_digest": self.fault_log_digest,
            "faults_fired": self.faults_fired,
            "violations": self.violations,
            "duplicate_grants_avoided": self.duplicate_grants_avoided,
            "stalled_streams": self.stalled_streams,
            "rerequested_streams": self.rerequested_streams,
            "deadline_shed": self.deadline_shed,
            "deadline_enforced": self.deadline_enforced,
            "spilled_bytes": self.spilled_bytes,
        }


# -- cluster/session plumbing ------------------------------------------------


class _Session:
    """One scenario's cluster + driver connection, reusable across seeds."""

    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        self._saved_env: Dict[str, Optional[str]] = {}
        for k, v in scenario.env.items():
            self._saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        from ray_tpu_torch.cluster_utils import Cluster

        head_args = {"num_cpus": 2, "num_gpus": 0}
        if scenario.object_store_memory:
            head_args["object_store_memory"] = scenario.object_store_memory
        self.cluster = Cluster(head_node_args=head_args)
        if scenario.remote_node:
            self.cluster.add_node(
                num_cpus=2,
                resources={"victim": 2},
                object_store_memory=scenario.object_store_memory,
            )
        self.cluster.connect()
        import ray_tpu_torch
        from ray_tpu_torch._private import worker as worker_mod

        self.ray = ray_tpu_torch
        self.w = worker_mod.global_worker
        self.add = ray_tpu_torch.remote(max_retries=3)(_add)
        self.produce = ray_tpu_torch.remote(
            max_retries=3, resources={"victim": 1} if scenario.remote_node else None
        )(_produce_blob)
        self.produce_spill = ray_tpu_torch.remote(
            max_retries=3, resources={"victim": 1} if scenario.remote_node else None
        )(_produce_spill_blob)
        self.serve = None
        self.serve_dep: Optional[str] = None
        if scenario.workload == "serve":
            from ray_tpu_torch import serve

            self.serve = serve
            serve.start(http_options={"enabled": False})
            echo = serve.deployment(
                num_replicas=2,
                max_ongoing_requests=4,
                max_queued_requests=32,
                # Fast death detection: a killed replica must be replaced
                # within the seed, not after a 10s default health period.
                health_check_period_s=0.25,
                health_check_timeout_s=2.0,
                graceful_shutdown_timeout_s=1.0,
            )(_ServeEcho)
            serve.run(echo.bind(), route_prefix=None)
            self.serve_dep = f"default#{echo.name}"

    def run_async(self, coro, timeout=60):
        return self.w.run_async(coro, timeout=timeout)

    def repair_victim_node(self) -> None:
        have_victim = any(
            "victim" in r.total.to_dict() for r in self.cluster.raylets.values()
        )
        if not have_victim:
            self.cluster.add_node(
                num_cpus=2,
                resources={"victim": 2},
                object_store_memory=self.scenario.object_store_memory,
            )

    def close(self) -> None:
        try:
            if self.serve is not None:
                # Also clears the cached controller handle and the
                # process-wide router — both would otherwise point into this
                # (about to die) cluster when the next session boots.
                try:
                    self.serve.shutdown()
                except Exception:
                    pass
            self.cluster.shutdown()
        finally:
            for k, old in self._saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old


# -- the seed loop -----------------------------------------------------------


def run_seed(session: _Session, scenario: Scenario, seed: int,
             verbose: bool = False) -> SeedResult:
    from ray_tpu_torch._private import rpc, telemetry
    from ray_tpu_torch.chaos import interceptors, invariants
    from ray_tpu_torch.chaos.nemesis import Nemesis

    schedule = FaultSchedule(seed, scenario.specs)
    plan = NemesisPlan(seed, scenario.nemesis, scenario.steps)
    nemesis = Nemesis(session.cluster)
    violations: List[str] = []
    probe_refs = []  # (ref, expected_digest)
    # spill workload: every acknowledged object as (ref, digest, kind) — the
    # check_no_data_loss invariant re-resolves all of them post-quiesce.
    data_ledger = []
    spill_seen = 0

    async def _install():
        # Start from a drained cluster (the previous seed's probe lease may
        # still be warm): every seed then re-requests leases and re-transfers
        # objects, so its schedule actually sees traffic to fault.
        await invariants.quiesce(session.cluster, timeout=15.0)
        # A previous seed's unhealed replication partition must not leak
        # into this one (partition_* nemesis actions are module-global).
        from ray_tpu_torch._private.gcs_store import heal_all_partitions

        heal_all_partitions()
        # Per-seed deadline accounting: the no-call-outlives-deadline
        # invariant reads these process-wide counters — and the GCS-side
        # aggregate of worker-subprocess flushes — at convergence.
        rpc.deadline_stats.reset()
        gcs = session.cluster.gcs_server
        if gcs is not None:
            gcs.worker_deadline_stats.update(met=0, shed=0, enforced=0)
            gcs.worker_deadline_stats["overruns"].clear()
        # Per-seed telemetry: zero the registry and both flight-recorder
        # rings so a violation's dump holds THIS seed's timeline only.
        telemetry.reset_all()
        from ray_tpu_torch.util import tracing

        tracing.reset()
        if gcs is not None:
            gcs.telemetry = telemetry.new_aggregate()
            gcs.flight_events.clear()
            gcs.spans.clear()
        return interceptors.install(schedule)

    async def _uninstall():
        return interceptors.uninstall()

    async def _serve_step(step, actions):
        """One burst of 16 concurrent serve requests; nemesis actions fire
        WHILE the burst is in flight (replica kill mid-request). Returns
        (outcome counters, violations, nemesis descriptions)."""
        from ray_tpu_torch.serve import handle as handle_mod
        from ray_tpu_torch.serve._private.common import DeploymentOverloadedError

        router = await handle_mod._get_router()
        outcomes = {"ok": 0, "shed": 0, "deadline": 0, "replica_error": 0}
        bad: List[str] = []
        error_samples: List[str] = []

        async def one(i):
            want = seed * 1000 + step * 100 + i
            try:
                got = await router.assign_request(
                    session.serve_dep,
                    {"call_method": "__call__", "request_id": "",
                     "multiplexed_model_id": ""},
                    (want,),
                    {},
                    timeout_s=scenario.serve_timeout_s,
                )
            except DeploymentOverloadedError:
                outcomes["shed"] += 1
            except (rpc.DeadlineExceeded, TimeoutError, asyncio.TimeoutError):
                outcomes["deadline"] += 1
            except Exception as e:
                # A replica killed mid-request surfaces as a typed
                # actor-death error: acceptable (callers can retry), unlike
                # a wrong value or a hang.
                outcomes["replica_error"] += 1
                if len(error_samples) < 3:
                    error_samples.append(f"{type(e).__name__}: {e}")
            else:
                if got != want:
                    bad.append(f"request {i} returned {got!r}, want {want}")
                else:
                    outcomes["ok"] += 1

        burst = asyncio.gather(*(one(i) for i in range(16)))
        fired = []
        if actions:
            await asyncio.sleep(0.02)  # let requests reach the replicas
            for action, pick in actions:
                desc = await nemesis.fire(action, pick)
                if desc:
                    fired.append(desc)
        await burst
        if not outcomes["ok"]:
            # Zero successes is about to be a violation: capture the
            # router's replica view so the corpus says *why* (stale set,
            # empty set, all corpses) instead of just the outcome counts.
            rs = router._replica_set(session.serve_dep)
            error_samples.append(
                f"replicas={[r.replica_id_str[-8:] for r in rs.replicas]} "
                f"stats={router.stats().get(session.serve_dep)}"
            )
        return outcomes, bad, fired, error_samples

    def _collective_step(step, actions):
        """One store-backend allreduce across fresh rank actors; nemesis
        kills fire WHILE the ranks are parked inside the op (rank 1's
        contribution is staggered, so every peer is blocked when the
        SIGKILL lands). Runs sync on the driver thread: the blocking is in
        the rank actors, not here. Returns (violations, fired)."""
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch.util.collective import CollectiveGroupDiedError

        group = f"chaos_{seed}_{step}"
        world = 2
        # Fractional CPUs: the chaos head node has 2; both ranks plus the
        # 0.1-CPU rendezvous actor must fit or rank 1 never places and the
        # group op times out without any fault having fired.
        Rank = ray_tpu_torch.remote(max_restarts=0, num_cpus=0.5)(_CollectiveRank)
        ranks = [
            Rank.options(
                name=f"COLLECTIVE_RANK::{group}_{r}"
            ).remote(group, world, r)
            for r in range(world)
        ]
        bad: List[str] = []
        try:
            # Barrier: the group must be fully formed (store actor up, every
            # member registered) before the nemesis arms — the invariant
            # under test is death MID-OP, not death during bootstrap.
            session.ray.get([a.join.remote() for a in ranks], timeout=60)
        except Exception as e:
            bad.append(
                f"step {step}: group bootstrap failed before any fault: "
                f"{type(e).__name__}: {e}"
            )
            for a in ranks:
                try:
                    session.ray.kill(a)
                except Exception:
                    pass
            return bad, []
        refs = [ranks[0].reduce.remote(0.0), ranks[1].reduce.remote(1.5)]
        _time.sleep(0.5)  # rank 0 is parked inside the allreduce now
        fired = []
        for action, pick in actions:
            async def _fire(action=action, pick=pick):
                return await nemesis.fire(action, pick)

            desc = session.run_async(_fire(), timeout=60)
            if desc:
                fired.append(desc)
        outcomes = {"ok": 0, "typed_death": 0, "victim_died": 0}
        deadline = 30.0
        for r, ref in enumerate(refs):
            t0 = _time.monotonic()
            try:
                got = session.ray.get(ref, timeout=deadline)
            except CollectiveGroupDiedError:
                # The survivor's op failed typed — the invariant under test.
                outcomes["typed_death"] += 1
            except (
                ray_tpu_torch.ActorDiedError,
                ray_tpu_torch.ActorUnavailableError,
                ray_tpu_torch.WorkerCrashedError,
            ):
                outcomes["victim_died"] += 1  # the killed rank's own call
            except ray_tpu_torch.GetTimeoutError:
                bad.append(
                    f"step {step} rank {r}: collective op hung past "
                    f"{deadline:.0f}s (after {_time.monotonic() - t0:.1f}s) "
                    "instead of failing typed"
                )
            except Exception as e:
                bad.append(
                    f"step {step} rank {r}: untyped collective failure "
                    f"{type(e).__name__}: {e}"
                )
            else:
                if got != 3.0:  # sum over ranks of full(1024, rank+1)[0]
                    bad.append(
                        f"step {step} rank {r}: allreduce returned {got}, "
                        "want 3.0"
                    )
                else:
                    outcomes["ok"] += 1
        if fired and not (outcomes["typed_death"] or outcomes["victim_died"]):
            bad.append(
                f"step {step}: nemesis fired ({fired}) but no rank observed "
                f"a death: {outcomes}"
            )
        # Reap this step's group: surviving ranks and the rendezvous actor
        # (each step builds a fresh group, so corpses must not accumulate).
        for a in ranks:
            try:
                session.ray.kill(a)
            except Exception:
                pass
        try:
            session.ray.kill(
                session.ray.get_actor(f"__collective_{group}")
            )
        except Exception:
            pass
        return bad, fired

    interceptor = session.run_async(_install(), timeout=20)
    try:
        for step in range(scenario.steps):
            actions = plan.at_step(step)
            if scenario.workload not in ("serve", "collective"):
                for action, pick in actions:
                    async def _fire(action=action, pick=pick):
                        return await nemesis.fire(action, pick)

                    fired = session.run_async(_fire(), timeout=60)
                    if verbose and fired:
                        print(f"      nemesis: {fired}")
                    if scenario.repair and fired:
                        # Autoscaler analog: replace the killed node right
                        # away so queued infeasible work and reconstruction
                        # proceed.
                        session.repair_victim_node()
            try:
                if scenario.workload == "serve":
                    outcomes, bad, fired, err_samples = session.run_async(
                        _serve_step(step, actions), timeout=90
                    )
                    if verbose and fired:
                        for desc in fired:
                            print(f"      nemesis: {desc}")
                    violations.extend(
                        f"workload: step {step} serve: {b}" for b in bad
                    )
                    if not outcomes["ok"]:
                        violations.append(
                            f"workload: step {step} no serve request "
                            f"succeeded: {outcomes} errors={err_samples}"
                        )
                elif scenario.workload == "collective":
                    bad, fired = _collective_step(step, actions)
                    if verbose and fired:
                        for desc in fired:
                            print(f"      nemesis: {desc}")
                    violations.extend(f"workload: {b}" for b in bad)
                elif scenario.workload == "tasks":
                    refs = [
                        session.add.remote(seed * 1000 + step * 10 + i, i)
                        for i in range(4)
                    ]
                    got = session.ray.get(refs, timeout=120)
                    expect = [seed * 1000 + step * 10 + 2 * i for i in range(4)]
                    if got != expect:
                        violations.append(
                            f"workload: step {step} returned {got}, "
                            f"expected {expect}"
                        )
                elif scenario.workload == "spill":
                    # One step's slice of a working set sized 4x the arena:
                    # the puts that cannot fit force the pressure loop to
                    # spill, and refs are held for the whole seed so nothing
                    # is merely freed instead of spilled.
                    arena = scenario.object_store_memory or _SPILL_ARENA
                    per_step = max(
                        1, (4 * arena) // SPILL_BLOB_SIZE // scenario.steps
                    )
                    tags = [
                        (scenario.name, seed, step, i)
                        for i in range(per_step)
                    ]
                    refs = [session.produce_spill.remote(t) for t in tags]
                    ready, not_ready = session.ray.wait(
                        refs, num_returns=len(refs), timeout=180
                    )
                    if not_ready:
                        violations.append(
                            f"workload: step {step}: {len(not_ready)}/"
                            f"{len(refs)} produces never acknowledged"
                        )
                    acked = {r.hex() for r in ready}
                    for r, t in zip(refs, tags):
                        if r.hex() in acked:
                            data_ledger.append(
                                (r, _spill_digest(t), "task-return")
                            )
                    put_tag = ("put", scenario.name, seed, step)
                    put_ref = session.ray.put(_produce_spill_blob(put_tag))
                    data_ledger.append((put_ref, _spill_digest(put_tag), "put"))
                    # Spot-check one transfer now; the full ledger is
                    # re-resolved by check_no_data_loss after convergence.
                    data = session.ray.get(refs[0], timeout=120)
                    if hashlib.sha256(data).hexdigest() != _spill_digest(tags[0]):
                        violations.append(
                            f"workload: step {step} spilled transfer corrupt"
                        )
                    del data
                    spill_seen = max(spill_seen, sum(
                        r.spilled_bytes
                        for r in session.cluster.raylets.values()
                    ))
                else:  # transfer
                    tag = (scenario.name, seed, step)
                    ref = session.produce.remote(tag)
                    data = session.ray.get(ref, timeout=120)
                    if data != _blob(tag):
                        violations.append(
                            f"workload: step {step} transfer corrupt "
                            f"({len(data)} bytes)"
                        )
                    probe_refs.append(
                        (ref, hashlib.sha256(_blob(tag)).hexdigest())
                    )
            except Exception as e:
                violations.append(
                    f"workload: step {step} failed: {type(e).__name__}: {e}"
                )
            if scenario.router_restart:
                async def _restart_router():
                    from ray_tpu_torch.serve import handle as handle_mod

                    handle_mod._reset_router()

                session.run_async(_restart_router(), timeout=10)
    finally:
        session.run_async(_uninstall())

    # crash_gcs durability diffs: acknowledged records missing after a
    # crash-restart are violations, not workload noise.
    violations.extend(nemesis.state_loss)

    # Belt and braces: if the in-step repair was skipped (nemesis found no
    # target), make sure the cluster shape is whole before quiescing.
    if scenario.repair:
        session.repair_victim_node()

    # Convergence: quiesce, then invariants, then functional probes.
    async def _converge():
        await invariants.quiesce(session.cluster, timeout=30.0)
        return await invariants.check(session.cluster)

    try:
        violations.extend(str(v) for v in session.run_async(_converge(), timeout=45))
    except Exception as e:
        violations.append(f"convergence: {type(e).__name__}: {e}")

    # Probe 1: previously transferred objects still resolve correctly
    # (reconstruction allowed — kill_raylet relies on it).
    for ref, digest in probe_refs:
        try:
            data = session.ray.get(ref, timeout=120)
            if hashlib.sha256(data).hexdigest() != digest:
                violations.append("probe: re-get returned corrupt bytes")
        except Exception as e:
            violations.append(
                f"probe: owned object not reconstructable: "
                f"{type(e).__name__}: {e}"
            )
    # Probe (spill): the no-data-loss invariant — every acknowledged object
    # still resolves to its exact bytes (restored from external storage or
    # re-executed from lineage), or fails with the typed reconstruction
    # error. And the pressure loop must actually have spilled along the way,
    # else the seed proved nothing about the spill path.
    if scenario.workload == "spill":
        if not spill_seen:
            violations.append(
                "workload: spill scenario never spilled (working set did "
                "not pressure the arena)"
            )
        violations.extend(
            str(v)
            for v in invariants.check_no_data_loss(
                session.ray, data_ledger, timeout_s=120.0
            )
        )
    # Probe 2: the cluster still runs fresh work.
    try:
        if session.ray.get(session.add.remote(seed, 1), timeout=60) != seed + 1:
            violations.append("probe: fresh task returned wrong value")
    except Exception as e:
        violations.append(f"probe: fresh task failed: {type(e).__name__}: {e}")
    # Probe 3 (serve): a fresh request must route and succeed — whatever the
    # faults broke (replica, router view) has been repaired by now. One retry
    # absorbs a router whose long-poll update is still in flight.
    if scenario.workload == "serve":

        async def _serve_probe():
            from ray_tpu_torch.serve import handle as handle_mod

            router = await handle_mod._get_router()
            for attempt in (0, 1):
                try:
                    return await router.assign_request(
                        session.serve_dep,
                        {"call_method": "__call__", "request_id": "",
                         "multiplexed_model_id": ""},
                        (seed,),
                        {},
                        timeout_s=5.0,
                    )
                except Exception:
                    if attempt:
                        raise
                    await asyncio.sleep(1.0)

        try:
            if session.run_async(_serve_probe(), timeout=30) != seed:
                violations.append("probe: serve request returned wrong value")
        except Exception as e:
            violations.append(
                f"probe: serve request failed: {type(e).__name__}: {e}"
            )

    dup_avoided = sum(
        r.duplicate_lease_grants_avoided for r in session.cluster.raylets.values()
    )
    stalled = sum(
        r.pull_manager.stalled_streams for r in session.cluster.raylets.values()
    )
    rereq = sum(
        r.pull_manager.rerequested_streams
        for r in session.cluster.raylets.values()
    )
    return SeedResult(
        scenario=scenario.name,
        seed=seed,
        ok=not violations,
        schedule_digest=schedule.digest(),
        fault_log_digest=interceptor.log.digest(),
        faults_fired=interceptor.log.count(),
        violations=violations,
        duplicate_grants_avoided=dup_avoided,
        stalled_streams=stalled,
        rerequested_streams=rereq,
        deadline_shed=rpc.deadline_stats.shed,
        deadline_enforced=rpc.deadline_stats.enforced,
        spilled_bytes=spill_seen,
    )


# -- simulated-cluster scheduler seeds ---------------------------------------

# Lease cycles per step. With 120 4-CPU nodes and 2-CPU demands this holds
# the fleet at ~85% utilization, so most requests funneled through the few
# entry raylets must spill — kills then land mid-chain by construction.
_SCHED_BURST = 200


def run_sched_seed(cluster, client, scenario: Scenario, seed: int,
                   verbose: bool = False) -> SeedResult:
    """One seed of a ``sched`` scenario: saturating bursts of concurrent
    lease cycles on a SimCluster while the nemesis kills raylets mid-
    spillback-chain, then quiescence + the lease-exactly-once/ledger
    invariants on the survivors. No driver, no workers — the control plane
    under fire is the whole point."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private import telemetry
    from ray_tpu_torch.chaos import invariants
    from ray_tpu_torch.chaos.nemesis import Nemesis

    schedule = FaultSchedule(seed, scenario.specs)
    plan = NemesisPlan(seed, scenario.nemesis, scenario.steps)
    nemesis = Nemesis(cluster)
    violations: List[str] = []
    fired_all: List[str] = []

    async def _reset():
        # Same per-seed hygiene as run_seed: drained cluster, fresh deadline
        # accounting and telemetry so check()/flight dumps see one seed only.
        await invariants.quiesce(cluster, timeout=15.0)
        from ray_tpu_torch._private.gcs_store import heal_all_partitions

        heal_all_partitions()
        rpc.deadline_stats.reset()
        gcs = cluster.gcs_server
        if gcs is not None:
            gcs.worker_deadline_stats.update(met=0, shed=0, enforced=0)
            gcs.worker_deadline_stats["overruns"].clear()
            telemetry.reset_all()
            gcs.telemetry = telemetry.new_aggregate()
            gcs.flight_events.clear()
            gcs.spans.clear()
            from ray_tpu_torch.util import tracing

            tracing.reset()

    cluster.run(_reset(), timeout=30)

    async def _sched_step(step: int, actions) -> None:
        # Funnel every request through a handful of entry raylets: they
        # saturate immediately, so the burst rides spillback chains across
        # the fleet rather than granting at the front door.
        entries = sorted(cluster.raylets)[: max(4, len(cluster.raylets) // 16)]
        addrs = [tuple(cluster.raylets[nid].addr) for nid in entries]

        async def one(i):
            await client.lease_cycle(
                {"CPU": 2.0},
                entry_addr=addrs[(seed + i) % len(addrs)],
                hold_s=0.02,
            )

        burst = asyncio.gather(
            *(one(i) for i in range(_SCHED_BURST)), return_exceptions=True
        )
        await asyncio.sleep(0.05)  # let chains get in flight before killing
        for action, pick in actions:
            desc = await nemesis.fire(action, pick)
            if desc:
                fired_all.append(desc)
                if verbose:
                    print(f"      nemesis: {desc}")
        results = await burst
        errors = [r for r in results if isinstance(r, BaseException)]
        if errors:
            sample = "; ".join(f"{type(e).__name__}: {e}" for e in errors[:3])
            violations.append(
                f"workload: step {step}: {len(errors)}/{len(results)} lease "
                f"cycles failed ({sample})"
            )

    try:
        for step in range(scenario.steps):
            cluster.run(_sched_step(step, plan.at_step(step)), timeout=180)
    finally:
        if scenario.repair:
            # Autoscaler analog: restore the fleet to its nominal size so
            # the next seed starts from the scenario's shape.
            while len(cluster.raylets) < scenario.sim_nodes:
                cluster.add_node()

    violations.extend(nemesis.state_loss)

    async def _converge():
        await invariants.quiesce(cluster, timeout=30.0)
        return await invariants.check(cluster)

    try:
        violations.extend(str(v) for v in cluster.run(_converge(), timeout=60))
    except Exception as e:
        violations.append(f"convergence: {type(e).__name__}: {e}")

    # Scheduler-specific exactly-once: every cycle released its grant (or
    # the grant died with its raylet), so no survivor may still hold one.
    for raylet in list(cluster.raylets.values()):
        if raylet.leases:
            violations.append(
                f"lease-exactly-once: node {raylet.node_id[:8]} still holds "
                f"{len(raylet.leases)} grant(s) after every cycle released"
            )

    # Probe: the surviving cluster still grants fresh leases.
    async def _probe():
        grant = await client.lease({"CPU": 1.0}, timeout=30.0)
        await client.release(grant)

    try:
        cluster.run(_probe(), timeout=45)
    except Exception as e:
        violations.append(
            f"probe: fresh lease failed: {type(e).__name__}: {e}"
        )

    dup_avoided = sum(
        r.duplicate_lease_grants_avoided for r in cluster.raylets.values()
    )
    return SeedResult(
        scenario=scenario.name,
        seed=seed,
        ok=not violations,
        schedule_digest=schedule.digest(),
        # No wire interceptor here — the fault log is the nemesis record.
        fault_log_digest=hashlib.sha256(
            "\n".join(fired_all).encode()
        ).hexdigest(),
        faults_fired=len(fired_all),
        violations=violations,
        duplicate_grants_avoided=dup_avoided,
        deadline_shed=rpc.deadline_stats.shed,
        deadline_enforced=rpc.deadline_stats.enforced,
    )


def _run_sched_scenario(scenario: Scenario, seeds: List[int],
                        corpus: Optional[str],
                        verbose: bool = False) -> List[SeedResult]:
    """Seed loop for ``sched`` scenarios: a SimCluster instead of a driver
    session, reused across seeds, rebuilt after any failing seed."""
    import shutil
    import tempfile

    from ray_tpu_torch._private.sim_cluster import SimCluster, SimLeaseClient

    def _boot():
        persist_path = None
        if scenario.persist:
            persist_path = os.path.join(
                tempfile.mkdtemp(prefix="chaos_gcs_"), "gcs.wal"
            )
        cluster = SimCluster(
            scenario.sim_nodes, env=dict(scenario.env),
            persist_path=persist_path, ha=scenario.ha,
        ).start()
        return cluster, SimLeaseClient(cluster)

    def _teardown(cluster, client):
        try:
            cluster.run(client.close(), timeout=30)
        except Exception:
            pass
        cluster.shutdown()
        if cluster.persist_path:
            shutil.rmtree(os.path.dirname(cluster.persist_path),
                          ignore_errors=True)

    results: List[SeedResult] = []
    cluster, client = _boot()
    try:
        for seed in seeds:
            result = run_sched_seed(cluster, client, scenario, seed,
                                    verbose=verbose)
            results.append(result)
            status = "ok" if result.ok else "FAIL"
            print(
                f"    seed {seed:>4} {status}  faults={result.faults_fired}"
                f"  schedule={result.schedule_digest[:12]}"
            )
            if not result.ok:
                for v in result.violations:
                    print(f"      {v}")
                if corpus:
                    _append_corpus(corpus, result)
                # One bad seed must not poison the next: fresh sim cluster.
                _teardown(cluster, client)
                cluster, client = _boot()
    finally:
        _teardown(cluster, client)
    return results


def run_scenario(scenario: Scenario, seeds: List[int], corpus: Optional[str],
                 verbose: bool = False) -> List[SeedResult]:
    if scenario.workload == "sched":
        return _run_sched_scenario(scenario, seeds, corpus, verbose=verbose)
    results: List[SeedResult] = []
    session = _Session(scenario)
    try:
        for seed in seeds:
            result = run_seed(session, scenario, seed, verbose=verbose)
            results.append(result)
            status = "ok" if result.ok else "FAIL"
            print(
                f"    seed {seed:>4} {status}  faults={result.faults_fired}"
                f"  schedule={result.schedule_digest[:12]}"
            )
            if not result.ok:
                for v in result.violations:
                    print(f"      {v}")
                if corpus:
                    _append_corpus(corpus, result)
                    _dump_flight(corpus, session, result)
                    _dump_spans(corpus, session, result)
                # One bad seed must not poison the next: fresh cluster.
                session.close()
                session = _Session(scenario)
    finally:
        session.close()
    return results


def _append_corpus(path: str, result: SeedResult) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(result.to_wire(), sort_keys=True) + "\n")


def _dump_flight(corpus: str, session: _Session, result: SeedResult) -> Optional[str]:
    """Write the merged flight-recorder timeline for a failing seed next to
    the replay corpus: the GCS's ingested ring (events drained from worker
    and driver flushes) merged with this process's undrained local ring,
    sorted by wall-clock timestamp."""
    from ray_tpu_torch._private import telemetry

    gcs = session.cluster.gcs_server
    ingested = list(gcs.flight_events) if gcs is not None else []
    path = os.path.join(
        os.path.dirname(os.path.abspath(corpus)),
        f"flight_{result.scenario}_{result.seed}.jsonl",
    )
    try:
        n = telemetry.dump_timeline(
            path, ingested, telemetry.flight().snapshot()
        )
    except Exception as e:  # triage artifact must never mask the violation
        print(f"      flight dump failed: {type(e).__name__}: {e}")
        return None
    print(f"      flight recorder: {n} events -> {path}")
    return path


def _dump_spans(corpus: str, session: _Session, result: SeedResult) -> Optional[str]:
    """Write the merged span timeline for a failing seed as chrome://tracing
    JSON next to the flight-recorder dump: the GCS's span ring (flushed from
    workers and diverted from task events) merged with this process's
    unflushed local buffer. Loads directly into Perfetto for causal triage."""
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.state.api import _span_timeline_events

    gcs = session.cluster.gcs_server
    spans = list(gcs.spans) if gcs is not None else []
    spans.extend(tracing.snapshot())
    if not spans:
        return None
    path = os.path.join(
        os.path.dirname(os.path.abspath(corpus)),
        f"spans_{result.scenario}_{result.seed}.json",
    )
    try:
        events = _span_timeline_events(spans)
        with open(path, "w") as f:
            json.dump(events, f)
    except Exception as e:  # triage artifact must never mask the violation
        print(f"      span dump failed: {type(e).__name__}: {e}")
        return None
    print(f"      span timeline: {len(events)} spans -> {path}")
    return path


def _load_corpus(path: str) -> List[dict]:
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(json.loads(line))
    return entries


# -- determinism gate --------------------------------------------------------


def check_determinism(names: List[str], seeds: List[int]) -> int:
    """Rebuild every (scenario, seed) schedule twice and compare bytes; the
    CI proof that replaying a seed reproduces the identical fault plan."""
    failures = 0
    for name in names:
        scenario = SCENARIOS[name]
        for seed in seeds:
            a = FaultSchedule(seed, scenario.specs)
            b = FaultSchedule(seed, scenario.specs)
            pa = NemesisPlan(seed, scenario.nemesis, scenario.steps)
            pb = NemesisPlan(seed, scenario.nemesis, scenario.steps)
            same = a.to_bytes() == b.to_bytes() and pa.to_wire() == pb.to_wire()
            if not same:
                failures += 1
                print(f"  {name} seed {seed}: NON-DETERMINISTIC SCHEDULE")
            else:
                print(f"  {name} seed {seed}: {a.digest()[:16]} deterministic")
    return failures


# -- CLI ---------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.chaos",
        description="deterministic seeded fault injection with convergence "
        "invariants",
    )
    parser.add_argument("--suite", choices=sorted(SUITES), default=None,
                        help="named scenario suite")
    parser.add_argument("--scenario", action="append", default=None,
                        help="individual scenario (repeatable)")
    parser.add_argument("--seeds", type=int, default=5,
                        help="number of consecutive seeds (default 5)")
    parser.add_argument("--seed-base", type=int, default=0,
                        help="first seed (default 0)")
    parser.add_argument("--seed", action="append", type=int, default=None,
                        help="explicit seed (repeatable; overrides --seeds)")
    parser.add_argument("--corpus", default="chaos_corpus.jsonl",
                        help="JSONL replay corpus for failing seeds")
    parser.add_argument("--no-corpus", action="store_true",
                        help="do not record failing seeds")
    parser.add_argument("--replay", metavar="PATH",
                        help="re-run the (scenario, seed) entries of a corpus")
    parser.add_argument("--check-determinism", action="store_true",
                        help="only verify seed -> schedule determinism "
                        "(no cluster)")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios and suites")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.list:
        print("scenarios:")
        for name in sorted(SCENARIOS):
            s = SCENARIOS[name]
            nem = f" nemesis={','.join(s.nemesis)}" if s.nemesis else ""
            print(f"  {name:<14} {s.description}{nem}")
        print("suites:")
        for name in sorted(SUITES):
            print(f"  {name:<14} {' '.join(SUITES[name])}")
        return 0

    if args.replay:
        entries = _load_corpus(args.replay)
        if not entries:
            print(f"replay corpus {args.replay} is empty")
            return 0
        pairs = [(e["scenario"], e["seed"]) for e in entries]
        names = sorted({s for s, _ in pairs})
        rc = 0
        for name in names:
            scenario = SCENARIOS[name]
            seeds = sorted({seed for s, seed in pairs if s == name})
            print(f"  replay {name} seeds {seeds}")
            results = run_scenario(scenario, seeds, corpus=None,
                                   verbose=args.verbose)
            rc |= int(any(not r.ok for r in results))
        return rc

    names = list(args.scenario or [])
    if args.suite:
        names.extend(SUITES[args.suite])
    if not names:
        names = SUITES["smoke"]
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"unknown scenario(s): {unknown}; see --list")
        return 2
    seeds = args.seed if args.seed else list(
        range(args.seed_base, args.seed_base + args.seeds)
    )

    if args.check_determinism:
        failures = check_determinism(names, seeds)
        print(
            "determinism: "
            + ("FAILED" if failures else f"ok ({len(names) * len(seeds)} schedules)")
        )
        return 1 if failures else 0

    corpus = None if args.no_corpus else args.corpus
    total_fail = 0
    for name in names:
        scenario = SCENARIOS[name]
        print(f"chaos scenario {name}: {scenario.description}")
        results = run_scenario(scenario, seeds, corpus, verbose=args.verbose)
        failed = [r for r in results if not r.ok]
        total_fail += len(failed)
        print(
            f"  {name}: {len(results) - len(failed)}/{len(results)} seeds "
            "converged"
        )
    if total_fail:
        print(f"chaos: {total_fail} failing seed(s)"
              + (f" recorded to {corpus}" if corpus else ""))
        return 1
    print("chaos: all seeds converged; every invariant held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
