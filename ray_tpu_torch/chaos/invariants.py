"""Convergence invariants: what must be true once the dust settles.

After a fault sequence, :func:`quiesce` drives the in-process cluster to a
stable point (no queued leases, no half-assembled pushes, no transitional
actor states), then :func:`check` asserts the invariants the recovery
machinery promises:

- **lease-exactly-once** — every lease id maps to exactly one live worker,
  no worker is under two lease ids or simultaneously leased and idle, and
  the raylet's resource ledger balances (available + leased demands == total
  when no placement groups mutate totals).
- **actors-terminal** — every GCS actor FSM is in a terminal-or-stable state
  (ALIVE / DEAD), never parked in PENDING_CREATION / RESTARTING /
  DEPENDENCIES_UNREADY after quiescence.
- **no-orphaned-tasks** — no transient coroutine (grant, RPC dispatch,
  object push) is still pending across two spaced snapshots; daemon loops
  are exempt.
- **store-settled** — no unsealed push assemblies or in-flight restores
  survive quiescence.
- **objects-reconstructable** — checked by the runner functionally: refs
  created before the faults must still ``get`` correctly (recovery may
  re-execute lineage), and a fresh probe task must run. Both are workload
  probes rather than state inspections, so they live in the runner.
- **no-data-loss** — for spill scenarios: every acknowledged put or task
  return with a live ref still resolves to its exact bytes post-quiesce
  (restored from external storage or re-executed from lineage), or fails
  with the typed :class:`ObjectReconstructionFailedError` — never wrong
  bytes, never a hang, never an untyped error
  (:func:`check_no_data_loss`).

All coroutines here run on the cluster's event loop.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import List

from ray_tpu_torch._private import rpc

# Coroutine qualnames that MUST complete by quiescence; anything else
# pending in the background-task set is assumed to be a daemon loop.
TRANSIENT_QUALNAMES = {
    "Raylet._grant",
    "Raylet._resolve_duplicate_lease_async",
    "PushManager.push",
    "PushManager._do_push",
}

# GCS actor states that may legitimately persist after quiescence. This set
# must equal the actor machine's quiescent states declared in
# ray_tpu_torch/devtools/protocols.py — the protocol checker (part of `make lint`)
# fails with protocol-invariant-drift if the two ever diverge, so a spec
# change here forces the matching FSM spec/doc update and vice versa.
TERMINAL_ACTOR_STATES = {"ALIVE", "DEAD"}


@dataclass
class Violation:
    invariant: str
    node_id: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.invariant}] node={self.node_id[:8]}: {self.detail}"


class ConvergenceTimeout(AssertionError):
    """The cluster failed to reach quiescence inside the deadline."""


def _raylet_busy(raylet) -> List[str]:
    """What still churns on one raylet (empty == quiescent)."""
    busy = []
    if any(not req.fut.done() for req in raylet.pending_leases):
        busy.append(f"pending_leases={len(raylet.pending_leases)}")
    if raylet.grants_in_flight:
        busy.append(f"grants_in_flight={raylet.grants_in_flight}")
    if raylet.push_assembly:
        busy.append(f"push_assembly={sorted(raylet.push_assembly)}")
    if raylet.restoring:
        busy.append(f"restoring={sorted(raylet.restoring)}")
    if raylet.spilling:
        busy.append(f"spilling={sorted(raylet.spilling)}")
    # Non-actor leases drain once the driver's lease pool returns idle
    # workers (worker_lease_idle_keep_s); actor leases persist by design.
    task_leases = [
        lid for lid, h in raylet.leases.items() if h.actor_id is None
    ]
    if task_leases:
        busy.append(f"task_leases={task_leases}")
    return busy


def _gcs_busy(gcs_server) -> List[str]:
    busy = []
    transitional = {
        aid: a.state
        for aid, a in gcs_server.actors.items()
        if a.state not in TERMINAL_ACTOR_STATES
    }
    if transitional:
        busy.append(f"transitional_actors={transitional}")
    return busy


async def quiesce(cluster, timeout: float = 30.0) -> None:
    """Poll until every raylet and the GCS stop churning; raise
    :class:`ConvergenceTimeout` (with the stuck state named) otherwise."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    last: List[str] = ["never-sampled"]
    while loop.time() < deadline:
        last = []
        for raylet in list(cluster.raylets.values()):
            for item in _raylet_busy(raylet):
                last.append(f"{raylet.node_id[:8]}:{item}")
        if cluster.gcs_server is not None:
            for item in _gcs_busy(cluster.gcs_server):
                last.append(f"gcs:{item}")
        if not last:
            return
        await asyncio.sleep(0.05)
    raise ConvergenceTimeout(f"cluster did not quiesce in {timeout}s: {last}")


def check_leases(raylet) -> List[Violation]:
    """Lease table / worker pool / resource-ledger consistency."""
    violations = []
    nid = raylet.node_id
    seen_workers = {}
    for lease_id, handle in raylet.leases.items():
        if handle.lease_id != lease_id:
            violations.append(
                Violation(
                    "lease-exactly-once",
                    nid,
                    f"lease {lease_id[:12]} maps to handle tagged "
                    f"{str(handle.lease_id)[:12]}",
                )
            )
        if handle.worker_id in seen_workers:
            violations.append(
                Violation(
                    "lease-exactly-once",
                    nid,
                    f"worker {handle.worker_id[:12]} held by two leases "
                    f"({seen_workers[handle.worker_id][:12]}, {lease_id[:12]})",
                )
            )
        seen_workers[handle.worker_id] = lease_id
        if handle.worker_id not in raylet.workers:
            violations.append(
                Violation(
                    "lease-exactly-once",
                    nid,
                    f"lease {lease_id[:12]} holds unknown (dead?) worker "
                    f"{handle.worker_id[:12]} — leaked grant",
                )
            )
        if handle in raylet.idle_workers:
            violations.append(
                Violation(
                    "lease-exactly-once",
                    nid,
                    f"worker {handle.worker_id[:12]} both leased and idle",
                )
            )
    if len(raylet.idle_workers) != len(set(map(id, raylet.idle_workers))):
        violations.append(
            Violation("lease-exactly-once", nid, "duplicate idle pool entry")
        )
    if not raylet.available.nonnegative():
        violations.append(
            Violation(
                "resource-ledger",
                nid,
                f"negative availability {raylet.available.to_dict()}",
            )
        )
    if not raylet.pg_committed and not raylet.pg_prepared:
        # Without placement groups mutating totals the ledger must balance
        # exactly: total == available + sum of leased demands.
        ledger = raylet.available
        for handle in raylet.leases.values():
            if handle.demand is not None:
                ledger = ledger + handle.demand
        if ledger != raylet.total:
            violations.append(
                Violation(
                    "resource-ledger",
                    nid,
                    f"total {raylet.total.to_dict()} != available+leased "
                    f"{ledger.to_dict()} (leaked or double-counted grant)",
                )
            )
    return violations


def check_actors(gcs_server) -> List[Violation]:
    violations = []
    for aid, actor in gcs_server.actors.items():
        if actor.state not in TERMINAL_ACTOR_STATES:
            violations.append(
                Violation(
                    "actors-terminal",
                    "gcs",
                    f"actor {aid[:12]} stuck in {actor.state}",
                )
            )
    return violations


def check_store(raylet) -> List[Violation]:
    violations = []
    if raylet.push_assembly:
        violations.append(
            Violation(
                "store-settled",
                raylet.node_id,
                f"unsealed push assemblies {sorted(raylet.push_assembly)}",
            )
        )
    if raylet.restoring:
        violations.append(
            Violation(
                "store-settled",
                raylet.node_id,
                f"in-flight restores {sorted(raylet.restoring)}",
            )
        )
    return violations


def check_no_data_loss(ray_mod, ledger, timeout_s: float = 120.0) -> List[Violation]:
    """Every acknowledged object — a driver ``put`` or a task return whose
    readiness the workload observed — with a still-live ref must resolve to
    its exact bytes after convergence (restored from external storage or
    re-executed from lineage), or fail with the typed
    ``ObjectReconstructionFailedError``. Wrong bytes, hangs (a get timeout),
    and untyped errors are data loss.

    A functional probe in the objects-reconstructable mold: the runner
    passes the ``(ref, sha256-hexdigest, kind)`` ledger it built while the
    workload ran. Runs on the driver thread (blocking gets), not the
    cluster loop.
    """
    import hashlib

    from ray_tpu_torch._private.common import ObjectReconstructionFailedError

    violations = []
    for ref, digest, kind in ledger:
        try:
            data = ray_mod.get(ref, timeout=timeout_s)
        except ObjectReconstructionFailedError:
            # Principled, typed loss (lineage pruned / unreconstructable by
            # design): the caller knows exactly what happened and why.
            continue
        except Exception as e:
            violations.append(
                Violation(
                    "no-data-loss",
                    "-",
                    f"{kind} object {ref.hex()[:12]} irrecoverable with "
                    f"untyped {type(e).__name__}: {e}",
                )
            )
            continue
        if hashlib.sha256(data).hexdigest() != digest:
            violations.append(
                Violation(
                    "no-data-loss",
                    "-",
                    f"{kind} object {ref.hex()[:12]} resolved to wrong bytes",
                )
            )
    return violations


async def check_orphan_tasks(settle_s: float = 1.0) -> List[Violation]:
    """Transient coroutines still pending across two spaced snapshots are
    orphans (a _grant that never resolved, a push wedged on a dead link).
    Daemon loops and RPC dispatch of long-poll handlers are exempt."""

    def _transients():
        out = set()
        for task in rpc._BG_TASKS:
            if task.done():
                continue
            coro = task.get_coro()
            qual = getattr(coro, "__qualname__", "")
            if qual in TRANSIENT_QUALNAMES:
                out.add(task)
        return out

    first = _transients()
    if not first:
        return []
    await asyncio.sleep(settle_s)
    stuck = [t for t in first if t in _transients()]
    return [
        Violation(
            "no-orphaned-tasks",
            "-",
            f"{getattr(t.get_coro(), '__qualname__', '?')} pending "
            f">{settle_s}s after quiescence",
        )
        for t in stuck
    ]


def check_deadlines(gcs_server=None) -> List[Violation]:
    """No call outlives its deadline: every handler dispatched under a wire
    deadline must finish — or unwind its cancellation — within the grace
    period (``config.rpc_deadline_grace_s``) of it. An overrun means a
    handler swallowed cancellation or the loop stalled long enough that
    shedding/enforcement never got to run; either way a hop kept working
    after its caller gave up.

    Two sources: the driver-process counters (rpc.deadline_stats, reset per
    seed by the runner) and — when a GCS server is given — the cluster
    aggregate fed by worker-subprocess flushes (ReportDeadlineStats), so a
    replica or task worker that outlived its deadline is a violation too."""
    violations = [
        Violation(
            "no-call-outlives-deadline",
            "-",
            f"handler {method} finished {late:.3f}s past its wire deadline "
            "(> grace period)",
        )
        for method, late in rpc.deadline_stats.overruns
    ]
    if gcs_server is not None:
        for wid, method, late in gcs_server.worker_deadline_stats["overruns"]:
            violations.append(
                Violation(
                    "no-call-outlives-deadline",
                    str(wid),
                    f"worker handler {method} finished {late:.3f}s past its "
                    "wire deadline (> grace period)",
                )
            )
    return violations


async def check(cluster) -> List[Violation]:
    """Run every invariant against a quiesced cluster."""
    violations: List[Violation] = []
    for raylet in list(cluster.raylets.values()):
        violations.extend(check_leases(raylet))
        violations.extend(check_store(raylet))
    if cluster.gcs_server is not None:
        violations.extend(check_actors(cluster.gcs_server))
    violations.extend(await check_orphan_tasks())
    violations.extend(check_deadlines(cluster.gcs_server))
    return violations
