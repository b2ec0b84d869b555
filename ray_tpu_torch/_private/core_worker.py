"""CoreWorker: the in-process runtime embedded in every driver and worker.

TPU-native analog of the reference's CoreWorker (src/ray/core_worker/core_worker.h:292):
Put/Get/Wait, task submission over leased workers (direct task transport —
transport/direct_task_transport.h:75), direct actor submission with per-handle
sequence numbers (transport/sequential_actor_submit_queue.cc), ownership-based
reference counting (reference_count.cc), task retries (task_manager.cc), and an
object server so borrowers can pull owner-local objects.

Everything here is async and runs on the process's event loop; the public sync
API (ray_tpu_torch/_private/worker.py) bridges via run_coroutine_threadsafe.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import logging
import time
import traceback
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import rpc, serialization, telemetry
from ray_tpu_torch._private.common import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectReconstructionFailedError,
    ResourceSet,
    TaskCancelledError,
    TaskError,
    TaskSpec,
    WorkerCrashedError,
    config,
)
from ray_tpu_torch._private.gcs import GcsClient
from ray_tpu_torch._private.ids import (
    ActorID,
    ObjectID,
    TaskID,
    deterministic_object_id,
    fast_unique_hex,
    return_object_ids,
)
from ray_tpu_torch._private.object_store import IN_PLASMA, INLINE, MemoryStore, PlasmaClient

logger = logging.getLogger(__name__)

_TEL_RECONSTRUCTIONS = telemetry.counter(
    "object", "reconstructions",
    "lineage reconstructions of lost objects, by outcome "
    "(ok = producer re-ran and the value is back; failed = re-execution "
    "failed, attempts exhausted, depth cap hit, or no lineage existed; "
    "pruned = the producing spec was dropped under lineage_bytes_limit)",
)
_TEL_RECON_OK = _TEL_RECONSTRUCTIONS.cell(outcome="ok")
_TEL_RECON_FAILED = _TEL_RECONSTRUCTIONS.cell(outcome="failed")
_TEL_RECON_PRUNED = _TEL_RECONSTRUCTIONS.cell(outcome="pruned")
_TEL_LINEAGE_BYTES = telemetry.gauge(
    "object", "lineage_bytes",
    "bytes of retained producing TaskSpecs (bounded by lineage_bytes_limit)",
)


class ObjectRefGenerator:
    """Value of a num_returns="dynamic" task: an iterable of ObjectRefs.

    Streaming (reference: the ReportGeneratorItemReturns path +
    TryReadObjectRefStream, core_worker.h:389): the producing worker ships
    each yielded item as it is produced, so iterating here overlaps the
    producer — ``__iter__`` yields the ref for item i as soon as the owner
    has it, blocking only on items not yet produced. ``len()`` blocks until
    the producer finishes. A generator constructed with a plain ref list
    (legacy / fully-materialized) behaves statically.
    """

    def __init__(self, refs=None, task_id=None, owner_addr=None, total=None):
        self._refs = list(refs) if refs is not None else None
        self._task_id = task_id
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._total = total
        # Streaming mode: hold a ref on the stream's return object so the
        # owner keeps the stream state (and item bookkeeping) alive for as
        # long as any generator handle exists — the caller usually drops the
        # raw task ref right after ray.get()ing this generator.
        self._stream_ref = None
        if task_id is not None:
            try:
                from ray_tpu_torch._private import worker as worker_mod

                core = worker_mod.global_worker.core
                if core is not None and not core.closed:
                    rid = return_object_ids(task_id, 1)[0]
                    self._stream_ref = ObjectRef(rid, self._owner_addr, core)
            except Exception:
                pass

    # -- streaming plumbing --------------------------------------------------

    def _next_ref(self, i: int):
        """Blocking: ref for item i, or None when the stream ended before i."""
        if self._refs is not None:
            return self._refs[i] if i < len(self._refs) else None
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        return w.run_async(
            w.core.dyn_next(self._task_id, self._owner_addr, i), timeout=600
        )

    def __iter__(self):
        if self._refs is not None:
            return iter(list(self._refs))

        def it(gen=self):
            i = 0
            while True:
                ref = gen._next_ref(i)
                if ref is None:
                    return
                yield ref
                i += 1

        return it()

    def __len__(self):
        if self._refs is not None:
            return len(self._refs)
        if self._total is None:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.global_worker
            self._total = w.run_async(
                w.core.dyn_total(self._task_id, self._owner_addr), timeout=600
            )
        return self._total

    def __getitem__(self, i):
        if self._refs is not None:
            return self._refs[i]
        ref = self._next_ref(i)
        if ref is None:
            raise IndexError(i)
        return ref

    def __reduce__(self):
        if self._refs is not None:
            return (ObjectRefGenerator, (self._refs,))
        # The stream's return object is this generator's dependency: record
        # it so task-arg serialization pins the stream while in flight.
        if self._stream_ref is not None:
            serialization.record_contained_ref(self._stream_ref)
        return (
            ObjectRefGenerator,
            (None, self._task_id, self._owner_addr, self._total),
        )


class ObjectRef:
    """A reference to a (possibly not-yet-computed) object.

    Carries the owner's object-server address so any holder can resolve the
    value (ownership model: the owner worker is the object's directory).
    """

    __slots__ = ("_hex", "_owner_addr", "_core", "__weakref__")

    def __init__(self, hex_id: str, owner_addr: Tuple[str, int], core: Optional["CoreWorker"] = None):
        self._hex = hex_id
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._core = core
        if core is not None:
            core.reference_table.add_local(hex_id)

    def hex(self) -> str:
        return self._hex

    def binary(self) -> bytes:
        return bytes.fromhex(self._hex)

    @property
    def owner_addr(self):
        return self._owner_addr

    def __repr__(self):
        return f"ObjectRef({self._hex})"

    def __hash__(self):
        return hash(self._hex)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._hex == self._hex

    def __reduce__(self):
        serialization.record_contained_ref(self)
        deserializer = serialization.get_ref_deserializer()
        if deserializer is not None:
            return (deserializer, (self._hex, self._owner_addr))
        return (_plain_ref, (self._hex, self._owner_addr))

    def __del__(self):
        core = self._core
        if core is not None and not core.closed:
            try:
                core.reference_table.remove_local(self._hex, core)
            except Exception:
                pass

    def __await__(self):
        # Allows `await ref` inside async actors.
        core = self._core
        if core is None:
            raise RuntimeError("ObjectRef is not attached to a core worker")
        return core.get_objects([self], timeout=None).__await__()


def _plain_ref(hex_id, owner_addr):
    # Deserialized outside any worker context (e.g. in a subprocess tool):
    # ref without a core; get() requires re-attachment.
    return ObjectRef(hex_id, owner_addr, None)


class RefEntry:
    __slots__ = ("local", "submitted", "owned", "freed")

    def __init__(self):
        self.local = 0
        self.submitted = 0
        self.owned = False
        self.freed = False


class ReferenceTable:
    """Per-process reference counts driving object lifetime.

    Owner frees the object (memory store entry + shm primary copy) once the
    local python refcount and in-flight-task count both reach zero.
    Reference: src/ray/core_worker/reference_count.cc (we implement the
    owner-side protocol; cross-worker borrow counts are conservatively
    approximated by the submitted-task count).

    Thread-safe: mutated both from the event loop and from user threads
    (ObjectRef ctor/__del__, the synchronous submission fast path).
    """

    def __init__(self):
        import threading

        self.entries: Dict[str, RefEntry] = {}
        self._lock = threading.Lock()

    def _entry(self, oid: str) -> RefEntry:
        e = self.entries.get(oid)
        if e is None:
            e = self.entries[oid] = RefEntry()
        return e

    def add_local(self, oid: str) -> None:
        with self._lock:
            self._entry(oid).local += 1

    def register_task(self, return_ids, dep_oids) -> None:
        """Submission-time registration under ONE lock acquire (hot path):
        mark returns owned, count deps as submitted."""
        with self._lock:
            for oid in return_ids:
                self._entry(oid).owned = True
            for oid in dep_oids:
                self._entry(oid).submitted += 1

    def mark_owned(self, oid: str) -> None:
        with self._lock:
            self._entry(oid).owned = True

    def add_submitted(self, oid: str) -> None:
        with self._lock:
            self._entry(oid).submitted += 1

    def remove_submitted(self, oid: str, core: "CoreWorker") -> None:
        with self._lock:
            e = self.entries.get(oid)
            if e is None:
                return
            e.submitted -= 1
            self._maybe_free(oid, e, core)

    def remove_local(self, oid: str, core: "CoreWorker") -> None:
        with self._lock:
            e = self.entries.get(oid)
            if e is None:
                return
            e.local -= 1
            self._maybe_free(oid, e, core)

    def _maybe_free(self, oid: str, e: RefEntry, core: "CoreWorker") -> None:
        # Called with the lock held; the schedule_* sinks are plain appends.
        if e.local <= 0 and e.submitted <= 0 and not e.freed:
            e.freed = True
            del self.entries[oid]
            if e.owned:
                core.schedule_free(oid)
            # Drop this process's plasma hold: with no local refs left, user
            # code keeping a zero-copy view alive past this point is outside
            # the supported contract (same as the reference's buffer release).
            if oid in core.plasma.held:
                core.schedule_release(oid)


_FP_MOD: Any = None  # None = untried; False = unavailable; module otherwise

# Cached serialized ([], {}) — the args blob of every no-arg task.
_EMPTY_ARGS: Any = None


def _fp_mod():
    """The native fastpath extension, or False when disabled/missing."""
    global _FP_MOD
    if _FP_MOD is None:
        if not config.fastpath_enabled:
            _FP_MOD = False
        else:
            try:
                from ray_tpu_torch._native import _fastpath as m

                _FP_MOD = m
            except Exception:
                _FP_MOD = False
    return _FP_MOD


class Lease:
    __slots__ = (
        "lease_id", "worker_id", "addr", "conn", "raylet_conn",
        "outstanding", "in_idle", "checked_out", "used", "parked_at",
        "fp_port", "fp_channel",
    )

    def __init__(
        self, lease_id: str, worker_id: str, addr, conn, raylet_conn,
        fp_port=None,
    ):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.addr = tuple(addr)
        self.conn: rpc.Connection = conn
        self.raylet_conn: rpc.Connection = raylet_conn
        # Native fastpath channel (src/fastpath.cc): advertised port and the
        # lazily-opened channel id (None until first eligible dispatch;
        # False after a failed connect so we stop retrying).
        self.fp_port = fp_port
        self.fp_channel = None
        # Tasks pushed but not yet replied. The dispatcher pipelines up to
        # PIPELINE_DEPTH tasks per leased worker so the next task's frame is
        # already in the worker's socket buffer when the current one finishes
        # (the worker still executes serially; this hides the RTT).
        self.outstanding = 0
        # Membership flag for the shape pool's idle list (capacity available).
        self.in_idle = False
        # Exclusively handed to an acquire() waiter; release() clears it.
        # While set, pipelined-task reply callbacks must not repark/return it.
        self.checked_out = False
        # True once a task has been dispatched on it (SPREAD pools retire
        # used leases instead of recycling them).
        self.used = False
        # monotonic() when the lease last went fully idle (keep-alive sweep).
        self.parked_at = 0.0


class _ShapePool:
    """Per-resource-shape lease state: queued work items, idle leases, and
    in-flight lease requests to the raylet."""

    __slots__ = (
        "idle", "pending", "inflight", "inflight_ids", "inflight_reqs",
        "leases", "total_outstanding", "resources", "pg_id", "bundle_index",
        "strategy", "sweep_scheduled",
    )

    def __init__(self, resources, pg_id, bundle_index, strategy=None):
        self.idle: List[Lease] = []
        # Work items in FIFO order. Each is ("task", wire, None) — a
        # callback-dispatched task submission — or ("waiter", future, hints)
        # — an async acquire() that receives the lease itself, with optional
        # arg-locality hints ({"host:port": weight}) forwarded to the raylet
        # on the next lease request of this shape.
        self.pending: "deque" = deque()
        self.inflight = 0
        # lease_ids of in-flight RequestWorkerLease RPCs still cancellable on
        # the home raylet.
        self.inflight_ids: set = set()
        # lease_id -> (conn, msgid) of the batched request frame, so a
        # cancel landing before the batch flushes withdraws the entry
        # locally instead of sending a wire cancel for a frame that never
        # went out.
        self.inflight_reqs: dict = {}
        # Live leases of this shape (granted, not yet returned).
        self.leases: set = set()
        # Running total of outstanding pushes across self.leases (kept by
        # dispatch/reply so depth decisions don't re-sum per item).
        self.total_outstanding = 0
        self.resources = resources
        self.pg_id = pg_id
        self.bundle_index = bundle_index
        self.strategy = strategy
        # A keep-alive sweep timer is pending for this pool's parked leases.
        self.sweep_scheduled = False


class LeasePool:
    """Pipelined worker-lease dispatcher (callback-based hot path).

    Reference design: CoreWorkerDirectTaskSubmitter keeps a per-scheduling-key
    queue, pipelines one lease request per queued task (bounded), reuses
    granted workers for queued tasks of the same shape, and returns surplus
    workers to the raylet. The hot path here never creates a coroutine per
    task: `submit_task_fast` queues a wire spec, `_pump` pushes it onto an
    idle lease via `call_nowait`, and the reply callback recycles the lease
    into the next queued item (direct_task_transport.h:75 analog).
    """

    # Max in-flight RequestWorkerLease RPCs per shape (reference knob:
    # max_pending_lease_requests_per_scheduling_category).
    MAX_INFLIGHT = 16
    # Tasks pushed-but-unreplied per leased worker (execution stays serial on
    # the worker; >1 hides the push/reply RTT behind execution). Deep enough
    # that a worker's queue stays non-empty across a whole completion-drain
    # cycle on a loaded single-core host (measured: 16 leaves pipeline
    # bubbles at >10k tasks/s; 64 removes them); _allowed_depth scales this
    # down whenever the backlog is small relative to the lease supply, so
    # long-task bursts still spread.
    PIPELINE_DEPTH = 64

    def __init__(self, core: "CoreWorker"):
        self.core = core
        self.pools: Dict[tuple, _ShapePool] = {}
        # Native fastpath state: task_id -> (key, pool, lease, wire) for
        # tasks in flight on a C++ channel, and whether the completion
        # drainer is wired onto the event loop.
        self._fp_inflight: Dict[str, tuple] = {}
        self._fp_drainer_installed = False

    @staticmethod
    def shape_key(resources: Dict[str, int], pg_id, bundle_index, strategy=None) -> tuple:
        if strategy:
            import json

            # Canonical hashable form; label strategies nest dicts.
            skey = json.dumps(strategy, sort_keys=True)
        else:
            skey = None
        return (tuple(sorted((resources or {}).items())), pg_id, bundle_index, skey)

    def _pool(self, key, resources, pg_id, bundle_index, strategy=None) -> _ShapePool:
        p = self.pools.get(key)
        if p is None:
            p = self.pools[key] = _ShapePool(resources, pg_id, bundle_index, strategy)
        return p

    # -- intake --------------------------------------------------------------

    def submit_task_fast(self, wire: dict) -> None:
        """Queue a dependency-free task wire for callback dispatch."""
        strategy = wire.get("scheduling_strategy")
        key = self.shape_key(
            wire.get("resources"), wire.get("pg_id"), wire.get("bundle_index", -1),
            strategy,
        )
        pool = self._pool(
            key, wire.get("resources") or {}, wire.get("pg_id"),
            wire.get("bundle_index", -1), strategy,
        )
        pool.pending.append(("task", wire, None))
        self._pump(key, pool)

    async def acquire(
        self,
        resources: Dict[str, int],
        pg_id=None,
        bundle_index=None,
        strategy=None,
        locality: Optional[Dict[str, float]] = None,
    ) -> Lease:
        key = self.shape_key(resources, pg_id, bundle_index, strategy)
        pool = self._pool(key, resources, pg_id, bundle_index, strategy)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        pool.pending.append(("waiter", fut, locality))
        self._pump(key, pool)
        return await fut

    # -- pump: match pending work to leases ----------------------------------

    def _pump(self, key, pool: _ShapePool) -> None:
        pending = pool.pending
        if pending and pool.idle:
            # One pass per pump: prune dead leases, then fill lowest-loaded
            # leases first up to the allowed depth. O(idle log idle + items).
            live = []
            for lease in pool.idle:
                if lease.conn.closed:
                    lease.in_idle = False
                    pool.leases.discard(lease)
                else:
                    live.append(lease)
            if len(live) > 1:
                live.sort(key=lambda l: l.outstanding)
            pool.idle[:] = live
            allowed = self._allowed_depth(pool)
            i = 0
            while pending and i < len(pool.idle):
                lease = pool.idle[i]
                if lease.outstanding >= allowed:
                    i += 1
                    continue
                kind, item, _hints = pending.popleft()
                if kind == "waiter":
                    # Waiters check the lease out exclusively.
                    pool.idle.pop(i)
                    lease.in_idle = False
                    if item.done():  # cancelled acquire; lease stays available
                        pool.idle.insert(i, lease)
                        lease.in_idle = True
                        continue
                    lease.checked_out = True
                    item.set_result(lease)
                else:
                    self._dispatch_task(key, pool, lease, item)
                    if not lease.in_idle and i < len(pool.idle) and pool.idle[i] is not lease:
                        continue  # dispatch removed it (depth cap/conn loss)
        shortfall = len(pool.pending) - pool.inflight
        while shortfall > 0 and pool.inflight < self.MAX_INFLIGHT:
            pool.inflight += 1
            shortfall -= 1
            rpc.spawn(self._request_lease(key, pool))
        # Cancel surplus in-flight requests so recycled leases don't leave
        # our own queued RequestWorkerLease RPCs pinning the raylet queue.
        surplus = pool.inflight - len(pool.pending)
        while surplus > 0 and pool.inflight_ids:
            lid = pool.inflight_ids.pop()
            surplus -= 1
            conn, msgid = pool.inflight_reqs.pop(lid, (None, None))
            if conn is not None and conn.closed:
                # The link died with the request on it: teardown already
                # failed the pending future, whose exception path does the
                # slot bookkeeping. Nothing to cancel anywhere.
                continue
            if conn is not None and conn.try_cancel_batched(msgid):
                # The request was still queued in this tick's unsent lease
                # batch: withdrawn locally, so no CancelWorkerLease may go
                # out (the raylet never saw the request; a wire cancel for
                # it would be a cancel for a phantom lease_id). The
                # awaiting coroutine observes its future cancelled and
                # exits; account for the slot here.
                pool.inflight -= 1
                continue
            try:
                (conn if conn is not None else self.core.raylet_conn).push_nowait(
                    "CancelWorkerLease", {"lease_id": lid}
                )
            except rpc.ConnectionLost:
                break

    def _lease_available(self, key, pool: _ShapePool, lease: Lease) -> None:
        """A lease (re)gained capacity: serve pending work or park it."""
        if lease.checked_out:
            return  # an acquire() waiter owns it; release() reparks it
        if lease.conn.closed:
            if lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            pool.leases.discard(lease)
            return
        if (
            pool.strategy
            and pool.strategy.get("spread")
            and lease.used
            and lease.outstanding == 0
        ):
            # SPREAD: one task per granted lease — recycling would funnel the
            # burst back onto whichever node answered first instead of the
            # round-robin placement each lease request received.
            if lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            pool.leases.discard(lease)
            rpc.spawn(self._return_worker(lease, dirty=False))
            self._pump(key, pool)
            return
        if not lease.in_idle:
            pool.idle.append(lease)
            lease.in_idle = True
        self._pump(key, pool)
        # Trim surplus idle capacity back to the raylet. Immediate return
        # only while lease requests are still in flight (a parked lease + a
        # queued request = a pinned CPU another client may be waiting on);
        # otherwise surplus leases park for a short keep-alive window so a
        # bursty submitter (trial loops, iterative drivers) reuses the full
        # worker set instead of re-leasing per burst (reference:
        # worker_lease keepalive in the direct task submitter).
        if not pool.pending and lease.in_idle and lease.outstanding == 0:
            if pool.inflight > 0:
                pool.idle.remove(lease)
                lease.in_idle = False
                pool.leases.discard(lease)
                rpc.spawn(self._return_worker(lease, dirty=False))
                return
            lease.parked_at = time.monotonic()
            self._schedule_idle_sweep(key, pool)

    def _schedule_idle_sweep(self, key, pool: _ShapePool) -> None:
        if getattr(pool, "sweep_scheduled", False):
            return
        pool.sweep_scheduled = True
        keep = config.worker_lease_idle_keep_s
        asyncio.get_running_loop().call_later(
            keep, self._sweep_idle_leases, key, pool
        )

    def _sweep_idle_leases(self, key, pool: _ShapePool) -> None:
        """Return EVERY lease parked past the keep-alive window — a parked
        lease pins its CPUs/TPUs cluster-wide (blocks other jobs and the
        autoscaler's idle scale-down), so the cache is strictly
        time-bounded."""
        pool.sweep_scheduled = False
        if pool.pending:
            return  # busy again; leases are in use
        keep = config.worker_lease_idle_keep_s
        now = time.monotonic()
        expired = [
            l
            for l in pool.idle
            if l.outstanding == 0 and now - l.parked_at >= keep
        ]
        for lease in expired:
            pool.idle.remove(lease)
            lease.in_idle = False
            pool.leases.discard(lease)
            rpc.spawn(self._return_worker(lease, dirty=False))
        if pool.idle:
            self._schedule_idle_sweep(key, pool)

    def _pool_locality_hints(self, pool: _ShapePool) -> Optional[Dict[str, float]]:
        """Aggregate arg-location hints over the next few queued work items
        so the raylet can prefer a node already holding their args. Only
        acquire() waiters carry hints (the dependency-free fast path has no
        plasma args by construction); weights count objects per holder."""
        hints: Optional[Dict[str, float]] = None
        scanned = 0
        for _kind, _item, h in pool.pending:
            if h:
                if hints is None:
                    hints = {}
                for addr_key, w in h.items():
                    hints[addr_key] = hints.get(addr_key, 0.0) + w
            scanned += 1
            if scanned >= 8:
                break
        return hints

    async def _gcs_spill_target(self, pool: _ShapePool):
        """Hop-cap fallback: per-raylet views lag under churn, and a chain of
        stale spillback suggestions can loop (A->B->A). The GCS node table is
        authoritative — pick its least-utilized ALIVE node that can ever fit
        the demand and pin the request there (spilled_from), where it queues
        until resources free instead of bouncing further."""
        try:
            reply = await self.core.gcs.call("GetAllNodes")
        except rpc.RpcError:
            return None
        demand = ResourceSet.from_units(pool.resources or {})
        best = None
        best_util = None
        for n in reply["nodes"]:
            if n.get("state") != "ALIVE":
                continue
            if not pool.pg_id and not demand.is_subset_of(
                ResourceSet.from_units(n["total"])
            ):
                # (PG demands are rewritten to group-scoped names on the
                # raylet; raw names can't be checked against totals here.)
                continue
            util = 0.0
            for k, tot in n["total"].items():
                if tot > 0 and not k.startswith("node:"):
                    util = max(util, 1.0 - n["available"].get(k, 0) / tot)
            if best_util is None or util < best_util:
                best, best_util = n, util
        return None if best is None else best["addr"]

    async def _request_lease(self, key, pool: _ShapePool) -> None:
        from ray_tpu_torch._private.ids import fast_unique_hex

        lease_id = fast_unique_hex()
        raylet_conn = self.core.raylet_conn
        pool.inflight_ids.add(lease_id)
        locality = self._pool_locality_hints(pool)
        # The lease pump runs outside any task context, so the lease RPC
        # would leave the trace at the submit span. Borrow the trace context
        # of the first traced pending task — the request exists to serve it —
        # so the raylet's lease-lifecycle spans join that task's trace.
        for _kind, _item, _h in pool.pending:
            if _kind != "waiter" and isinstance(_item, dict) and _item.get("trace_ctx"):
                _c = _item["trace_ctx"]
                rpc._trace_ctx.set((_c["trace_id"], _c["span_id"]))
                break
        try:
            hops = 0
            used_gcs_fallback = False
            while True:
                # Batched issue: this tick's lease requests to the same
                # raylet ride one LeaseBatch frame. The msgid is recorded so
                # a cancel racing the flush withdraws the entry locally
                # (_pump) instead of sending a wire cancel for a frame that
                # never went out.
                deadline = raylet_conn._effective_deadline(None)
                fut = raylet_conn.call_batched_nowait(
                    "RequestWorkerLease",
                    {
                        "lease_id": lease_id,
                        "resources": pool.resources,
                        "pg_id": pool.pg_id,
                        "bundle_index": pool.bundle_index,
                        "strategy": pool.strategy,
                        "spilled_from": hops > 0,
                        "locality": locality,
                        # Owning job: the raylet's memory-monitor kill policy
                        # groups leased workers by owner for fair shedding.
                        "job_id": self.core.job_id,
                    },
                    deadline=deadline,
                )
                pool.inflight_reqs[lease_id] = (raylet_conn, fut.rpc_msgid)
                try:
                    reply = await raylet_conn._await_reply(fut, deadline)
                except asyncio.CancelledError:
                    if lease_id not in pool.inflight_ids:
                        # Withdrawn pre-flush by _pump's surplus trim, which
                        # already did the slot bookkeeping.
                        return
                    raise
                pool.inflight_ids.discard(lease_id)
                pool.inflight_reqs.pop(lease_id, None)
                if reply.get("cancelled"):
                    pool.inflight -= 1
                    # A cancel can cross new work: we asked to cancel this
                    # request while the queue was empty, and a task was
                    # submitted before the cancelled reply landed. Without a
                    # re-pump that task would sit pending with no request in
                    # flight, forever.
                    if pool.pending:
                        self._pump(key, pool)
                    return
                if reply.get("granted"):
                    conn = await self.core.connect_to(tuple(reply["worker_addr"]))
                    lease = Lease(
                        reply["lease_id"],
                        reply["worker_id"],
                        reply["worker_addr"],
                        conn,
                        raylet_conn,
                        fp_port=reply.get("fp_port"),
                    )
                    pool.inflight -= 1
                    pool.leases.add(lease)
                    self._lease_available(key, pool, lease)
                    return
                spill = reply.get("spillback")
                if spill is None:
                    raise rpc.RpcError(
                        f"no node can host resources {pool.resources} (cluster infeasible)"
                    )
                hops += 1
                if hops > 4:
                    if used_gcs_fallback:
                        raise rpc.RpcError(
                            "lease spillback loop exceeded 4 hops after "
                            "GCS-view fallback"
                        )
                    # Spillback chain overran its budget (stale views can
                    # bounce a request between nodes): re-anchor on the GCS
                    # global view instead of failing the task.
                    used_gcs_fallback = True
                    target_addr = await self._gcs_spill_target(pool)
                    if target_addr is None:
                        raise rpc.RpcError(
                            f"no node can host resources {pool.resources} "
                            "(cluster infeasible)"
                        )
                    hops = 1  # fresh budget; stays pinned (spilled_from)
                    raylet_conn = await self.core.connect_to(tuple(target_addr))
                    continue
                raylet_conn = await self.core.connect_to(tuple(spill["addr"]))
        except Exception as e:
            pool.inflight -= 1
            pool.inflight_ids.discard(lease_id)
            pool.inflight_reqs.pop(lease_id, None)
            # Fail one pending item (the request served one logical slot).
            while pool.pending:
                kind, item, _hints = pool.pending.popleft()
                if kind == "waiter":
                    if not item.done():
                        item.set_exception(e)
                        return
                else:
                    self.core._finish_task_error(item, e)
                    return
            return
        # unreachable: grant/cancel paths return above
        # (kept for clarity; inflight bookkeeping handled per-branch)

    # -- task dispatch over a lease (callback chain) -------------------------

    def _pool_depth(self, pool: _ShapePool) -> int:
        # SPREAD pools place per task: no pipelining, or one granted lease
        # would swallow the whole burst the strategy wants distributed.
        if pool.strategy and pool.strategy.get("spread"):
            return 1
        return self.PIPELINE_DEPTH

    def _allowed_depth(self, pool: _ShapePool) -> int:
        """Backlog-aware pipelining: pipeline deeply only when the backlog
        exceeds the lease supply. A burst of long tasks must spread over the
        leases (and spillback targets) being granted for it, not serialize
        behind the first granted worker; a deep backlog of short tasks still
        gets full-depth pipelining."""
        base = self._pool_depth(pool)
        if base == 1:
            return 1
        supply = max(1, len(pool.leases) + pool.inflight)
        backlog = len(pool.pending) + pool.total_outstanding
        return max(1, min(base, -(-backlog // supply)))

    def _dispatch_task(self, key, pool: _ShapePool, lease: Lease, wire: dict) -> None:
        """Push one task onto a lease. Caller guarantees lease.in_idle and
        capacity; this updates the capacity accounting."""
        core = self.core
        entry = core._inflight_tasks.get(wire["task_id"])
        if entry is not None and entry["cancelled"]:
            core._finish_task_error(
                wire, TaskCancelledError(f"task {wire['name']} was cancelled")
            )
            return
        if entry is not None:
            entry["conn"] = lease.conn
        core.record_task_event(wire["task_id"], wire["name"], "RUNNING")
        if (
            lease.fp_port
            and lease.fp_channel is not False
            and wire.get("args_blob") is not None
            and not wire.get("ref_positions")
            and not wire.get("kw_ref_keys")
            and wire.get("num_returns") == 1
            and "trace_ctx" not in wire
            and not wire.get("_no_fastpath")
            and not wire.get("runtime_env")  # env_vars/working_dir need the
            and not config.task_profile_events  # RPC path's application step
            and self._fp_submit(key, pool, lease, wire)
        ):
            lease.outstanding += 1
            pool.total_outstanding += 1
            lease.used = True
            if lease.outstanding >= self._pool_depth(pool) and lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            return
        try:
            # Inline reply callback (no Future/call_soon hop): the reply
            # dispatches _on_task_reply straight from the read path.
            lease.conn.call_cb(
                "PushTask",
                {"spec": wire},
                lambda r, e, k=key, p=pool, l=lease, w=wire: self._on_task_reply(
                    k, p, l, w, r, e
                ),
            )
        except rpc.ConnectionLost:
            if lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            pool.leases.discard(lease)
            rpc.spawn(self._return_worker(lease, dirty=True))
            self._retry_or_fail(key, pool, wire, rpc.ConnectionLost("worker connection lost"))
            return
        lease.outstanding += 1
        pool.total_outstanding += 1
        lease.used = True
        if lease.outstanding >= self._pool_depth(pool) and lease.in_idle:
            pool.idle.remove(lease)
            lease.in_idle = False

    # -- native fastpath (src/fastpath.cc) -----------------------------------

    def _fp_submit(self, key, pool: _ShapePool, lease: Lease, wire: dict) -> bool:
        """Hand one eligible task to the C++ direct-call channel. Returns
        False (and poisons the lease's channel) when the native path is
        unavailable, so the caller falls through to the RPC push."""
        fp = _fp_mod()
        if not fp:
            lease.fp_channel = False
            return False
        if lease.fp_channel is None:
            ch = fp.client_connect(lease.addr[0], lease.fp_port)
            if ch < 0:
                lease.fp_channel = False
                return False
            lease.fp_channel = ch
            if not self._fp_drainer_installed:
                asyncio.get_running_loop().add_reader(
                    fp.notify_fd(), self._fp_drain, fp
                )
                self._fp_drainer_installed = True
        tid = wire["task_id"]
        # bytes() wrap: the C++ side reads the args with "y#", which takes
        # bytes only, and to_bytes() gives a bytearray when the args carry
        # out-of-band buffers (an array or a tensor of more than 512 bytes).
        blob = wire["args_blob"]
        if not isinstance(blob, bytes):
            blob = bytes(blob)
        if not fp.submit(
            lease.fp_channel,
            tid.encode(),
            wire["func_id"].encode(),
            wire["name"].encode(),
            blob,
        ):
            lease.fp_channel = False
            return False
        self._fp_inflight[tid] = (key, pool, lease, wire)
        return True

    def _fp_drain(self, fp) -> None:
        """Event-loop callback: fold a batch of native completions into the
        normal reply bookkeeping (one loop wakeup per batch, not per task)."""
        for tid, status, payload in fp.drain():
            entry = self._fp_inflight.pop(tid.decode(), None)
            if entry is None:
                continue
            key, pool, lease, wire = entry
            if status == 0:  # inline value
                self._on_task_reply(
                    key, pool, lease, wire, {"returns": [{"inline": payload}]}, None
                )
            elif status == 6:  # large value parked in worker-side plasma
                import pickle

                self._on_task_reply(
                    key, pool, lease, wire,
                    {"returns": [pickle.loads(payload)]}, None,
                )
            elif status == 1:  # application error (serialized exception)
                if not payload:
                    # The C++ callback shim failed before Python could
                    # serialize anything; surface a real exception.
                    payload = serialization.serialize(
                        WorkerCrashedError("fastpath execution failed")
                    ).to_bytes()
                self._on_task_reply(
                    key, pool, lease, wire, {"error": payload}, None
                )
            elif status == 4:  # function not cached there: RPC path exports it
                lease.outstanding -= 1
                pool.total_outstanding -= 1
                wire["_no_fastpath"] = True
                pool.pending.append(("task", wire, None))
                self._lease_available(key, pool, lease)
            else:  # 2: channel lost — normal worker-death retry machinery
                lease.fp_channel = False
                self._on_task_reply(
                    key, pool, lease, wire, None, rpc._CONNECTION_LOST
                )

    def _on_task_reply(self, key, pool: _ShapePool, lease: Lease, wire: dict, reply, err) -> None:
        core = self.core
        lease.outstanding -= 1
        pool.total_outstanding -= 1
        entry = core._inflight_tasks.get(wire["task_id"])
        if entry is not None:
            entry["conn"] = None
        exc = None
        if err is not None:
            exc = (
                rpc.ConnectionLost("worker connection lost")
                if err == rpc._CONNECTION_LOST
                else rpc.RpcError(err)
            )
        if exc is None:
            core._store_task_results(wire, reply)
            if reply.get("error") is None and wire.get("actor_id") is None:
                core._register_lineage(wire, reply)
                core.record_task_event(wire["task_id"], wire["name"], "FINISHED")
            core._cleanup_task(wire)
            self._lease_available(key, pool, lease)
            return
        if isinstance(exc, rpc.ConnectionLost):
            if lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            pool.leases.discard(lease)
            if lease.outstanding == 0:
                rpc.spawn(self._return_worker(lease, dirty=True))
            if entry is not None and entry["cancelled"]:
                core._finish_task_error(
                    wire, TaskCancelledError(f"task {wire['name']} was cancelled")
                )
                return
            self._retry_or_fail(key, pool, wire, exc)
            return
        # Handler-level RpcError (worker alive): the task failed terminally.
        core._finish_task_error(wire, exc)
        self._lease_available(key, pool, lease)

    def _retry_or_fail(self, key, pool: _ShapePool, wire: dict, exc) -> None:
        core = self.core
        attempt = wire.get("_attempt", 0)
        if attempt < wire.get("max_retries", 0):
            wire["_attempt"] = attempt + 1
            core.record_task_event(
                wire["task_id"], wire["name"], "RETRY", attempt=attempt
            )
            logger.warning(
                "task %s attempt %d failed (%s); retrying", wire["name"], attempt, exc
            )
            loop = asyncio.get_running_loop()
            loop.call_later(
                min(1.0, 0.1 * (attempt + 1)),
                lambda: (pool.pending.append(("task", wire, None)), self._pump(key, pool)),
            )
        else:
            core._finish_task_error(
                wire,
                WorkerCrashedError(
                    f"task {wire['name']} failed after retries: {exc}"
                ),
            )

    # -- release / teardown --------------------------------------------------

    async def release(
        self, lease: Lease, resources, pg_id=None, bundle_index=None,
        dirty=False, strategy=None,
    ):
        key = self.shape_key(resources, pg_id, bundle_index, strategy)
        pool = self._pool(key, resources, pg_id, bundle_index, strategy)
        lease.checked_out = False
        if dirty or lease.conn.closed:
            if lease.in_idle:
                pool.idle.remove(lease)
                lease.in_idle = False
            pool.leases.discard(lease)
            await self._return_worker(lease, dirty=True)
            self._pump(key, pool)
            return
        self._lease_available(key, pool, lease)

    async def _return_worker(self, lease: Lease, dirty: bool) -> None:
        if isinstance(lease.fp_channel, int):
            fp = _fp_mod()
            if fp:
                try:
                    fp.client_close(lease.fp_channel)
                except Exception:
                    pass
            lease.fp_channel = False
        try:
            await lease.raylet_conn.call_batched(
                "ReturnWorker", {"lease_id": lease.lease_id, "dirty": dirty}
            )
        except rpc.RpcError:
            pass

    async def drain(self):
        for pool in self.pools.values():
            for lease in pool.idle:
                lease.in_idle = False
                pool.leases.discard(lease)
                await self._return_worker(lease, dirty=False)
            pool.idle.clear()


class ActorSubmitter:
    """Direct transport to one actor with per-handle sequencing and
    restart-aware redirection."""

    def __init__(self, core: "CoreWorker", actor_id: str):
        self.core = core
        self.actor_id = actor_id
        self.seq = 0
        self.conn: Optional[rpc.Connection] = None
        self.state = "PENDING"
        self.addr = None
        self.incarnation = 0
        self._lock = asyncio.Lock()
        # Count of slow-path submissions queued but not yet sent. While
        # nonzero the fast path must not cut the line (ordered actors execute
        # calls in submission order).
        self.pending_slow = 0

    async def _resolve(self, timeout: Optional[float] = None) -> None:
        if timeout is None:
            timeout = config.actor_resolve_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            reply = await self.core.gcs.call("GetActor", {"actor_id": self.actor_id})
            info = reply["actor"]
            if info is None:
                raise ActorDiedError(f"actor {self.actor_id[:8]} unknown to GCS")
            self.state = info["state"]
            if info["state"] == "ALIVE":
                # A restarted incarnation starts its sequence log fresh.
                if info["num_restarts"] != self.incarnation:
                    self.incarnation = info["num_restarts"]
                    self.seq = 0
                self.addr = tuple(info["addr"])
                self.conn = await self.core.connect_to(self.addr)
                return
            if info["state"] == "DEAD":
                raise ActorDiedError(
                    f"actor {self.actor_id[:8]} is dead: {info.get('death_cause')}"
                )
            await asyncio.sleep(0.1)
        raise ActorDiedError(f"timed out waiting for actor {self.actor_id[:8]} to start")

    async def submit(self, wire: dict) -> dict:
        async with self._lock:
            if self.conn is None or self.conn.closed:
                self.conn = None
                await self._resolve()
            conn = self.conn
            wire["seq_no"] = self.seq
            self.seq += 1
        try:
            return await conn.call("PushActorTask", {"spec": wire})
        except rpc.ConnectionLost:
            # Actor worker died mid-call. In-flight tasks fail (reference
            # semantics: no silent at-least-once resend); the next submit
            # re-resolves and lands on the restarted incarnation if any.
            self.conn = None
            raise ActorUnavailableError(
                f"actor {self.actor_id[:8]} died while task {wire['name']!r} was in flight"
            )
        except rpc.RpcError as e:
            if "no handler for method" not in str(e):
                raise
            # The actor's address answered, but not as an actor worker: the
            # worker died and another process took its port before the GCS
            # heard of the death. As a lost connection: the next submit
            # re-resolves.
            self.conn = None
            raise ActorUnavailableError(
                f"actor {self.actor_id[:8]}'s address {self.addr} is served by another "
                f"process: its worker is gone"
            )


def function_id_of(pickled: bytes) -> str:
    return hashlib.blake2b(pickled, digest_size=16).hexdigest()


class CoreWorker:
    """One per process. Owns the event-loop-side runtime state."""

    def __init__(
        self,
        *,
        job_id: str,
        session_name: str,
        node_id: str,
        gcs_conn: rpc.Connection,
        raylet_conn: rpc.Connection,
        is_driver: bool,
        worker_id: str,
        server: rpc.Server,
        gcs_leader_file: Optional[str] = None,
    ):
        self.job_id = job_id
        self.session_name = session_name
        self.node_id = node_id
        resolver = None
        if gcs_leader_file:
            from ray_tpu_torch._private import gcs_ha

            resolver = gcs_ha.file_resolver(gcs_leader_file)
        self.gcs = GcsClient(gcs_conn, resolver=resolver)
        self.raylet_conn = raylet_conn
        self.is_driver = is_driver
        self.worker_id = worker_id
        self.server = server  # shared rpc server (object server + task server)
        self.addr: Optional[Tuple[str, int]] = None  # set after server start
        self.raylet_addr: Optional[Tuple[str, int]] = None

        self.memory_store = MemoryStore()
        self.plasma = PlasmaClient(raylet_conn)
        self.reference_table = ReferenceTable()
        self.lease_pool = LeasePool(self)
        self.actor_submitters: Dict[str, ActorSubmitter] = {}
        self._conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._func_ids_exported: set = set()
        # Bounded (reference: task_event_buffer max buffer size): under
        # sustained 10k+ tasks/s the ring drops oldest events rather than
        # growing the 1 Hz GCS flush without bound.
        import collections as _collections

        self._task_events: "deque" = _collections.deque(
            maxlen=config.task_events_max_buffer
        )
        self._free_queue: List[str] = []
        self._release_queue: List[str] = []
        # Single-hold releases from value finalizers; appended from whatever
        # thread runs GC (list.append is atomic), drained by the flush loop.
        self._release_one_queue: List[str] = []
        # task_id -> {"cancelled": bool, "conn": live worker conn or None}
        self._inflight_tasks: Dict[str, dict] = {}
        self._oid_to_task: Dict[str, str] = {}
        # Streaming-generator state per producing task (reference:
        # TryReadObjectRefStream): items land here as GeneratorItem pushes
        # arrive; "done" carries the final count from the task reply.
        self._dyn_streams: Dict[str, dict] = {}
        self._oid_to_dyn: Dict[str, str] = {}
        # Lineage: oid -> {"wire": producing TaskSpec wire, "attempts": int,
        # "nbytes": retained-spec size estimate}. Lost plasma-resident task
        # returns are recomputed by re-running the producing task (reference:
        # object_recovery_manager.h:41 + task_manager.cc; deterministic
        # return ids from ids.py make the recomputed object land under the
        # same id). Ordered: total retained bytes are bounded by
        # config.lineage_bytes_limit with least-recently-registered/used
        # eviction (reference: lineage_pinning / TaskManager lineage bytes
        # accounting), so a long-lived driver cannot leak every spec it ever
        # submitted.
        self.lineage: "OrderedDict[str, dict]" = OrderedDict()
        self._lineage_bytes = 0
        # Oids whose lineage fell to the byte cap (NOT freed): recovery of
        # these raises the typed pruned error instead of the generic
        # "no lineage", so callers can tell a tuning problem from an
        # unreconstructable-by-design object.
        self._lineage_pruned: set = set()
        self._recovering: Dict[str, asyncio.Future] = {}
        self.closed = False
        self._bg_tasks: List[asyncio.Task] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._flush_wake = False
        # Cross-thread submission buffer: .remote() fast paths (any thread)
        # append wire specs here and schedule ONE loop wakeup per burst —
        # call_soon_threadsafe per call costs more than the submission itself.
        self._submit_buf: deque = deque()
        self._submit_wake = False

        server.register("GetObject", self._handle_get_object)
        server.register("GeneratorItem", self._handle_generator_item)
        server.register("DynNext", self._handle_dyn_next)
        server.register("WaitObject", self._handle_wait_object)
        server.register("RecoverObject", self._handle_recover_object)
        server.register("Ping", self._handle_ping)

    def start_background(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._bg_tasks.append(rpc.spawn(self._flush_loop()))
        # Owner-side node-death watch: when a node dies, every owned plasma
        # object whose primary copy lived there is gone — kick lineage
        # reconstruction eagerly instead of waiting for the next get to trip
        # over the dead address (reference: object_recovery_manager +
        # WaitForObjectEviction node-death subscription).
        self._bg_tasks.append(rpc.spawn(self._watch_node_deaths()))
        # Periodic runtime-telemetry flush to the GCS aggregate. Idempotent
        # per process: in an in-process cluster the driver's CoreWorker wins
        # and the shared registry flushes once.
        telemetry.start_flusher(self.gcs.call, self.worker_id, self.node_id)
        # Same deal for the runtime-span buffer (no-op when tracing is off).
        from ray_tpu_torch.util import tracing

        tracing.start_span_flusher(self.gcs.call, self.worker_id, self.node_id)

    async def _flush_loop(self) -> None:
        while not self.closed:
            await asyncio.sleep(1.0)
            await self._flush_free_queue()
            await self._flush_release_queue()
            await self._flush_release_one_queue()
            await self._flush_task_events()

    def _wake_flush(self) -> None:
        """Prompt (debounced) free/release flush. Dropping a large object's
        last ref must recycle its arena span quickly — the span's pages are
        already faulted in, so reusing them keeps big puts off the kernel's
        first-touch page-allocation path."""
        if self._flush_wake or self._loop is None:
            return
        self._flush_wake = True
        try:
            self._loop.call_soon_threadsafe(self._start_prompt_flush)
        except RuntimeError:
            self._flush_wake = False

    def _start_prompt_flush(self) -> None:
        self._flush_wake = False
        if not self.closed:
            rpc.spawn(self._flush_frees_once())

    async def _flush_frees_once(self) -> None:
        await self._flush_free_queue()
        await self._flush_release_queue()
        await self._flush_release_one_queue()

    async def _flush_release_queue(self) -> None:
        if not self._release_queue:
            return
        oids, self._release_queue = self._release_queue, []
        await self.plasma.release_many(oids)

    async def _flush_release_one_queue(self) -> None:
        if not self._release_one_queue:
            return
        oids, self._release_one_queue = self._release_one_queue, []
        counts: Dict[str, int] = {}
        for oid in oids:
            counts[oid] = counts.get(oid, 0) + 1
        await self.plasma.release_value_holds(counts)

    async def _flush_free_queue(self) -> None:
        if not self._free_queue:
            return
        oids, self._free_queue = self._free_queue, []
        to_delete_local = []
        for oid in oids:
            entry = self.memory_store.get(oid)
            self.memory_store.delete(oid)
            if entry is not None and entry.kind == IN_PLASMA:
                if entry.plasma_addr == self.raylet_addr:
                    to_delete_local.append(oid)
                else:
                    rpc.spawn(self._delete_remote(oid, entry.plasma_addr))
        if to_delete_local:
            try:
                await self.plasma.delete(to_delete_local)
            except rpc.RpcError:
                pass

    async def _delete_remote(self, oid: str, addr) -> None:
        try:
            conn = await self.connect_to(tuple(addr))
            await conn.call("ObjDelete", {"oids": [oid]})
        except rpc.RpcError:
            pass

    async def _flush_task_events(self) -> None:
        if not self._task_events:
            return
        # Drain with popleft: producers append from other threads (worker
        # exec thread records PROFILE events), so list()+clear() would drop
        # anything appended between the snapshot and the clear.
        events = []
        try:
            while True:
                events.append(self._task_events.popleft())
        except IndexError:
            pass
        # Expand the hot-path tuples into wire dicts at flush time (the
        # constant per-process fields are added once here, not per event).
        out = []
        for task_id, name, state, ts, extra in events:
            ev = {
                "task_id": task_id,
                "name": name,
                "state": state,
                "job_id": self.job_id,
                "worker_id": self.worker_id,
                "node_id": self.node_id,
                "time": ts,
            }
            if extra:
                ev.update(extra)
            out.append(ev)
        try:
            await self.gcs.call("AddTaskEvents", {"events": out})
        except rpc.RpcError:
            pass

    def record_task_event(self, task_id: str, name: str, state: str, **extra) -> None:
        self._task_events.append((task_id, name, state, time.time(), extra or None))

    def schedule_free(self, oid: str) -> None:
        self._free_queue.append(oid)
        self._drop_lineage(oid)
        self._lineage_pruned.discard(oid)
        dyn_task = self._oid_to_dyn.pop(oid, None)
        if dyn_task is not None:
            self._dyn_streams.pop(dyn_task, None)
        self._wake_flush()

    def schedule_release(self, oid: str) -> None:
        self._release_queue.append(oid)
        self._wake_flush()

    async def connect_to(self, addr: Tuple[str, int]) -> rpc.Connection:
        addr = tuple(addr)
        conn = self._conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(
                *addr,
                handlers=self.server._handlers,
                sync_handlers=self.server._sync_handlers,
            )
            self._conns[addr] = conn
        return conn

    # ------------------------------------------------------------------ put

    async def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random().hex()
        await self.put_with_id(oid, value)
        ref = ObjectRef(oid, self.addr, self)
        self.reference_table.mark_owned(oid)
        return ref

    async def put_with_id(self, oid: str, value: Any) -> None:
        serialized = serialization.serialize(value)
        if serialized.total_size <= config.max_direct_call_object_size:
            self.memory_store.put_inline(oid, serialized.to_bytes())
        else:
            await self.plasma.put_serialized(oid, serialized)
            self.memory_store.put_plasma_marker(oid, self.raylet_addr)

    # ------------------------------------------------------------------ get

    async def get_objects(self, refs: List[ObjectRef], timeout: Optional[float]) -> List[Any]:
        single = False
        if isinstance(refs, ObjectRef):
            refs, single = [refs], True
        deadline = time.monotonic() + timeout if timeout is not None else None
        # Fast path: inline values already in the memory store resolve
        # synchronously — no gather Task per ref (matters when getting
        # thousands of mostly-completed refs).
        payloads = [None] * len(refs)
        pending_idx = []
        mget = self.memory_store.get
        for i, r in enumerate(refs):
            entry = mget(r.hex())
            if entry is not None and entry.kind == INLINE:
                payloads[i] = entry.payload
            else:
                pending_idx.append(i)
        if pending_idx:
            fetched = await asyncio.gather(
                *(self._resolve_payload(refs[i], deadline) for i in pending_idx)
            )
            for i, p in zip(pending_idx, fetched):
                payloads[i] = p
        values = []
        with serialization.DeserializationContext(
            ref_deserializer=self._deserialize_ref
        ):
            for ref, payload in zip(refs, payloads):
                if isinstance(payload, memoryview):
                    # Plasma-backed zero-copy value: one hold follows the
                    # value's out-of-band buffers, so the arena bytes stay
                    # mapped while anything built on them is alive (a numpy
                    # array in a tuple, a view taken out of it), whether or
                    # not the ObjectRef lives on, and can be spilled/evicted
                    # once they are collected (reference: plasma client
                    # buffer refcounts).
                    value, is_exc = serialization.deserialize(
                        payload, on_release=self._value_hold(ref.hex()))
                else:
                    value, is_exc = serialization.deserialize(payload)
                if is_exc:
                    raise value
                values.append(value)
        return values[0] if single else values

    def _queue_release_one(self, oid: str) -> None:
        # Bound method (not list.append) so finalizers always reach the
        # *current* queue — the flush loop swaps the list object out.
        self._release_one_queue.append(oid)
        self._wake_flush()

    def _value_hold(self, oid: str):
        """Move one of this process's holds on `oid` to a value's lifetime:
        the ObjectRef's release no longer drops it; the returned callback
        (run when the value's buffers are collected) does."""
        self.plasma.hold_for_value(oid)
        return functools.partial(self._queue_release_one, oid)

    def _deserialize_ref(self, hex_id, owner_addr):
        return ObjectRef(hex_id, owner_addr, self)

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise GetTimeoutError("get timed out")
        return rem

    async def _resolve_payload(
        self, ref: ObjectRef, deadline, purpose: str = "get"
    ) -> bytes:
        oid = ref.hex()
        entry = self.memory_store.get(oid)
        owned = oid in self.reference_table.entries and self.reference_table.entries[oid].owned
        if entry is None and owned:
            entry = await self.memory_store.wait_for(oid, self._remaining(deadline))
            if entry is None:
                raise GetTimeoutError(f"timed out waiting for {oid[:12]}")
        if entry is not None:
            if entry.kind == INLINE:
                return entry.payload
            recoveries = 0
            while True:
                try:
                    return await self._fetch_plasma(
                        oid, entry.plasma_addr, deadline, purpose
                    )
                except (ObjectLostError, rpc.RpcError):
                    # Primary copy gone (node death, eviction). If we own it
                    # and have lineage, recompute; else propagate.
                    if not owned or recoveries >= config.max_lineage_reconstruction:
                        raise
                    recoveries += 1
                    await self.recover_object(oid)
                    entry = self.memory_store.get(oid)
                    if entry is None:
                        raise ObjectLostError(
                            f"object {oid[:12]} lost and reconstruction "
                            "produced no value"
                        )
                    if entry.kind == INLINE:
                        return entry.payload
        # Borrowed ref: try local plasma first (common when the primary copy
        # is on our node), else ask the owner.
        found, _ = await self.plasma.get([oid], block=False)
        if oid in found:
            return found[oid]
        return await self._fetch_from_owner(ref, deadline)

    async def _fetch_plasma(
        self, oid: str, plasma_addr, deadline, purpose: str = "get"
    ) -> memoryview:
        if tuple(plasma_addr) == self.raylet_addr:
            found, missing = await self.plasma.get([oid], timeout=self._remaining(deadline))
            if oid in found:
                return found[oid]
            raise ObjectLostError(f"object {oid[:12]} lost from local store")
        return await self.plasma.pull(oid, tuple(plasma_addr), purpose)

    async def _fetch_from_owner(self, ref: ObjectRef, deadline) -> bytes:
        if ref.owner_addr is None:
            raise ObjectLostError(f"no owner known for {ref.hex()[:12]}")
        if tuple(ref.owner_addr) == self.addr:
            # We are the owner but have no entry: freed or never created.
            raise ObjectLostError(f"object {ref.hex()[:12]} no longer exists on owner")
        try:
            conn = await self.connect_to(ref.owner_addr)
            reply = await conn.call(
                "GetObject",
                {"oid": ref.hex(), "timeout": self._remaining(deadline)},
                timeout=None,
            )
        except rpc.ConnectionLost as e:
            # The owner process is gone; with it goes the object's directory
            # entry and any lineage (reference: OwnerDiedError).
            raise ObjectLostError(
                f"owner of {ref.hex()[:12]} at {tuple(ref.owner_addr)} is "
                f"unreachable ({e}); object cannot be recovered"
            ) from e
        for _ in range(config.max_lineage_reconstruction + 1):
            status = reply.get("status")
            if status == "inline":
                return reply["payload"]
            if status == "plasma":
                try:
                    return await self._fetch_plasma(
                        ref.hex(), tuple(reply["addr"]), deadline
                    )
                except (ObjectLostError, rpc.RpcError):
                    # Primary copy unreachable; ask the owner to recover it
                    # (lineage re-execution on the owner side) and retry with
                    # the fresh location.
                    try:
                        reply = await conn.call(
                            "RecoverObject",
                            {"oid": ref.hex(), "timeout": self._remaining(deadline)},
                            timeout=None,
                        )
                    except rpc.ConnectionLost as e:
                        raise ObjectLostError(
                            f"owner of {ref.hex()[:12]} died during recovery "
                            f"({e}); object cannot be recovered"
                        ) from e
                    continue
            if status == "timeout":
                raise GetTimeoutError(f"owner timed out resolving {ref.hex()[:12]}")
            err_cls = (
                ObjectReconstructionFailedError
                if reply.get("reconstruction_failed")
                else ObjectLostError
            )
            raise err_cls(
                f"owner reports {ref.hex()[:12]}: {status}"
                + (f" ({reply['error']})" if reply.get("error") else "")
            )
        raise ObjectLostError(
            f"object {ref.hex()[:12]} unrecoverable after repeated owner recovery"
        )

    # -- owner-side object server -------------------------------------------

    async def _handle_get_object(self, conn, p):
        entry = await self.memory_store.wait_for(p["oid"], p.get("timeout", 300))
        if entry is None:
            known = p["oid"] in self.reference_table.entries
            return {"status": "timeout" if known else "unknown"}
        if entry.kind == INLINE:
            return {"status": "inline", "payload": entry.payload}
        return {"status": "plasma", "addr": list(entry.plasma_addr)}

    async def _handle_wait_object(self, conn, p):
        entry = await self.memory_store.wait_for(p["oid"], p.get("timeout"))
        return {"ready": entry is not None}

    async def _handle_recover_object(self, conn, p):
        """Borrower reports our object's primary copy lost; reconstruct via
        lineage and reply with the fresh location."""
        oid = p["oid"]
        try:
            await self.recover_object(oid)
        except ObjectReconstructionFailedError as e:
            # Typed flag so the borrower re-raises the reconstruction error
            # class, not the generic loss (callers branch on it to decide
            # between re-submitting work and failing the pipeline).
            return {"status": "lost", "error": str(e), "reconstruction_failed": True}
        except ObjectLostError as e:
            return {"status": "lost", "error": str(e)}
        entry = await self.memory_store.wait_for(oid, p.get("timeout") or 300)
        if entry is None:
            return {"status": "timeout"}
        if entry.kind == INLINE:
            return {"status": "inline", "payload": entry.payload}
        return {"status": "plasma", "addr": list(entry.plasma_addr)}

    # ---------------------------------------------- streaming generators

    def _dyn_stream(self, task_id: str) -> dict:
        st = self._dyn_streams.get(task_id)
        if st is None:
            st = self._dyn_streams[task_id] = {"items": {}, "done": None, "waiters": []}
        return st

    @staticmethod
    def _dyn_wake(st: dict) -> None:
        for w in st["waiters"]:
            if not w.done():
                w.set_result(None)
        st["waiters"].clear()

    def _dyn_item_oid(self, task_id: str, i: int) -> str:
        return deterministic_object_id(TaskID.from_hex(task_id), i + 1).hex()

    def _dyn_fail(self, task_id: str, error_payload: bytes) -> None:
        """Terminate a stream on producer failure: items not yet produced
        resolve to the task's error (consumers must not hang)."""
        st = self._dyn_stream(task_id)
        st["failed"] = error_payload
        self._dyn_wake(st)

    def _dyn_publish(self, task_id: str, total=None) -> None:
        """Publish the task's return value as a streaming generator so
        consumers start iterating while the producer still runs."""
        rid = return_object_ids(task_id, 1)[0]
        self._oid_to_dyn[rid] = task_id
        if total is None and self.memory_store.contains(rid):
            return
        gen = ObjectRefGenerator(task_id=task_id, owner_addr=self.addr, total=total)
        self.memory_store.put_inline(rid, serialization.serialize(gen).to_bytes())

    async def _handle_generator_item(self, conn, p):
        """One streamed item from the producing worker (reference:
        ReportGeneratorItemReturns, core_worker.proto)."""
        task_id, idx, ret = p["task_id"], p["index"], p["ret"]
        st = self._dyn_stream(task_id)
        oid = self._dyn_item_oid(task_id, idx)
        if "inline" in ret:
            self.memory_store.put_inline(oid, ret["inline"])
        else:
            self.memory_store.put_plasma_marker(oid, tuple(ret["plasma"]))
        self.reference_table.mark_owned(oid)
        st["items"][idx] = {k: v for k, v in ret.items() if k != "inline"} or {"inline": True}
        self._dyn_publish(task_id)
        self._dyn_wake(st)
        return {"ok": True}

    async def dyn_next(self, task_id: str, owner_addr, i: int):
        """Blocking read of stream item i; None when the stream ends first."""
        if owner_addr is None or tuple(owner_addr) == self.addr:
            st = self._dyn_stream(task_id)
            while True:
                oid = self._dyn_item_oid(task_id, i)
                if (
                    i in st["items"]
                    or (st["done"] is not None and i < st["done"])
                    or self.memory_store.contains(oid)
                ):
                    return ObjectRef(oid, self.addr, self)
                if st.get("failed") is not None:
                    # Surface the producer's error through the item ref.
                    self.memory_store.put_inline(oid, st["failed"])
                    return ObjectRef(oid, self.addr, self)
                if st["done"] is not None:
                    return None
                fut = asyncio.get_running_loop().create_future()
                st["waiters"].append(fut)
                await fut
        conn = await self.connect_to(tuple(owner_addr))
        while True:
            reply = await conn.call(
                "DynNext", {"task_id": task_id, "index": i, "timeout": 10}
            )
            if reply.get("pending"):
                continue
            if reply.get("gone"):
                raise ObjectLostError(
                    f"generator stream {task_id[:12]} is gone (freed by owner)"
                )
            if reply.get("done"):
                return None
            return ObjectRef(reply["oid"], tuple(owner_addr), self)

    async def dyn_total(self, task_id: str, owner_addr):
        if owner_addr is None or tuple(owner_addr) == self.addr:
            st = self._dyn_stream(task_id)
            while st["done"] is None:
                if st.get("failed") is not None:
                    return len(st["items"])
                fut = asyncio.get_running_loop().create_future()
                st["waiters"].append(fut)
                await fut
            return st["done"]
        conn = await self.connect_to(tuple(owner_addr))
        while True:
            reply = await conn.call("DynNext", {"task_id": task_id, "timeout": 10})
            if reply.get("pending"):
                continue
            if reply.get("gone"):
                raise ObjectLostError(
                    f"generator stream {task_id[:12]} is gone (freed by owner)"
                )
            return reply["total"]

    async def _handle_dyn_next(self, conn, p):
        """Borrower-side stream read (long-poll against the owner)."""
        task_id = p["task_id"]
        st = self._dyn_streams.get(task_id)
        if st is None:
            # No live stream state: answer from surviving objects, else the
            # stream is gone (freed or owner restarted) — do not resurrect
            # empty state that would make the borrower poll forever.
            i = p.get("index")
            if i is not None and self.memory_store.contains(
                self._dyn_item_oid(task_id, i)
            ):
                return {"oid": self._dyn_item_oid(task_id, i)}
            rid = return_object_ids(task_id, 1)[0]
            if not self.memory_store.contains(rid):
                return {"gone": True}
            st = self._dyn_stream(task_id)
        i = p.get("index")
        deadline = time.monotonic() + (p.get("timeout") or 10)
        while True:
            if i is None:
                if st["done"] is not None:
                    return {"total": st["done"]}
                if st.get("failed") is not None:
                    return {"total": len(st["items"])}
            else:
                if i in st["items"] or (st["done"] is not None and i < st["done"]):
                    return {"oid": self._dyn_item_oid(task_id, i)}
                if st.get("failed") is not None:
                    oid = self._dyn_item_oid(task_id, i)
                    self.memory_store.put_inline(oid, st["failed"])
                    return {"oid": oid}
                if st["done"] is not None:
                    return {"done": True}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"pending": True}
            fut = asyncio.get_running_loop().create_future()
            st["waiters"].append(fut)
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                return {"pending": True}

    # ------------------------------------------------- lineage reconstruction

    def _register_lineage(self, wire: dict, reply: dict) -> None:
        """Remember the producing spec for every plasma-resident return so a
        lost copy can be recomputed (inline returns live in this process and
        die with the owner, at which point all refs die too)."""
        plasma_oids = []
        for oid, ret in zip(wire["return_ids"], reply.get("returns") or []):
            if "plasma" in ret:
                plasma_oids.append(oid)
        if reply.get("dynamic") is not None:
            for i, ret in enumerate(reply["dynamic"]):
                if "plasma" in ret:
                    plasma_oids.append(
                        deterministic_object_id(
                            TaskID.from_hex(wire["task_id"]), i + 1
                        ).hex()
                    )
        if reply.get("dynamic_count") is not None:
            st = self._dyn_streams.get(wire["task_id"])
            if st is not None:
                for i, ret in st["items"].items():
                    if "plasma" in ret:
                        plasma_oids.append(self._dyn_item_oid(wire["task_id"], i))
        if not plasma_oids:
            return
        # Size estimate: the spec's dominant payload is the serialized-args
        # blob; the flat overhead covers ids/resources/etc. The same wire is
        # shared by every return of the task, but charging it per return
        # keeps the accounting release-order independent (each pop subtracts
        # exactly what its insert added).
        nbytes = len(wire.get("args_blob") or b"") + 512
        for oid in plasma_oids:
            prev = self.lineage.pop(oid, None)
            if prev is not None:
                self._lineage_bytes -= prev["nbytes"]
            self._lineage_pruned.discard(oid)
            self.lineage[oid] = {
                "wire": wire,
                # A reconstruction-driven re-run must not refill the attempt
                # budget, or a flaky node makes the cap unreachable.
                "attempts": (
                    prev["attempts"]
                    if prev is not None
                    else config.max_lineage_reconstruction
                ),
                "nbytes": nbytes,
            }
            self._lineage_bytes += nbytes
        # LRU prune to the byte cap; never evict the entry just inserted
        # (a single over-cap spec must still be reconstructable once).
        while (
            self._lineage_bytes > config.lineage_bytes_limit
            and len(self.lineage) > 1
        ):
            old_oid, old = self.lineage.popitem(last=False)
            self._lineage_bytes -= old["nbytes"]
            self._lineage_pruned.add(old_oid)
        _TEL_LINEAGE_BYTES.set(self._lineage_bytes)

    def _drop_lineage(self, oid: str) -> None:
        entry = self.lineage.pop(oid, None)
        if entry is not None:
            self._lineage_bytes -= entry["nbytes"]
            _TEL_LINEAGE_BYTES.set(self._lineage_bytes)

    async def recover_object(self, oid: str, depth: int = 0) -> None:
        """Re-execute the producing task of a lost object (owner side).

        Deduplicates concurrent recoveries per producing task (one re-execution
        regenerates every return of that task). Lost owned *arguments* are
        recovered first (recursively, ``depth``-capped by
        config.reconstruction_max_depth) so the re-run's worker never fetches
        against a dead address; anything else resolves lazily because the
        re-executed task's worker pulls its args through this same get path
        (recursing borrower->owner).
        Reference: src/ray/core_worker/object_recovery_manager.h:41.
        """
        if depth > config.reconstruction_max_depth:
            _TEL_RECON_FAILED.inc()
            raise ObjectReconstructionFailedError(
                f"object {oid[:12]} lost; reconstruction recursion exceeded "
                f"reconstruction_max_depth={config.reconstruction_max_depth}"
            )
        entry = self.lineage.get(oid)
        if entry is None:
            if oid in self._lineage_pruned:
                _TEL_RECON_PRUNED.inc()
                raise ObjectReconstructionFailedError(
                    f"object {oid[:12]} lost and its producing task was "
                    f"pruned under lineage_bytes_limit="
                    f"{config.lineage_bytes_limit}; raise the limit or "
                    "persist the value outside the object store"
                )
            _TEL_RECON_FAILED.inc()
            raise ObjectReconstructionFailedError(
                f"object {oid[:12]} lost and has no lineage "
                "(ray.put objects and non-retriable actor-task returns are "
                "not reconstructable)"
            )
        # Being the subject of a recovery is an access: keep hot lineage out
        # of the prune window.
        self.lineage.move_to_end(oid)
        task_id = entry["wire"]["task_id"]
        fut = self._recovering.get(task_id)
        if fut is not None:
            # The owning recovery driver resolves this future on every path
            # (success, re-execution failure, attempts exhausted — see the
            # finally below); the get() caller owns the overall budget.
            await fut  # rpc-flow: disable=unbounded-await
            return
        if entry["attempts"] <= 0:
            _TEL_RECON_FAILED.inc()
            raise ObjectReconstructionFailedError(
                f"object {oid[:12]} lost; lineage reconstruction attempts exhausted"
            )
        entry["attempts"] -= 1
        fut = asyncio.get_running_loop().create_future()
        self._recovering[task_id] = fut
        wire = dict(entry["wire"])
        wire.pop("_attempt", None)
        logger.info(
            "reconstructing object %s by re-running task %r (depth %d)",
            oid[:12],
            wire["name"],
            depth,
        )
        self.record_task_event(wire["task_id"], wire["name"], "RECONSTRUCTING")
        t0 = time.monotonic()
        ws = time.time()
        # Re-install the submission bookkeeping that _run_task's finally
        # clause tears down.
        self._inflight_tasks[wire["task_id"]] = {"cancelled": False, "conn": None}
        for rid in wire["return_ids"]:
            self._oid_to_task[rid] = wire["task_id"]
        for dep_oid, _ in wire["dependencies"]:
            self.reference_table.add_submitted(dep_oid)
        try:
            await self._recover_lost_deps(wire, depth)
            if wire.get("actor_id"):
                # Actor-task return: resubmit through the (restarted) actor
                # (reference: task_manager.cc actor-task resubmission).
                await self._run_actor_task(wire)
            else:
                await self._run_task(wire)
            fut.set_result(None)
            _TEL_RECON_OK.inc()
            from ray_tpu_torch.util import tracing

            tracing.record_span(
                "object.reconstruct",
                "object",
                ws,
                time.monotonic() - t0,
                oid=oid[:16],
                task=wire["name"],
                depth=depth,
            )
        except BaseException as e:
            # Typed reconstruction failures already counted their outcome at
            # the raise site (ok/pruned/failed are mutually exclusive).
            if not isinstance(e, ObjectReconstructionFailedError):
                _TEL_RECON_FAILED.inc()
            fut.set_exception(e)
            # Consume it if nobody else awaits the future.
            fut.exception()
            raise
        finally:
            self._recovering.pop(task_id, None)

    async def _recover_lost_deps(self, wire: dict, depth: int) -> None:
        """Probe the task's owned, task-produced plasma arguments and
        reconstruct any whose copy is gone (holder dead or store emptied)
        before re-running the producer. A spilled copy counts as present —
        the holder's ObjContains includes its spill table, and restore runs
        on the worker's arg fetch."""
        for dep_oid, _owner in wire.get("dependencies") or []:
            entry = self.memory_store.get(dep_oid)
            if entry is None or entry.kind != IN_PLASMA:
                continue
            if (
                dep_oid not in self.lineage
                and dep_oid not in self._lineage_pruned
            ):
                continue  # not task-produced: the pull/restore path owns it
            try:
                if tuple(entry.plasma_addr) == self.raylet_addr:
                    alive = (await self.plasma.contains([dep_oid])).get(dep_oid)
                else:
                    conn = await self.connect_to(tuple(entry.plasma_addr))
                    reply = await conn.call(
                        "ObjContains",
                        {"oids": [dep_oid]},
                        timeout=config.rpc_object_get_timeout_s,
                    )
                    alive = reply["contains"].get(dep_oid)
            except (rpc.RpcError, asyncio.TimeoutError, OSError):
                alive = False  # unreachable holder == lost copy
            if not alive:
                await self.recover_object(dep_oid, depth + 1)

    # -------------------------------------------- node-death object recovery

    async def _watch_node_deaths(self) -> None:
        try:
            await self.gcs.subscribe("nodes", self._on_node_event)
        except (rpc.RpcError, asyncio.TimeoutError, OSError) as e:
            # Standalone/degraded boots have no pubsub; loss then surfaces
            # lazily on the next get of an affected object.
            logger.debug("node-death watch unavailable: %s", e)

    def _on_node_event(self, msg) -> None:
        if self.closed or not isinstance(msg, dict) or msg.get("event") != "removed":
            return  # a closed worker rebuilds nothing: its cluster may be stopping
        addr = msg.get("lost_object_addr") or (msg.get("node") or {}).get("addr")
        if not addr:
            return
        dead = tuple(addr)
        if dead == self.raylet_addr:
            return  # our own raylet died; the session is going down with it
        for oid in self.memory_store.plasma_oids_at(dead):
            rpc.spawn(self._recover_lost_primary(oid))

    async def _recover_lost_primary(self, oid: str) -> None:
        try:
            await self.recover_object(oid)
        except ObjectLostError as e:
            # Unreconstructable (no lineage / pruned / exhausted): leave the
            # stale marker in place so the consumer's get raises the same
            # typed error instead of hanging on a missing entry.
            logger.warning("object %s lost to node death: %s", oid[:12], e)
        except (rpc.RpcError, asyncio.TimeoutError, OSError) as e:
            logger.warning(
                "eager reconstruction of %s failed (%s); will retry on get",
                oid[:12],
                e,
            )

    async def _handle_ping(self, conn, p):
        return {"pong": True, "worker_id": self.worker_id}

    # ------------------------------------------------------------- wait

    async def wait(
        self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float]
    ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        ready_flags: Dict[int, bool] = {}

        async def probe(i, ref):
            try:
                await self._wait_available(ref, None)
                ready_flags[i] = True
            except asyncio.CancelledError:
                pass

        tasks = [rpc.spawn(probe(i, r)) for i, r in enumerate(refs)]
        deadline = time.monotonic() + timeout if timeout is not None else None
        try:
            while len(ready_flags) < num_returns:
                pending = [t for t in tasks if not t.done()]
                if not pending:
                    break
                rem = None if deadline is None else max(0.0, deadline - time.monotonic())
                done, _ = await asyncio.wait(
                    pending, timeout=rem, return_when=asyncio.FIRST_COMPLETED
                )
                if not done:
                    break  # timeout
        finally:
            for t in tasks:
                t.cancel()
        ready = [r for i, r in enumerate(refs) if ready_flags.get(i)]
        not_ready = [r for i, r in enumerate(refs) if not ready_flags.get(i)]
        return ready, not_ready

    async def _wait_available(self, ref: ObjectRef, timeout) -> None:
        oid = ref.hex()
        entry = self.memory_store.get(oid)
        if entry is not None:
            return
        owned = oid in self.reference_table.entries and self.reference_table.entries[oid].owned
        if owned:
            entry = await self.memory_store.wait_for(oid, timeout)
            if entry is None:
                raise GetTimeoutError(oid)
            return
        contains = await self.plasma.contains([oid])
        if contains.get(oid):
            return
        if ref.owner_addr is None or tuple(ref.owner_addr) == self.addr:
            entry = await self.memory_store.wait_for(oid, timeout)
            if entry is None:
                raise GetTimeoutError(oid)
            return
        conn = await self.connect_to(ref.owner_addr)
        await conn.call("WaitObject", {"oid": oid, "timeout": timeout}, timeout=None)

    # ----------------------------------------------------- function export

    async def export_function(self, pickled_fn: bytes) -> str:
        func_id = function_id_of(pickled_fn)
        if func_id not in self._func_ids_exported:
            await self.gcs.kv_put(func_id, pickled_fn, ns="fn", overwrite=False)
            self._func_ids_exported.add(func_id)
        return func_id

    # ------------------------------------------------------- task submission

    def _prepare_args(self, args: tuple, kwargs: dict):
        """Serialize the call arguments; returns (blob_info, deps).

        Top-level ObjectRef args are replaced by positional markers resolved
        by the executor to values (reference semantics); nested refs pass
        through as refs. A large blob moves via the shm store.
        """
        if not args and not kwargs:
            # No-arg calls are the most common task shape; one cached blob
            # serves them all (serialize + ref-scan are ~20us per call).
            global _EMPTY_ARGS
            if _EMPTY_ARGS is None:
                _EMPTY_ARGS = serialization.serialize(([], {}))
            return _EMPTY_ARGS, [], [], []
        ref_positions = []
        plain_args = list(args)
        for i, a in enumerate(plain_args):
            if isinstance(a, ObjectRef):
                ref_positions.append(i)
        kw_ref_keys = [k for k, v in kwargs.items() if isinstance(v, ObjectRef)]
        serialized = serialization.serialize((plain_args, kwargs))
        deps = []
        for r in serialized.contained_refs:
            deps.append((r.hex(), list(r.owner_addr) if r.owner_addr else None))
        return serialized, ref_positions, kw_ref_keys, deps

    async def submit_task(
        self,
        pickled_fn: bytes,
        fn_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: Optional[int] = None,
        retry_exceptions: bool = False,
        pg_id: Optional[str] = None,
        bundle_index: int = -1,
        scheduling_strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ) -> List[ObjectRef]:
        if runtime_env:
            from ray_tpu_torch.runtime_env.context import prepare

            runtime_env = await prepare(self, runtime_env)
        if num_returns == "dynamic":
            num_returns = -1
        func_id = await self.export_function(pickled_fn)
        task_id = fast_unique_hex()
        return_ids = return_object_ids(task_id, 1 if num_returns == -1 else num_returns)
        serialized, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        args_blob, args_object = None, None
        if serialized.total_size <= config.max_direct_call_object_size:
            args_blob = serialized.to_bytes()
        else:
            args_object = ObjectID.from_random().hex()
            await self.plasma.put_serialized(args_object, serialized)
            self.memory_store.put_plasma_marker(args_object, self.raylet_addr)
            self.reference_table.mark_owned(args_object)
            self.reference_table.add_local(args_object)

        res = ResourceSet(resources if resources is not None else {"CPU": 1.0})
        wire = self._task_wire(
            task_id=task_id,
            name=fn_name,
            func_id=func_id,
            args_blob=args_blob,
            args_object=args_object,
            ref_positions=ref_pos,
            kw_ref_keys=kw_refs,
            dependencies=deps,
            num_returns=num_returns,
            return_ids=return_ids,
            resources=res.to_units(),
            max_retries=(
                max_retries if max_retries is not None else config.default_max_task_retries
            ),
            retry_exceptions=retry_exceptions,
            pg_id=pg_id,
            bundle_index=bundle_index,
            scheduling_strategy=scheduling_strategy,
            runtime_env=runtime_env,
        )
        return self._launch_task(wire)

    def _task_wire(self, *, task_id, name, func_id, args_blob, args_object,
                   ref_positions, kw_ref_keys, dependencies, num_returns,
                   return_ids, resources, max_retries=0, retry_exceptions=False,
                   pg_id=None, bundle_index=-1, scheduling_strategy=None,
                   runtime_env=None) -> dict:
        """Build a task wire dict directly (hot-path form of TaskSpec.to_wire;
        same keys, no dataclass round-trip).

        SPARSE encoding: fields at their TaskSpec defaults are omitted — all
        consumers read optional fields with .get() and TaskSpec.from_wire
        fills dataclass defaults, so the ~12 always-default actor/placement
        fields never pay msgpack pack+wire+unpack on the normal-task path
        (a few us per task at 10k tasks/s)."""
        wire = {
            "task_id": task_id,
            "job_id": self.job_id,
            "name": name,
            "func_id": func_id,
            "args_blob": args_blob,
            "dependencies": dependencies,
            "num_returns": num_returns,
            "return_ids": return_ids,
            "resources": resources,
            "max_retries": max_retries,
            "owner_addr": list(self.addr),
            "caller_id": self.worker_id,
        }
        if config.task_trace_spans or config.trace_sample_rate > 0:
            from ray_tpu_torch.util import tracing

            ctx = tracing.make_submit_ctx(self, task_id, name)
            if ctx is not None:
                wire["trace_ctx"] = ctx
        if args_object is not None:
            wire["args_object"] = args_object
        if ref_positions:
            wire["ref_positions"] = ref_positions
        if kw_ref_keys:
            wire["kw_ref_keys"] = kw_ref_keys
        if retry_exceptions:
            wire["retry_exceptions"] = retry_exceptions
        if pg_id is not None:
            wire["pg_id"] = pg_id
            wire["bundle_index"] = bundle_index
        if scheduling_strategy is not None:
            wire["scheduling_strategy"] = scheduling_strategy
        if runtime_env is not None:
            wire["runtime_env"] = runtime_env
        return wire

    def _launch_task(self, wire: dict) -> List[ObjectRef]:
        """Register bookkeeping for a built task wire and launch it.
        Loop thread only."""
        refs = self._register_task_bookkeeping(wire)
        if wire["dependencies"]:
            rpc.spawn(self._run_task(wire))
        else:
            self.lease_pool.submit_task_fast(wire)
        return refs

    def _register_task_bookkeeping(self, wire: dict) -> List[ObjectRef]:
        return_ids = wire["return_ids"]
        self.reference_table.register_task(
            return_ids, [d for d, _ in wire["dependencies"]]
        )
        refs = [ObjectRef(oid, self.addr, self) for oid in return_ids]
        # The lease's resources ride the first event, so the state API
        # shows what each task asked for (a GPU task's "GPU").
        self.record_task_event(wire["task_id"], wire["name"], "PENDING",
                               resources=wire["resources"])
        self._inflight_tasks[wire["task_id"]] = {"cancelled": False, "conn": None}
        oid_to_task = self._oid_to_task
        for oid in wire["return_ids"]:
            oid_to_task[oid] = wire["task_id"]
        return refs

    def try_submit_task_fast(
        self,
        pickled_fn: bytes,
        fn_name: str,
        args: tuple,
        kwargs: dict,
        *,
        loop,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: Optional[int] = None,
        retry_exceptions: bool = False,
        pg_id: Optional[str] = None,
        bundle_index: int = -1,
        scheduling_strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
        resources_units: Optional[Dict[str, int]] = None,
        no_fastpath: bool = False,
    ) -> Optional[List[ObjectRef]]:
        """Synchronous submission fast path, callable from any thread.

        The hot-path cost of .remote() is not the work but the thread
        round-trip into the event loop (run_coroutine_threadsafe + wait).
        Everything except launching the network I/O is thread-safe to do
        here: serialization uses thread-local context, id generation is
        random, the reference table takes a lock, and the remaining
        bookkeeping is GIL-atomic appends/inserts. Only the launch is posted
        (fire-and-forget) onto the loop. Returns None when this call needs
        the async slow path (runtime_env prep, first-time function export,
        or plasma-resident args).
        """
        if runtime_env:
            return None
        func_id = function_id_of(pickled_fn)
        if func_id not in self._func_ids_exported:
            return None  # first call pays the async export
        if num_returns == "dynamic":
            num_returns = -1
        serialized, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        if serialized.total_size > config.max_direct_call_object_size:
            return None  # large args need an async plasma write
        task_id = fast_unique_hex()
        return_ids = return_object_ids(task_id, 1 if num_returns == -1 else num_returns)
        if resources_units is None:
            res = ResourceSet(resources if resources is not None else {"CPU": 1.0})
            resources_units = res.to_units()
        wire = self._task_wire(
            task_id=task_id,
            name=fn_name,
            func_id=func_id,
            args_blob=serialized.to_bytes(),
            args_object=None,
            ref_positions=ref_pos,
            kw_ref_keys=kw_refs,
            dependencies=deps,
            num_returns=num_returns,
            return_ids=return_ids,
            resources=resources_units,
            max_retries=(
                max_retries
                if max_retries is not None
                else config.default_max_task_retries
            ),
            retry_exceptions=retry_exceptions,
            pg_id=pg_id,
            bundle_index=bundle_index,
            scheduling_strategy=scheduling_strategy,
            runtime_env=None,
        )
        if no_fastpath:
            wire["_no_fastpath"] = True
        refs = self._register_task_bookkeeping(wire)
        self._enqueue_submit(("task", wire), loop)
        return refs

    # -- cross-thread submission funnel -------------------------------------

    def _enqueue_submit(self, item, loop) -> None:
        self._submit_buf.append(item)
        if not self._submit_wake:
            self._submit_wake = True
            loop.call_soon_threadsafe(self._drain_submit_buf)

    def _drain_submit_buf(self) -> None:
        self._submit_wake = False
        buf = self._submit_buf
        while buf:
            kind, wire = buf.popleft()
            try:
                if kind == "task":
                    if wire["dependencies"]:
                        rpc.spawn(self._run_task(wire))
                    else:
                        self.lease_pool.submit_task_fast(wire)
                else:
                    self._actor_submit_fast(wire)
            except Exception as e:
                logger.exception("fast submission of %s failed", wire.get("name"))
                self._finish_task_error(wire, e)

    async def cancel(self, ref: "ObjectRef", force: bool = False) -> bool:
        """Best-effort task cancellation (reference: ray.cancel ->
        CoreWorker::CancelTask). Queued tasks are dropped; running tasks get
        a TaskCancelledError raised in their executing thread/coroutine."""
        task_id = self._oid_to_task.get(ref.hex())
        if task_id is None:
            return False
        entry = self._inflight_tasks.get(task_id)
        if entry is None:
            return False  # already finished
        entry["cancelled"] = True
        conn = entry.get("conn")
        if conn is not None and not conn.closed:
            try:
                await conn.call(
                    "CancelTask",
                    {"task_id": task_id, "force": force},
                    timeout=config.rpc_control_timeout_s,
                )
            except rpc.RpcError:
                pass
        return True

    async def _run_task(self, wire: dict) -> None:
        task_id, name = wire["task_id"], wire["name"]
        try:
            await self._wait_for_deps(wire["dependencies"])
            attempts = wire.get("max_retries", 0) + 1
            last_err: Optional[Exception] = None
            for attempt in range(attempts):
                entry = self._inflight_tasks.get(task_id)
                if entry is not None and entry["cancelled"]:
                    self._store_task_error(
                        wire, TaskCancelledError(f"task {name} was cancelled")
                    )
                    self.record_task_event(task_id, name, "CANCELLED")
                    return
                try:
                    reply = await self._lease_and_push(wire)
                    self._store_task_results(wire, reply)
                    if reply.get("error") is None and wire.get("actor_id") is None:
                        self._register_lineage(wire, reply)
                    self.record_task_event(task_id, name, "FINISHED")
                    return
                except (rpc.ConnectionLost, WorkerCrashedError) as e:
                    last_err = e
                    entry = self._inflight_tasks.get(task_id)
                    if entry is not None and entry["cancelled"]:
                        self._store_task_error(
                            wire,
                            TaskCancelledError(f"task {name} was cancelled"),
                        )
                        return
                    self.record_task_event(task_id, name, "RETRY", attempt=attempt)
                    logger.warning(
                        "task %s attempt %d failed (%s); retrying", name, attempt, e
                    )
                    await asyncio.sleep(min(1.0, 0.1 * (attempt + 1)))
            self._store_task_error(
                wire, WorkerCrashedError(f"task {name} failed after retries: {last_err}")
            )
        except Exception as e:
            logger.exception("task %s submission failed", name)
            self._store_task_error(wire, e)
        finally:
            self._cleanup_task(wire)

    def _cleanup_task(self, wire: dict) -> None:
        self._inflight_tasks.pop(wire["task_id"], None)
        for oid in wire["return_ids"]:
            self._oid_to_task.pop(oid, None)
        for dep_oid, _ in wire["dependencies"]:
            self.reference_table.remove_submitted(dep_oid, self)

    def _finish_task_error(self, wire: dict, exc: Exception) -> None:
        """Terminal failure on the callback path: store the error and tear
        down submission bookkeeping."""
        try:
            self._store_task_error(wire, exc)
        finally:
            self._cleanup_task(wire)

    async def _wait_for_deps(self, deps) -> None:
        waits = []
        for oid, owner in deps:
            ref = ObjectRef(oid, tuple(owner) if owner else None, self)
            waits.append(self._wait_available(ref, 300))
        if waits:
            await asyncio.gather(*waits)

    def _arg_locality(self, wire: dict) -> Optional[Dict[str, float]]:
        """Locations of the task's plasma-resident args as addr-keyed
        weights ("host:port" -> object count). Deps are resolved by the time
        this runs, so the memory store knows each primary copy's raylet
        (put_plasma_marker); entries carry no sizes, so weights count
        objects, not bytes."""
        deps = wire.get("dependencies")
        if not deps:
            return None
        from ray_tpu_torch._private.object_store import IN_PLASMA

        hints: Dict[str, float] = {}
        for oid, _owner in deps:
            entry = self.memory_store.get(oid)
            if (
                entry is not None
                and entry.kind == IN_PLASMA
                and entry.plasma_addr
            ):
                addr_key = f"{entry.plasma_addr[0]}:{entry.plasma_addr[1]}"
                hints[addr_key] = hints.get(addr_key, 0.0) + 1.0
        return hints or None

    async def _lease_and_push(self, wire: dict) -> dict:
        resources = wire.get("resources") or {}
        pg_id, bundle_index = wire.get("pg_id"), wire.get("bundle_index", -1)
        strategy = wire.get("scheduling_strategy")
        lease = await self.lease_pool.acquire(
            resources, pg_id, bundle_index, strategy,
            locality=self._arg_locality(wire),
        )
        dirty = False
        entry = None
        try:
            entry = self._inflight_tasks.get(wire["task_id"])
            if entry is not None:
                if entry["cancelled"]:
                    # Cancellation landed while we were queued for a lease.
                    raise TaskCancelledError(f"task {wire['name']} was cancelled")
                entry["conn"] = lease.conn
            self.record_task_event(wire["task_id"], wire["name"], "RUNNING")
            return await lease.conn.call("PushTask", {"spec": wire}, timeout=None)
        except rpc.ConnectionLost:
            dirty = True
            raise
        finally:
            if entry is not None:
                entry["conn"] = None
            await self.lease_pool.release(
                lease, resources, pg_id, bundle_index, dirty=dirty, strategy=strategy
            )

    def _store_task_results(self, wire: dict, reply: dict) -> None:
        if reply.get("error") is not None:
            payload = reply["error"]
            streaming = wire.get("num_returns") == -1
            for oid in wire["return_ids"]:
                # A stream already published keeps its generator: the items it
                # produced stay readable, the rest resolve to the error.
                if not (streaming and self._oid_to_dyn.get(oid) == wire["task_id"]):
                    self.memory_store.put_inline(oid, payload)
            if streaming:
                self._dyn_fail(wire["task_id"], payload)
            self.record_task_event(wire["task_id"], wire["name"], "FAILED")
            return
        if reply.get("dynamic_count") is not None:
            # Streaming-generator task finished: items were stored as they
            # arrived (GeneratorItem pushes); record the final count and
            # publish the total-aware generator value.
            n = reply["dynamic_count"]
            task_id = wire["task_id"]
            st = self._dyn_stream(task_id)
            st["done"] = n
            for i in range(n):
                self.reference_table.mark_owned(self._dyn_item_oid(task_id, i))
            self._dyn_publish(task_id, total=n)
            self._dyn_wake(st)
            return
        if reply.get("dynamic") is not None:
            # Legacy fully-materialized generator reply: store each yielded
            # item under its deterministic id and make the main return value
            # an ObjectRefGenerator over them.
            refs = []
            for i, ret in enumerate(reply["dynamic"]):
                oid = deterministic_object_id(
                    TaskID.from_hex(wire["task_id"]), i + 1
                ).hex()
                if "inline" in ret:
                    self.memory_store.put_inline(oid, ret["inline"])
                else:
                    self.memory_store.put_plasma_marker(oid, tuple(ret["plasma"]))
                self.reference_table.mark_owned(oid)
                refs.append(ObjectRef(oid, self.addr, self))
            gen = ObjectRefGenerator(refs)
            self.memory_store.put_inline(
                wire["return_ids"][0], serialization.serialize(gen).to_bytes()
            )
            return
        returns = reply["returns"]
        put_inline = self.memory_store.put_inline
        for oid, ret in zip(wire["return_ids"], returns):
            payload = ret.get("inline")
            if payload is not None:
                put_inline(oid, payload)
            else:
                self.memory_store.put_plasma_marker(oid, tuple(ret["plasma"]))

    def _store_task_error(self, wire: dict, exc: Exception) -> None:
        serialized = serialization.serialize(exc)
        payload = serialized.to_bytes()
        for oid in wire["return_ids"]:
            self.memory_store.put_inline(oid, payload)
        if wire.get("num_returns") == -1:
            self._dyn_fail(wire["task_id"], payload)
        self.record_task_event(wire["task_id"], wire["name"], "FAILED")

    # ----------------------------------------------------------- actors

    async def create_actor(
        self,
        pickled_cls: bytes,
        cls_name: str,
        args: tuple,
        kwargs: dict,
        *,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        max_task_retries: int = 0,
        concurrency_groups: Optional[Dict[str, int]] = None,
        name: Optional[str] = None,
        namespace: Optional[str] = None,
        lifetime: Optional[str] = None,
        get_if_exists: bool = False,
        pg_id: Optional[str] = None,
        bundle_index: int = -1,
        scheduling_strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
        prepared_args: Optional[tuple] = None,
    ) -> str:
        if runtime_env:
            from ray_tpu_torch.runtime_env.context import prepare

            runtime_env = await prepare(self, runtime_env)
        func_id = await self.export_function(pickled_cls)
        actor_id = ActorID.from_random().hex()
        task_id = TaskID.from_random().hex()
        strategy = dict(scheduling_strategy or {})
        if lifetime == "detached":
            strategy["detached"] = True
        res = ResourceSet(resources if resources is not None else {"CPU": 1.0})
        args_blob, args_object = None, None
        if prepared_args is not None:
            # Pre-serialized args (client proxy path: the proxy cannot
            # deserialize user values, so payloads pass through opaque).
            payload, ref_pos, kw_refs, deps = prepared_args
            if payload is None or len(payload) <= config.max_direct_call_object_size:
                args_blob = payload
            else:
                args_object = ObjectID.from_random().hex()
                await self.plasma.put_bytes(args_object, payload)
                self.memory_store.put_plasma_marker(args_object, self.raylet_addr)
        else:
            serialized, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
            if serialized.total_size <= config.max_direct_call_object_size:
                args_blob = serialized.to_bytes()
            else:
                args_object = ObjectID.from_random().hex()
                await self.plasma.put_serialized(args_object, serialized)
                self.memory_store.put_plasma_marker(args_object, self.raylet_addr)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            name=cls_name,
            func_id=func_id,
            args_blob=args_blob,
            args_object=args_object,
            ref_positions=ref_pos,
            kw_ref_keys=kw_refs,
            dependencies=deps,
            num_returns=0,
            return_ids=[],
            resources=res.to_units(),
            owner_addr=list(self.addr),
            actor_id=actor_id,
            actor_creation=True,
            max_restarts=max_restarts,
            max_concurrency=max_concurrency,
            max_task_retries=max_task_retries,
            concurrency_groups=concurrency_groups,
            pg_id=pg_id,
            bundle_index=bundle_index,
            scheduling_strategy=strategy,
            runtime_env=runtime_env,
            actor_name=name,
            namespace=namespace,
        )
        wire = spec.to_wire()
        reply = await self.gcs.call(
            "CreateActor",
            {"spec": wire, "wait_alive": False, "get_if_exists": get_if_exists},
            timeout=None,
        )
        if reply.get("existing"):
            return reply["actor"]["actor_id"]
        return actor_id

    def _submitter(self, actor_id: str) -> ActorSubmitter:
        sub = self.actor_submitters.get(actor_id)
        if sub is None:
            sub = self.actor_submitters[actor_id] = ActorSubmitter(self, actor_id)
        return sub

    def _actor_wire(
        self, actor_id, method_name, args_blob, args_object,
        ref_pos, kw_refs, deps, num_returns, return_ids, task_id,
        max_task_retries=0, concurrency_group=None,
    ) -> dict:
        wire = {
            "task_id": task_id,
            "job_id": self.job_id,
            "name": method_name,
            "func_id": "",
            "args_blob": args_blob,
            "args_object": args_object,
            "ref_positions": ref_pos,
            "kw_ref_keys": kw_refs,
            "dependencies": deps,
            "num_returns": num_returns,
            "return_ids": return_ids,
            "resources": {},
            "max_retries": max_task_retries,
            "retry_exceptions": False,
            "owner_addr": list(self.addr),
            "actor_id": actor_id,
            "actor_creation": False,
            "actor_method": method_name,
            "seq_no": -1,
            "caller_id": self.worker_id,
            "pg_id": None,
            "bundle_index": -1,
            "scheduling_strategy": None,
            "runtime_env": None,
            "concurrency_group": concurrency_group,
        }
        if config.task_trace_spans or config.trace_sample_rate > 0:
            from ray_tpu_torch.util import tracing

            ctx = tracing.make_submit_ctx(self, task_id, method_name)
            if ctx is not None:
                wire["trace_ctx"] = ctx
        return wire

    async def submit_actor_task(
        self,
        actor_id: str,
        method_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        max_task_retries: int = 0,
        concurrency_group: Optional[str] = None,
        prepared_args: Optional[tuple] = None,
    ) -> List[ObjectRef]:
        if num_returns == "dynamic":
            num_returns = -1
        task_id = fast_unique_hex()
        # Dynamic (streaming-generator) calls have ONE return object whose
        # value is the ObjectRefGenerator (same convention as submit_task).
        return_ids = return_object_ids(
            task_id, 1 if num_returns == -1 else num_returns
        )
        args_blob, args_object = None, None
        if prepared_args is not None:
            payload, ref_pos, kw_refs, deps = prepared_args
            if payload is None or len(payload) <= config.max_direct_call_object_size:
                args_blob = payload
            else:
                args_object = ObjectID.from_random().hex()
                await self.plasma.put_bytes(args_object, payload)
                self.memory_store.put_plasma_marker(args_object, self.raylet_addr)
        else:
            serialized, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
            if serialized.total_size <= config.max_direct_call_object_size:
                args_blob = serialized.to_bytes()
            else:
                args_object = ObjectID.from_random().hex()
                await self.plasma.put_serialized(args_object, serialized)
                self.memory_store.put_plasma_marker(args_object, self.raylet_addr)
        wire = self._actor_wire(
            actor_id, method_name, args_blob, args_object,
            ref_pos, kw_refs, deps, num_returns, return_ids, task_id,
            max_task_retries, concurrency_group,
        )
        refs = []
        for oid in return_ids:
            self.reference_table.mark_owned(oid)
            refs.append(ObjectRef(oid, self.addr, self))
        for dep_oid, _ in deps:
            self.reference_table.add_submitted(dep_oid)
        if not deps and args_object is None:
            self._actor_submit_fast(wire)
        else:
            self._spawn_actor_slow(wire)
        return refs

    def try_submit_actor_task_fast(
        self,
        actor_id: str,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        loop,
        num_returns: int = 1,
        max_task_retries: int = 0,
        concurrency_group: Optional[str] = None,
    ) -> Optional[List[ObjectRef]]:
        """Synchronous actor-call fast path (see try_submit_task_fast)."""
        if num_returns == "dynamic":
            num_returns = -1
        serialized, ref_pos, kw_refs, deps = self._prepare_args(args, kwargs)
        if serialized.total_size > config.max_direct_call_object_size:
            return None
        task_id = fast_unique_hex()
        return_ids = return_object_ids(
            task_id, 1 if num_returns == -1 else num_returns
        )
        wire = self._actor_wire(
            actor_id, method_name, serialized.to_bytes(), None,
            ref_pos, kw_refs, deps, num_returns, return_ids, task_id,
            max_task_retries, concurrency_group,
        )
        refs = []
        mark_owned = self.reference_table.mark_owned
        for oid in return_ids:
            mark_owned(oid)
            refs.append(ObjectRef(oid, self.addr, self))
        for dep_oid, _ in deps:
            self.reference_table.add_submitted(dep_oid)
        self._enqueue_submit(("actor", wire), loop)
        return refs

    def _spawn_actor_slow(self, wire: dict) -> None:
        """Slow-path actor submission via coroutine (first call, restarts,
        dependencies, large args). Bumps pending_slow synchronously so fast
        submissions queued after this one cannot overtake it."""
        sub = self._submitter(wire["actor_id"])
        sub.pending_slow += 1
        rpc.spawn(self._run_actor_task(wire, sub))

    def _actor_submit_fast(self, wire: dict) -> None:
        """Callback-based actor submission (loop thread). Sends the PushActorTask
        frame directly when the submitter is in steady state; otherwise falls
        back to the coroutine path (reference: direct_actor_task_submitter's
        send-or-queue split)."""
        if wire["dependencies"]:
            self._spawn_actor_slow(wire)
            return
        sub = self._submitter(wire["actor_id"])
        conn = sub.conn
        if (
            conn is None
            or conn.closed
            or sub.pending_slow > 0
            or sub._lock.locked()
            or sub.state != "ALIVE"
        ):
            self._spawn_actor_slow(wire)
            return
        wire["seq_no"] = sub.seq
        sub.seq += 1
        try:
            # Fold the ambient deadline like Connection.call does: an actor
            # call made while serving (or routing) a deadlined request rides
            # the fast path with the same TTL stamp, so the replica-side
            # server can shed/cancel it (serve admission control relies on
            # this for the no-admitted-request-overruns guarantee).
            fut = conn.call_nowait(
                "PushActorTask",
                {"spec": wire},
                deadline=rpc.current_deadline(),
            )
        except rpc.ConnectionLost:
            sub.conn = None
            if wire.get("max_retries", 0) > wire.get("_attempt", 0):
                wire["_attempt"] = wire.get("_attempt", 0) + 1
                self._spawn_actor_slow(wire)
                return
            self._finish_task_error(
                wire,
                ActorUnavailableError(
                    f"actor {wire['actor_id'][:8]} died while task "
                    f"{wire['name']!r} was in flight"
                ),
            )
            return
        fut.add_done_callback(
            lambda f, w=wire, s=sub: self._on_actor_reply(w, s, f)
        )

    def _on_actor_reply(self, wire: dict, sub: ActorSubmitter, fut) -> None:
        exc = fut.exception() if not fut.cancelled() else rpc.ConnectionLost("cancelled")
        if exc is None:
            reply = fut.result()
            self._store_task_results(wire, reply)
            if reply.get("error") is None and wire.get("max_retries", 0) > 0:
                # Actor-task lineage: retriable methods register their
                # plasma-resident returns for reconstruction through the
                # (possibly restarted) actor (reference: task_manager.cc
                # resubmit of actor tasks with max_task_retries > 0).
                self._register_lineage(wire, reply)
            self._cleanup_task(wire)
            return
        if isinstance(exc, rpc.ConnectionLost):
            sub.conn = None
            if wire.get("max_retries", 0) > wire.get("_attempt", 0):
                # Resubmit through the slow path: it re-resolves the actor
                # (waiting out a restart) before pushing again.
                wire["_attempt"] = wire.get("_attempt", 0) + 1
                self.record_task_event(
                    wire["task_id"], wire["name"], "RETRY",
                    attempt=wire["_attempt"],
                )
                self._spawn_actor_slow(wire)
                return
            self._store_task_error(
                wire,
                ActorUnavailableError(
                    f"actor {wire['actor_id'][:8]} died while task "
                    f"{wire['name']!r} was in flight"
                ),
            )
        else:
            self._store_task_error(wire, exc)
        self._cleanup_task(wire)

    async def _run_actor_task(self, wire: dict, sub: Optional[ActorSubmitter] = None) -> None:
        if sub is None:
            sub = self._submitter(wire["actor_id"])
            sub.pending_slow += 1
        try:
            try:
                await self._wait_for_deps(wire["dependencies"])
                attempts = wire.get("max_retries", 0) + 1
                attempt = wire.get("_attempt", 0)
                while True:
                    try:
                        reply = await sub.submit(wire)
                        break
                    except (ActorUnavailableError, rpc.ConnectionLost) as e:
                        attempt += 1
                        wire["_attempt"] = attempt
                        if attempt >= attempts:
                            raise
                        self.record_task_event(
                            wire["task_id"], wire["name"], "RETRY", attempt=attempt
                        )
                        await asyncio.sleep(min(1.0, 0.2 * attempt))
            finally:
                sub.pending_slow -= 1
            self._store_task_results(wire, reply)
            if reply.get("error") is None and wire.get("max_retries", 0) > 0:
                self._register_lineage(wire, reply)
        except Exception as e:
            if isinstance(e, rpc.ConnectionLost):
                # Callers' retry loops catch RayTpuError (the documented
                # pattern); a raw transport error must not leak past them
                # when the real meaning is "the actor's process went away".
                e = ActorUnavailableError(
                    f"actor {wire['actor_id'][:8]} unreachable for task "
                    f"{wire['name']!r}: {e}"
                )
            self._store_task_error(wire, e)
        finally:
            self._cleanup_task(wire)

    async def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        await self.gcs.call("KillActor", {"actor_id": actor_id, "no_restart": no_restart})

    # ---------------------------------------------------------- shutdown

    async def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for t in self._bg_tasks:
            t.cancel()
        await self._flush_task_events()
        # Flush-on-exit for runtime spans, mirroring the task-event flush:
        # a short-lived worker's spans must not die in its local buffer.
        from ray_tpu_torch.util import tracing

        if tracing.enabled():
            try:
                await tracing.flush_spans_once(
                    self.gcs.call, self.worker_id, self.node_id
                )
            except Exception:
                pass
        tracing.stop_flusher()  # flusher task dies with this loop
        if self.lease_pool._fp_drainer_installed:
            fp = _fp_mod()
            if fp:
                try:
                    asyncio.get_running_loop().remove_reader(fp.notify_fd())
                except Exception:
                    pass
            self.lease_pool._fp_drainer_installed = False
        await self.lease_pool.drain()
        self.plasma.close()
        for conn in self._conns.values():
            await conn.close()
