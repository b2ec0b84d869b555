"""Request router: pow-2-choices replica scheduling with local in-flight counts.

Analog of python/ray/serve/_private/router.py (Router:312) +
replica_scheduler/pow_2_scheduler.py: the router keeps a live replica set per
deployment (pushed from the controller via long-poll) and assigns each request
to the less-loaded of two randomly sampled replicas, respecting
max_ongoing_requests with backpressure.

Overload story (docs/serving.md): every request carries a deadline (explicit
``timeout_s`` folded with the ambient RPC deadline), and the router is the
admission gate —

- a request whose remaining budget cannot cover the deployment's observed
  service-time estimate (EWMA over completed requests, times a safety
  factor) is shed at the door with a typed DeploymentOverloadedError
  instead of burning a replica slot only to be cut at the wire deadline;
- requests waiting for a replica slot count against a per-deployment queue
  cap (max_queued_requests); overflow sheds immediately, bounding memory
  under open-loop storms;
- admitted requests ride the PR-4 TTL stamps to the replica (the ambient
  deadline is set around the actor call), so the replica-side server sheds
  or cancels them at the deadline and the error reply comes back typed.

The router also pushes per-deployment queue depth + ongoing counts to the
controller at a fixed cadence; that feed drives the queue-EWMA autoscaler.
"""

from __future__ import annotations

import asyncio
import logging
import random
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import rpc, telemetry
from ray_tpu_torch._private.common import (
    ActorDiedError,
    ActorUnavailableError,
    config,
)
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.serve._private.common import (
    DeploymentOverloadedError,
    RunningReplicaInfo,
)
from ray_tpu_torch.serve._private.long_poll import LongPollClient
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_TEL_SHED_QUEUE = telemetry.counter(
    "serve", "shed_queue_full", "requests shed at the door: queue cap reached"
)
_TEL_SHED_DEADLINE = telemetry.counter(
    "serve", "shed_deadline",
    "requests shed at admission: budget below service estimate",
)
_TEL_COMPLETED = telemetry.counter(
    "serve", "requests_completed", "requests completed through the router"
)
_TEL_EVICTED = telemetry.counter(
    "serve", "replicas_evicted", "replicas locally evicted as observed-dead"
)
_TEL_SERVICE_TIME = telemetry.histogram(
    "serve", "service_time_s",
    "end-to-end request service time observed by the router",
    buckets=telemetry.LATENCY_BUCKETS_S,
)


class _ReplicaSet:
    def __init__(self, dep: str = "?"):
        self.replicas: List[RunningReplicaInfo] = []
        self.handles: Dict[str, ActorHandle] = {}
        self.ongoing: Dict[str, int] = {}
        self.nonempty = asyncio.Event()
        self.slot_freed = asyncio.Event()
        # model_id -> replica_id_str sticky routing for @serve.multiplexed.
        self.model_affinity: Dict[str, str] = {}
        # Admission-control state: requests currently waiting for a replica
        # slot, and the EWMA of observed request service time (queue wait at
        # the replica included — that is the latency a new request will see).
        self.queued = 0
        self.ewma_service_s: Optional[float] = None
        # Shed/outcome counters (surfaced via Router.stats() for loadgen,
        # tests, and the chaos serve invariant).
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.deadline_failures = 0
        self.completed = 0
        self.evicted = 0
        self.dep = dep
        # Telemetry twins of the counters above, labeled by deployment
        # (the plain ints stay: loadgen/chaos read them via stats()).
        self._tel_shed_queue = _TEL_SHED_QUEUE.cell(deployment=dep)
        self._tel_shed_deadline = _TEL_SHED_DEADLINE.cell(deployment=dep)
        self._tel_completed = _TEL_COMPLETED.cell(deployment=dep)
        self._tel_evicted = _TEL_EVICTED.cell(deployment=dep)
        self._tel_service_time = _TEL_SERVICE_TIME.cell(deployment=dep)

    def update(self, infos: List[RunningReplicaInfo]) -> None:
        self.replicas = infos
        new_ids = {r.replica_id_str for r in infos}
        for info in infos:
            if info.replica_id_str not in self.handles:
                self.handles[info.replica_id_str] = ActorHandle(info.actor_id)
                self.ongoing.setdefault(info.replica_id_str, 0)
        for rid in list(self.handles):
            if rid not in new_ids:
                del self.handles[rid]
                self.ongoing.pop(rid, None)
        for mid, rid in list(self.model_affinity.items()):
            if rid not in new_ids:
                del self.model_affinity[mid]
        if infos:
            self.nonempty.set()
        else:
            self.nonempty.clear()

    def evict(self, replica_id_str: str) -> None:
        """Drop a replica the data plane just observed dead. The controller's
        health checks lag the death by up to 3 check periods, and until it
        notices, every long-poll push re-lists the corpse — evicting locally
        closes that window so queued requests re-route instead of piling
        typed failures onto a replica that cannot answer."""
        before = len(self.replicas)
        self.replicas = [
            r for r in self.replicas if r.replica_id_str != replica_id_str
        ]
        if len(self.replicas) == before:
            return
        self.evicted += 1
        self._tel_evicted.inc()
        telemetry.record_event(
            "serve", "replica_evict", deployment=self.dep,
            replica=replica_id_str,
        )
        self.handles.pop(replica_id_str, None)
        self.ongoing.pop(replica_id_str, None)
        for mid, rid in list(self.model_affinity.items()):
            if rid == replica_id_str:
                del self.model_affinity[mid]
        if not self.replicas:
            self.nonempty.clear()
        # Wake queued pickers: the dead replica's phantom slots are gone.
        self.slot_freed.set()

    def queue_cap(self) -> int:
        for info in self.replicas:
            if info.max_queued_requests >= 0:
                return info.max_queued_requests
        return config.serve_max_queued_requests

    def observe_service_time(self, seconds: float) -> None:
        self.completed += 1
        self._tel_completed.inc()
        self._tel_service_time.observe(seconds)
        if self.ewma_service_s is None:
            self.ewma_service_s = seconds
        else:
            alpha = config.serve_admission_ewma_alpha
            self.ewma_service_s = (
                alpha * seconds + (1.0 - alpha) * self.ewma_service_s
            )


class Router:
    """One per handle-owning process per deployment-consumer (driver, replica,
    or proxy)."""

    def __init__(self, controller_handle: ActorHandle, core):
        self._controller = controller_handle
        self._core = core
        self._sets: Dict[str, _ReplicaSet] = {}
        self._poll_client: Optional[LongPollClient] = None
        self._watched: Dict[str, bool] = {}
        self._router_id = uuid.uuid4().hex[:8]
        self._metrics_task: Optional[asyncio.Task] = None
        self._stopped = False

    def _replica_set(self, deployment_id_str: str) -> _ReplicaSet:
        rs = self._sets.get(deployment_id_str)
        if rs is None:
            rs = _ReplicaSet(deployment_id_str)
            self._sets[deployment_id_str] = rs
        return rs

    async def _listen(self, keys_to_ids: Dict[str, int]):
        refs = await self._core.submit_actor_task(
            self._controller._actor_id,
            "listen_for_change",
            (keys_to_ids,),
            {},
            num_returns=1,
        )
        return await self._core.get_objects(refs[0], timeout=None)

    def watch(self, deployment_id_str: str) -> None:
        """Subscribe to replica-set updates for a deployment (idempotent).
        Restarts the long-poll client with the union of watched keys."""
        if self._watched.get(deployment_id_str):
            return
        self._watched[deployment_id_str] = True
        if self._poll_client is not None:
            self._poll_client.stop()
        listeners = {}
        for dep in self._watched:
            key = f"replicas::{dep}"

            def make_cb(dep_id=dep):
                def cb(value):
                    infos = [RunningReplicaInfo.from_dict(d) for d in (value or [])]
                    self._replica_set(dep_id).update(infos)

                return cb

            listeners[key] = make_cb()
        self._poll_client = LongPollClient(self._listen, listeners)
        self._poll_client.start()
        if self._metrics_task is None or self._metrics_task.done():
            self._metrics_task = rpc.spawn(self._metrics_loop())

    def shutdown(self) -> None:
        self._stopped = True
        if self._poll_client is not None:
            self._poll_client.stop()
        if self._metrics_task is not None:
            self._metrics_task.cancel()
            self._metrics_task = None

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-deployment router-side counters (loadgen + tests)."""
        return {
            dep: {
                "queued": rs.queued,
                "ongoing": sum(rs.ongoing.values()),
                "shed_queue_full": rs.shed_queue_full,
                "shed_deadline": rs.shed_deadline,
                "deadline_failures": rs.deadline_failures,
                "completed": rs.completed,
                "evicted": rs.evicted,
                "ewma_service_s": rs.ewma_service_s,
            }
            for dep, rs in self._sets.items()
        }

    # -- autoscaler feed -----------------------------------------------------

    async def _metrics_loop(self) -> None:
        """Push queue depth + ongoing counts per deployment to the controller
        (the queue-EWMA autoscaler's input). Best effort: a dead controller
        just drops samples until it returns."""
        interval = config.serve_router_metrics_interval_s
        while not self._stopped:
            await asyncio.sleep(interval)
            snap = {
                dep: {"queued": rs.queued, "ongoing": sum(rs.ongoing.values())}
                for dep, rs in self._sets.items()
            }
            if not snap:
                continue
            try:
                refs = await self._core.submit_actor_task(
                    self._controller._actor_id,
                    "record_router_metrics",
                    (self._router_id, snap),
                    {},
                    num_returns=1,
                )
                await asyncio.wait_for(
                    self._core.get_objects(refs[0], timeout=None),
                    timeout=interval * 4,
                )
            except asyncio.CancelledError:
                return
            except Exception:
                pass

    # -- admission control ---------------------------------------------------

    @staticmethod
    def _request_deadline(loop, timeout_s: Optional[float]) -> Optional[float]:
        """Fold the caller's timeout with the ambient RPC deadline (a handle
        call made inside a deadlined handler never outlives its caller)."""
        local = None if timeout_s is None else loop.time() + timeout_s
        ambient = rpc.current_deadline()
        if ambient is None:
            return local
        if local is None:
            return ambient
        return min(local, ambient)

    def _admit_deadline(
        self, rs: _ReplicaSet, dep: str, deadline: Optional[float], loop
    ) -> None:
        """Shed if the remaining budget cannot cover the service estimate."""
        if deadline is None or rs.ewma_service_s is None:
            return
        remaining = deadline - loop.time()
        need = rs.ewma_service_s * config.serve_admission_safety_factor
        if remaining < need:
            rs.shed_deadline += 1
            rs._tel_shed_deadline.inc()
            telemetry.record_event(
                "serve", "admission_shed", deployment=dep,
                reason="deadline_unreachable",
            )
            raise DeploymentOverloadedError(
                dep,
                "deadline_unreachable",
                f"remaining budget {remaining * 1000:.0f}ms < "
                f"service estimate {need * 1000:.0f}ms",
            )

    # -- scheduling ----------------------------------------------------------

    def _pick_replica(
        self, rs: _ReplicaSet, model_id: Optional[str] = None
    ) -> Optional[RunningReplicaInfo]:
        candidates = [
            r
            for r in rs.replicas
            if rs.ongoing.get(r.replica_id_str, 0) < r.max_ongoing_requests
        ]
        if not candidates:
            return None
        if model_id:
            # Multiplexed-model affinity (reference: multiplexed routing):
            # keep one model's requests on the replica that already loaded
            # it, so per-replica model caches actually hit.
            preferred = rs.model_affinity.get(model_id)
            if preferred is not None:
                for r in candidates:
                    if r.replica_id_str == preferred:
                        return r
                if any(r.replica_id_str == preferred for r in rs.replicas):
                    # Pinned replica is alive but momentarily full: wait for
                    # a slot instead of rebinding (a rebind cold-loads the
                    # model elsewhere and thrashes both replicas' caches).
                    return None
        sampled = random.sample(candidates, min(2, len(candidates)))
        pick = min(sampled, key=lambda r: rs.ongoing.get(r.replica_id_str, 0))
        if model_id:
            rs.model_affinity[model_id] = pick.replica_id_str
            while len(rs.model_affinity) > 256:
                rs.model_affinity.pop(next(iter(rs.model_affinity)))
        return pick

    async def _acquire_replica(
        self,
        deployment_id_str: str,
        request_meta: Dict[str, Any],
        deadline: Optional[float],
    ):
        """Admission gate + pow-2 pick; returns (replica_set, replica) with
        NO ongoing-count taken yet. Raises DeploymentOverloadedError on a
        shed, TimeoutError when no replica ever materializes in budget."""
        self.watch(deployment_id_str)
        rs = self._replica_set(deployment_id_str)
        loop = asyncio.get_running_loop()
        self._admit_deadline(rs, deployment_id_str, deadline, loop)
        cap = rs.queue_cap()
        if rs.queued >= cap:
            rs.shed_queue_full += 1
            rs._tel_shed_queue.inc()
            telemetry.record_event(
                "serve", "admission_shed", deployment=deployment_id_str,
                reason="queue_full",
            )
            raise DeploymentOverloadedError(
                deployment_id_str,
                "queue_full",
                f"{rs.queued} queued >= cap {cap}",
            )
        poll = config.serve_backpressure_poll_s
        rs.queued += 1
        try:
            while True:
                if not rs.replicas:
                    wait = (
                        None
                        if deadline is None
                        else max(0.0, deadline - loop.time())
                    )
                    try:
                        await asyncio.wait_for(rs.nonempty.wait(), timeout=wait)
                    except asyncio.TimeoutError:
                        raise TimeoutError(
                            f"no replicas of {deployment_id_str} available"
                        ) from None
                replica = self._pick_replica(
                    rs, request_meta.get("multiplexed_model_id")
                )
                if replica is not None:
                    return rs, replica
                # All replicas at max_ongoing_requests: wait for a slot, then
                # re-run deadline admission — a request whose budget drained
                # away while queued becomes a typed shed, not a timeout.
                rs.slot_freed.clear()
                try:
                    await asyncio.wait_for(
                        rs.slot_freed.wait(),
                        timeout=poll
                        if deadline is None
                        else min(poll, max(0.01, deadline - loop.time())),
                    )
                except asyncio.TimeoutError:
                    if deadline is not None and loop.time() > deadline:
                        raise TimeoutError(
                            f"backpressure timeout for {deployment_id_str}"
                        ) from None
                self._admit_deadline(rs, deployment_id_str, deadline, loop)
        finally:
            rs.queued -= 1

    async def assign_request(
        self,
        deployment_id_str: str,
        request_meta: Dict[str, Any],
        args: Tuple,
        kwargs: Dict,
        timeout_s: Optional[float] = None,
    ) -> Any:
        """Route one request and return its result value."""
        loop = asyncio.get_running_loop()
        deadline = self._request_deadline(loop, timeout_s)
        # Root span for the whole routed request: a serve request has no
        # task ancestry, so the router is where its trace begins (sampled
        # on the request id). Every downstream hop — the actor submit, the
        # lease RPCs, the replica's execute scope — parents under this.
        with tracing.root_scope(
            f"serve.request::{deployment_id_str}",
            "serve",
            key=request_meta.get("request_id") or deployment_id_str,
            deployment=deployment_id_str,
        ):
            return await self._assign_request_traced(
                deployment_id_str, request_meta, args, kwargs, loop, deadline
            )

    async def _assign_request_traced(
        self,
        deployment_id_str: str,
        request_meta: Dict[str, Any],
        args: Tuple,
        kwargs: Dict,
        loop,
        deadline: Optional[float],
    ) -> Any:
        while True:
            with tracing.span_scope(
                "serve.admission", "serve", deployment=deployment_id_str
            ):
                rs, replica = await self._acquire_replica(
                    deployment_id_str, request_meta, deadline
                )
            rid = replica.replica_id_str
            rs.ongoing[rid] = rs.ongoing.get(rid, 0) + 1
            t0 = loop.time()
            # Admitted: the deadline rides the actor call as a TTL stamp, so
            # the replica-side server sheds it if it expires in transit and
            # cancels the handler at the deadline (PR-4 enforcement). The
            # grace window lets the typed error reply travel back before we
            # declare the request lost.
            token = (
                rpc._ambient_deadline.set(deadline)
                if deadline is not None
                else None
            )
            try:
                refs = await self._core.submit_actor_task(
                    self._handle_for(rs, replica)._actor_id,
                    "handle_request",
                    (request_meta, args, kwargs),
                    {},
                    num_returns=1,
                )
                get = self._core.get_objects(refs[0], timeout=None)
                if deadline is None:
                    result = await get
                else:
                    result = await asyncio.wait_for(
                        get,
                        timeout=max(0.0, deadline - loop.time())
                        + config.rpc_deadline_grace_s,
                    )
                rs.observe_service_time(loop.time() - t0)
                return result
            except asyncio.TimeoutError:
                rs.deadline_failures += 1
                raise rpc.DeadlineExceeded(
                    f"request to {deployment_id_str} missed its deadline "
                    f"(no reply within budget + grace)"
                ) from None
            except rpc.DeadlineExceeded:
                rs.deadline_failures += 1
                raise
            except ActorDiedError:
                # The replica was dead before the task ever ran (it only
                # raises at actor resolution). Evict it and re-route: the
                # retry re-enters admission, so a budget that drains away
                # while the deployment recovers becomes a typed shed or
                # deadline error, never a wasted slot on a corpse.
                rs.evict(rid)
                continue
            except ActorUnavailableError:
                # Died while the request was in flight — it may have
                # partially executed, so no blind re-execute: surface the
                # typed error, but stop routing new requests at the corpse.
                rs.evict(rid)
                raise
            except rpc.RpcError as e:
                if str(e).startswith("DeadlineExceeded"):
                    rs.deadline_failures += 1
                    raise rpc.DeadlineExceeded(str(e)) from None
                raise
            finally:
                if token is not None:
                    rpc._ambient_deadline.reset(token)
                if rid in rs.ongoing:
                    rs.ongoing[rid] = max(0, rs.ongoing[rid] - 1)
                rs.slot_freed.set()

    async def assign_request_streaming(
        self,
        deployment_id_str: str,
        request_meta: Dict[str, Any],
        args: Tuple,
        kwargs: Dict,
        timeout_s: Optional[float] = None,
    ):
        """Route one request to the streaming handler; async-yields each
        item as the replica produces it (the runtime's streaming-generator
        machinery carries items owner-ward while the replica still runs —
        reference: router.py + replica.py handle_request_streaming).

        Admission control applies at entry; the per-item waits are not
        deadline-cut (streams may legitimately outlive the initial budget)."""
        loop = asyncio.get_running_loop()
        deadline = self._request_deadline(loop, timeout_s)
        # Root span covering the stream (see assign_request): entered
        # manually because this is an async generator — the scope must stay
        # open across yields and close on exhaustion/teardown.
        scope = tracing.root_scope(
            f"serve.request::{deployment_id_str}",
            "serve",
            key=request_meta.get("request_id") or deployment_id_str,
            deployment=deployment_id_str,
            streaming=True,
        )
        scope.__enter__()
        try:
            async for item in self._assign_streaming_traced(
                deployment_id_str, request_meta, args, kwargs, deadline
            ):
                yield item
        finally:
            scope.__exit__(None, None, None)

    async def _assign_streaming_traced(
        self,
        deployment_id_str: str,
        request_meta: Dict[str, Any],
        args: Tuple,
        kwargs: Dict,
        deadline: Optional[float],
    ):
        while True:
            with tracing.span_scope(
                "serve.admission", "serve", deployment=deployment_id_str
            ):
                rs, replica = await self._acquire_replica(
                    deployment_id_str, request_meta, deadline
                )
            rid = replica.replica_id_str
            rs.ongoing[rid] = rs.ongoing.get(rid, 0) + 1
            yielded = False
            try:
                refs = await self._core.submit_actor_task(
                    self._handle_for(rs, replica)._actor_id,
                    "handle_request_streaming",
                    (request_meta, args, kwargs),
                    {},
                    num_returns=-1,
                )
                gen = await self._core.get_objects(refs[0], timeout=None)
                i = 0
                while True:
                    if gen._refs is not None:  # fully-materialized legacy form
                        if i >= len(gen._refs):
                            break
                        ref = gen._refs[i]
                    else:
                        ref = await self._core.dyn_next(
                            gen._task_id, gen._owner_addr, i
                        )
                        if ref is None:
                            break
                    item = await self._core.get_objects(ref, timeout=None)
                    yielded = True
                    yield item
                    i += 1
                return
            except ActorDiedError:
                # Dead at resolution: safe to re-route only while nothing
                # has been yielded — a consumed prefix cannot be replayed.
                rs.evict(rid)
                if yielded:
                    raise
                continue
            except ActorUnavailableError:
                rs.evict(rid)
                raise
            finally:
                if rid in rs.ongoing:
                    rs.ongoing[rid] = max(0, rs.ongoing[rid] - 1)
                rs.slot_freed.set()

    def _handle_for(self, rs: _ReplicaSet, info: RunningReplicaInfo) -> ActorHandle:
        h = rs.handles.get(info.replica_id_str)
        if h is None:
            h = ActorHandle(info.actor_id)
            rs.handles[info.replica_id_str] = h
        return h
