"""ServeController: the singleton control-plane actor.

Analog of python/ray/serve/_private/controller.py (ServeController:86) +
application_state.py / deployment_state.py: holds target state per
application/deployment, runs a reconciliation loop that starts/stops/heals
replica actors, autoscales on queue metrics, and fans config out to routers
and proxies via a long-poll host. The data plane never touches the controller.
"""

from __future__ import annotations

import asyncio
import math

from ray_tpu_torch._private.rpc import spawn as _spawn
import logging
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.common import config as _config
from ray_tpu_torch._private.gcs import DEAD as ACTOR_DEAD
from ray_tpu_torch.serve._private.common import (
    ApplicationStatus,
    DeploymentID,
    DeploymentStatus,
    ReplicaID,
    RunningReplicaInfo,
)
from ray_tpu_torch.serve._private.long_poll import LongPollHost
from ray_tpu_torch.serve.schema import AutoscalingConfig, DeploymentConfig

logger = logging.getLogger(__name__)

RECONCILE_PERIOD_S = 0.25


class _ReplicaRecord:
    def __init__(
        self,
        replica_id: ReplicaID,
        actor_id: str,
        max_ongoing: int,
        max_queued: int = -1,
    ):
        self.replica_id = replica_id
        self.actor_id = actor_id
        self.max_ongoing = max_ongoing
        self.max_queued = max_queued
        self.ready = False
        self.health_task: Optional[asyncio.Task] = None
        self.consecutive_health_failures = 0
        # GCS actor:<id> pubsub handler while the death watch is armed.
        self.death_watch: Optional[Any] = None

    def info(self) -> RunningReplicaInfo:
        return RunningReplicaInfo(
            replica_id_str=self.replica_id.unique_id,
            deployment_id_str=str(self.replica_id.deployment_id),
            actor_id=self.actor_id,
            max_ongoing_requests=self.max_ongoing,
            max_queued_requests=self.max_queued,
        )


class _DeploymentState:
    """Target + actual state for one deployment (reference
    deployment_state.py DeploymentState)."""

    def __init__(self, dep_id: DeploymentID, spec: Dict[str, Any]):
        self.dep_id = dep_id
        self.spec = spec
        self.config = DeploymentConfig.from_dict(spec["config"])
        self.replicas: Dict[str, _ReplicaRecord] = {}
        self.starting: Dict[str, asyncio.Task] = {}
        self.stopping: Dict[str, asyncio.Task] = {}
        self.status = DeploymentStatus.UPDATING
        self.message = ""
        self.deleting = False
        # autoscaling bookkeeping
        self.metrics_window: List[tuple] = []  # (t, total_ongoing)
        self.queue_ewma = 0.0  # smoothed router queue depth
        self.above_since: Optional[float] = None  # hysteresis timers
        self.below_since: Optional[float] = None
        self.current_target: Optional[int] = None
        # start-failure backoff
        self.consecutive_start_failures = 0
        self.backoff_until = 0.0

    @property
    def target_replicas(self) -> int:
        if self.deleting:
            return 0
        ac = self.config.autoscaling_config
        if ac is not None:
            if self.current_target is None:
                self.current_target = max(ac.min_replicas, 1)
            return self.current_target
        return self.config.num_replicas

    def running_infos(self) -> List[RunningReplicaInfo]:
        return [r.info() for r in self.replicas.values() if r.ready]


def autoscale_tick(state: _DeploymentState, ac: AutoscalingConfig, now: float):
    """Decide the replica target from the ongoing-request window plus the
    smoothed router queue depth (state.queue_ewma), with hysteresis: a
    desired target only takes effect after it has held continuously for
    upscale_delay_s / downscale_delay_s. Returns the new target, or None.

    Kept as a free function (its only side effects are the window prune and
    the hysteresis timers on `state`) so tests can drive it with synthetic
    clocks and queue depths without a live control loop.
    """
    window = [
        (t, v) for (t, v) in state.metrics_window if now - t <= ac.look_back_period_s
    ]
    state.metrics_window = window
    if not window:
        return None
    ongoing_avg = sum(v for _, v in window) / len(window)
    # Queued requests are load the replicas haven't absorbed yet; counting
    # them is what makes the scaler react to saturation (ongoing alone
    # plateaus at num_replicas * max_ongoing_requests under overload).
    load = ongoing_avg + state.queue_ewma
    desired = max(
        ac.min_replicas,
        min(ac.max_replicas, math.ceil(load / max(ac.target_ongoing_requests, 1e-9))),
    )
    cur = state.target_replicas
    if desired > cur:
        state.below_since = None
        if state.above_since is None:
            state.above_since = now
        if now - state.above_since >= ac.upscale_delay_s:
            state.above_since = None
            return desired
    elif desired < cur:
        state.above_since = None
        if state.below_since is None:
            state.below_since = now
        if now - state.below_since >= ac.downscale_delay_s:
            state.below_since = None
            return desired
    else:
        state.above_since = None
        state.below_since = None
    return None


_TEL_AUTOSCALE = telemetry.counter(
    "serve", "autoscale_decisions",
    "autoscaler target changes that survived hysteresis",
)


class ServeController:
    """Created as a detached named actor with high max_concurrency so
    long-poll listens don't block control operations."""

    def __init__(self, http_options: Optional[Dict[str, Any]] = None):
        self._http_options = http_options or {}
        self._apps: Dict[str, Dict[str, Any]] = {}  # app -> app spec + status
        self._deployments: Dict[str, _DeploymentState] = {}  # str(dep_id) -> state
        self._long_poll = LongPollHost()
        self._loop_task: Optional[asyncio.Task] = None
        self._proxy_actor_id: Optional[str] = None
        self._shutdown = False
        # (dep_id_str, router_id) -> (monotonic ts, queued, ongoing); pushed
        # by every router's metrics loop, consumed by the autoscaler.
        self._router_metrics: Dict[Tuple[str, str], Tuple[float, int, int]] = {}

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> bool:
        if self._loop_task is None:
            self._loop_task = _spawn(self._run_control_loop())
            if self._http_options.get("enabled", True):
                await self._ensure_proxy()
        return True

    async def _ensure_proxy(self) -> None:
        if self._proxy_actor_id is not None:
            return
        from ray_tpu_torch.serve._private.proxy import ProxyActor

        core = worker_mod._core()
        actor_id = await core.create_actor(
            cloudpickle.dumps(ProxyActor),
            "ServeProxy",
            (
                self._http_options.get("host", "127.0.0.1"),
                self._http_options.get("port", 8000),
                self._http_options.get("grpc_port"),
            ),
            {},
            resources={"CPU": 0.0},
            max_concurrency=1000,
            name="SERVE_PROXY",
            namespace="serve",
            lifetime="detached",
        )
        self._proxy_actor_id = actor_id
        # Tell the proxy to bind its HTTP server.
        refs = await core.submit_actor_task(actor_id, "ready", (), {}, num_returns=1)
        bound = await core.get_objects(refs[0], timeout=None)
        self._http_options["port"] = bound["port"]
        if bound.get("grpc_port") is not None:
            self._http_options["grpc_port"] = bound["grpc_port"]
        logger.info("serve proxy listening on %s", bound)

    async def get_http_config(self) -> Dict[str, Any]:
        return dict(self._http_options)

    async def check_alive(self) -> bool:
        return True

    async def record_router_metrics(
        self, router_id: str, snap: Dict[str, Dict[str, int]]
    ) -> None:
        """Routers push {dep_id_str: {"queued": n, "ongoing": n}} here on a
        short interval; the autoscaler sums fresh entries across routers."""
        now = time.monotonic()
        for dep_key, m in (snap or {}).items():
            self._router_metrics[(dep_key, router_id)] = (
                now,
                int(m.get("queued", 0)),
                int(m.get("ongoing", 0)),
            )

    # -- long poll -----------------------------------------------------------

    async def listen_for_change(self, keys_to_snapshot_ids: Dict[str, int]):
        return await self._long_poll.listen_for_change(keys_to_snapshot_ids)

    def _broadcast_replicas(self, dep_id_str: str) -> None:
        state = self._deployments.get(dep_id_str)
        infos = [] if state is None else [i.to_dict() for i in state.running_infos()]
        self._long_poll.notify_changed(f"replicas::{dep_id_str}", infos)

    def _broadcast_routes(self) -> None:
        table = {}
        for app_name, app in self._apps.items():
            if app.get("route_prefix") and app["status"] in (
                ApplicationStatus.RUNNING,
                ApplicationStatus.DEPLOYING,
            ):
                table[app["route_prefix"]] = {
                    "app": app_name,
                    "ingress": app["ingress"],
                }
        self._long_poll.notify_changed("route_table", table)

    # -- deploy / delete API -------------------------------------------------

    async def deploy_application(self, app_spec: Dict[str, Any]) -> None:
        """app_spec: {name, route_prefix, ingress, deployments: [dep_spec]}.
        dep_spec: {name, serialized_cls, init_args_blob, config}."""
        name = app_spec["name"]
        old = self._apps.get(name)
        if old is not None:
            # Redeploy: drop deployments no longer present.
            new_names = {d["name"] for d in app_spec["deployments"]}
            for dep in old["deployments"]:
                if dep not in new_names:
                    key = str(DeploymentID(dep, name))
                    if key in self._deployments:
                        self._deployments[key].deleting = True
        self._apps[name] = {
            "name": name,
            "route_prefix": app_spec.get("route_prefix"),
            "ingress": app_spec.get("ingress"),
            "deployments": [d["name"] for d in app_spec["deployments"]],
            "status": ApplicationStatus.DEPLOYING,
            "message": "",
        }
        for dep_spec in app_spec["deployments"]:
            dep_id = DeploymentID(dep_spec["name"], name)
            key = str(dep_id)
            existing = self._deployments.get(key)
            if existing is not None and not existing.deleting:
                # In-place update: new config; replicas restart only if the
                # code/init args changed (version hash).
                if existing.spec.get("version") == dep_spec.get("version"):
                    old_cfg = existing.config
                    existing.spec = dep_spec
                    existing.config = DeploymentConfig.from_dict(dep_spec["config"])
                    existing.current_target = None
                    existing.status = DeploymentStatus.UPDATING
                    # Lightweight (same-code) config change: push user_config
                    # to live replicas and refresh router-visible limits.
                    new_cfg = existing.config
                    for rec in existing.replicas.values():
                        rec.max_ongoing = new_cfg.max_ongoing_requests
                        rec.max_queued = new_cfg.max_queued_requests
                    if new_cfg.user_config != old_cfg.user_config:
                        _spawn(
                            self._reconfigure_replicas(existing, new_cfg.user_config)
                        )
                    self._broadcast_replicas(key)
                    continue
                for rec in list(existing.replicas.values()):
                    self._start_stopping(existing, rec)
                existing.spec = dep_spec
                existing.config = DeploymentConfig.from_dict(dep_spec["config"])
                existing.current_target = None
                existing.status = DeploymentStatus.UPDATING
            else:
                self._deployments[key] = _DeploymentState(dep_id, dep_spec)
        self._broadcast_routes()

    async def delete_application(self, name: str) -> None:
        app = self._apps.get(name)
        if app is None:
            return
        app["status"] = ApplicationStatus.DELETING
        for dep in app["deployments"]:
            key = str(DeploymentID(dep, name))
            if key in self._deployments:
                self._deployments[key].deleting = True
        self._broadcast_routes()

    async def graceful_shutdown(self) -> None:
        # Mark everything deleting and let the reconcile loop (still running)
        # drain and kill replicas; only then stop the loop.
        for app in self._apps.values():
            app["status"] = ApplicationStatus.DELETING
        for state in self._deployments.values():
            state.deleting = True
        self._broadcast_routes()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if not self._deployments:
                break
            await asyncio.sleep(0.1)
        self._shutdown = True
        core = worker_mod._core()
        if self._proxy_actor_id:
            try:
                await core.kill_actor(self._proxy_actor_id)
            except Exception:
                pass

    # -- status --------------------------------------------------------------

    async def get_serve_status(self) -> Dict[str, Any]:
        out = {}
        for app_name, app in self._apps.items():
            deps = {}
            for dep in app["deployments"]:
                state = self._deployments.get(str(DeploymentID(dep, app_name)))
                if state is None:
                    continue
                counts = {
                    "RUNNING": sum(1 for r in state.replicas.values() if r.ready),
                    "STARTING": len(state.starting)
                    + sum(1 for r in state.replicas.values() if not r.ready),
                    "STOPPING": len(state.stopping),
                }
                deps[dep] = {
                    "status": state.status.value,
                    "message": state.message,
                    "replica_states": counts,
                    "target_replicas": state.target_replicas,
                }
            out[app_name] = {
                "status": app["status"].value
                if isinstance(app["status"], ApplicationStatus)
                else app["status"],
                "message": app.get("message", ""),
                "route_prefix": app.get("route_prefix"),
                "ingress": app.get("ingress"),
                "deployments": deps,
            }
        return out

    # -- reconciliation ------------------------------------------------------

    async def _run_control_loop(self) -> None:
        while not self._shutdown:
            try:
                await self._reconcile_once()
            except Exception:
                logger.error("reconcile error:\n%s", traceback.format_exc())
            await asyncio.sleep(RECONCILE_PERIOD_S)

    async def _reconcile_once(self) -> None:
        for key, state in list(self._deployments.items()):
            self._autoscale(state)
            target = state.target_replicas
            actual = len(state.replicas) + len(state.starting)
            if actual < target and time.monotonic() >= state.backoff_until:
                for _ in range(target - actual):
                    self._start_replica(state)
            elif actual > target:
                excess = actual - target
                # Prefer stopping not-yet-ready replicas.
                ordered = sorted(state.replicas.values(), key=lambda r: r.ready)
                for rec in ordered[:excess]:
                    self._start_stopping(state, rec)
            self._update_deployment_status(state)
            if state.deleting and not (
                state.replicas or state.starting or state.stopping
            ):
                del self._deployments[key]
                self._broadcast_replicas(key)
        self._update_app_statuses()

    def _update_deployment_status(self, state: _DeploymentState) -> None:
        if state.deleting:
            state.status = DeploymentStatus.DELETING
            return
        ready = sum(1 for r in state.replicas.values() if r.ready)
        if ready == state.target_replicas and not state.starting:
            state.status = DeploymentStatus.HEALTHY
        elif state.status != DeploymentStatus.UNHEALTHY:
            state.status = (
                DeploymentStatus.UPSCALING
                if ready < state.target_replicas
                else DeploymentStatus.DOWNSCALING
            )

    def _update_app_statuses(self) -> None:
        for app_name, app in self._apps.items():
            if app["status"] == ApplicationStatus.DELETING:
                if not any(
                    str(DeploymentID(d, app_name)) in self._deployments
                    for d in app["deployments"]
                ):
                    del self._apps[app_name]
                    self._broadcast_routes()
                    return
                continue
            statuses = []
            for d in app["deployments"]:
                state = self._deployments.get(str(DeploymentID(d, app_name)))
                if state is not None:
                    statuses.append(state.status)
            if any(s == DeploymentStatus.UNHEALTHY for s in statuses):
                new = ApplicationStatus.DEPLOY_FAILED
            elif statuses and all(s == DeploymentStatus.HEALTHY for s in statuses):
                new = ApplicationStatus.RUNNING
            else:
                new = ApplicationStatus.DEPLOYING
            if new != app["status"]:
                app["status"] = new
                self._broadcast_routes()

    # -- replica lifecycle ---------------------------------------------------

    def _start_replica(self, state: _DeploymentState) -> None:
        replica_id = ReplicaID.generate(state.dep_id)
        task = _spawn(self._create_replica(state, replica_id))
        state.starting[replica_id.unique_id] = task

    async def _create_replica(
        self, state: _DeploymentState, replica_id: ReplicaID
    ) -> None:
        from ray_tpu_torch.serve._private.replica import Replica

        core = worker_mod._core()
        cfg = state.config
        actor_id = None
        try:
            opts = dict(cfg.ray_actor_options)
            resources = {"CPU": float(opts.get("num_cpus", 0.1))}
            if opts.get("num_gpus"):
                resources["GPU"] = float(opts["num_gpus"])
            for k, v in (opts.get("resources") or {}).items():
                resources[k] = float(v)
            init_args, init_kwargs = cloudpickle.loads(state.spec["init_args_blob"])
            actor_id = await core.create_actor(
                cloudpickle.dumps(Replica),
                f"ServeReplica:{state.dep_id.app_name}:{state.dep_id.name}",
                (
                    state.spec["serialized_cls"],
                    init_args,
                    init_kwargs,
                    str(state.dep_id),
                    replica_id.unique_id,
                    cfg.user_config,
                    cfg.max_batch_size,
                    cfg.batch_wait_timeout_s,
                    cfg.max_ongoing_requests,
                ),
                {},
                resources=resources,
                max_concurrency=max(cfg.max_ongoing_requests, 8),
                name=replica_id.to_actor_name(),
                namespace="serve",
                lifetime="detached",
            )
            # Readiness ping (also surfaces user __init__ errors).
            refs = await core.submit_actor_task(
                actor_id, "check_health", (), {}, num_returns=1
            )
            await asyncio.wait_for(
                core.get_objects(refs[0], timeout=None),
                timeout=cfg.health_check_timeout_s,
            )
            rec = _ReplicaRecord(
                replica_id,
                actor_id,
                cfg.max_ongoing_requests,
                cfg.max_queued_requests,
            )
            rec.ready = True
            state.replicas[replica_id.unique_id] = rec
            rec.health_task = _spawn(self._health_loop(state, rec))
            self._arm_death_watch(state, rec)
            state.message = ""
            state.consecutive_start_failures = 0
            state.backoff_until = 0.0
            self._broadcast_replicas(str(state.dep_id))
        except Exception as e:
            state.status = DeploymentStatus.UNHEALTHY
            state.message = f"replica start failed: {type(e).__name__}: {e}"
            state.consecutive_start_failures += 1
            state.backoff_until = time.monotonic() + min(
                30.0, 0.5 * 2**state.consecutive_start_failures
            )
            if actor_id is not None:
                # Don't leak the half-started detached actor.
                try:
                    await core.kill_actor(actor_id)
                except Exception:
                    pass
            logger.warning(
                "replica %s of %s failed to start: %s",
                replica_id.unique_id,
                state.dep_id,
                state.message,
            )
        finally:
            state.starting.pop(replica_id.unique_id, None)

    async def _reconfigure_replicas(
        self, state: _DeploymentState, user_config: Any
    ) -> None:
        core = worker_mod._core()
        for rec in list(state.replicas.values()):
            try:
                refs = await core.submit_actor_task(
                    rec.actor_id, "reconfigure", (user_config,), {}, num_returns=1
                )
                await asyncio.wait_for(
                    core.get_objects(refs[0], timeout=None),
                    _config.serve_reconfigure_timeout_s,
                )
            except Exception as e:
                logger.warning(
                    "reconfigure of replica %s failed: %r; replacing",
                    rec.replica_id.unique_id,
                    e,
                )
                self._start_stopping(state, rec)

    async def _health_loop(self, state: _DeploymentState, rec: _ReplicaRecord) -> None:
        """Periodic replica health check (reference deployment_state.py
        check_health path): 3 consecutive failures -> replace the replica."""
        core = worker_mod._core()
        period = state.config.health_check_period_s
        while rec.replica_id.unique_id in state.replicas and not self._shutdown:
            await asyncio.sleep(period)
            try:
                refs = await core.submit_actor_task(
                    rec.actor_id, "check_health", (), {}, num_returns=1
                )
                await asyncio.wait_for(
                    core.get_objects(refs[0], timeout=None),
                    timeout=state.config.health_check_timeout_s,
                )
                rec.consecutive_health_failures = 0
            except asyncio.CancelledError:
                return
            except Exception:
                rec.consecutive_health_failures += 1
                if rec.consecutive_health_failures >= 3:
                    if rec.replica_id.unique_id in state.replicas:
                        logger.warning(
                            "replica %s of %s failed health checks; replacing",
                            rec.replica_id.unique_id,
                            state.dep_id,
                        )
                        self._start_stopping(state, rec)
                    return

    def _arm_death_watch(self, state: _DeploymentState, rec: _ReplicaRecord) -> None:
        """Replace a replica the moment the GCS declares its actor DEAD.

        The RPC health loop needs up to ``health_check_timeout_s`` plus two
        more periods to call a SIGKILLed replica dead — seconds in which
        routers still list the corpse. The GCS hears about the worker's
        death from its raylet almost immediately and publishes the actor
        state transition, so subscribing here turns replacement latency
        from seconds into one reconcile tick."""
        core = worker_mod._core()

        def on_update(msg) -> None:
            if (msg or {}).get("state") != ACTOR_DEAD:
                return
            if (
                self._shutdown
                or state.replicas.get(rec.replica_id.unique_id) is not rec
            ):
                return
            logger.warning(
                "replica %s of %s actor died (%s); replacing",
                rec.replica_id.unique_id,
                state.dep_id,
                (msg or {}).get("death_cause") or "no cause recorded",
            )
            self._start_stopping(state, rec)

        rec.death_watch = on_update

        # snapshot=True closes the subscribe-after-publish race (the actor
        # may have died before the Subscribe landed and that publish is
        # gone): the GcsClient delivers the current actor state to this
        # handler right after subscribing, and the same snapshot pull
        # re-fires automatically whenever a pubsub seq gap is detected.
        _spawn(
            core.gcs.subscribe(
                f"actor:{rec.actor_id}", on_update, snapshot=True
            )
        )

    def _start_stopping(self, state: _DeploymentState, rec: _ReplicaRecord) -> None:
        if rec.health_task is not None:
            rec.health_task.cancel()
            rec.health_task = None
        if rec.death_watch is not None:
            handler, rec.death_watch = rec.death_watch, None
            _spawn(
                worker_mod._core().gcs.unsubscribe(
                    f"actor:{rec.actor_id}", handler
                )
            )
        state.replicas.pop(rec.replica_id.unique_id, None)
        self._broadcast_replicas(str(state.dep_id))
        task = _spawn(self._stop_replica(state, rec))
        state.stopping[rec.replica_id.unique_id] = task

    async def _stop_replica(self, state: _DeploymentState, rec: _ReplicaRecord) -> None:
        core = worker_mod._core()
        try:
            refs = await core.submit_actor_task(
                rec.actor_id,
                "prepare_for_shutdown",
                (state.config.graceful_shutdown_timeout_s,),
                {},
                num_returns=1,
            )
            await asyncio.wait_for(
                core.get_objects(refs[0], timeout=None),
                timeout=state.config.graceful_shutdown_timeout_s
                + _config.serve_shutdown_grace_s,
            )
        except Exception:
            pass
        try:
            await core.kill_actor(rec.actor_id)
        except Exception:
            pass
        state.stopping.pop(rec.replica_id.unique_id, None)

    # -- autoscaling ---------------------------------------------------------

    def _router_queue_depth(
        self, dep_key: str, ac: AutoscalingConfig, now: float
    ) -> int:
        """Sum queued requests across routers, ignoring (and pruning) entries
        older than queue_metric_staleness_s — a dead router must not pin the
        depth at its last reported value forever."""
        total = 0
        for (key, router_id), (ts, queued, _ongoing) in list(
            self._router_metrics.items()
        ):
            if now - ts > ac.queue_metric_staleness_s:
                del self._router_metrics[(key, router_id)]
                continue
            if key == dep_key:
                total += queued
        return total

    def _autoscale(self, state: _DeploymentState) -> None:
        ac = state.config.autoscaling_config
        if ac is None or state.deleting:
            return
        now = time.monotonic()
        # Sample metrics (fire-and-forget gather; cheap at control-loop rate).
        _spawn(self._sample_metrics(state, now, ac))
        depth = self._router_queue_depth(str(state.dep_id), ac, now)
        alpha = ac.queue_ewma_alpha
        state.queue_ewma = alpha * depth + (1.0 - alpha) * state.queue_ewma
        new_target = autoscale_tick(state, ac, now)
        if new_target is not None and new_target != state.target_replicas:
            logger.info(
                "autoscaling %s: %d -> %d (queue_ewma=%.1f)",
                state.dep_id,
                state.target_replicas,
                new_target,
                state.queue_ewma,
            )
            direction = "up" if new_target > state.target_replicas else "down"
            _TEL_AUTOSCALE.cell(direction=direction).inc()
            telemetry.record_event(
                "serve", "autoscale", deployment=str(state.dep_id),
                direction=direction, old=state.target_replicas,
                new=new_target,
            )
            state.current_target = new_target

    async def _sample_metrics(
        self, state: _DeploymentState, ts: float, ac: AutoscalingConfig
    ) -> None:
        core = worker_mod._core()
        total = 0
        for rec in list(state.replicas.values()):
            if not rec.ready:
                continue
            try:
                refs = await core.submit_actor_task(
                    rec.actor_id, "get_metrics", (), {}, num_returns=1
                )
                m = await asyncio.wait_for(
                    core.get_objects(refs[0], timeout=None),
                    timeout=_config.serve_metrics_sample_timeout_s,
                )
                total += m.get("num_ongoing_requests", 0)
                rec.consecutive_health_failures = 0
            except Exception:
                rec.consecutive_health_failures += 1
                if rec.consecutive_health_failures >= 3:
                    logger.warning(
                        "replica %s unhealthy; replacing", rec.replica_id.unique_id
                    )
                    self._start_stopping(state, rec)
        state.metrics_window.append((ts, total))
