"""DeploymentHandle: call a deployment from Python (driver or other replicas).

Analog of python/ray/serve/handle.py: `handle.remote(*args)` returns a
DeploymentResponse — sync callers use `.result()`, async callers `await` it.
Handles serialize as (app, deployment) names, so they can be passed as init
args to downstream deployments for model composition.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.serve._private.common import DeploymentID, RequestMetadata

_router_lock = threading.Lock()
_process_router = None  # one Router per process, shared across handles


async def _get_router():
    """Lazily build the process-wide Router. Always runs on the runtime event
    loop, so the controller lookup uses the async GCS path (a sync lookup here
    would deadlock when called from inside a replica)."""
    global _process_router
    if _process_router is None:
        from ray_tpu_torch.actor import ActorHandle
        from ray_tpu_torch.serve._private.common import CONTROLLER_NAME, SERVE_NAMESPACE
        from ray_tpu_torch.serve._private.router import Router

        core = worker_mod._core()
        reply = await core.gcs.call(
            "GetNamedActor", {"name": CONTROLLER_NAME, "namespace": SERVE_NAMESPACE}
        )
        info = reply["actor"]
        if info is None or info["state"] == "DEAD":
            raise RuntimeError("Serve is not running (no controller actor)")
        _process_router = Router(ActorHandle(info["actor_id"]), core)
    return _process_router


def _reset_router() -> None:
    global _process_router
    with _router_lock:
        if _process_router is not None:
            _process_router.shutdown()
        _process_router = None


class DeploymentResponse:
    """Future-like result of handle.remote() (reference handle.py
    DeploymentResponse). Awaitable, and `.result(timeout_s)` for sync code."""

    def __init__(self, cf):
        self._cf = cf  # concurrent.futures.Future from run_coroutine_threadsafe

    def result(self, timeout_s: Optional[float] = None) -> Any:
        w = worker_mod.global_worker
        if threading.current_thread() is w._loop_thread:
            raise RuntimeError(
                "DeploymentResponse.result() called on the event loop; "
                "use `await response` in async code"
            )
        return self._cf.result(timeout_s)

    def __await__(self):
        return asyncio.wrap_future(self._cf).__await__()

    def cancel(self) -> None:
        self._cf.cancel()


class DeploymentHandle:
    def __init__(
        self,
        deployment_name: str,
        app_name: str = "default",
        *,
        method_name: str = "__call__",
        multiplexed_model_id: str = "",
    ):
        self.deployment_id = DeploymentID(deployment_name, app_name)
        self._method_name = method_name
        self._multiplexed_model_id = multiplexed_model_id

    def options(
        self,
        *,
        method_name: Optional[str] = None,
        multiplexed_model_id: Optional[str] = None,
    ) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_id.name,
            self.deployment_id.app_name,
            method_name=method_name or self._method_name,
            multiplexed_model_id=(
                multiplexed_model_id
                if multiplexed_model_id is not None
                else self._multiplexed_model_id
            ),
        )

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        w = worker_mod.global_worker
        meta = RequestMetadata(call_method=self._method_name)

        async def _assign():
            router = await _get_router()
            # Model composition: resolve nested responses/handles in args.
            rargs = []
            for a in args:
                if isinstance(a, DeploymentResponse):
                    a = await a
                rargs.append(a)
            rkwargs = {}
            for k, v in kwargs.items():
                if isinstance(v, DeploymentResponse):
                    v = await v
                rkwargs[k] = v
            return await router.assign_request(
                str(self.deployment_id),
                {
                    "call_method": meta.call_method,
                    "request_id": meta.request_id,
                    "multiplexed_model_id": self._multiplexed_model_id,
                },
                tuple(rargs),
                rkwargs,
            )

        cf = asyncio.run_coroutine_threadsafe(_assign(), w.loop)
        return DeploymentResponse(cf)

    def __reduce__(self):
        return (
            _rebuild_handle,
            (
                self.deployment_id.name,
                self.deployment_id.app_name,
                self._method_name,
                self._multiplexed_model_id,
            ),
        )

    def __repr__(self):
        return f"DeploymentHandle({self.deployment_id})"


def _rebuild_handle(
    name: str, app_name: str, method_name: str, multiplexed_model_id: str = ""
) -> DeploymentHandle:
    return DeploymentHandle(
        name,
        app_name,
        method_name=method_name,
        multiplexed_model_id=multiplexed_model_id,
    )
