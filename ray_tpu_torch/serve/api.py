"""Serve public API: @serve.deployment, serve.run, serve.status, ...

Analog of python/ray/serve/api.py (serve.run:545, @serve.deployment:248).
`Deployment.bind(*args)` builds an application graph (args may be other bound
deployments — model composition); `serve.run` deploys it through the
controller and returns a handle to the ingress deployment.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve._private.common import (
    CONTROLLER_NAME,
    DEFAULT_APP_NAME,
    SERVE_NAMESPACE,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, _reset_router
from ray_tpu_torch.serve.schema import AutoscalingConfig, DeploymentConfig, HTTPOptions

_controller_handle = None

# Per-class no-op-__del__ subclasses used by @multiplexed eviction; cached so
# repeated evictions of the same model class reuse one type object.
_neutered_classes: Dict[type, type] = {}


@dataclass
class Application:
    """A bound deployment DAG node (reference: serve.built_application /
    Application). `args` may contain other Application nodes."""

    deployment: "Deployment"
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


class Deployment:
    def __init__(self, func_or_class, name: str, config: DeploymentConfig):
        self._func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, **kwargs) -> "Deployment":
        cfg = DeploymentConfig.from_dict(self.config.to_dict())
        name = kwargs.pop("name", self.name)
        if "autoscaling_config" in kwargs:
            ac = kwargs.pop("autoscaling_config")
            cfg.autoscaling_config = (
                AutoscalingConfig.from_dict(ac) if isinstance(ac, dict) else ac
            )
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise TypeError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self._func_or_class, name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"deployment {self.name!r} cannot be called directly; use "
            "serve.run(deployment.bind(...)) and call the returned handle"
        )


def deployment(
    _func_or_class=None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str, None] = None,
    max_ongoing_requests: Optional[int] = None,
    max_queued_requests: Optional[int] = None,
    max_batch_size: Optional[int] = None,
    batch_wait_timeout_s: Optional[float] = None,
    autoscaling_config: Union[AutoscalingConfig, dict, None] = None,
    user_config: Optional[Any] = None,
    health_check_period_s: Optional[float] = None,
    health_check_timeout_s: Optional[float] = None,
    graceful_shutdown_timeout_s: Optional[float] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
):
    """Decorator converting a class (or function) into a Deployment."""

    def build(obj) -> Deployment:
        cfg = DeploymentConfig()
        if num_replicas is not None and num_replicas != "auto":
            cfg.num_replicas = int(num_replicas)
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if max_batch_size is not None:
            cfg.max_batch_size = max_batch_size
        if batch_wait_timeout_s is not None:
            cfg.batch_wait_timeout_s = batch_wait_timeout_s
        ac = autoscaling_config
        if num_replicas == "auto" and ac is None:
            ac = AutoscalingConfig(min_replicas=1, max_replicas=8)
        if ac is not None:
            cfg.autoscaling_config = (
                AutoscalingConfig.from_dict(ac) if isinstance(ac, dict) else ac
            )
        if user_config is not None:
            cfg.user_config = user_config
        if health_check_period_s is not None:
            cfg.health_check_period_s = health_check_period_s
        if health_check_timeout_s is not None:
            cfg.health_check_timeout_s = health_check_timeout_s
        if graceful_shutdown_timeout_s is not None:
            cfg.graceful_shutdown_timeout_s = graceful_shutdown_timeout_s
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        return Deployment(obj, name or obj.__name__, cfg)

    if _func_or_class is not None:
        return build(_func_or_class)
    return build


def ingress(_cls=None):
    """No-op marker for API parity with the reference's FastAPI ingress."""
    return _cls if _cls is not None else (lambda c: c)


# -- controller management ----------------------------------------------------


def _get_controller():
    global _controller_handle
    if _controller_handle is not None:
        return _controller_handle
    _controller_handle = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    return _controller_handle


def start(http_options: Union[HTTPOptions, dict, None] = None, **kwargs):
    """Ensure the Serve controller (and proxy) is running."""
    global _controller_handle
    if http_options is None:
        http_options = HTTPOptions(**kwargs) if kwargs else HTTPOptions(port=0)
    elif isinstance(http_options, dict):
        http_options = HTTPOptions(**http_options)
    try:
        handle = _get_controller()
    except ValueError:
        from ray_tpu_torch.serve._private.controller import ServeController

        handle = (
            ray_tpu_torch.remote(ServeController)
            .options(
                name=CONTROLLER_NAME,
                namespace=SERVE_NAMESPACE,
                lifetime="detached",
                max_concurrency=1000,
                num_cpus=0.1,
                get_if_exists=True,
            )
            .remote(http_options.to_dict())
        )
        _controller_handle = handle
    ray_tpu_torch.get(handle.start.remote())
    return handle


def _collect_deployments(
    app: Application, out: Dict[str, Tuple[Deployment, Tuple, Dict]], app_name: str
) -> str:
    """DFS over the bind graph; nested Applications become handles."""
    dep = app.deployment

    def resolve(v):
        if isinstance(v, Application):
            child = _collect_deployments(v, out, app_name)
            return DeploymentHandle(child, app_name)
        return v

    args = tuple(resolve(a) for a in app.args)
    kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    if dep.name in out and out[dep.name][0] is not dep:
        raise ValueError(f"duplicate deployment name {dep.name!r} in application")
    out[dep.name] = (dep, args, kwargs)
    return dep.name


def run(
    target: Application,
    *,
    name: str = DEFAULT_APP_NAME,
    route_prefix: Optional[str] = "/",
    blocking: bool = False,
    _timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application and wait until it is RUNNING."""
    if isinstance(target, Deployment):
        target = target.bind()
    if not isinstance(target, Application):
        raise TypeError("serve.run expects an Application (deployment.bind(...))")
    controller = start()

    deployments: Dict[str, Tuple[Deployment, Tuple, Dict]] = {}
    ingress_name = _collect_deployments(target, deployments, name)

    dep_specs = []
    for dep_name, (dep, args, kwargs) in deployments.items():
        serialized_cls = cloudpickle.dumps(dep._func_or_class)
        init_blob = cloudpickle.dumps((args, kwargs))
        version = hashlib.sha1(serialized_cls + init_blob).hexdigest()[:16]
        dep_specs.append(
            {
                "name": dep_name,
                "serialized_cls": serialized_cls,
                "init_args_blob": init_blob,
                "config": dep.config.to_dict(),
                "version": version,
            }
        )
    app_spec = {
        "name": name,
        "route_prefix": route_prefix,
        "ingress": ingress_name,
        "deployments": dep_specs,
    }
    ray_tpu_torch.get(controller.deploy_application.remote(app_spec))

    deadline = time.monotonic() + _timeout_s
    while True:
        statuses = ray_tpu_torch.get(controller.get_serve_status.remote())
        info = statuses.get(name, {})
        if info.get("status") == "RUNNING":
            break
        if info.get("status") == "DEPLOY_FAILED":
            msgs = {
                d: s.get("message")
                for d, s in info.get("deployments", {}).items()
                if s.get("message")
            }
            raise RuntimeError(f"deploying app {name!r} failed: {msgs}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"app {name!r} not RUNNING after {_timeout_s}s: {info}")
        time.sleep(0.1)

    handle = DeploymentHandle(ingress_name, name)
    if blocking:
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def delete(name: str, _blocking: bool = True) -> None:
    controller = _get_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name))
    if _blocking:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if name not in ray_tpu_torch.get(controller.get_serve_status.remote()):
                return
            time.sleep(0.1)


def status() -> Dict[str, Any]:
    try:
        controller = _get_controller()
    except ValueError:
        return {}
    return ray_tpu_torch.get(controller.get_serve_status.remote())


def get_deployment_handle(
    deployment_name: str, app_name: str = DEFAULT_APP_NAME
) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def get_app_handle(name: str = DEFAULT_APP_NAME) -> DeploymentHandle:
    info = status().get(name)
    if info is None:
        raise ValueError(f"no application named {name!r}")
    ing = info.get("ingress")
    if not ing:
        deps = list(info.get("deployments", {}))
        if len(deps) != 1:
            raise ValueError(f"cannot determine ingress of app {name!r}")
        ing = deps[0]
    return DeploymentHandle(ing, name)


# -- model multiplexing (reference: serve/api.py @serve.multiplexed +
# get_multiplexed_model_id) ---------------------------------------------------

import contextvars as _contextvars

_multiplexed_model_id_ctx: "_contextvars.ContextVar[str]" = _contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the in-flight multiplexed request
    (from the gRPC/HTTP ``multiplexed_model_id`` metadata)."""
    return _multiplexed_model_id_ctx.get()


def multiplexed(func=None, *, max_num_models_per_replica: int = 3):
    """Decorate an async per-model loader on a deployment: loads are cached
    per model id with LRU eviction at ``max_num_models_per_replica``; the
    router keeps a model's requests sticky to the replica that loaded it."""
    import asyncio as _asyncio
    import collections as _collections
    import functools as _functools

    def deco(fn):
        cache: "_collections.OrderedDict[str, Any]" = _collections.OrderedDict()
        locks: Dict[str, Any] = {}

        @_functools.wraps(fn)
        async def wrapper(self_or_id, model_id=None):
            # Supports both bound-method (self, model_id) and free (model_id).
            if model_id is None:
                target_id = self_or_id
                call = lambda: fn(target_id)  # noqa: E731
            else:
                target_id = model_id
                call = lambda: fn(self_or_id, target_id)  # noqa: E731
            if target_id in cache:
                cache.move_to_end(target_id)
                return cache[target_id]
            lock = locks.setdefault(target_id, _asyncio.Lock())
            async with lock:
                if target_id in cache:
                    cache.move_to_end(target_id)
                    return cache[target_id]
                model = call()
                if _asyncio.iscoroutine(model):
                    model = await model
                cache[target_id] = model
                while len(cache) > max_num_models_per_replica:
                    evicted_id, evicted = cache.popitem(last=False)
                    locks.pop(evicted_id, None)
                    # Release eagerly (reference evicts with explicit
                    # deletion so TPU/GPU memory frees before the next load).
                    del_fn = getattr(evicted, "__del__", None)
                    if del_fn is not None:
                        try:
                            del_fn()
                        except Exception:
                            pass
                        # Neutralize so GC doesn't run the destructor a
                        # second time (double resource release — reference:
                        # serve/multiplex.py:245-252 replaces __del__ after
                        # the explicit call; it uses an instance setattr,
                        # which CPython ignores for dunders, so swap in a
                        # per-instance subclass with a no-op __del__).
                        try:
                            cls = type(evicted)
                            neutered = _neutered_classes.get(cls)
                            if neutered is None:
                                neutered = type(
                                    cls.__name__,
                                    (cls,),
                                    {"__del__": lambda _s: None,
                                     "__qualname__": cls.__qualname__,
                                     "__module__": cls.__module__},
                                )
                                _neutered_classes[cls] = neutered
                            evicted.__class__ = neutered
                        except Exception:
                            # __slots__/extension types (TypeError) or a
                            # model class's __init_subclass__ hook rejecting
                            # the subclass: accept the destructor rerun.
                            pass
                return model

        return wrapper

    if func is not None:
        return deco(func)
    return deco


def shutdown() -> None:
    """Tear down all Serve actors."""
    global _controller_handle
    try:
        controller = _get_controller()
    except Exception:
        _controller_handle = None
        _reset_router()
        return
    try:
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=30)
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:
        pass
    _controller_handle = None
    _reset_router()
