"""ray_tpu_torch: the port of ray_tpu to PyTorch and CUDA on NVIDIA Hopper.

The runtime is the port's own copy of ray_tpu's core (tasks, actors,
shared-memory objects, placement groups, train, data), with GPUs as a
cluster resource; `models` (the transformer and ResNet) and `ops` (flash
attention with hand-written CUDA kernels, RMSNorm, chunked cross entropy)
hold the train steps, and `bench` measures them. It imports neither jax
nor ray_tpu.

    import ray_tpu_torch

    ray_tpu_torch.init()  # detects the node's GPUs: resources {"GPU": n}

    @ray_tpu_torch.remote(num_gpus=1)
    def f(x):
        return x * 2

    ray_tpu_torch.get(f.remote(2))  # 4

`models` and `ops` load on first use, so the runtime's daemons and workers
do not import torch unless the code they run does.
"""

import importlib

from ray_tpu_torch._private.common import (
    ActorDiedError,
    ActorUnavailableError,
    GetTimeoutError,
    ObjectLostError,
    ObjectReconstructionFailedError,
    PlacementGroupError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch._private.core_worker import ObjectRef, ObjectRefGenerator
from ray_tpu_torch._private.worker import (
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

_LAZY_SUBMODULES = ("models", "ops")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def remote(*args, **kwargs):
    """Decorator turning a function into a RemoteFunction or a class into an
    ActorClass. Usable bare (`@remote`) or with options
    (`@remote(num_cpus=2, num_gpus=1)`)."""

    def decorate(obj):
        if isinstance(obj, type):
            return ActorClass(obj, **kwargs)
        return RemoteFunction(obj, **kwargs)

    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        return decorate(args[0])
    if args:
        raise TypeError("remote() takes keyword options only, e.g. @remote(num_cpus=2)")
    return decorate


def method(**kwargs):
    """Decorator for actor methods to set defaults (e.g. num_returns)."""

    def deco(fn):
        fn._method_options = kwargs
        return fn

    return deco


__all__ = [
    "init",
    "shutdown",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "cancel",
    "kill",
    "ObjectRefGenerator",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "is_initialized",
    "ObjectRef",
    "ActorClass",
    "ActorHandle",
    "RemoteFunction",
    "RayTpuError",
    "TaskError",
    "ActorDiedError",
    "ActorUnavailableError",
    "WorkerCrashedError",
    "ObjectLostError",
    "ObjectReconstructionFailedError",
    "GetTimeoutError",
    "TaskCancelledError",
    "PlacementGroupError",
    "models",
    "ops",
]
