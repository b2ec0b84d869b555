"""Actor API: ActorClass / ActorHandle / ActorMethod.

Analog of python/ray/actor.py: `@ray_tpu_torch.remote` on a class yields an
ActorClass; `.remote(...)` asks the GCS to create the actor (GCS owns the
placement and restart FSM); the returned ActorHandle submits method calls
directly to the actor worker with per-handle sequence numbers. Handles
serialize as bare actor ids — any process re-attaches via its own core worker.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.remote_function import _build_resources, _strategy_fields


class ActorMethod:
    def __init__(
        self,
        handle: "ActorHandle",
        name: str,
        num_returns: int = 1,
        max_task_retries: Optional[int] = None,
        concurrency_group: Optional[str] = None,
    ):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._max_task_retries = max_task_retries
        self._concurrency_group = concurrency_group

    def options(
        self,
        *,
        num_returns: int = 1,
        max_task_retries: Optional[int] = None,
        concurrency_group: Optional[str] = None,
    ) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._name, num_returns, max_task_retries,
            concurrency_group,
        )

    def remote(self, *args, **kwargs):
        retries = (
            self._max_task_retries
            if self._max_task_retries is not None
            else self._handle._max_task_retries
        )
        w = worker_mod.global_worker
        if w.mode == "client":
            refs = w.client.call_actor_method(
                self._handle._actor_id, self._name, args, kwargs,
                num_returns=self._num_returns, max_task_retries=retries,
                concurrency_group=self._concurrency_group,
            )
            return refs[0] if self._num_returns in (1, -1, "dynamic") else refs
        core = worker_mod._core()
        refs = core.try_submit_actor_task_fast(
            self._handle._actor_id,
            self._name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=retries,
            concurrency_group=self._concurrency_group,
            loop=worker_mod.global_worker.loop,
        )
        if refs is None:  # large args need the async plasma path
            refs = worker_mod.global_worker.run_async(
                core.submit_actor_task(
                    self._handle._actor_id,
                    self._name,
                    args,
                    kwargs,
                    num_returns=self._num_returns,
                    max_task_retries=retries,
                    concurrency_group=self._concurrency_group,
                )
            )
        if self._num_returns in (1, -1, "dynamic"):
            # Dynamic generator calls resolve through ONE ref whose value is
            # the ObjectRefGenerator.
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG construction for compiled graphs (ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag.nodes import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name!r} cannot be called directly; use .remote()"
        )


class ActorHandle:
    def __init__(self, actor_id: str, max_task_retries: int = 0):
        self._actor_id = actor_id
        # Default per-method retry budget (reference: @ray.remote
        # max_task_retries on the actor class; rides handle serialization).
        self._max_task_retries = max_task_retries

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:16]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self._pickled: Optional[bytes] = None
        functools.update_wrapper(self, cls, updated=[])

    def _get_pickled(self) -> bytes:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._cls)
        return self._pickled

    def options(self, **options) -> "ActorClass":
        merged = {**self._options, **options}
        clone = ActorClass(self._cls, **merged)
        clone._pickled = self._pickled
        return clone

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._options
        w = worker_mod.global_worker
        if w.mode == "client":
            return w.client.create_actor(self, args, kwargs)
        core = worker_mod._core()
        pg_id, bundle_index, strategy = _strategy_fields(opts)
        resources = _build_resources(opts)
        actor_id = worker_mod.global_worker.run_async(
            core.create_actor(
                self._get_pickled(),
                opts.get("name_override") or self._cls.__name__,
                args,
                kwargs,
                resources=resources,
                max_restarts=opts.get("max_restarts", 0),
                max_concurrency=opts.get("max_concurrency", 1),
                max_task_retries=opts.get("max_task_retries", 0),
                concurrency_groups=opts.get("concurrency_groups"),
                name=opts.get("name"),
                namespace=opts.get("namespace") or worker_mod.global_worker.namespace,
                lifetime=opts.get("lifetime"),
                get_if_exists=opts.get("get_if_exists", False),
                pg_id=pg_id,
                bundle_index=bundle_index,
                scheduling_strategy=strategy,
                runtime_env=opts.get("runtime_env"),
            ),
            timeout=300,
        )
        return ActorHandle(actor_id, opts.get("max_task_retries", 0))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__!r} cannot be instantiated directly; "
            "use .remote()"
        )
