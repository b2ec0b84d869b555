"""@ray_tpu_torch.remote functions.

Analog of python/ray/remote_function.py: RemoteFunction wraps the user function,
pickles it once, and `_remote` submits through the core worker.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private import worker as worker_mod


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
    elif "CPU" not in resources:
        resources["CPU"] = 1.0
    if opts.get("num_gpus") is not None:
        resources["GPU"] = float(opts["num_gpus"])
    if opts.get("memory") is not None:
        resources["memory"] = float(opts["memory"])
    return resources


def _strategy_fields(opts):
    """Extract (pg_id, bundle_index, strategy_dict) from scheduling options."""
    pg_id, bundle_index, strategy = None, -1, None
    ss = opts.get("scheduling_strategy")
    if ss == "SPREAD":
        # Reference: scheduling_strategy="SPREAD" places tasks on the
        # least-loaded feasible nodes (scheduling_options.h SPREAD).
        return None, -1, {"spread": True}
    if ss == "DEFAULT":
        return None, -1, None
    if ss is not None:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
            NodeLabelSchedulingStrategy,
            PlacementGroupSchedulingStrategy,
        )

        if isinstance(ss, PlacementGroupSchedulingStrategy):
            pg_id = ss.placement_group.id_hex
            bundle_index = ss.placement_group_bundle_index
        elif isinstance(ss, NodeAffinitySchedulingStrategy):
            strategy = {"node_id": ss.node_id, "soft": ss.soft}
        elif isinstance(ss, NodeLabelSchedulingStrategy):
            strategy = ss.to_wire()
        elif isinstance(ss, dict):
            strategy = ss
    if opts.get("placement_group") is not None:
        pg_id = opts["placement_group"].id_hex
        bundle_index = opts.get("placement_group_bundle_index", -1)
    return pg_id, bundle_index, strategy


class RemoteFunction:
    def __init__(self, fn, **options):
        import asyncio

        self._fn = fn
        self._options = options
        self._pickled: Optional[bytes] = None
        # Per-call-invariant submission fields, computed once (the resource
        # fixed-point conversion and strategy unpacking are hot-path costs).
        self._res_units: Optional[Dict[str, int]] = None
        self._strategy_cache = None
        # Coroutine functions need the worker's event loop — permanently
        # ineligible for the native fastpath (gating here avoids a
        # per-call status-4 bounce off the worker).
        self._no_fastpath = asyncio.iscoroutinefunction(fn)
        functools.update_wrapper(self, fn)

    def _get_pickled(self) -> bytes:
        if self._pickled is None:
            self._pickled = cloudpickle.dumps(self._fn)
        return self._pickled

    def options(self, **options) -> "RemoteFunction":
        merged = {**self._options, **options}
        clone = RemoteFunction(self._fn, **merged)
        clone._pickled = self._pickled
        return clone

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs)

    def bind(self, *args, **kwargs):
        """Lazy task node for workflows (ray_tpu_torch.workflow.run(fn.bind(...)))."""
        from ray_tpu_torch.workflow.api import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _remote(self, args, kwargs):
        opts = self._options
        w = worker_mod.global_worker
        if w.mode == "client":
            refs = w.client.submit_remote_function(self, args, kwargs)
            num_returns = opts.get("num_returns", 1)
            return refs[0] if num_returns in (1, "dynamic") else refs
        core = worker_mod._core()
        if self._strategy_cache is None:
            self._strategy_cache = _strategy_fields(opts)
        pg_id, bundle_index, strategy = self._strategy_cache
        if self._res_units is None:
            from ray_tpu_torch._private.common import ResourceSet

            self._res_units = ResourceSet(_build_resources(opts)).to_units()
        name = opts.get("name") or getattr(self._fn, "__name__", "task")
        # Thread-side fast path: skips the run_coroutine_threadsafe round trip
        # (the dominant cost of .remote()); falls back for first-call export,
        # runtime envs, and plasma-sized args.
        refs = core.try_submit_task_fast(
            self._get_pickled(),
            name,
            args,
            kwargs,
            loop=worker_mod.global_worker.loop,
            num_returns=opts.get("num_returns", 1),
            resources_units=self._res_units,
            max_retries=opts.get("max_retries"),
            retry_exceptions=opts.get("retry_exceptions", False),
            pg_id=pg_id,
            bundle_index=bundle_index,
            scheduling_strategy=strategy,
            runtime_env=opts.get("runtime_env"),
            no_fastpath=self._no_fastpath,
        )
        if refs is None:
            refs = worker_mod.global_worker.run_async(
                core.submit_task(
                    self._get_pickled(),
                    name,
                    args,
                    kwargs,
                    num_returns=opts.get("num_returns", 1),
                    resources=_build_resources(opts),
                    max_retries=opts.get("max_retries"),
                    retry_exceptions=opts.get("retry_exceptions", False),
                    pg_id=pg_id,
                    bundle_index=bundle_index,
                    scheduling_strategy=strategy,
                    runtime_env=opts.get("runtime_env"),
                )
            )
        num_returns = opts.get("num_returns", 1)
        if num_returns == 1 or num_returns == "dynamic":
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__!r} cannot be called directly; "
            "use .remote()"
        )
