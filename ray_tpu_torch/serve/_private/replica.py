"""Replica actor: hosts one copy of a user deployment.

Analog of python/ray/serve/_private/replica.py (ReplicaActor:231): wraps the
user callable, tracks ongoing-request count (consumed by the pow-2 router and
the autoscaler), exposes health checks and reconfigure.

Continuous dynamic batching (reference: @serve.batch; Orca-style iteration
scheduling, Yu et al. OSDI'22): when max_batch_size > 1, concurrent requests
to the same method are coalesced into one user-code call that receives a
LIST of inputs and must return a list of the same length. A batch launches
when it fills or batch_wait_timeout_s after its first request arrives — and
the NEXT batch keeps forming while in-flight batches execute, so admission
into batch N+1 overlaps batch N's compute (the "continuous" part).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import telemetry
from ray_tpu_torch._private.rpc import spawn as _spawn
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


class _BatchItem:
    __slots__ = ("value", "future", "enqueued_at", "enqueued_wall", "trace_ctx")

    def __init__(self, value, future, enqueued_at):
        self.value = value
        self.future = future
        self.enqueued_at = enqueued_at
        self.enqueued_wall = time.time()
        # Captured at submit: the pump/batch tasks run in the PUMP's
        # context, so the request's trace would be lost at the queue hop
        # without pinning it here (the batch counterpart of the
        # run_in_executor gap set_context documents).
        self.trace_ctx = tracing.current_context()


_TEL_BATCH_SIZE = telemetry.histogram(
    "serve", "batch_size",
    "dynamic-batch sizes launched by replica batch queues",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
).default


class _BatchStats:
    """Batch-size / queue-age counters, exposed via Replica.get_metrics."""

    __slots__ = (
        "batches",
        "requests",
        "size_max",
        "queue_age_sum_s",
        "queue_age_max_s",
    )

    def __init__(self):
        self.batches = 0
        self.requests = 0
        self.size_max = 0
        self.queue_age_sum_s = 0.0
        self.queue_age_max_s = 0.0

    def observe(self, size: int, oldest_age_s: float) -> None:
        self.batches += 1
        self.requests += size
        self.size_max = max(self.size_max, size)
        self.queue_age_sum_s += oldest_age_s
        self.queue_age_max_s = max(self.queue_age_max_s, oldest_age_s)
        _TEL_BATCH_SIZE.observe(size)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batches": self.batches,
            "requests": self.requests,
            "size_max": self.size_max,
            "size_avg": (self.requests / self.batches) if self.batches else 0.0,
            "queue_age_avg_s": (
                self.queue_age_sum_s / self.batches if self.batches else 0.0
            ),
            "queue_age_max_s": self.queue_age_max_s,
        }


class _BatchQueue:
    """One per (replica, method): forms batches continuously.

    The pump loop never blocks on execution — it hands a formed batch to a
    spawned task (bounded by ``max_concurrent_batches``) and immediately
    starts collecting the next one, so new requests are admitted into the
    next batch while in-flight ones complete.
    """

    def __init__(
        self,
        method,
        max_batch_size: int,
        batch_wait_timeout_s: float,
        max_concurrent_batches: int,
        stats: _BatchStats,
    ):
        self._method = method
        self._max = max(1, max_batch_size)
        self._wait = max(0.0, batch_wait_timeout_s)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._sem = asyncio.Semaphore(max(1, max_concurrent_batches))
        self._stats = stats
        self._pump_task = _spawn(self._pump())

    def close(self) -> None:
        self._pump_task.cancel()

    async def submit(self, value: Any) -> Any:
        loop = asyncio.get_running_loop()
        item = _BatchItem(value, loop.create_future(), loop.time())
        self._queue.put_nowait(item)
        try:
            return await item.future
        except asyncio.CancelledError:
            # Cut at the wire deadline before dispatch: the pump drops
            # cancelled futures when forming, so a dead request never
            # occupies a batch slot.
            item.future.cancel()
            raise

    def _take_live(self, item: Optional[_BatchItem]) -> Optional[_BatchItem]:
        if item is None or item.future.done():
            return None
        return item

    async def _pump(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = self._take_live(await self._queue.get())
            if first is None:
                continue
            batch = [first]
            start = loop.time()
            while len(batch) < self._max:
                remaining = self._wait - (loop.time() - start)
                if remaining <= 0:
                    break
                try:
                    item = self._take_live(
                        await asyncio.wait_for(
                            self._queue.get(), timeout=remaining
                        )
                    )
                except asyncio.TimeoutError:
                    break
                if item is not None:
                    batch.append(item)
            # Bound in-flight batches; formation of the next batch resumes
            # as soon as the spawn below is off our hands.
            await self._sem.acquire()
            self._stats.observe(len(batch), loop.time() - batch[0].enqueued_at)
            task = _spawn(self._run_batch(batch))
            task.add_done_callback(lambda _t: self._sem.release())

    async def _run_batch(self, batch: List[_BatchItem]) -> None:
        inputs = [item.value for item in batch]
        # Per-item queue-wait spans (enqueue -> batch launch), each parented
        # into ITS OWN request's trace; the execute span below is parented
        # to the first traced item (a span has one parent — the other
        # members' waits still link their traces to this batch).
        lead_ctx = None
        now = time.time()
        for item in batch:
            if item.trace_ctx is not None:
                if lead_ctx is None:
                    lead_ctx = item.trace_ctx
                tracing.record_span(
                    "serve.batch_wait",
                    "serve",
                    item.enqueued_wall,
                    now - item.enqueued_wall,
                    ctx=item.trace_ctx,
                )
        token = tracing.set_context(lead_ctx)
        t0 = time.time()
        try:
            if inspect.iscoroutinefunction(self._method):
                results = await self._method(inputs)
            else:
                loop = asyncio.get_running_loop()
                # copy_context AFTER the trace set: the batch's trace context
                # must follow the user method onto the executor thread.
                ctx = contextvars.copy_context()
                results = await loop.run_in_executor(
                    None, lambda: ctx.run(self._method, inputs)
                )
            if not isinstance(results, (list, tuple)) or len(results) != len(
                batch
            ):
                raise TypeError(
                    f"batched method returned "
                    f"{type(results).__name__} of length "
                    f"{len(results) if isinstance(results, (list, tuple)) else '?'}"
                    f"; expected a list of {len(batch)} results"
                )
        except Exception as e:
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(e)
            return
        finally:
            tracing.reset_context(token)
            if lead_ctx is not None:
                tracing.record_span(
                    "serve.batch_execute",
                    "serve",
                    t0,
                    time.time() - t0,
                    ctx=lead_ctx,
                    size=len(batch),
                )
        for item, result in zip(batch, results):
            if not item.future.done():
                item.future.set_result(result)


class Replica:
    """The actor class the controller instantiates per replica."""

    def __init__(
        self,
        serialized_cls: bytes,
        init_args: Tuple,
        init_kwargs: Dict,
        deployment_id_str: str,
        replica_id_str: str,
        user_config: Any = None,
        max_batch_size: int = 1,
        batch_wait_timeout_s: float = 0.01,
        max_ongoing_requests: int = 16,
    ):
        cls = cloudpickle.loads(serialized_cls)
        self._deployment_id_str = deployment_id_str
        self._replica_id_str = replica_id_str
        self._num_ongoing = 0
        self._total_served = 0
        self._shutting_down = False
        self._max_batch_size = max(1, int(max_batch_size))
        self._batch_wait_timeout_s = float(batch_wait_timeout_s)
        self._max_ongoing_requests = max(1, int(max_ongoing_requests))
        self._batch_queues: Dict[str, _BatchQueue] = {}
        self._batch_stats = _BatchStats()
        if inspect.isfunction(cls):
            # Function deployments: wrap into a callable instance.
            fn = cls

            class _FnWrapper:
                def __call__(self, *a, **k):
                    return fn(*a, **k)

            self._user = _FnWrapper()
        else:
            self._user = cls(*init_args, **init_kwargs)
        if user_config is not None:
            self._apply_reconfigure(user_config)

    def _apply_reconfigure(self, user_config: Any) -> None:
        reconfigure = getattr(self._user, "reconfigure", None)
        if reconfigure is None:
            raise RuntimeError(
                "user_config was set but the deployment has no reconfigure()"
            )
        reconfigure(user_config)

    # -- data plane ----------------------------------------------------------

    def _batch_queue_for(self, method_name: str) -> _BatchQueue:
        bq = self._batch_queues.get(method_name)
        if bq is None:
            bq = _BatchQueue(
                getattr(self._user, method_name),
                self._max_batch_size,
                self._batch_wait_timeout_s,
                # Leave headroom so the next batch executes while the current
                # one is in flight, without exceeding the replica's overall
                # concurrency budget.
                max_concurrent_batches=max(
                    1, self._max_ongoing_requests // self._max_batch_size
                ),
                stats=self._batch_stats,
            )
            self._batch_queues[method_name] = bq
        return bq

    async def handle_request(
        self, request_meta: Dict[str, Any], args: Tuple, kwargs: Dict
    ) -> Any:
        """Run one request through the user callable. Called concurrently up
        to max_ongoing_requests (actor max_concurrency)."""
        self._num_ongoing += 1
        self._total_served += 1
        model_id = request_meta.get("multiplexed_model_id")
        if model_id:
            # Visible to @serve.multiplexed loaders via
            # serve.get_multiplexed_model_id() (reference: replica context).
            from ray_tpu_torch.serve import api as serve_api

            serve_api._multiplexed_model_id_ctx.set(model_id)
        try:
            method_name = request_meta.get("call_method", "__call__")
            # Batchable shape: single positional payload, no kwargs, no
            # per-request model id (multiplexed requests must not be fused
            # across models).
            if (
                self._max_batch_size > 1
                and len(args) == 1
                and not kwargs
                and not model_id
            ):
                return await self._batch_queue_for(method_name).submit(args[0])
            method = getattr(self._user, method_name)
            if inspect.iscoroutinefunction(method):
                return await method(*args, **kwargs)
            loop = asyncio.get_running_loop()
            # copy_context: contextvars (multiplexed model id) must follow
            # the call onto the executor thread.
            ctx = contextvars.copy_context()
            return await loop.run_in_executor(
                None, lambda: ctx.run(method, *args, **kwargs)
            )
        finally:
            self._num_ongoing -= 1

    def handle_request_streaming(
        self, request_meta: Dict[str, Any], args: Tuple, kwargs: Dict
    ):
        """Streaming data plane: the user handler is a (possibly async)
        generator; each yielded item is published through the runtime's
        streaming-generator machinery as it is produced, so the proxy
        forwards chunks while the replica is still generating (reference:
        replica.py handle_request_streaming + ReportGeneratorItemReturns).

        This is a SYNC generator actor method (invoked with
        num_returns="dynamic"); it runs on the executor pool, pumping async
        generators via the worker's event loop."""
        self._num_ongoing += 1
        self._total_served += 1
        model_id = request_meta.get("multiplexed_model_id")

        def _set_model_ctx():
            # Each resume of this generator may land on a DIFFERENT executor
            # thread (every next() is its own run_in_executor dispatch), so
            # the contextvar must be re-set on the current thread before the
            # user frame runs — a single set at creation time would be lost
            # across hops and could leak onto unrelated requests.
            if model_id:
                from ray_tpu_torch.serve import api as serve_api

                serve_api._multiplexed_model_id_ctx.set(model_id)

        try:
            _set_model_ctx()
            method_name = request_meta.get("call_method", "__call__")
            method = getattr(self._user, method_name)
            result = method(*args, **kwargs)
            if inspect.isasyncgen(result):
                from ray_tpu_torch._private import worker as worker_mod

                loop = worker_mod._core().loop

                async def _anext():
                    _set_model_ctx()
                    return await result.__anext__()

                while True:
                    fut = asyncio.run_coroutine_threadsafe(_anext(), loop)
                    try:
                        yield fut.result()
                    except StopAsyncIteration:
                        break
            elif inspect.isgenerator(result):
                while True:
                    _set_model_ctx()
                    try:
                        item = next(result)
                    except StopIteration:
                        break
                    yield item
            elif inspect.iscoroutine(result):
                from ray_tpu_torch._private import worker as worker_mod

                loop = worker_mod._core().loop
                yield asyncio.run_coroutine_threadsafe(result, loop).result()
            else:
                yield result
        finally:
            self._num_ongoing -= 1

    # -- control plane -------------------------------------------------------

    async def get_metrics(self) -> Dict[str, Any]:
        return {
            "replica_id": self._replica_id_str,
            "num_ongoing_requests": self._num_ongoing,
            "total_served": self._total_served,
            "batch": self._batch_stats.to_dict(),
        }

    async def check_health(self) -> bool:
        user_check = getattr(self._user, "check_health", None)
        if user_check is not None:
            if inspect.iscoroutinefunction(user_check):
                await user_check()
            else:
                user_check()
        return True

    async def reconfigure(self, user_config: Any) -> None:
        self._apply_reconfigure(user_config)

    async def prepare_for_shutdown(self, timeout_s: float = 10.0) -> None:
        """Drain: wait for ongoing requests to finish (graceful shutdown,
        reference replica.py perform_graceful_shutdown)."""
        self._shutting_down = True
        for bq in self._batch_queues.values():
            bq.close()
        deadline = asyncio.get_running_loop().time() + timeout_s
        while self._num_ongoing > 0:
            if asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.05)
        user_del = getattr(self._user, "__del__", None)
        if user_del is not None:
            try:
                user_del()
            except Exception:
                pass
