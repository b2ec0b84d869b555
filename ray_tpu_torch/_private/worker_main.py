"""Worker process entrypoint: executes tasks and hosts actors.

Analog of the reference's default_worker.py + the Cython task-execution handler
(python/ray/_raylet.pyx:2251 execute_task path): the asyncio loop owns RPC; user
task code runs on executor threads (sync) or directly on the loop (async actor
methods). Ordered actor execution follows the per-caller sequence-number design
of the reference's ActorSchedulingQueue.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import ctypes
import inspect
import logging
import os
import sys
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private import rpc, serialization, telemetry
from ray_tpu_torch._private.common import TaskError, TaskSpec, config
from ray_tpu_torch._private.core_worker import CoreWorker, ObjectRef
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

# Max unacked streamed generator items in flight to the owner (reference:
# _generator_backpressure_num_objects).
_GEN_BACKPRESSURE_WINDOW = 16


def _deadline_stats_delta(worker_id: str) -> Optional[dict]:
    """Snapshot-and-reset the process deadline counters as a wire delta.

    Runs on the event loop with no awaits between read and reset, so no
    enforcement event can land in the gap and be lost or double-counted.
    Returns None when there is nothing to report.
    """
    st = rpc.deadline_stats
    if not (st.met or st.shed or st.enforced or st.overruns):
        return None
    delta = {
        "met": st.met,
        "shed": st.shed,
        "enforced": st.enforced,
        "overruns": [[m, float(late)] for m, late in st.overruns],
        "worker_id": worker_id,
    }
    st.reset()
    return delta


def _restore_deadline_delta(delta: dict) -> None:
    """Fold an undelivered delta back into the local counters so the next
    flush carries it. If the report actually landed and only the reply was
    lost, counters double-count (ReportDeadlineStats is RETRY_NONE for the
    same reason) — acceptable for telemetry, and an overrun re-reported
    twice still flags the same real violation."""
    st = rpc.deadline_stats
    st.met += delta["met"]
    st.shed += delta["shed"]
    st.enforced += delta["enforced"]
    st.overruns.extend((m, late) for m, late in delta["overruns"])


class _ExecThread:
    """Dedicated execution thread with reply batching.

    The task/actor hot path never crosses loop<->thread per call the way
    run_in_executor does: the RPC layer enqueues work items straight from
    data_received (sync handler), the thread executes back-to-back, and
    completed replies are flushed to the event loop in coalesced batches
    (one call_soon_threadsafe per burst). Analog of the reference's
    dedicated actor-scheduling-queue execution thread
    (transport/actor_scheduling_queue.cc).
    """

    def __init__(self, executor: "Executor", loop: asyncio.AbstractEventLoop):
        import queue

        self.executor = executor
        self.loop = loop
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.replies: list = []
        self._reply_wake = False
        self.thread = threading.Thread(
            target=self._run, name="ray_tpu_torch_exec", daemon=True
        )
        self.thread.start()

    def submit(self, conn, msgid: int, method: str, wire: dict) -> None:
        self.q.put((conn, msgid, method, wire))

    def _run(self) -> None:
        ex = self.executor
        while True:
            item = self.q.get()
            if item is None:
                return
            conn, msgid, method, wire = item
            task_id = wire.get("task_id", "")
            if task_id in ex.cancelled_tasks:
                ex.cancelled_tasks.pop(task_id, None)
                from ray_tpu_torch._private.common import TaskCancelledError

                self.replies.append(
                    (conn, msgid, method,
                     {"error": ex._error_payload(TaskCancelledError("task cancelled"))})
                )
                if not self._reply_wake:
                    self._reply_wake = True
                    self.loop.call_soon_threadsafe(self._drain_replies)
                continue
            track = ex.running_tasks[task_id] = {
                "thread_id": threading.get_ident(),
                "async_task": None,
            }
            try:
                payload = ex._execute_sync(wire, conn)
            except BaseException as e:  # noqa: BLE001 - serialize any failure
                if isinstance(e, SystemExit):
                    self.loop.call_soon_threadsafe(
                        self.loop.call_later, 0.1, os._exit, 0
                    )
                    payload = {
                        "error": ex._error_payload(RuntimeError("actor exited"))
                    }
                else:
                    payload = {"error": ex._error_payload(e)}
            finally:
                ex.running_tasks.pop(wire.get("task_id", ""), None)
            self.replies.append((conn, msgid, method, payload))
            if not self._reply_wake:
                self._reply_wake = True
                self.loop.call_soon_threadsafe(self._drain_replies)

    def _drain_replies(self) -> None:
        self._reply_wake = False
        batch, self.replies = self.replies, []
        for conn, msgid, method, payload in batch:
            conn.reply_nowait(msgid, method, payload)

    def run_on_loop(self, coro):
        """Blockingly run a coroutine on the event loop (slow aspects of an
        otherwise thread-executed call: ref resolution, plasma writes)."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()


class Executor:
    """Task/actor execution engine wired onto a CoreWorker."""

    def __init__(self, core: CoreWorker):
        self.core = core
        self.fn_cache: Dict[str, Any] = {}
        self.actor_instance: Any = None
        self.actor_spec: Optional[dict] = None
        self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        # Per-caller ordered execution state for the sync single-concurrency
        # actor path (reference: sequential_actor_submit_queue.cc).
        self.expected_seq: Dict[str, int] = {}
        self.pending_seq: Dict[str, Dict[int, asyncio.Future]] = {}
        self.exec_lock = asyncio.Lock()
        # task_id -> {"thread_id": int|None, "async_task": Task|None}
        self.running_tasks: Dict[str, dict] = {}
        self._exec_thread: Optional[_ExecThread] = None
        # True when the hosted actor has no coroutine methods (set at
        # creation); gates the exec-thread fast path.
        self.actor_all_sync = False
        # Concurrency groups (set at actor creation when declared).
        self.cgroup_sems = None
        self.cgroup_pools = None
        # Tasks cancelled before they started executing (they may still be
        # queued behind a running task on this worker — pipelined dispatch).
        # Bounded: best-effort markers for races with finished tasks must not
        # accumulate forever.
        self.cancelled_tasks: "OrderedDict[str, None]" = OrderedDict()
        # Event loop handle for the native fastpath callback's plasma hop.
        self._fp_loop: Optional[asyncio.AbstractEventLoop] = None
        core.server.register("PushTask", self.handle_push_task)
        core.server.register("PushActorTask", self.handle_push_actor_task)
        core.server.register("CreateActor", self.handle_create_actor)
        core.server.register("CancelTask", self.handle_cancel_task)
        core.server.register("Exit", self.handle_exit)
        core.server.register_sync("PushTask", self._sync_push_task)
        core.server.register_sync("PushActorTask", self._sync_push_actor_task)

    # -- native fastpath (ray_tpu_torch._native._fastpath server callback) ---------

    def fastpath_exec(self, tid: bytes, fid: bytes, name: bytes, blob: bytes):
        """Execute one task for the native direct-call channel.

        Runs on the extension's connection thread with the GIL held (the
        C++ side serializes execution per connection, matching the sync
        exec-thread semantics). Statuses: 0 ok (payload = inline serialized
        value), 1 error (payload = serialized exception), 4 function not
        cached here (driver re-sends via the RPC path, which populates the
        cache), 6 large result stored in plasma (payload = pickled returns
        descriptor).
        """
        import pickle

        from ray_tpu_torch._private.ids import return_object_ids

        try:
            fn = self.fn_cache.get(fid.decode())
            if fn is None or asyncio.iscoroutinefunction(fn):
                # Unknown here, or a coroutine function (needs the event
                # loop): the driver re-sends via the RPC path.
                return (4, b"")
            with serialization.DeserializationContext(
                ref_deserializer=self.core._deserialize_ref
            ):
                (args, kwargs), _ = serialization.deserialize(blob)
            result = fn(*args, **kwargs)
            serialized = serialization.serialize(result)
            if serialized.total_size <= config.max_direct_call_object_size:
                # bytes() wrap: the C++ side reads the payload with
                # PyBytes_AsStringAndSize, which rejects bytearray.
                return (0, bytes(serialized.to_bytes()))
            # Large return: plasma write via the worker loop, then the same
            # returns descriptor the RPC path uses.
            oid = return_object_ids(tid.decode(), 1)[0]
            asyncio.run_coroutine_threadsafe(
                self.core.plasma.put_serialized(oid, serialized),
                self._fp_loop,
            ).result(timeout=60)
            return (6, pickle.dumps({"plasma": list(self.core.raylet_addr)}))
        except BaseException as e:  # noqa: BLE001 - must serialize any failure
            return (1, self._error_payload(e))

    # -- sync fast-path dispatch (called inline from data_received) ----------

    def _exec(self) -> _ExecThread:
        t = self._exec_thread
        if t is None:
            t = self._exec_thread = _ExecThread(self, asyncio.get_running_loop())
        return t

    def _fallback_async(self, conn, msgid, method, handler, payload) -> None:
        async def run():
            try:
                result = await handler(conn, payload)
            except Exception as e:
                conn.reply_error_nowait(
                    msgid, method, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
                )
                return
            conn.reply_nowait(msgid, method, result)

        rpc.spawn(run())

    def _sync_push_actor_task(self, conn, msgid, p) -> None:
        wire = p["spec"]
        if (
            self.actor_all_sync
            and self.cgroup_sems is None
            and self.actor_instance is not None
            and (self.actor_spec or {}).get("max_concurrency", 1) == 1
            and wire.get("actor_method") != "__rt_dag_loop__"
        ):
            # Ordered all-sync actor: every call funnels through the exec
            # thread in arrival order (= per-caller seq order), which enforces
            # the sequencing the async path needed futures for. Actors with
            # coroutine methods stay on the loop path — their awaits must
            # interleave across callers (e.g. rendezvous patterns).
            # Advance the async path's seq ledger now: a later call routed
            # through handle_push_actor_task (__rt_dag_loop__, restarts) must
            # not wait on a turn the exec thread will never signal.
            seq = wire.get("seq_no", -1)
            if seq >= 0:
                self._advance_seq(wire.get("caller_id") or "anon", seq)
            self._exec().submit(conn, msgid, "PushActorTask", wire)
            return
        self._fallback_async(conn, msgid, "PushActorTask", self.handle_push_actor_task, p)

    def _sync_push_task(self, conn, msgid, p) -> None:
        wire = p["spec"]
        fn = self.fn_cache.get(wire.get("func_id"))
        renv = wire.get("runtime_env") or {}
        if (
            fn is not None
            and not asyncio.iscoroutinefunction(fn)
            and wire.get("args_blob") is not None
            and not wire.get("ref_positions")
            and not wire.get("kw_ref_keys")
            and wire.get("num_returns") != -1
            and not renv.get("working_dir")
            and not renv.get("py_modules")
            and not renv.get("pip")
            and not renv.get("conda")
        ):
            self._exec().submit(conn, msgid, "PushTask", wire)
            return
        self._fallback_async(conn, msgid, "PushTask", self.handle_push_task, p)

    def _execute_sync(self, wire: dict, conn=None):
        """Run one task/actor call on the exec thread; returns the reply
        payload. Slow aspects (ref args, plasma-resident args/returns) hop to
        the event loop via run_on_loop."""
        core = self.core
        profile = config.task_profile_events
        t0 = time.time()
        exec_t = self._exec_thread
        actor_method = wire.get("actor_method")
        if actor_method is not None:
            fn = getattr(self.actor_instance, actor_method)
        else:
            fn = self.fn_cache[wire["func_id"]]
        # -- arguments
        if (
            wire.get("args_blob") is not None
            and not wire.get("ref_positions")
            and not wire.get("kw_ref_keys")
        ):
            with serialization.DeserializationContext(
                ref_deserializer=core._deserialize_ref
            ):
                (args, kwargs), _ = serialization.deserialize(wire["args_blob"])
        else:
            t_fetch = time.time()
            args, kwargs = exec_t.run_on_loop(self.load_args(wire))
            if "trace_ctx" in wire:
                tracing.record_span(
                    "task.arg_fetch",
                    "arg_fetch",
                    t_fetch,
                    time.time() - t_fetch,
                    ctx=tracing.ctx_from_wire(wire),
                    task_id=wire["task_id"],
                )
        t_args = time.time()
        # -- execute
        renv = wire.get("runtime_env") or {}
        env_vars = renv.get("env_vars")
        # Manual scope: it must stay open through the generator-drain branch
        # below (a streaming task's body runs during iteration, not at
        # fn() time), so nested submits keep the trace context and the
        # execute span covers real execution. Gated on the wire key so the
        # disabled case costs one dict lookup (this is the 10k+ tasks/s
        # fast path).
        trace_scope = (
            tracing.execute_scope(core, wire) if "trace_ctx" in wire else None
        )
        if trace_scope is not None:
            trace_scope.__enter__()
        try:
            if env_vars:
                from ray_tpu_torch.runtime_env.context import scoped_env_vars

                with scoped_env_vars(env_vars):
                    result = (
                        exec_t.run_on_loop(fn(*args, **kwargs))
                        if asyncio.iscoroutinefunction(fn)
                        else fn(*args, **kwargs)
                    )
            elif asyncio.iscoroutinefunction(fn):
                result = exec_t.run_on_loop(fn(*args, **kwargs))
            else:
                result = fn(*args, **kwargs)
            t_exec = time.time()
            # -- returns (inside the trace scope: generator bodies run here)
            reply, t_exec = self._sync_returns(wire, result, conn, t_exec)
        finally:
            if trace_scope is not None:
                trace_scope.__exit__(None, None, None)
        if profile:
            # Per-task phase spans (reference: worker profile events in the
            # chrome timeline, RAY_PROFILING + profiling.py).
            core.record_task_event(
                wire["task_id"],
                wire["name"],
                "PROFILE",
                start=t0,
                phases={
                    "deserialize_args": t_args - t0,
                    "execute": t_exec - t_args,
                    "store_returns": time.time() - t_exec,
                },
            )
        return reply

    def _sync_returns(self, wire: dict, result, conn, t_exec):
        """Store the result(s) of an exec-thread call; returns (reply,
        t_exec). Runs INSIDE the trace scope: a streaming generator's body
        executes during the drain loop here, not at fn() time."""
        exec_t = self._exec_thread
        num_returns = wire["num_returns"]
        if num_returns == 0:
            return {"returns": []}, t_exec
        if num_returns == -1 and inspect.isgenerator(result):
            # Streaming generator on the exec thread: store + push each item
            # as produced (same GeneratorItem protocol as the async path).
            # Window of unacked pushes bounds the owner's buffering when the
            # consumer is slower than the producer (reference:
            # _generator_backpressure_num_objects).
            idx = 0
            inflight: list = []
            for item in result:
                ret = self._store_one_sync(self._dyn_oid(wire, idx), item)
                fut = asyncio.run_coroutine_threadsafe(
                    self._send_generator_item(
                        conn, wire["task_id"], idx, ret[0]
                    ),
                    exec_t.loop,
                )
                inflight.append(fut)
                if len(inflight) >= _GEN_BACKPRESSURE_WINDOW:
                    for f in inflight:
                        f.result()  # acks double as flow-control tokens
                    inflight = []
                idx += 1
            for f in inflight:
                f.result()
            # Generator execution IS the drain; restate t_exec so the
            # PROFILE store_returns phase doesn't swallow it.
            return {"dynamic_count": idx}, time.time()
        if num_returns == -1:
            num_returns = 1
        values = [result] if num_returns == 1 else list(result)
        if num_returns != 1 and len(values) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{len(values)}"
            )
        out = []
        for oid, value in zip(wire["return_ids"], values):
            out.extend(self._store_one_sync(oid, value))
        return {"returns": out}, t_exec

    def _store_one_sync(self, oid: str, value) -> list:
        serialized = serialization.serialize(value)
        if serialized.total_size <= config.max_direct_call_object_size:
            return [{"inline": serialized.to_bytes()}]
        self._exec_thread.run_on_loop(self.core.plasma.put_serialized(oid, serialized))
        return [{"plasma": list(self.core.raylet_addr)}]

    # -- function table ------------------------------------------------------

    async def get_function(self, func_id: str):
        fn = self.fn_cache.get(func_id)
        if fn is None:
            blob = await self.core.gcs.kv_get(func_id, ns="fn")
            if blob is None:
                raise rpc.RpcError(f"function {func_id} not found in GCS")
            fn = cloudpickle.loads(blob)
            self.fn_cache[func_id] = fn
        return fn

    # -- argument loading ----------------------------------------------------

    async def load_args(self, wire: dict):
        if wire.get("args_object"):
            ref = ObjectRef(
                wire["args_object"],
                tuple(wire["owner_addr"]) if wire.get("owner_addr") else None,
                self.core,
            )
            # Task-argument fetches are below interactive gets in the pull
            # admission order (reference: pull_manager.h bundle priority).
            payload = await self.core._resolve_payload(ref, None, purpose="task_arg")
        else:
            payload = wire["args_blob"]
        with serialization.DeserializationContext(
            ref_deserializer=self.core._deserialize_ref
        ):
            (args, kwargs), _ = serialization.deserialize(payload)
        args = list(args)
        # Resolve top-level ObjectRef args to values (reference semantics).
        for i in wire.get("ref_positions") or []:
            args[i] = await self.core.get_objects(args[i], timeout=None)
        for k in wire.get("kw_ref_keys") or []:
            kwargs[k] = await self.core.get_objects(kwargs[k], timeout=None)
        return args, kwargs

    # -- result storage ------------------------------------------------------

    async def store_returns(self, spec_wire: dict, result: Any) -> list:
        num_returns = spec_wire["num_returns"]
        if num_returns == 0:
            return []
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned {len(values)}"
                )
        out = []
        for oid, value in zip(spec_wire["return_ids"], values):
            serialized = serialization.serialize(value)
            if serialized.total_size <= config.max_direct_call_object_size:
                out.append({"inline": serialized.to_bytes()})
            else:
                await self.core.plasma.put_serialized(oid, serialized)
                out.append({"plasma": list(self.core.raylet_addr)})
        return out

    def _error_payload(self, exc: BaseException) -> bytes:
        # Exact bytes required: this payload can cross the native fastpath
        # channel (PyBytes_AsStringAndSize rejects bytearray).
        tb = traceback.format_exc()
        try:
            exc.task_traceback = tb  # best effort annotation
        except Exception:
            pass
        try:
            return bytes(serialization.serialize(exc).to_bytes())
        except Exception:
            return bytes(
                serialization.serialize(
                    TaskError(RuntimeError(repr(exc)), traceback_str=tb)
                ).to_bytes()
            )

    # -- normal tasks --------------------------------------------------------

    async def handle_push_task(self, conn, p):
        wire = p["spec"]
        task_id = wire.get("task_id", "")
        if task_id in self.cancelled_tasks:
            self.cancelled_tasks.pop(task_id, None)
            from ray_tpu_torch._private.common import TaskCancelledError

            return {"error": self._error_payload(TaskCancelledError("task cancelled"))}
        track = self.running_tasks[task_id] = {"thread_id": None, "async_task": None}
        try:
            renv = wire.get("runtime_env") or {}
            if (
                renv.get("working_dir") or renv.get("py_modules")
                or renv.get("pip") or renv.get("conda")
            ):
                # Shared worker process: packages and pip-env site-packages
                # go on sys.path (idempotent) but the cwd is left alone; env
                # vars are call-scoped below.
                from ray_tpu_torch.runtime_env.context import apply_runtime_env

                await apply_runtime_env(
                    self.core,
                    {
                        k: renv[k]
                        for k in ("working_dir", "py_modules", "pip", "conda")
                        if k in renv
                    },
                    chdir=False,
                )
            profile = config.task_profile_events
            t0 = time.time()
            fn = await self.get_function(wire["func_id"])
            args, kwargs = await self.load_args(wire)
            t_args = time.time()
            if "trace_ctx" in wire:
                tracing.record_span(
                    "task.arg_fetch",
                    "arg_fetch",
                    t0,
                    t_args - t0,
                    ctx=tracing.ctx_from_wire(wire),
                    task_id=task_id,
                )
            from ray_tpu_torch.runtime_env.context import scoped_env_vars

            with scoped_env_vars(renv.get("env_vars")), tracing.execute_scope(
                self.core, wire
            ):
                tctx = tracing.current_context()
                if task_id in self.cancelled_tasks:
                    # Cancel arrived while args/function were being resolved.
                    self.cancelled_tasks.pop(task_id, None)
                    from ray_tpu_torch._private.common import TaskCancelledError

                    raise asyncio.CancelledError("task cancelled")
                if asyncio.iscoroutinefunction(fn):
                    coro_task = rpc.spawn(fn(*args, **kwargs))
                    track["async_task"] = coro_task
                    result = await coro_task
                else:
                    loop = asyncio.get_running_loop()

                    def run_tracked():
                        if task_id in self.cancelled_tasks:
                            self.cancelled_tasks.pop(task_id, None)
                            from ray_tpu_torch._private.common import TaskCancelledError

                            raise TaskCancelledError("task cancelled")
                        track["thread_id"] = threading.get_ident()
                        # Trace context does not cross run_in_executor.
                        tok = tracing.set_context(tctx)
                        try:
                            return fn(*args, **kwargs)
                        finally:
                            tracing.reset_context(tok)
                            track["thread_id"] = None

                    result = await loop.run_in_executor(self.pool, run_tracked)
                if wire["num_returns"] == -1 and inspect.isgenerator(result):
                    # Streaming generator: each yielded item is stored and
                    # reported to the owner AS PRODUCED, so the consumer's
                    # iteration overlaps this producer (reference:
                    # ReportGeneratorItemReturns). Runs INSIDE the trace
                    # scope: the generator body executes during this drain.
                    # Acked window = flow control (see _GEN_BACKPRESSURE_WINDOW).
                    idx = 0
                    loop = asyncio.get_running_loop()

                    def _advance():
                        tok = tracing.set_context(tctx)
                        try:
                            return True, next(result)
                        except StopIteration:
                            return False, None
                        finally:
                            tracing.reset_context(tok)

                    inflight = []
                    while True:
                        ok, item = await loop.run_in_executor(self.pool, _advance)
                        if not ok:
                            break
                        ret = await self.store_returns(
                            {"num_returns": 1,
                             "return_ids": [self._dyn_oid(wire, idx)]},
                            item,
                        )
                        inflight.append(rpc.spawn(
                            self._send_generator_item(
                                conn, wire["task_id"], idx, ret[0]
                            )
                        ))
                        if len(inflight) >= _GEN_BACKPRESSURE_WINDOW:
                            await asyncio.gather(*inflight)
                            inflight = []
                        idx += 1
                    if inflight:
                        await asyncio.gather(*inflight)
                    if profile:
                        self._record_profile(wire, t0, t_args, t_args)
                    return {"dynamic_count": idx}
            t_exec = time.time()
            returns = await self.store_returns(wire, result)
            if profile:
                self._record_profile(wire, t0, t_args, t_exec)
            return {"returns": returns}
        except asyncio.CancelledError:
            from ray_tpu_torch._private.common import TaskCancelledError

            return {"error": self._error_payload(TaskCancelledError("task cancelled"))}
        except BaseException as e:  # noqa: BLE001 - must serialize any failure
            logger.info("task %s raised: %r", wire.get("name"), e)
            return {"error": self._error_payload(e)}
        finally:
            self.running_tasks.pop(task_id, None)

    def _record_profile(self, wire: dict, t0: float, t_args: float, t_exec: float) -> None:
        """One PROFILE task event with phase durations (reference:
        RAY_PROFILING worker profile events)."""
        self.core.record_task_event(
            wire["task_id"],
            wire.get("name", "task"),
            "PROFILE",
            start=t0,
            phases={
                "deserialize_args": t_args - t0,
                "execute": t_exec - t_args,
                "store_returns": time.time() - t_exec,
            },
        )

    @staticmethod
    def _dyn_oid(wire: dict, index: int) -> str:
        from ray_tpu_torch._private.ids import TaskID, deterministic_object_id

        return deterministic_object_id(
            TaskID.from_hex(wire["task_id"]), index + 1
        ).hex()

    async def handle_cancel_task(self, conn, p):
        """Cancel a running task: async tasks via asyncio cancellation, sync
        tasks via an exception raised in the executing thread (the reference
        raises KeyboardInterrupt in the worker; same best-effort semantics —
        blocking C calls are not interrupted until they return)."""
        from ray_tpu_torch._private.common import TaskCancelledError

        track = self.running_tasks.get(p["task_id"])
        if track is None or (
            track.get("async_task") is None and track.get("thread_id") is None
        ):
            # Not executing yet: queued behind the current task (pipelined
            # push) or waiting for the executor. Mark it so execution is
            # skipped when its turn comes.
            self.cancelled_tasks[p["task_id"]] = None
            while len(self.cancelled_tasks) > 1024:
                self.cancelled_tasks.popitem(last=False)
            return {"found": True, "queued": True}
        if track.get("async_task") is not None:
            track["async_task"].cancel()
            return {"found": True}
        tid = track.get("thread_id")
        if tid is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError)
            )
            return {"found": True}
        return {"found": False}

    # -- actors --------------------------------------------------------------

    async def handle_create_actor(self, conn, p):
        wire = p["spec"]
        self.actor_spec = wire
        # Stash the hosted actor's identity on the CoreWorker so library code
        # running inside this process (collective group membership, death
        # watches) can learn "which actor am I" without an RPC.
        self.core.current_actor_id = wire.get("actor_id")
        max_c = wire.get("max_concurrency") or 1
        cgroups = wire.get("concurrency_groups")
        if cgroups:
            # Per-method concurrency groups (reference:
            # transport/concurrency_group_manager.cc): each group gets its
            # own semaphore (async methods) and thread pool (sync methods);
            # calls in different groups never block each other. Ungrouped
            # calls ride the default group sized by max_concurrency.
            if max_c == 1:
                max_c = 1000  # reference default for concurrency-group actors
            self.cgroup_sems = {
                name: asyncio.Semaphore(int(n)) for name, n in cgroups.items()
            }
            self.cgroup_sems["_default"] = asyncio.Semaphore(max_c)
            self.cgroup_pools = {
                name: concurrent.futures.ThreadPoolExecutor(max_workers=int(n))
                for name, n in cgroups.items()
            }
            self.cgroup_pools["_default"] = concurrent.futures.ThreadPoolExecutor(
                max_workers=max_c
            )
        if max_c > 1 and not cgroups:
            self.pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_c)
        # Run the constructor in the background and reply to the raylet NOW.
        # The raylet's lease grant (and through it the GCS actor scheduler)
        # must not block on user __init__: constructors may legitimately
        # rendezvous with actors that haven't been placed yet (collective
        # group bootstrap), and serializing placement behind them deadlocks.
        # Readiness/failure flows to the GCS via ReportActorReady, which is
        # what gates task submission (reference: GcsActorScheduler pushes the
        # creation task asynchronously and tracks readiness separately).
        self._creation_task = rpc.spawn(self._run_actor_creation(wire))
        return {"ok": True}

    async def _run_actor_creation(self, wire) -> None:
        try:
            if wire.get("runtime_env"):
                # Actors own their process: permanent application (env vars,
                # working_dir chdir + sys.path, py_modules).
                from ray_tpu_torch.runtime_env.context import apply_runtime_env

                await apply_runtime_env(self.core, wire["runtime_env"])
            cls = await self.get_function(wire["func_id"])
            args, kwargs = await self.load_args(wire)
            loop = asyncio.get_running_loop()
            tctx = tracing.ctx_from_wire(wire) or tracing.current_context()

            def _construct():
                # Trace context does not cross run_in_executor; re-set it so
                # work submitted from __init__ joins the creation trace.
                tok = tracing.set_context(tctx)
                try:
                    return cls(*args, **kwargs)
                finally:
                    tracing.reset_context(tok)

            self.actor_instance = await loop.run_in_executor(self.pool, _construct)
            self.actor_all_sync = not any(
                asyncio.iscoroutinefunction(m)
                for _, m in inspect.getmembers(
                    type(self.actor_instance), callable
                )
            )
            await self._report_actor_ready(
                {
                    "actor_id": wire["actor_id"],
                    "addr": list(self.core.addr),
                    "worker_id": self.core.worker_id,
                    "node_id": self.core.node_id,
                }
            )
        except asyncio.CancelledError:
            # Teardown cancellation is not a creation failure: unwind so the
            # raylet's worker-death report drives the actor FSM instead of a
            # bogus "creation failed" report pinning the actor DEAD.
            raise
        except BaseException as e:
            logger.exception("actor creation failed")
            await self._report_actor_ready(
                {
                    "actor_id": wire["actor_id"],
                    "error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                }
            )

    async def _report_actor_ready(self, payload: dict) -> None:
        """Deliver the readiness/failure report, retrying through GCS blips.
        This is the ONLY signal that moves the actor out of PENDING_CREATION
        (the creation task is otherwise unobserved), so if it cannot be
        delivered the worker exits: the raylet's worker-death report then
        fails/restarts the actor instead of leaving callers blocked forever."""
        for attempt in range(5):
            try:
                await self.core.gcs.call("ReportActorReady", payload)
                return
            # This bounded retry loop IS the StaleLeaderError handling: the
            # gcs channel re-resolves the leader on reconnect, and after 5
            # failures the worker exits so the raylet surfaces the failure —
            # nothing is converted to silent success.
            except Exception:  # exc-flow: disable=swallowed-control-error
                logger.exception(
                    "ReportActorReady attempt %d/5 failed", attempt + 1
                )
                await asyncio.sleep(min(2.0**attempt, 10.0))
        logger.error(
            "could not report actor %s readiness; exiting so the raylet "
            "surfaces the failure",
            payload.get("actor_id", "?")[:8],
        )
        os._exit(1)

    async def handle_push_actor_task(self, conn, p):
        wire = p["spec"]
        caller = wire.get("caller_id") or "anon"
        seq = wire.get("seq_no", -1)
        if self.cgroup_sems is not None:
            # Concurrency-group actor: out-of-order execution, bounded per
            # group (reference: out_of_order_actor_submit_queue.cc +
            # concurrency_group_manager.cc).
            group = wire.get("concurrency_group") or "_default"
            sem = self.cgroup_sems.get(group)
            if sem is None:
                raise rpc.RpcError(f"unknown concurrency group {group!r}")
            if seq >= 0:
                self._advance_seq(caller, seq)
            async with sem:
                return await self._run_actor_method(
                    wire, pool=self.cgroup_pools[group], conn=conn
                )
        ordered = (self.actor_spec or {}).get("max_concurrency", 1) == 1
        if ordered and seq >= 0:
            await self._wait_my_turn(caller, seq)
        try:
            return await self._run_actor_method(wire, conn=conn)
        finally:
            if ordered and seq >= 0:
                self._advance_seq(caller, seq)

    async def _wait_my_turn(self, caller: str, seq: int) -> None:
        expected = self.expected_seq.get(caller, 0)
        if seq <= expected:
            return
        fut = asyncio.get_running_loop().create_future()
        self.pending_seq.setdefault(caller, {})[seq] = fut
        # Resolved by _advance_seq when the predecessor finishes (its
        # finally runs even on failure); mirrors the reference
        # out-of-order submit queue, where sequencing waits are unbounded
        # and the caller's task-level retry owns recovery.
        await fut  # rpc-flow: disable=unbounded-await

    def _advance_seq(self, caller: str, seq: int) -> None:
        nxt = max(self.expected_seq.get(caller, 0), seq + 1)
        self.expected_seq[caller] = nxt
        pending = self.pending_seq.get(caller, {})
        if nxt in pending:
            fut = pending.pop(nxt)
            if not fut.done():
                fut.set_result(None)

    async def _run_actor_method(self, wire: dict, pool=None, conn=None):
        if pool is None:
            pool = self.pool
        try:
            if self.actor_instance is None:
                raise RuntimeError("actor not initialized")
            if wire["actor_method"] == "__rt_dag_loop__":
                # Compiled-DAG resident loop (ray_tpu_torch.dag): runs until the
                # driver writes the STOP sentinel into the input channels.
                from ray_tpu_torch.dag.exec_loop import dag_exec_loop

                args, kwargs = await self.load_args(wire)
                loop = asyncio.get_running_loop()
                dag_tctx = tracing.ctx_from_wire(wire) or tracing.current_context()

                def _dag_run():
                    # Trace context does not cross run_in_executor; re-set it
                    # so submissions from inside the DAG loop stay traced.
                    tok = tracing.set_context(dag_tctx)
                    try:
                        return dag_exec_loop(self.actor_instance, *args)
                    finally:
                        tracing.reset_context(tok)

                result = await loop.run_in_executor(None, _dag_run)
                returns = await self.store_returns(wire, result)
                return {"returns": returns}
            method = getattr(self.actor_instance, wire["actor_method"])
            t_fetch = time.time()
            args, kwargs = await self.load_args(wire)
            if "trace_ctx" in wire:
                tracing.record_span(
                    "task.arg_fetch",
                    "arg_fetch",
                    t_fetch,
                    time.time() - t_fetch,
                    ctx=tracing.ctx_from_wire(wire),
                    task_id=wire["task_id"],
                )
            loop = asyncio.get_running_loop()

            with tracing.execute_scope(self.core, wire):
                tctx = tracing.current_context()
                if asyncio.iscoroutinefunction(method):
                    result = await method(*args, **kwargs)
                else:
                    def _run_with_ctx():
                        tok = tracing.set_context(tctx)
                        try:
                            return method(*args, **kwargs)
                        finally:
                            tracing.reset_context(tok)

                    result = await loop.run_in_executor(pool, _run_with_ctx)
                if (
                    wire["num_returns"] == -1
                    and conn is not None
                    and (inspect.isgenerator(result) or inspect.isasyncgen(result))
                ):
                    # Streaming actor generator: items are stored and
                    # reported to the owner AS PRODUCED (GeneratorItem
                    # pushes), so the consumer's iteration overlaps this
                    # producer. Runs INSIDE the trace scope — the generator
                    # body executes during this drain, and its nested
                    # submits must inherit the trace context.
                    idx = 0
                    if inspect.isasyncgen(result):
                        async def _advance():
                            try:
                                return True, await result.__anext__()
                            except StopAsyncIteration:
                                return False, None
                        advance = _advance
                    else:
                        def _advance_sync():
                            tok = tracing.set_context(tctx)
                            try:
                                return True, next(result)
                            except StopIteration:
                                return False, None
                            finally:
                                tracing.reset_context(tok)

                        async def _advance():
                            return await loop.run_in_executor(
                                pool, _advance_sync
                            )
                        advance = _advance
                    inflight = []
                    while True:
                        ok, item = await advance()
                        if not ok:
                            break
                        ret = await self.store_returns(
                            {"num_returns": 1,
                             "return_ids": [self._dyn_oid(wire, idx)]},
                            item,
                        )
                        # Acked delivery with a bounded window: a slow
                        # consumer throttles the producer instead of the
                        # owner buffering the whole stream (reference:
                        # _generator_backpressure_num_objects).
                        inflight.append(rpc.spawn(
                            self._send_generator_item(
                                conn, wire["task_id"], idx, ret[0]
                            )
                        ))
                        if len(inflight) >= _GEN_BACKPRESSURE_WINDOW:
                            await asyncio.gather(*inflight)
                            inflight = []
                        idx += 1
                    if inflight:
                        await asyncio.gather(*inflight)
                    return {"dynamic_count": idx}
            returns = await self.store_returns(wire, result)
            return {"returns": returns}
        except asyncio.CancelledError:
            # Same contract as the plain-task path above: ray.cancel must
            # cross the wire as typed TaskCancelledError, not as an opaque
            # CancelledError string the caller cannot dispatch on.
            from ray_tpu_torch._private.common import TaskCancelledError

            return {"error": self._error_payload(TaskCancelledError("task cancelled"))}
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, SystemExit):
                asyncio.get_running_loop().call_later(0.1, os._exit, 0)
                return {"error": self._error_payload(RuntimeError("actor exited"))}
            logger.info("actor method %s raised: %r", wire.get("actor_method"), e)
            return {"error": self._error_payload(e)}

    async def _send_generator_item(self, conn, task_id: str, idx: int, ret: dict):
        """One acked GeneratorItem delivery (the ack is the flow-control
        token — a window of these bounds producer run-ahead)."""
        return await conn.call(
            "GeneratorItem", {"task_id": task_id, "index": idx, "ret": ret}
        )

    async def handle_exit(self, conn, p):
        # Final deadline-stats flush: overruns observed in this worker's last
        # report interval must reach the GCS aggregate before the process
        # dies, or the no-call-outlives-deadline invariant goes blind to
        # them. Bounded so a dead GCS cannot stall the exit.
        delta = _deadline_stats_delta(self.core.worker_id)
        if delta is not None:
            try:
                await asyncio.wait_for(
                    self.core.gcs.call("ReportDeadlineStats", delta), timeout=1.0
                )
            except Exception:
                pass
        # Same for the runtime-telemetry registry: counters recorded since
        # the last periodic flush (and any undrained flight events) ride one
        # bounded final report instead of dying with the process.
        tel = telemetry.flush_delta(self.core.worker_id, self.core.node_id)
        if tel is not None:
            try:
                await asyncio.wait_for(
                    self.core.gcs.call("ReportTelemetry", tel), timeout=1.0
                )
            except Exception:
                telemetry.restore_delta(tel)
        # And the trace plane: buffered task-event spans plus runtime spans
        # must outlive the worker (flush-on-exit span delivery) — a span
        # recorded milliseconds before exit is exactly the one a trace of a
        # short task needs.
        if tracing.enabled():
            try:
                await asyncio.wait_for(self.core._flush_task_events(), timeout=1.0)
            except Exception:
                pass
            try:
                await asyncio.wait_for(
                    tracing.flush_spans_once(
                        self.core.gcs.call,
                        self.core.worker_id,
                        self.core.node_id,
                    ),
                    timeout=1.0,
                )
            except Exception:
                pass
        asyncio.get_running_loop().call_later(0.05, os._exit, 0)
        return {"ok": True}


async def amain() -> None:
    raylet_addr = (
        os.environ["RAY_TPU_RAYLET_HOST"],
        int(os.environ["RAY_TPU_RAYLET_PORT"]),
    )
    gcs_addr = (os.environ["RAY_TPU_GCS_HOST"], int(os.environ["RAY_TPU_GCS_PORT"]))
    gcs_leader_file = os.environ.get("RAY_TPU_GCS_LEADER_FILE") or None
    if gcs_leader_file:
        # HA mode: the env address is whatever leader the raylet knew at
        # spawn time — a worker booting mid/post-failover must dial the
        # CURRENT leader from the pointer file instead.
        from ray_tpu_torch._private import gcs_ha

        gcs_addr = gcs_ha.resolve_leader_file(gcs_leader_file) or gcs_addr
    worker_id = os.environ["RAY_TPU_WORKER_ID"]
    node_id = os.environ["RAY_TPU_NODE_ID"]
    session = os.environ["RAY_TPU_SESSION"]

    server = rpc.Server("127.0.0.1", 0)
    addr = await server.start()

    raylet_conn = await rpc.connect(
        *raylet_addr, handlers=server._handlers, sync_handlers=server._sync_handlers
    )
    gcs_conn = await rpc.connect(
        *gcs_addr, handlers=server._handlers, sync_handlers=server._sync_handlers
    )

    core = CoreWorker(
        job_id=os.environ.get("RAY_TPU_JOB_ID", ""),
        session_name=session,
        node_id=node_id,
        gcs_conn=gcs_conn,
        raylet_conn=raylet_conn,
        is_driver=False,
        worker_id=worker_id,
        server=server,
        gcs_leader_file=gcs_leader_file,
    )
    core.addr = addr
    core.raylet_addr = raylet_addr
    core.start_background()

    executor = Executor(core)

    # Install the sync-facing global worker so user code can call
    # ray_tpu_torch.get()/put() from inside tasks.
    from ray_tpu_torch._private import worker as worker_mod

    worker_mod.attach_existing(core, asyncio.get_running_loop())

    # Native direct-call channel (reference: the worker-side PushTask fast
    # lane of the C++ core worker). Optional: without the extension the RPC
    # path serves everything.
    fp_port = None
    fp_server_id = None
    if config.fastpath_enabled:
        try:
            from ray_tpu_torch._native import _fastpath as _fp

            executor._fp_loop = asyncio.get_running_loop()
            fp_server_id, fp_port = _fp.serve(
                "127.0.0.1", 0, executor.fastpath_exec
            )
        except Exception:
            fp_port = None

    reply = await raylet_conn.call(
        "RegisterWorker",
        {"worker_id": worker_id, "addr": list(addr), "fp_port": fp_port},
    )
    core.job_id = core.job_id or reply.get("job_id", "")

    async def _deadline_report_loop() -> None:
        """Flush deadline-enforcement deltas to the GCS aggregate so overruns
        inside worker subprocesses are visible to the cluster-wide
        no-call-outlives-deadline invariant, not just driver-local stats."""
        interval = config.rpc_deadline_report_interval_s
        if interval <= 0:
            return
        while True:
            await asyncio.sleep(interval)
            delta = _deadline_stats_delta(worker_id)
            if delta is None:
                continue
            try:
                await core.gcs.call("ReportDeadlineStats", delta)
            except Exception:
                _restore_deadline_delta(delta)

    rpc.spawn(_deadline_report_loop())

    # Exit if the raylet link dies: an unmanaged worker must not linger.
    while not raylet_conn.closed:
        await asyncio.sleep(0.5)
    os._exit(0)


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {os.environ.get('RAY_TPU_WORKER_ID', '?')[:8]}] %(message)s",
    )
    rpc.install_event_loop()
    asyncio.run(amain())


if __name__ == "__main__":
    main()
